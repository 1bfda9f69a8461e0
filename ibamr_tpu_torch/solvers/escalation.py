"""Solver non-convergence surfacing and escalation (port of
``ibamr_tpu/solvers/escalation.py``).

- :func:`record_solve_stats` stores a solve's ``{iters, resnorm,
  converged, solver}`` on its owning solver (``last_solve_stats``), so a
  driver logs them without re-running the solve.
- :func:`escalate_solve` walks a declared chain of solve geometries (more
  FGMRES restarts, a longer basis, deeper preconditioner sweeps) and stops
  at the first attempt that converges; an exhausted chain raises
  :class:`SolverBreakdown`, a ``SimulationDiverged``. It never hands the
  solve to another device.
- :func:`precision_level_name` / :func:`precision_chain` name the
  ``spectral_dtype`` levels bf16 -> f32 -> f64.

The reference's strided f64 shadow audit (``ShadowAuditor``,
``PrecisionDrift``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

from ibamr_tpu_torch.utils.hierarchy_driver import SimulationDiverged


class SolverBreakdown(SimulationDiverged):
    """A solve escalated through its whole chain and still did not
    converge."""

    kind = "solver_breakdown"

    def __init__(self, context: str, attempts, step: Optional[int] = None):
        self.context = context
        self.attempts = list(attempts)
        self.step = -1 if step is None else step
        self.bad_leaves: list = []
        last = self.attempts[-1] if self.attempts else {}
        RuntimeError.__init__(
            self,
            f"solver breakdown in {context!r}: escalation chain "
            f"exhausted after {len(self.attempts)} attempts "
            f"(last level {last.get('level')!r}, resnorm "
            f"{last.get('resnorm')})")

    def incident_payload(self) -> dict:
        return {"context": self.context, "attempts": self.attempts}


def solve_stats_dict(sol, solver: str = "", level: str = "") -> dict:
    """``{iters, resnorm, converged[, solver][, level]}`` of a solve
    result (one host read of each)."""
    rec = {"iters": int(sol.iters), "resnorm": float(sol.resnorm),
           "converged": bool(sol.converged)}
    if solver:
        rec["solver"] = solver
    if level:
        rec["level"] = level
    return rec


def record_solve_stats(sink, sol, solver: str = "",
                       mirrors: Sequence = ()) -> None:
    """Store the solve's stats as ``sink.last_solve_stats`` and on every
    object of ``mirrors``."""
    rec = solve_stats_dict(sol, solver)
    for s in (sink,) + tuple(m for m in mirrors if m is not None):
        s.last_solve_stats = rec


@dataclasses.dataclass(frozen=True)
class EscalationLevel:
    """One link of an escalation chain: scales of the base solve's
    restarts, basis length, iteration cap and inner accuracy."""

    name: str
    restarts_scale: int = 1
    m_scale: int = 1
    maxiter_scale: int = 1
    inner_scale: int = 1


ESCALATION_LEVELS: Dict[str, EscalationLevel] = {
    "base": EscalationLevel("base"),
    "restarts_x4": EscalationLevel("restarts_x4", restarts_scale=4),
    "deep_x4_inner_x2": EscalationLevel(
        "deep_x4_inner_x2", restarts_scale=4, m_scale=2, inner_scale=2),
}

ESCALATION_FALLBACKS: Dict[str, Optional[str]] = {
    "base": "restarts_x4",
    "restarts_x4": "deep_x4_inner_x2",
    "deep_x4_inner_x2": None,
}


def escalation_chain(name: str = "base"):
    """The escalation order starting at ``name`` (inclusive)."""
    if name not in ESCALATION_LEVELS:
        raise KeyError(f"unknown escalation level {name!r}; known: "
                       f"{sorted(ESCALATION_LEVELS)}")
    chain, cur = [], name
    while cur is not None:
        chain.append(ESCALATION_LEVELS[cur])
        cur = ESCALATION_FALLBACKS[cur]
    return chain


PRECISION_LEVELS = ("bf16", "f32", "f64")
PRECISION_FALLBACKS: Dict[str, Optional[str]] = {
    "bf16": "f32",
    "f32": "f64",
    "f64": None,
}


def precision_level_name(spectral_dtype) -> str:
    """The ``PRECISION_LEVELS`` name of a ``spectral_dtype`` knob value."""
    import torch

    from ibamr_tpu_torch.solvers.spectral_plan import canonical_spectral_dtype

    sd = canonical_spectral_dtype(spectral_dtype)
    if sd is None:
        return "f32"
    return "bf16" if sd is torch.bfloat16 else "f64"


def precision_chain(name: str = "bf16"):
    """The precision escalation order starting at ``name`` (inclusive)."""
    if name not in PRECISION_FALLBACKS:
        raise KeyError(f"unknown precision level {name!r}; known: "
                       f"{list(PRECISION_LEVELS)}")
    chain, cur = [], name
    while cur is not None:
        chain.append(cur)
        cur = PRECISION_FALLBACKS[cur]
    return chain


def escalate_solve(attempt_fn: Callable, *, context: str = "solve",
                   chain=None, on_incident: Optional[Callable] = None,
                   step: Optional[int] = None):
    """Walk the chain until an attempt converges.
    ``attempt_fn(level, attempt) -> SolveResult`` runs one solve at that
    level's geometry; the first converged attempt wins (level 0
    converging returns its result untouched). Escalations past level 0
    go to ``on_incident`` as one record ``{event, kind, context,
    recovered, level, attempts}``; an exhausted chain raises
    :class:`SolverBreakdown` with the same attempts."""
    chain = escalation_chain() if chain is None else list(chain)
    if not chain:
        raise ValueError("escalation chain must have at least one level")
    attempts = []
    for i, level in enumerate(chain):
        sol = attempt_fn(level, i)
        rec = solve_stats_dict(sol, level=level.name)
        attempts.append(rec)
        if rec["converged"]:
            if i > 0 and on_incident is not None:
                on_incident({"event": "solver_escalation",
                             "kind": "solver_breakdown",
                             "context": context, "recovered": True,
                             "level": level.name, "attempts": attempts})
            return sol
    if on_incident is not None:
        on_incident({"event": "solver_breakdown",
                     "kind": "solver_breakdown", "context": context,
                     "recovered": False, "level": None,
                     "attempts": attempts})
    raise SolverBreakdown(context, attempts, step=step)
