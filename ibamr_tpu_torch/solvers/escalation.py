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
- :class:`ShadowAuditor` re-runs one fluid substep at the configured
  ``spectral_dtype`` and at f64 every N chunks and raises
  :class:`PrecisionDrift` when they part by more than a bound; the
  supervisor answers by escalating ``spectral_dtype`` one level. On a
  GPU the f64 shadow is a real f64 cuFFT substep.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

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


class PrecisionDrift(SimulationDiverged):
    """The strided f64 shadow audit found the mixed-precision fluid
    substep drifting past its bound: the state is finite and the solver
    converged, but the fast path is out of tolerance. The supervisor
    retries at the next ``PRECISION_FALLBACKS`` level instead of backing
    dt off: the cure is precision, not stability."""

    kind = "precision_drift"

    def __init__(self, step: int, *, drift: float, bound: float,
                 spectral_dtype: str, div_drift: Optional[float] = None):
        self.step = step
        self.drift = float(drift)
        self.bound = float(bound)
        self.spectral_dtype = spectral_dtype
        self.div_drift = None if div_drift is None else float(div_drift)
        self.bad_leaves: list = []      # nothing is non-finite
        RuntimeError.__init__(
            self,
            f"precision drift by step {step}: f64 shadow audit measured "
            f"relative substep drift {self.drift:.4g} > bound "
            f"{self.bound:.4g} at spectral_dtype={spectral_dtype!r} - "
            f"the mixed-precision fast path is out of tolerance")

    def incident_payload(self) -> dict:
        return {"drift": self.drift, "bound": self.bound,
                "spectral_dtype": self.spectral_dtype,
                "div_drift": self.div_drift}


class ShadowAuditor:
    """Strided f64 shadow audit of the fused spectral fluid substep.

    Every ``every`` chunks, :meth:`maybe_audit` re-runs ONE Stokes
    substep from the current velocity twice, at the integrator's
    ``spectral_dtype`` and at f64 through
    :func:`~ibamr_tpu_torch.solvers.spectral_plan.get_plan`, and compares
    the relative velocity drift (and the post-projection divergence gap)
    against its bounds; a breach raises :class:`PrecisionDrift`. The
    audit runs between chunks, off the step. Default ``bound=0.02``: an
    order of magnitude above the natural bf16 substep drift (~3e-3
    against the f64 oracle)."""

    def __init__(self, every: int = 8, bound: float = 0.02,
                 div_bound: Optional[float] = None):
        if every < 1:
            raise ValueError("ShadowAuditor.every must be >= 1")
        self.every = every
        self.bound = float(bound)
        self.div_bound = None if div_bound is None else float(div_bound)
        self.chunks_seen = 0
        self.audits = 0
        self.history: list = []
        self.last: Optional[dict] = None

    def params(self) -> dict:
        """JSON-safe audit configuration for the flight-recorder
        fingerprint (what ``tools/replay.py`` re-arms the audit from)."""
        return {"every": self.every, "bound": self.bound,
                "div_bound": self.div_bound}

    @staticmethod
    def _fluid_parts(integ, state):
        """(INS-like integrator, INS-like state): unwraps one IB layer."""
        ins = getattr(integ, "ins", None)
        if ins is not None and hasattr(state, "ins"):
            return ins, state.ins
        return integ, state

    def maybe_audit(self, integ, state, dt, step: int):
        """Called by the driver once per chunk; audits every
        ``every``-th call. Returns the audit record (or None)."""
        self.chunks_seen += 1
        if self.chunks_seen % self.every:
            return None
        return self.audit(integ, state, dt, step=step)

    def audit(self, integ, state, dt, step: int):
        """One shadow audit; raises :class:`PrecisionDrift` on breach."""
        import numpy as np

        from ibamr_tpu_torch.ops import stencils
        from ibamr_tpu_torch.solvers.spectral_plan import get_plan

        fluid, fstate = self._fluid_parts(integ, state)
        sdtype = getattr(fluid, "spectral_dtype", None)
        grid = fluid.grid
        rho = float(getattr(fluid, "rho", 1.0))
        mu = float(getattr(fluid, "mu", 0.0))
        u = fstate.u
        # one Stokes substep: backward-Euler viscous solve + Leray
        # projection of rho/dt * u, the algebra the fused path runs
        alpha = rho / float(dt)
        beta = -0.5 * mu
        rhs = tuple((c * alpha) for c in u)
        dev = rhs[0].device
        plan = get_plan(rhs[0].shape, grid.dx, rhs[0].dtype, dev)
        fast_u, _ = plan.substep(rhs, alpha, beta, (alpha, beta),
                                 spectral_dtype=sdtype)
        plan64 = get_plan(rhs[0].shape, grid.dx, torch.float64, dev)
        ref_u, _ = plan64.substep(
            tuple(c.to(plan64.rdtype) for c in rhs),
            alpha, beta, (alpha, beta), spectral_dtype=None)
        scale = max(float(torch.max(torch.abs(c))) for c in ref_u)
        scale = max(scale, 1e-30)
        drift = max(
            float(torch.max(torch.abs(f.to(plan64.rdtype)
                                      - r.to(plan64.rdtype))))
            for f, r in zip(fast_u, ref_u)) / scale
        div_fast = float(torch.max(torch.abs(
            stencils.divergence(fast_u, grid.dx))))
        div_ref = float(torch.max(torch.abs(
            stencils.divergence(ref_u, grid.dx))))
        div_drift = abs(div_fast - div_ref) / max(scale, 1e-30)
        self.audits += 1
        level = precision_level_name(sdtype)
        rec = {"step": int(step), "spectral_dtype": level,
               "drift": drift, "bound": self.bound,
               "div_drift": div_drift, "div_bound": self.div_bound}
        self.last = rec
        self.history.append(rec)
        breached = (np.isfinite(drift) and drift > self.bound) or \
            (self.div_bound is not None and div_drift > self.div_bound)
        if breached:
            raise PrecisionDrift(step, drift=drift, bound=self.bound,
                                 spectral_dtype=level,
                                 div_drift=div_drift)
        return rec


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
