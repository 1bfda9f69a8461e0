"""The run loop shared by the example drivers (port of the single-state
path of ``ibamr_tpu/utils/hierarchy_driver.py``): dt management, viz,
restart and regrid cadences, per-chunk metrics, and the divergence guard.

Steps run in chunks of ``health_interval``, shortened to land exactly on
the viz, restart and regrid cadences. Where the reference scans a jitted
chunk, a chunk here is a Python loop of ``step_fn`` calls; after it the
driver reads one finite flag of the whole state to the host (the chunk's
one synchronisation) and raises :class:`SimulationDiverged`, naming the
non-finite leaves, before any callback sees the broken state.

Not ported: fleet lanes, the health probe, the flight recorder, the
shadow audit, rematerialisation and buffer donation; asking for any of
them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ibamr_tpu_torch.utils.tree import flatten_with_path, keystr


class SimulationDiverged(RuntimeError):
    """Raised when the state stops being finite; carries diagnostics."""

    kind = "divergence"

    def __init__(self, step: int, bad_leaves):
        self.step = step
        self.bad_leaves = bad_leaves
        names = ", ".join(bad_leaves) or "<unknown>"
        super().__init__(
            f"simulation diverged by step {step}: non-finite values in "
            f"state leaves [{names}] - no checkpoint written for the "
            f"broken state")


def _float_leaves(state):
    return [(p, leaf) for p, leaf in flatten_with_path(state)
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]


def _finite_flag(state) -> bool:
    """One host read: every floating leaf of ``state`` is finite."""
    flags = [torch.isfinite(leaf).all() for _, leaf in _float_leaves(state)]
    return bool(torch.stack(flags).all()) if flags else True


def _bad_leaf_names(state) -> list:
    return [keystr(p) for p, leaf in _float_leaves(state)
            if not bool(torch.isfinite(leaf).all())]


@dataclasses.dataclass
class RunConfig:
    """Cadences mirror the reference input-file vocabulary."""
    dt: float
    num_steps: int
    viz_dump_interval: int = 0        # 0 = off
    restart_interval: int = 0
    regrid_interval: int = 0
    health_interval: int = 10         # steps per chunk (>= 1)
    cfl: Optional[float] = None       # recompute dt each chunk if set
    donate: bool = False              # not ported
    remat: Optional[str] = None       # not ported

    def __post_init__(self):
        if self.donate:
            raise NotImplementedError(
                "RunConfig.donate is not ported (the eager step has no "
                "buffer donation)")
        if self.remat is not None:
            raise NotImplementedError("RunConfig.remat is not ported yet")
        # fail-fast input validation: a bad input file dies here with the
        # offending field named
        if not (self.dt > 0):            # also rejects NaN dt
            raise ValueError(
                f"RunConfig.dt must be > 0, got {self.dt!r} (a non-"
                f"positive or NaN timestep silently freezes the run)")
        if self.num_steps < 0:
            raise ValueError(
                f"RunConfig.num_steps must be >= 0, got "
                f"{self.num_steps!r}")
        for name in ("viz_dump_interval", "restart_interval",
                     "regrid_interval"):
            val = getattr(self, name)
            if val < 0:
                raise ValueError(
                    f"RunConfig.{name} must be >= 0 (0 = off), got "
                    f"{val!r} - a negative cadence is a typo'd input "
                    f"file, not a request")
        if self.health_interval < 1:
            raise ValueError(
                "health_interval is the steps-per-chunk granularity and "
                "must be >= 1 (the divergence guard cannot be disabled)")
        if self.cfl is not None and not (self.cfl > 0):
            raise ValueError(
                f"RunConfig.cfl must be > 0 when set, got {self.cfl!r}")


class HierarchyDriver:
    """Shared advance/regrid/viz/restart/health loop.

    ``integ`` needs ``step(state, dt) -> state``, and ``cfl_dt(state,
    cfl)`` when ``cfg.cfl`` is set. Callbacks (all optional), after each
    chunk and in this order: ``metrics_fn(state, step) -> dict`` (returned
    dicts go to ``self.history``), ``viz_fn(state, step)`` at the viz
    cadence, ``checkpoint_fn(state, step)`` at the restart cadence and
    ``regrid_fn(state, step) -> state`` at the regrid cadence; the final
    state is visualized when the last step is off the viz cadence.
    ``timer`` (a ``TimerManager``) times each chunk with its host read.
    """

    def __init__(self, integ, cfg: RunConfig,
                 viz_fn: Optional[Callable] = None,
                 metrics_fn: Optional[Callable] = None,
                 regrid_fn: Optional[Callable] = None,
                 checkpoint_fn: Optional[Callable] = None,
                 step_fn: Optional[Callable] = None,
                 timer=None,
                 timer_name: str = "HierarchyIntegrator::advanceHierarchy",
                 health_probe=None, recorder=None, shadow_audit=None,
                 lanes: Optional[int] = None):
        for name, val in (("health_probe", health_probe),
                          ("recorder", recorder),
                          ("shadow_audit", shadow_audit), ("lanes", lanes)):
            if val is not None:
                raise NotImplementedError(
                    f"HierarchyDriver({name}=...) is not ported yet")
        self.integ = integ
        self.cfg = cfg
        self.viz_fn = viz_fn
        self.metrics_fn = metrics_fn
        self.regrid_fn = regrid_fn
        self.checkpoint_fn = checkpoint_fn
        self.timer = timer                 # times the chunks, not callbacks
        self.timer_name = timer_name
        self.history = []
        self._step = step_fn if step_fn is not None else integ.step

    def _advance(self, state, n: int, dt: float):
        """One chunk of ``n`` steps, then its one host read."""
        for _ in range(n):
            state = self._step(state, dt)
        return state, _finite_flag(state)

    def run(self, state, start_step: int = 0):
        """Advance to ``cfg.num_steps``; returns the final state."""
        cfg = self.cfg
        step = start_step
        dt = cfg.dt
        if (start_step and cfg.regrid_interval
                and self.regrid_fn is not None
                and start_step % cfg.regrid_interval == 0):
            # resume landing on a regrid boundary: the restored checkpoint
            # was written before that step's regrid ran (checkpoint, then
            # regrid), so the pending regrid fires exactly once here
            state = self.regrid_fn(state, start_step)
        cadences = [i for i in (cfg.viz_dump_interval,
                                cfg.restart_interval,
                                cfg.regrid_interval) if i]
        while step < cfg.num_steps:
            if cfg.cfl is not None:
                dt = float(min(cfg.dt, self.integ.cfl_dt(state, cfg.cfl)))
            n = min(cfg.health_interval, cfg.num_steps - step)
            for i in cadences:               # land exactly on cadences
                n = min(n, i - step % i)
            if self.timer is not None:
                with self.timer.scope(self.timer_name):
                    state, finite = self._advance(state, n, dt)
            else:
                state, finite = self._advance(state, n, dt)
            if not finite:
                raise SimulationDiverged(step + n, _bad_leaf_names(state))
            step += n

            if self.metrics_fn is not None:
                rec = self.metrics_fn(state, step)
                if rec:
                    self.history.append(rec)
            if (cfg.viz_dump_interval and self.viz_fn is not None
                    and step % cfg.viz_dump_interval == 0):
                self.viz_fn(state, step)
            if (cfg.restart_interval and self.checkpoint_fn is not None
                    and step % cfg.restart_interval == 0):
                self.checkpoint_fn(state, step)
            if (cfg.regrid_interval and self.regrid_fn is not None
                    and step % cfg.regrid_interval == 0):
                state = self.regrid_fn(state, step)
        # always visualize the final configuration, aligned or not
        if (cfg.viz_dump_interval and self.viz_fn is not None
                and step % cfg.viz_dump_interval != 0):
            self.viz_fn(state, step)
        return state
