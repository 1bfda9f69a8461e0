"""The run loop shared by the example drivers (port of
``ibamr_tpu/utils/hierarchy_driver.py``): dt management, viz, restart
and regrid cadences, per-chunk metrics, and the divergence guard.

Steps run in chunks of ``health_interval``, shortened to land exactly on
the viz, restart and regrid cadences. Where the reference scans a jitted
chunk, a chunk here is a Python loop of ``step_fn`` calls; after it the
driver reads ONE small vector to the host (the chunk's one
synchronisation): the finite flag of the whole state, or, with a
:class:`~ibamr_tpu_torch.utils.health.HealthProbe`, the probe's vitals
in its place. It raises :class:`SimulationDiverged`, naming the
non-finite leaves, before any callback sees the broken state.
``host_reads`` counts those reads.

The resilience hooks of the reference run here too: the flight
recorder's pre-chunk snapshot, the health probe's triage, the strided
f64 shadow audit, fleet chunks (``lanes=B``: every leaf carries a lane
axis; each live lane's slice steps in turn and the lanes are re-stacked;
dead lanes keep their pre-step rows through ``torch.where``, a select),
and the telemetry bus's ``driver/chunk`` span, counters and chunk
boundary records. ``RunConfig.remat`` wraps each step of a chunk in
``torch.utils.checkpoint``. ``RunConfig.donate`` keeps the reference's
contract (forced off under ``remat`` and by ``ResilientDriver``) and
otherwise does nothing: eager PyTorch has no buffer donation.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional

import numpy as np
import torch

from ibamr_tpu_torch import obs as _obs
from ibamr_tpu_torch.utils.tree import flatten_with_path, keystr, tree_map

_CHUNKS_TOTAL = _obs.counter("driver_chunks_total")
_STEPS_TOTAL = _obs.counter("driver_steps_total")
_CHUNK_WALL = _obs.histogram("driver_chunk_wall_seconds")
_obs.describe("driver_chunk_wall_seconds",
              "Per-chunk wall time including the post-chunk sync.")


class SimulationDiverged(RuntimeError):
    """Raised when the state stops being finite; carries diagnostics.
    ``kind`` tags the incident record the supervisor writes (subclasses:
    ``health_degraded``, ``solver_breakdown``, ``precision_drift``,
    ``lane_fault``); ``incident_payload()`` adds subclass fields."""

    kind = "divergence"

    def __init__(self, step: int, bad_leaves):
        self.step = step
        self.bad_leaves = bad_leaves
        names = ", ".join(bad_leaves) or "<unknown>"
        super().__init__(
            f"simulation diverged by step {step}: non-finite values in "
            f"state leaves [{names}] - no checkpoint written for the "
            f"broken state")

    def incident_payload(self) -> dict:
        return {}


class LaneFault(SimulationDiverged):
    """One or more lanes of a fleet chunk went bad while the REST of the
    fleet advanced normally. Carries the post-chunk lane-stacked state
    so the supervisor patches only the failing lanes' slices and resumes
    from ``step``."""

    kind = "lane_fault"

    def __init__(self, step: int, lanes, lane_reasons: dict,
                 vitals, fleet_size: int, state=None,
                 bad_leaves: Optional[dict] = None):
        self.lanes = list(lanes)
        self.lane_reasons = dict(lane_reasons)
        self.vitals = vitals
        self.fleet_size = int(fleet_size)
        self.state = state                 # post-chunk stacked state
        self.lane_bad_leaves = dict(bad_leaves or {})
        union = sorted({leaf for ls in self.lane_bad_leaves.values()
                        for leaf in ls})
        RuntimeError.__init__(
            self,
            f"lane fault at step {step}: lanes {self.lanes} of "
            f"{self.fleet_size} failed "
            f"({ {k: v for k, v in self.lane_reasons.items()} })")
        self.step = step
        self.bad_leaves = union

    def incident_payload(self) -> dict:
        vit = self.vitals
        return {
            "lanes": self.lanes,
            "lane_reasons": self.lane_reasons,
            "fleet_size": self.fleet_size,
            "lane_bad_leaves": self.lane_bad_leaves,
            "vitals": (np.asarray(vit).tolist()
                       if vit is not None else None),
        }


def _float_leaves(state):
    return [(p, leaf) for p, leaf in flatten_with_path(state)
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]


def _state_device(state):
    for _, leaf in flatten_with_path(state):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _finite_flag(state) -> torch.Tensor:
    """0-dim bool tensor on the state's device: every floating leaf of
    ``state`` is finite. No host read."""
    flags = [torch.isfinite(leaf).all() for _, leaf in _float_leaves(state)]
    if not flags:
        return torch.ones((), dtype=torch.bool, device=_state_device(state))
    return torch.stack(flags).all()


def _finite_flag_lanes(state) -> torch.Tensor:
    """(B,) float32 per-lane finite flags of a lane-stacked state."""
    out = None
    for _, leaf in _float_leaves(state):
        f = torch.isfinite(leaf).reshape(leaf.shape[0], -1).all(dim=1)
        out = f if out is None else out & f
    if out is None:
        raise ValueError("state has no floating leaves")
    return out.to(torch.float32)


def _bad_leaf_names(state) -> list:
    return [keystr(p) for p, leaf in _float_leaves(state)
            if not bool(torch.isfinite(leaf).all())]


# Rematerialization policies for differentiable chunks: what reverse
# mode may SAVE inside each step of a chunk. "full" saves nothing
# (recompute the step from its input); "dots" saves the outputs of the
# matrix products (aten mm / addmm / bmm) and recomputes the rest;
# "dots_no_batch" saves mm / addmm only. Names, not callables, so
# RunConfig stays plain data.
REMAT_POLICIES = {
    "full": None,
    "dots": ("mm", "addmm", "bmm"),
    "dots_no_batch": ("mm", "addmm"),
}


def checkpointed_step(step, remat: str):
    """Wrap ``step(state, dt)`` (or any function of tensors and pytrees
    of them, a design objective say) in non-reentrant
    ``torch.utils.checkpoint`` under the named policy."""
    from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                        create_selective_checkpoint_contexts)

    saved = REMAT_POLICIES[remat]
    kw = {}
    if saved is not None:
        ops = {getattr(torch.ops.aten, name).default for name in saved}

        def policy(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in ops
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)

    @functools.wraps(step)
    def wrapped(*args):
        return checkpoint(step, *args, use_reentrant=False, **kw)

    return wrapped


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
    donate: bool = False              # the reference's buffer donation:
    #   accepted and forced off under remat and by ResilientDriver, as
    #   there; eager PyTorch has no donation, so it changes nothing else
    remat: Optional[str] = None       # a REMAT_POLICIES name: each step
    #   of a chunk runs under torch.utils.checkpoint, so reverse mode
    #   through a chunk keeps one state per step

    def __post_init__(self):
        if self.remat is not None and self.remat not in REMAT_POLICIES:
            raise ValueError(
                f"RunConfig.remat must be one of "
                f"{sorted(REMAT_POLICIES)} or None, got {self.remat!r}")
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

    ``health_probe`` (a :class:`~ibamr_tpu_torch.utils.health.HealthProbe`)
    replaces the per-chunk finite flag by its vitals vector at the same
    one read per chunk; its ``check`` triages on the host and raises
    ``HealthDegraded`` before any callback sees the degraded state.
    ``recorder`` (a :class:`~ibamr_tpu_torch.utils.flight_recorder.
    FlightRecorder`) copies the pre-chunk state before every chunk.
    ``shadow_audit`` (a :class:`~ibamr_tpu_torch.solvers.escalation.
    ShadowAuditor`) re-runs one fluid substep at f64 every N chunks and
    raises ``PrecisionDrift`` before the checkpoint cadence can persist a
    drifted state.

    ``lanes=B`` runs a lane-stacked fleet: dt becomes the host vector
    ``lane_dt`` and ``lane_alive`` freezes quarantined lanes; the
    supervisor changes both between chunks. ``fleet_step_wrap`` wraps
    the STACKED step ``(state, dt) -> state`` (``dt`` the (B,) tensor of
    lane dts on the state's device), as the lane fault injectors need.
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
                 lanes: Optional[int] = None,
                 fleet_step_wrap: Optional[Callable] = None,
                 lane_mesh=None):
        if lane_mesh is not None:
            raise NotImplementedError(
                "HierarchyDriver(lane_mesh=...) is not ported: it shards "
                "lanes over devices and waits for the port of parallel/")
        self.integ = integ
        self.cfg = cfg
        self.viz_fn = viz_fn
        self.metrics_fn = metrics_fn
        self.regrid_fn = regrid_fn
        self.checkpoint_fn = checkpoint_fn
        self.timer = timer                 # times the chunks, not callbacks
        self.timer_name = timer_name
        self.health_probe = health_probe
        self.recorder = recorder
        self.shadow_audit = shadow_audit
        self.last_vitals = None            # host record of the last chunk
        self.last_chunk_wall_s = None      # wall seconds incl. the sync
        self.history = []
        self.host_reads = 0                # device-to-host reads by run()
        self._base_step = step_fn if step_fn is not None else integ.step
        self._chunks = {}
        # distinct input signatures (leaf shapes and dtypes) seen per
        # chunk length: the reference's no-retrace observable, kept so a
        # fleet's recovery can be shown to change values, never shapes
        self.trace_counts = {}
        self._trace_sigs = {}
        if lanes is not None and lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes!r}")
        if lanes is not None and cfg.cfl is not None:
            raise ValueError(
                "cfg.cfl adaptive dt is not supported in fleet mode - "
                "lanes carry independent per-lane dt (driver.lane_dt)")
        self.lanes = lanes
        self.fleet_step_wrap = fleet_step_wrap
        self.lane_mesh = None
        if lanes is not None:
            self.lane_dt = np.full(lanes, float(cfg.dt), dtype=float)
            self.lane_alive = np.ones(lanes, dtype=bool)
        else:
            self.lane_dt = None
            self.lane_alive = None

    @property
    def donates(self) -> bool:
        """The reference's donation decision (``cfg.donate`` unless
        ``cfg.remat`` is set); nothing is donated in eager PyTorch."""
        return bool(self.cfg.donate) and self.cfg.remat is None

    def _record_sig(self, n: int, sig) -> None:
        sigs = self._trace_sigs.setdefault(n, set())
        sigs.add(sig)
        self.trace_counts[n] = len(sigs)

    @staticmethod
    def _leaf_sig(state) -> tuple:
        return tuple((tuple(leaf.shape), str(leaf.dtype))
                     for _, leaf in flatten_with_path(state)
                     if isinstance(leaf, torch.Tensor))

    def _chunk(self, n: int):
        """The chunk of ``n`` steps: ``chunk(state, dt) -> (state,
        health)`` (fleet: ``chunk(state, dt_vec, alive)``), ``health``
        the finite flag or the vitals, still on the device."""
        if n not in self._chunks:
            if self.lanes is not None:
                self._chunks[n] = self._build_fleet_chunk(n)
                return self._chunks[n]
            step = self._base_step
            if self.cfg.remat is not None:
                step = checkpointed_step(step, self.cfg.remat)
            probe = self.health_probe

            def chunk(state, dt):
                self._record_sig(n, (self._leaf_sig(state),
                                     type(dt).__name__))
                for _ in range(n):
                    state = step(state, dt)
                if probe is not None:
                    return state, probe.measure(state, dt)
                return state, _finite_flag(state)

            self._chunks[n] = chunk
        return self._chunks[n]

    def _build_fleet_chunk(self, n: int):
        """The lane-batched chunk ``chunk(state, dt, alive)``: each
        step, every live lane's slice steps at its own dt and the lanes
        are re-stacked; then dead lanes' rows are restored from the
        pre-step state with ``torch.where`` (a select: healthy lanes'
        bits pass through). Lane k of B lanes is therefore bitwise the
        same scenario run at B=1, and a B=1 chunk bitwise the solo
        chunk."""
        from ibamr_tpu_torch.utils.lanes import (lane_mask_shape, lane_slice,
                                                 stack_lanes)

        base_step = self._base_step
        if self.cfg.remat is not None:
            base_step = checkpointed_step(base_step, self.cfg.remat)
        probe = self.health_probe
        B = int(self.lanes)
        wrap = self.fleet_step_wrap

        def chunk(state, dt, alive):
            dt_host = (dt.detach().cpu().numpy()
                       if isinstance(dt, torch.Tensor) else np.asarray(dt))
            dt_host = dt_host.astype(np.float64).reshape(B)
            alive_host = (alive.detach().cpu().numpy()
                          if isinstance(alive, torch.Tensor)
                          else np.asarray(alive)).astype(bool).reshape(B)
            self._record_sig(n, (B, self._leaf_sig(state), dt_host.shape,
                                 alive_host.shape))
            dev = _state_device(state)
            dt_dev = torch.as_tensor(dt_host, device=dev)
            alive_dev = torch.as_tensor(alive_host, device=dev)

            def stacked_step(s, _dt):
                return stack_lanes([
                    base_step(lane_slice(s, i), float(dt_host[i]))
                    if alive_host[i] else lane_slice(s, i)
                    for i in range(B)])

            step = wrap(stacked_step) if wrap is not None else stacked_step
            for _ in range(n):
                new = step(state, dt_dev)
                state = tree_map(
                    lambda nl, ol: torch.where(
                        lane_mask_shape(alive_dev, nl), nl, ol),
                    new, state)
            if probe is not None:
                # (7, B) per-lane vitals: still one read per chunk
                return state, torch.stack(
                    [probe.measure(lane_slice(state, i), float(dt_host[i]))
                     for i in range(B)], dim=1)
            return state, _finite_flag_lanes(state)

        return chunk

    def _triage_fleet(self, state, health, step: int):
        """Host-side per-lane triage of a fleet chunk's vitals (7, B) or
        finite flags (B,). Dead lanes are skipped; any live lane that
        went non-finite or triaged FATAL raises :class:`LaneFault`
        carrying the post-chunk state."""
        probe = self.health_probe
        alive = self.lane_alive
        B = self.lanes
        finite = (health[0] >= 1.0) if probe is not None \
            else (health >= 1.0)
        bad = [i for i in range(B) if alive[i] and not bool(finite[i])]
        reasons = {i: ["non_finite"] for i in bad}
        if probe is not None:
            verdicts = probe.check_lanes(health, step=step,
                                         dt=self.lane_dt, alive=alive)
            self.last_vitals = verdicts
            for i, v in enumerate(verdicts):
                if i in reasons or not alive[i]:
                    continue
                if v.get("fire"):
                    bad.append(i)
                    reasons[i] = list(v.get("reasons") or [])
        if bad:
            from ibamr_tpu_torch.utils.lanes import lane_slice
            bad_leaves = {i: _bad_leaf_names(lane_slice(state, i))
                          for i in bad if not bool(finite[i])}
            raise LaneFault(step, sorted(bad), reasons, health, B,
                            state=state, bad_leaves=bad_leaves)

    def _advance(self, n: int, state, chunk_args):
        """One chunk and its one host read."""
        state, health = self._chunk(n)(state, *chunk_args)
        health = health.detach().cpu().numpy()
        self.host_reads += 1
        return state, health

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
        fleet = self.lanes is not None
        probe = self.health_probe
        while step < cfg.num_steps:
            if cfg.cfl is not None:
                dt = float(min(cfg.dt, self.integ.cfl_dt(state, cfg.cfl)))
            n = min(cfg.health_interval, cfg.num_steps - step)
            for i in cadences:               # land exactly on cadences
                n = min(n, i - step % i)
            if fleet:
                snap_dt = self.lane_dt.copy()
                snap_alive = self.lane_alive.copy()
                chunk_args = (snap_dt, snap_alive)
            else:
                snap_dt, snap_alive = dt, None
                chunk_args = (dt,)
            if self.recorder is not None:
                # copy of the PRE-chunk state, which the chunk replaces
                self.recorder.snapshot(state, step=step, dt=snap_dt,
                                       length=n, integ=self.integ,
                                       cfg=cfg, alive=snap_alive)
            t0 = time.perf_counter()
            with _obs.span("driver/chunk", step=step, length=n):
                if self.timer is not None:
                    with self.timer.scope(self.timer_name):
                        state, health = self._advance(n, state, chunk_args)
                else:
                    state, health = self._advance(n, state, chunk_args)
            self.last_chunk_wall_s = time.perf_counter() - t0
            _CHUNKS_TOTAL.inc()
            _STEPS_TOTAL.inc(n)
            _CHUNK_WALL.observe(self.last_chunk_wall_s)
            # counters snapshot and device-memory watermarks, riding the
            # read that just happened (a no-op without a ledger)
            _obs.chunk_boundary(step=step + n,
                                chunk_wall_s=self.last_chunk_wall_s)
            if fleet:
                self._triage_fleet(state, health, step + n)
            else:
                finite = bool(health[0] >= 1.0) if probe is not None \
                    else bool(health)
                if not finite:
                    raise SimulationDiverged(step + n,
                                             _bad_leaf_names(state))
                if probe is not None:
                    self.last_vitals = probe.check(health, step=step + n,
                                                   dt=dt)
            if self.shadow_audit is not None and not fleet:
                self.shadow_audit.maybe_audit(self.integ, state, dt,
                                              step=step + n)
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
