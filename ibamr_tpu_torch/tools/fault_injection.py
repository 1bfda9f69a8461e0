"""Fault injection for the resilience layer (port of the parts of
``tools/fault_injection.py`` that the single-device drills need).

- :func:`nan_injector_step` / :func:`inject_nan` poison a named state
  leaf with NaN at a chosen step; the step wrapper is dt-gated, so a
  supervised retry at a backed-off dt passes cleanly.
- :func:`growth_injector_step`, :func:`volume_leak_injector`,
  :func:`stagnating_operator` and :func:`slow_metrics` are the silent
  failures the health probe, the solver escalation and the watchdog
  each exist to catch; :func:`bf16_drift_injector` biases the bf16
  spectral rounding (only the f64 shadow audit sees it);
  :func:`lane_nan_injector` / :func:`lane_drift_injector` poison ONE
  lane of a fleet chunk's stacked step.
- :func:`recorded` registers an armed fault in :data:`ACTIVE_INJECTORS`,
  so flight-recorder fingerprints carry it and
  :func:`apply_recorded_injectors` re-arms it in a replay.
- :func:`truncate_checkpoint` / :func:`corrupt_checkpoint` /
  :func:`drop_sidecar` / :func:`failing_checkpoint_writes` damage
  checkpoints the ways a crash or a bad disk does.
- :func:`run_smoke`, :func:`run_silent_smoke`, :func:`run_replay_smoke`
  and :func:`run_fleet_smoke` are the end-to-end drills; each raises on
  a failed expectation and returns a one-line summary dict. They run on
  ``device`` (the GPU unless ``device="cpu"``):
  ``python -m ibamr_tpu_torch.tools.fault_injection --smoke``.

Every step wrapper acts with ``torch.where`` on device values, so it
adds no host read to a step. The sharded, elastic, soak, design and
assimilation drills wait for the ports of their subsystems.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from ibamr_tpu_torch.utils.tree import flatten_with_path, keystr, leaves
from ibamr_tpu_torch.utils.tree import map_with_path


# ---------------------------------------------------------------------------
# NaN injection
# ---------------------------------------------------------------------------

def _is_float(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


def _match_paths(state, leaf_path: str):
    """Key paths containing ``leaf_path`` (``"u[0]"`` matches the first
    MAC velocity component of an INS state)."""
    return [keystr(p) for p, _ in flatten_with_path(state)
            if leaf_path in keystr(p)]


def _map_matching(state, leaf_path: str, fn):
    """``state`` with ``fn(leaf)`` applied to every floating leaf whose
    key path contains ``leaf_path``; raises when nothing matches (a
    typo'd path must not silently inject nothing)."""
    hit = []

    def visit(path, leaf):
        if leaf_path in keystr(path) and _is_float(leaf):
            hit.append(keystr(path))
            return fn(leaf)
        return leaf

    out = map_with_path(visit, state)
    if not hit:
        raise KeyError(f"no floating leaf path contains {leaf_path!r}; "
                       f"available: {_match_paths(state, '')}")
    return out


def inject_nan(state, leaf_path: str):
    """``state`` with NaN written into every floating leaf whose path
    contains ``leaf_path``."""
    return _map_matching(state, leaf_path,
                         lambda leaf: torch.full_like(leaf, float("nan")))


def _attr(state, dotted: str):
    for attr in dotted.split("."):
        state = getattr(state, attr)
    return state


def nan_injector_step(step_fn, at_step: int, leaf_path: str = "u",
                      dt_gate: float | None = None,
                      step_attr: str = "k"):
    """Wrap ``step_fn(state, dt) -> state`` so the stepped state comes
    out poisoned (NaN in every floating leaf matching ``leaf_path``)
    exactly when its step counter ``state.<step_attr>`` (dotted, e.g.
    ``"ins.k"``) equals ``at_step``: a ``torch.where`` on the device
    counter, no host read. ``dt_gate`` arms the fault only while
    ``dt >= dt_gate``, so a supervised retry at a backed-off dt passes."""
    def wrapped(state, dt):
        out = step_fn(state, dt)
        fire = _attr(out, step_attr) == at_step
        if dt_gate is not None and not float(dt) >= dt_gate:
            fire = torch.zeros_like(fire)
        return _map_matching(
            out, leaf_path,
            lambda leaf: torch.where(fire, torch.full_like(
                leaf, float("nan")), leaf))

    return wrapped


# ---------------------------------------------------------------------------
# Silent-failure injectors
# ---------------------------------------------------------------------------

def growth_injector_step(step_fn, rate: float = 1.5,
                         leaf_path: str = "u",
                         dt_gate: float | None = None):
    """Wrap ``step_fn`` so every floating leaf matching ``leaf_path`` is
    multiplied by ``rate`` per step: a FINITE exponential blow-up.
    ``dt_gate`` arms it only while ``dt >= dt_gate``."""
    def wrapped(state, dt):
        out = step_fn(state, dt)
        factor = rate if dt_gate is None or float(dt) >= dt_gate else 1.0
        return _map_matching(out, leaf_path, lambda leaf: leaf * factor)

    return wrapped


def _tree_dot(x, y) -> torch.Tensor:
    return sum(torch.sum(a * b) for a, b in zip(leaves(x), leaves(y)))


def stagnating_operator(A, direction=None):
    """Wrap a pytree linear operator so it is SINGULAR along
    ``direction`` (default: the all-ones pytree): any rhs with a
    component outside the crippled range leaves a residual floor no
    Krylov iteration passes, a deterministic stagnating solve."""
    from ibamr_tpu_torch.solvers.krylov import tree_axpy

    def wrapped(x):
        e = direction if direction is not None \
            else map_with_path(lambda _, v: torch.ones_like(v), x)
        coef = _tree_dot(e, x) / _tree_dot(e, e)
        return A(tree_axpy(-coef, e, x))

    return wrapped


def slow_metrics(sleep_s: float, at_steps=None, metrics_fn=None):
    """A ``metrics_fn`` wrapper that sleeps ``sleep_s`` on the host, the
    watchdog drill's stalled chunk; ``at_steps`` limits the stall to the
    named post-chunk steps (``None`` = every chunk)."""
    at = None if at_steps is None else {int(s) for s in at_steps}

    def wrapped(state, step):
        if at is None or int(step) in at:
            time.sleep(sleep_s)
        return metrics_fn(state, step) if metrics_fn is not None else None

    return wrapped


# ---------------------------------------------------------------------------
# Recorded injectors: faults the flight recorder fingerprints, so a
# replay re-arms them. ACTIVE_INJECTORS maps name -> JSON-safe params of
# every armed recorded fault.
# ---------------------------------------------------------------------------

ACTIVE_INJECTORS: dict = {}


@contextlib.contextmanager
def recorded(name: str, **params):
    """Register an armed fault in ``ACTIVE_INJECTORS`` for the block, so
    fingerprints (and replay capsules) carry it; the caller still applies
    the injector. Params must let :func:`apply_recorded_injectors`
    rebuild it."""
    if name in ACTIVE_INJECTORS:
        raise ValueError(f"recorded injector {name!r} already armed")
    ACTIVE_INJECTORS[name] = dict(params)
    try:
        yield params
    finally:
        ACTIVE_INJECTORS.pop(name, None)


@contextlib.contextmanager
def bf16_drift_injector(scale: float = 0.35):
    """Bias the bf16 spectral path's split-real operand rounding
    (``solvers/spectral_plan._round_complex``) by ``(1 + scale)``: a
    smooth, finite corruption that only the bf16 path runs, so precision
    escalation or a ``spectral_dtype=f64`` replay cures it. Registers
    itself as ``bf16_drift``."""
    with _bare_bf16_drift(scale):
        with recorded("bf16_drift", scale=float(scale)):
            yield


def volume_leak_injector(step_fn, rate: float = 0.01,
                         leaf_path: str = "X",
                         dt_gate: float | None = None):
    """Wrap ``step_fn`` so every floating leaf matching ``leaf_path``
    (default: the IB markers) contracts toward its centroid by ``rate``
    per step: a secular enclosed-volume drift only the volume sentinel
    sees. ``dt_gate`` arms it only while ``dt >= dt_gate``."""
    def wrapped(state, dt):
        out = step_fn(state, dt)
        f = 1.0 - rate if dt_gate is None or float(dt) >= dt_gate else 1.0

        def leak(leaf):
            if leaf.ndim < 1:
                return leaf
            c = torch.mean(leaf, dim=0, keepdim=True)
            return c + (leaf - c) * f

        return _map_matching(out, leaf_path, leak)

    return wrapped


def _lane_mask(fire: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return fire.reshape((fire.shape[0],) + (1,) * (leaf.ndim - 1))


def lane_nan_injector(stacked_step, at_step: int, lane: int,
                      fleet_size: int, leaf_path: str = "u",
                      dt_gate: float | None = None,
                      step_attr: str = "k"):
    """Wrap a STACKED step ``(state, dt_vec) -> state`` (lane-stacked
    leaves, ``dt_vec`` the (B,) lane dts on the device) so exactly lane
    ``lane``'s rows of every floating leaf matching ``leaf_path`` come
    out NaN when that lane's step counter equals ``at_step``. Other
    lanes' rows pass through bitwise (``torch.where``). ``dt_gate`` arms
    the fault only while the lane's dt is ``>= dt_gate``."""
    def wrapped(state, dt):
        out = stacked_step(state, dt)
        k = _attr(out, step_attr)
        ids = torch.arange(int(fleet_size), device=k.device)
        fire = (ids == lane) & (k == at_step)
        if dt_gate is not None:
            fire = fire & (torch.as_tensor(dt, device=k.device) >= dt_gate)
        return _map_matching(
            out, leaf_path,
            lambda leaf: torch.where(_lane_mask(fire, leaf), torch.full_like(
                leaf, float("nan")), leaf))

    return wrapped


def lane_drift_injector(stacked_step, rate: float = 1.5, lane: int = 0,
                        fleet_size: int = 1, leaf_path: str = "u",
                        dt_gate: float | None = None):
    """Wrap a STACKED step so lane ``lane``'s rows of every floating
    leaf matching ``leaf_path`` grow by ``rate`` per step, a finite
    blow-up confined to one lane."""
    def wrapped(state, dt):
        out = stacked_step(state, dt)
        dev = leaves(out)[0].device
        fire = torch.arange(int(fleet_size), device=dev) == lane
        if dt_gate is not None:
            fire = fire & (torch.as_tensor(dt, device=dev) >= dt_gate)
        return _map_matching(
            out, leaf_path,
            lambda leaf: leaf * torch.where(
                _lane_mask(fire, leaf), torch.full_like(leaf[:1], rate),
                torch.ones_like(leaf[:1])))

    return wrapped


@contextlib.contextmanager
def apply_recorded_injectors(injectors: dict):
    """Re-arm the faults a replay manifest recorded: ``bf16_drift`` is
    entered for the block; step-level faults (``nan``, ``growth``,
    ``volume_leak``, ``lane_nan``, ``lane_drift``) come through the
    yielded ``wrap(step_fn)``. Unknown names raise: dropping a recorded
    fault would make every replay of it read as cured."""
    factories = {"nan": nan_injector_step, "growth": growth_injector_step,
                 "volume_leak": volume_leak_injector,
                 "lane_nan": lane_nan_injector,
                 "lane_drift": lane_drift_injector}
    wrappers = []
    with contextlib.ExitStack() as stack:
        for name, params in (injectors or {}).items():
            params = dict(params)
            if name == "bf16_drift":
                stack.enter_context(
                    _bare_bf16_drift(scale=params.get("scale", 0.35)))
            elif name in factories:
                wrappers.append(lambda fn, f=factories[name], p=params:
                                f(fn, **p))
            else:
                raise KeyError(
                    f"replay manifest records unknown injector {name!r}")

        def wrap(step_fn):
            for w in wrappers:
                step_fn = w(step_fn)
            return step_fn

        yield wrap


@contextlib.contextmanager
def _bare_bf16_drift(scale: float):
    """The bf16_drift patch WITHOUT the ACTIVE_INJECTORS registration
    (a replay must not re-record the fault it re-arms)."""
    from ibamr_tpu_torch.solvers import spectral_plan as sp

    orig = sp._round_complex

    def biased(z, sdtype):
        return orig(z, sdtype) * (1.0 + scale)

    sp._round_complex = biased
    try:
        yield
    finally:
        sp._round_complex = orig


# ---------------------------------------------------------------------------
# On-disk checkpoint damage
# ---------------------------------------------------------------------------

def _ckpt_path(directory: str, step: int, ext: str = "npz") -> str:
    return os.path.join(directory, f"restore.{step:08d}.{ext}")


def truncate_checkpoint(directory: str, step: int,
                        keep_bytes: int | None = None) -> str:
    """Chop the array file short (default: half)."""
    path = _ckpt_path(directory, step)
    size = os.path.getsize(path)
    keep = size // 2 if keep_bytes is None else keep_bytes
    with open(path, "r+b") as f:
        f.truncate(keep)
    return path


def corrupt_checkpoint(directory: str, step: int,
                       offset: int | None = None) -> str:
    """Flip one byte WITHOUT changing the size (only the CRC sees it)."""
    path = _ckpt_path(directory, step)
    size = os.path.getsize(path)
    pos = size // 2 if offset is None else offset
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))
    return path


def drop_sidecar(directory: str, step: int) -> str:
    """Remove the JSON commit marker."""
    path = _ckpt_path(directory, step, "json")
    os.remove(path)
    return path


@contextlib.contextmanager
def failing_checkpoint_writes(fail_calls, exc_type=OSError):
    """Patch ``checkpoint._write_arrays`` so the 0-based call indices in
    ``fail_calls`` raise ``exc_type``; the async writer's retry looks the
    symbol up per attempt, so ``{0}`` fails only the first attempt.
    Yields the call counter dict."""
    from ibamr_tpu_torch.utils import checkpoint as _ckpt

    fail = set(fail_calls)
    orig = _ckpt._write_arrays
    counter = {"calls": 0}

    def flaky(*args, **kwargs):
        i = counter["calls"]
        counter["calls"] += 1
        if i in fail:
            raise exc_type(f"injected checkpoint write failure (call {i})")
        return orig(*args, **kwargs)

    _ckpt._write_arrays = flaky
    try:
        yield counter
    finally:
        _ckpt._write_arrays = orig


# ---------------------------------------------------------------------------
# The drills
# ---------------------------------------------------------------------------

def _tg16_setup(spectral_dtype=None, device="cuda", dtype=torch.float32):
    """The drills' 16^2 Taylor-Green INS set-up."""
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator

    g = StaggeredGrid(n=(16, 16), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    integ = INSStaggeredIntegrator(g, rho=1.0, mu=0.05, dtype=dtype,
                                   spectral_dtype=spectral_dtype,
                                   device=device)
    dev = integ.device
    xf, yc = g.face_centers(0, dtype, dev)
    xc, yf = g.face_centers(1, dtype, dev)
    u = torch.sin(2 * np.pi * xf) * torch.cos(2 * np.pi * yc) + 0 * yc
    v = -torch.cos(2 * np.pi * xc) * torch.sin(2 * np.pi * yf) + 0 * xc
    return integ, integ.initialize(u0_arrays=(u, v))


@contextlib.contextmanager
def _workdir(directory):
    if directory is not None:
        yield directory
        return
    with tempfile.TemporaryDirectory(prefix="ibamr_torch_drill_") as d:
        yield d


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all())


def run_smoke(directory: str | None = None, device="cuda",
              dtype=torch.float32) -> dict:
    """End-to-end resilience drill on a 16^2 INS run:

    1. supervised recovery: NaN injected at step 6 diverges the run; the
       ResilientDriver rolls back to the step-4 checkpoint, halves dt
       (which disarms the dt-gated injector) and completes;
    2. corruption fallback: a byte flipped in the newest checkpoint makes
       ``latest_step`` / ``restore_checkpoint`` fall back to the newest
       verified one;
    3. flaky-write retry: the next write's first attempt fails and the
       async writer's retry still lands a verified file.
    """
    import warnings

    from ibamr_tpu_torch.utils.checkpoint import (AsyncCheckpointWriter,
                                                  latest_step,
                                                  restore_checkpoint,
                                                  verify_checkpoint)
    from ibamr_tpu_torch.utils.hierarchy_driver import (HierarchyDriver,
                                                        RunConfig)
    from ibamr_tpu_torch.utils.supervisor import ResilientDriver

    with _workdir(directory) as directory:
        integ, st0 = _tg16_setup(device=device, dtype=dtype)
        dt0 = 1e-3
        cfg = RunConfig(dt=dt0, num_steps=12, restart_interval=4,
                        health_interval=2)
        drv = HierarchyDriver(
            integ, cfg,
            step_fn=nan_injector_step(integ.step, at_step=6,
                                      leaf_path="u[0]",
                                      dt_gate=dt0 * 0.99))
        sup = ResilientDriver(drv, directory, max_retries=2,
                              dt_backoff=0.5, handle_signals=False)
        out = sup.run(st0)
        if int(out.k) != cfg.num_steps:
            raise AssertionError(f"supervised run stopped at {int(out.k)}")
        if not _finite(out.u[0]):
            raise AssertionError("supervised run finished non-finite")
        div = [r for r in sup.incidents if r["event"] == "divergence"]
        if len(div) != 1 or div[0]["rollback_step"] != 4:
            raise AssertionError(f"unexpected incidents: {sup.incidents}")

        newest = latest_step(directory)
        corrupt_checkpoint(directory, newest)
        if verify_checkpoint(directory, newest):
            raise AssertionError("byte flip went undetected")
        fell_back = latest_step(directory)
        if fell_back is None or fell_back >= newest:
            raise AssertionError("latest_step did not fall back")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, got, _ = restore_checkpoint(directory, template=out)
        if got != fell_back:
            raise AssertionError("restore did not fall back")

        w = AsyncCheckpointWriter(directory, keep=3)
        try:
            with failing_checkpoint_writes({0}) as ctr:
                w.save(out, 99)
                w.wait()
            if ctr["calls"] != 2:
                raise AssertionError(f"expected a retry, saw {ctr}")
        finally:
            w.close()
        if not verify_checkpoint(directory, 99):
            raise AssertionError("retried write is not verified")

        return {"fault_smoke": "ok", "divergence_incidents": len(div),
                "rollback_step": div[0]["rollback_step"],
                "corrupt_step_skipped": newest,
                "fallback_step": fell_back,
                "flaky_write_calls": ctr["calls"],
                "incidents": sup.incidents, "state": out}


def run_silent_smoke(directory: str | None = None, device="cuda",
                     dtype=torch.float32) -> dict:
    """End-to-end SILENT-failure drill:

    1. health precursor: a finite exponential velocity growth trips the
       probe's functional-growth WARN streak; the supervisor rolls back
       and backs dt off before any non-finite value exists;
    2. solver escalation: a diagonal system restarted GMRES cannot solve
       at the base geometry nor at restarts_x4 converges at
       deep_x4_inner_x2; behind :func:`stagnating_operator` the chain
       is exhausted and ``SolverBreakdown`` raised;
    3. watchdog: a slow host callback stalls a supervised run; the
       watchdog records a ``stall`` incident into ``incidents.jsonl``.
    """
    from ibamr_tpu_torch.solvers.escalation import (SolverBreakdown,
                                                    escalate_solve)
    from ibamr_tpu_torch.solvers.krylov import fgmres
    from ibamr_tpu_torch.utils.health import HealthProbe
    from ibamr_tpu_torch.utils.hierarchy_driver import (HierarchyDriver,
                                                        RunConfig)
    from ibamr_tpu_torch.utils.supervisor import ResilientDriver
    from ibamr_tpu_torch.utils.watchdog import RunWatchdog, read_heartbeat

    with _workdir(directory) as directory:
        integ, st0 = _tg16_setup(device=device, dtype=dtype)
        dt0 = 1e-3
        probe = HealthProbe.for_integrator(integ, func_growth_warn=8.0,
                                           sustain=2)
        cfg = RunConfig(dt=dt0, num_steps=12, restart_interval=4,
                        health_interval=2)
        drv = HierarchyDriver(
            integ, cfg,
            step_fn=growth_injector_step(integ.step, rate=1.5,
                                         leaf_path="u",
                                         dt_gate=dt0 * 0.99),
            health_probe=probe)
        sup = ResilientDriver(drv, os.path.join(directory, "health"),
                              max_retries=2, dt_backoff=0.5,
                              handle_signals=False)
        out = sup.run(st0)
        if int(out.k) != cfg.num_steps:
            raise AssertionError(f"health drill stopped at {int(out.k)}")
        if not _finite(out.u[0]):
            raise AssertionError("health drill finished non-finite")
        if any(rec["finite"] < 1.0 for rec in probe.history):
            raise AssertionError("a non-finite value materialized - the "
                                 "precursor fired too late")
        hd = [r for r in sup.incidents
              if r["event"] == "divergence"
              and r.get("kind") == "health_degraded"]
        if len(hd) != 1 or hd[0]["rollback_step"] != 4:
            raise AssertionError(f"unexpected incidents: {sup.incidents}")
        if not hd[0].get("reasons"):
            raise AssertionError("health incident carries no reasons")

        dev = integ.device
        w = torch.logspace(0, 2, 48, dtype=dtype, device=dev)
        A = lambda x: w * x                 # noqa: E731
        b = torch.ones(48, dtype=dtype, device=dev)

        def attempt(level, _i):
            return fgmres(A, b, m=8 * level.m_scale, tol=1e-4,
                          restarts=1 * level.restarts_scale)

        esc_incidents = []
        sol = escalate_solve(attempt, context="silent_smoke_diag",
                             on_incident=esc_incidents.append)
        if not bool(sol.converged):
            raise AssertionError("escalated solve did not converge")
        if len(esc_incidents) != 1 \
                or esc_incidents[0]["event"] != "solver_escalation" \
                or not esc_incidents[0]["recovered"] \
                or len(esc_incidents[0]["attempts"]) != 3:
            raise AssertionError(f"unexpected escalation record: "
                                 f"{esc_incidents}")
        As = stagnating_operator(A)

        def attempt_stag(level, _i):
            return fgmres(As, b, m=8 * level.m_scale, tol=1e-4,
                          restarts=1 * level.restarts_scale)

        breakdown = None
        try:
            escalate_solve(attempt_stag, context="silent_smoke_stagnant",
                           on_incident=esc_incidents.append, step=42)
        except SolverBreakdown as e:
            breakdown = e
        if breakdown is None or breakdown.step != 42:
            raise AssertionError("stagnating solve did not break down")
        if esc_incidents[-1]["event"] != "solver_breakdown" \
                or esc_incidents[-1]["recovered"]:
            raise AssertionError(f"unexpected breakdown record: "
                                 f"{esc_incidents[-1]}")

        cfg2 = RunConfig(dt=dt0, num_steps=8, health_interval=2)
        drv2 = HierarchyDriver(integ, cfg2)
        drv2.run(st0, start_step=6)         # warm the step
        drv2.metrics_fn = slow_metrics(1.2, at_steps={4})
        wd_dir = os.path.join(directory, "wd")
        wd = RunWatchdog(heartbeat_path=wd_dir, interval_s=0.05,
                         stall_factor=3.0, min_stall_s=0.4)
        sup2 = ResilientDriver(drv2, wd_dir, handle_signals=False,
                               watchdog=wd)
        sup2.run(st0)
        stalls = [r for r in sup2.incidents if r["event"] == "stall"]
        if not stalls or stalls[0].get("kind") != "stall":
            raise AssertionError(f"no stall incident: {sup2.incidents}")
        hb = read_heartbeat(os.path.join(wd_dir, "heartbeat.json"))
        if hb is None or hb["step"] is None:
            raise AssertionError(f"no usable heartbeat: {hb}")

        return {"silent_smoke": "ok", "escalations": esc_incidents,
                "health_rollback_step": hd[0]["rollback_step"],
                "health_reasons": hd[0]["reasons"],
                "escalation_recovered_level": esc_incidents[0]["level"],
                "breakdown_attempts": len(breakdown.attempts),
                "stall_incidents": len(stalls),
                "heartbeat_step": hb["step"],
                "incidents": sup.incidents, "state": out}


def run_replay_smoke(directory: str | None = None, device="cuda") -> dict:
    """End-to-end REPLAY drill:

    1. precision escalation: a 16^2 INS run at ``spectral_dtype="bf16"``
       with a biased bf16 rounding (:func:`bf16_drift_injector`) trips
       the f64 :class:`~ibamr_tpu_torch.solvers.escalation.ShadowAuditor`
       on the first chunk; the supervisor dumps a capsule, escalates
       bf16 -> f32 with dt unchanged, rolls back and completes;
    2. bitwise replay: ``tools.replay`` re-executes the capsule with the
       recorded injector re-armed -> verdict ``reproduced``;
    3. classification: the same capsule with ``spectral_dtype=f64`` no
       longer drifts -> verdict ``precision_dependent``.
    """
    from ibamr_tpu_torch.solvers.escalation import ShadowAuditor
    from ibamr_tpu_torch.tools.replay import replay
    from ibamr_tpu_torch.utils.flight_recorder import FlightRecorder
    from ibamr_tpu_torch.utils.hierarchy_driver import (HierarchyDriver,
                                                        RunConfig)
    from ibamr_tpu_torch.utils.supervisor import ResilientDriver

    with _workdir(directory) as directory:
        integ, st0 = _tg16_setup(spectral_dtype="bf16", device=device)
        cfg = RunConfig(dt=1e-3, num_steps=8, restart_interval=4,
                        health_interval=2)
        drv = HierarchyDriver(integ, cfg,
                              recorder=FlightRecorder(capacity=4),
                              shadow_audit=ShadowAuditor(every=1,
                                                         bound=0.02))
        sup = ResilientDriver(drv, directory, max_retries=2,
                              handle_signals=False)
        with bf16_drift_injector(scale=0.35):
            out = sup.run(st0)
        if int(out.k) != cfg.num_steps:
            raise AssertionError(f"replay drill stopped at {int(out.k)}")
        if not _finite(out.u[0]):
            raise AssertionError("replay drill finished non-finite")
        esc = [r for r in sup.incidents
               if r["event"] == "precision_escalation"]
        if len(esc) != 1:
            raise AssertionError(f"unexpected incidents: {sup.incidents}")
        rec = esc[0]
        if rec.get("schema") != 3 or not rec.get("replay"):
            raise AssertionError(f"incident is not replayable v3: {rec}")
        if (rec["spectral_dtype_before"], rec["spectral_dtype_after"]) \
                != ("bf16", "f32"):
            raise AssertionError(f"unexpected escalation: {rec}")
        if rec["dt"] != cfg.dt:
            raise AssertionError("precision escalation must not back "
                                 "dt off")
        base = replay(rec["replay"])
        if base["verdict"] != "reproduced" or not base["bitwise"]:
            raise AssertionError(f"baseline replay: {base}")
        cured = replay(rec["replay"], overrides={"spectral_dtype": "f64"})
        if cured["verdict"] != "precision_dependent":
            raise AssertionError(f"override replay: {cured}")
        return {"replay_smoke": "ok",
                "escalation_step": rec["step"],
                "spectral_dtype_after": rec["spectral_dtype_after"],
                "drift": rec.get("drift"),
                "baseline_verdict": base["verdict"],
                "override_verdict": cured["verdict"],
                "capsule": rec["replay"],
                "incidents": sup.incidents, "state": out}


def run_fleet_smoke(directory: str | None = None, fleet_size: int = 8,
                    bad_lane: int = 5, device="cuda",
                    engine="pallas_packed", dtype=torch.float64) -> dict:
    """End-to-end FLEET drill: B lanes of the 32^3 IB shell (on
    ``engine``) with lane ``bad_lane`` poisoned at its 4th step by an
    un-gated :func:`lane_nan_injector`:

    1. the driver's per-lane triage raises ``LaneFault`` naming exactly
       that lane;
    2. the supervisor restores only that lane's slice from the newest
       fleet checkpoint and backs off its dt (one ``lane_rollback``); the
       fault re-fires, retries run out, and the lane is quarantined (one
       ``lane_quarantine``): restored rows, then frozen. The input
       signatures never change;
    3. every surviving lane's final state is bitwise its solo (B=1) run;
    4. the rollback's single-lane capsule replays bitwise ->
       ``reproduced``.
    """
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.tools.replay import replay
    from ibamr_tpu_torch.utils.flight_recorder import (FlightRecorder,
                                                       factory_spec)
    from ibamr_tpu_torch.utils.hierarchy_driver import (HierarchyDriver,
                                                        RunConfig)
    from ibamr_tpu_torch.utils.lanes import lane_slice, stack_lanes
    from ibamr_tpu_torch.utils.supervisor import ResilientDriver

    B, BAD = int(fleet_size), int(bad_lane)
    with _workdir(directory) as directory:
        kwargs = dict(n_cells=32, n_lat=16, n_lon=16, mu=0.05,
                      use_fast_interaction=engine,
                      dtype=str(dtype).replace("torch.", ""),
                      device=str(device))
        integ, st0 = build_shell_example(**dict(kwargs, dtype=dtype))
        lane_states = [st0._replace(ins=st0.ins._replace(
            u=tuple(c * (1.0 + 0.01 * i) + 1e-4 * (i + 1)
                    for c in st0.ins.u))) for i in range(B)]
        fleet0 = stack_lanes(lane_states)

        dt0 = 1e-3
        cfg = RunConfig(dt=dt0, num_steps=8, restart_interval=2,
                        health_interval=2)
        inj = dict(at_step=4, lane=BAD, fleet_size=B,
                   leaf_path="u[0]", step_attr="ins.k")
        with recorded("lane_nan", **inj):
            drv = HierarchyDriver(
                integ, cfg, lanes=B,
                fleet_step_wrap=lambda s: lane_nan_injector(s, **inj),
                recorder=FlightRecorder(capacity=4, spec=factory_spec(
                    "ibamr_tpu_torch.models.shell3d", "build_shell_example",
                    **kwargs)))
            sup = ResilientDriver(drv, directory, max_retries=1,
                                  dt_backoff=0.5, handle_signals=False)
            t0 = time.perf_counter()
            out = sup.run(fleet0)
            fleet_wall = time.perf_counter() - t0

        k = out.ins.k.cpu().numpy()
        healthy = [i for i in range(B) if i != BAD]
        if any(int(k[i]) != cfg.num_steps for i in healthy):
            raise AssertionError(f"healthy lanes did not finish: {k}")
        if drv.lane_alive[BAD]:
            raise AssertionError("bad lane was never quarantined")
        if not _finite(out.ins.u[0][BAD]):
            raise AssertionError("quarantined lane holds non-finite rows")
        if float(drv.lane_dt[BAD]) != dt0 * 0.5:
            raise AssertionError(
                f"bad lane dt not backed off once: {drv.lane_dt}")
        if any(float(d) != dt0 for i, d in enumerate(drv.lane_dt)
               if i != BAD):
            raise AssertionError("a healthy lane's dt was touched")
        rolls = [r for r in sup.incidents if r["event"] == "lane_rollback"]
        quars = [r for r in sup.incidents
                 if r["event"] == "lane_quarantine"]
        if len(rolls) != 1 or len(quars) != 1:
            raise AssertionError(f"unexpected incidents: "
                                 f"{[r['event'] for r in sup.incidents]}")
        if rolls[0]["lane"] != BAD or quars[0]["lane"] != BAD:
            raise AssertionError("incidents name the wrong lane")
        if not rolls[0]["from_checkpoint"]:
            raise AssertionError("rollback did not come from a "
                                 "verified checkpoint")
        if any(c != 1 for c in drv.trace_counts.values()):
            raise AssertionError(f"fleet recovery changed the chunk's "
                                 f"signature: {drv.trace_counts}")

        ref_cfg = RunConfig(dt=dt0, num_steps=8, health_interval=2)
        for i in healthy:
            ref = HierarchyDriver(integ, ref_cfg, lanes=1).run(
                stack_lanes([lane_states[i]]))
            got, want = leaves(lane_slice(out, i)), leaves(lane_slice(ref, 0))
            if any(not torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(
                    f"healthy lane {i} is not bitwise equal to its solo "
                    f"run")

        cap = rolls[0].get("replay")
        if not cap:
            raise AssertionError(f"rollback incident has no capsule: "
                                 f"{rolls[0]}")
        with open(os.path.join(cap, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("lane", {}).get("index") != BAD \
                or manifest.get("lane", {}).get("fleet_size") != B:
            raise AssertionError(f"capsule lane record wrong: "
                                 f"{manifest.get('lane')}")
        res = replay(cap)
        if res["verdict"] != "reproduced" or not res["bitwise"]:
            raise AssertionError(f"lane capsule replay: {res}")

        return {"fleet_smoke": "ok", "fleet_size": B, "bad_lane": BAD,
                "healthy_final_step": cfg.num_steps,
                "bad_lane_final_step": int(k[BAD]),
                "lane_rollbacks": len(rolls),
                "lane_quarantines": len(quars),
                "trace_counts": {str(n): c for n, c
                                 in drv.trace_counts.items()},
                "capsule": cap, "replay_verdict": res["verdict"],
                "fleet_wall_s": fleet_wall,
                "incidents": sup.incidents, "state": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run the port's resilience drills")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--silent-smoke", action="store_true")
    ap.add_argument("--replay-smoke", action="store_true")
    ap.add_argument("--fleet-smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    drills = [(args.smoke, run_smoke), (args.silent_smoke, run_silent_smoke),
              (args.replay_smoke, run_replay_smoke),
              (args.fleet_smoke, run_fleet_smoke)]
    if not any(on for on, _ in drills):
        ap.error("name at least one drill")
    for on, fn in drills:
        if on:
            res = fn(device=args.device)
            print(json.dumps({k: v for k, v in res.items()
                              if k not in ("incidents", "state", "escalations")},
                             default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
