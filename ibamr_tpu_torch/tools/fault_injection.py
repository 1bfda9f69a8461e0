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
- :func:`obs_dropout_injector`, :func:`obs_outlier_injector` and
  :func:`stale_obs_injector` wrap an assimilation cycle's sensor stream;
  :func:`member_divergence_injector` poisons one ensemble member.
- :func:`compile_storm_injector`, :func:`slow_lane_injector`,
  :func:`failing_build_injector` and :func:`kill_router_thread_injector`
  patch the warm-pool router's seams (slow builds, stragglers, failed
  and killed builds); :func:`mix_shift_injector` rotates an arrival
  schedule onto an unseen family and :func:`memory_pressure_injector`
  squeezes the executable cache's bytes ceiling.
- :func:`run_smoke`, :func:`run_silent_smoke`, :func:`run_replay_smoke`,
  :func:`run_fleet_smoke`, :func:`run_assim_smoke`,
  :func:`run_soak_smoke`, :func:`run_elastic_smoke` and
  :func:`run_design_smoke` (the inverse-design drill) are the
  end-to-end drills; each raises on a failed expectation and returns a
  one-line summary dict. They run on ``device`` (the GPU unless
  ``device="cpu"``):
  ``python -m ibamr_tpu_torch.tools.fault_injection --smoke``.

- :func:`corrupt_shard`, :func:`drop_shard`, :func:`tear_manifest` and
  :func:`stale_manifest_shard` damage sharded checkpoints;
  :func:`run_sharded_smoke` is the sharded-checkpoint drill and
  :func:`run_sharded_crash_child` its kill-mid-commit victim;
  ``run_fleet_smoke(mesh_shards=D)`` adds the lane-mesh leg
  (``--fleet-smoke --mesh 8``).

Every step wrapper acts with ``torch.where`` on device values, so it
adds no host read to a step.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import tempfile
import threading
import time

import numpy as np
import torch

from ibamr_tpu_torch.parallel.spmd import Blocks
from ibamr_tpu_torch.utils.tree import flatten_with_path, keystr, leaves
from ibamr_tpu_torch.utils.tree import map_with_path


# ---------------------------------------------------------------------------
# NaN injection
# ---------------------------------------------------------------------------

def _is_float(leaf) -> bool:
    return (isinstance(leaf, (torch.Tensor, Blocks))
            and leaf.is_floating_point())


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
    ``volume_leak``, ``lane_nan``, ``lane_drift``, ``member_divergence``)
    come through the yielded ``wrap(step_fn)``. Unknown names raise: dropping a recorded
    fault would make every replay of it read as cured."""
    factories = {"nan": nan_injector_step, "growth": growth_injector_step,
                 "volume_leak": volume_leak_injector,
                 "lane_nan": lane_nan_injector,
                 "lane_drift": lane_drift_injector,
                 "member_divergence": member_divergence_injector}
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


def _shard_path(directory: str, step: int, shard: int) -> str:
    from ibamr_tpu_torch.utils.checkpoint_sharded import (_shard_name,
                                                          _step_dir)

    return os.path.join(_step_dir(directory, step), _shard_name(shard))


def corrupt_shard(directory: str, step: int, shard: int = 0,
                  offset: int | None = None) -> str:
    """Flip one byte of ONE shard file without changing its size (only
    that shard's whole-file CRC in the manifest sees it)."""
    path = _shard_path(directory, step, shard)
    size = os.path.getsize(path)
    pos = size // 2 if offset is None else offset
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))
    return path


def drop_shard(directory: str, step: int, shard: int = 0) -> str:
    """Delete ONE shard file of a committed step (a lost host)."""
    path = _shard_path(directory, step, shard)
    os.remove(path)
    return path


def tear_manifest(directory: str, step: int) -> str:
    """Replace a step's manifest with a truncated (invalid-JSON) prefix,
    what a non-atomic manifest writer killed mid-write would leave."""
    from ibamr_tpu_torch.utils.checkpoint_sharded import _step_dir

    path = os.path.join(_step_dir(directory, step), "manifest.json")
    with open(path) as f:
        payload = f.read()
    with open(path, "w") as f:
        f.write(payload[: max(1, len(payload) // 2)].rstrip("}"))
    return path


def stale_manifest_shard(directory: str, step: int, shard: int = 0) -> str:
    """Rewrite ONE shard file after the manifest committed (arrays x 2: a
    valid npz with the wrong bytes), the stale-manifest-newer-shard mode
    of a restarted writer racing an old step."""
    path = _shard_path(directory, step, shard)
    with np.load(path) as z:
        arrays = {k: np.asarray(z[k]) * 2 for k in z.files}
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return path


def crash_state(step: int, n: int = 64) -> dict:
    """Closed-form deterministic trajectory: the state after ``step``
    iterations of a fixed contraction map (float64 numpy, so every
    process gets the same bits and a parent verifies a killed child's
    checkpoint by recomputing it)."""
    u = np.linspace(0.0, 1.0, n)
    for k in range(1, step + 1):
        u = np.cos(u) * 0.9 + 0.01 * k
    return {"u": u, "k": np.int64(step)}


def run_sharded_crash_child(directory: str, num_steps: int, interval: int,
                            keep: int = 3, n_devices: int = 8,
                            device="cuda") -> int:
    """The sharded kill-mid-commit victim: :func:`crash_state`'s
    trajectory laid out over an ``n_devices``-shard 1-D mesh, every
    checkpoint through ``save_sharded_checkpoint`` (widen the commit
    window with ``IBAMR_SHARDED_COMMIT_DELAY_S``). Resumes from the
    newest VERIFIED sharded step; prints ``START <k>``, ``SAVED <k>``
    and ``DONE`` markers."""
    from ibamr_tpu_torch.parallel.mesh import make_mesh
    from ibamr_tpu_torch.parallel.spmd import NamedSharding, P, pin
    from ibamr_tpu_torch.utils.checkpoint_sharded import (
        latest_sharded_step, restore_sharded, save_sharded_checkpoint)

    mesh = make_mesh(n_devices, max_axes=1, device=device)
    sh, rep = NamedSharding(mesh, P("x")), NamedSharding(mesh, P())
    dev = mesh.first_device

    def place(d):
        return {"u": pin(torch.as_tensor(d["u"], device=dev), sh),
                "k": pin(torch.as_tensor(d["k"], device=dev), rep)}

    start = latest_sharded_step(directory)
    if start is None:
        start, u = 0, crash_state(0)["u"]
    else:
        state, start, _ = restore_sharded(directory,
                                          place(crash_state(start)),
                                          step=start)
        u = state["u"].cpu().numpy()
    print(f"START {start}", flush=True)
    for k in range(start + 1, num_steps + 1):
        u = np.cos(u) * 0.9 + 0.01 * k
        if k % interval == 0:
            save_sharded_checkpoint(directory,
                                    place({"u": u, "k": np.int64(k)}), k,
                                    keep=keep, mesh=mesh)
            print(f"SAVED {k}", flush=True)
    print("DONE", flush=True)
    return num_steps


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
                    engine="pallas_packed", dtype=torch.float64,
                    mesh_shards: int = 0) -> dict:
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
       ``reproduced``;
    5. with ``mesh_shards`` D, the lane-mesh leg: the same supervised
       fleet with its lanes laid out over a D-shard lane mesh and
       sharded checkpoints (a lane rolls back to its initial slice)
       gives the same incidents, dt vector and alive mask, and every
       healthy lane is bitwise the replicated fleet's.
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

        mesh_leg = None
        if mesh_shards:
            from ibamr_tpu_torch.parallel.mesh import (make_lane_mesh,
                                                       place_lanes)
            from ibamr_tpu_torch.parallel.spmd import sharding_of
            from ibamr_tpu_torch.utils.checkpoint_sharded import \
                _all_sharded_steps

            lm = make_lane_mesh(mesh_shards, device=device)
            mdir = os.path.join(directory, "lane_mesh")
            with recorded("lane_nan", **inj):
                drv_m = HierarchyDriver(
                    integ, cfg, lanes=B, lane_mesh=lm,
                    fleet_step_wrap=lambda s: lane_nan_injector(s, **inj))
                sup_m = ResilientDriver(drv_m, mdir, max_retries=1,
                                        dt_backoff=0.5,
                                        handle_signals=False,
                                        sharded=True, mesh=lm)
                t0 = time.perf_counter()
                out_m = sup_m.run(place_lanes(fleet0, lm))
                mesh_wall = time.perf_counter() - t0
            ev = [(r["event"], r.get("lane")) for r in sup.incidents]
            ev_m = [(r["event"], r.get("lane")) for r in sup_m.incidents]
            if ev != ev_m:
                raise AssertionError(f"lane-mesh incidents {ev_m} != {ev}")
            if not (np.array_equal(drv.lane_dt, drv_m.lane_dt)
                    and np.array_equal(drv.lane_alive, drv_m.lane_alive)):
                raise AssertionError("lane-mesh dt/alive differ")
            for i in healthy:
                if any(not torch.equal(a, b) for a, b in zip(
                        leaves(lane_slice(out, i)),
                        leaves(lane_slice(out_m, i)))):
                    raise AssertionError(f"lane-mesh lane {i} is not "
                                         f"bitwise the replicated fleet's")
            lay = sharding_of(out_m.ins.u[0])
            if lay is None or lay.mesh.size != mesh_shards:
                raise AssertionError("lane-mesh output lost its layout")
            if not _all_sharded_steps(mdir):
                raise AssertionError("lane-mesh run wrote no sharded "
                                     "checkpoints")
            mesh_leg = {"shards": mesh_shards,
                        "lanes_per_shard": B // mesh_shards,
                        "bitwise_healthy_lanes": len(healthy),
                        "fleet_wall_s": mesh_wall}

        return {"fleet_smoke": "ok", "fleet_size": B, "bad_lane": BAD,
                "mesh_leg": mesh_leg,
                "healthy_final_step": cfg.num_steps,
                "bad_lane_final_step": int(k[BAD]),
                "lane_rollbacks": len(rolls),
                "lane_quarantines": len(quars),
                "trace_counts": {str(n): c for n, c
                                 in drv.trace_counts.items()},
                "capsule": cap, "replay_verdict": res["verdict"],
                "fleet_wall_s": fleet_wall,
                "incidents": sup.incidents, "state": out}


def run_sharded_smoke(directory: str | None = None, device="cuda",
                      n_shards: int = 8) -> dict:
    """End-to-end SHARDED-checkpoint drill on an ``n_shards`` 1-D mesh of
    ``device`` shards:

    1. **no-gather save + verified round trip**: a 64^2 f32 state laid
       out over the mesh saves with every host copy audited to be
       shard-sized, verifies, and restores bitwise onto the same mesh;
    2. **elastic restore**: the step restores bitwise onto ONE shard
       (N -> 1) and onto half the shards (N -> N/2);
    3. **damage inventory**: a byte flip in one shard, a dropped shard,
       a torn manifest and a stale shard rewritten after the commit each
       fail verification; ``latest_sharded_step`` / ``restore_sharded``
       fall back to the verified step;
    4. **concurrent-writer collision**: two threads commit the same step;
       it then verifies and restores bitwise to one writer's state, or
       fails verification (and fsck flags it), never a verified mix;
    5. **supervised sharded rollback**: a dt-gated NaN diverges a 16^2
       INS run on a 2-shard mesh under ``ResilientDriver(sharded=True)``;
       rollback restores the newest verified sharded step, the run
       completes, no single-host checkpoint is written, and the
       incident's capsule records the mesh spec and replays with
       ``--sharded`` bitwise;
    6. **fsck gate**: ``tools.ckpt_fsck`` flags the damaged steps (exit
       1 after ``--repair`` quarantines them), then passes clean.
    """
    import shutil
    import warnings

    from ibamr_tpu_torch.parallel.mesh import (make_mesh,
                                               make_sharded_ins_step,
                                               place_state)
    from ibamr_tpu_torch.parallel.spmd import NamedSharding, P, pin
    from ibamr_tpu_torch.tools import ckpt_fsck
    from ibamr_tpu_torch.tools.replay import replay
    from ibamr_tpu_torch.utils import checkpoint_sharded as cs
    from ibamr_tpu_torch.utils.flight_recorder import FlightRecorder
    from ibamr_tpu_torch.utils.hierarchy_driver import (HierarchyDriver,
                                                        RunConfig)
    from ibamr_tpu_torch.utils.supervisor import ResilientDriver

    with _workdir(directory) as directory:
        mesh = make_mesh(n_shards, max_axes=1, device=device)
        dev = mesh.first_device
        sh, rep = NamedSharding(mesh, P("x")), NamedSharding(mesh, P())
        n = 64
        host_u = np.linspace(-1.0, 1.0, n * n,
                             dtype=np.float32).reshape(n, n)

        def place(u, m=mesh):
            return {"u": pin(torch.as_tensor(u, device=dev),
                             NamedSharding(m, P("x"))),
                    "k": pin(torch.tensor(7, device=dev),
                             NamedSharding(m, P()))}

        state = place(host_u)

        # -- 1. no-gather save --------------------------------------------
        ckdir = os.path.join(directory, "ck")
        global_bytes = host_u.nbytes
        fetched: list = []
        orig_fetch = cs._fetch_shard

        def counting_fetch(data):
            arr = orig_fetch(data)
            fetched.append(arr.nbytes)
            return arr

        cs._fetch_shard = counting_fetch
        try:
            cs.save_sharded_checkpoint(ckdir, state, 10, mesh=mesh)
        finally:
            cs._fetch_shard = orig_fetch
        big = [b for b in fetched if b >= global_bytes]
        if n_shards > 1 and big:
            raise AssertionError(f"sharded save fetched a global-sized "
                                 f"array ({big} vs {global_bytes} bytes)")
        if not cs.verify_sharded_checkpoint(ckdir, 10):
            raise AssertionError("fresh sharded step failed verify")
        r, got, _ = cs.restore_sharded(ckdir, state)
        if got != 10 or not np.array_equal(r["u"].cpu().numpy(), host_u):
            raise AssertionError("same-mesh sharded restore not bitwise")

        # -- 2. elastic N -> 1 and N -> N/2 --------------------------------
        for m in (make_mesh(1, device=device),
                  make_mesh(max(1, n_shards // 2), max_axes=1,
                            device=device)):
            rm, _, _ = cs.restore_sharded(ckdir, place(host_u * 0, m))
            if not np.array_equal(rm["u"].cpu().numpy(), host_u):
                raise AssertionError(f"elastic restore onto {m.size} "
                                     f"shards not bitwise")

        # -- 3. damage inventory ---------------------------------------------
        damaged = {}
        for step, damage in ((20, corrupt_shard), (30, drop_shard),
                             (40, tear_manifest),
                             (50, stale_manifest_shard)):
            cs.save_sharded_checkpoint(ckdir, state, step, mesh=mesh,
                                       keep=0)
            if damage is tear_manifest:
                damage(ckdir, step)
            else:
                damage(ckdir, step, shard=n_shards - 1)
            if cs.verify_sharded_checkpoint(ckdir, step):
                raise AssertionError(
                    f"{damage.__name__} went undetected at step {step}")
            damaged[damage.__name__] = step
        if cs.latest_sharded_step(ckdir) != 10:
            raise AssertionError(f"latest_sharded_step did not fall back: "
                                 f"{cs.latest_sharded_step(ckdir)}")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, fell_back, _ = cs.restore_sharded(ckdir, state)
        if fell_back != 10:
            raise AssertionError("restore_sharded did not fall back")

        # -- 4. concurrent-writer collision ----------------------------------
        coll = os.path.join(directory, "collision")
        other = place(host_u + 1.0)
        errs: list = []

        def write(st):
            try:
                cs.save_sharded_checkpoint(coll, st, 60, mesh=mesh)
            except Exception as e:      # pragma: no cover - diagnostic
                errs.append(e)

        ts = [threading.Thread(target=write, args=(st,))
              for st in (state, other)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if errs:
            raise AssertionError(f"collision writers raised: {errs}")
        collided_verified = cs.verify_sharded_checkpoint(coll, 60)
        if collided_verified:
            rc, _, _ = cs.restore_sharded(coll, state)
            ru = rc["u"].cpu().numpy()
            if not (np.array_equal(ru, host_u)
                    or np.array_equal(ru, host_u + 1.0)):
                raise AssertionError("collision produced a verified mix "
                                     "of two writers' shards")
        else:
            # a detectable mix: fsck must flag it; --repair spares a sole
            # damaged candidate, so the drill directory goes once seen
            if ckpt_fsck.audit(coll)["clean"]:
                raise AssertionError("collision step failed verification "
                                     "but fsck called the tree clean")
            shutil.rmtree(coll)

        # -- 5. supervised sharded rollback ----------------------------------
        integ, st0 = _tg16_setup(device=device)
        mesh2 = make_mesh(min(2, n_shards), max_axes=1, device=device)
        st0 = place_state(st0, integ.grid, mesh2)
        dt0 = 1e-3
        cfg = RunConfig(dt=dt0, num_steps=12, restart_interval=4,
                        health_interval=2)
        sup_dir = os.path.join(directory, "supervised")
        inj = dict(at_step=6, leaf_path="u[0]", dt_gate=dt0 * 0.99)
        with recorded("nan", **inj):
            drv = HierarchyDriver(
                integ, cfg,
                step_fn=nan_injector_step(make_sharded_ins_step(integ, mesh2),
                                          **inj),
                recorder=FlightRecorder(capacity=4))
            sup = ResilientDriver(drv, sup_dir, max_retries=2,
                                  dt_backoff=0.5, handle_signals=False,
                                  sharded=True, mesh=mesh2)
            out = sup.run(st0)
        if int(out.k) != cfg.num_steps:
            raise AssertionError(f"supervised sharded run stopped at "
                                 f"{int(out.k)}")
        if not _finite(out.u[0]):
            raise AssertionError("supervised sharded run non-finite")
        div = [r for r in sup.incidents if r["event"] == "divergence"]
        if len(div) != 1 or div[0]["rollback_step"] != 4:
            raise AssertionError(f"unexpected incidents: {sup.incidents}")
        if not cs._all_sharded_steps(sup_dir):
            raise AssertionError("supervised run wrote no sharded steps")
        if any(f.startswith("restore.") for f in os.listdir(sup_dir)):
            raise AssertionError("sharded supervision wrote single-host "
                                 "checkpoints")
        cap = div[0].get("replay")
        if not cap:
            raise AssertionError("divergence incident has no capsule")
        with open(os.path.join(cap, "manifest.json")) as f:
            cap_mesh = json.load(f)["fingerprint"].get("mesh")
        if not cap_mesh or cap_mesh.get("n_shards") != mesh2.size:
            raise AssertionError(f"capsule fingerprint lacks the mesh "
                                 f"spec: {cap_mesh}")
        res = replay(cap, sharded=True)
        if not (res["sharded_replay"] and res["bitwise"]
                and res["verdict"] == "reproduced"):
            raise AssertionError(f"sharded capsule replay: {res}")

        # -- 6. fsck gate ------------------------------------------------------
        rep_ = ckpt_fsck.audit(directory)
        n_bad = rep_["counts"]["torn"] + rep_["counts"]["corrupt"]
        if rep_["clean"] or n_bad < len(damaged):
            raise AssertionError(f"fsck missed damage: {rep_['counts']} "
                                 f"vs {damaged}")
        if ckpt_fsck.main([directory, "--repair", "-q"]) != 1:
            raise AssertionError("fsck --repair did not exit 1")
        if not ckpt_fsck.audit(directory)["clean"]:
            raise AssertionError("tree not clean after repair")
        if ckpt_fsck.main([directory, "-q"]) != 0:
            raise AssertionError("fsck exit nonzero on repaired tree")
        if cs.latest_sharded_step(ckdir) != 10:
            raise AssertionError("repair touched the verified step")

        return {"sharded_smoke": "ok", "n_shards": n_shards,
                "shard_fetches": len(fetched),
                "max_fetch_bytes": max(fetched),
                "global_bytes": global_bytes,
                "damage_detected": damaged,
                "collision_verified": bool(collided_verified),
                "rollback_step": div[0]["rollback_step"],
                "replay_verdict": res["verdict"],
                "fsck_quarantined": n_bad}


# ---------------------------------------------------------------------------
# serving-path chaos: faults against the warm-pool router
# ---------------------------------------------------------------------------
#
# The four monkey-patching injectors patch the router's seams for the
# duration of a ``with`` block and restore them on exit. They are
# deliberately NOT ``recorded()``: they perturb latency and liveness,
# never state values, so there is no bitwise replay story — the soak
# drill's invariants are the reproduction.


@contextlib.contextmanager
def compile_storm_injector(extra_s: float = 0.5):
    """Every bucket build (the whole cost of a serving miss) takes
    ``extra_s`` longer — the host-side model of a build storm, where
    novel families pile onto the build threads and cold requests wait.
    Warm pools are untouched (the patch sits on
    ``WarmPool.ensure_compiled``, which only runs at build time)."""
    from ibamr_tpu_torch.serve.router import WarmPool

    orig = WarmPool.ensure_compiled

    def stormy(self):
        time.sleep(float(extra_s))
        return orig(self)

    WarmPool.ensure_compiled = stormy
    try:
        yield
    finally:
        WarmPool.ensure_compiled = orig


@contextlib.contextmanager
def slow_lane_injector(extra_s: float = 0.25, match=None):
    """Straggler: every warm-chunk invocation on pools whose spec
    satisfies ``match`` (default: all pools) eats a host-side
    ``extra_s`` sleep first. Scoping ``match`` to the chaos family is
    how the soak proves a straggling tenant cannot drag a healthy
    tenant's p99 — slots, not speed, are the shared resource."""
    from ibamr_tpu_torch.serve.router import WarmPool

    orig = WarmPool.chunk

    def straggler(self, length):
        ex = orig(self, length)
        if match is not None and not match(self.spec):
            return ex

        def slow_exec(*a, **k):
            time.sleep(float(extra_s))
            return ex(*a, **k)

        return slow_exec

    WarmPool.chunk = straggler
    try:
        yield
    finally:
        WarmPool.chunk = orig


@contextlib.contextmanager
def failing_build_injector(n_failures: int = 1,
                           message: str = "injected build failure"):
    """The first ``n_failures`` bucket builds raise — the transient
    build failure the router's jittered-backoff retry budget exists
    for. Yields the live countdown list (``[remaining]``) so a drill
    can assert the faults were actually consumed."""
    from ibamr_tpu_torch.serve.router import WarmPool

    orig = WarmPool.ensure_compiled
    remaining = [int(n_failures)]
    lock = threading.Lock()

    def flaky(self):
        with lock:
            fail = remaining[0] > 0
            if fail:
                remaining[0] -= 1
        if fail:
            raise RuntimeError(message)
        return orig(self)

    WarmPool.ensure_compiled = flaky
    try:
        yield remaining
    finally:
        WarmPool.ensure_compiled = orig


@contextlib.contextmanager
def kill_router_thread_injector(n_kills: int = 1):
    """The first ``n_kills`` pool-build threads DIE without publishing
    (``_build_pool`` returns before setting the flight event) — the
    harshest router liveness fault: every waiter on that flight would
    hang forever if the sliced-wait dead-thread failover did not
    exist. Yields the live countdown list (``[remaining]``)."""
    from ibamr_tpu_torch.serve import router as _router

    orig = _router.WarmPoolRouter._build_pool
    remaining = [int(n_kills)]
    lock = threading.Lock()

    def killed(self, spec, flight):
        with lock:
            kill = remaining[0] > 0
            if kill:
                remaining[0] -= 1
        if kill:
            return  # thread exits: no pool, no error, no event
        return orig(self, spec, flight)

    _router.WarmPoolRouter._build_pool = killed
    try:
        yield remaining
    finally:
        _router.WarmPoolRouter._build_pool = orig


def mix_shift_injector(seed: int, duration_s: float, rate_rps: float,
                       shift_frac: float = 0.5,
                       shifted_family=(("n_lon", 12),),
                       burst_factor: float = 2.0):
    """Mix-shift fault: a deterministic arrival schedule whose mix
    ROTATES to an unseen bucket family at ``shift_frac`` of the run —
    the traffic pattern a fixed warm-pool set cannot survive (every
    post-shift request would cold-build or shed). Pure schedule
    transform, no monkey-patching: the same seed replays the same shift
    bit-for-bit. Returns ``(arrivals, shifted_family_str)`` where the
    string matches the ``family`` field of
    ``request_admit``/``pool_scale`` ledger records."""
    from ibamr_tpu_torch.serve.loadgen import (SCENARIO_MIX,
                                               ScenarioRequest,
                                               poisson_burst_schedule)

    shifted_mix = tuple(
        dataclasses.replace(s, family=tuple(shifted_family))
        for s in SCENARIO_MIX)
    arrivals = poisson_burst_schedule(
        seed=seed, duration_s=duration_s, rate_rps=rate_rps,
        burst_factor=burst_factor,
        mix_schedule=[(0.0, SCENARIO_MIX),
                      (float(shift_frac), shifted_mix)])
    fam = dict(shifted_family)
    probe = ScenarioRequest(
        tenant="probe", n_cells=fam.get("n_cells", 8),
        n_lat=fam.get("n_lat", 6), n_lon=fam.get("n_lon", 8),
        engine=fam.get("engine"),
        spectral_dtype=fam.get("spectral_dtype"),
        mu=fam.get("mu", 0.05))
    return arrivals, str(probe.family())


@contextlib.contextmanager
def memory_pressure_injector(cache, max_bytes: int):
    """Memory-pressure fault: squeeze the executable cache's bytes
    ceiling mid-run (the ``aot_cache_bytes`` watermark the brownout
    pressure signal reads: the warm pools' resident bytes), restoring
    the original ceiling on exit. Yields the live eviction count ``[n]``
    from the initial squeeze so a drill can assert what the pressure
    actually cost."""
    orig = cache.max_bytes
    evicted = [cache.set_max_bytes(int(max_bytes))]
    try:
        yield evicted
    finally:
        cache.set_max_bytes(orig)


def _terminal_join(records):
    """(admitted ids, lost ids, doubled ids): every ``request_admit``
    trace id against its terminal ``request`` / ``request_shed``
    records."""
    admits = [r["trace_id"] for r in records
              if r.get("kind") == "request_admit"]
    terminals: dict = {}
    for r in records:
        if r.get("kind") in ("request", "request_shed"):
            tid = r.get("trace_id")
            terminals[tid] = terminals.get(tid, 0) + 1
    lost = [t for t in admits if terminals.get(t, 0) == 0]
    doubled = [t for t in admits if terminals.get(t, 0) > 1]
    return admits, lost, doubled


def run_elastic_smoke(directory: str | None = None,
                      duration_s: float = 5.0, rate_rps: float = 8.0,
                      time_scale: float = 0.5,
                      shift_frac: float = 0.4, device="cuda") -> dict:
    """Deterministic elasticity drill on ``device`` (the GPU unless
    ``device="cpu"``): a mid-soak MIX SHIFT onto an unseen family plus
    MEMORY PRESSURE on the executable cache drive the
    ``ElasticPoolManager`` through grow, brownout, shrink, and a
    crash-safe restart, and the invariants are pinned from the ledger:

    1. **no lost request** — every admitted ``trace_id`` reaches
       exactly one terminal record, shift or no shift;
    2. **scale-up before shed** — the shifted family's ``pool_scale``
       grow decision lands BEFORE any of its requests shed, and the
       family is eventually served warm;
    3. **brownout without oscillation** — the build backlog pushes the
       mode ladder into brownout, the squeezed bytes watermark holds it
       there (``pressure()`` read while the squeeze holds: the pools'
       resident bytes at or above ``brownout_cache_frac`` of the
       ceiling, which still fits both pools), it de-escalates through
       the dwell guard once the squeeze lifts, and the total number of
       mode transitions stays bounded (no flapping);
    4. **elastic shrink** — the pre-shift family decays cold and is
       released (entries + bytes), never while serving;
    5. **restart drill** — ``serving_manifest.json`` is checkpointed,
       a FRESH router+cache restores it with bounded-concurrency
       re-warm and ZERO fresh builds (executable-cache ``cold_source``:
       every family re-warmed is one this cache directory has seen),
       then serves warm on the first request.

    Raises on any failed expectation; returns a one-line summary
    (``python -m ibamr_tpu_torch.tools.slo check --elastic`` evaluates
    the same ledger against the port's SLO.json ``elastic_slos``)."""
    from ibamr_tpu_torch import obs as _obs
    from ibamr_tpu_torch.serve import aot_cache
    from ibamr_tpu_torch.serve.autoscale import (ElasticPoolManager,
                                                 ScalePolicy,
                                                 restore_serving_manifest)
    from ibamr_tpu_torch.serve.capacity import capacity_report
    from ibamr_tpu_torch.serve.loadgen import (SOAK_POLICIES,
                                               run_open_loop,
                                               traffic_summary)
    from ibamr_tpu_torch.serve.router import (BucketSpec, ScenarioRequest,
                                              WarmPool, WarmPoolRouter)

    max_transitions = 6
    tmp = None
    if directory is None:
        tmp = tempfile.TemporaryDirectory(prefix="ibamr_elastic_smoke_")
        directory = tmp.name
    try:
        ledger_path = os.path.join(directory, "elastic_ledger.jsonl")
        manifest_path = os.path.join(directory,
                                     "serving_manifest.json")
        # the cross-process layer: the cache directory's manifest
        # sidecars, from which the restart re-warms
        cache = aot_cache.ExecutableCache(
            directory=os.path.join(directory, "cache"))
        spec = BucketSpec(n_cells=8, n_lat=6, n_lon=8, lanes=2,
                          chunk_steps=2)
        router = WarmPoolRouter([spec], cache=cache,
                                allow_dynamic=True,
                                policies=dict(SOAK_POLICIES),
                                device=device)
        # backlog>=1 trips brownout: one async grow IS the pressure
        # this drill exercises; de-escalation dwell bounds flapping
        policy = ScalePolicy(grow_share=0.08, grow_min_arrivals=2,
                             shrink_share=0.02, min_dwell_s=2.0,
                             idle_evict_s=6.0,
                             brownout_backlog=1,
                             brownout_exit_backlog=0,
                             urgent_share=0.15,
                             mode_min_dwell_s=0.5)
        manager = ElasticPoolManager(router, policy=policy,
                                     manifest_path=manifest_path)

        shifted = (("n_lon", 12),)
        arrivals, shifted_family = mix_shift_injector(
            seed=0, duration_s=duration_s, rate_rps=rate_rps,
            shift_frac=shift_frac, shifted_family=shifted)
        shift_t = shift_frac * duration_s
        pre = [a for a in arrivals if a.t < shift_t]
        post = [dataclasses.replace(a, t=a.t - shift_t)
                for a in arrivals if a.t >= shift_t]

        with _obs.ledger(ledger_path):
            with _obs.span("elastic_smoke/warm"):
                router.warm(spec)
            base_family = str(spec.family())

            with _obs.span("elastic_smoke/pre_shift",
                           arrivals=len(pre)):
                run1 = run_open_loop(router, pre,
                                     time_scale=time_scale,
                                     join_timeout_s=120.0)
            # mid-soak: the mix rotates to the unseen family while the
            # cache's bytes ceiling is squeezed so that both families'
            # resident bytes fit and read at 95 % of it (the dynamic
            # bucket the grow builds, sized here by its pool's bytes):
            # the watermark is pressure, not sabotage
            fam = dict(shifted)
            grown = BucketSpec(n_cells=8, n_lat=6,
                               n_lon=fam["n_lon"],
                               lanes=router.default_lanes)
            grown_bytes = WarmPool(grown, cache,
                                   device=device).resident_bytes
            target_frac = 0.5 * (policy.brownout_cache_frac + 1.0)
            ceiling = max(int((cache.bytes() + grown_bytes)
                              / target_frac), 1)
            with _obs.span("elastic_smoke/shifted_open_loop",
                           arrivals=len(post)), \
                    memory_pressure_injector(cache, ceiling) as evicted:
                run2 = run_open_loop(router, post,
                                     time_scale=time_scale,
                                     join_timeout_s=180.0)
                squeeze = manager.pressure()
                squeeze_target = manager._target_mode(squeeze)
                squeeze_mode = manager.mode

            # settle: idle ticks decay the mix + drain the mode
            # ladder back to healthy and let the cold family shrink
            t_settle = time.monotonic()
            while time.monotonic() - t_settle < 20.0:
                manager.tick()
                shrunk = any(e["action"] == "shrink"
                             for e in manager.scale_events)
                if manager.mode == "healthy" and shrunk:
                    break
                time.sleep(0.25)
            manager.tick()

            # -- 5. the restart drill --------------------------------
            manager.save_manifest()
            if manager.drain(timeout_s=120.0):
                raise AssertionError("builds/watchers never finished "
                                     "before the restart drill")
            router2, manager2, restore_stats = \
                restore_serving_manifest(manifest_path, device=device)
            probe = router2.serve([ScenarioRequest(
                tenant="interactive-restart", n_cells=8, n_lat=6,
                n_lon=fam["n_lon"], steps=2,
                tenant_class="interactive")])[0]
            router2.drain_builds(timeout_s=60.0)
            _obs.chunk_boundary()

        # -- invariant 1: no lost request ----------------------------
        for run in (run1, run2):
            if run["hung_threads"]:
                raise AssertionError(
                    f"{run['hung_threads']} producer threads never "
                    f"finished — the elastic drill deadlocked")
            if run["errors"]:
                raise AssertionError(
                    f"serve() raised under the mix shift: "
                    f"{run['errors'][:3]}")
        records = list(_obs.read_ledger(ledger_path))
        admits = [r for r in records
                  if r.get("kind") == "request_admit"]
        _, lost, doubled = _terminal_join(records)
        if lost or doubled:
            raise AssertionError(
                f"terminal-record invariant broken: {len(lost)} lost, "
                f"{len(doubled)} doubled (first: "
                f"{(lost + doubled)[:3]})")

        # -- invariant 2: scale-up before shed for the shifted mix ---
        grows = [r for r in records if r.get("kind") == "pool_scale"
                 and r.get("action") == "grow"
                 and r.get("family") == shifted_family]
        if not grows:
            raise AssertionError(
                f"the shifted family {shifted_family} never got a "
                f"grow decision — the mix estimator is blind")
        first_grow_seq = min(r["seq"] for r in grows)
        shifted_tids = {r["trace_id"] for r in admits
                        if r.get("family") == shifted_family}
        shifted_sheds = [r for r in records
                         if r.get("kind") == "request_shed"
                         and r.get("trace_id") in shifted_tids]
        early = [r for r in shifted_sheds
                 if r.get("seq", 0) < first_grow_seq]
        if early:
            raise AssertionError(
                f"{len(early)} shifted-family requests shed BEFORE "
                f"the grow decision (seq {first_grow_seq})")
        warmed = [r for r in records if r.get("kind") == "pool_scale"
                  and r.get("action") == "warmed"
                  and r.get("family") == shifted_family]
        shifted_warm = [r for r in records if r.get("kind") == "request"
                        and r.get("trace_id") in shifted_tids
                        and not r.get("cold")]
        if not warmed or not shifted_warm:
            raise AssertionError(
                f"shifted family never published warm "
                f"(warmed={len(warmed)}, warm_served="
                f"{len(shifted_warm)})")

        # -- invariant 3: brownout entry/exit without oscillation ----
        modes = [r for r in records if r.get("kind") == "serve_mode"]
        if not any(r["mode"] == "brownout" for r in modes):
            raise AssertionError(
                "the grow backlog never tripped brownout — the "
                "pressure signal is dead")
        if (squeeze["cache_frac"] < policy.brownout_cache_frac
                or squeeze_target == "healthy"
                or squeeze_mode == "healthy" or evicted[0]):
            raise AssertionError(
                f"the bytes squeeze did not hold brownout: pressure "
                f"{squeeze} (target {squeeze_target}, mode "
                f"{squeeze_mode}) against the ceiling {ceiling} B, "
                f"{evicted[0]} entries evicted by it")
        if len(modes) > max_transitions:
            raise AssertionError(
                f"{len(modes)} mode transitions (> {max_transitions})"
                f" — the ladder is oscillating")
        if manager.mode != "healthy":
            raise AssertionError(
                f"mode never de-escalated (stuck {manager.mode})")

        # -- invariant 4: elastic shrink of the cold family ----------
        shrinks = [r for r in records if r.get("kind") == "pool_scale"
                   and r.get("action") == "shrink"]
        if not any(r.get("family") == base_family for r in shrinks):
            raise AssertionError(
                f"the pre-shift family {base_family} was never "
                f"shrunk after going cold")
        if shifted_family not in {str(f)
                                  for f in router.live_families()}:
            raise AssertionError(
                "the shifted (hot) family is not live after shrink")

        # -- invariant 5: restart reached warm with zero fresh builds
        if restore_stats["fresh_compiles"] != 0:
            raise AssertionError(
                f"restart drill paid {restore_stats['fresh_compiles']}"
                f" fresh builds (cold_source attribution) — the cache "
                f"directory's manifests did not survive the crash")
        if restore_stats["warmed"] == 0 or restore_stats["errors"]:
            raise AssertionError(
                f"restart re-warm failed: {restore_stats}")
        if probe.shed or probe.cold or not probe.ok:
            raise AssertionError(
                f"first post-restart request was not a warm serve: "
                f"cold={probe.cold} shed={probe.shed} ok={probe.ok}")

        results = run1["results"] + run2["results"]
        wall = run1["wall_s"] + run2["wall_s"]
        summary = traffic_summary(results, wall)
        cap = capacity_report(records, p99_ceiling_s=2.0)
        if cap["prediction"]["rps"] is None:
            raise AssertionError(
                "capacity model unevaluable — no warm samples in the "
                "elastic ledger")
        return {"elastic_smoke": "ok",
                "arrivals": len(arrivals),
                "admitted": len(admits),
                "lost": 0,
                "shed": summary["shed"],
                "mode_transitions": len(modes),
                "grows": len(grows),
                "shrinks": len(shrinks),
                "scale_up_s": max(r.get("warm_s", 0.0)
                                  for r in warmed),
                "squeeze_ceiling_bytes": ceiling,
                "squeeze_cache_frac": round(squeeze["cache_frac"], 4),
                "squeeze_mode": squeeze_mode,
                "restart_warm_s": restore_stats["warm_s"],
                "restart_fresh_compiles":
                    restore_stats["fresh_compiles"],
                "cache_bytes": cache.bytes(),
                "predicted_rps": cap["prediction"]["rps"],
                "measured_rps": summary["requests_per_s"],
                "wall_s": round(wall, 3),
                "ledger": (None if tmp is not None else ledger_path)}
    finally:
        if tmp is not None:
            tmp.cleanup()


def run_soak_smoke(directory: str | None = None,
                   duration_s: float = 5.0, rate_rps: float = 8.0,
                   time_scale: float = 0.5,
                   chaos_rate_rps: float = 3.0, device="cuda") -> dict:
    """Deterministic traffic-robustness drill on ``device`` (the GPU
    unless ``device="cpu"``): the open-loop load generator drives a
    warm-pool router under ALL FOUR serving chaos injectors at once,
    and the liveness invariants are pinned from the ledger.

    1. **healthy traffic, chaos tenant burning** — seeded Poisson
       arrivals with a 4x burst window over the heavy-tailed
       interactive/batch mix share the router with a ``chaos``-class
       tenant whose requests land on NOVEL families (fresh bucket
       builds) while a build storm slows every build, the first build
       raises (retry fuel), one build thread is killed mid-flight, and
       the chaos families' lanes straggle;
    2. **no deadlock** — every producer thread joins inside the
       drill's bounded window (``hung_threads == 0``);
    3. **no lost request** — every ``request_admit`` trace_id in the
       ledger reaches EXACTLY one terminal record (``request`` or
       ``request_shed``), storm or no storm;
    4. **bounded shed** — healthy classes shed at most
       ``max_healthy_shed_rate``; the chaos class may shed freely
       (that is admission control doing its job, not a failure);
    5. **healthy p99 within band** — healthy tenants' warm first-step
       p99 stays inside the band while the chaos tenant burns.

    Raises on any failed expectation; returns a one-line summary.
    """
    from ibamr_tpu_torch import obs as _obs
    from ibamr_tpu_torch.serve import aot_cache
    from ibamr_tpu_torch.serve.loadgen import (SOAK_POLICIES, Scenario,
                                               poisson_burst_schedule,
                                               run_open_loop,
                                               traffic_summary)
    from ibamr_tpu_torch.serve.router import BucketSpec, WarmPoolRouter

    max_healthy_shed_rate = 0.10
    healthy_warm_p99_band_s = 2.0

    tmp = None
    if directory is None:
        tmp = tempfile.TemporaryDirectory(prefix="ibamr_soak_smoke_")
        directory = tmp.name
    try:
        ledger_path = os.path.join(directory, "soak_ledger.jsonl")
        spec = BucketSpec(n_cells=8, n_lat=6, n_lon=8, lanes=2,
                          chunk_steps=2)
        router = WarmPoolRouter(
            [spec],
            cache=aot_cache.ExecutableCache(
                directory=os.path.join(directory, "cache")),
            allow_dynamic=True, policies=dict(SOAK_POLICIES),
            device=device)

        with _obs.ledger(ledger_path):
            with _obs.span("soak_smoke/warm"):
                router.warm(spec)

            # healthy mix on the pre-warmed family; chaos tenant on
            # two NOVEL families (distinct n_lon -> fresh builds)
            arrivals = poisson_burst_schedule(
                seed=0, duration_s=duration_s, rate_rps=rate_rps,
                burst_factor=4.0)
            chaos_mix = (Scenario("chaos/storm_probe", 1.0, "chaos",
                                  steps=1),)
            for j, n_lon in enumerate((10, 12)):
                arrivals += poisson_burst_schedule(
                    seed=100 + j, duration_s=duration_s,
                    rate_rps=chaos_rate_rps / 2.0, burst_factor=4.0,
                    mix=chaos_mix, n_lon=n_lon, tenants_per_class=1)
            arrivals.sort(key=lambda a: a.t)

            chaos_family = (lambda s: s.n_lon != 8)
            with _obs.span("soak_smoke/chaos_open_loop",
                           arrivals=len(arrivals)), \
                    compile_storm_injector(extra_s=0.2), \
                    failing_build_injector(n_failures=1) as build_faults, \
                    kill_router_thread_injector(n_kills=1) as kills, \
                    slow_lane_injector(extra_s=0.2, match=chaos_family):
                run = run_open_loop(router, arrivals,
                                    time_scale=time_scale,
                                    join_timeout_s=120.0)
            _obs.chunk_boundary()

        # -- 2. no deadlock ------------------------------------------
        # deadline-shed chaos requests leave their bucket builds
        # running; those threads must also terminate (and must do so
        # before interpreter exit)
        still = router.drain_builds(timeout_s=120.0)
        if still:
            raise AssertionError(
                f"{still} pool builds never finished — a build "
                f"thread is wedged")
        if run["hung_threads"]:
            raise AssertionError(
                f"{run['hung_threads']} producer threads never "
                f"finished — the router deadlocked under chaos")
        if run["errors"]:
            raise AssertionError(
                f"serve() raised under chaos (every fault must "
                f"terminate as a shed, not an exception): "
                f"{run['errors'][:3]}")
        if build_faults[0] != 0 or kills[0] != 0:
            raise AssertionError(
                f"injected faults not consumed: {build_faults[0]} "
                f"build failures, {kills[0]} kills left — the drill "
                f"did not exercise what it claims")

        # -- 3. no lost request, from the ledger alone ---------------
        records = list(_obs.read_ledger(ledger_path))
        admits, lost, doubled = _terminal_join(records)
        if lost:
            raise AssertionError(
                f"{len(lost)} admitted requests have NO terminal "
                f"record (first: {lost[:3]}) — requests were lost")
        if doubled:
            raise AssertionError(
                f"{len(doubled)} admitted requests have multiple "
                f"terminal records (first: {doubled[:3]})")

        # -- 4. bounded shed for healthy classes ---------------------
        summary = traffic_summary(run["results"], run["wall_s"])
        healthy_sub = healthy_shed = 0
        for cls, c in summary["classes"].items():
            if cls != "chaos":
                healthy_sub += c["submitted"]
                healthy_shed += c["shed"]
        healthy_rate = (healthy_shed / healthy_sub) if healthy_sub else 0.0
        if healthy_rate > max_healthy_shed_rate:
            raise AssertionError(
                f"healthy classes shed {healthy_rate:.2%} "
                f"(> {max_healthy_shed_rate:.0%}) — the chaos tenant "
                f"stole healthy capacity")

        # -- 5. healthy warm p99 within band -------------------------
        healthy_warm = sorted(
            r["first_step_s"] for r in records
            if r.get("kind") == "request"
            and r.get("tenant_class") in ("interactive", "batch")
            and not r.get("cold"))
        if not healthy_warm:
            raise AssertionError("no healthy warm completions — the "
                                 "soak never reached the warm path")
        p99 = healthy_warm[min(len(healthy_warm) - 1,
                               max(0, math.ceil(0.99 * len(healthy_warm))
                                   - 1))]
        if p99 > healthy_warm_p99_band_s:
            raise AssertionError(
                f"healthy warm p99 {p99:.3f}s blew the "
                f"{healthy_warm_p99_band_s}s band while the chaos "
                f"tenant burned")

        chaos = summary["classes"].get("chaos", {})
        return {"soak_smoke": "ok",
                "arrivals": len(arrivals),
                "admitted": len(admits),
                "lost": 0,
                "healthy_shed_rate": round(healthy_rate, 4),
                "chaos_submitted": chaos.get("submitted", 0),
                "chaos_shed": chaos.get("shed", 0),
                "chaos_completed": chaos.get("completed", 0),
                "retried": summary["retried"],
                "healthy_warm_p99_s": round(float(p99), 4),
                "hung_threads": 0,
                "wall_s": round(run["wall_s"], 3),
                "ledger": (None if tmp is not None else ledger_path)}
    finally:
        if tmp is not None:
            tmp.cleanup()


# ---------------------------------------------------------------------------
# assimilation faults: bad sensors and bad members
# ---------------------------------------------------------------------------
#
# The first three injectors wrap the cycle's ``obs_source`` seam: a pure
# schedule transform over the sensor stream (which channels go bad, at
# which cycles), so an armed drill is reproducible from its parameters
# alone. ``member_divergence_injector`` is a lane-confined STATE fault
# (the lane_nan shape) and is ``recorded()`` so capsules of an
# assimilating run carry it.

def obs_dropout_injector(source, channels, at_cycles):
    """Wrap an ``obs_source`` so the named channels read NaN (a dead
    sensor) at the named cycles: the QC gate must reject each with
    reason ``dropout`` and the analysis must proceed on the rest."""
    chans, cycs = list(channels), {int(c) for c in at_cycles}

    def wrapped(cycle, step):
        b = source(cycle, step)
        if b is None or cycle not in cycs:
            return b
        b = dataclasses.replace(b, values=b.values.copy())
        b.values[chans] = np.nan
        return b

    return wrapped


def obs_outlier_injector(source, channels, at_cycles,
                         magnitude: float = 50.0):
    """Wrap an ``obs_source`` so the named channels spike by
    ``magnitude`` observation-sigmas (an electrical transient) at the
    named cycles: the QC gate's background check must reject each with
    reason ``outlier``."""
    chans, cycs = list(channels), {int(c) for c in at_cycles}

    def wrapped(cycle, step):
        b = source(cycle, step)
        if b is None or cycle not in cycs:
            return b
        b = dataclasses.replace(b, values=b.values.copy())
        b.values[chans] += magnitude * np.sqrt(b.r[chans])
        return b

    return wrapped


def stale_obs_injector(source, channels, at_cycles,
                       age_s: float = 1e6):
    """Wrap an ``obs_source`` so the named channels arrive ``age_s``
    seconds old (a feed replaying its last value) at the named cycles:
    the QC gate must reject each with reason ``stale``."""
    chans, cycs = list(channels), {int(c) for c in at_cycles}

    def wrapped(cycle, step):
        b = source(cycle, step)
        if b is None or cycle not in cycs:
            return b
        b = dataclasses.replace(b, age_s=b.age_s.copy())
        b.age_s[chans] = age_s
        return b

    return wrapped


def member_divergence_injector(stacked_step, at_step: int, lane: int,
                               fleet_size: int, leaf_path: str = "u[0]",
                               dt_gate: float | None = None,
                               step_attr: str = "ins.k"):
    """One ensemble MEMBER diverges mid-run: lane ``lane``'s rows go NaN
    at its ``at_step`` (the :func:`lane_nan_injector` mechanics under the
    assimilation drill's name). The fleet triage must quarantine the
    member, and the masked analysis statistics must exclude it instead of
    averaging a diverged state into every other lane."""
    return lane_nan_injector(stacked_step, at_step=at_step, lane=lane,
                             fleet_size=fleet_size, leaf_path=leaf_path,
                             dt_gate=dt_gate, step_attr=step_attr)


def assim_shell_setup(B: int, n_cyc: int, spc: int, dt0: float, *,
                      device="cuda", dtype=torch.float64, sigma=1e-5,
                      seed: int = 7, perturb: float = 2e-3,
                      rings=(2, 5), **shell):
    """The assimilation drill's twin experiment on the IB shell: the
    integrator, two latitude-ring flow meters (``rings`` of the
    ``n_lat`` x ``n_lon`` shell) as the observation operator, the noisy
    sensor batches of a truth run (``n_cyc`` cycles of ``spc`` steps,
    noise ``sigma`` from numpy's generator at ``seed``) and the B-lane
    forecast fleet (additive velocity offsets ``perturb·(i+1)``: the
    initial state is quiescent, so multiplicative perturbations would
    leave the ensemble degenerate). Returns ``(integ, op, fleet0,
    batches, kwargs)``, ``kwargs`` the shell's build arguments."""
    from ibamr_tpu_torch.assim import ObservationOperator, \
        synthesize_batches
    from ibamr_tpu_torch.instruments import InstrumentPanel, make_meters
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.utils.lanes import stack_lanes

    kwargs = dict(shell, dtype=str(dtype).replace("torch.", ""),
                  device=str(device))
    integ, st0 = build_shell_example(**dict(kwargs, dtype=dtype))
    n_lon = int(shell["n_lon"])
    loops = [[ring * n_lon + j for j in range(n_lon)] for ring in rings]
    panel = InstrumentPanel(integ.ins.grid, make_meters(
        loops, closed=True, dtype=dtype, device=device))
    op = ObservationOperator(panel)
    st, truth = st0, []
    for _ in range(n_cyc):
        for _ in range(spc):
            st = integ.step(st, dt0)
        truth.append(st)
    batches = synthesize_batches(op, truth, sigma=sigma, seed=seed)
    del truth, st
    fleet0 = stack_lanes([st0._replace(ins=st0.ins._replace(
        u=tuple(c + perturb * (i + 1) for c in st0.ins.u)))
        for i in range(B)])
    return integ, op, fleet0, batches, kwargs


def armed_obs_source(batches, names, plan):
    """The sensor stream of ``batches`` with the drill's three faults
    armed: ``plan`` maps ``dropout`` / ``outlier`` / ``stale`` to its
    (channel, cycle). Returns ``(source, injected)``, ``injected`` the
    set of (cycle, instrument, reason) triples QC must reject. The
    outlier spikes by 2e4 observation-sigmas, which clears the
    background check however wide the ensemble is."""
    from ibamr_tpu_torch.assim import stream_from_list

    source = stream_from_list(batches)
    ch, cy = plan["dropout"]
    source = obs_dropout_injector(source, [ch], [cy])
    ch, cy = plan["outlier"]
    source = obs_outlier_injector(source, [ch], [cy], magnitude=2e4)
    ch, cy = plan["stale"]
    source = stale_obs_injector(source, [ch], [cy])
    injected = {(cy, names[ch], reason)
                for reason, (ch, cy) in plan.items()}
    return source, injected


def run_assim_smoke(directory: str | None = None, fleet_size: int = 6,
                    cycles: int = 6, steps_per_cycle: int = 2,
                    bad_lane: int | None = None, device="cuda",
                    dtype=torch.float64) -> dict:
    """Deterministic end-to-end ASSIMILATION drill at the reference's
    sizes (the 16^3 shell, 8 x 16 markers, on the scatter oracle): the
    B-lane shell fleet runs as a forecasting service while ALL FOUR
    assimilation injectors are armed at once:

    1. **bad sensors rejected, not assimilated**: a dropped channel
       (NaN), an outlier spike and a stale feed each hit a distinct
       channel at a distinct cycle; the QC gate must reject exactly
       those (cycle, channel, reason) triples as ``assim_qc_reject``
       ledger records while the analysis proceeds on the rest;
    2. **bad member quarantined, not averaged in**: one lane's state
       goes NaN mid-run; the supervisor quarantines it and the masked
       ensemble statistics exclude it from every later analysis;
    3. **zero lost cycles**: every cycle lands exactly one terminal
       ``assim_cycle`` ledger record (skipped or analyzed);
    4. **the filter earns its keep**: the final forecast error beats the
       open-loop ensemble (same fleet, same member fault, no analysis)
       against the same sensors;
    5. **one signature, two builds**: the whole episode runs one input
       signature per chunk length and exactly two analysis builds
       (observe + analyze) through the executable cache, everything
       after a hit.

    Raises on any failed expectation; returns a one-line summary dict.
    """
    from ibamr_tpu_torch import obs as _obs
    from ibamr_tpu_torch.assim import (AssimConfig, AssimilationCycle,
                                       masked_moments)
    from ibamr_tpu_torch.assim import qc as _aqc
    from ibamr_tpu_torch.serve.aot_cache import ExecutableCache
    from ibamr_tpu_torch.utils.flight_recorder import (FlightRecorder,
                                                       factory_spec)
    from ibamr_tpu_torch.utils.health import HealthProbe

    B = int(fleet_size)
    BAD = B - 1 if bad_lane is None else int(bad_lane)
    n_cyc, spc = int(cycles), int(steps_per_cycle)
    dt0 = 1e-3
    t_all = time.perf_counter()
    with _workdir(directory) as directory:
        integ, op, fleet0, batches, kwargs = assim_shell_setup(
            B, n_cyc, spc, dt0, device=device, dtype=dtype,
            n_cells=16, n_lat=8, n_lon=16, mu=0.05)
        names = op.channel_names()
        source, injected = armed_obs_source(
            batches, names, {"dropout": (0, 1), "outlier": (1, 2),
                             "stale": (2, 3)})
        member_inj = dict(at_step=spc + 1, lane=BAD, fleet_size=B,
                          leaf_path="u[0]", step_attr="ins.k")

        ledger_path = os.path.join(directory, "assim_ledger.jsonl")
        cfg = AssimConfig(steps_per_cycle=spc, dt=dt0,
                          qc=_aqc.QCConfig(k_sigma=6.0))
        cache = ExecutableCache()
        probe = HealthProbe.for_integrator(integ)
        with _obs.ledger(ledger_path):
            with recorded("member_divergence", **member_inj):
                cyc = AssimilationCycle(
                    integ, op, B, cfg, probe=probe, cache=cache,
                    fleet_step_wrap=lambda s:
                        member_divergence_injector(s, **member_inj),
                    recorder=FlightRecorder(capacity=4, spec=factory_spec(
                        "ibamr_tpu_torch.models.shell3d",
                        "build_shell_example", **kwargs)))
                out = cyc.run(fleet0, batches, directory=directory,
                              obs_source=source, max_retries=1)

        if cyc.driver.lane_alive[BAD]:
            raise AssertionError("diverged member never quarantined")
        if not all(cyc.driver.lane_alive[i] for i in range(B)
                   if i != BAD):
            raise AssertionError("a healthy member was quarantined")

        records = list(_obs.read_ledger(ledger_path))
        rej = {(r["cycle"], r["instrument"], r["reason"])
               for r in records if r.get("kind") == "assim_qc_reject"}
        if not injected <= rej:
            raise AssertionError(
                f"injected bad observations not all rejected: "
                f"missing {injected - rej}")
        if rej - injected:
            raise AssertionError(
                f"QC rejected healthy observations: {rej - injected}")

        cyc_recs = [r for r in records if r.get("kind") == "assim_cycle"]
        done = {r["cycle"] for r in cyc_recs}
        if done != set(range(n_cyc)):
            raise AssertionError(
                f"lost cycles: {sorted(set(range(n_cyc)) - done)}")
        if not [r for r in cyc_recs if not r.get("skipped")]:
            raise AssertionError("no cycle ever analyzed")

        if any(c != 1 for c in cyc.driver.trace_counts.values()):
            raise AssertionError(
                f"fleet chunk signature changed: "
                f"{cyc.driver.trace_counts}")
        stats = cache.stats()
        if stats["misses"] != 2:
            raise AssertionError(
                f"expected exactly 2 analysis builds (observe + "
                f"analyze), got {stats['misses']}")

        ol = AssimilationCycle(
            integ, op, B, AssimConfig(steps_per_cycle=spc, dt=dt0),
            probe=HealthProbe.for_integrator(integ),
            cache=ExecutableCache(),
            fleet_step_wrap=lambda s:
                member_divergence_injector(s, **member_inj))
        ol_dir = os.path.join(directory, "open_loop")
        os.makedirs(ol_dir, exist_ok=True)
        ol_out = ol.run(fleet0, directory=ol_dir, n_cycles=n_cyc,
                        obs_source=lambda c, s: None, max_retries=1)

        def _forecast_err(fleet_state, alive, batch):
            pred = op.fleet(fleet_state)
            ybar, _, _ = masked_moments(
                pred, torch.as_tensor(alive, device=pred.device))
            d = np.asarray(batch.values) - ybar.detach().to(
                "cpu", torch.float64).numpy()
            d = d[np.isfinite(d)]
            return float(np.sqrt(np.mean(d * d)))

        err_assim = _forecast_err(out, cyc.driver.lane_alive, batches[-1])
        err_open = _forecast_err(ol_out, ol.driver.lane_alive, batches[-1])
        if not err_assim < err_open:
            raise AssertionError(
                f"assimilation did not beat the open loop: "
                f"{err_assim:.3e} vs {err_open:.3e}")

        # the drill's verdict lands in the ledger itself (append-only:
        # reopening continues the seq); the open-loop baseline exists
        # nowhere else
        with _obs.ledger(ledger_path):
            _obs.emit("assim_summary", cycles=n_cyc, fleet_size=B,
                      bad_lane=BAD, forecast_error=err_assim,
                      open_loop_error=err_open,
                      analysis_compiles=stats["misses"],
                      analysis_cache_hits=stats["hits"],
                      final_inflation=cyc.inflation,
                      inflation_escalations=len(cyc.escalations))

        return {"assim_smoke": "ok", "fleet_size": B, "bad_lane": BAD,
                "cycles": n_cyc,
                "qc_rejections": sorted([list(t) for t in rej]),
                "lost_cycles": 0,
                "analysis_compiles": stats["misses"],
                "analysis_cache_hits": stats["hits"],
                "forecast_error": float(f"{err_assim:.6e}"),
                "open_loop_error": float(f"{err_open:.6e}"),
                "final_inflation": cyc.inflation,
                "ledger": ledger_path,
                "wall_s": round(time.perf_counter() - t_all, 3)}


# ---------------------------------------------------------------------------
# the inverse-design drill
# ---------------------------------------------------------------------------

def run_design_smoke(directory: str | None = None, num_iters: int = 3,
                     lr: float = 0.05, device="cuda") -> dict:
    """The inverse-design drill at the reference's size: the eel2d gait
    objective (``design.eel_gait``: the swim displacement differentiated
    through the ConstraintIB rollout) at 24^2, 17 markers, 10 steps, f64,
    with four gates:

    1. the adjoint gradient on the gait amplitude ``A0`` agrees with an
       f64 central difference within 1e-6 relative;
    2. ``num_iters`` Adam iterations through :class:`~ibamr_tpu_torch.
       design.DesignLoop` strictly decrease the objective;
    3. iteration 1 builds the cached iterate (exactly one miss), every
       later iteration is one hit and no miss;
    4. each iteration leaves one ``design_iter`` record in the attached
       run ledger.

    Raises on a failed gate; returns a one-line summary dict."""
    from ibamr_tpu_torch import obs as _obs
    from ibamr_tpu_torch.design import DesignLoop, build_eel_gait_problem
    from ibamr_tpu_torch.serve.aot_cache import ExecutableCache

    with _workdir(directory) as directory:
        t_all = time.perf_counter()
        objective, params0 = build_eel_gait_problem(
            n=24, ns=17, num_steps=10, dtype=torch.float64, device=device)

        # 1. the adjoint against a central difference on the amplitude
        loop = DesignLoop(objective, params0, lr=lr, cache=ExecutableCache(),
                          label="eel_smoke")
        _, grads = loop.value_and_grad_fn()(params0)
        g_a0 = float(grads["A0"])
        a0 = float(params0["A0"])
        fd_eps = 1e-5

        def at(a):
            p = dict(params0)
            p["A0"] = torch.tensor(a, dtype=torch.float64,
                                   device=params0["A0"].device)
            with torch.no_grad():
                return float(objective(p))

        fd = (at(a0 + fd_eps) - at(a0 - fd_eps)) / (2.0 * fd_eps)
        fd_rel = abs(g_a0 - fd) / max(abs(fd), 1e-30)
        if fd_rel > 1e-6:
            raise AssertionError(
                f"adjoint disagrees with central difference: grad "
                f"{g_a0:.12e} vs FD {fd:.12e} (rel {fd_rel:.3e} > 1e-6)")

        # 2-4. the loop itself, with a run ledger attached
        ledger_path = os.path.join(directory, "design_ledger.jsonl")
        with _obs.ledger(ledger_path):
            res = loop.run(num_iters)
        objs = [it.objective for it in res.history]
        for earlier, later in zip(objs, objs[1:]):
            if not later < earlier:
                raise AssertionError(
                    f"objective did not strictly decrease: {objs}")
        first = res.history[0]
        if first.cache_misses != 1:
            raise AssertionError(f"iteration 1 should build the iterate "
                                 f"once, built {first.cache_misses}")
        for it in res.history[1:]:
            if it.cache_misses != 0 or it.cache_hits != 1:
                raise AssertionError(
                    f"warm iteration {it.iteration} not served from the "
                    f"cache: hits={it.cache_hits} "
                    f"misses={it.cache_misses}")
        recs = [r for r in _obs.read_ledger(ledger_path)
                if r.get("kind") == "design_iter"]
        if len(recs) != num_iters:
            raise AssertionError(f"expected {num_iters} design_iter ledger "
                                 f"records, found {len(recs)}")
        return {"design_smoke": "ok",
                "iterations": num_iters,
                "objectives": [round(v, 10) for v in objs],
                "fd_rel_err": float(f"{fd_rel:.3e}"),
                "grad_A0": float(f"{g_a0:.6e}"),
                "cold_misses": first.cache_misses,
                "warm_misses": sum(it.cache_misses
                                   for it in res.history[1:]),
                "warm_wall_s": round(sum(it.wall_s
                                         for it in res.history[1:]), 3),
                "cold_wall_s": round(first.wall_s, 3),
                "ledger_records": len(recs),
                "ledger": ledger_path,
                "wall_s": round(time.perf_counter() - t_all, 3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run the port's resilience drills")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--silent-smoke", action="store_true")
    ap.add_argument("--replay-smoke", action="store_true")
    ap.add_argument("--fleet-smoke", action="store_true")
    ap.add_argument("--assim-smoke", action="store_true",
                    help="the assimilation drill: QC-rejected bad "
                         "sensors, a quarantined member, zero lost "
                         "cycles, the filter beating the open loop")
    ap.add_argument("--soak-smoke", action="store_true",
                    help="the traffic-robustness soak drill: four "
                         "serving chaos injectors, no deadlock, no "
                         "lost request, bounded healthy shed")
    ap.add_argument("--elastic-smoke", action="store_true",
                    help="the elastic warm-pool drill: mix shift, "
                         "memory pressure, brownout, shrink, restart "
                         "with zero fresh builds")
    ap.add_argument("--design-smoke", action="store_true",
                    help="the inverse-design drill: the eel gait's "
                         "adjoint against a central difference, strict "
                         "Adam descent, one build then cache hits")
    ap.add_argument("--sharded-smoke", action="store_true",
                    help="the sharded-checkpoint drill: no-gather save, "
                         "elastic restore, damage inventory, collision, "
                         "supervised sharded rollback and its replay, "
                         "fsck gate")
    ap.add_argument("--sharded-crash-child", metavar="DIR",
                    help="run the sharded checkpoint-writer victim loop "
                         "in DIR (f64, --n-devices shards)")
    ap.add_argument("--mesh", type=int, default=0, metavar="D",
                    help="with --fleet-smoke: add the lane-mesh leg on a "
                         "D-shard lane mesh")
    ap.add_argument("--n-devices", type=int, default=8)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--interval", type=int, default=5)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.sharded_crash_child:
        run_sharded_crash_child(args.sharded_crash_child, args.steps,
                                args.interval, keep=args.keep,
                                n_devices=args.n_devices,
                                device=args.device)
        return 0
    drills = [(args.smoke, run_smoke), (args.silent_smoke, run_silent_smoke),
              (args.replay_smoke, run_replay_smoke),
              (args.fleet_smoke,
               lambda device: run_fleet_smoke(device=device,
                                              mesh_shards=args.mesh)),
              (args.sharded_smoke, run_sharded_smoke),
              (args.assim_smoke, run_assim_smoke),
              (args.soak_smoke, run_soak_smoke),
              (args.elastic_smoke, run_elastic_smoke),
              (args.design_smoke, run_design_smoke)]
    if not any(on for on, _ in drills):
        ap.error("name at least one drill")
    if args.device == "cpu" and (args.soak_smoke or args.elastic_smoke):
        # the serving drills run many request threads of small ops at
        # once: intra-op threads only contend for the cores
        torch.set_num_threads(1)
    for on, fn in drills:
        if on:
            res = fn(device=args.device)
            print(json.dumps({k: v for k, v in res.items()
                              if k not in ("incidents", "state", "escalations")},
                             default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
