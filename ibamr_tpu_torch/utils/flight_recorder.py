"""Flight recorder: bounded ring of chunk-entry states + run
fingerprint, dumped as a bitwise-replayable capsule on any incident (port
of ``ibamr_tpu/utils/flight_recorder.py``).

- :meth:`FlightRecorder.snapshot` is called by
  :class:`~ibamr_tpu_torch.utils.hierarchy_driver.HierarchyDriver` once
  per chunk, BEFORE the chunk replaces the state. The snapshot is a
  ``clone`` of every leaf on the state's own device: a copy the chunk
  cannot alias, made at the device's memory rate (a host copy of the
  256^3 flagship state, ~0.47 GB, would cross PCIe before every chunk).
  The ring is bounded (``capacity`` chunks); ``overhead_s`` accounts for
  the snapshots' wall time.
- :meth:`FlightRecorder.dump_incident` writes
  ``incidents/<step>/replay.npz`` (the pre-chunk state, host arrays in
  the checkpoint layout) plus ``manifest.json``: the run fingerprint
  (config digest, integrator spec, engine, ``spectral_dtype``, torch and
  numpy versions, device count and platform, active fault injectors,
  shadow-audit parameters) and the POST-chunk digest (per-leaf CRC32s
  and the health vector of the state the failing chunk produces, by
  re-executing the recorded chunk once through the driver's own chunk).
  ``ibamr_tpu_torch/tools/replay.py`` re-executes the capsule and pins
  bitwise against that digest.

Both files are written with the checkpoint module's atomic-write
discipline (temp + fsync + rename); the manifest is written LAST and is
the commit marker.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from collections import deque
from typing import Any, List, Optional

import numpy as np
import torch

from ibamr_tpu_torch.parallel.spmd import Blocks
from ibamr_tpu_torch.utils.checkpoint import (_atomic_write_digest,
                                              _gather_arrays, _host,
                                              _leaf_crc, _path_str)
from ibamr_tpu_torch.utils.tree import flatten_with_path, map_with_path

CAPSULE_SCHEMA = 1


def _json_safe(obj):
    """Best-effort conversion of config/spec values to JSON types."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return repr(obj)


def canonicalize(obj):
    """Deterministic JSON-safe form of fingerprint/cache-key material:
    values through :func:`_json_safe` (tuples -> lists, numpy scalars ->
    python), dict keys RECURSIVELY sorted. Two semantically identical
    configs that differ only in dict insertion order canonicalize (and
    therefore digest, e.g. into the ledger's ``run_id``) identically."""
    def _sort(v):
        if isinstance(v, dict):
            return {k: _sort(v[k]) for k in sorted(v)}
        if isinstance(v, list):
            return [_sort(x) for x in v]
        return v
    return _sort(_json_safe(obj))


def _engine_label(val) -> Optional[str]:
    """Normalize an engine selection value (the ``use_fast_interaction``
    vocabulary) to a stable string label."""
    if val is None:
        return "auto"
    if val is True:
        return "mxu"
    if val is False:
        return "scatter"
    return str(val)


def describe_integrator(integ) -> dict:
    """Reconstructible spec of an integrator: enough for
    ``tools/replay.py`` to rebuild it in a fresh process. The INS
    integrator is described field by field; anything else falls back to
    an opaque record (replayable only through an explicit factory
    ``spec`` passed to the recorder)."""
    if integ is None:
        return {"kind": "opaque", "class": None}
    grid = getattr(integ, "grid", None)
    if (grid is not None and hasattr(integ, "rho")
            and hasattr(integ, "convective_op_type")
            and hasattr(integ, "initialize")):
        from ibamr_tpu_torch.solvers.escalation import precision_level_name

        wall = getattr(integ, "wall_axes", None)
        return {
            "kind": "ins",
            "grid": {"n": [int(v) for v in grid.n],
                     "x_lo": [float(v) for v in grid.x_lo],
                     "x_up": [float(v) for v in grid.x_up]},
            "rho": float(integ.rho), "mu": float(integ.mu),
            "convective_op_type": str(integ.convective_op_type),
            "dtype": str(integ.dtype).replace("torch.", ""),
            "wall_axes": None if wall is None else [bool(w) for w in wall],
            "spectral_dtype": precision_level_name(
                getattr(integ, "spectral_dtype", None)),
            "device": str(getattr(integ, "device", "cuda")),
        }
    return {"kind": "opaque", "class": type(integ).__name__}


def factory_spec(module: str, name: str, **kwargs) -> dict:
    """Spec for an integrator built by a module-level factory (e.g.
    ``ibamr_tpu_torch.models.shell3d.build_shell_example``): replay imports
    ``module``, calls ``name(**kwargs)`` and expects ``(integ, state)``
    (or an integrator with ``initialize()``). Overrides substitute into
    ``kwargs`` by key (``engine`` maps onto ``use_fast_interaction``)."""
    return {"kind": "factory", "module": module, "name": name,
            "kwargs": _json_safe(kwargs)}


@dataclasses.dataclass
class ChunkSnapshot:
    """One ring entry: a copy of the state ENTERING a chunk, on the
    state's device. Fleet chunks store the per-lane dt vector and
    lane-alive mask; solo chunks keep the scalar dt and ``alive=None``."""
    step: int
    dt: Any                           # float, or (B,) ndarray in fleet mode
    length: int
    paths: List[str]                  # leaf order of the checkpoint layout
    state: Any                        # the cloned pytree
    wall_time: float
    alive: Optional[np.ndarray] = None

    def covers(self, step: Optional[int]) -> bool:
        return (step is None
                or self.step <= step <= self.step + self.length)


class FlightRecorder:
    """Bounded ring of pre-chunk host snapshots + the run fingerprint.

    Parameters
    ----------
    capacity:
        Ring depth in chunks. The newest entry covering the incident
        step becomes the capsule; a handful suffices (the supervisor
        dumps on the FIRST raise).
    spec:
        Optional explicit integrator spec (see :func:`factory_spec`)
        overriding the derived :func:`describe_integrator` record —
        required for replay of anything but the plain INS integrator.
    extra_fingerprint:
        Extra JSON-safe fields merged into the fingerprint (mesh shape,
        run labels, ...).
    """

    def __init__(self, capacity: int = 4, spec: Optional[dict] = None,
                 extra_fingerprint: Optional[dict] = None):
        if capacity < 1:
            raise ValueError("FlightRecorder.capacity must be >= 1")
        self.capacity = capacity
        self.ring: "deque[ChunkSnapshot]" = deque(maxlen=capacity)
        self.spec = spec
        self.extra = dict(extra_fingerprint or {})
        self.snapshots = 0
        self.overhead_s = 0.0         # cumulative snapshot cost (the
        #                               < 2%-of-chunk-wall observable)
        self.dumps: List[str] = []
        self._integ = None
        self._cfg = None

    # -- recording -----------------------------------------------------------

    def snapshot(self, state, *, step: int, dt, length: int,
                 integ=None, cfg=None, alive=None) -> None:
        """Copy the pre-chunk state into the ring (``clone`` of every
        leaf, on its device). Fleet chunks pass the (B,) per-lane dt
        vector and lane-alive mask."""
        t0 = time.perf_counter()
        paths = [_path_str(p) for p, _ in flatten_with_path(state)]
        copy = map_with_path(
            lambda _, leaf: leaf.detach().clone()
            if isinstance(leaf, (torch.Tensor, Blocks)) else leaf, state)
        dt_val = float(dt) if np.ndim(dt) == 0 \
            else np.array(dt, dtype=np.float64)
        self.ring.append(ChunkSnapshot(
            step=int(step), dt=dt_val, length=int(length),
            paths=paths, state=copy, wall_time=time.time(),
            alive=None if alive is None else np.array(alive, dtype=bool)))
        if integ is not None:
            self._integ = integ
        if cfg is not None:
            self._cfg = cfg
        self.snapshots += 1
        self.overhead_s += time.perf_counter() - t0

    def entry_for_step(self, step: Optional[int]) -> Optional[ChunkSnapshot]:
        """Newest ring entry whose chunk covers ``step`` (fallback: the
        newest entry - an incident belongs to the last chunk started)."""
        for entry in reversed(self.ring):
            if entry.covers(step):
                return entry
        return self.ring[-1] if self.ring else None

    def restore(self, entry: ChunkSnapshot):
        """A fresh copy of a ring entry's state (the ring keeps its own)."""
        return map_with_path(
            lambda _, leaf: leaf.clone()
            if isinstance(leaf, (torch.Tensor, Blocks)) else leaf,
            entry.state)

    # -- fingerprint ---------------------------------------------------------

    def fingerprint(self, driver=None) -> dict:
        """The run identity a replay must reproduce. JSON-safe."""
        integ = driver.integ if driver is not None else self._integ
        cfg = driver.cfg if driver is not None else self._cfg
        cfg_dict = (_json_safe(dataclasses.asdict(cfg))
                    if dataclasses.is_dataclass(cfg) else {})
        digest = hashlib.sha256(
            json.dumps(cfg_dict, sort_keys=True).encode()).hexdigest()
        spec = self.spec if self.spec is not None \
            else describe_integrator(integ)
        try:
            from ibamr_tpu_torch.solvers.escalation import precision_level_name
            fluid = getattr(integ, "ins", integ)
            sd = precision_level_name(
                getattr(fluid, "spectral_dtype", None))
        except Exception:
            sd = None
        engine, chain = self._engine_info(integ, spec)
        try:
            from ibamr_tpu_torch.tools.fault_injection import \
                ACTIVE_INJECTORS
            injectors = _json_safe(dict(ACTIVE_INJECTORS))
        except Exception:
            injectors = {}
        audit = None
        sa = getattr(driver, "shadow_audit", None)
        if sa is not None:
            audit = sa.params()
        fp = {
            "config": cfg_dict, "config_digest": digest,
            "integrator": spec,
            "spectral_dtype": sd,
            "engine": engine, "engine_chain": chain,
            "torch_version": torch.__version__,
            "numpy_version": np.__version__,
            "device_count": (torch.cuda.device_count()
                             if torch.cuda.is_available() else 0),
            "platform": _platform(integ),
            "mesh_shape": self.extra.get("mesh_shape"),
            "mesh": self.extra.get("mesh"),
            # the framework threads no RNG through the run loop; the
            # slot exists so stochastic physics can stamp its keys via
            # extra_fingerprint without a schema bump
            "rng_keys": self.extra.get("rng_keys"),
            "injectors": injectors,
            "audit": audit,
        }
        for k, v in self.extra.items():
            fp.setdefault(k, _json_safe(v))
        # canonical form: dict insertion order must never leak into
        # run_id digests
        return canonicalize(fp)

    def run_id(self, driver=None) -> str:
        """The 16-hex run identity the observability ledger stamps on
        every record — a digest of :meth:`fingerprint`, so the ledger,
        the incident capsules and the replay verdicts of one run all
        cross-reference by the same id."""
        from ibamr_tpu_torch.obs import run_id_from_fingerprint
        return run_id_from_fingerprint(self.fingerprint(driver=driver))

    def observe(self, integ=None, cfg=None) -> None:
        """Bind integrator/config context for fingerprinting WITHOUT
        taking a ring snapshot."""
        if integ is not None:
            self._integ = integ
        if cfg is not None:
            self._cfg = cfg

    @staticmethod
    def _engine_info(integ, spec):
        """(engine label, fallback chain) actually in use, best-effort.
        The RESOLVED name stamped by the factory (``ib.engine_name``,
        post-auto-resolution and post-fallback) wins over the factory
        spec's alias — the fingerprint must describe what runs, not
        what was asked for."""
        label = None
        ib_resolved = getattr(getattr(integ, "ib", None),
                              "engine_name", None)
        if ib_resolved is not None:
            label = str(ib_resolved)
        if label is None and spec.get("kind") == "factory":
            kwargs = spec.get("kwargs", {})
            if "use_fast_interaction" in kwargs:
                label = _engine_label(kwargs["use_fast_interaction"])
        if label is None:
            ib = getattr(integ, "ib", None)
            fast = getattr(ib, "fast", None)
            if ib is not None:
                label = (type(fast).__name__ if fast is not None
                         else "scatter")
        if label is None:
            return None, None
        # the port never degrades to another engine: the chain is the
        # engine alone
        return label, [label]

    # -- capsule dump --------------------------------------------------------

    def dump_incident(self, *, directory: str, kind: str,
                      step: Optional[int] = None,
                      event: Optional[str] = None,
                      driver=None,
                      lane: Optional[int] = None) -> Optional[str]:
        """Write ``<directory>/<step>/replay.npz`` + ``manifest.json``
        for the newest ring entry covering ``step``. Returns the
        capsule directory (or None when the ring is empty). A second
        incident landing on the same chunk reuses the existing capsule
        (the state is identical; only the first dump pays).

        ``lane`` (fleet runs) slices the lane-stacked snapshot down to
        that lane's rows: the capsule is SINGLE-LANE (``-L<k>`` suffix
        on the directory), carries a ``lane`` manifest record with the
        original ``lane_index``/``fleet_size``, and replays unbatched —
        ``tools/replay.py`` re-executes it as a B=1 fleet chunk, the
        bitwise-equal solo form of the failing lane."""
        entry = self.entry_for_step(step)
        if entry is None:
            return None
        fleet = np.ndim(entry.dt) > 0
        suffix = "" if lane is None else f"-L{lane:03d}"
        cap_dir = os.path.join(directory, f"{entry.step:08d}{suffix}")
        manifest_path = os.path.join(cap_dir, "manifest.json")
        if os.path.exists(manifest_path):
            return cap_dir
        os.makedirs(cap_dir, exist_ok=True)
        npz_path = os.path.join(cap_dir, "replay.npz")
        host = _gather_arrays(entry.state)
        if lane is not None:
            arrays = {k: np.ascontiguousarray(v[lane])
                      for k, v in host.items()}
            chunk_dt = float(entry.dt[lane]) if fleet \
                else float(entry.dt)
        else:
            arrays = host
            chunk_dt = [float(v) for v in entry.dt] if fleet \
                else entry.dt
        _atomic_write_digest(npz_path, lambda f: np.savez(f, **arrays))
        post = None
        if driver is not None and kind != "stall":
            # a stalled chunk may hang again on re-execution — replay
            # of a stall capsule is interactive business, not dump-time
            post = self._post_digest(entry, driver, lane=lane)
        manifest = {
            "capsule_schema": CAPSULE_SCHEMA,
            "incident": {"kind": kind, "event": event,
                         "step": step},
            "chunk": {"start_step": entry.step, "length": entry.length,
                      "dt": chunk_dt},
            "state_file": "replay.npz",
            "leaf_order": entry.paths,
            "pre_leaf_crcs": {k: _leaf_crc(arrays[k])
                              for k in entry.paths},
            "post": post,
            "fingerprint": self.fingerprint(driver),
            "time": time.time(),
        }
        try:
            # a capsule dumped while serving names the request(s) whose
            # trace crosses it — the ledger timeline and the capsule
            # then cross-reference by trace_id, not just run_id
            from ibamr_tpu_torch.obs import bus as _bus
            tids = _bus.current_trace()
            if tids:
                if len(tids) == 1:
                    manifest["trace_id"] = tids[0]
                else:
                    manifest["trace_ids"] = list(tids)
        except Exception:
            pass
        if lane is not None:
            fleet_size = (len(entry.dt) if fleet else
                          getattr(driver, "lanes", None))
            manifest["lane"] = {"index": int(lane),
                                "fleet_size": None if fleet_size is None
                                else int(fleet_size)}
        elif fleet:
            manifest["fleet"] = {
                "size": len(entry.dt),
                "alive": None if entry.alive is None
                else [bool(a) for a in entry.alive]}
        _atomic_write_digest(manifest_path,
                      lambda f: f.write(json.dumps(
                          manifest, indent=1).encode()))
        self.dumps.append(cap_dir)
        return cap_dir

    def _post_digest(self, entry: ChunkSnapshot, driver,
                     lane: Optional[int] = None) -> Optional[dict]:
        """Per-leaf CRC32s + health vector of the state the recorded
        chunk produces, by ONE re-execution through the driver's own
        chunk (incidents are rare; the extra chunk is cheap). For a lane
        capsule, the digest of the LANE's slice of the fleet
        re-execution: bitwise what a B=1 replay must reproduce. None
        when the re-execution itself fails."""
        try:
            state = self.restore(entry)
            if np.ndim(entry.dt) > 0:
                alive = entry.alive if entry.alive is not None \
                    else np.ones(len(entry.dt), dtype=bool)
                out, health = driver._chunk(entry.length)(
                    state, np.asarray(entry.dt), alive)
            else:
                out, health = driver._chunk(entry.length)(state, entry.dt)
            h = _host(health).astype(np.float64)
            if lane is not None:
                from ibamr_tpu_torch.utils.lanes import lane_slice
                out = lane_slice(out, lane)
                vit = h[:, lane] if h.ndim == 2 else h[lane:lane + 1]
            else:
                vit = h.reshape(-1)
            arrays = _gather_arrays(out)
            return {
                "leaf_crcs": {k: _leaf_crc(v) for k, v in arrays.items()},
                "vitals": [float(v) for v in vit],
                "finite": bool(np.isfinite(
                    np.concatenate([np.asarray(v, dtype=np.float64).
                                    reshape(-1) for v in arrays.values()
                                    if np.issubdtype(v.dtype,
                                                     np.floating)])).all()),
            }
        except Exception:
            return None


def _platform(integ) -> str:
    """``cuda`` or ``cpu``: the device type the integrator runs on."""
    fluid = getattr(integ, "ins", integ)
    dev = getattr(fluid, "device", None)
    if dev is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(dev).type
