"""Deterministic incident replay (port of ``tools/replay.py``).

A capsule ``incidents/<step>/replay.npz`` + ``manifest.json`` (dumped by
the :class:`~ibamr_tpu_torch.utils.flight_recorder.FlightRecorder`
through the supervisor) holds the failing chunk: the pre-chunk state,
the run fingerprint (integrator spec, engine, ``spectral_dtype``, armed
fault injectors, audit parameters) and the post-chunk digest (per-leaf
CRC32s and the health vector). :func:`replay`:

1. **baseline**: rebuilds the integrator from the fingerprint, re-arms
   the recorded injectors, runs the chunk (the driver's loop of eager
   steps) and pins the produced state BITWISE against the recorded
   post-chunk CRCs;
2. **substitution**: ``overrides`` (``engine=...``,
   ``spectral_dtype=...``, or a factory keyword) and ``dt_scale`` re-run
   the same capsule under one substitution;
3. **verdict**: ``reproduced`` (the baseline matched bitwise and the
   override, if any, still failed), ``engine_dependent`` /
   ``precision_dependent`` (the override cured it), ``not_reproduced``
   (the baseline did not match the recorded digest). A dt cure is
   reported as ``dt_dependent: true`` on a ``reproduced`` verdict.

The rebuild runs on the device the capsule recorded (a factory spec's
``device`` keyword, an INS spec's ``device``) unless ``device=`` names
another. Lane capsules (one lane sliced out of a fleet chunk) replay as
a B=1 fleet chunk, with recorded lane faults moved onto lane 0; in the
port a B=1 fleet chunk is bitwise the solo chunk.

Capsules record unsharded host arrays, so any capsule replays on one
device. A capsule of a sharded run also records its mesh spec (stamped
by ``ResilientDriver(sharded=True, mesh=...)``). On one device it runs
the single-device step, another program than the sharded step's pencil
solves, so its bits differ from the recorded digest and only the
failure reproduces. ``--sharded`` re-executes the recorded sharded
program on a rebuilt mesh of the same shape (its shards on the replay's
device), bitwise, and degrades to the
single-device program with ``mesh_degraded: true`` and the
failure-reproduction pin when that mesh cannot be rebuilt here (a CUDA
mesh with no GPU), as the reference degrades with too few devices.

Not ported: the reference's x64 scope (the port has no global precision
mode: every dtype is explicit in the integrator spec).

    python -m ibamr_tpu_torch.tools.replay CKPT_DIR/incidents/00000020 \\
        [--override spectral_dtype=f64] [--override engine=scatter] \\
        [--dt-scale 0.5] [--device cpu] [--sharded] [--json]
"""

from __future__ import annotations

import argparse
import importlib
import json
import os

import numpy as np
import torch


class ReplayError(RuntimeError):
    pass


def read_incidents(path: str) -> list:
    """Read ``incidents.jsonl``; records without ``schema`` read as
    ``schema=2`` with ``replay=None``."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            rec.setdefault("schema", 2)
            rec.setdefault("replay", None)
            out.append(rec)
    return out


def load_capsule(capsule_dir: str):
    """``(manifest, {path: np.ndarray})`` of a capsule directory."""
    mpath = os.path.join(capsule_dir, "manifest.json")
    if not os.path.exists(mpath):
        raise ReplayError(f"no manifest.json in {capsule_dir!r}")
    with open(mpath) as f:
        manifest = json.load(f)
    npz = os.path.join(capsule_dir, manifest.get("state_file", "replay.npz"))
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    return manifest, arrays


_ENGINE_TO_KWARG = {"scatter": False, "auto": None}


def rebuild(manifest: dict, overrides: dict | None = None, device=None):
    """``(integ, template_state)`` per the manifest fingerprint, with
    ``overrides`` substituted (``spectral_dtype`` -> the spectral knob,
    ``engine`` -> the factory's ``use_fast_interaction``; other keys
    substitute into the factory's keywords)."""
    overrides = dict(overrides or {})
    spec = manifest["fingerprint"]["integrator"]
    kind = spec.get("kind")
    if kind == "ins":
        from ibamr_tpu_torch.grid import StaggeredGrid
        from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator

        if "engine" in overrides:
            raise ReplayError("--override engine applies to factory "
                              "capsules (the plain INS integrator has "
                              "no transfer engine)")
        gd = spec["grid"]
        grid = StaggeredGrid(n=tuple(gd["n"]), x_lo=tuple(gd["x_lo"]),
                             x_up=tuple(gd["x_up"]))
        wall = spec.get("wall_axes")
        integ = INSStaggeredIntegrator(
            grid, rho=spec["rho"], mu=spec["mu"],
            convective_op_type=spec["convective_op_type"],
            dtype=getattr(torch, spec["dtype"]),
            wall_axes=None if wall is None else tuple(wall),
            spectral_dtype=overrides.get("spectral_dtype",
                                         spec.get("spectral_dtype")),
            device=device or spec.get("device", "cuda"))
        return integ, integ.initialize()
    if kind == "factory":
        mod = importlib.import_module(spec["module"])
        fn = getattr(mod, spec["name"])
        kwargs = dict(spec.get("kwargs", {}))
        if isinstance(kwargs.get("dtype"), str):
            kwargs["dtype"] = getattr(torch, kwargs["dtype"])
        if device is not None:
            kwargs["device"] = device
        for key, val in overrides.items():
            if key == "engine":
                kwargs["use_fast_interaction"] = \
                    _ENGINE_TO_KWARG.get(val, val)
            else:
                kwargs[key] = val
        out = fn(**kwargs)
        if isinstance(out, tuple):
            return out[0], out[1]
        return out, out.initialize()
    raise ReplayError(
        f"capsule integrator spec kind={kind!r} is not replayable "
        f"(record an explicit factory spec on the FlightRecorder)")


def state_from_capsule(manifest: dict, arrays: dict, template):
    """The capsule's state on the template's devices and dtypes: arrays
    keyed by the checkpoint path convention in recorded ``leaf_order``."""
    from ibamr_tpu_torch.utils.checkpoint import _path_str
    from ibamr_tpu_torch.utils.tree import flatten_with_path, map_with_path

    keys = [_path_str(p) for p, _ in flatten_with_path(template)]
    order = manifest["leaf_order"]
    if set(keys) != set(order):
        raise ReplayError(
            f"capsule/template leaf mismatch: capsule has "
            f"{sorted(set(order) - set(keys))} extra, template has "
            f"{sorted(set(keys) - set(order))} extra")
    return map_with_path(
        lambda p, leaf: torch.as_tensor(arrays[_path_str(p)]).to(
            device=leaf.device, dtype=leaf.dtype), template)


def rebuild_mesh(mesh_spec: dict, device="cuda"):
    """The recorded mesh rebuilt on this process: the same shape and
    axis names, its shards over the devices of ``device``'s type (all
    on ``cuda:0`` with one card). Raises :class:`ReplayError` when no
    such device is available."""
    from ibamr_tpu_torch.parallel.spmd import Mesh, mesh_devices

    shape = tuple(int(s) for s in mesh_spec["shape"])
    need = int(np.prod(shape))
    try:
        devs = mesh_devices(need, device)
    except RuntimeError as e:
        raise ReplayError(f"capsule was recorded on a {shape} mesh; it "
                          f"cannot be rebuilt here: {e}")
    names = mesh_spec.get("axis_names") or \
        [f"ax{i}" for i in range(len(shape))]
    arr = np.empty(need, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), tuple(names))


def _replay_device(manifest: dict, device=None) -> str:
    spec = manifest["fingerprint"]["integrator"]
    return str(device or spec.get("device")
               or spec.get("kwargs", {}).get("device") or "cuda")


def execute_chunk(integ, state, dt: float, length: int, step_wrap=None,
                  step_fn=None):
    """Re-execute the failing chunk: ``length`` eager steps, the loop
    the driver's chunk runs. Returns the post-chunk state."""
    step = integ.step if step_fn is None else step_fn
    if step_wrap is not None:
        step = step_wrap(step)
    for _ in range(length):
        state = step(state, dt)
    return state


def execute_lane_chunk(integ, state, dt: float, length: int,
                       step_wrap=None):
    """Re-execute a LANE capsule's chunk as a B=1 fleet chunk (the
    driver's fleet chunk with one live lane); ``step_wrap`` (recorded
    lane faults, moved onto lane 0) wraps the stacked step."""
    from ibamr_tpu_torch.utils.hierarchy_driver import (HierarchyDriver,
                                                        RunConfig)
    from ibamr_tpu_torch.utils.lanes import lane_slice, stack_lanes

    drv = HierarchyDriver(integ, RunConfig(dt=dt, num_steps=length),
                          lanes=1, fleet_step_wrap=step_wrap)
    out, _ = drv._chunk(length)(stack_lanes([state]),
                                np.asarray([dt]), np.ones(1, dtype=bool))
    return lane_slice(out, 0)


def digest_state(post_state) -> dict:
    from ibamr_tpu_torch.utils.checkpoint import _gather_arrays, _leaf_crc

    return {k: _leaf_crc(v) for k, v in _gather_arrays(post_state).items()}


def _all_finite(state) -> bool:
    from ibamr_tpu_torch.parallel.spmd import Blocks
    from ibamr_tpu_torch.utils.tree import leaves
    return all(bool(torch.isfinite(leaf).all()) for leaf in leaves(state)
               if isinstance(leaf, (torch.Tensor, Blocks))
               and leaf.is_floating_point())


def chunk_failed(manifest: dict, integ, post_state, dt: float) -> bool:
    """Did THIS execution show the recorded failure? Non-finite leaves
    for the divergence family; a recomputed shadow-audit breach for
    ``precision_drift`` (whose state is finite)."""
    kind = (manifest.get("incident") or {}).get("kind", "divergence")
    if not _all_finite(post_state):
        return True
    if kind == "precision_drift":
        from ibamr_tpu_torch.solvers.escalation import (PrecisionDrift,
                                                        ShadowAuditor)

        audit = manifest["fingerprint"].get("audit") or {}
        aud = ShadowAuditor(every=1, bound=audit.get("bound", 0.02),
                            div_bound=audit.get("div_bound"))
        try:
            aud.audit(integ, post_state, dt,
                      step=manifest["chunk"]["start_step"]
                      + manifest["chunk"]["length"])
        except PrecisionDrift:
            return True
    return False


def _run_once(manifest, arrays, overrides, dt_scale, device,
              sharded=False):
    from ibamr_tpu_torch.tools.fault_injection import \
        apply_recorded_injectors

    injectors = dict(manifest["fingerprint"].get("injectors") or {})
    lane_rec = manifest.get("lane")
    armed = {}
    for name, params in injectors.items():
        if name in ("lane_nan", "lane_drift", "member_divergence") \
                and lane_rec is not None:
            # a fault aimed at THIS lane moves onto lane 0 of the B=1
            # replay fleet; one aimed at another lane cannot fire here
            p = dict(params)
            if int(p.get("lane", -1)) != int(lane_rec["index"]):
                continue
            p["lane"] = 0
            p["fleet_size"] = 1
            armed[name] = p
        else:
            armed[name] = params
    with apply_recorded_injectors(armed) as wrap:
        integ, template = rebuild(manifest, overrides, device=device)
        state = state_from_capsule(manifest, arrays, template)
        dt = float(manifest["chunk"]["dt"]) * float(dt_scale)
        length = int(manifest["chunk"]["length"])
        if lane_rec is not None:
            post = execute_lane_chunk(integ, state, dt, length,
                                      step_wrap=wrap)
        else:
            step_fn = None
            if sharded:
                # the SAME sharded program the incident ran: the recorded
                # mesh rebuilt, the capsule state placed on it
                from ibamr_tpu_torch.parallel.mesh import (make_sharded_step,
                                                           place_state)
                mesh = rebuild_mesh(manifest["fingerprint"]["mesh"],
                                    _replay_device(manifest, device))
                grid = getattr(integ, "grid", None) or integ.ins.grid
                state = place_state(state, grid, mesh)
                step_fn = make_sharded_step(integ, mesh)
            post = execute_chunk(integ, state, dt, length, step_wrap=wrap,
                                 step_fn=step_fn)
        crcs = digest_state(post)
        failed = chunk_failed(manifest, integ, post, dt)
    return {"leaf_crcs": crcs, "failed": failed,
            "finite": _all_finite(post)}


def replay(capsule_dir: str, overrides: dict | None = None,
           dt_scale: float = 1.0, device=None, sharded: bool = False) -> dict:
    """Full replay: baseline bitwise pin, optional substitution run,
    structured verdict (see the module docstring). ``sharded=True``
    re-executes on the recorded mesh, or degrades (``mesh_degraded``)
    when it cannot be rebuilt here."""
    manifest, arrays = load_capsule(capsule_dir)
    recorded_post = manifest.get("post")
    mesh_spec = (manifest.get("fingerprint") or {}).get("mesh")
    mesh_degraded = use_sharded = False
    if sharded:
        if manifest.get("lane") is not None:
            raise ReplayError("lane capsules replay unbatched (B=1); "
                              "--sharded does not apply")
        if not mesh_spec or int(mesh_spec.get("n_shards", 1)) <= 1:
            raise ReplayError(
                "sharded replay requested but the capsule records no "
                "multi-shard mesh (was the run supervised with "
                "ResilientDriver(sharded=True, mesh=...)?)")
        try:
            rebuild_mesh(mesh_spec, _replay_device(manifest, device))
            use_sharded = True
        except ReplayError:
            mesh_degraded = True
    base = _run_once(manifest, arrays, None, 1.0, device, use_sharded)
    if recorded_post and recorded_post.get("leaf_crcs"):
        bitwise = base["leaf_crcs"] == {
            k: int(v) for k, v in recorded_post["leaf_crcs"].items()}
        if not bitwise and mesh_degraded:
            # the recorded digest belongs to the sharded program that
            # could not be rebuilt: pin failure reproduction instead
            bitwise = base["failed"]
    else:
        # no recorded digest (a stall capsule): the weaker pin
        bitwise = base["failed"]
    result = {
        "capsule": os.path.abspath(capsule_dir),
        "kind": (manifest.get("incident") or {}).get("kind"),
        "bitwise": bool(bitwise),
        "baseline_failed": bool(base["failed"]),
        "override": dict(overrides) if overrides else None,
        "dt_scale": float(dt_scale),
        "override_failed": None,
        "dt_dependent": None,
        "recorded_mesh": mesh_spec,
        "sharded_replay": use_sharded,
        "mesh_degraded": mesh_degraded,
    }
    has_sub = bool(overrides) or dt_scale != 1.0
    if has_sub:
        sub = _run_once(manifest, arrays, overrides, dt_scale, device,
                        use_sharded)
        result["override_failed"] = bool(sub["failed"])
    if not bitwise:
        verdict = "not_reproduced"
    elif not has_sub:
        verdict = "reproduced" if base["failed"] else "not_reproduced"
    elif result["override_failed"]:
        verdict = "reproduced"
    elif overrides and "spectral_dtype" in overrides:
        verdict = "precision_dependent"
    elif overrides and "engine" in overrides:
        verdict = "engine_dependent"
    else:
        verdict = "reproduced"
        result["dt_dependent"] = True
    result["verdict"] = verdict
    from ibamr_tpu_torch import obs as _obs
    _obs.counter("replay_verdicts_total", verdict=verdict).inc()
    _obs.emit("replay", verdict=verdict, step=result.get("step"),
              override_failed=result.get("override_failed"))
    return result


def newest_capsule(root: str) -> str | None:
    """Newest ``incidents/<step>`` capsule under a checkpoint root (or
    an incidents directory itself)."""
    cand = root
    if os.path.isdir(os.path.join(root, "incidents")):
        cand = os.path.join(root, "incidents")
    if not os.path.isdir(cand):
        return None
    caps = [os.path.join(cand, d) for d in sorted(os.listdir(cand))
            if os.path.exists(os.path.join(cand, d, "manifest.json"))]
    return caps[-1] if caps else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="re-execute an incident replay capsule, bitwise-"
                    "pinned against its recorded post-chunk digest")
    ap.add_argument("capsule", help="incidents/<step> capsule directory")
    ap.add_argument("--override", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="substitute one knob (engine=..., "
                         "spectral_dtype=..., or a factory keyword)")
    ap.add_argument("--dt-scale", type=float, default=1.0,
                    help="re-run the chunk at dt * SCALE")
    ap.add_argument("--device", default=None,
                    help="rebuild on this device instead of the recorded "
                         "one")
    ap.add_argument("--sharded", action="store_true",
                    help="re-execute on the capsule's recorded mesh "
                         "(degrades when it cannot be rebuilt here)")
    ap.add_argument("--json", action="store_true",
                    help="print the full result dict as JSON")
    args = ap.parse_args(argv)
    overrides = {}
    for item in args.override:
        if "=" not in item:
            ap.error(f"--override {item!r}: expected KEY=VALUE")
        key, val = item.split("=", 1)
        overrides[key.strip()] = val.strip()
    result = replay(args.capsule, overrides=overrides or None,
                    dt_scale=args.dt_scale, device=args.device,
                    sharded=args.sharded)
    if args.json:
        print(json.dumps(result, indent=1))
    else:
        print(f"verdict: {result['verdict']} "
              f"(bitwise={result['bitwise']}, "
              f"baseline_failed={result['baseline_failed']}, "
              f"override_failed={result['override_failed']})")
    return 0 if result["verdict"] != "not_reproduced" else 3


if __name__ == "__main__":
    raise SystemExit(main())
