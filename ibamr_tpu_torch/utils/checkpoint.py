"""Checkpoint / restart of one simulation state (port of the single-state
part of ``ibamr_tpu/utils/checkpoint.py``).

The whole state is one pytree of tensors, so a checkpoint is one ``.npz``
holding every leaf keyed by its pytree path (``ins/u/0``, ``X``, ...)
plus a JSON sidecar with the step, the state schema (each leaf's shape
and dtype name) and an integrity record (per-leaf CRC32, whole-file
CRC32 and size). Both files land by write-to-temp + ``fsync`` +
``os.replace``, the sidecar after the arrays, so a kill at any instant
leaves the previous complete checkpoint or the new one. The layout, keys
and dtype names are the reference's: a checkpoint written by either
package restores into the other.

``restore_checkpoint`` and ``latest_step`` skip checkpoints that fail
verification and fall back to the newest verified one; pruning never
deletes the last verified checkpoint.

:class:`AsyncCheckpointWriter` writes off the critical path: ``save``
copies the state to the host at once (the copy is what the run may not
overwrite) and a single worker thread writes it, retrying once. Fleet
checkpoints (``lanes=B``) add per-lane CRCs to the sidecar, so
:func:`restore_lane` restores one lane from a step whose file is damaged
in another lane's rows. The per-shard format is
``utils/checkpoint_sharded.py``.
"""

from __future__ import annotations

import json
import os
import re
import threading
import warnings
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from ibamr_tpu_torch.parallel.spmd import Blocks
from ibamr_tpu_torch.utils.tree import flatten_with_path, map_with_path

SCHEMA_VERSION = 1


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (truncated file,
    flipped bytes, or a tampered/missing sidecar)."""


def _esc(s: str) -> str:
    # escape the path separator so dict keys containing '/' cannot collide
    # with genuine nesting ({"a/b": x} vs {"a": {"b": y}})
    return s.replace("%", "%25").replace("/", "%2F")


def _path_str(path) -> str:
    """The reference's ``_path_str``: field names and dict keys escaped,
    sequence positions as numbers, joined by ``/``."""
    parts = [str(v) if kind == "idx" else _esc(str(v)) for kind, v in path]
    return "/".join(parts) if parts else "_root"


def _dtype_name(leaf) -> str:
    if isinstance(leaf, (torch.Tensor, Blocks)):
        return str(leaf.dtype).replace("torch.", "")
    return str(getattr(leaf, "dtype", np.asarray(leaf).dtype))


def state_schema(state: Any) -> Dict[str, Any]:
    """Every leaf's path, shape and dtype name, as the reference writes
    them into the sidecar."""
    return {
        "version": SCHEMA_VERSION,
        "leaves": {_path_str(p): [list(np.shape(leaf)), _dtype_name(leaf)]
                   for p, leaf in flatten_with_path(state)},
    }


def _schema_diff(stored: Dict[str, Any], current: Dict[str, Any]) -> str:
    s_leaves = stored.get("leaves", {})
    c_leaves = current["leaves"]
    lines = []
    for k in sorted(set(s_leaves) - set(c_leaves)):
        lines.append(f"  checkpoint-only leaf: {k} {s_leaves[k]}")
    for k in sorted(set(c_leaves) - set(s_leaves)):
        lines.append(f"  template-only leaf:   {k} {c_leaves[k]}")
    for k in sorted(set(c_leaves) & set(s_leaves)):
        if s_leaves[k][0] != c_leaves[k][0]:
            lines.append(f"  shape mismatch at {k}: checkpoint "
                         f"{s_leaves[k][0]} vs template {c_leaves[k][0]}")
        elif (np.dtype(s_leaves[k][1]).kind
              != np.dtype(c_leaves[k][1]).kind):
            # width changes (f64 checkpoint -> f32 run) are a supported
            # cast; kind changes (float -> int) are a refactor
            lines.append(f"  dtype-kind mismatch at {k}: checkpoint "
                         f"{s_leaves[k][1]} vs template {c_leaves[k][1]}")
    return "\n".join(lines)


def _host(leaf) -> np.ndarray:
    """A leaf's host copy (a block-resident leaf assembled on the host:
    the whole-state files are a host-facing edge)."""
    if isinstance(leaf, (torch.Tensor, Blocks)):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _file_crc(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
    return crc & 0xFFFFFFFF


def _fsync_dir(directory: str) -> None:
    # durability of the os.replace itself
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write(path: str, write_fn) -> None:
    """Write via a pid- and thread-unique temp name + fsync +
    os.replace: the file at ``path`` is always absent, the old complete
    version or the new complete version, never torn (the serving
    manifest's writer, ``serve/autoscale.py``)."""
    _atomic_write_digest(path, write_fn)


def _atomic_write_digest(path: str, write_fn):
    """Write via a pid- and thread-unique temp name + fsync + os.replace;
    returns ``(crc32, size)`` of the bytes, read from the temp file
    before the replace."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        crc = _file_crc(tmp)
        size = os.path.getsize(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    _fsync_dir(os.path.dirname(path) or ".")
    return crc, size


def _npz(directory: str, step: int) -> str:
    return os.path.join(directory, f"restore.{step:08d}.npz")


def _gather_arrays(state: Any) -> Dict[str, np.ndarray]:
    """Host copies of every leaf, keyed by the reference's leaf path."""
    return {_path_str(p): _host(leaf) for p, leaf in flatten_with_path(state)}


def _write_arrays(directory: str, arrays: Dict[str, np.ndarray],
                  schema: Dict[str, Any], step: int,
                  metadata: Optional[Dict[str, Any]], keep: int,
                  lanes: Optional[int] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    fname = _npz(directory, step)
    npz_crc, npz_size = _atomic_write_digest(
        fname, lambda f: np.savez(f, **arrays))
    meta = dict(metadata or {})
    meta["step"] = step
    meta["schema"] = schema
    # the sidecar lands after the arrays: a complete sidecar implies a
    # complete array file (the commit marker)
    meta["integrity"] = {
        "leaves": {k: _leaf_crc(v) for k, v in arrays.items()},
        "npz_crc32": npz_crc,
        "npz_size": npz_size,
    }
    if lanes is not None:
        # fleet checkpoints: per-lane CRC32 of every lane-stacked leaf's
        # rows, so one corrupt lane condemns only that lane's slice
        meta["integrity"]["lanes"] = {
            "count": int(lanes),
            "leaves": {k: [_leaf_crc(v[i]) for i in range(int(lanes))]
                       for k, v in arrays.items()
                       if v.ndim >= 1 and v.shape[0] == int(lanes)},
        }
    payload = json.dumps(meta).encode()
    _atomic_write_digest(fname.replace(".npz", ".json"),
                         lambda f: f.write(payload))
    _prune(directory, keep)
    return fname


def save_checkpoint(directory: str, state: Any, step: int,
                    metadata: Optional[Dict[str, Any]] = None,
                    keep: int = 3, lanes: Optional[int] = None) -> str:
    """Serialize a state pytree. Returns the checkpoint file path.
    ``lanes`` (fleet runs) records per-lane leaf CRCs in the sidecar."""
    return _write_arrays(directory, _gather_arrays(state),
                         state_schema(state), step, metadata, keep,
                         lanes=lanes)


def _read_sidecar(directory: str, step: int) -> Optional[Dict[str, Any]]:
    """Parse the sidecar; None if absent or torn (invalid JSON)."""
    try:
        with open(_npz(directory, step).replace(".npz", ".json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def verify_checkpoint(directory: str, step: int) -> bool:
    """True iff step's checkpoint is complete and intact: the sidecar
    parses and the array file matches its recorded size and whole-file
    CRC32. Sidecars without an integrity record are accepted."""
    fname = _npz(directory, step)
    if not os.path.exists(fname):
        return False
    meta = _read_sidecar(directory, step)
    if meta is None:
        return False
    integ = meta.get("integrity")
    if integ is None:
        return True
    try:
        if os.path.getsize(fname) != integ.get("npz_size"):
            return False
        return _file_crc(fname) == integ.get("npz_crc32")
    except OSError:
        return False


def _all_steps(directory: str) -> list:
    steps = []
    for f in os.listdir(directory):
        m = re.fullmatch(r"restore\.(\d+)\.npz", f)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def _prune(directory: str, keep: int) -> None:
    # temp files of another process are debris from a killed writer
    for f in os.listdir(directory):
        m = re.search(r"\.tmp\.(\d+)(?:\.\d+)?$", f)
        if m and int(m.group(1)) != os.getpid():
            try:
                os.remove(os.path.join(directory, f))
            except OSError:
                pass
    if keep <= 0:
        return
    steps = _all_steps(directory)
    doomed = steps[:-keep]
    if not doomed:
        return
    # the newest verified checkpoint is never deleted
    last_verified = next((s for s in reversed(steps)
                          if verify_checkpoint(directory, s)), None)
    for s in doomed:
        if s == last_verified:
            continue
        os.remove(_npz(directory, s))
        side = _npz(directory, s).replace(".npz", ".json")
        if os.path.exists(side):
            os.remove(side)


def latest_step(directory: str,
                verified_only: bool = True) -> Optional[int]:
    """Newest restorable step (by default the newest that
    :func:`verify_checkpoint` vouches for)."""
    if not os.path.isdir(directory):
        return None
    steps = _all_steps(directory)
    if not verified_only:
        return steps[-1] if steps else None
    return next((s for s in reversed(steps)
                 if verify_checkpoint(directory, s)), None)


class AsyncCheckpointWriter:
    """Checkpoint writes on one worker thread, overlapping the next
    chunks.

    The device-to-host copy happens synchronously inside ``save``: the
    run goes on updating its tensors, so the worker may only see a copy.
    One worker keeps writes ordered; a write that fails twice (one retry)
    surfaces once on the next ``save``/``wait`` and is then dropped. The
    queue is bounded: at ``max_pending`` outstanding writes,
    ``overflow="block"`` waits for the oldest to land and
    ``overflow="drop"`` sheds the new save (``dropped_saves``).
    ``queue_depth()`` is the backlog, published as the
    ``ckpt_queue_depth`` gauge; each write's wall time goes to the
    ``ckpt_commit_seconds`` histogram.
    """

    def __init__(self, directory: str, keep: int = 3,
                 max_pending: int = 2, overflow: str = "block",
                 lanes: Optional[int] = None):
        from concurrent.futures import ThreadPoolExecutor

        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if overflow not in ("block", "drop"):
            raise ValueError("overflow must be 'block' or 'drop'")
        self.directory = directory
        self.keep = keep
        self.max_pending = max_pending
        self.overflow = overflow
        self.lanes = lanes
        self.dropped_saves = 0
        self._exec = ThreadPoolExecutor(max_workers=1)
        self._pending = []

    def queue_depth(self) -> int:
        """Writes enqueued but not yet finished."""
        return sum(1 for f in self._pending if not f.done())

    def _raise_finished(self):
        # drop completed futures first so a failure is reported once
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        for f in done:
            f.result()

    @staticmethod
    def _write_with_retry(directory, arrays, schema, step, metadata,
                          keep, lanes=None):
        # one retry: the atomic-replace protocol makes it idempotent.
        # `_write_arrays` is looked up per call, so a patched writer
        # (tools/fault_injection.failing_checkpoint_writes) sees both
        # attempts
        import time as _time

        from ibamr_tpu_torch import obs as _obs
        t0 = _time.perf_counter()
        try:
            try:
                return _write_arrays(directory, arrays, schema, step,
                                     metadata, keep, lanes=lanes)
            except Exception:
                return _write_arrays(directory, arrays, schema, step,
                                     metadata, keep, lanes=lanes)
        finally:
            _obs.histogram("ckpt_commit_seconds",
                           writer="single").observe(
                _time.perf_counter() - t0)

    def save(self, state: Any, step: int,
             metadata: Optional[Dict[str, Any]] = None):
        """Copy and enqueue one checkpoint write. Returns the write
        future, or ``None`` when the save was shed."""
        from ibamr_tpu_torch import obs as _obs
        self._raise_finished()
        if self.queue_depth() >= self.max_pending:
            if self.overflow == "drop":
                self.dropped_saves += 1
                _obs.counter("ckpt_dropped_saves_total",
                             writer="single").inc()
                return None
            import concurrent.futures as _cf
            oldest = next((f for f in self._pending if not f.done()),
                          None)
            if oldest is not None:
                _cf.wait([oldest])
            self._raise_finished()
        arrays = _gather_arrays(state)
        schema = state_schema(state)
        fut = self._exec.submit(self._write_with_retry, self.directory,
                                arrays, schema, step, metadata,
                                self.keep, self.lanes)
        self._pending.append(fut)
        _obs.gauge("ckpt_queue_depth",
                   writer="single").set(self.queue_depth())
        return fut

    def wait(self) -> None:
        """Block until every enqueued write is on disk (re-raises the
        first failure; failed futures are dropped)."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._exec.shutdown(wait=True)


def restore_checkpoint(directory: str, template: Any,
                       step: Optional[int] = None):
    """Restore a state pytree shaped like ``template``, whose leaves give
    each restored tensor its dtype and device. With ``step=None`` the
    newest verified checkpoint is restored, skipping corrupt ones with a
    warning; an explicit ``step`` raises :class:`CheckpointCorruptError`
    if it fails verification. A schema mismatch raises ``ValueError``.
    Returns ``(state, step, metadata)``."""
    if step is not None:
        fname = _npz(directory, step)
        if not os.path.exists(fname):
            raise FileNotFoundError(fname)
        if not verify_checkpoint(directory, step):
            raise CheckpointCorruptError(
                f"checkpoint {fname} failed integrity verification "
                f"(truncated/corrupt file or missing sidecar)")
        return _load_step(directory, step, template)

    steps = _all_steps(directory) if os.path.isdir(directory) else []
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    for s in reversed(steps):
        if not verify_checkpoint(directory, s):
            warnings.warn(f"skipping unverified checkpoint step {s} in "
                          f"{directory} (corrupt or sidecar-less)")
            continue
        try:
            return _load_step(directory, s, template)
        except CheckpointCorruptError as e:
            warnings.warn(f"skipping checkpoint step {s}: {e}")
    raise FileNotFoundError(
        f"no verified checkpoints in {directory} "
        f"({len(steps)} candidate(s), all corrupt)")


def _load_step(directory: str, step: int, template: Any):
    fname = _npz(directory, step)
    metadata: Dict[str, Any] = _read_sidecar(directory, step) or {}
    leaf_crcs = (metadata.get("integrity") or {}).get("leaves", {})
    stored_schema = metadata.get("schema")
    if stored_schema is not None:
        diff = _schema_diff(stored_schema, state_schema(template))
        if diff:
            raise ValueError(
                f"checkpoint {fname} was written with an incompatible "
                f"state schema (version "
                f"{stored_schema.get('version', '?')}):\n{diff}")

    with np.load(fname) as data:
        def load(path, leaf):
            key = _path_str(path)
            if key not in data:
                raise KeyError(f"checkpoint {fname} missing leaf {key!r}")
            arr = data[key]
            if key in leaf_crcs and _leaf_crc(arr) != leaf_crcs[key]:
                raise CheckpointCorruptError(
                    f"checkpoint {fname}: leaf {key!r} fails its recorded "
                    f"CRC32 - the array file and sidecar disagree")
            if isinstance(leaf, Blocks):
                # cut on the host: each block goes to its own device
                return Blocks.cut(leaf.mesh, torch.tensor(arr).to(
                    dtype=leaf.dtype), leaf.spec)
            if isinstance(leaf, torch.Tensor):
                return torch.tensor(arr).to(device=leaf.device,
                                            dtype=leaf.dtype)
            tgt = getattr(leaf, "dtype", None)
            return arr.astype(tgt) if tgt is not None else arr

        state = map_with_path(load, template)
    return state, step, metadata


def restore_lane(directory: str, template: Any, lane: int,
                 step: Optional[int] = None):
    """Restore ONE lane's slice from a fleet checkpoint into
    ``template`` (the current lane-stacked state). Every other lane's
    rows come back bitwise untouched. Verification is per lane (the
    sidecar's ``integrity.lanes``), so a step whose file is corrupt in
    another lane's rows still serves this one; sidecars without a lane
    record need whole-leaf CRCs. Walks newest to oldest (or only
    ``step``) and returns ``(patched_state, checkpoint_step)``, or
    ``None`` when no checkpoint vouches for this lane."""
    if not os.path.isdir(directory):
        return None
    steps = [step] if step is not None else \
        list(reversed(_all_steps(directory)))
    for s in steps:
        try:
            return _load_lane_step(directory, s, template, lane), s
        except (CheckpointCorruptError, KeyError, ValueError,
                OSError) as e:
            warnings.warn(
                f"restore_lane: skipping step {s} for lane {lane}: {e}")
    return None


def _load_lane_step(directory: str, step: int, template: Any, lane: int):
    fname = _npz(directory, step)
    if not os.path.exists(fname):
        raise FileNotFoundError(fname)
    meta = _read_sidecar(directory, step)
    if meta is None:
        raise CheckpointCorruptError(
            "sidecar missing or unparseable (torn write)")
    integ = meta.get("integrity") or {}
    lane_rec = integ.get("lanes")
    if lane_rec is not None and lane >= int(lane_rec.get("count", 0)):
        raise ValueError(
            f"lane {lane} out of range for fleet of "
            f"{lane_rec.get('count')}")
    lane_crcs = (lane_rec or {}).get("leaves", {})
    leaf_crcs = integ.get("leaves", {})

    with np.load(fname) as data:
        def load(path, leaf):
            key = _path_str(path)
            if key not in data:
                raise KeyError(f"checkpoint {fname} missing leaf {key!r}")
            arr = data[key]
            if arr.shape != tuple(np.shape(leaf)):
                raise ValueError(
                    f"checkpoint {fname}: leaf {key!r} shape {arr.shape} "
                    f"!= fleet state shape {tuple(np.shape(leaf))}")
            if arr.ndim < 1 or lane >= arr.shape[0]:
                raise ValueError(
                    f"checkpoint {fname}: leaf {key!r} has no lane {lane}")
            sl = arr[lane]
            if key in lane_crcs:
                rec = lane_crcs[key]
                if lane >= len(rec) or _leaf_crc(np.asarray(sl)) != \
                        int(rec[lane]):
                    raise CheckpointCorruptError(
                        f"checkpoint {fname}: lane {lane} of leaf {key!r} "
                        f"fails its recorded per-lane CRC32")
            elif key in leaf_crcs and _leaf_crc(arr) != leaf_crcs[key]:
                raise CheckpointCorruptError(
                    f"checkpoint {fname}: leaf {key!r} fails its recorded "
                    f"CRC32 and carries no per-lane record")
            out = leaf.clone()
            out[lane] = torch.as_tensor(np.ascontiguousarray(sl)).to(
                device=leaf.device, dtype=leaf.dtype)
            return out

        return map_with_path(load, template)
