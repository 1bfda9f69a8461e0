"""Sharded fault-tolerant checkpoints: per-shard files + a manifest commit
marker, elastic N->M restore (port of
``ibamr_tpu/utils/checkpoint_sharded.py``).

The layout, keys, CRCs and manifest fields are the reference's, so a
sharded checkpoint written by either package restores into the other::

    <dir>/sharded.<step:08d>/shard-0000.npz   # shard 0's slices
    <dir>/sharded.<step:08d>/shard-0001.npz
    ...
    <dir>/sharded.<step:08d>/manifest.json    # commit marker, LAST

- :func:`save_sharded_checkpoint` writes one file per shard of the
  state's mesh, each holding only the slices that shard owns (the first
  shard holding each distinct index range, from the layout a leaf
  carries: a block-resident leaf (``parallel.spmd.Blocks``) writes each
  shard straight from its block; a pinned tensor
  (``parallel.spmd.sharding_of``) by slices; a leaf with no layout
  belongs to shard 0), then the manifest atomically LAST: the mesh spec, every
  leaf's chunks (shard, index range, CRC32), the state schema and every
  shard file's CRC32 and size. A kill at any instant leaves no manifest
  or a manifest whose digests expose a missing, torn or stale shard.
- :func:`verify_sharded_checkpoint` / :func:`latest_sharded_step` skip
  torn, missing-shard and CRC-mismatched steps.
- :func:`restore_sharded` reassembles a checkpoint written on N shards
  and lays it out as the template dictates (M shards, one device, or
  host arrays; a Blocks template leaf has each of its blocks filled
  from the chunks that overlap it): chunk assembly is memcpy, so every
  restore is bitwise.
- :class:`AsyncShardedWriter` copies each shard's slices to the host at
  ``save`` (the copy is what the run may not overwrite; still never the
  global tensor) and writes the shard files concurrently on worker
  threads behind a bounded queue.

Every slice reaches the host through :func:`_fetch_shard`, so a test can
check that a save never copies the global tensor.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ibamr_tpu_torch.parallel.spmd import Blocks, pin, sharding_of
from ibamr_tpu_torch.utils.checkpoint import (CheckpointCorruptError,
                                              _atomic_write_digest,
                                              _file_crc, _fsync_dir,
                                              _leaf_crc, _path_str,
                                              _schema_diff, state_schema)
from ibamr_tpu_torch.utils.tree import flatten_with_path, map_with_path

SHARDED_SCHEMA = 1

# widens the window between the last shard write and the manifest, so a
# kill drill lands inside the uncommitted window
_COMMIT_DELAY_ENV = "IBAMR_SHARDED_COMMIT_DELAY_S"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"sharded.{step:08d}")


def _shard_name(i: int) -> str:
    return f"shard-{i:04d}.npz"


def _fetch_shard(data) -> np.ndarray:
    """Host copy of ONE shard's slice."""
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def _full_index(shape):
    return [[0, int(s)] for s in shape]


def _layout(leaf):
    """The layout a leaf carries: its Blocks' own, a pin, or None."""
    return leaf.sharding if isinstance(leaf, Blocks) else sharding_of(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, (torch.Tensor, Blocks)):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _plan_shards(state):
    """``(n_shards, leaves_meta, per_shard)`` for a state pytree: every
    distinct index range of a leaf is owned by exactly one shard (the
    first that holds it), so replicated leaves and axes are stored
    once."""
    flat = flatten_with_path(state)
    n_shards = 1
    for _, leaf in flat:
        sh = _layout(leaf)
        if sh is not None:
            n_shards = max(n_shards, sh.mesh.size)

    leaves_meta: Dict[str, Any] = {}
    per_shard: Dict[int, Dict[str, np.ndarray]] = {}

    def own(i: int, key: str, arr: np.ndarray, index):
        per_shard.setdefault(i, {})[key] = arr
        leaves_meta[key]["chunks"].append(
            {"shard": i, "index": index, "crc32": _leaf_crc(arr)})

    for path, leaf in flat:
        key = _path_str(path)
        shape = [int(s) for s in np.shape(leaf)]
        leaves_meta[key] = {"shape": shape, "dtype": _dtype_name(leaf),
                            "chunks": []}
        sh = _layout(leaf)
        if sh is None or not isinstance(leaf, (torch.Tensor, Blocks)):
            own(0, key, _fetch_shard(leaf), _full_index(shape))
            continue
        seen = set()
        for i in range(sh.mesh.size):
            index = sh.index(i, shape)
            ikey = json.dumps(index)
            if ikey in seen:
                continue              # a replica of a chunk already owned
            seen.add(ikey)
            if isinstance(leaf, Blocks):
                own(i, key, _fetch_shard(leaf.blocks[i]), index)
                continue
            sl = tuple(slice(lo, hi) for lo, hi in index)
            own(i, key, _fetch_shard(leaf[sl]), index)
    return n_shards, leaves_meta, per_shard


def _mesh_spec(mesh=None, n_shards: int = 1) -> dict:
    if mesh is not None:
        return {"shape": [int(s) for s in mesh.devices.shape],
                "axis_names": [str(a) for a in mesh.axis_names],
                "n_shards": int(np.prod(mesh.devices.shape))}
    return {"shape": [int(n_shards)], "axis_names": None,
            "n_shards": int(n_shards)}


def _write_manifest(directory: str, step: int, n_shards: int,
                    leaves_meta: dict, shards_meta: dict, schema: dict,
                    metadata: Optional[dict], mesh) -> None:
    delay = float(os.environ.get(_COMMIT_DELAY_ENV, "0") or 0)
    if delay > 0:
        time.sleep(delay)
    manifest = {
        "sharded_schema": SHARDED_SCHEMA,
        "step": int(step),
        "mesh": _mesh_spec(mesh, n_shards),
        "schema": schema,
        "leaves": leaves_meta,
        "shards": shards_meta,
        "metadata": dict(metadata or {}),
        "time": time.time(),
    }
    payload = json.dumps(manifest).encode()
    _atomic_write_digest(os.path.join(_step_dir(directory, step),
                                      "manifest.json"),
                         lambda f: f.write(payload))
    _fsync_dir(directory)


def _write_one(directory: str, step: int, i: int, arrays: dict):
    sdir = _step_dir(directory, step)
    os.makedirs(sdir, exist_ok=True)
    # the digest comes from the temp file, before the replace: reading
    # the published path back would record a concurrent writer's bytes
    crc, size = _atomic_write_digest(os.path.join(sdir, _shard_name(i)),
                                     lambda f: np.savez(f, **arrays))
    return _shard_name(i), {"crc32": crc, "size": size}


def save_sharded_checkpoint(directory: str, state: Any, step: int,
                            metadata: Optional[Dict[str, Any]] = None,
                            keep: int = 3, mesh=None) -> str:
    """Write one checkpoint of ``state`` in the sharded layout; each
    shard file holds only the slices its shard owns, and the manifest,
    written atomically LAST, is the commit marker. Returns the step
    directory."""
    n_shards, leaves_meta, per_shard = _plan_shards(state)
    os.makedirs(_step_dir(directory, step), exist_ok=True)
    shards_meta = dict(_write_one(directory, step, i, per_shard.get(i, {}))
                       for i in range(n_shards))
    _write_manifest(directory, step, n_shards, leaves_meta, shards_meta,
                    state_schema(state), metadata, mesh)
    _prune_sharded(directory, keep)
    return _step_dir(directory, step)


def read_manifest(directory: str, step: int) -> Optional[dict]:
    """A step's manifest; None when absent or torn (invalid JSON), which
    is what an uncommitted or killed-mid-commit step looks like."""
    path = os.path.join(_step_dir(directory, step), "manifest.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def verify_sharded_checkpoint(directory: str, step: int) -> bool:
    """True iff the step committed and every shard file exists with the
    recorded byte size and whole-file CRC32."""
    manifest = read_manifest(directory, step)
    if manifest is None or manifest.get("step") != step:
        return False
    sdir = _step_dir(directory, step)
    shards = manifest.get("shards")
    if not isinstance(shards, dict):
        return False
    for name, rec in shards.items():
        path = os.path.join(sdir, name)
        try:
            if os.path.getsize(path) != rec.get("size"):
                return False
            if _file_crc(path) != rec.get("crc32"):
                return False
        except OSError:
            return False
    return True


def _all_sharded_steps(directory: str) -> list:
    steps = []
    if not os.path.isdir(directory):
        return steps
    for f in os.listdir(directory):
        m = re.fullmatch(r"sharded\.(\d+)", f)
        if m and os.path.isdir(os.path.join(directory, f)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_sharded_step(directory: str,
                        verified_only: bool = True) -> Optional[int]:
    """Newest restorable sharded step (torn, corrupt and uncommitted
    steps skipped unless ``verified_only=False``)."""
    steps = _all_sharded_steps(directory)
    if not verified_only:
        return steps[-1] if steps else None
    return next((s for s in reversed(steps)
                 if verify_sharded_checkpoint(directory, s)), None)


def _prune_sharded(directory: str, keep: int) -> None:
    if keep <= 0:
        return
    steps = _all_sharded_steps(directory)
    doomed = steps[:-keep]
    if not doomed:
        return
    # the newest VERIFIED step is never pruned
    last_verified = next((s for s in reversed(steps)
                          if verify_sharded_checkpoint(directory, s)), None)
    for s in doomed:
        if s != last_verified:
            shutil.rmtree(_step_dir(directory, s), ignore_errors=True)


def _load_chunks(sdir: str, key: str, meta: dict, shard_files: dict):
    """``[(index, host array), ...]`` of one leaf's manifest chunks,
    CRC-checking every loaded slice."""
    chunks = meta["chunks"]
    if not chunks:
        raise CheckpointCorruptError(
            f"sharded checkpoint {sdir}: leaf {key!r} has no chunks "
            f"in the manifest")
    out = []
    for ch in chunks:
        name = _shard_name(int(ch["shard"]))
        if name not in shard_files:
            shard_files[name] = np.load(os.path.join(sdir, name))
        z = shard_files[name]
        if key not in z:
            raise CheckpointCorruptError(
                f"sharded checkpoint {sdir}: shard {name} is missing "
                f"leaf {key!r} recorded in the manifest")
        arr = z[key]
        if _leaf_crc(arr) != ch["crc32"]:
            raise CheckpointCorruptError(
                f"sharded checkpoint {sdir}: leaf {key!r} chunk in "
                f"{name} fails its recorded CRC32 - shard file and "
                f"manifest disagree")
        out.append(([list(map(int, ij)) for ij in ch["index"]], arr))
    return out


def _fill(sdir: str, key: str, index, chunks) -> np.ndarray:
    """The host array of the index range ``index`` (``[[lo, hi], ...]``)
    copied from the chunks that overlap it."""
    dtype = chunks[0][1].dtype
    out = np.empty([hi - lo for lo, hi in index], dtype=dtype)
    filled = 0
    for cidx, arr in chunks:
        box = [(max(a0, b0), min(a1, b1))
               for (a0, a1), (b0, b1) in zip(index, cidx)]
        if any(lo >= hi for lo, hi in box):
            continue
        dst = tuple(slice(lo - a0, hi - a0)
                    for (lo, hi), (a0, _) in zip(box, index))
        src = tuple(slice(lo - b0, hi - b0)
                    for (lo, hi), (b0, _) in zip(box, cidx))
        out[dst] = arr[src]
        filled += int(np.prod([hi - lo for lo, hi in box]))
    if filled != out.size:
        raise CheckpointCorruptError(
            f"sharded checkpoint {sdir}: leaf {key!r} chunks do not "
            f"cover the array")
    return out


def _assemble_leaf(sdir: str, key: str, meta: dict, shard_files: dict):
    """One global host array from its manifest chunks."""
    shape = [int(s) for s in meta["shape"]]
    chunks = _load_chunks(sdir, key, meta, shard_files)
    for index, arr in chunks:
        if index == _full_index(shape):
            return arr                 # whole-array chunk (replicated)
    return _fill(sdir, key, _full_index(shape), chunks)


def _restore_blocks(sdir: str, key: str, meta: dict, shard_files: dict,
                    leaf: Blocks) -> Blocks:
    """A Blocks leaf restored block by block: each shard's index range
    filled from the chunks that overlap it, straight to its device."""
    chunks = _load_chunks(sdir, key, meta, shard_files)
    if [int(s) for s in meta["shape"]] != list(leaf.shape):
        raise CheckpointCorruptError(
            f"sharded checkpoint {sdir}: leaf {key!r} has shape "
            f"{meta['shape']}, the template {list(leaf.shape)}")
    return leaf.like([
        torch.as_tensor(_fill(sdir, key, leaf.sharding.index(i, leaf.shape),
                              chunks)).to(device=leaf.mesh.device(i),
                                          dtype=leaf.dtype)
        for i in range(leaf.mesh.size)])


def restore_sharded(directory: str, template: Any,
                    step: Optional[int] = None, sharding_fn=None):
    """Restore a state pytree from the sharded layout, elastically.

    ``template`` gives structure, dtype and the TARGET placement: a
    tensor leaf restores onto its device with its layout
    (``sharding_of``: an M-shard mesh, or none); a numpy leaf restores
    to a host array. ``sharding_fn(path_str, np_array)`` overrides the
    placement per leaf. ``step=None`` restores the newest VERIFIED step,
    warning and falling back through older ones on corruption; an
    explicit ``step`` raises :class:`CheckpointCorruptError` when it
    fails verification. Returns ``(state, step, manifest)``."""
    if step is not None:
        if not os.path.isdir(_step_dir(directory, step)):
            raise FileNotFoundError(_step_dir(directory, step))
        if not verify_sharded_checkpoint(directory, step):
            raise CheckpointCorruptError(
                f"sharded checkpoint {_step_dir(directory, step)} "
                f"failed integrity verification (torn manifest, "
                f"missing shard, or digest mismatch)")
        return _load_sharded_step(directory, step, template, sharding_fn)

    steps = _all_sharded_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no sharded checkpoints in {directory}")
    for s in reversed(steps):
        if not verify_sharded_checkpoint(directory, s):
            warnings.warn(
                f"skipping unverified sharded checkpoint step {s} in "
                f"{directory} (torn manifest, missing shard, or digest "
                f"mismatch - a kill mid-commit leaves exactly this)")
            continue
        try:
            return _load_sharded_step(directory, s, template, sharding_fn)
        except CheckpointCorruptError as e:
            warnings.warn(f"skipping sharded checkpoint step {s}: {e}")
    raise FileNotFoundError(
        f"no verified sharded checkpoints in {directory} "
        f"({len(steps)} candidate(s), all torn or corrupt)")


def _load_sharded_step(directory: str, step: int, template: Any,
                       sharding_fn):
    sdir = _step_dir(directory, step)
    manifest = read_manifest(directory, step)
    leaves_meta = manifest["leaves"]
    stored_schema = manifest.get("schema")
    if stored_schema is not None:
        diff = _schema_diff(stored_schema, state_schema(template))
        if diff:
            raise ValueError(
                f"sharded checkpoint {sdir} was written with an "
                f"incompatible state schema (version "
                f"{stored_schema.get('version', '?')}):\n{diff}")

    shard_files: Dict[str, Any] = {}

    def load(path, leaf):
        key = _path_str(path)
        if key not in leaves_meta:
            raise KeyError(f"sharded checkpoint {sdir} missing leaf {key!r}")
        if isinstance(leaf, Blocks) and sharding_fn is None:
            return _restore_blocks(sdir, key, leaves_meta[key], shard_files,
                                   leaf)
        arr = _assemble_leaf(sdir, key, leaves_meta[key], shard_files)
        if sharding_fn is not None:
            return sharding_fn(key, arr)
        if isinstance(leaf, torch.Tensor):
            t = torch.as_tensor(np.array(arr)).to(
                device=leaf.device, dtype=leaf.dtype)
            return pin(t, sharding_of(leaf))
        tgt = getattr(leaf, "dtype", None)
        return arr.astype(tgt) if tgt is not None else arr

    try:
        state = map_with_path(load, template)
    finally:
        for z in shard_files.values():
            z.close()
    return state, step, manifest


class AsyncShardedWriter:
    """Sharded checkpoint writes off the critical path.

    ``save`` copies each shard's slices to the host at once (never the
    global tensor), then hands the step to the single committer thread,
    which writes the shard files concurrently over ``shard_workers``
    threads and the manifest strictly after them; steps commit in save
    order. At most ``max_pending`` steps are in flight:
    ``overflow="block"`` makes ``save`` wait for the oldest,
    ``overflow="drop"`` sheds the new save (``dropped_saves``)."""

    def __init__(self, directory: str, keep: int = 3,
                 max_pending: int = 2, overflow: str = "block",
                 shard_workers: int = 4, mesh=None):
        from concurrent.futures import ThreadPoolExecutor

        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if overflow not in ("block", "drop"):
            raise ValueError("overflow must be 'block' or 'drop'")
        self.directory = directory
        self.keep = keep
        self.max_pending = max_pending
        self.overflow = overflow
        self.mesh = mesh
        self.dropped_saves = 0
        self._commit = ThreadPoolExecutor(max_workers=1)
        self._shard_pool = ThreadPoolExecutor(
            max_workers=max(1, shard_workers))
        self._pending: List = []
        self._lock = threading.Lock()

    def queue_depth(self) -> int:
        """Steps enqueued but not yet committed."""
        with self._lock:
            return sum(1 for f in self._pending if not f.done())

    def _raise_finished(self):
        with self._lock:
            done = [f for f in self._pending if f.done()]
            self._pending = [f for f in self._pending if not f.done()]
        for f in done:
            f.result()

    def _write_step_once(self, step, n_shards, leaves_meta, per_shard,
                         schema, metadata):
        os.makedirs(_step_dir(self.directory, step), exist_ok=True)
        shards_meta = dict(self._shard_pool.map(
            lambda i: _write_one(self.directory, step, i,
                                 per_shard.get(i, {})), range(n_shards)))
        _write_manifest(self.directory, step, n_shards, leaves_meta,
                        shards_meta, schema, metadata, self.mesh)
        _prune_sharded(self.directory, self.keep)
        return _step_dir(self.directory, step)

    def _write_step(self, *args):
        from ibamr_tpu_torch import obs as _obs

        t0 = time.perf_counter()
        try:
            try:
                return self._write_step_once(*args)
            except Exception:
                # one retry: the atomic-replace protocol makes it
                # idempotent
                return self._write_step_once(*args)
        finally:
            _obs.histogram("ckpt_commit_seconds", writer="sharded").observe(
                time.perf_counter() - t0)

    def save(self, state: Any, step: int,
             metadata: Optional[Dict[str, Any]] = None):
        """Copy the shards' slices to the host and enqueue the write.
        Returns the committer future, or ``None`` when the save was shed
        under ``overflow="drop"``."""
        from ibamr_tpu_torch import obs as _obs

        self._raise_finished()
        if self.queue_depth() >= self.max_pending:
            if self.overflow == "drop":
                self.dropped_saves += 1
                _obs.counter("ckpt_dropped_saves_total",
                             writer="sharded").inc()
                return None
            import concurrent.futures as _cf
            with self._lock:
                oldest = next((f for f in self._pending if not f.done()),
                              None)
            if oldest is not None:
                _cf.wait([oldest])
            self._raise_finished()
        n_shards, leaves_meta, per_shard = _plan_shards(state)
        fut = self._commit.submit(self._write_step, step, n_shards,
                                  leaves_meta, per_shard,
                                  state_schema(state), metadata)
        with self._lock:
            self._pending.append(fut)
        _obs.gauge("ckpt_queue_depth", writer="sharded").set(
            self.queue_depth())
        return fut

    def wait(self) -> None:
        """Block until every enqueued step is committed (re-raises the
        first worker failure)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._commit.shutdown(wait=True)
            self._shard_pool.shutdown(wait=True)
