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
deletes the last verified checkpoint. Not ported: the asynchronous
writer, lane (fleet) checkpoints and sharded checkpoints.
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
    if isinstance(leaf, torch.Tensor):
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
    if isinstance(leaf, torch.Tensor):
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


def save_checkpoint(directory: str, state: Any, step: int,
                    metadata: Optional[Dict[str, Any]] = None,
                    keep: int = 3) -> str:
    """Serialize a state pytree. Returns the checkpoint file path."""
    arrays = {_path_str(p): _host(leaf)
              for p, leaf in flatten_with_path(state)}
    os.makedirs(directory, exist_ok=True)
    fname = _npz(directory, step)
    npz_crc, npz_size = _atomic_write_digest(
        fname, lambda f: np.savez(f, **arrays))
    meta = dict(metadata or {})
    meta["step"] = step
    meta["schema"] = state_schema(state)
    # the sidecar lands after the arrays: a complete sidecar implies a
    # complete array file (the commit marker)
    meta["integrity"] = {
        "leaves": {k: _leaf_crc(v) for k, v in arrays.items()},
        "npz_crc32": npz_crc,
        "npz_size": npz_size,
    }
    payload = json.dumps(meta).encode()
    _atomic_write_digest(fname.replace(".npz", ".json"),
                         lambda f: f.write(payload))
    _prune(directory, keep)
    return fname


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
            if isinstance(leaf, torch.Tensor):
                return torch.tensor(arr).to(device=leaf.device,
                                            dtype=leaf.dtype)
            tgt = getattr(leaf, "dtype", None)
            return arr.astype(tgt) if tgt is not None else arr

        state = map_with_path(load, template)
    return state, step, metadata
