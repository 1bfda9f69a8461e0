"""The port's device mesh: shards of one process over a list of torch
devices, per-shard bodies and explicit collectives.

The reference is single-controller: one process builds a
``jax.sharding.Mesh`` over its devices, ``shard_map`` runs a body on
every device's block, and ``lax.ppermute`` / ``lax.all_to_all`` /
``lax.psum`` move blocks between them. The port keeps that shape inside
one process:

- a :class:`Mesh` is a row-major grid of shards with axis names, one
  torch device per shard (``make_mesh`` cycles the shards over the
  GPUs; on one H100 every shard sits on ``cuda:0``; the tests put them
  on the CPU);
- :func:`shard` cuts a global tensor into per-shard blocks by a
  :class:`PartitionSpec` (each block a copy on its shard's device) and
  :func:`unshard` assembles them;
- :func:`smap` calls a per-shard body with ``(ctx, *blocks)`` -- that
  shard's blocks only, and ``ctx.axis_index`` for its coordinates;
- the collectives are mesh-level calls on the list of blocks:
  :func:`ppermute`, :func:`all_to_all` (``lax.all_to_all``'s
  ``split_axis`` / ``concat_axis`` / ``tiled=True`` block order),
  :func:`psum`. Every block they return is a fresh copy on its shard's
  device, moved with ``.to(device)``; sums run in coordinate order, so
  a result is bitwise the same run to run.

A body that reads another shard's block or the global tensor is a bug.
Under :func:`audit_blocks` every torch call a body makes is checked, and
an argument whose storage belongs to the global tensor of a
:func:`shard` call or to another shard's block raises
:class:`BlockLeakError` (the tests run the engines under it).

:class:`NamedSharding` records which shard owns which index range of a
tensor; :func:`pin` attaches it to a tensor (``sharding_of`` reads it).
That record is the layout the sharded checkpoints write and restore.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

AxisName = Union[str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per tensor dimension: ``None`` (not split), a mesh axis name, or
    a tuple of axis names (split over their flattened coordinate)."""

    def __new__(cls, *parts):
        return tuple.__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


class Mesh:
    """A row-major grid of shards. ``devices`` is a numpy object array of
    torch devices shaped like the mesh (``devices.shape``,
    ``devices.size``, ``devices.flat`` as for ``jax.sharding.Mesh``);
    ``shape`` maps each axis name to its size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devs = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(devs.shape):
            devs[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        if devs.ndim != len(axis_names):
            raise ValueError(
                f"mesh of shape {devs.shape} needs {devs.ndim} axis names, "
                f"got {tuple(axis_names)}")
        self.devices = devs
        self.axis_names = tuple(str(a) for a in axis_names)
        self.shape = dict(zip(self.axis_names,
                              (int(s) for s in devs.shape)))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first_device(self) -> torch.device:
        return self.devices.flat[0]

    def device(self, i: int) -> torch.device:
        return self.devices.flat[i]

    def coords(self, i: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(i, self.devices.shape))

    def flat_index(self, coords: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.devices.shape))

    def _axes(self, axis: AxisName) -> Tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh has no axis {a!r}: {self.axis_names}")
        return axes

    def axis_size(self, axis: AxisName) -> int:
        return math.prod(self.shape[a] for a in self._axes(axis))

    def axis_index(self, axis: AxisName, i: int) -> int:
        """Shard ``i``'s coordinate along ``axis`` (axes of a tuple
        flattened in the order given, the first the slowest)."""
        c = self.coords(i)
        idx = 0
        for a in self._axes(axis):
            k = self.axis_names.index(a)
            idx = idx * self.shape[a] + c[k]
        return idx

    def group(self, axis: AxisName, i: int) -> List[int]:
        """The shards that differ from shard ``i`` only along ``axis``,
        in order of their coordinate there."""
        axes = self._axes(axis)
        base = list(self.coords(i))
        ks = [self.axis_names.index(a) for a in axes]
        sizes = [self.shape[a] for a in axes]
        out = []
        for sub in np.ndindex(*sizes):
            c = list(base)
            for k, s in zip(ks, sub):
                c[k] = s
            out.append(self.flat_index(c))
        return out

    def spec(self) -> dict:
        """The mesh as the sharded manifests record it."""
        return {"shape": [int(s) for s in self.devices.shape],
                "axis_names": list(self.axis_names),
                "n_shards": self.size}

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, devices="
                f"{sorted({str(d) for d in self.devices.flat})})")


def mesh_devices(n: int, device="cuda") -> List[torch.device]:
    """``n`` shard devices: on ``cuda`` the shards cycle over the GPUs
    (all on ``cuda:0`` with one card); ``cpu`` puts every shard on the
    CPU. A CUDA request without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * n
    if dev.type != "cuda":
        raise ValueError(f"unsupported mesh device {device!r}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "for a mesh of CPU shards")
    if dev.index is not None:
        return [dev] * n
    return [torch.device("cuda", k % count) for k in range(n)]


class NamedSharding:
    """``(mesh, spec)``: which shard owns which index range of a tensor
    laid out by ``spec`` (replicated dimensions: every shard along the
    unnamed axes holds the same range; the checkpoint keeps the first)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def index(self, i: int, shape: Sequence[int]) -> List[List[int]]:
        """Shard ``i``'s ``[[lo, hi], ...]`` of a tensor of ``shape``."""
        out = []
        for d, n in enumerate(shape):
            part = self.spec[d] if d < len(self.spec) else None
            if part is None:
                out.append([0, int(n)])
                continue
            cnt = self.mesh.axis_size(part)
            if n % cnt:
                raise ValueError(
                    f"dimension {d} ({n}) does not divide over mesh axes "
                    f"{part!r} ({cnt})")
            k = self.mesh.axis_index(part, i)
            b = n // cnt
            out.append([k * b, (k + 1) * b])
        return out

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def pin(t, sharding: Optional[NamedSharding]):
    """``t`` as a new tensor object (a view, no copy) on the mesh's first
    device carrying ``sharding``; other leaves pass through."""
    if sharding is None or not isinstance(t, torch.Tensor):
        return t
    dev = sharding.mesh.first_device
    out = t.to(dev) if t.device != dev else t.view_as(t)
    out._ibamr_sharding = sharding
    return out


def sharding_of(t) -> Optional[NamedSharding]:
    return getattr(t, "_ibamr_sharding", None)


# ---------------------------------------------------------------------------
# blocks, bodies and collectives
# ---------------------------------------------------------------------------

class BlockLeakError(RuntimeError):
    """A per-shard body touched a tensor that is not its own block."""


_AUDIT: Optional[dict] = None


@contextlib.contextmanager
def audit_blocks():
    """Check every per-shard body run inside: a body whose torch calls
    take the global tensor of a :func:`shard` call or another shard's
    block raises :class:`BlockLeakError`. Yields the audit record
    (``bodies``: body calls checked, ``calls``: torch calls checked)."""
    global _AUDIT
    prev = _AUDIT
    # the global tensors stay referenced for the audit's duration, so
    # their storage is never reused by a body's own results
    _AUDIT = {"globals": set(), "held": [], "bodies": 0, "calls": 0}
    try:
        yield _AUDIT
    finally:
        _AUDIT = prev


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


class _BodyGuard(TorchFunctionMode):
    def __init__(self, foreign: set, record: dict, shard: int):
        super().__init__()
        self.foreign = foreign
        self.record = record
        self.shard = shard

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.record["calls"] += 1
        for t in _tensors((args, kwargs)):
            if t.numel() and _storage(t) in self.foreign:
                raise BlockLeakError(
                    f"shard {self.shard}'s body passed a tensor of shape "
                    f"{tuple(t.shape)} that is not its own block to "
                    f"{getattr(func, '__name__', func)}")
        return func(*args, **kwargs)


class ShardCtx:
    """What a per-shard body knows besides its blocks."""

    def __init__(self, mesh: Mesh, i: int):
        self.mesh = mesh
        self.index = i
        self.device = mesh.device(i)

    def axis_index(self, axis: AxisName) -> int:
        return self.mesh.axis_index(axis, self.index)


def shard(mesh: Mesh, x: torch.Tensor, spec: PartitionSpec
          ) -> List[torch.Tensor]:
    """Per-shard blocks of the global tensor ``x`` laid out by ``spec``,
    each a copy on its shard's device."""
    if _AUDIT is not None and x.numel():
        _AUDIT["globals"].add(_storage(x))
        _AUDIT["held"].append(x)
    sh = NamedSharding(mesh, spec)
    out = []
    for i in range(mesh.size):
        idx = tuple(slice(lo, hi) for lo, hi in sh.index(i, x.shape))
        out.append(x[idx].to(mesh.device(i), copy=True))
    return out


def unshard(mesh: Mesh, blocks: Sequence[torch.Tensor], spec: PartitionSpec,
            device=None) -> torch.Tensor:
    """The global tensor from per-shard blocks laid out by ``spec`` (a
    range held by several shards is taken from the first), on
    ``device`` (default: the mesh's first device)."""
    sh = NamedSharding(mesh, spec)
    dev = mesh.first_device if device is None else torch.device(device)
    b0 = blocks[0]
    shape = []
    for d in range(b0.dim()):
        part = spec[d] if d < len(spec) else None
        shape.append(b0.shape[d] * (mesh.axis_size(part)
                                    if part is not None else 1))
    out = torch.empty(shape, dtype=b0.dtype, device=dev)
    seen = set()
    for i in range(mesh.size):
        index = sh.index(i, shape)
        key = tuple(map(tuple, index))
        if key in seen:
            continue
        seen.add(key)
        out[tuple(slice(lo, hi) for lo, hi in index)] = blocks[i].to(dev)
    return out


def smap(body: Callable, mesh: Mesh, *block_lists, **consts):
    """``[body(ctx_i, *blocks_i, **consts) for each shard i]``: the body
    sees shard i's blocks only. Under :func:`audit_blocks` each call is
    checked against every other shard's blocks and the global tensors."""
    n = mesh.size
    for bl in block_lists:
        if len(bl) != n:
            raise ValueError(f"{len(bl)} blocks for a {n}-shard mesh")
    out = []
    for i in range(n):
        own = [bl[i] for bl in block_lists]
        ctx = ShardCtx(mesh, i)
        if _AUDIT is None:
            out.append(body(ctx, *own, **consts))
            continue
        mine = {_storage(t) for t in _tensors(own) if t.numel()}
        foreign = set(_AUDIT["globals"])
        for bl in block_lists:
            for j, b in enumerate(bl):
                if j != i:
                    foreign |= {_storage(t) for t in _tensors(b)
                                if t.numel()}
        foreign -= mine
        _AUDIT["bodies"] += 1
        with _BodyGuard(foreign, _AUDIT, i):
            out.append(body(ctx, *own, **consts))
    return out


def ppermute(mesh: Mesh, blocks: Sequence[torch.Tensor], axis: AxisName,
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``lax.ppermute``: along ``axis``, the block of the shard at
    coordinate ``src`` goes to the shard at ``dst`` for every
    ``(src, dst)`` of ``perm``; a shard that receives nothing gets
    zeros."""
    src_of = {int(d): int(s) for s, d in perm}
    out = []
    for i in range(mesh.size):
        me = mesh.axis_index(axis, i)
        dev = mesh.device(i)
        if me not in src_of:
            out.append(torch.zeros_like(blocks[i]))
            continue
        j = mesh.group(axis, i)[src_of[me]]
        out.append(blocks[j].to(dev, copy=True))
    return out


def all_to_all(mesh: Mesh, blocks: Sequence[torch.Tensor], axis: AxisName,
               split_axis: int, concat_axis: int) -> List[torch.Tensor]:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    each block splits into ``P`` equal chunks along ``split_axis``;
    chunk ``k`` goes to the shard at coordinate ``k`` along ``axis``,
    which concatenates what it receives along ``concat_axis`` in order
    of the sender's coordinate."""
    out = []
    for i in range(mesh.size):
        grp = mesh.group(axis, i)
        p = len(grp)
        me = mesh.axis_index(axis, i)
        dev = mesh.device(i)
        pieces = []
        for j in grp:
            b = blocks[j]
            if b.shape[split_axis] % p:
                raise ValueError(
                    f"all_to_all: axis {split_axis} ({b.shape[split_axis]})"
                    f" does not split into {p}")
            w = b.shape[split_axis] // p
            pieces.append(b.narrow(split_axis, me * w, w).to(dev))
        out.append(torch.cat(pieces, dim=concat_axis))
    return out


def psum(mesh: Mesh, blocks: Sequence[torch.Tensor], axis: AxisName
         ) -> List[torch.Tensor]:
    """``lax.psum`` over ``axis``: every member of a group gets the sum
    of the group's blocks, added in coordinate order."""
    out = []
    for i in range(mesh.size):
        dev = mesh.device(i)
        grp = mesh.group(axis, i)
        acc = blocks[grp[0]].to(dev, copy=True)
        for j in grp[1:]:
            acc = acc + blocks[j].to(dev)
        out.append(acc)
    return out
