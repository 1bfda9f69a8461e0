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

# listeners of the collective census (``analysis.graph_census``): each
# collective calls every listener with its name and one shard's output
# block
COLLECTIVE_LISTENERS: List[Callable] = []


def _report(prim: str, out: List[torch.Tensor]) -> List[torch.Tensor]:
    for listener in COLLECTIVE_LISTENERS:
        listener(prim, out[0])
    return out


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
    return _report("ppermute", out)


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
    return _report("all_to_all", out)


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
    return _report("psum", out)


# ---------------------------------------------------------------------------
# block-resident grid leaves and the halo pass
# ---------------------------------------------------------------------------

# listeners of the whole-grid layouts (``analysis.graph_census``): every
# cut of a whole tensor into :class:`Blocks` and every assembly of one
# calls each listener with ``"cut"`` or ``"assemble"`` and the whole tensor
GRID_LISTENERS: List[Callable] = []


def _report_grid(kind: str, whole: torch.Tensor) -> None:
    for listener in GRID_LISTENERS:
        listener(kind, whole)


# torch functions and Tensor methods that act cell by cell: on every
# shard's block with the same scalar operands they give the blocks of the
# op on the whole tensor
_ELEMENTWISE = frozenset((
    "add", "sub", "mul", "div", "true_divide", "rsub", "neg", "negative",
    "abs", "square", "sqrt", "exp", "sign", "pow", "where", "maximum",
    "minimum", "clamp", "clone", "detach", "contiguous", "float", "double",
    "zeros_like", "ones_like", "empty_like", "full_like", "isfinite",
    "isnan", "eq", "ne", "lt", "le", "gt", "ge", "logical_and",
    "logical_or", "logical_not",
    "__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
    "__truediv__", "__rtruediv__", "__rdiv__", "__neg__", "__pow__",
    "__rpow__", "__abs__", "__and__", "__or__", "__invert__", "__lt__",
    "__le__", "__gt__", "__ge__"))
# whole reductions: per block, then combined in coordinate order
_REDUCE = {"sum": torch.add, "max": torch.maximum, "amax": torch.maximum,
           "min": torch.minimum, "amin": torch.minimum,
           "all": torch.logical_and, "any": torch.logical_or}


class Blocks:
    """A grid leaf held as per-shard blocks: ``blocks[i]`` is shard i's
    index range of the global tensor of ``shape`` laid out by
    ``sharding``, on shard i's device. The layout is the container's, so
    no step re-pins it; :mod:`ibamr_tpu_torch.utils.tree` sees a
    ``Blocks`` as one leaf, which the checkpoints write shard by shard.

    Cell-by-cell torch ops (``+``, ``*``, ``torch.where``,
    ``torch.isfinite``, ``zeros_like``, ...) run on every block, with
    0-dim tensors and numbers as the other operands; ``sum`` / ``max`` /
    ``min`` / ``all`` / ``any`` of the whole leaf reduce each block, then
    combine the partial results on the mesh's first device in coordinate
    order (bitwise run to run; another order than a whole-tensor
    reduction, so equal to it only to roundoff). A stencil goes through
    :func:`halo_apply`. Any other op raises ``TypeError``: nothing falls
    back to a whole-grid tensor. :meth:`cut` and :meth:`assemble` are the
    host-facing edges (placement, checkpoints, viz), and report to
    ``GRID_LISTENERS``."""

    __slots__ = ("blocks", "sharding", "shape")

    def __init__(self, blocks: Sequence[torch.Tensor],
                 sharding: NamedSharding, shape: Sequence[int]):
        self.blocks = list(blocks)
        self.sharding = sharding
        self.shape = torch.Size(shape)
        if len(self.blocks) != sharding.mesh.size:
            raise ValueError(f"{len(self.blocks)} blocks for a "
                             f"{sharding.mesh.size}-shard mesh")

    @classmethod
    def cut(cls, mesh: Mesh, x: torch.Tensor,
            spec: PartitionSpec) -> "Blocks":
        """The blocks of the whole tensor ``x`` laid out by ``spec``."""
        _report_grid("cut", x)
        return cls(shard(mesh, x, spec), NamedSharding(mesh, spec), x.shape)

    def assemble(self, device=None) -> torch.Tensor:
        """The whole tensor, on ``device`` (default: the mesh's first)."""
        out = unshard(self.mesh, self.blocks, self.spec, device)
        _report_grid("assemble", out)
        return out

    def like(self, blocks: Sequence[torch.Tensor]) -> "Blocks":
        """New blocks under this leaf's layout."""
        return Blocks(blocks, self.sharding, self.shape)

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        """The first shard's device (where reductions land)."""
        return self.blocks[0].device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self) -> int:
        return len(self.shape)

    def is_floating_point(self) -> bool:
        return self.blocks[0].is_floating_point()

    def cpu(self) -> torch.Tensor:
        return self.assemble("cpu")

    def numpy(self) -> np.ndarray:
        return self.assemble("cpu").numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def __bool__(self):
        raise TypeError("the truth value of a Blocks leaf is ambiguous")

    def __repr__(self):
        return (f"Blocks({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding!r})")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        if name == "equal":
            return _blocks_equal(*args)
        if name in _REDUCE and len(args) == 1 and not kwargs:
            return _blocks_reduce(name, args[0])
        if name in _ELEMENTWISE:
            return _blocks_map(func, args, kwargs)
        raise TypeError(
            f"{name} is not a per-block op: a Blocks leaf takes cell-by-"
            f"cell ops and whole reductions, and its stencils through "
            f"spmd.halo_apply")


def _tensor_method(name: str):
    fn = getattr(torch.Tensor, name)

    def method(self, *args, **kwargs):
        return Blocks.__torch_function__(fn, (Blocks,), (self,) + args,
                                         kwargs)

    method.__name__ = name
    return method


for _name in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
              "__rmul__", "__truediv__", "__rtruediv__", "__neg__",
              "__pow__", "__rpow__", "__abs__", "__and__", "__or__",
              "__invert__", "__lt__", "__le__", "__gt__", "__ge__",
              "abs", "square", "sqrt", "clone", "detach", "contiguous",
              "float", "double", "isfinite", "sum", "max", "min",
              "amax", "amin", "all", "any"):
    setattr(Blocks, _name, _tensor_method(_name))


def _same_layout(leaves: Sequence[Blocks]) -> Blocks:
    ref = leaves[0]
    for b in leaves[1:]:
        if (b.mesh is not ref.mesh or tuple(b.spec) != tuple(ref.spec)
                or b.shape != ref.shape):
            raise ValueError(f"Blocks of different layouts: {b!r} and "
                             f"{ref!r}")
    return ref


def _on_device(v, device):
    """A non-Blocks operand of a per-block op: numbers pass; a tensor
    must be 0-dim (a whole-grid operand would be another layout)."""
    if isinstance(v, torch.Tensor):
        if v.dim() != 0:
            raise TypeError(
                f"a per-block op takes 0-dim tensors beside Blocks, got "
                f"shape {tuple(v.shape)}")
        return v.to(device)
    return v


def _blocks_map(func, args, kwargs) -> Blocks:
    found = [a for a in list(args) + list(kwargs.values())
             if isinstance(a, Blocks)]
    ref = _same_layout(found)

    def body(ctx, *own):
        it = iter(own)
        a = [next(it) if isinstance(x, Blocks) else _on_device(x, ctx.device)
             for x in args]
        kw = {k: next(it) if isinstance(v, Blocks)
              else _on_device(v, ctx.device) for k, v in kwargs.items()}
        return func(*a, **kw)

    outs = smap(body, ref.mesh, *[b.blocks for b in found])
    for o, b in zip(outs, ref.blocks):
        if not (isinstance(o, torch.Tensor) and o.shape == b.shape):
            raise TypeError(f"{getattr(func, '__name__', func)} did not "
                            f"act cell by cell on the blocks")
    return ref.like(outs)


def _distinct_shards(x: Blocks) -> List[int]:
    """The shards holding distinct index ranges, in coordinate order."""
    seen, out = set(), []
    for i in range(x.mesh.size):
        key = tuple(map(tuple, x.sharding.index(i, x.shape)))
        if key not in seen:
            seen.add(key)
            out.append(i)
    return out


def _blocks_reduce(name: str, x: Blocks) -> torch.Tensor:
    parts = smap(lambda ctx, b: getattr(torch, name)(b), x.mesh, x.blocks)
    dev = x.mesh.first_device
    keep = _distinct_shards(x)
    acc = parts[keep[0]].to(dev)
    for i in keep[1:]:
        acc = _REDUCE[name](acc, parts[i].to(dev))
    return acc


def _blocks_equal(a, b) -> bool:
    if not (isinstance(a, Blocks) and isinstance(b, Blocks)):
        raise TypeError("torch.equal compares two Blocks leaves; assemble "
                        "one to compare it with a tensor")
    return (a.shape == b.shape and tuple(a.spec) == tuple(b.spec)
            and a.mesh.size == b.mesh.size
            and all(torch.equal(x, y.to(x.device))
                    for x, y in zip(a.blocks, b.blocks)))


def split_dims(sharding: NamedSharding, ndim: int):
    """``[(dim, mesh axis), ...]`` of the tensor dimensions the layout
    splits, in order."""
    return [(d, sharding.spec[d]) for d in range(min(ndim,
                                                     len(sharding.spec)))
            if sharding.spec[d] is not None]


def ghost_fill(mesh: Mesh, blocks: Sequence[torch.Tensor], axis: AxisName,
               dim: int, width: int) -> List[torch.Tensor]:
    """Every shard's block extended by ``width`` ghost layers on both
    sides of tensor dimension ``dim``, from its ring neighbours along the
    mesh ``axis`` (periodic). Raises when ``width`` exceeds the block's
    extent there (the ghosts would need a farther neighbour)."""
    n = blocks[0].shape[dim]
    if width > n:
        raise ValueError(
            f"ghost width {width} exceeds the block's extent {n} along "
            f"dimension {dim}: use fewer shards or a bigger grid")
    p = mesh.axis_size(axis)
    top = smap(lambda ctx, f: f.narrow(dim, n - width, width), mesh, blocks)
    bot = smap(lambda ctx, f: f.narrow(dim, 0, width), mesh, blocks)
    lo = ppermute(mesh, top, axis, [(i, (i + 1) % p) for i in range(p)])
    hi = ppermute(mesh, bot, axis, [(i, (i - 1) % p) for i in range(p)])
    return smap(lambda ctx, g0, f, g1: torch.cat([g0, f, g1], dim=dim),
                mesh, lo, blocks, hi)


def halo_add(mesh: Mesh, bufs: Sequence[torch.Tensor], axis: AxisName,
             dim: int, width: int) -> List[torch.Tensor]:
    """The adjoint of :func:`ghost_fill`: every shard's ``width`` ghost
    layers on both sides of ``dim`` pushed to its ring neighbours along
    ``axis`` and accumulated into their interiors (lo ghosts into the
    previous block's tail, hi ghosts into the next block's head);
    returns the interiors."""
    p = mesh.axis_size(axis)
    nl = bufs[0].shape[dim] - 2 * width
    lo = smap(lambda ctx, b: b.narrow(dim, 0, width), mesh, bufs)
    hi = smap(lambda ctx, b: b.narrow(dim, nl + width, width), mesh, bufs)
    from_next = ppermute(mesh, lo, axis, [(i, (i - 1) % p) for i in range(p)])
    from_prev = ppermute(mesh, hi, axis, [(i, (i + 1) % p) for i in range(p)])

    def retire(ctx, b, fn, fp):
        interior = b.narrow(dim, width, nl).clone()
        interior.narrow(dim, nl - width, width).add_(fn)
        interior.narrow(dim, 0, width).add_(fp)
        return interior

    return smap(retire, mesh, bufs, from_next, from_prev)


def halo_apply(mesh: Mesh, blocks, fn: Callable, width: int):
    """A roll-form stencil of radius ``width`` on block-resident leaves.

    ``blocks`` is one :class:`Blocks` or a sequence of them (one layout);
    ``fn(*tensors)`` is the stencil on whole tensors, returning a tensor
    or a tuple of tensors of the input's shape. The leaves go through one
    stacked ghost fill per split axis, the first split axis first (the
    later fills move slabs of the already padded block, so the corners
    are filled too); then ``fn`` runs on every shard's padded block and
    the ghosts are cropped. A roll on a block padded by the stencil's
    radius gives every interior cell the operands the roll on the whole
    tensor gives it, in the same order, so the result is bitwise the
    whole-tensor stencil's; only ghost cells wrap wrongly, and they go.
    Returns Blocks (or a tuple of them) under the inputs' layout."""
    ins = (blocks,) if isinstance(blocks, Blocks) else tuple(blocks)
    ref = _same_layout(ins)
    if ref.mesh is not mesh:
        raise ValueError("halo_apply: the blocks are on another mesh")
    dims = split_dims(ref.sharding, ref.ndim)
    padded = smap(lambda ctx, *bs: torch.stack(bs), mesh,
                  *[b.blocks for b in ins])
    for d, axis in dims:
        padded = ghost_fill(mesh, padded, axis, d + 1, width)
    extent = {d: ref.blocks[0].shape[d] for d, _ in dims}
    single = []

    def body(ctx, pad):
        out = fn(*pad.unbind(0))
        single.append(not isinstance(out, tuple))
        outs = (out,) if single[-1] else out
        cropped = []
        for o in outs:
            for d, _ in dims:
                o = o.narrow(d, width, extent[d])
            cropped.append(o)
        return cropped

    res = smap(body, mesh, padded)
    out = tuple(ref.like([r[k] for r in res]) for k in range(len(res[0])))
    return out[0] if single[0] else out


def halo_stencil(fn: Callable, width: int) -> Callable:
    """``fn(x, *args)``, a roll-form stencil of radius ``width`` whose
    ``x`` is a tensor or a tuple of tensors (``ops/stencils.py``'s
    signature), as the same stencil on Blocks through :func:`halo_apply`
    (the mesh is the leaves' own). A non-Blocks ``x`` raises."""
    def apply(x, *args, **kwargs):
        one = isinstance(x, Blocks)
        first = x if one else x[0]
        if not isinstance(first, Blocks):
            raise TypeError(
                f"{getattr(fn, '__name__', fn)} on the block-resident "
                f"path takes Blocks, got {type(first).__name__}")
        if one:
            def body(b):
                return fn(b, *args, **kwargs)
        else:
            def body(*bs):
                return fn(bs, *args, **kwargs)
        return halo_apply(first.mesh, x, body, width)

    apply.__name__ = f"halo_{getattr(fn, '__name__', 'stencil')}"
    return apply
