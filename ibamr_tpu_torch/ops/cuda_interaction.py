"""The ``pallas_packed``, ``pallas`` and hybrid transfer engines on CUDA,
driven by hand-written kernels (port of
``ibamr_tpu/ops/pallas_interaction.py``: ``PallasPackedInteraction``,
``PallasInteraction`` with ``PallasSpread3D``, and
``HybridPackedInteraction``: the packed spread kernel with the ``packed``
engine's interp in torch ops, bf16 operands for ``hybrid_bf16``).

Kernels (sources in ``csrc/``, notes on design and bound there):

- ``packed_spread`` (``csrc/packed_spread.cu``) replaces
  ``_packed_spread_kernel_3d`` and the visited-tile mask and
  ``_overlap_add`` after it: the periodic grid component itself from the
  packed chunks.
- ``packed_interp`` (``csrc/packed_interp.cu``) replaces
  ``_packed_interp_kernel_3d`` and the ``_extract_tiles`` before it:
  per-slot interpolants ``(Q, c)`` read straight from the grid component,
  every slot.
- ``tile_spread`` (``csrc/tile_spread.cu``) replaces ``_spread_kernel_3d``
  and the ``_overlap_add`` after it: the periodic grid component itself
  from the unpacked per-tile layout (``Buckets``, B tiles of ``cap``
  slots, the first ``counts[t]`` of row t filled).
- ``tile_interp`` (``csrc/tile_interp.cu``) replaces ``_interp_kernel_3d``
  and the ``_extract_tiles`` before it: per-slot interpolants
  ``(B, cap)`` read straight from the grid component, exact zeros past
  each row's ``counts[t]``.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain PyTorch version beside it for CPU tensors; nothing falls back
from the GPU. The kernels evaluate every named isotropic delta of
``ops/delta.CUDA_DELTAS`` (IB_3, IB_4, IB_6, COSINE, PIECEWISE_LINEAR,
BSPLINE_2 to BSPLINE_6; ``csrc/delta.cuh``), one instantiation per
support, the delta passed by id; each wrapper and its plain version take
it as ``kernel`` (IB_4 by default). A composite B-spline raises
``ValueError`` and a user-defined ``(support, phi)`` pair
``NotImplementedError`` in every engine here. IB_6's table goes to the
kernels as a float64 device tensor that the engine holds. The kernels
have no derivative (nor has the reference's ``pallas_call``): every
engine here raises ``NotImplementedError`` when asked to transfer, with
grad mode on, a force, a field or positions that require grad
(:func:`check_no_autograd`), on every device, rather than hand autograd
a result that lacks the kernels' share of the gradient. ``LAUNCHES``
counts the kernel launches, and ``DELTA_LAUNCHES`` the same launches by
kernel and delta. The plain versions are the reference's dense weight
preamble with a batched contraction and, for the packed spread, an
``index_add_`` over ``tile_of_chunk``; the spread versions compose the
reference's program with the overlap-add and sum in float64 (each cell
rounded once, as the kernels' exact sums are), the interp versions
compose it with the extraction, and the tile versions are the packed
ones over the identity tile map.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import numpy as np
import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops.interaction import _centering_offsets
from ibamr_tpu_torch.ops.interaction_fast import (
    BucketGeometry, _extract_tiles, _overlap_add, bucket_markers,
    bucketed_channel, make_geometry, spread_overflow_fallbacks, tile_weights,
    unbucket_with_overflow)
from ibamr_tpu_torch.ops.delta import CUDA_DELTAS, _ib6_tensor, cuda_delta
from ibamr_tpu_torch.ops.interaction_packed import (PackedInteraction,
                                                    pack_markers,
                                                    refresh_packed)

# kernel launches since the last reset_launch_counts(), by kernel name
LAUNCHES: Dict[str, int] = {"packed_spread": 0, "packed_interp": 0,
                             "tile_spread": 0, "tile_interp": 0}
# the same launches by (kernel name, delta name)
DELTA_LAUNCHES: Dict[tuple, int] = {(k, d): 0 for k in LAUNCHES
                                    for d in CUDA_DELTAS}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in DELTA_LAUNCHES:
        DELTA_LAUNCHES[k] = 0


def _count(name: str, delta: str) -> None:
    LAUNCHES[name] += 1
    DELTA_LAUNCHES[(name, delta)] += 1


class _Geom(ctypes.Structure):
    """Mirrors ``TileGeom`` in ``csrc/delta.cuh``."""
    _fields_ = [(n, ctypes.c_int) for n in
                ("nb1", "t0", "t1", "W0", "W1", "n0", "n1", "nz",
                 "support", "delta", "cut")] + \
               [(n, ctypes.c_float) for n in
                ("lo0", "lo1", "lo2", "dx0", "dx1", "dx2",
                 "off0", "off1", "off2")] + \
               [("tab", ctypes.c_void_p)]


def delta_table(kernel, device) -> Optional[torch.Tensor]:
    """The device table a kernel reads for ``kernel``: IB_6's float64
    table on a CUDA ``device``, else None."""
    device = torch.device(device)
    if device.type != "cuda" or cuda_delta(kernel)[0] != "IB_6":
        return None
    return _ib6_tensor(device)


def _tile_geom(geom: BucketGeometry, grid: StaggeredGrid, offs, kernel,
               table: Optional[torch.Tensor]) -> _Geom:
    name, delta, support, cut = cuda_delta(kernel)
    if support != geom.support:
        raise ValueError(f"delta {name} has support {support}, the "
                         f"geometry {geom.support}")
    if (table is None) != (name != "IB_6"):
        raise ValueError(f"delta {name}: "
                         + ("needs its table" if table is None
                            else "reads no table"))
    return _Geom(geom.nblk[1], geom.tile[0], geom.tile[1], geom.width[0],
                 geom.width[1], grid.n[0], grid.n[1], grid.n[2], support,
                 delta, cut, *grid.x_lo, *grid.dx, *offs,
                 None if table is None else table.data_ptr())


# -- plain PyTorch versions ---------------------------------------------------

def _chunk_partials(geom: BucketGeometry, grid: StaggeredGrid, offs,
                    tid: torch.Tensor, Xb: torch.Tensor,
                    coef: torch.Tensor, kernel="IB_4") -> torch.Tensor:
    """Each chunk's partial grid over its tile's footprint -> (Q, P, nz),
    in float64: the factors wx*wy and wz*coef of every term are formed in
    the input type and the sums taken in float64, so that each cell is
    rounded once, by the caller, as the kernels' exact fixed-point sums
    round it."""
    wx, wy, wz = tile_weights(geom, grid, offs, tid, Xb, kernel)
    Q, c = coef.shape
    A = (wx[:, :, None, :] * wy[:, None, :, :]).reshape(Q, -1, c)
    return torch.bmm(A.double(),
                     (wz * coef[:, None, :]).double().transpose(1, 2))


def _packed_tiles(geom: BucketGeometry, grid: StaggeredGrid, offs,
                  tid: torch.Tensor, Xb: torch.Tensor,
                  coef: torch.Tensor, kernel="IB_4") -> torch.Tensor:
    """The chunks' partial grids summed per tile -> (B, P, nz) float64,
    zero for tiles no chunk visits."""
    Tq = _chunk_partials(geom, grid, offs, tid, Xb, coef, kernel)
    B = int(np.prod(geom.nblk))
    T = torch.zeros((B,) + Tq.shape[1:], dtype=Tq.dtype, device=Tq.device)
    return T.index_add_(0, tid.to(torch.int64), Tq)


def packed_spread_partials_plain(geom: BucketGeometry, grid: StaggeredGrid,
                                 offs, tid: torch.Tensor, Xb: torch.Tensor,
                                 coef: torch.Tensor,
                                 kernel="IB_4") -> torch.Tensor:
    """The reference's packed spread program with its visited-tile mask:
    per-tile partial grids (B, P, nz), zero for tiles no chunk visits."""
    return _packed_tiles(geom, grid, offs, tid, Xb, coef,
                         kernel).to(coef.dtype)


def packed_spread_plain(geom: BucketGeometry, grid: StaggeredGrid, offs,
                        tid: torch.Tensor, Xb: torch.Tensor,
                        coef: torch.Tensor, kernel="IB_4") -> torch.Tensor:
    """Plain version of the packed spread kernel: the chunks' partial
    grids folded onto the periodic grid -> ``grid.n``."""
    return _overlap_add(geom, grid, _packed_tiles(
        geom, grid, offs, tid, Xb, coef, kernel)).to(coef.dtype)


def packed_interp_partials_plain(geom: BucketGeometry, grid: StaggeredGrid,
                                 offs, tid: torch.Tensor, Xb: torch.Tensor,
                                 T: torch.Tensor,
                                 kernel="IB_4") -> torch.Tensor:
    """The reference's packed interp program: per-slot interpolants
    (Q, c) from the extracted tiles T (B, P, nz), every slot."""
    wx, wy, wz = tile_weights(geom, grid, offs, tid, Xb, kernel)
    Q, W0, c = wx.shape
    tmp = torch.bmm(T[tid.to(torch.int64)], wz)          # (Q, P, c)
    inner = torch.sum(wy[:, None, :, :] * tmp.reshape(Q, W0, -1, c), dim=2)
    return torch.sum(wx * inner, dim=1)


def packed_interp_plain(geom: BucketGeometry, grid: StaggeredGrid, offs,
                        tid: torch.Tensor, Xb: torch.Tensor,
                        f: torch.Tensor, kernel="IB_4") -> torch.Tensor:
    """Plain version of the packed interp kernel: the field's tiles
    interpolated at every chunk slot -> (Q, c)."""
    return packed_interp_partials_plain(geom, grid, offs, tid, Xb,
                                        _extract_tiles(geom, grid, f),
                                        kernel)


def _tile_ids(Xb: torch.Tensor) -> torch.Tensor:
    """The identity tile map of the per-tile layout: slot row t is tile t."""
    return torch.arange(Xb.shape[0], dtype=torch.int32, device=Xb.device)


def _filled(Xb: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """(B, cap) mask of the filled slot prefix of each row."""
    slots = torch.arange(Xb.shape[1], device=Xb.device)
    return slots[None, :] < counts.to(Xb.device)[:, None]


def tile_spread_partials_plain(geom: BucketGeometry, grid: StaggeredGrid,
                               offs, Xb: torch.Tensor, coef: torch.Tensor,
                               kernel="IB_4") -> torch.Tensor:
    """The reference's tile spread program: per-tile partial grids
    (B, P, nz) over every slot."""
    return _chunk_partials(geom, grid, offs, _tile_ids(Xb), Xb, coef,
                           kernel).to(coef.dtype)


def tile_interp_partials_plain(geom: BucketGeometry, grid: StaggeredGrid,
                               offs, Xb: torch.Tensor, T: torch.Tensor,
                               kernel="IB_4") -> torch.Tensor:
    """The reference's tile interp program: per-slot interpolants
    (B, cap) from the extracted tiles T (B, P, nz), every slot."""
    return packed_interp_partials_plain(geom, grid, offs, _tile_ids(Xb),
                                        Xb, T, kernel)


def tile_spread_plain(geom: BucketGeometry, grid: StaggeredGrid, offs,
                      Xb: torch.Tensor, coef: torch.Tensor,
                      counts: torch.Tensor, kernel="IB_4") -> torch.Tensor:
    """Plain version of the tile spread kernel: the filled slots' partial
    grids folded onto the periodic grid -> ``grid.n``."""
    coef = torch.where(_filled(Xb, counts), coef, torch.zeros_like(coef))
    return _overlap_add(geom, grid, _chunk_partials(
        geom, grid, offs, _tile_ids(Xb), Xb, coef, kernel)).to(coef.dtype)


def tile_interp_plain(geom: BucketGeometry, grid: StaggeredGrid, offs,
                      Xb: torch.Tensor, f: torch.Tensor,
                      counts: torch.Tensor, kernel="IB_4") -> torch.Tensor:
    """Plain version of the tile interp kernel: the field's tiles
    interpolated at the filled slots, 0 elsewhere -> (B, cap)."""
    U = tile_interp_partials_plain(geom, grid, offs, Xb,
                                   _extract_tiles(geom, grid, f), kernel)
    return torch.where(_filled(Xb, counts), U, torch.zeros_like(U))


# -- kernel wrappers ------------------------------------------------------------

def _check_cuda(name: str, dev: torch.device, **tensors) -> None:
    for arg, (t, dtype) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


# argument types of each launcher (C prototypes in csrc/*.cu):
# packed_spread / packed_interp (tid, Xb, coef or f, out, Q, c, geom,
# stream), and tile_spread / tile_interp (Xb, coef or f, counts, out, B,
# cap, geom, stream); each launches the instantiation for geom.support
_ARGTYPES = {"packed_spread": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [_Geom, ctypes.c_void_p],
             "packed_interp": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [_Geom, ctypes.c_void_p],
             "tile_spread": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [_Geom, ctypes.c_void_p],
             "tile_interp": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [_Geom, ctypes.c_void_p]}
_bound: Dict[str, tuple] = {}


def _launcher(name: str, support: int):
    """``(launch_fn, (max_rows, max_width, min_nz))`` of one kernel at a
    delta support, built and bound at first use: ``max_rows`` bounds the
    chunk (or tile row) size, or for ``packed_spread`` the slot count
    Q * c."""
    if (name, support) not in _bound:
        from ibamr_tpu_torch.ops import kernel_build

        lib = kernel_build.load_all()[name]
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        limits = getattr(lib, f"{name}_limits")
        limits.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
        limits.restype = ctypes.c_int
        lims = [ctypes.c_int() for _ in range(3)]
        if limits(support, *map(ctypes.byref, lims)) != 0:
            raise ValueError(f"{name}: no kernel for support {support}")
        _bound[(name, support)] = (fn, tuple(v.value for v in lims))
    return _bound[(name, support)]


def _check_shapes(name, geom, grid, Xb, tid=None):
    """Bind the kernel and check what its launch geometry supports. The
    packed kernels take a chunk-to-tile map ``tid``; the tile kernels take
    one slot row per tile."""
    if grid.dim != 3:
        raise ValueError(f"{name}: 3D only")
    if Xb.dim() != 3 or Xb.shape[2] != 3:
        raise ValueError(f"{name}: Xb must be (rows, slots, 3), got "
                         f"{tuple(Xb.shape)}")
    Q, c = Xb.shape[0], Xb.shape[1]
    if tid is None and Q != math.prod(geom.nblk):
        raise ValueError(f"{name}: need one slot row per tile "
                         f"({math.prod(geom.nblk)}), got {Q}")
    if tid is not None and tid.shape != (Q,):
        raise ValueError(f"{name}: need tid (Q,) for Xb (Q, c, 3); got "
                         f"{tuple(tid.shape)}, {tuple(Xb.shape)}")
    fn, (max_rows, max_width, min_nz) = _launcher(name, geom.support)
    what, size = (("slots", Q * c) if name == "packed_spread"
                  else ("chunk", c))
    if size > max_rows or max(geom.width) > max_width or grid.n[2] < min_nz:
        raise ValueError(f"{name}: needs {what} <= {max_rows}, widths <= "
                         f"{max_width}, nz >= {min_nz}; got {what} {size}, "
                         f"widths {geom.width}, nz {grid.n[2]}")
    return fn


def _kernel_geom(geom: BucketGeometry, grid: StaggeredGrid, offs, kernel,
                 table: Optional[torch.Tensor], dev: torch.device) -> _Geom:
    """The launch geometry of ``kernel`` with its table on ``dev``."""
    if table is None:
        table = delta_table(kernel, dev)
    elif table.device != dev or table.dtype != torch.float64:
        raise ValueError(f"the delta table must be float64 on {dev}")
    return _tile_geom(geom, grid, offs, kernel, table)


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def packed_spread(geom: BucketGeometry, grid: StaggeredGrid, offs,
                  tid: torch.Tensor, Xb: torch.Tensor, coef: torch.Tensor,
                  kernel="IB_4",
                  table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The grid component (``grid.n``) spread from every slot of the
    packed layout with the delta ``kernel``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. ``table`` is
    :func:`delta_table`'s (looked up when None)."""
    if Xb.device.type == "cpu":
        return packed_spread_plain(geom, grid, offs, tid, Xb, coef, kernel)
    if Xb.device.type != "cuda":
        raise ValueError(f"packed_spread: unsupported device {Xb.device}")
    fn = _check_shapes("packed_spread", geom, grid, Xb, tid)
    Q, c = coef.shape
    _check_cuda("packed_spread", Xb.device, tid=(tid, torch.int32),
                Xb=(Xb, torch.float32), coef=(coef, torch.float32))
    if coef.shape != Xb.shape[:2]:
        raise ValueError("packed_spread: coef must be (Q, c)")
    g = _kernel_geom(geom, grid, offs, kernel, table, Xb.device)
    out = torch.empty(grid.n, dtype=torch.float32, device=Xb.device)
    err = fn(tid.data_ptr(), Xb.data_ptr(), coef.data_ptr(), out.data_ptr(),
             Q, c, g, torch.cuda.current_stream(Xb.device).cuda_stream)
    _raise_on("packed_spread", err)
    _count("packed_spread", cuda_delta(kernel)[0])
    return out


def packed_interp(geom: BucketGeometry, grid: StaggeredGrid, offs,
                  tid: torch.Tensor, Xb: torch.Tensor, f: torch.Tensor,
                  kernel="IB_4",
                  table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-slot interpolants (Q, c) of the field ``f`` (``grid.n``) at
    every chunk slot of the packed layout with the delta ``kernel``: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if Xb.device.type == "cpu":
        return packed_interp_plain(geom, grid, offs, tid, Xb, f, kernel)
    if Xb.device.type != "cuda":
        raise ValueError(f"packed_interp: unsupported device {Xb.device}")
    fn = _check_shapes("packed_interp", geom, grid, Xb, tid)
    Q, c = Xb.shape[0], Xb.shape[1]
    _check_cuda("packed_interp", Xb.device, tid=(tid, torch.int32),
                Xb=(Xb, torch.float32), f=(f, torch.float32))
    if f.shape != grid.n:
        raise ValueError(f"packed_interp: f must be {grid.n}, got "
                         f"{tuple(f.shape)}")
    g = _kernel_geom(geom, grid, offs, kernel, table, Xb.device)
    out = torch.empty((Q, c), dtype=torch.float32, device=Xb.device)
    err = fn(tid.data_ptr(), Xb.data_ptr(), f.data_ptr(), out.data_ptr(),
             Q, c, g, torch.cuda.current_stream(Xb.device).cuda_stream)
    _raise_on("packed_interp", err)
    _count("packed_interp", cuda_delta(kernel)[0])
    return out


def _check_tile_args(name: str, geom: BucketGeometry, grid: StaggeredGrid,
                     Xb: torch.Tensor, counts: torch.Tensor, **tensors):
    """Bind a tile kernel and check its arguments: one slot row per tile,
    f32 operands and int32 per-tile counts on Xb's device."""
    fn = _check_shapes(name, geom, grid, Xb)
    _check_cuda(name, Xb.device, Xb=(Xb, torch.float32),
                counts=(counts, torch.int32),
                **{k: (t, torch.float32) for k, t in tensors.items()})
    if counts.shape != Xb.shape[:1]:
        raise ValueError(f"{name}: counts must be (B,), got "
                         f"{tuple(counts.shape)}")
    return fn


def tile_spread(geom: BucketGeometry, grid: StaggeredGrid, offs,
                Xb: torch.Tensor, coef: torch.Tensor, counts: torch.Tensor,
                kernel="IB_4",
                table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The grid component (``grid.n``) spread from the filled slots of
    the per-tile layout with the delta ``kernel``: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if Xb.device.type == "cpu":
        return tile_spread_plain(geom, grid, offs, Xb, coef, counts, kernel)
    if Xb.device.type != "cuda":
        raise ValueError(f"tile_spread: unsupported device {Xb.device}")
    fn = _check_tile_args("tile_spread", geom, grid, Xb, counts, coef=coef)
    if coef.shape != Xb.shape[:2]:
        raise ValueError("tile_spread: coef must be (B, cap)")
    B, cap = coef.shape
    g = _kernel_geom(geom, grid, offs, kernel, table, Xb.device)
    out = torch.empty(grid.n, dtype=torch.float32, device=Xb.device)
    err = fn(Xb.data_ptr(), coef.data_ptr(), counts.data_ptr(),
             out.data_ptr(), B, cap, g,
             torch.cuda.current_stream(Xb.device).cuda_stream)
    _raise_on("tile_spread", err)
    _count("tile_spread", cuda_delta(kernel)[0])
    return out


def tile_interp(geom: BucketGeometry, grid: StaggeredGrid, offs,
                Xb: torch.Tensor, f: torch.Tensor, counts: torch.Tensor,
                kernel="IB_4",
                table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-slot interpolants (B, cap) of the field ``f`` (``grid.n``) at
    the filled slots of the per-tile layout with the delta ``kernel``,
    exact zeros elsewhere: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if Xb.device.type == "cpu":
        return tile_interp_plain(geom, grid, offs, Xb, f, counts, kernel)
    if Xb.device.type != "cuda":
        raise ValueError(f"tile_interp: unsupported device {Xb.device}")
    fn = _check_tile_args("tile_interp", geom, grid, Xb, counts, f=f)
    if f.shape != grid.n:
        raise ValueError(f"tile_interp: f must be {grid.n}, got "
                         f"{tuple(f.shape)}")
    B, cap = Xb.shape[0], Xb.shape[1]
    g = _kernel_geom(geom, grid, offs, kernel, table, Xb.device)
    out = torch.empty((B, cap), dtype=torch.float32, device=Xb.device)
    err = fn(Xb.data_ptr(), f.data_ptr(), counts.data_ptr(), out.data_ptr(),
             B, cap, g, torch.cuda.current_stream(Xb.device).cuda_stream)
    _raise_on("tile_interp", err)
    _count("tile_interp", cuda_delta(kernel)[0])
    return out


# -- the engines ------------------------------------------------------------------

def refuse_autograd(engine: str) -> None:
    """Raise for reverse mode through an engine whose transfers launch
    hand CUDA kernels."""
    raise NotImplementedError(
        f"the {engine!r} transfer engine launches hand CUDA kernels, which "
        "have no derivative (the reference's pallas_call refuses "
        "autodiff likewise): differentiate through 'scatter', 'packed' / "
        "'packed_bf16', 'mxu' / 'mxu_bf16' or 'packed3' / 'packed3_bf16'")


def check_no_autograd(engine: str, *tensors) -> None:
    """:func:`refuse_autograd` when grad mode is on and any of
    ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        refuse_autograd(engine)


class _KernelEngine:
    """Spread and interp of a MAC velocity through one pair of kernels:
    per component one spread launch (its grid, then the overflow
    scatter) and one interp launch per transfer (then the unbucketing
    and the overflow gather). Each engine's hooks turn a component into
    its grid and a field into per-slot interpolants, with the engine's
    delta and its device table. They refuse autograd
    (:func:`check_no_autograd`)."""

    engine = ""
    table: Optional[torch.Tensor] = None

    def _spread_grid(self, offs, b, Xb, coef):
        raise NotImplementedError

    def _interp_slots(self, offs, b, Xb, f):
        raise NotImplementedError

    def spread(self, F: torch.Tensor, X: torch.Tensor, centering,
               b) -> torch.Tensor:
        check_no_autograd(self.engine, F, X, b.Xb)
        grid = self.grid
        inv_vol = 1.0 / math.prod(grid.dx)
        offs = _centering_offsets(grid, centering)
        coef = bucketed_channel(b, F) * b.wb * inv_vol
        out = self._spread_grid(offs, b, b.Xb.to(coef.dtype), coef)
        return spread_overflow_fallbacks(out.to(F.dtype), b, F, X, grid,
                                         centering, self.kernel)

    def spread_vel(self, F: torch.Tensor, X: torch.Tensor,
                   weights: Optional[torch.Tensor] = None, b=None) -> tuple:
        if b is None:
            b = self.buckets(X, weights=weights)
        return tuple(self.spread(F[:, d], X, d, b)
                     for d in range(self.grid.dim))

    def interpolate(self, f: torch.Tensor, X: torch.Tensor, centering,
                    b) -> torch.Tensor:
        check_no_autograd(self.engine, f, X, b.Xb)
        grid = self.grid
        offs = _centering_offsets(grid, centering)
        Ub = self._interp_slots(offs, b, b.Xb.to(f.dtype), f) * b.wb
        return unbucket_with_overflow(Ub, b, f, X, grid, centering,
                                      self.kernel)

    def interpolate_vel(self, u, X: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        b=None) -> torch.Tensor:
        if b is None:
            b = self.buckets(X, weights=weights)
        return torch.stack([self.interpolate(u[d], X, d, b)
                            for d in range(self.grid.dim)], dim=-1)


class PackedKernelInteraction(_KernelEngine):
    """Occupancy-packed chunks (``ops/interaction_packed.py`` layout) with
    the spread and interp of each velocity component done by the packed
    kernels: 3 spread and 3 interp launches per transfer of a MAC
    velocity. Both write or read the grid themselves, with no overlap-add
    or tile extraction. Overflow markers go through the exact scatter
    fallback."""

    engine = "pallas_packed"

    def __init__(self, grid: StaggeredGrid, kernel="IB_4", tile: int = 8,
                 chunk: int = 128, nchunks: int = 1024,
                 overflow_cap: Optional[int] = None, device="cuda"):
        if grid.dim != 3:
            raise ValueError("PackedKernelInteraction is 3D-only")
        cuda_delta(kernel)   # raises for a delta the kernels do not take
        dev = resolve_device(device)   # raises for a GPU request without one
        self.grid = grid
        self.kernel = kernel
        self.table = delta_table(kernel, dev)
        self.geom = make_geometry(grid, kernel, tile=tile, cap=chunk)
        self.nchunks = int(nchunks)
        self.overflow_cap = overflow_cap

    def buckets(self, X: torch.Tensor,
                weights: Optional[torch.Tensor] = None):
        return pack_markers(self.geom, self.grid, X, weights=weights,
                            nchunks=self.nchunks,
                            overflow_cap=self.overflow_cap)

    def refresh(self, b, X: torch.Tensor,
                weights: Optional[torch.Tensor] = None):
        """Slot-preserving half-step refresh; returns ``(buckets, hit)``."""
        return refresh_packed(self.geom, self.grid, b, X, weights)

    def _spread_grid(self, offs, b, Xb, coef):
        return packed_spread(self.geom, self.grid, offs, b.tile_of_chunk, Xb,
                             coef, self.kernel, self.table)

    def _interp_slots(self, offs, b, Xb, f):
        return packed_interp(self.geom, self.grid, offs, b.tile_of_chunk,
                             Xb, f.contiguous(), self.kernel, self.table)


class TileKernelInteraction(_KernelEngine):
    """The per-tile layout (``interaction_fast.bucket_markers``: B tiles of
    ``cap`` slots) with the spread and interp of each velocity component
    done by the tile kernels, which write and read the grid themselves:
    3 spread and 3 interp launches per transfer of a MAC velocity, and no
    overlap-add or tile extraction. Markers beyond a tile's ``cap`` go
    through the exact scatter fallback. Like the reference engine it has
    no ``refresh``: the midpoint step buckets the half-step positions
    anew."""

    engine = "pallas"

    def __init__(self, grid: StaggeredGrid, kernel="IB_4", tile: int = 8,
                 cap: int = 256, overflow_cap: Optional[int] = None,
                 device="cuda"):
        if grid.dim != 3:
            raise ValueError("TileKernelInteraction is 3D-only")
        cuda_delta(kernel)   # raises for a delta the kernels do not take
        dev = resolve_device(device)   # raises for a GPU request without one
        self.grid = grid
        self.kernel = kernel
        self.table = delta_table(kernel, dev)
        self.geom = make_geometry(grid, kernel, tile=tile, cap=cap)
        self.overflow_cap = overflow_cap

    def buckets(self, X: torch.Tensor,
                weights: Optional[torch.Tensor] = None):
        return bucket_markers(self.geom, self.grid, X, weights=weights,
                              overflow_cap=self.overflow_cap)

    def _spread_grid(self, offs, b, Xb, coef):
        return tile_spread(self.geom, self.grid, offs, Xb, coef, b.counts,
                           self.kernel, self.table)

    def _interp_slots(self, offs, b, Xb, f):
        return tile_interp(self.geom, self.grid, offs, Xb, f.contiguous(),
                           b.counts, self.kernel, self.table)


class HybridKernelInteraction:
    """The ``hybrid_bf16`` (alias ``hybrid_packed_bf16``) and
    ``hybrid_packed`` engines: the ``packed_spread`` kernel for the spread
    and the ``packed`` engine's interp in torch ops, over one shared
    ``PackedBuckets`` context that the ``packed`` twin packs and refreshes.
    ``compute_dtype=torch.bfloat16`` rounds the interp contraction's
    operands to bf16 (f32 sum); the spread stays f32. 3 spread launches
    per transfer of a MAC velocity, no interp kernel; overflow markers go
    through the exact scatter fallback in both directions."""

    def __init__(self, grid: StaggeredGrid, kernel="IB_4", tile: int = 8,
                 chunk: int = 128, nchunks: int = 1024,
                 overflow_cap: Optional[int] = None, compute_dtype=None,
                 device="cuda"):
        self._spread = PackedKernelInteraction(
            grid, kernel=kernel, tile=tile, chunk=chunk, nchunks=nchunks,
            overflow_cap=overflow_cap, device=device)
        self._packed = PackedInteraction(
            grid, kernel=kernel, tile=tile, chunk=chunk, nchunks=nchunks,
            overflow_cap=overflow_cap, compute_dtype=compute_dtype,
            device=device)
        self.grid = grid
        self.kernel = kernel
        self.geom = self._packed.geom
        self.nchunks = int(nchunks)
        self.overflow_cap = overflow_cap
        self.compute_dtype = compute_dtype
        self.engine = ("hybrid_bf16" if compute_dtype == torch.bfloat16
                       else "hybrid_packed")

    def buckets(self, X: torch.Tensor,
                weights: Optional[torch.Tensor] = None):
        return self._packed.buckets(X, weights)

    def refresh(self, b, X: torch.Tensor,
                weights: Optional[torch.Tensor] = None):
        """One slot-preserving refresh of the shared context serves both
        directions; returns ``(buckets, hit)``."""
        return self._packed.refresh(b, X, weights)

    def spread_vel(self, F: torch.Tensor, X: torch.Tensor,
                   weights: Optional[torch.Tensor] = None, b=None) -> tuple:
        check_no_autograd(self.engine, F, X)
        if b is None:
            b = self.buckets(X, weights)
        return self._spread.spread_vel(F, X, weights=weights, b=b)

    def interpolate_vel(self, u, X: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        b=None) -> torch.Tensor:
        check_no_autograd(self.engine, *u, X)
        if b is None:
            b = self.buckets(X, weights)
        return self._packed.interpolate_vel(u, X, weights=weights, b=b)
