"""Fully blocked occupancy-packed chunks and the ``packed3`` /
``packed3_bf16`` transfer engines on them, 2D and 3D (port of
``ibamr_tpu/ops/interaction_packed3.py``).

Every axis is tiled (x, y by ``tile``, the last axis by ``tile_last``):
chunk q holds up to ``c`` markers of ONE tile ``tile_of_chunk[q]``, packed
in tile order by the same core as the xy-packed layout
(:func:`~ibamr_tpu_torch.ops.interaction_packed.chunk_pack_core`), so the
two layouts cannot diverge. A chunk's contraction covers its tile's
footprint on the last axis too (``tile_last + support + 1`` cells, not the
whole axis), and the per-tile partials fold onto the grid by **spill
folding** (:func:`_fold_spills_to_grid`): because the spill (``support +
1`` cells) never exceeds the tile, each block's spill lands inside its
successor's core, so the periodic accumulation is a roll by one block and
an add per axis on the small tile tensor, then one reshape to the grid and
one roll; no masked grid-size pass. Markers beyond the chunk capacity take
the exact scatter fallback of :mod:`.interaction_fast`.

The partial tiles keep the footprint's axes in grid order, ``(B, P,
W_last)``: the reference puts ``P`` last for the TPU's lanes, which the
card has no use for. The reference's ``_extract_tiles3`` is
:func:`~ibamr_tpu_torch.ops.interaction_fast._extract_tiles` on this
geometry.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops.delta import get_kernel
from ibamr_tpu_torch.ops.interaction import scatter_add
from ibamr_tpu_torch.ops.interaction_fast import (
    _extract_tiles, _host_array, _interp_rows, _pad_axis, _spread_rows,
    _tile_origins, spread_overflow_fallbacks, unbucket_with_overflow)
from ibamr_tpu_torch.ops.interaction_packed import (chunk_pack_core,
                                                    default_overflow_cap)


class BucketGeometry3(NamedTuple):
    """Static fully blocked configuration: every axis carries a (tile,
    nblk, width) triple, ``width_d = tile_d + support + 1`` (the footprint
    starts one cell below the tile origin)."""
    tile: Tuple[int, ...]
    nblk: Tuple[int, ...]
    cap: int                  # marker slots per chunk
    support: int
    width: Tuple[int, ...]


def make_geometry3(grid: StaggeredGrid, kernel="IB_4", tile: int = 8,
                   tile_last: int = 16, cap: int = 64) -> BucketGeometry3:
    support, _ = get_kernel(kernel)
    tiles = tuple([tile] * (grid.dim - 1) + [tile_last])
    for d, (n, t) in enumerate(zip(grid.n, tiles)):
        if t < support + 1:
            raise ValueError(
                f"tile {t} (axis {d}) must be >= support+1 = "
                f"{support + 1} (spill must fit one tile)")
        if n % t != 0:
            raise ValueError(
                f"grid extent {n} not divisible by tile {t} (axis {d})")
        if n < t + support + 1:
            raise ValueError(
                f"grid extent {n} too small for tile {t} + support "
                f"{support} + 1 (axis {d})")
    return BucketGeometry3(
        tile=tiles,
        nblk=tuple(n // t for n, t in zip(grid.n, tiles)),
        cap=int(cap),
        support=int(support),
        width=tuple(t + support + 1 for t in tiles))


class PackedBuckets3(NamedTuple):
    """Chunk-packed marker layout over (x, y, z)-tiles (the fields of
    :class:`~ibamr_tpu_torch.ops.interaction_packed.PackedBuckets`, with
    a tile origin per axis)."""
    Xb: torch.Tensor               # (Q, c, dim)
    wb: torch.Tensor               # (Q, c)
    slot_of_marker: torch.Tensor   # (N,) int32
    w_overflow: torch.Tensor       # (N,)
    o_idx: torch.Tensor            # (ocap,) int32
    o_w: torch.Tensor              # (ocap,)
    any_overflow: bool             # host flag
    exceeded: bool                 # host flag
    x0: Tuple[torch.Tensor, ...]   # per axis: (Q,) tile origin cell
    tile_of_chunk: torch.Tensor    # (Q,) int32, nondecreasing


def _block_ids3_np(grid, Xn, support, tiles):
    bid = np.zeros(len(Xn), dtype=np.int64)
    for d in range(grid.dim):
        xi = (Xn[:, d] - grid.x_lo[d]) / grid.dx[d] - 0.5
        j0 = np.floor(xi - 0.5 * support).astype(np.int64) + 1
        bid = bid * (grid.n[d] // tiles[d]) \
            + np.mod(j0, grid.n[d]) // tiles[d]
    return bid


def suggest_chunks3(grid: StaggeredGrid, X, kernel="IB_4", tile: int = 8,
                    tile_last: int = 16, chunk: int = 64,
                    slack: float = 1.3) -> int:
    """Host-side chunk capacity from a concrete marker distribution:
    slack x the exact chunk demand sum(ceil(count/c))."""
    support, _ = get_kernel(kernel)
    tiles = tuple([tile] * (grid.dim - 1) + [tile_last])
    bids = _block_ids3_np(grid, _host_array(X), support, tiles)
    B = int(np.prod([n // t for n, t in zip(grid.n, tiles)]))
    counts = np.bincount(bids, minlength=B)
    need = int(np.sum(-(-counts // chunk)))
    return max(8, int(math.ceil(need * slack)))


def pack_markers3(geom: BucketGeometry3, grid: StaggeredGrid,
                  X: torch.Tensor, weights: Optional[torch.Tensor] = None,
                  nchunks: int = 1024,
                  overflow_cap: Optional[int] = None) -> PackedBuckets3:
    """Bucket markers by (x, y, z)-tile and pack them into ``nchunks``
    chunks of ``geom.cap`` slots in tile order."""
    N = X.shape[0]
    if weights is None:
        weights = torch.ones(N, dtype=X.dtype, device=X.device)
    if overflow_cap is None:
        overflow_cap = default_overflow_cap(N)
    bid = torch.zeros(N, dtype=torch.int64, device=X.device)
    for d in range(grid.dim):
        xi = (X[:, d] - grid.x_lo[d]) / grid.dx[d] - 0.5
        j0 = torch.floor(xi - 0.5 * geom.support).to(torch.int64) + 1
        bid = bid * geom.nblk[d] + torch.remainder(j0, grid.n[d]) \
            // geom.tile[d]
    (Xb, wb, slot_of_marker, w_overflow, o_idx, o_w, n_over,
     exceeded, tid) = chunk_pack_core(bid, X, weights, int(nchunks),
                                      geom.cap, int(np.prod(geom.nblk)),
                                      overflow_cap)
    any_overflow, exceeded = torch.stack([n_over > 0, exceeded]).tolist()
    return PackedBuckets3(Xb=Xb, wb=wb, slot_of_marker=slot_of_marker,
                          w_overflow=w_overflow, o_idx=o_idx, o_w=o_w,
                          any_overflow=any_overflow, exceeded=exceeded,
                          x0=_tile_origins(geom, tid), tile_of_chunk=tid)


def _fold_spills_to_grid(geom: BucketGeometry3, grid: StaggeredGrid,
                         T: torch.Tensor) -> torch.Tensor:
    """Spill-folding overlap-add: per-tile footprints ``T (nb_0, ...,
    nb_{dim-1}, w_0, ..., w_{dim-1})`` -> the grid. Per axis the spill
    segment ``[tile, width)`` of block b lies inside block b+1's core, so
    it is rolled one block forward and added to the core; the folded
    cores partition the grid, up to the footprint's offset of one cell
    (a final roll by -1 on every axis)."""
    dim = grid.dim
    tl, wd = geom.tile, geom.width
    for d in range(dim):
        ax_w = dim + d
        core = T.narrow(ax_w, 0, tl[d])
        spill = torch.roll(T.narrow(ax_w, tl[d], wd[d] - tl[d]), 1, dims=d)
        T = core + _pad_axis(spill, ax_w, 2 * tl[d] - wd[d])
    perm = [a for d in range(dim) for a in (d, dim + d)]
    out = T.permute(perm).reshape(grid.n)
    return torch.roll(out, (-1,) * dim, tuple(range(dim)))


def spread_packed3(geom: BucketGeometry3, grid: StaggeredGrid,
                   b: PackedBuckets3, F: torch.Tensor, X: torch.Tensor,
                   centering, kernel, compute_dtype=None) -> torch.Tensor:
    """Spread marker values F (N,) to the grid component at ``centering``:
    per chunk the contraction of its markers' weights over its tile's
    footprint, a sorted segment sum onto the tiles, then the spill fold;
    the overflow markers go through the exact scatter."""
    tid = b.tile_of_chunk.to(torch.int64)
    Tq = _spread_rows(geom, grid, b, tid, F, centering, kernel,
                      compute_dtype)
    B = int(np.prod(geom.nblk))
    T = scatter_add(Tq.new_zeros((B,) + Tq.shape[1:]), tid, Tq)
    out = _fold_spills_to_grid(geom, grid,
                               T.reshape(geom.nblk + geom.width))
    return spread_overflow_fallbacks(out, b, F, X, grid, centering, kernel)


def interpolate_packed3(geom: BucketGeometry3, grid: StaggeredGrid,
                        b: PackedBuckets3, f: torch.Tensor, X: torch.Tensor,
                        centering, kernel,
                        compute_dtype=None) -> torch.Tensor:
    """Interpolate the grid component ``f`` at the markers -> (N,), the
    adjoint of :func:`spread_packed3`."""
    tid = b.tile_of_chunk.to(torch.int64)
    Ub = _interp_rows(geom, grid, b, tid,
                      _extract_tiles(geom, grid, f)[tid], centering, kernel,
                      compute_dtype)
    return unbucket_with_overflow(Ub, b, f, X, grid, centering, kernel)


class PackedInteraction3:
    """The ``packed3`` engine (``packed3_bf16`` with ``compute_dtype=
    torch.bfloat16``): fully blocked chunks of ``chunk`` slots, packed once
    per position and reused for every component and both directions;
    ``nchunks`` is the static chunk capacity (size it with
    :func:`suggest_chunks3`). It has no refresh: the half-step packs
    anew, as in the reference."""

    def __init__(self, grid: StaggeredGrid, kernel="IB_4", tile: int = 8,
                 tile_last: int = 16, chunk: int = 64, nchunks: int = 2048,
                 overflow_cap: Optional[int] = None, compute_dtype=None,
                 device="cuda"):
        resolve_device(device)   # raises for a GPU request without one
        self.grid = grid
        self.kernel = kernel
        self.geom = make_geometry3(grid, kernel, tile=tile,
                                   tile_last=tile_last, cap=chunk)
        self.nchunks = int(nchunks)
        self.overflow_cap = overflow_cap
        self.compute_dtype = compute_dtype

    def buckets(self, X: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> PackedBuckets3:
        return pack_markers3(self.geom, self.grid, X, weights,
                             nchunks=self.nchunks,
                             overflow_cap=self.overflow_cap)

    def interpolate_vel(self, u, X: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        b: Optional[PackedBuckets3] = None) -> torch.Tensor:
        if b is None:
            b = self.buckets(X, weights)
        return torch.stack([
            interpolate_packed3(self.geom, self.grid, b, u[d], X, d,
                                self.kernel,
                                compute_dtype=self.compute_dtype)
            for d in range(self.grid.dim)], dim=-1)

    def spread_vel(self, F: torch.Tensor, X: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   b: Optional[PackedBuckets3] = None) -> tuple:
        if b is None:
            b = self.buckets(X, weights)
        return tuple(spread_packed3(self.geom, self.grid, b, F[:, d], X, d,
                                    self.kernel,
                                    compute_dtype=self.compute_dtype)
                     for d in range(self.grid.dim))
