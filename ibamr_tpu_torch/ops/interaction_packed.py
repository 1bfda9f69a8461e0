"""Occupancy-packed chunk layout of the markers and the ``packed`` /
``packed_bf16`` transfer engines on it, 2D and 3D (port of
``ibamr_tpu/ops/interaction_packed.py``; forward only).

Markers are bucketed by (x, y) tile and packed into ``Q`` chunks of
``c`` slots, allocated compactly in tile order: chunk q holds up to c
markers of ONE tile, ``tile_of_chunk[q]``, a nondecreasing map. Total
slots are ``Q*c ~ N + c*active_tiles`` instead of ``B*cap_max``. Markers
beyond the global chunk capacity flow through the exact overflow
fallback of :mod:`.interaction_fast`.

Layouts match the reference slot for slot: the sort is stable (as
``jnp.argsort``), searchsorted sides match, and out-of-range gathers
read an explicit zero pad row. The two overflow flags and the refresh
hit are read to the host once per pack or refresh: that is the step's
host synchronisation.

The engine (:class:`PackedInteraction`) is the reference's XLA engine in
torch ops on the engine's device: per chunk a batched contraction of its
markers' weights over the tile footprint, a sorted segment sum of the
chunks onto their tiles (deterministic: no atomics on the card), then the
overlap-add (spread); or the tile extraction, the contraction and a sum
over the footprint (interp). It is not the ``pallas_packed`` engine,
which runs the hand-written kernels (``ops/cuda_interaction.py``).
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
    BucketGeometry, _block_ids_np, _extract_tiles, _host_array,
    _interp_rows, _marker_tile_ids, _overlap_add, _spread_rows,
    _tile_origins, compact_overflow, default_overflow_cap, make_geometry,
    spread_overflow_fallbacks, unbucket_with_overflow)


class PackedBuckets(NamedTuple):
    """Chunk-packed marker layout."""
    Xb: torch.Tensor               # (Q, c, dim)
    wb: torch.Tensor               # (Q, c) marker weights (0 = empty slot)
    slot_of_marker: torch.Tensor   # (N,) int32 flat slot or Q*c (overflowed)
    w_overflow: torch.Tensor       # (N,)
    o_idx: torch.Tensor            # (ocap,) int32
    o_w: torch.Tensor              # (ocap,)
    any_overflow: bool             # host flag
    exceeded: bool                 # host flag: overflow count > ocap
    x0: Tuple[torch.Tensor, ...]   # per blocked axis: (Q,) tile origin
    tile_of_chunk: torch.Tensor    # (Q,) int32, nondecreasing


def suggest_chunks(grid: StaggeredGrid, X, kernel="IB_4", tile: int = 8,
                   chunk: int = 128, slack: float = 1.3) -> int:
    """Host-side chunk capacity from a concrete marker distribution:
    slack x the exact chunk demand sum(ceil(count/c))."""
    support, _ = get_kernel(kernel)
    bids = _block_ids_np(grid, _host_array(X), support, tile)
    B = int(np.prod([n // tile for n in grid.n[:-1]]))
    counts = np.bincount(bids, minlength=B)
    need = int(np.sum(-(-counts // chunk)))
    return max(8, int(math.ceil(need * slack)))


def chunk_pack_core(bid: torch.Tensor, X: torch.Tensor,
                    weights: torch.Tensor, Q: int, c: int, B: int,
                    overflow_cap: int):
    """Pack markers with tile ids ``bid`` in [0, B) into ``Q`` chunks of
    ``c`` slots allocated compactly in tile order. Returns
    ``(Xb, wb, slot_of_marker, w_overflow, o_idx, o_w, n_over, exceeded,
    tile_of_chunk)``."""
    N, dim = X.shape
    dev = X.device
    order = torch.argsort(bid, stable=True)
    bid_s = bid[order]
    edges = torch.searchsorted(bid_s, torch.arange(B + 1, device=dev))
    start, counts = edges[:-1], torch.diff(edges)
    nchunk_tile = (counts + c - 1) // c                 # ceil(counts/c)
    base = torch.cumsum(nchunk_tile, 0) - nchunk_tile   # exclusive scan
    rank = torch.arange(N, device=dev) - start[bid_s]
    chunk_s = base[bid_s] + rank // c                   # global chunk id
    keep = chunk_s < Q
    slot_sorted = torch.where(keep, chunk_s * c + rank % c,
                              torch.full_like(chunk_s, Q * c))

    # tile of every chunk: the last tile whose first chunk is <= q;
    # trailing never-allocated chunks pin to B-1 (nondecreasing map)
    tid = torch.searchsorted(base, torch.arange(Q, device=dev),
                             right=True) - 1
    tid = torch.clamp(tid, 0, B - 1)

    # slot -> sorted-marker position; empty slots read the zero pad row
    q_c = torch.arange(Q * c, device=dev) // c
    r = torch.arange(Q * c, device=dev) % c
    t_of_slot = tid[q_c]
    off_in_tile = (q_c - base[t_of_slot]) * c + r
    valid = (off_in_tile >= 0) & (off_in_tile < counts[t_of_slot])
    src = torch.where(valid, start[t_of_slot] + off_in_tile,
                      torch.full_like(off_in_tile, N))
    X_s = torch.cat([X[order], X.new_zeros(1, dim)])
    w_s = torch.cat([weights[order], weights.new_zeros(1)])
    Xb = X_s[src].reshape(Q, c, dim)
    wb = w_s[src].reshape(Q, c)

    (slot_of_marker, w_overflow, o_idx, o_w, n_over,
     exceeded) = compact_overflow(order, keep, slot_sorted, weights, N,
                                  overflow_cap)
    return (Xb, wb, slot_of_marker, w_overflow, o_idx, o_w, n_over,
            exceeded, tid.to(torch.int32))


def pack_markers(geom: BucketGeometry, grid: StaggeredGrid,
                 X: torch.Tensor, weights: Optional[torch.Tensor] = None,
                 nchunks: int = 1024,
                 overflow_cap: Optional[int] = None) -> PackedBuckets:
    """Bucket markers by tile, then pack tiles' markers into ``nchunks``
    chunks of ``geom.cap`` slots, allocated compactly in tile order."""
    N = X.shape[0]
    if weights is None:
        weights = torch.ones(N, dtype=X.dtype, device=X.device)
    if overflow_cap is None:
        overflow_cap = default_overflow_cap(N)
    B = int(np.prod(geom.nblk))
    (Xb, wb, slot_of_marker, w_overflow, o_idx, o_w, n_over,
     exceeded, tid) = chunk_pack_core(_marker_tile_ids(geom, grid, X), X,
                                      weights, int(nchunks), geom.cap, B,
                                      overflow_cap)
    any_overflow, exceeded = torch.stack([n_over > 0, exceeded]).tolist()
    return PackedBuckets(Xb=Xb, wb=wb, slot_of_marker=slot_of_marker,
                         w_overflow=w_overflow, o_idx=o_idx, o_w=o_w,
                         any_overflow=any_overflow, exceeded=exceeded,
                         x0=_tile_origins(geom, tid), tile_of_chunk=tid)


def refresh_packed(geom: BucketGeometry, grid: StaggeredGrid,
                   b: PackedBuckets, X: torch.Tensor,
                   weights: Optional[torch.Tensor] = None
                   ) -> Tuple[PackedBuckets, bool]:
    """Slot-preserving half-step refresh: re-gather the new positions
    ``X`` into ``b``'s chunk layout when every live packed marker's cell-
    and face-centered stencil origins stay within its chunk's footprint
    (``mod(j0 - (x0-1), n) <= tile+1`` on every blocked axis; see the
    reference for the exactness argument), else re-pack from scratch.
    Returns ``(buckets, hit)``."""
    N, dim = X.shape
    if weights is None:
        weights = torch.ones(N, dtype=X.dtype, device=X.device)
    weights = weights.to(b.wb.dtype)
    Q, c = b.Xb.shape[0], b.Xb.shape[1]
    slot = b.slot_of_marker.to(torch.int64)
    chunk_of_marker = torch.clamp(slot // c, max=Q - 1)

    ok = torch.ones(N, dtype=torch.bool, device=X.device)
    for d in range(dim - 1):
        x0 = b.x0[d].to(torch.int64)[chunk_of_marker]
        for off in (0.5, 0.0):      # cell- and face-centered origins
            xi = (X[:, d] - grid.x_lo[d]) / grid.dx[d] - off
            j0 = torch.floor(xi - 0.5 * geom.support).to(torch.int64) + 1
            r = torch.remainder(j0 - (x0 - 1), grid.n[d])
            ok &= r <= geom.tile[d] + 1
    ok |= (slot >= Q * c) | (weights == 0)
    if not bool(torch.all(ok)):
        return pack_markers(geom, grid, X, weights, nchunks=Q,
                            overflow_cap=b.o_idx.shape[0]), False
    # slot -> marker inverse (duplicates only at the discarded overflow
    # sentinel Q*c), then one gather of the new positions
    inv = torch.full((Q * c + 1,), N, dtype=torch.int64, device=X.device)
    inv[slot] = torch.arange(N, device=X.device)
    Xp = torch.cat([X, X.new_zeros(1, dim)])
    return b._replace(Xb=Xp[inv[:-1]].reshape(Q, c, dim)), True


# -- the packed engine ---------------------------------------------------------

def spread_packed(geom: BucketGeometry, grid: StaggeredGrid,
                  b: PackedBuckets, F: torch.Tensor, X: torch.Tensor,
                  centering, kernel, compute_dtype=None) -> torch.Tensor:
    """Spread marker values F (N,) to the grid component at
    ``centering``; the overflow markers go through the exact scatter.
    ``compute_dtype=torch.bfloat16`` rounds the contraction's operands to
    bf16 (f32 sum). The reference's ``_spread_raw``: its custom VJP is
    not ported."""
    tid = b.tile_of_chunk.to(torch.int64)
    Tq = _spread_rows(geom, grid, b, tid, F, centering, kernel,
                      compute_dtype)
    # tile_of_chunk is nondecreasing: the chunks of a tile are one
    # segment, summed without atomics
    B = int(np.prod(geom.nblk))
    T = scatter_add(Tq.new_zeros((B,) + Tq.shape[1:]), tid, Tq)
    return spread_overflow_fallbacks(_overlap_add(geom, grid, T), b, F, X,
                                     grid, centering, kernel)


def interpolate_packed(geom: BucketGeometry, grid: StaggeredGrid,
                       b: PackedBuckets, f: torch.Tensor, X: torch.Tensor,
                       centering, kernel,
                       compute_dtype=None) -> torch.Tensor:
    """Interpolate the grid component ``f`` at the markers -> (N,), the
    adjoint of :func:`spread_packed` (the reference's ``_interp_raw``)."""
    tid = b.tile_of_chunk.to(torch.int64)
    Ub = _interp_rows(geom, grid, b, tid, _extract_tiles(geom, grid, f)[tid],
                      centering, kernel, compute_dtype)
    return unbucket_with_overflow(Ub, b, f, X, grid, centering, kernel)


class PackedInteraction:
    """The ``packed`` engine (``packed_bf16`` with ``compute_dtype=
    torch.bfloat16``): occupancy-packed chunks of ``chunk`` slots, packed
    once per position and reused for every component and both directions;
    ``nchunks`` is the static chunk capacity (size it with
    :func:`suggest_chunks`); markers beyond it take the exact scatter
    fallback."""

    def __init__(self, grid: StaggeredGrid, kernel="IB_4", tile: int = 8,
                 chunk: int = 128, nchunks: int = 1024,
                 overflow_cap: Optional[int] = None, compute_dtype=None,
                 device="cuda"):
        resolve_device(device)   # raises for a GPU request without one
        self.grid = grid
        self.kernel = kernel
        self.geom = make_geometry(grid, kernel, tile=tile, cap=chunk)
        self.nchunks = int(nchunks)
        self.overflow_cap = overflow_cap
        self.compute_dtype = compute_dtype

    def buckets(self, X: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> PackedBuckets:
        return pack_markers(self.geom, self.grid, X, weights,
                            nchunks=self.nchunks,
                            overflow_cap=self.overflow_cap)

    def refresh(self, b: PackedBuckets, X: torch.Tensor,
                weights: Optional[torch.Tensor] = None):
        """Slot-preserving half-step refresh; returns ``(buckets, hit)``."""
        return refresh_packed(self.geom, self.grid, b, X, weights)

    def interpolate_vel(self, u, X: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        b: Optional[PackedBuckets] = None) -> torch.Tensor:
        if b is None:
            b = self.buckets(X, weights)
        return torch.stack([
            interpolate_packed(self.geom, self.grid, b, u[d], X, d,
                               self.kernel, compute_dtype=self.compute_dtype)
            for d in range(self.grid.dim)], dim=-1)

    def spread_vel(self, F: torch.Tensor, X: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   b: Optional[PackedBuckets] = None) -> tuple:
        if b is None:
            b = self.buckets(X, weights)
        return tuple(spread_packed(self.geom, self.grid, b, F[:, d], X, d,
                                   self.kernel,
                                   compute_dtype=self.compute_dtype)
                     for d in range(self.grid.dim))


# -- engine names ------------------------------------------------------------------
#
# The reference's degradation order, kept as names only: the port never
# degrades to another engine (a failed build raises).

ENGINE_FALLBACKS = {
    "pallas_packed": "packed",
    "hybrid_bf16": "packed_bf16",
    "hybrid_packed_bf16": "packed_bf16",
    "packed_bf16": "packed",
    "packed3_bf16": "packed3",
    "packed3": "packed",
    "packed": "scatter",
    "pallas": "mxu",
    "mxu_bf16": "mxu",
    "mxu": "scatter",
}


def normalize_engine_name(name) -> str:
    """Map the ``use_fast_interaction`` vocabulary (True/False/str) to a
    registry name."""
    if name is True:
        return "mxu"
    if name is False or name is None or name == "scatter":
        return "scatter"
    return str(name).lower()


def fallback_chain(name):
    """The reference's degradation order from ``name`` (inclusive) to
    "scatter"; KeyError for an unknown name."""
    cur = normalize_engine_name(name)
    chain = [cur]
    while cur != "scatter":
        cur = ENGINE_FALLBACKS[cur]
        chain.append(cur)
    return chain
