"""Occupancy-packed chunk layout of the markers and the ``packed`` /
``packed_bf16`` transfer engines on it, 2D and 3D (port of
``ibamr_tpu/ops/interaction_packed.py``).

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

Reverse mode (the reference's custom VJPs): under autograd
:func:`spread_packed` and :func:`interpolate_packed` run as
``torch.autograd.Function`` subclasses. The spread's force cotangent is
an interp of the grid cotangent through the same buckets times
``1/h^dim`` with no accumulating scatter (the overflow merge is a sort,
a prefix sum and two ``searchsorted`` probes); the interp's field
cotangent is a spread through the same buckets times ``h^dim``. The
position cotangent of either is the scatter oracle's weight derivative,
pulled back through :func:`.interaction.interpolate` of the other side's
field. The bucket layout gets no cotangent: its integers are piecewise
constant in X, and the whole position gradient flows through the
explicit ``X``, which must be the positions the buckets were packed
from. So the Functions are differentiable once: a reverse pass taken
with ``create_graph`` (to be differentiated again) raises, and
:func:`plain_autodiff_transfers` (``GRAD_TRANSFERS = False``), which
differentiates the plain ops, serves it.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops import interaction
from ibamr_tpu_torch.ops.delta import get_kernel
from ibamr_tpu_torch.ops.interaction import scatter_add
from ibamr_tpu_torch.ops.interaction_fast import (
    BucketGeometry, _block_ids_np, _extract_tiles, _host_array,
    _interp_rows, _marker_tile_ids, _overlap_add, _spread_rows,
    _tile_origins, compact_overflow, default_overflow_cap, make_geometry,
    spread_overflow_fallbacks, unbucket_with_overflow)

# Reverse-mode policy of the packed transfers: True routes autograd
# through the adjoint Functions, False differentiates the plain ops.
GRAD_TRANSFERS = True


@contextlib.contextmanager
def plain_autodiff_transfers():
    """Differentiate the plain packed ops inside the block instead of the
    adjoint Functions (their backward emits the transposed scatters of
    the gathers; the implicit Newton's Jacobian products run under it,
    as the reference's)."""
    global GRAD_TRANSFERS
    prev = GRAD_TRANSFERS
    GRAD_TRANSFERS = False
    try:
        yield
    finally:
        GRAD_TRANSFERS = prev


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

def _spread_raw(geom: BucketGeometry, grid: StaggeredGrid,
                b: PackedBuckets, F: torch.Tensor, X: torch.Tensor,
                centering, kernel, compute_dtype=None) -> torch.Tensor:
    tid = b.tile_of_chunk.to(torch.int64)
    Tq = _spread_rows(geom, grid, b, tid, F, centering, kernel,
                      compute_dtype)
    # tile_of_chunk is nondecreasing: the chunks of a tile are one
    # segment, summed without atomics
    B = int(np.prod(geom.nblk))
    T = scatter_add(Tq.new_zeros((B,) + Tq.shape[1:]), tid, Tq)
    return spread_overflow_fallbacks(_overlap_add(geom, grid, T), b, F, X,
                                     grid, centering, kernel)


def _interp_raw(geom: BucketGeometry, grid: StaggeredGrid,
                b: PackedBuckets, f: torch.Tensor, X: torch.Tensor,
                centering, kernel, compute_dtype=None,
                merge=None) -> torch.Tensor:
    tid = b.tile_of_chunk.to(torch.int64)
    Ub = _interp_rows(geom, grid, b, tid, _extract_tiles(geom, grid, f)[tid],
                      centering, kernel, compute_dtype)
    return unbucket_with_overflow(Ub, b, f, X, grid, centering, kernel,
                                  merge=merge)


# -- reverse mode ------------------------------------------------------------

def _marker_weights(b: PackedBuckets) -> torch.Tensor:
    """The per-marker weights from the layout: the pack-time weight of a
    packed marker (its slot is its own) plus ``w_overflow`` for the
    others."""
    wb = b.wb.reshape(-1)
    slot = b.slot_of_marker.to(torch.int64)
    packed = wb[torch.clamp(slot, max=wb.numel() - 1)]
    return torch.where(slot < wb.numel(), packed,
                       torch.zeros_like(packed)) + b.w_overflow


def _merge_overflow_gather(U: torch.Tensor, o_idx: torch.Tensor,
                           vals: torch.Tensor) -> torch.Tensor:
    """``U.index_add(0, o_idx, vals)`` without an accumulating scatter:
    sort the overflow list by marker, prefix-sum the sorted values and
    take each marker's run sum by two ``searchsorted`` probes (pad entries
    alias a real marker with value 0; repeated markers sum)."""
    perm = torch.argsort(o_idx, stable=True)
    so = o_idx[perm]
    cs = torch.cat([vals.new_zeros(1), torch.cumsum(vals[perm], 0)])
    ar = torch.arange(U.shape[0], dtype=so.dtype, device=so.device)
    lo = torch.searchsorted(so, ar)
    hi = torch.searchsorted(so, ar, right=True)
    return U + (cs[hi] - cs[lo])


def _position_cotangent(grid: StaggeredGrid, field: torch.Tensor,
                        X: torch.Tensor, centering, kernel,
                        scale: torch.Tensor) -> torch.Tensor:
    """``scale`` (the per-marker chain factor) pulled back through the
    oracle's stencil evaluation ``X -> sum_cells field delta_h(cells -
    X)``: the stencil indices are floors (no derivative), so only the
    kernel weights differentiate, by gathers and elementwise ops."""
    with torch.enable_grad():
        Xp = X.detach().requires_grad_(True)
        y = interaction.interpolate(field.detach(), grid, Xp,
                                    centering=centering, kernel=kernel)
        (g,) = torch.autograd.grad(y, Xp, scale.to(y.dtype))
    return g


def _refuse_create_graph() -> None:
    """Raise for a reverse pass taken with ``create_graph`` (one that is
    to be differentiated again): the adjoint formulas hold the layout
    constant, so their own derivative in the positions would be wrong,
    and a wrong second derivative must not pass silently."""
    if torch.is_grad_enabled():
        raise NotImplementedError(
            "the packed transfers' adjoint Functions are differentiable "
            "once: take a reverse pass that is to be differentiated again "
            "(create_graph=True, the implicit Newton's Jacobian products) "
            "under plain_autodiff_transfers()")


class _SpreadAdjoint(torch.autograd.Function):
    """:func:`_spread_raw` with the reference's custom VJP."""

    @staticmethod
    def forward(ctx, F, X, geom, grid, b, centering, kernel, compute_dtype):
        ctx.save_for_backward(F, X)
        ctx.args = (geom, grid, b, centering, kernel, compute_dtype)
        return _spread_raw(geom, grid, b, F, X, centering, kernel,
                           compute_dtype)

    @staticmethod
    def backward(ctx, ct):
        _refuse_create_graph()
        F, X = ctx.saved_tensors
        geom, grid, b, centering, kernel, compute_dtype = ctx.args
        inv_vol = 1.0 / math.prod(grid.dx)
        F_ct = X_ct = None
        if ctx.needs_input_grad[0]:
            # an interp of the grid cotangent that runs no accumulating
            # scatter: the overflow merge by _merge_overflow_gather
            F_ct = inv_vol * _interp_raw(geom, grid, b, ct, X, centering,
                                         kernel, compute_dtype,
                                         merge=_merge_overflow_gather)
        if ctx.needs_input_grad[1]:
            X_ct = _position_cotangent(grid, ct, X, centering, kernel,
                                       F * _marker_weights(b) * inv_vol)
        return F_ct, X_ct, None, None, None, None, None, None


class _InterpAdjoint(torch.autograd.Function):
    """:func:`_interp_raw` with the reference's custom VJP."""

    @staticmethod
    def forward(ctx, f, X, geom, grid, b, centering, kernel, compute_dtype):
        ctx.save_for_backward(f, X)
        ctx.args = (geom, grid, b, centering, kernel, compute_dtype)
        return _interp_raw(geom, grid, b, f, X, centering, kernel,
                           compute_dtype)

    @staticmethod
    def backward(ctx, ct):
        _refuse_create_graph()
        f, X = ctx.saved_tensors
        geom, grid, b, centering, kernel, compute_dtype = ctx.args
        f_ct = X_ct = None
        if ctx.needs_input_grad[0]:
            f_ct = math.prod(grid.dx) * _spread_raw(
                geom, grid, b, ct, X, centering, kernel, compute_dtype)
        if ctx.needs_input_grad[1]:
            X_ct = _position_cotangent(grid, f, X, centering, kernel,
                                       ct * _marker_weights(b))
        return f_ct, X_ct, None, None, None, None, None, None


def _adjoint_wanted(b: PackedBuckets, *xs) -> bool:
    return GRAD_TRANSFERS and torch.is_grad_enabled() and any(
        x.requires_grad for x in xs + (b.Xb, b.wb))


def spread_packed(geom: BucketGeometry, grid: StaggeredGrid,
                  b: PackedBuckets, F: torch.Tensor, X: torch.Tensor,
                  centering, kernel, compute_dtype=None) -> torch.Tensor:
    """Spread marker values F (N,) to the grid component at
    ``centering``; the overflow markers go through the exact scatter.
    ``compute_dtype=torch.bfloat16`` rounds the contraction's operands to
    bf16 (f32 sum). Under autograd the adjoint Function (module
    docstring): its force cotangent runs no accumulating scatter."""
    if _adjoint_wanted(b, F, X):
        return _SpreadAdjoint.apply(F, X, geom, grid, b, centering, kernel,
                                    compute_dtype)
    return _spread_raw(geom, grid, b, F, X, centering, kernel,
                       compute_dtype)


def interpolate_packed(geom: BucketGeometry, grid: StaggeredGrid,
                       b: PackedBuckets, f: torch.Tensor, X: torch.Tensor,
                       centering, kernel,
                       compute_dtype=None) -> torch.Tensor:
    """Interpolate the grid component ``f`` at the markers -> (N,), the
    adjoint of :func:`spread_packed`; under autograd the adjoint
    Function, whose field cotangent is a spread through the same
    buckets."""
    if _adjoint_wanted(b, f, X):
        return _InterpAdjoint.apply(f, X, geom, grid, b, centering, kernel,
                                    compute_dtype)
    return _interp_raw(geom, grid, b, f, X, centering, kernel,
                       compute_dtype)


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
