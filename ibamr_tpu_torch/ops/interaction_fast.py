"""Tile geometry, the per-tile marker layout, the shared pieces of the
bucketed transfer engines and the ``mxu`` / ``mxu_bf16`` engine
(:class:`FastInteraction`, 2D and 3D; port of
``ibamr_tpu/ops/interaction_fast.py``).

Markers are bucketed by the (x, y) tile holding their stencil origin.
Each tile's footprint spans ``width = tile + support + 1`` cells per
blocked axis, starting one cell below the tile origin, and the whole
periodic last axis. Per-tile partial grids ``(B, W0*W1, nz)`` fold onto
the periodic grid with :func:`_overlap_add`; :func:`_extract_tiles` is
its gather twin. Markers that do not fit the layout ("overflow") go
through the exact scatter/gather oracle (:mod:`.interaction`). The
torch-op engines (``mxu``, ``packed``, ``packed3``) contract each layout
row's weights with one batched ``torch.einsum`` (:func:`_spread_rows`,
:func:`_interp_rows`), as the reference's XLA einsums; the f32
contraction runs without TF32 on the card.

The reference's ``lax.cond`` overflow branches are Python branches here
on the two host flags that the layout builder reads once per bucketing.
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
from ibamr_tpu_torch.ops.interaction import _centering_offsets
from ibamr_tpu_torch.ops.delta import get_kernel


class BucketGeometry(NamedTuple):
    """Static bucketing configuration."""
    tile: Tuple[int, ...]     # tile extent per blocked axis (all but last)
    nblk: Tuple[int, ...]     # number of tiles per blocked axis
    cap: int                  # marker capacity per tile (chunk size)
    support: int              # delta support s
    width: Tuple[int, ...]    # tile + s + 1 per blocked axis


def make_geometry(grid: StaggeredGrid, kernel="IB_4", tile: int = 8,
                  cap: int = 256) -> BucketGeometry:
    support, _ = get_kernel(kernel)
    blocked = grid.n[:-1]
    if tile < support + 1:
        # the spill segment (support+1 wide) must fit inside one tile
        raise ValueError(
            f"tile {tile} must be >= support+1 = {support + 1}")
    for n in blocked:
        if n % tile != 0:
            raise ValueError(f"grid extent {n} not divisible by tile {tile}")
        if n < tile + support + 1:
            # a wrapped footprint would overlap itself and double-count
            raise ValueError(
                f"grid extent {n} too small for tile {tile} + "
                f"support {support} + 1")
    return BucketGeometry(
        tile=tuple(tile for _ in blocked),
        nblk=tuple(n // tile for n in blocked),
        cap=int(cap),
        support=int(support),
        width=tuple(tile + support + 1 for _ in blocked))


def _block_ids_np(grid, Xn, support, tile):
    """Host-side tile id of each marker's cell-centered stencil origin."""
    bid = np.zeros(len(Xn), dtype=np.int64)
    for d in range(grid.dim - 1):
        xi = (Xn[:, d] - grid.x_lo[d]) / grid.dx[d] - 0.5
        j0 = np.floor(xi - 0.5 * support).astype(np.int64) + 1
        b = np.mod(j0, grid.n[d]) // tile
        bid = bid * (grid.n[d] // tile) + b
    return bid


def _host_array(X) -> np.ndarray:
    return X.detach().cpu().numpy() if isinstance(X, torch.Tensor) \
        else np.asarray(X)


def suggest_cap(grid: StaggeredGrid, X, kernel="IB_4", tile: int = 8,
                slack: float = 1.5) -> int:
    """Host-side tile capacity from a concrete marker distribution:
    ``slack`` x the max tile occupancy, rounded up to a multiple of 8."""
    support, _ = get_kernel(kernel)
    bids = _block_ids_np(grid, _host_array(X), support, tile)
    counts = np.bincount(bids, minlength=int(np.prod(
        [n // tile for n in grid.n[:-1]])))
    return int(math.ceil(max(1, counts.max()) * slack / 8.0) * 8)


def default_overflow_cap(N: int) -> int:
    """Shared overflow-buffer sizing heuristic."""
    return min(N, max(2048, 1 << int(math.ceil(
        math.log2(max(N // 8, 1))))))


def _marker_tile_ids(geom: BucketGeometry, grid: StaggeredGrid,
                     X: torch.Tensor) -> torch.Tensor:
    """Tile id (int64) of each marker's cell-centered stencil origin."""
    bid = torch.zeros(X.shape[0], dtype=torch.int64, device=X.device)
    for d in range(grid.dim - 1):
        xi = (X[:, d] - grid.x_lo[d]) / grid.dx[d] - 0.5
        j0 = torch.floor(xi - 0.5 * geom.support).to(torch.int64) + 1
        b = torch.remainder(j0, grid.n[d]) // geom.tile[d]
        bid = bid * geom.nblk[d] + b
    return bid


def _tile_origins(geom: BucketGeometry, ids: torch.Tensor):
    """Per blocked axis, the origin cell of flat tile ids ``ids``."""
    nblocked = len(geom.nblk)
    x0 = []
    for d in range(nblocked):
        i = ids
        for a in range(nblocked - 1, d, -1):
            i = i // geom.nblk[a]
        x0.append((i % geom.nblk[d]) * geom.tile[d])
    return tuple(x0)


class Buckets(NamedTuple):
    """Per-tile marker layout: B tiles of ``cap`` slots, tile-major."""
    Xb: torch.Tensor               # (B, cap, dim), 0 in empty slots
    wb: torch.Tensor               # (B, cap) marker weights (0 = empty slot)
    slot_of_marker: torch.Tensor   # (N,) int32 flat slot or B*cap (dropped)
    w_overflow: torch.Tensor       # (N,) weights of dropped markers
    o_idx: torch.Tensor            # (ocap,) int32 overflow marker indices
    o_w: torch.Tensor              # (ocap,) their weights (0 in pad slots)
    any_overflow: bool             # host flag
    exceeded: bool                 # host flag: overflow count > ocap
    x0: Tuple[torch.Tensor, ...]   # per blocked axis: (B,) tile origin cell
    counts: torch.Tensor           # (B,) int32 filled slots, min(count, cap)


def bucket_markers(geom: BucketGeometry, grid: StaggeredGrid,
                   X: torch.Tensor, weights: Optional[torch.Tensor] = None,
                   overflow_cap: Optional[int] = None) -> Buckets:
    """Bucket markers by tile into ``geom.cap`` slots per tile, in the
    order of a stable sort of their tile ids (slot for slot the
    reference's layout); a tile's markers beyond ``cap`` overflow. Row
    t fills slots ``0 .. counts[t] - 1`` and leaves the rest empty."""
    N, dim = X.shape
    dev = X.device
    if weights is None:
        weights = torch.ones(N, dtype=X.dtype, device=dev)
    if overflow_cap is None:
        overflow_cap = default_overflow_cap(N)
    B = int(np.prod(geom.nblk))
    cap = geom.cap
    bid = _marker_tile_ids(geom, grid, X)
    order = torch.argsort(bid, stable=True)
    bid_s = bid[order]
    edges = torch.searchsorted(bid_s, torch.arange(B + 1, device=dev))
    start, counts = edges[:-1], torch.diff(edges)
    rank = torch.arange(N, device=dev) - start[bid_s]
    keep = rank < cap
    slot_sorted = torch.where(keep, bid_s * cap + rank,
                              torch.full_like(rank, B * cap))

    # slot -> sorted-marker position; empty slots read the zero pad row
    slot_b = torch.arange(B * cap, device=dev) // cap
    slot_r = torch.arange(B * cap, device=dev) % cap
    src = torch.where(slot_r < counts[slot_b], start[slot_b] + slot_r,
                      torch.full_like(slot_r, N))
    X_s = torch.cat([X[order], X.new_zeros(1, dim)])
    w_s = torch.cat([weights[order], weights.new_zeros(1)])
    Xb = X_s[src].reshape(B, cap, dim)
    wb = w_s[src].reshape(B, cap)

    (slot_of_marker, w_overflow, o_idx, o_w, n_over,
     exceeded) = compact_overflow(order, keep, slot_sorted, weights, N,
                                  overflow_cap)
    any_overflow, exceeded = torch.stack([n_over > 0, exceeded]).tolist()
    x0 = _tile_origins(geom, torch.arange(B, dtype=torch.int32, device=dev))
    return Buckets(Xb=Xb, wb=wb, slot_of_marker=slot_of_marker,
                   w_overflow=w_overflow, o_idx=o_idx, o_w=o_w,
                   any_overflow=any_overflow, exceeded=exceeded, x0=x0,
                   counts=torch.clamp(counts, max=cap).to(torch.int32))


def compact_overflow(order: torch.Tensor, keep: torch.Tensor,
                     slot_sorted: torch.Tensor, weights: torch.Tensor,
                     N: int, overflow_cap: int):
    """Overflow bookkeeping shared by the bucketed layouts: the per-
    ORIGINAL-marker slot and overflow weight, and the compact overflow
    list of static size ``overflow_cap`` (positions in the increasing
    order of the stable sort; pad entries alias marker ``order[N-1]``
    with weight 0, so every consumer weights by ``o_w``). Returns
    ``(slot_of_marker, w_overflow, o_idx, o_w, n_over, exceeded)``."""
    dev = order.device
    slot_of_marker = torch.zeros(N, dtype=torch.int32, device=dev)
    slot_of_marker[order] = slot_sorted.to(torch.int32)
    w_overflow = torch.zeros(N, dtype=weights.dtype, device=dev)
    w_overflow[order] = torch.where(keep, torch.zeros_like(weights),
                                    weights[order])
    # static-size nonzero: the k-th overflow position is the first
    # index whose running overflow count reaches k+1 (N when none)
    running = torch.cumsum((~keep).to(torch.int64), 0)
    o_pos = torch.searchsorted(
        running, torch.arange(1, overflow_cap + 1, device=dev))
    o_valid = o_pos < N
    o_src = order[torch.clamp(o_pos, max=N - 1)]
    o_idx = o_src.to(torch.int32)
    o_w = torch.where(o_valid, weights[o_src], torch.zeros_like(
        weights[o_src]))
    n_over = N - torch.sum(keep)
    return (slot_of_marker, w_overflow, o_idx, o_w, n_over,
            n_over > overflow_cap)


def _phi_safe(phi, support):
    """``phi`` clipped to its support and exactly 0 outside it."""
    half = 0.5 * support

    def f(t):
        inside = torch.abs(t) < half
        return torch.where(inside, phi(torch.clamp(t, -half, half)),
                           torch.zeros_like(t))
    return f


def tile_weights(geom: BucketGeometry, grid: StaggeredGrid, offs,
                 tid: torch.Tensor, Xb: torch.Tensor, kernel="IB_4"):
    """The weight preamble of the kernels and engines for every chunk (or
    tile row) ``q`` of tile ``tid[q]``: per axis d, the weights ``(Q, W_d,
    c)`` of its markers over the tile's footprint (``W_d = width[d]``
    cells from one below the tile origin) on the blocked axes, and over
    the whole periodic axis on an axis ``geom`` does not block (the last,
    for the xy-blocked layouts; none for the fully blocked ``packed3``),
    wrapped periodically by rounding half to even. The CUDA kernels
    evaluate IB_4, the default; the torch-op engines pass their own
    (isotropic) kernel."""
    support, phi0 = get_kernel(kernel)
    phi = _phi_safe(phi0, support)
    dtype, dev = Xb.dtype, Xb.device
    origins = _tile_origins(geom, tid.to(torch.int64))
    out = []
    for d in range(grid.dim):
        n = grid.n[d]
        xi = (Xb[..., d] - grid.x_lo[d]) / grid.dx[d] - offs[d]   # (Q, c)
        if d < len(geom.nblk):
            k = ((origins[d] - 1)[:, None].to(dtype)
                 + torch.arange(geom.width[d], dtype=dtype, device=dev))
        else:
            k = torch.arange(n, dtype=dtype, device=dev)[None, :]
        tk = xi[:, None, :] - k[:, :, None]
        tk = tk - torch.round(tk / n) * n
        out.append(phi(tk))
    return tuple(out)


def _tile_weights(geom, grid: StaggeredGrid, b, tid: torch.Tensor,
                  centering, kernel):
    """The reference's ``_tile_weights`` for rows of tiles ``tid``: the
    first ``dim - 1`` axes combined into one footprint axis, ``A (Q, P,
    c)`` with ``p = a * W1 + b`` in 3D, and the last axis ``W (Q, W_last,
    c)`` (``_blocked_axis_weights`` / ``_full_axis_weights`` are
    :func:`tile_weights`'s cases)."""
    ws = tile_weights(geom, grid, _centering_offsets(grid, centering), tid,
                      b.Xb, kernel)
    A = ws[0]
    for w in ws[1:-1]:
        A = (A[:, :, None, :] * w[:, None, :, :]).reshape(
            A.shape[0], -1, A.shape[-1])
    return A, ws[-1]


def _spread_rows(geom, grid: StaggeredGrid, b, tid: torch.Tensor,
                 F: torch.Tensor, centering, kernel,
                 compute_dtype=None) -> torch.Tensor:
    """Each layout row's partial footprint ``(Q, P, W_last)`` of the
    marker values F (N,): the rows' weighted markers contracted over
    their slots (``bmp,bmz->bpz`` of the reference)."""
    inv_vol = 1.0 / math.prod(grid.dx)
    A, W = _tile_weights(geom, grid, b, tid, centering, kernel)
    A = A * (bucketed_channel(b, F) * b.wb * inv_vol)[:, None, :]
    return contract_compressed("qpm,qzm->qpz", A, W, compute_dtype)


def _interp_rows(geom, grid: StaggeredGrid, b, tid: torch.Tensor,
                 T: torch.Tensor, centering, kernel,
                 compute_dtype=None) -> torch.Tensor:
    """Each layout slot's interpolant ``(Q, c)`` from its row's footprint
    ``T (Q, P, W_last)`` of the grid component (``bpz,bmz->bmp`` of the
    reference, then the sum over the footprint)."""
    A, W = _tile_weights(geom, grid, b, tid, centering, kernel)
    D = contract_compressed("qpz,qzm->qpm", T, W, compute_dtype)
    return torch.sum(A * D, dim=1) * b.wb


def _pad_axis(x: torch.Tensor, axis: int, after: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[axis] = after
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _overlap_add(geom: BucketGeometry, grid: StaggeredGrid,
                 T: torch.Tensor) -> torch.Tensor:
    """Accumulate tiles T (B, w0[, w1], n_last) into the periodic grid:
    split each blocked axis into core [0, tile) and spill [tile, width)
    segments, reshape each combination onto the grid, roll into place."""
    dim = grid.dim
    nb, tl, wd = geom.nblk, geom.tile, geom.width
    nblocked = dim - 1
    T = T.reshape(tuple(nb) + tuple(wd) + (grid.n[dim - 1],))
    out = torch.zeros(grid.n, dtype=T.dtype, device=T.device)
    for mask in range(2 ** nblocked):
        seg = T
        shift = []
        for d in range(nblocked):
            spill = (mask >> d) & 1
            lo, hi = (0, tl[d]) if not spill else (tl[d], wd[d])
            seg = seg.narrow(nblocked + d, lo, hi - lo)
            if tl[d] - (hi - lo):
                seg = _pad_axis(seg, nblocked + d, tl[d] - (hi - lo))
            # core starts at x0 - 1; spill starts at x0 + tile - 1
            shift.append(-1 if not spill else tl[d] - 1)
        perm = []
        for d in range(nblocked):
            perm += [d, nblocked + d]
        perm += [2 * nblocked]
        seg = seg.permute(perm).reshape(grid.n)
        for d in range(nblocked):
            seg = torch.roll(seg, shift[d], dims=d)
        out = out + seg
    return out


def _extract_tiles(geom, grid: StaggeredGrid,
                   f: torch.Tensor) -> torch.Tensor:
    """Gather every tile's footprint of ``f`` -> ``(B, P, W_last)``: the
    blocked axes' widths, the first ``dim - 1`` combined into ``P``, and
    the last axis whole (xy-blocked layouts) or its footprint (the fully
    blocked ``packed3``, the reference's ``_extract_tiles3``)."""
    nblocked = len(geom.nblk)
    arr = f
    for d in range(nblocked):
        idx = (np.arange(geom.nblk[d])[:, None] * geom.tile[d] - 1
               + np.arange(geom.width[d])[None, :]) % grid.n[d]
        arr = torch.index_select(
            arr, 2 * d, torch.as_tensor(idx.reshape(-1), device=f.device))
        arr = arr.reshape(arr.shape[:2 * d]
                          + (geom.nblk[d], geom.width[d])
                          + arr.shape[2 * d + 1:])
    # (nb0, w0, nb1, w1, ...[, n_last]) -> (nb..., w...[, n_last])
    perm = ([2 * d for d in range(nblocked)]
            + [2 * d + 1 for d in range(nblocked)]
            + list(range(2 * nblocked, arr.dim())))
    return arr.permute(perm).reshape(int(np.prod(geom.nblk)),
                                     int(np.prod(geom.width[:grid.dim - 1])),
                                     -1)


def bucketed_channel(b, F: torch.Tensor) -> torch.Tensor:
    """Place a per-marker channel (N,) into the slot layout of ``b``.
    Slots are unique per marker except the dropped overflow sentinel,
    which is cut off, so a plain indexed write suffices."""
    nslot = b.wb.numel()
    Ff = torch.zeros(nslot + 1, dtype=F.dtype, device=F.device)
    Ff[b.slot_of_marker.to(torch.int64)] = F
    return Ff[:-1].reshape(b.wb.shape)


@contextlib.contextmanager
def exact_f32_matmul():
    """cuBLAS f32 products without TF32 inside the block, the reference's
    ``Precision.HIGHEST``, whatever the process set; the setting is
    restored after."""
    m = torch.backends.cuda.matmul
    prev = m.fp32_precision
    if prev == "ieee":
        yield
        return
    m.fp32_precision = "ieee"
    try:
        yield
    finally:
        m.fp32_precision = prev


def contract_compressed(spec: str, a: torch.Tensor, b: torch.Tensor,
                        compute_dtype=None) -> torch.Tensor:
    """The transfer engines' contraction: exact in the operands' type (f32
    without TF32 on the card), or, with ``compute_dtype=torch.bfloat16``,
    of the operands rounded to bf16 with an f32 sum and an f32 result
    (cast to ``a``'s type) as the reference's
    ``preferred_element_type=f32``. Each rounded operand goes back to f32
    before the product: a bf16 ``einsum`` would round its result to bf16
    too."""
    if compute_dtype is not None:
        def rounded(x):
            return x.to(compute_dtype).to(torch.float32)

        a_, b_ = rounded(a), rounded(b)
    else:
        a_, b_ = a, b
    if a.device.type != "cuda":
        return torch.einsum(spec, a_, b_).to(a.dtype)
    with exact_f32_matmul():
        return torch.einsum(spec, a_, b_).to(a.dtype)


def spread_overflow_fallbacks(out: torch.Tensor, b, F: torch.Tensor,
                              X: torch.Tensor, grid: StaggeredGrid,
                              centering, kernel) -> torch.Tensor:
    """Add the overflow markers' contribution to ``out``: a compact
    scatter of the buffered overflow list, or an exact full scatter when
    the buffer itself overflowed."""
    if b.exceeded:
        return interaction.spread(F, grid, X, centering=centering,
                                  kernel=kernel, weights=b.w_overflow,
                                  out=out)
    if b.any_overflow:
        # pad slots rely on o_w == 0 making them inert
        o = b.o_idx.to(torch.int64)
        return interaction.spread(F[o], grid, X[o], centering=centering,
                                  kernel=kernel, weights=b.o_w, out=out)
    return out


def unbucket_with_overflow(Ub: torch.Tensor, b, f: torch.Tensor,
                           X: torch.Tensor, grid: StaggeredGrid,
                           centering, kernel) -> torch.Tensor:
    """Per-slot interpolants Ub back to marker order, plus the overflow
    markers' contribution (compact gather of the buffered overflow, or
    an exact full gather when the buffer itself overflowed)."""
    slot = b.slot_of_marker.to(torch.int64)
    flat = Ub.reshape(-1)
    U = flat[torch.clamp(slot, max=flat.numel() - 1)]
    U = torch.where(slot < flat.numel(), U, torch.zeros_like(U))
    if b.exceeded:
        return U + interaction.interpolate(f, grid, X, centering=centering,
                                           kernel=kernel,
                                           weights=b.w_overflow)
    if b.any_overflow:
        # pad entries add exact zeros to an aliased marker: the sum is
        # order-independent, so the atomic index_add stays deterministic
        o = b.o_idx.to(torch.int64)
        Uo = interaction.interpolate(f, grid, X[o], centering=centering,
                                     kernel=kernel, weights=b.o_w)
        return U.index_add(0, o, Uo)
    return U


def spread_bucketed(geom: BucketGeometry, grid: StaggeredGrid, b: Buckets,
                    F: torch.Tensor, X: torch.Tensor, centering, kernel,
                    compute_dtype=None) -> torch.Tensor:
    """Spread marker values F (N,) to the grid component at ``centering``
    through the per-tile layout ``b``: per tile the contraction of its
    slots' weights, then the overlap-add; the overflow markers go through
    the exact scatter. The marker weights are the ones baked into ``b``."""
    tid = torch.arange(b.wb.shape[0], device=F.device)
    T = _spread_rows(geom, grid, b, tid, F, centering, kernel, compute_dtype)
    return spread_overflow_fallbacks(_overlap_add(geom, grid, T), b, F, X,
                                     grid, centering, kernel)


def interpolate_bucketed(geom: BucketGeometry, grid: StaggeredGrid,
                         b: Buckets, f: torch.Tensor, X: torch.Tensor,
                         centering, kernel,
                         compute_dtype=None) -> torch.Tensor:
    """Interpolate the grid component ``f`` at the markers -> (N,), the
    adjoint of :func:`spread_bucketed`."""
    tid = torch.arange(b.wb.shape[0], device=f.device)
    Ub = _interp_rows(geom, grid, b, tid, _extract_tiles(geom, grid, f),
                      centering, kernel, compute_dtype)
    return unbucket_with_overflow(Ub, b, f, X, grid, centering, kernel)


class FastInteraction:
    """The ``mxu`` engine (``mxu_bf16`` with ``compute_dtype=
    torch.bfloat16``), 2D and 3D: markers bucketed once per position into
    ``cap`` slots per tile and reused for every component and both
    directions; each tile's transfer is one batched contraction
    (``torch.einsum``, as the reference's XLA einsum). Markers past a
    tile's ``cap`` take the exact scatter fallback. ``weights`` are baked
    into the buckets: with a prebuilt ``b`` they must be the ones it was
    built with."""

    def __init__(self, grid: StaggeredGrid, kernel="IB_4", tile: int = 8,
                 cap: int = 256, overflow_cap: Optional[int] = None,
                 compute_dtype=None, device="cuda"):
        resolve_device(device)   # raises for a GPU request without one
        self.grid = grid
        self.kernel = kernel
        self.geom = make_geometry(grid, kernel, tile=tile, cap=cap)
        self.overflow_cap = overflow_cap
        self.compute_dtype = compute_dtype

    def buckets(self, X: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> Buckets:
        return bucket_markers(self.geom, self.grid, X, weights,
                              overflow_cap=self.overflow_cap)

    def interpolate_vel(self, u, X: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        b: Optional[Buckets] = None) -> torch.Tensor:
        if b is None:
            b = self.buckets(X, weights)
        return torch.stack([
            interpolate_bucketed(self.geom, self.grid, b, u[d], X, d,
                                 self.kernel,
                                 compute_dtype=self.compute_dtype)
            for d in range(self.grid.dim)], dim=-1)

    def spread_vel(self, F: torch.Tensor, X: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   b: Optional[Buckets] = None) -> tuple:
        if b is None:
            b = self.buckets(X, weights)
        return tuple(spread_bucketed(self.geom, self.grid, b, F[:, d], X, d,
                                     self.kernel,
                                     compute_dtype=self.compute_dtype)
                     for d in range(self.grid.dim))
