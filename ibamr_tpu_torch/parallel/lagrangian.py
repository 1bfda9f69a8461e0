"""Lagrangian co-partitioning: shard-owned markers + halo exchange (port
of ``ibamr_tpu/parallel/lagrangian.py``).

1. **Owner bucketing.** Markers are bucketed by the mesh block owning
   their cell: one stable argsort + scatter of N rows on the mesh's
   first device, giving fixed-capacity per-shard pools ``(P * cap,
   ...)`` that are cut into one ``(cap, ...)`` block per shard.
   Inactive (weight-0) markers go to the sentinel owner ``P`` and use no
   capacity. Re-bucketing every call is the migration strategy.
2. **Local transfer + halo exchange.** Each shard's body spreads the
   filled slots of its pool (the bucketing's one host read counts them;
   the weight-0 pads after them are skipped) into its grid block
   extended by a halo ring of width ``s//2 + 1`` on the sharded axes
   (wrapped on the others), then the halo slabs are ppermuted to the
   ring neighbours and accumulated, one sharded axis after another.
   Interpolation mirrors it: ghost fill by ppermute, then a purely local
   gather (the exact adjoint). Both halo passes are ``parallel/spmd.py``'s
   (``halo_add``, ``ghost_fill``), which the block-resident step's
   stencils share. The MAC components go through one pass:
   stacked into one buffer a shard, with the shard's stencils built once
   per layout and shared by every transfer at it. The velocity comes in
   and the force goes out as whole tensors or, for the block-resident
   step, as ``spmd.Blocks`` (``spread_vel(..., blocks=True)``), read and
   written block by block.
3. **Overflow.** Markers beyond a shard's capacity go through the
   replicated scatter oracle over a compact index buffer (pad entries
   carry weight 0); when that buffer overflows too, every unselected
   marker takes the full oracle with the caller's weights. Which path
   runs is decided from one host read per bucketing.

The local scatter runs under ``ops.interaction.deterministic``, and the
halo sums run in a fixed order, so a transfer is bitwise the same run to
run. Per-shard work scales with ``cap`` (~N/P * slack), not N. Like the
reference's, this engine calls no hand kernel.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops import interaction
from ibamr_tpu_torch.ops.delta import get_kernel
from ibamr_tpu_torch.ops.interaction import (_axis_weights_indices,
                                             _centering_offsets)
from ibamr_tpu_torch.parallel.spmd import (Blocks, Mesh, NamedSharding, P,
                                           ghost_fill, halo_add, shard, smap,
                                           unshard)

Vel = Tuple[torch.Tensor, ...]


class ShardBuckets(NamedTuple):
    """Owner-bucketed marker layout (all shapes static). The first eight
    fields are the reference's. ``Xl`` / ``wl`` are the per-shard blocks
    of ``Xb`` / ``wb``; ``fill`` (host ints) counts each shard's filled
    slots, which come first in its pool (the rest are weight-0 pads);
    ``overflow`` holds host copies of ``(any_overflow, exceeded)``;
    ``memo`` keeps the per-shard stencils of this layout, built once and
    shared by every transfer at it."""
    Xb: torch.Tensor          # (P*cap, dim) positions
    wb: torch.Tensor          # (P*cap,) weights (0 in pad slots)
    slot_of_marker: torch.Tensor   # (N,) slot or P*cap (overflowed)
    w_all: torch.Tensor       # (N,) the caller's weights, global order
    o_idx: torch.Tensor       # (ocap,) original indices of overflow markers
    o_w: torch.Tensor         # (ocap,) their weights (0 in pad slots)
    any_overflow: torch.Tensor     # () bool
    exceeded: torch.Tensor    # () bool: overflow buffer itself overflowed
    Xl: List[torch.Tensor]
    wl: List[torch.Tensor]
    fill: Tuple[int, ...]
    overflow: Tuple[bool, bool]
    memo: dict


class ShardedInteraction:
    """Shard-owned spread/interp engine bound to one (grid, mesh) pair.

    The leading ``len(mesh.axis_names)`` grid axes are sharded by the
    mesh (the convention of ``parallel.mesh.grid_pspec``). ``cap`` is
    the per-shard marker capacity; default ``slack`` x the balanced
    share, rounded up to a multiple of 8.
    """

    def __init__(self, grid: StaggeredGrid, mesh: Mesh,
                 kernel="IB_4", n_markers: Optional[int] = None,
                 cap: Optional[int] = None, slack: float = 2.0,
                 overflow_cap: Optional[int] = None):
        self.grid = grid
        self.mesh = mesh
        self.kernel = kernel
        self.axes = tuple(mesh.axis_names)
        self.sizes = tuple(mesh.shape[a] for a in self.axes)
        self.n_sharded = len(self.axes)
        if self.n_sharded > grid.dim:
            raise ValueError("mesh has more axes than the grid")
        self.nloc = []
        for d, p in enumerate(self.sizes):
            if grid.n[d] % p != 0:
                raise ValueError(
                    f"grid axis {d} ({grid.n[d]}) not divisible by mesh "
                    f"axis {self.axes[d]!r} ({p})")
            self.nloc.append(grid.n[d] // p)
        support, _ = get_kernel(kernel)
        self.support = support
        # halo radius: the stencil of a cell-owned marker spans at most
        # [c - s//2, c + s//2] across all MAC centerings
        self.w = support // 2 + 1
        for d in range(self.n_sharded):
            if self.nloc[d] < self.w:
                raise ValueError(
                    f"local block ({self.nloc[d]} cells on axis {d}) "
                    f"thinner than the halo ({self.w}); use fewer devices "
                    f"or a bigger grid")
        self.P = int(np.prod(self.sizes))
        if cap is None:
            if n_markers is None:
                raise ValueError("need n_markers or an explicit cap")
            cap = int(math.ceil(n_markers * slack / self.P / 8.0) * 8)
        self.cap = int(cap)
        self.overflow_cap = overflow_cap
        # row layout of the (P*cap, ...) pools: all mesh axes, in order
        row_axes = tuple(self.axes) if self.n_sharded > 1 else self.axes[0]
        self.row_spec = P(row_axes)
        self.row_spec2 = P(row_axes, None)
        self.grid_spec = P(*self.axes,
                           *([None] * (grid.dim - self.n_sharded)))
        self.ext_shape = tuple(
            (self.nloc[d] + 2 * self.w) if d < self.n_sharded
            else grid.n[d] for d in range(grid.dim))

    # -- bucketing (replicated arithmetic) -----------------------------------
    def buckets(self, X: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> ShardBuckets:
        grid = self.grid
        N, dim = X.shape
        dev = X.device
        if weights is None:
            weights = torch.ones((N,), dtype=X.dtype, device=dev)
        ocap = self.overflow_cap
        if ocap is None:
            ocap = min(N, max(256, N // 8))

        active = weights != 0
        owner = torch.zeros((N,), dtype=torch.int64, device=dev)
        for d in range(self.n_sharded):
            c = torch.floor((X[:, d] - grid.x_lo[d]) / grid.dx[d]).to(
                torch.int64)
            c = torch.remainder(c, grid.n[d])
            owner = owner * self.sizes[d] + torch.div(
                c, self.nloc[d], rounding_mode="floor")
        owner = torch.where(active, owner, torch.full_like(owner, self.P))

        cap, Pn = self.cap, self.P
        order = torch.argsort(owner, stable=True)
        owner_s = owner[order]
        start = torch.searchsorted(
            owner_s, torch.arange(Pn, dtype=owner_s.dtype, device=dev))
        rank = (torch.arange(N, dtype=torch.int64, device=dev)
                - start[torch.clamp(owner_s, max=Pn - 1)])
        keep = (owner_s < Pn) & (rank < cap)
        slot_sorted = torch.where(keep, owner_s * cap + rank,
                                  torch.full_like(owner_s, Pn * cap))

        # the sentinel row Pn*cap takes every unselected marker, then goes
        Xb = torch.zeros((Pn * cap + 1, dim), dtype=X.dtype, device=dev)
        Xb = Xb.index_put((slot_sorted,), X[order])[:-1]
        wb = torch.zeros((Pn * cap + 1,), dtype=weights.dtype, device=dev)
        wb = wb.index_put((slot_sorted,), torch.where(
            keep, weights[order], torch.zeros_like(weights)))[:-1]
        slot_of_marker = torch.empty((N,), dtype=torch.int64, device=dev)
        slot_of_marker[order] = slot_sorted

        # compact fallback buffer: only ACTIVE unselected markers need it
        need = (~keep) & active[order]
        ord2 = torch.argsort((~need).to(torch.int8), stable=True)
        o_pos = ord2[:ocap]
        o_idx = order[o_pos]
        o_w = torch.where(need[o_pos], weights[order[o_pos]],
                          torch.zeros((), dtype=weights.dtype, device=dev))
        n_over = torch.sum(need)
        fill = torch.bincount(torch.where(keep, owner_s,
                                          torch.full_like(owner_s, Pn)),
                              minlength=Pn + 1)[:Pn]
        # the bucketing's one host read: the fills and the overflow count
        host = torch.cat([fill, n_over.reshape(1)]).tolist()
        n_host = int(host[-1])
        return ShardBuckets(
            Xb=Xb, wb=wb, slot_of_marker=slot_of_marker, w_all=weights,
            o_idx=o_idx, o_w=o_w, any_overflow=n_over > 0,
            exceeded=n_over > ocap,
            Xl=shard(self.mesh, Xb, self.row_spec2),
            wl=shard(self.mesh, wb, self.row_spec),
            fill=tuple(int(v) for v in host[:-1]),
            overflow=(n_host > 0, n_host > ocap), memo={})

    # -- per-shard pieces ----------------------------------------------------
    def _starts(self, ctx) -> List[int]:
        return [ctx.axis_index(self.axes[d]) * self.nloc[d]
                for d in range(self.n_sharded)]

    def _axis_stencils(self, Xl, starts, off: float):
        """Per-axis local stencil indices and weights of the markers
        ``Xl`` (f, dim) at centering offset ``off`` on every axis ->
        ``j, w`` (f, dim, s): sharded axes wrapped by the marker's CELL
        (a stencil contiguous around the owned cell) and made local to
        the halo-extended block, the other axes wrapped periodically."""
        grid = self.grid
        support, phi = get_kernel(self.kernel)
        xis = []
        for d in range(grid.dim):
            xi = (Xl[:, d] - grid.x_lo[d]) / grid.dx[d]
            if d < self.n_sharded:
                fl = torch.floor(xi)
                xi = xi + (torch.remainder(fl, grid.n[d]) - fl)
            xis.append(xi)
        j, w = _axis_weights_indices(torch.stack(xis, dim=1) - off, None,
                                     support, phi)
        sub = torch.tensor([starts[d] - self.w if d < self.n_sharded else 0
                            for d in range(grid.dim)], dtype=j.dtype,
                           device=j.device)
        j = j - sub[:, None]
        if self.n_sharded < grid.dim:
            n_un = torch.tensor(grid.n[self.n_sharded:], dtype=j.dtype,
                                device=j.device)
            j = torch.cat([j[:, :self.n_sharded],
                           torch.remainder(j[:, self.n_sharded:],
                                           n_un[:, None])], dim=1)
        return j, w

    def _combine(self, js, ws):
        """Flattened indices into the halo-extended block (clamped: pad
        slots may fall outside it, with no weight) and tensor-product
        weights -> (f, S)."""
        ext, C = self.ext_shape, js[0].shape[0]
        s = self.support
        lin, wgt = js[0], ws[0]
        for d in range(1, len(js)):
            lin = lin[..., :, None] * ext[d] + js[d].reshape(
                (C,) + (1,) * (lin.dim() - 1) + (s,))
            wgt = wgt[..., :, None] * ws[d].reshape(
                (C,) + (1,) * (wgt.dim() - 1) + (s,))
        S = s ** len(js)
        return (lin.reshape(C, S).clamp(0, math.prod(ext) - 1),
                wgt.reshape(C, S))

    def _stencils(self, b: ShardBuckets, centerings):
        """Every shard's stencils of its filled slots at the layout
        ``b``, one per centering (a MAC component c: offset 0 on axis c,
        1/2 on the others), built once per layout and centerings."""
        key = tuple(centerings)
        if key not in b.memo:
            offs = [_centering_offsets(self.grid, c) for c in centerings]
            needed = sorted({o for off in offs for o in off})

            def build(ctx, Xl):
                Xl = Xl[:b.fill[ctx.index]]
                starts = self._starts(ctx)
                cols = {o: self._axis_stencils(Xl, starts, o)
                        for o in needed}
                return [self._combine(
                    [cols[o][0][:, d] for d, o in enumerate(off)],
                    [cols[o][1][:, d] for d, o in enumerate(off)])
                    for off in offs]

            b.memo[key] = smap(build, self.mesh, b.Xl)
        return b.memo[key]

    # -- public ops ----------------------------------------------------------
    def spread(self, F: torch.Tensor, X: torch.Tensor, centering,
               b: ShardBuckets) -> torch.Tensor:
        """Spread marker values F (N,) -> grid field (global layout)."""
        return self._spread(F[:, None], X, [centering], b)[0]

    def _spread(self, F: torch.Tensor, X: torch.Tensor, centerings,
                b: ShardBuckets, blocks: bool = False):
        """Spread the columns of F (N, C), column c at ``centerings[c]``,
        in one pass: one local scatter per shard into a stacked (C, ext)
        buffer, one halo exchange per sharded axis. ``blocks=True``
        returns each component as :class:`Blocks` of the grid layout
        (whole tensors otherwise); only an overflow's oracle fallback
        assembles the grid."""
        grid, mesh = self.grid, self.mesh
        C = F.shape[1]
        E = math.prod(self.ext_shape)
        inv_vol = 1.0 / math.prod(grid.dx)
        Fb = torch.zeros((self.P * self.cap + 1, C), dtype=F.dtype,
                         device=F.device)
        with interaction.deterministic():
            Fb = Fb.index_put((b.slot_of_marker,), F, accumulate=True)[:-1]
        Fl = shard(mesh, Fb, self.row_spec2)

        def body(ctx, stencils, Fl, wl):
            f = b.fill[ctx.index]
            Fl, wl = Fl[:f], wl[:f]
            lin = torch.cat([l_ + c * E for c, (l_, _) in
                             enumerate(stencils)]).reshape(-1)
            vals = torch.cat([(Fl[:, c] * wl * inv_vol)[:, None] * wg
                              for c, (_, wg) in enumerate(stencils)])
            buf = torch.zeros(C * E, dtype=vals.dtype, device=vals.device)
            buf = interaction.scatter_add(buf, lin, vals.reshape(-1))
            return buf.reshape((C,) + self.ext_shape)

        bufs = smap(body, mesh, self._stencils(b, centerings), Fl, b.wl)
        for d in range(self.n_sharded):
            bufs = halo_add(mesh, bufs, self.axes[d], d + 1, self.w)
        if blocks:
            out = [self.grid_layout(smap(lambda ctx, f: f[c], mesh, bufs))
                   for c in range(C)]
            if not any(b.overflow):
                return tuple(out)
            return tuple(Blocks.cut(mesh, self._spread_overflow(
                o.assemble(F.device), F[:, c], X, cen, b), self.grid_spec)
                for c, (o, cen) in enumerate(zip(out, centerings)))
        out = unshard(mesh, bufs, P(None, *self.grid_spec), device=F.device)
        return tuple(self._spread_overflow(out[c], F[:, c], X, cen, b)
                     for c, cen in enumerate(centerings))

    def grid_layout(self, blocks) -> Blocks:
        """Per-shard interior blocks as a grid leaf."""
        return Blocks(blocks, NamedSharding(self.mesh, self.grid_spec),
                      self.grid.n)

    def _spread_overflow(self, out, F, X, centering, b: ShardBuckets):
        """The overflow fallbacks of one spread component."""
        any_over, exceeded = b.overflow
        if exceeded:
            # exact full fallback carrying the CALLER's weights for every
            # unselected marker (masked markers stay masked)
            w_over = torch.where(b.slot_of_marker < self.P * self.cap,
                                 torch.zeros_like(b.w_all), b.w_all)
            return interaction.spread(F, self.grid, X, centering=centering,
                                      kernel=self.kernel, weights=w_over,
                                      out=out)
        if any_over:
            return interaction.spread(F[b.o_idx], self.grid, X[b.o_idx],
                                      centering=centering,
                                      kernel=self.kernel, weights=b.o_w,
                                      out=out)
        return out

    def interpolate(self, f: torch.Tensor, X: torch.Tensor, centering,
                    b: ShardBuckets) -> torch.Tensor:
        """Interpolate a grid field (global layout) at the markers ->
        (N,)."""
        return self._interpolate((f,), X, [centering], b)[0]

    def _interpolate(self, fs, X: torch.Tensor, centerings,
                     b: ShardBuckets):
        """Interpolate the fields ``fs`` (field c at ``centerings[c]``) in
        one pass: one stacked ghost fill per sharded axis, one local
        gather per shard."""
        mesh, C = self.mesh, len(fs)
        if isinstance(fs[0], Blocks):
            fls = smap(lambda ctx, *c: torch.stack(c), mesh,
                       *[f.blocks for f in fs])
        else:
            fls = shard(mesh, torch.stack(tuple(fs)),
                        P(None, *self.grid_spec))
        for d in range(self.n_sharded):
            fls = ghost_fill(mesh, fls, self.axes[d], d + 1, self.w)
        E = math.prod(self.ext_shape)

        def body(ctx, fl, stencils, wl):
            f = b.fill[ctx.index]
            wl = wl[:f]
            flat = fl.reshape(-1)
            out = torch.zeros((C, self.cap), dtype=fl.dtype,
                              device=fl.device)
            for c, (lin, wgt) in enumerate(stencils):
                vals = flat[lin + c * E]
                out[c, :f] = torch.sum(vals * wgt, dim=-1) * wl
            return out

        Ubs = smap(body, mesh, fls, self._stencils(b, centerings), b.wl)
        Ub = unshard(mesh, Ubs, P(None, self.row_spec[0]), device=X.device)
        return [self._interp_unbucket(Ub[c], fs[c], X, cen, b)
                for c, cen in enumerate(centerings)]

    def _interp_unbucket(self, Ub, f, X, centering, b: ShardBuckets):
        """Slot gather back to global marker order (the sentinel slot
        P*cap gives 0) and the overflow fallbacks."""
        L = Ub.shape[0]
        U = Ub[torch.clamp(b.slot_of_marker, max=L - 1)]
        U = torch.where(b.slot_of_marker < L, U, torch.zeros_like(U))
        any_over, exceeded = b.overflow
        if any_over and isinstance(f, Blocks):
            f = f.assemble(X.device)
        if exceeded:
            w_over = torch.where(b.slot_of_marker < self.P * self.cap,
                                 torch.zeros_like(b.w_all), b.w_all)
            return U + interaction.interpolate(
                f, self.grid, X, centering=centering, kernel=self.kernel,
                weights=w_over)
        if any_over:
            Uo = interaction.interpolate(f, self.grid, X[b.o_idx],
                                         centering=centering,
                                         kernel=self.kernel, weights=b.o_w)
            with interaction.deterministic():
                return U.index_put((b.o_idx,), Uo, accumulate=True)
        return U

    # drop-in FastInteraction-shaped surface (the IBMethod engine seam):
    # the components go through one stacked pass, each component's
    # arithmetic that of its own scalar transfer
    def interpolate_vel(self, u: Vel, X: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        b: Optional[ShardBuckets] = None) -> torch.Tensor:
        if b is None:
            b = self.buckets(X, weights)
        return torch.stack(self._interpolate(
            tuple(u), X, list(range(self.grid.dim)), b), dim=-1)

    def spread_vel(self, F: torch.Tensor, X: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   b: Optional[ShardBuckets] = None,
                   blocks: bool = False) -> Vel:
        if b is None:
            b = self.buckets(X, weights)
        return self._spread(F, X, list(range(self.grid.dim)), b,
                            blocks=blocks)
