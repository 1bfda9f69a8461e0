"""Geometric multigrid for cell-centered Poisson/Helmholtz problems under
the Robin BCs of ``bc.py`` (port of ``ibamr_tpu/solvers/multigrid.py``).

Red-black smoothing is two masked Jacobi half-sweeps per pass (the full
residual once per color, the update through a checkerboard mask); BCs
enter through the ghost fill and an exactly assembled diagonal (the
ghost reflection coefficient folds into the boundary-cell diagonal);
restriction is the 2^d block mean and prolongation BC-aware piecewise
linear. Variable coefficients ``alpha Q + div(D grad Q)`` rediscretize on
every level with the block-mean coarsened D. The outer iteration reads
its residual norm on the host once per V-cycle.

Each axis's face coefficients are a pair of cell-shaped tensors (the
lower and the upper face of every cell), and the wall cells and the
red-black colours are marked through ``ops/stencils.wall_boundary_masks``
and :func:`checkerboard_masks` by global index. So the V-cycle also
runs on block-resident leaves (``parallel.spmd.Blocks``, when ``D`` is
one): the operator is a width-1 halo stencil whose wall ghosts are the
ghost fill's, restriction is local to a block (its extent is even),
prolongation takes its ghosts by the halo pass, and every update is
cell by cell -- bitwise the whole-tensor V-cycle. A level whose extent
does not divide over its mesh axis, or whose blocks would be thinner
than :data:`MIN_BLOCK` cells, is not cut: it and every coarser level run
whole on the mesh's first device. The finer level's blocks are
restricted in place and only the coarse level is gathered; the coarse
correction is scattered back and prolonged on blocks (``Blocks.gather``
/ ``Blocks.scatter``). Only a level whose blocks have an odd extent is
gathered before its restriction -- at the finest level, a whole-grid
layout (``Blocks.assemble`` / ``Blocks.cut``), which the census counts.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ibamr_tpu_torch.bc import (AxisBC, DomainBC, _slab, fill_ghosts_cc,
                                ghost_reflect_coeff, ghost_rule_cc)
from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.ops.stencils import wall_boundary_masks
from ibamr_tpu_torch.parallel.spmd import (Blocks, ghost_fill,
                                           global_positions, halo_apply,
                                           halo_pad, smap, split_dims)


def restrict_cc(fine: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    """Conservative block-mean coarsening of cell data (the port's own
    copy of ``ibamr_tpu/amr.py::restrict_cc``); on Blocks, each block
    coarsened locally (every block extent is a multiple of ``ratio``)."""
    if isinstance(fine, Blocks):
        return Blocks(smap(lambda ctx, b: restrict_cc(b, ratio), fine.mesh,
                           fine.blocks), fine.sharding,
                      [s // ratio for s in fine.shape])
    shape = []
    for d in range(fine.ndim):
        assert fine.shape[d] % ratio == 0
        shape += [fine.shape[d] // ratio, ratio]
    arr = fine.reshape(shape)
    for d in reversed(range(fine.ndim)):
        arr = arr.mean(dim=2 * d + 1)
    return arr


def checkerboard_masks(shape, device=None) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(red, black) boolean checkerboard masks for red-black sweeps,
    coloured by global index (a block at an odd offset keeps the whole
    grid's colours)."""
    grids = torch.meshgrid(*[global_positions(s, d, device)[0]
                             for d, s in enumerate(shape)], indexing="ij")
    parity = sum(grids) % 2
    return parity == 0, parity == 1


def homogeneous_bc(bc: DomainBC) -> DomainBC:
    """The same BC kinds with zero boundary data."""
    return DomainBC(axes=tuple(
        AxisBC(dataclasses.replace(ax.lo, value=0.0),
               dataclasses.replace(ax.hi, value=0.0)) for ax in bc.axes))


def _nullspace(bc: DomainBC) -> bool:
    """True when the Poisson operator has the constant nullspace (every
    axis periodic or pure Neumann)."""
    for ax in bc.axes:
        if ax.periodic:
            continue
        for s in (ax.lo, ax.hi):
            if s.coeffs()[0] != 0.0:
                return False
    return True


class _Level(NamedTuple):
    shape: Tuple[int, ...]
    dx: Tuple[float, ...]
    diag: torch.Tensor                     # operator diagonal with BCs
    # per axis (lower, upper) face diffusivity of every cell, or None
    D_face: Optional[Tuple[Tuple[torch.Tensor, torch.Tensor], ...]]
    blocks: bool = False                   # the level is in Blocks
    # Blocks levels: each shard's D_face leaves and diagonal padded by
    # one ghost layer (the operator's and the smoother's per-shard
    # coefficients), and its (red, black) masks padded likewise
    D_pad: Optional[list] = None
    masks_pad: Optional[list] = None


def _face_coeffs(D: torch.Tensor, bc: DomainBC):
    """Arithmetic-mean face diffusivities as a (lower, upper) pair of
    cell-shaped tensors per axis; a wall face takes the one-sided cell
    value, a periodic one the wrap mean."""
    out = []
    for d in range(D.ndim):
        lo = 0.5 * (D + torch.roll(D, 1, d))
        hi = torch.roll(lo, -1, d)
        if not bc.axes[d].periodic:
            is_lo, is_hi = wall_boundary_masks(D.shape, d, D.device)
            edge = 0.5 * (D + D)
            lo = torch.where(is_lo, edge, lo)
            hi = torch.where(is_hi, edge, hi)
        out.append((lo, hi))
    return tuple(out)


def _apply_op(Q: torch.Tensor, dx, D_face, bc: DomainBC, alpha: float,
              beta: float, bdry_data: Optional[dict] = None) -> torch.Tensor:
    """``alpha Q + beta lap Q`` (constant coefficient) or
    ``alpha Q + beta div(D grad Q)`` in conservative face-flux form."""
    dim = Q.ndim
    G = fill_ghosts_cc(Q, bc, dx, bdry_data=bdry_data)
    center = tuple(slice(1, -1) for _ in range(dim))
    out = alpha * Q
    for d in range(dim):
        lo = list(center)
        hi = list(center)
        lo[d] = slice(0, -2)
        hi[d] = slice(2, None)
        if D_face is None:
            out = out + beta * (G[tuple(lo)] - 2.0 * Q + G[tuple(hi)]) \
                / dx[d] ** 2
        else:
            Df_lo, Df_hi = D_face[d]
            flux_hi = Df_hi * (G[tuple(hi)] - Q) / dx[d]
            flux_lo = Df_lo * (Q - G[tuple(lo)]) / dx[d]
            out = out + beta * (flux_hi - flux_lo) / dx[d]
    return out


def _assemble_diag(shape, bc: DomainBC, dx, alpha: float, beta: float,
                   D_face, dtype, device) -> torch.Tensor:
    """The exact operator diagonal, with the ghost reflection of each
    boundary cell folded in."""
    dim = len(shape)
    if D_face is None:
        diag = torch.full(shape, alpha + beta * sum(-2.0 / h ** 2
                                                    for h in dx),
                          dtype=dtype, device=device)
    else:
        diag = torch.full(shape, alpha, dtype=dtype, device=device)
    for d in range(dim):
        if D_face is not None:
            Df_lo, Df_hi = D_face[d]
            diag = diag - beta * (Df_lo + Df_hi) / dx[d] ** 2
        ax = bc.axes[d]
        if ax.periodic:
            continue
        masks = wall_boundary_masks(shape, d, device)
        for s, side in ((0, ax.lo), (1, ax.hi)):
            c = ghost_reflect_coeff(side, dx[d])
            if D_face is None:
                term = beta * c / dx[d] ** 2
            else:
                term = beta * c * D_face[d][s] / dx[d] ** 2
            diag = torch.where(masks[s], diag + term, diag)
    return diag


def _level_coeffs(D, bc: DomainBC, dx, alpha: float, beta: float):
    """(D_face, diag) of a level from its cell diffusivity ``D``."""
    D_face = _face_coeffs(D, bc)
    return D_face, _assemble_diag(tuple(D.shape), bc, dx, alpha, beta,
                                  D_face, D.dtype, D.device)


def _flat_pairs(D_face):
    return tuple(t for pair in D_face for t in pair)


def _pairs(flat):
    return tuple((flat[2 * d], flat[2 * d + 1])
                 for d in range(len(flat) // 2))


def restrict_full_weighting(r: torch.Tensor) -> torch.Tensor:
    """2^d block mean (the cell-centered full-weighting restriction)."""
    return restrict_cc(r, ratio=2)


def _axis_ghost_hom(C: torch.Tensor, axis: int, ax: AxisBC,
                    h: float) -> torch.Tensor:
    """One ghost layer along ONE axis under homogeneous BCs."""
    n = C.shape[axis]
    if ax.periodic:
        lo_g, hi_g = _slab(C, axis, n - 1, n), _slab(C, axis, 0, 1)
    else:
        lo_g = ghost_reflect_coeff(ax.lo, h) * _slab(C, axis, 0, 1)
        hi_g = ghost_reflect_coeff(ax.hi, h) * _slab(C, axis, n - 1, n)
    return torch.cat([lo_g, C, hi_g], dim=axis)


def _prolong_axis(G: torch.Tensor, d: int) -> torch.Tensor:
    """The ratio-2 linear children along axis ``d`` of data padded by one
    ghost layer there."""
    n = G.shape[d]
    mid = _slab(G, d, 1, n - 1)
    left = 0.75 * mid + 0.25 * _slab(G, d, 0, n - 2)
    right = 0.75 * mid + 0.25 * _slab(G, d, 2, n)
    stacked = torch.stack([left, right], dim=d + 1)
    new_shape = list(mid.shape)
    new_shape[d] = mid.shape[d] * 2
    return stacked.reshape(new_shape)


def prolong_linear(C: torch.Tensor, bc: DomainBC,
                   dx_coarse) -> torch.Tensor:
    """BC-aware piecewise-linear prolongation (cell-centered, ratio 2):
    the 3/4-1/4 axis-separable interpolants of each parent and its
    neighbor toward the child, homogeneous-BC ghosts beyond walls. On
    Blocks the ghosts along a split axis come by the halo pass (at a
    wall, the edge shard's homogeneous-BC ghost)."""
    if isinstance(C, Blocks):
        return _prolong_blocks(C, bc, dx_coarse)
    out = C
    for d in range(C.ndim):
        out = _prolong_axis(_axis_ghost_hom(out, d, bc.axes[d],
                                            dx_coarse[d]), d)
    return out


def _prolong_blocks(C: Blocks, bc: DomainBC, dx_coarse) -> Blocks:
    mesh = C.mesh
    split = dict(split_dims(C.sharding, C.ndim))
    out = C.blocks
    shape = list(C.shape)
    for d in range(C.ndim):
        ax, h = bc.axes[d], dx_coarse[d]
        if d not in split:
            G = smap(lambda ctx, c: _axis_ghost_hom(c, d, ax, h), mesh, out)
        else:
            edge = None
            if not ax.periodic:
                def edge(side, ring, own, ax=ax, h=h, d=d):
                    n = own.shape[d]
                    if side == 0:
                        return ghost_reflect_coeff(ax.lo, h) * _slab(
                            own, d, 0, 1)
                    return ghost_reflect_coeff(ax.hi, h) * _slab(
                        own, d, n - 1, n)
            G = ghost_fill(mesh, out, split[d], d, 1, edge)
        out = smap(lambda ctx, g: _prolong_axis(g, d), mesh, G)
        shape[d] *= 2
    return Blocks(out, C.sharding, shape)


class MGSolveResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: torch.Tensor
    converged: torch.Tensor


# a Blocks hierarchy runs whole on the first shard from the first level
# whose blocks would be thinner than this many cells: there the halo
# passes and the per-block launches of a level's sweeps cost more than
# its work, while the levels of larger blocks (a grid past one card)
# stay spread over the shards. tools/vc_timing.py on H100s: the dam
# break's level of 32x24 blocks on four cards, and every measured level
# of blocks of 16 to 32 cells, ran slower in blocks than whole
MIN_BLOCK = 64


class PoissonMultigrid:
    """Geometric multigrid for ``alpha Q + beta lap Q = f`` (D=None) or
    ``alpha Q + div(D grad Q) = f`` (cell-centered D) under the full
    Robin BC menu. A ``D`` in Blocks builds the hierarchy on its mesh,
    and :meth:`vcycle` then takes and returns Blocks of that layout: a
    level is cut into blocks while its extent divides over the mesh
    and every block keeps at least :data:`MIN_BLOCK` cells along each
    split axis; the first coarser level and every level below run whole
    on the first shard (the coarsest level alone runs ``nu_coarse``
    sweeps)."""

    def __init__(self, shape: Sequence[int], bc: DomainBC,
                 dx: Sequence[float], alpha: float = 0.0, beta: float = 1.0,
                 D: Optional[torch.Tensor] = None, nu_pre: int = 2,
                 nu_post: int = 2, nu_coarse: int = 40, min_cells: int = 4,
                 dtype=torch.float64, device="cuda"):
        self.bc = bc
        self.bc_hom = homogeneous_bc(bc)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.nu_pre = nu_pre
        self.nu_post = nu_post
        self.nu_coarse = nu_coarse
        self.has_nullspace = (alpha == 0.0) and _nullspace(bc)
        self.mesh = D.mesh if isinstance(D, Blocks) else None
        self.device = (D.device if self.mesh is not None
                       else resolve_device(device))

        shape = tuple(int(v) for v in shape)
        dx = tuple(float(v) for v in dx)
        self.levels: List[_Level] = []
        self._masks = []
        Dl = D
        while True:
            if isinstance(Dl, Blocks):
                self.levels.append(self._block_level(Dl, dx))
            else:
                D_face = None if Dl is None else _face_coeffs(Dl, bc)
                diag = _assemble_diag(shape, bc, dx, self.alpha, self.beta,
                                      D_face, dtype, self.device)
                self.levels.append(_Level(shape=shape, dx=dx, diag=diag,
                                          D_face=D_face))
                self._masks.append(checkerboard_masks(shape, self.device))
            if any(s % 2 != 0 or s // 2 < min_cells for s in shape):
                break
            shape = tuple(s // 2 for s in shape)
            dx = tuple(h * 2.0 for h in dx)
            if isinstance(Dl, Blocks) and not self._cuttable(Dl, shape):
                Dl = self._restrict_gathered(Dl, len(self.levels) - 1)
            elif Dl is not None:
                Dl = restrict_full_weighting(Dl)

    @staticmethod
    def _cuttable(x: Blocks, shape) -> bool:
        """A level of ``shape`` splits into whole blocks of at least
        :data:`MIN_BLOCK` (and one) cells under ``x``'s layout."""
        for d, axis in split_dims(x.sharding, len(shape)):
            p = x.mesh.axis_size(axis)
            if shape[d] % p or shape[d] // p < max(1, MIN_BLOCK):
                return False
        return True

    @staticmethod
    def _even_blocks(x: Blocks) -> bool:
        """Every block of ``x`` has an even extent along each split axis
        (so it restricts in place, and the coarse level divides)."""
        return all(x.blocks[0].shape[d] % 2 == 0
                   for d, _ in split_dims(x.sharding, x.ndim))

    def _restrict_gathered(self, x: Blocks, li: int) -> torch.Tensor:
        """Level ``li``'s Blocks ``x`` restricted, whole on the first
        shard: the blocks restricted in place and the coarse level
        gathered; blocks of an odd extent gathered first (at the finest
        level, a whole-grid layout)."""
        if self._even_blocks(x):
            return restrict_full_weighting(x).gather()
        return restrict_full_weighting(x.assemble() if li == 0
                                       else x.gather())

    def _prolong_scattered(self, ec: torch.Tensor, li: int,
                           like: Blocks) -> Blocks:
        """The whole coarse correction ``ec`` of level ``li + 1``
        prolonged into level ``li``'s Blocks ``like`` (the inverse of
        :meth:`_restrict_gathered`)."""
        dxc = self.levels[li + 1].dx
        if self._even_blocks(like):
            return prolong_linear(Blocks.scatter(self.mesh, ec, like.spec),
                                  self.bc_hom, dxc)
        e = prolong_linear(ec, self.bc_hom, dxc)
        if li == 0:
            return Blocks.cut(self.mesh, e, like.spec)
        return Blocks.scatter(self.mesh, e, like.spec)

    def _block_level(self, D: Blocks, dx) -> _Level:
        """A level in Blocks: the face pairs and the diagonal as one
        width-1 halo stencil of ``D``, the face pairs padded once for
        the operator, the colours by global index."""
        def coeffs(Dp):
            D_face, diag = _level_coeffs(Dp, self.bc, dx, self.alpha,
                                         self.beta)
            return (*_flat_pairs(D_face), diag)

        *flat, diag = halo_apply(D.mesh, D, coeffs, 1)
        masks = halo_apply(
            D.mesh, diag, lambda q: checkerboard_masks(q.shape, q.device),
            0)
        self._masks.append(masks)
        return _Level(shape=tuple(D.shape), dx=dx, diag=diag,
                      D_face=_pairs(flat), blocks=True,
                      D_pad=halo_pad(D.mesh, (*flat, diag), 1),
                      masks_pad=halo_pad(D.mesh, masks, 1))

    def _block_bcs(self, Q: Blocks, lv: _Level, bc: DomainBC):
        """(the halo pass's wall rules, the body's BCs) of the operator on
        a Blocks level: the edge shards' wall ghosts are the fill's; on
        the padded block the body fills a split axis by the wrap, which
        only the cropped ghost cells read."""
        split = dict(split_dims(Q.sharding, Q.ndim))
        walls = {d: ghost_rule_cc(ax, lv.dx[d])
                 for d, ax in enumerate(bc.axes)
                 if not ax.periodic and d in split}
        body_bc = DomainBC(axes=tuple(AxisBC() if d in split else ax
                                      for d, ax in enumerate(bc.axes)))
        return walls, body_bc

    def _op(self, Q, li: int, bdry_data=None, hom=True):
        bc = self.bc_hom if hom else self.bc
        lv = self.levels[li]
        if lv.blocks:
            walls, body_bc = self._block_bcs(Q, lv, bc)
            nf = 2 * len(lv.shape)
            return halo_apply(
                self.mesh, Q,
                lambda q, *ex: _apply_op(q, lv.dx, _pairs(ex[:nf]), body_bc,
                                         self.alpha, self.beta),
                1, [walls], extra=lv.D_pad)
        return _apply_op(Q, lv.dx, lv.D_face, bc, self.alpha, self.beta,
                         bdry_data=bdry_data)

    def _smooth(self, Q, f, li: int, sweeps: int, reverse: bool = False):
        """Red-black relaxation; ``reverse`` sweeps black, then red (which
        makes the V-cycle a symmetric operator)."""
        if self.levels[li].blocks:
            return self._smooth_blocks(Q, f, li, sweeps, reverse)
        red, black = self._masks[li]
        diag = self.levels[li].diag
        order = (black, red) if reverse else (red, black)
        for _ in range(sweeps):
            for mask in order:
                r = f - self._op(Q, li)
                Q = Q + torch.where(mask, r / diag, torch.zeros_like(r))
        return Q

    def _smooth_blocks(self, Q: Blocks, f: Blocks, li: int, sweeps: int,
                       reverse: bool):
        """:meth:`_smooth` on a Blocks level: each half-sweep is one halo
        pass of ``Q`` whose body is the whole half-sweep (the residual
        and the masked update, the same operations cell by cell) on the
        padded block, with the coefficients, the diagonal, the masks and
        ``f`` padded once."""
        lv = self.levels[li]
        walls, body_bc = self._block_bcs(Q, lv, self.bc_hom)
        nf = 2 * len(lv.shape)
        f_pad = halo_pad(self.mesh, f, 1)

        def half(q, *ex):
            r = ex[nf + 1] - _apply_op(q, lv.dx, _pairs(ex[:nf]), body_bc,
                                       self.alpha, self.beta)
            return q + torch.where(ex[nf + 2], r / ex[nf],
                                   torch.zeros_like(r))

        extra = [[(*lv.D_pad[i], f_pad[i][0], lv.masks_pad[i][c])
                  for i in range(self.mesh.size)] for c in (0, 1)]
        order = (1, 0) if reverse else (0, 1)
        for _ in range(sweeps):
            for c in order:
                Q = halo_apply(self.mesh, Q, half, 1, [walls],
                               extra=extra[c])
        return Q

    def _vcycle(self, Q, f, li: int):
        if li == len(self.levels) - 1:
            half = self.nu_coarse // 2
            Q = self._smooth(Q, f, li, half)
            return self._smooth(Q, f, li, self.nu_coarse - half,
                                reverse=True)
        Q = self._smooth(Q, f, li, self.nu_pre)
        r = f - self._op(Q, li)
        if self.levels[li].blocks and not self.levels[li + 1].blocks:
            rc = self._restrict_gathered(r, li)
            ec = self._vcycle(torch.zeros_like(rc), rc, li + 1)
            e = self._prolong_scattered(ec, li, Q)
        else:
            rc = restrict_full_weighting(r)
            ec = self._vcycle(torch.zeros_like(rc), rc, li + 1)
            e = prolong_linear(ec, self.bc_hom, self.levels[li + 1].dx)
        Q = Q + e
        return self._smooth(Q, f, li, self.nu_post, reverse=True)

    def vcycle(self, Q: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        """One homogeneous-BC V-cycle (use as a preconditioner); Blocks
        in and out on a hierarchy built on a mesh."""
        return self._vcycle(Q, f, 0)

    def solve(self, f: torch.Tensor, x0: Optional[torch.Tensor] = None,
              tol: float = 1e-8, maxiter: int = 50,
              bdry_data: Optional[dict] = None) -> MGSolveResult:
        """V-cycles to ``|r| <= tol |f|``; inhomogeneous boundary data is
        folded into the right-hand side once, so the cycle runs
        homogeneous."""
        if x0 is None:
            x0 = torch.zeros_like(f)
        bc_terms = self._op(torch.zeros_like(f), 0, bdry_data=bdry_data,
                            hom=False)
        f_eff = f - bc_terms
        if self.has_nullspace:
            f_eff = f_eff - torch.mean(f_eff)
        stop = tol * torch.clamp(torch.linalg.vector_norm(f_eff), min=1e-30)
        Q = x0
        rn = torch.linalg.vector_norm(f_eff - self._op(x0, 0))
        it = 0
        while it < maxiter and bool(rn > stop):
            Q = self._vcycle(Q, f_eff, 0)
            if self.has_nullspace:
                Q = Q - torch.mean(Q)
            rn = torch.linalg.vector_norm(f_eff - self._op(Q, 0))
            it += 1
        return MGSolveResult(x=Q, iters=it, resnorm=rn, converged=rn <= stop)
