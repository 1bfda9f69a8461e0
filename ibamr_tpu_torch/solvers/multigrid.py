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
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ibamr_tpu_torch.bc import (AxisBC, DomainBC, _edge_pad, _slab,
                                fill_ghosts_cc, ghost_reflect_coeff)
from ibamr_tpu_torch.device import resolve_device


def restrict_cc(fine: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    """Conservative block-mean coarsening of cell data (the port's own
    copy of ``ibamr_tpu/amr.py::restrict_cc``)."""
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
    """(red, black) boolean checkerboard masks for red-black sweeps."""
    grids = torch.meshgrid(*[torch.arange(s, device=device) for s in shape],
                           indexing="ij")
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
    D_face: Optional[Tuple[torch.Tensor, ...]]  # face diffusivity, or None


def _face_coeffs(D: torch.Tensor, bc: DomainBC) -> Tuple[torch.Tensor, ...]:
    """Arithmetic-mean face diffusivities (shape n + e_d per axis);
    boundary faces take the one-sided cell value, periodic ones the wrap
    mean."""
    out = []
    for d in range(D.ndim):
        if bc.axes[d].periodic:
            Dm = 0.5 * (D + torch.roll(D, 1, d))
            Df = torch.cat([Dm, _slab(Dm, d, 0, 1)], dim=d)
        else:
            pads = [(0, 0)] * D.ndim
            pads[d] = (1, 1)
            Dg = _edge_pad(D, pads)
            n = Dg.shape[d]
            Df = 0.5 * (_slab(Dg, d, 0, n - 1) + _slab(Dg, d, 1, n))
        out.append(Df)
    return tuple(out)


def _apply_op(Q: torch.Tensor, level: _Level, bc: DomainBC, alpha: float,
              beta: float, bdry_data: Optional[dict] = None) -> torch.Tensor:
    """``alpha Q + beta lap Q`` (constant coefficient) or
    ``alpha Q + beta div(D grad Q)`` in conservative face-flux form."""
    dim = Q.ndim
    dx = level.dx
    G = fill_ghosts_cc(Q, bc, dx, bdry_data=bdry_data)
    center = tuple(slice(1, -1) for _ in range(dim))
    out = alpha * Q
    for d in range(dim):
        lo = list(center)
        hi = list(center)
        lo[d] = slice(0, -2)
        hi[d] = slice(2, None)
        if level.D_face is None:
            out = out + beta * (G[tuple(lo)] - 2.0 * Q + G[tuple(hi)]) \
                / dx[d] ** 2
        else:
            Df = level.D_face[d]
            n = Df.shape[d]
            flux_hi = _slab(Df, d, 1, n) * (G[tuple(hi)] - Q) / dx[d]
            flux_lo = _slab(Df, d, 0, n - 1) * (Q - G[tuple(lo)]) / dx[d]
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
        for d in range(dim):
            ax = bc.axes[d]
            if ax.periodic:
                continue
            for s, side in ((0, ax.lo), (1, ax.hi)):
                c = ghost_reflect_coeff(side, dx[d])
                idx = [slice(None)] * dim
                idx[d] = slice(0, 1) if s == 0 else slice(-1, None)
                diag[tuple(idx)] += beta * c / dx[d] ** 2
        return diag
    diag = torch.full(shape, alpha, dtype=dtype, device=device)
    for d in range(dim):
        Df = D_face[d]
        n = Df.shape[d]
        diag = diag - beta * (_slab(Df, d, 0, n - 1) + _slab(Df, d, 1, n)) \
            / dx[d] ** 2
        ax = bc.axes[d]
        if ax.periodic:
            continue
        for s, side in ((0, ax.lo), (1, ax.hi)):
            c = ghost_reflect_coeff(side, dx[d])
            idx = [slice(None)] * dim
            idx[d] = slice(0, 1) if s == 0 else slice(-1, None)
            diag[tuple(idx)] += beta * c * Df[tuple(idx)] / dx[d] ** 2
    return diag


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


def prolong_linear(C: torch.Tensor, bc: DomainBC,
                   dx_coarse) -> torch.Tensor:
    """BC-aware piecewise-linear prolongation (cell-centered, ratio 2):
    the 3/4-1/4 axis-separable interpolants of each parent and its
    neighbor toward the child, homogeneous-BC ghosts beyond walls."""
    out = C
    for d in range(C.ndim):
        G = _axis_ghost_hom(out, d, bc.axes[d], dx_coarse[d])
        n = G.shape[d]
        mid = _slab(G, d, 1, n - 1)
        left = 0.75 * mid + 0.25 * _slab(G, d, 0, n - 2)
        right = 0.75 * mid + 0.25 * _slab(G, d, 2, n)
        stacked = torch.stack([left, right], dim=d + 1)
        new_shape = list(out.shape)
        new_shape[d] = out.shape[d] * 2
        out = stacked.reshape(new_shape)
    return out


class MGSolveResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: torch.Tensor
    converged: torch.Tensor


class PoissonMultigrid:
    """Geometric multigrid for ``alpha Q + beta lap Q = f`` (D=None) or
    ``alpha Q + div(D grad Q) = f`` (cell-centered D) under the full
    Robin BC menu."""

    def __init__(self, shape: Sequence[int], bc: DomainBC,
                 dx: Sequence[float], alpha: float = 0.0, beta: float = 1.0,
                 D: Optional[torch.Tensor] = None, nu_pre: int = 2,
                 nu_post: int = 2, nu_coarse: int = 40, min_cells: int = 4,
                 dtype=torch.float64, device="cuda"):
        self.bc = bc
        self.bc_hom = homogeneous_bc(bc)
        self.device = resolve_device(device)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.nu_pre = nu_pre
        self.nu_post = nu_post
        self.nu_coarse = nu_coarse
        self.has_nullspace = (alpha == 0.0) and _nullspace(bc)

        shape = tuple(int(v) for v in shape)
        dx = tuple(float(v) for v in dx)
        self.levels: List[_Level] = []
        Dl = D
        while True:
            D_face = None if Dl is None else _face_coeffs(Dl, bc)
            diag = _assemble_diag(shape, bc, dx, self.alpha, self.beta,
                                  D_face, dtype, self.device)
            self.levels.append(_Level(shape=shape, dx=dx, diag=diag,
                                      D_face=D_face))
            if any(s % 2 != 0 or s // 2 < min_cells for s in shape):
                break
            shape = tuple(s // 2 for s in shape)
            dx = tuple(h * 2.0 for h in dx)
            if Dl is not None:
                Dl = restrict_full_weighting(Dl)
        self._masks = [checkerboard_masks(lv.shape, self.device)
                       for lv in self.levels]

    def _op(self, Q, li: int, bdry_data=None, hom=True):
        bc = self.bc_hom if hom else self.bc
        return _apply_op(Q, self.levels[li], bc, self.alpha, self.beta,
                         bdry_data=bdry_data)

    def _smooth(self, Q, f, li: int, sweeps: int, reverse: bool = False):
        """Red-black relaxation; ``reverse`` sweeps black, then red (which
        makes the V-cycle a symmetric operator)."""
        red, black = self._masks[li]
        diag = self.levels[li].diag
        order = (black, red) if reverse else (red, black)
        for _ in range(sweeps):
            for mask in order:
                r = f - self._op(Q, li)
                Q = Q + torch.where(mask, r / diag, torch.zeros_like(r))
        return Q

    def _vcycle(self, Q, f, li: int):
        if li == len(self.levels) - 1:
            half = self.nu_coarse // 2
            Q = self._smooth(Q, f, li, half)
            return self._smooth(Q, f, li, self.nu_coarse - half,
                                reverse=True)
        Q = self._smooth(Q, f, li, self.nu_pre)
        r = f - self._op(Q, li)
        rc = restrict_full_weighting(r)
        ec = self._vcycle(torch.zeros_like(rc), rc, li + 1)
        Q = Q + prolong_linear(ec, self.bc_hom, self.levels[li + 1].dx)
        return self._smooth(Q, f, li, self.nu_post, reverse=True)

    def vcycle(self, Q: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        """One homogeneous-BC V-cycle (use as a preconditioner)."""
        return self._vcycle(Q, f, 0)

    def solve(self, f: torch.Tensor, x0: Optional[torch.Tensor] = None,
              tol: float = 1e-8, maxiter: int = 50,
              bdry_data: Optional[dict] = None) -> MGSolveResult:
        """V-cycles to ``|r| <= tol |f|``; inhomogeneous boundary data is
        folded into the right-hand side once, so the cycle runs
        homogeneous."""
        if x0 is None:
            x0 = torch.zeros_like(f)
        bc_terms = _apply_op(torch.zeros_like(f), self.levels[0], self.bc,
                             self.alpha, self.beta, bdry_data=bdry_data)
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
