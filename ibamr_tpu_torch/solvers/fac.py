"""FAC (Fast Adaptive Composite) multigrid preconditioners for the
composite Poisson systems of the AMR projections (port of
``ibamr_tpu/solvers/fac.py``).

One V-cycle smooths each refined patch with masked red-black sweeps, puts
the restricted patch residual under the patch on its parent level (the
defining FAC move), solves the root level with a
:class:`~ibamr_tpu_torch.solvers.multigrid.PoissonMultigrid` V-cycle, and
brings each correction back up through the quadratic coarse-fine ghost
fill of :mod:`ibamr_tpu_torch.amr`. The cycle has no host read, so it is
a drop-in ``M`` of the composite projections' FGMRES (through their
``precond_factory`` seam).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as nnf

from ibamr_tpu_torch.amr import (FineBox, box_slices, fill_fine_ghosts,
                                 prolong_cc, restrict_cc)
from ibamr_tpu_torch.amr_ins import _box_cc_laplacian as _box_lap
from ibamr_tpu_torch.bc import DomainBC
from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.solvers.multigrid import (PoissonMultigrid,
                                               checkerboard_masks)


def _pad1(e: torch.Tensor) -> torch.Tensor:
    """One layer of zero ghosts on every side."""
    return nnf.pad(e, (1, 1) * e.ndim)


def _smooth_patch(box: FineBox, dx_f, diag_f, masks, box_sl,
                  e: torch.Tensor, r: torch.Tensor,
                  e_parent: Optional[torch.Tensor],
                  sweeps: int) -> torch.Tensor:
    """Masked red-black relaxation of lap e = r on one patch level.
    ``e_parent`` supplies the CF ghosts (None: homogeneous zero ghosts).
    Shared by the two-level and L-level FAC classes."""
    fine_n = box.fine_n

    def ghosted(e):
        if e_parent is None:
            return _pad1(e)
        e_eff = e_parent.clone()
        e_eff[box_sl] = restrict_cc(e)
        return fill_fine_ghosts(e, e_eff, box, ghost=1)

    for _ in range(sweeps):
        for mask in masks:
            lap = _box_lap(ghosted(e), dx_f, fine_n)
            e = e + torch.where(mask, (r - lap) / diag_f,
                                torch.zeros_like(r))
    return e


def _covered_mask(shape, box: FineBox, device) -> torch.Tensor:
    cov = torch.zeros(tuple(shape), dtype=torch.bool, device=device)
    cov[box_slices(box.lo, box.shape)] = True
    return cov


class FACCompositePoisson:
    """FAC preconditioner of the two-level composite Poisson system of
    :class:`ibamr_tpu_torch.amr_ins.CompositeProjection` (residual pair
    ``(r_coarse, r_fine_box)``; covered coarse rows are decoupled identity
    rows at Laplacian-diagonal scale). ``precondition`` applies one
    V(nu, nu)-cycle:

    1. red-black smoothing of the patch correction (zero CF ghosts);
    2. full-domain coarse multigrid V-cycle on the composite residual,
       whose covered region carries the restricted fine residual;
    3. CF interpolation of the coarse correction onto the patch;
    4. post-smoothing with live CF ghosts from the coarse correction.
    """

    graph_safe = True    # no host read: a projection may replay it

    def __init__(self, coarse_shape, bc: DomainBC, dx, box: FineBox,
                 nu: int = 2, mg: Optional[PoissonMultigrid] = None,
                 dtype=torch.float64, device="cuda"):
        self.device = resolve_device(device)
        self.box = box
        self.bc = bc
        self.dx = tuple(float(h) for h in dx)
        self.dx_f = tuple(h / box.ratio for h in self.dx)
        self.nu = int(nu)
        self.box_sl = box_slices(box.lo, box.shape)
        self._covered = _covered_mask(coarse_shape, box, self.device)
        self.mg_c = mg if mg is not None else PoissonMultigrid(
            coarse_shape, bc, self.dx, dtype=dtype, device=self.device)
        self._diag_c = sum(2.0 / h ** 2 for h in self.dx)
        self._diag_f = sum(-2.0 / h ** 2 for h in self.dx_f)
        self._masks = checkerboard_masks(box.fine_n, self.device)

    def _smooth_fine(self, e_f, r_f, e_c, sweeps: int) -> torch.Tensor:
        return _smooth_patch(self.box, self.dx_f, self._diag_f,
                             self._masks, self.box_sl, e_f, r_f, e_c,
                             sweeps)

    def precondition(self, r: Tuple[torch.Tensor, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        r_c, r_f = r
        # 1. patch pre-smoothing (zero ghosts: a correction quantity)
        e_f = self._smooth_fine(torch.zeros_like(r_f), r_f, None, self.nu)
        # 2. the composite residual on the coarse level, the restricted
        #    fine residual underneath the patch
        res_f = r_f - _box_lap(_pad1(e_f), self.dx_f, self.box.fine_n)
        rr_c = r_c.clone()
        rr_c[self.box_sl] = restrict_cc(res_f)
        if self.mg_c.has_nullspace:
            rr_c = rr_c - torch.mean(rr_c)
        e_c = self.mg_c.vcycle(torch.zeros_like(rr_c), rr_c)
        if self.mg_c.has_nullspace:
            e_c = e_c - torch.mean(e_c)
        # 3. the correction carried onto the patch by CF interpolation
        e_f = e_f + prolong_cc(e_c, self.box)
        # 4. post-smoothing with live CF ghosts
        e_f = self._smooth_fine(e_f, r_f, e_c, self.nu)
        # covered coarse rows are decoupled -diag*phi identity rows
        e_c_out = torch.where(self._covered, -r_c / self._diag_c, e_c)
        return (e_c_out, e_f)


class FACMultilevelPoisson:
    """L-level FAC V-cycle for the composite Poisson system of
    :class:`ibamr_tpu_torch.amr_ins_multilevel.MultiLevelCompositeProjection`
    (residual tuple ``(r_0, ..., r_{L-1})``, one nested box per level),
    the arbitrary-depth form of :class:`FACCompositePoisson`. One
    V(nu, nu)-cycle:

    - down, finest to level 1: red-black pre-smoothing of each patch
      correction (zero CF ghosts), the parent's right-hand side taking
      the restricted child residual underneath the patch;
    - bottom: a full-domain multigrid V-cycle on level 0's composite
      residual;
    - up, level 1 to finest: the parent correction CF-interpolated onto
      the patch, then post-smoothing with live CF ghosts.

    ``levels`` come from ``amr_multilevel.build_hierarchy`` (level 0 the
    periodic root).
    """

    graph_safe = True    # no host read: a projection may replay it

    def __init__(self, levels, nu: int = 2,
                 mg: Optional[PoissonMultigrid] = None,
                 dtype=torch.float64, device="cuda"):
        self.device = resolve_device(device)
        self.levels = list(levels)
        self.L = len(self.levels)
        self.nu = int(nu)
        root = self.levels[0].grid
        self.mg_c = mg if mg is not None else PoissonMultigrid(
            tuple(root.n), DomainBC.periodic(root.dim), root.dx,
            dtype=dtype, device=self.device)
        self.dx = [spec.grid.dx for spec in self.levels]
        self.diag = [sum(-2.0 / h ** 2 for h in spec.grid.dx)
                     for spec in self.levels]
        self.box_sl = []
        self.masks = []
        self.covered = []     # per level l < L-1: the child-box mask
        for l in range(1, self.L):
            box = self.levels[l].box
            self.box_sl.append(box_slices(box.lo, box.shape))
            self.masks.append(checkerboard_masks(box.fine_n, self.device))
            self.covered.append(_covered_mask(self.levels[l - 1].grid.n,
                                              box, self.device))

    def _smooth(self, l: int, e, r, e_parent, sweeps: int) -> torch.Tensor:
        return _smooth_patch(self.levels[l].box, self.dx[l], self.diag[l],
                             self.masks[l - 1], self.box_sl[l - 1], e, r,
                             e_parent, sweeps)

    def precondition(self, rs):
        # the identity rows echo the original residual; the down pass
        # overwrites the covered regions with child residuals
        orig = tuple(rs)
        rs = list(rs)
        es = [None] * self.L

        # down: smooth each patch, push its residual under the parent
        for l in range(self.L - 1, 0, -1):
            e = self._smooth(l, torch.zeros_like(rs[l]), rs[l], None,
                             self.nu)
            res = rs[l] - _box_lap(_pad1(e), self.dx[l],
                                   self.levels[l].box.fine_n)
            parent = rs[l - 1].clone()
            parent[self.box_sl[l - 1]] = restrict_cc(res)
            rs[l - 1] = parent
            es[l] = e

        # bottom: full-domain multigrid on the root composite residual
        rr = rs[0]
        if self.mg_c.has_nullspace:
            rr = rr - torch.mean(rr)
        e0 = self.mg_c.vcycle(torch.zeros_like(rr), rr)
        if self.mg_c.has_nullspace:
            e0 = e0 - torch.mean(e0)
        es[0] = e0

        # up: prolong the parent correction, post-smooth with live ghosts
        for l in range(1, self.L):
            es[l] = es[l] + prolong_cc(es[l - 1], self.levels[l].box)
            es[l] = self._smooth(l, es[l], rs[l], es[l - 1], self.nu)

        # covered parent rows are decoupled -diag*phi identity rows of the
        # composite operator
        out = []
        for l in range(self.L):
            if l + 1 < self.L:
                out.append(torch.where(self.covered[l],
                                       orig[l] / self.diag[l], es[l]))
            else:
                out.append(es[l])
        return tuple(out)
