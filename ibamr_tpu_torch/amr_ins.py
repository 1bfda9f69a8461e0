"""Two-level composite incompressible Navier-Stokes, and IB on it (port of
``ibamr_tpu/amr_ins.py``).

Scheme (one static FineBox, refinement ratio 2, shared dt):

1. explicit convective + viscous RHS per level; the fine box works on
   ghost-extended tensors whose shell is quadratically interpolated from
   the coarse level at MAC positions;
2. the covered coarse region slaved to the restriction of the fine
   predictor (coincident-face mean, flux preserving);
3. composite projection: one FGMRES solve over the pair (phi_coarse,
   phi_fine) of the composite Poisson operator. Covered coarse cells
   carry the slaving identity, uncovered cells the 5/7-point Laplacian
   with the coarse flux through each coarse-fine interface face replaced
   by the transverse mean of the fine-side fluxes, and fine cells the
   box Laplacian with CF-interpolated ghosts. The preconditioner is the
   periodic FFT inverse (coarse) and the fast-diagonalization Dirichlet
   inverse (fine box);
4. both levels corrected with consistent gradients, and covered coarse
   faces synchronized to the restricted fine faces.

``TwoLevelIBINS`` keeps the structure inside the fine box: spread at fine
resolution, the force restricted to the coarse level, marker velocities
interpolated from the fine level. A moving window is a new box: the
host-side regrid rebuilds the integrator between chunks of steps. The
steps are eager PyTorch; the FGMRES reads its residual to the host once
per restart. On a CUDA device the composite operator and the default
preconditioner (some 200 small kernels an FGMRES iteration, launched one
by one) are each captured once per box as a CUDA graph and replayed, as
``solvers/stokes.py`` does: the same kernels on the same data, so the
projection is bitwise the eager one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.amr import (FineBox, box_mac_divergence, box_slices,
                                 cached_plans, _apply_plan, _interp_plan,
                                 fill_fine_ghosts, prolong_mac_div_preserving,
                                 restrict_cc, restrict_mac)
from ibamr_tpu_torch.bc import DomainBC, dirichlet_axis
from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops import stencils
from ibamr_tpu_torch.ops.convection import convective_rate
from ibamr_tpu_torch.solvers import fft
from ibamr_tpu_torch.solvers.escalation import record_solve_stats
from ibamr_tpu_torch.solvers.fastdiag import FastDiagSolver
from ibamr_tpu_torch.solvers.krylov import fgmres_flat, flat_operators
from ibamr_tpu_torch.utils.cuda_graph import Graphed
from ibamr_tpu_torch.utils.tree import ravel

Vel = Tuple[torch.Tensor, ...]


# -- box-local MAC helpers (component d has shape fine_n + e_d) ---------------

def _shift(a, axis, s, n):
    return stencils.axis_slice(a, axis, s, s + n)


def _mac_ghost_plan(box: FineBox, ghost: int, d: int, coarse_shape,
                    dtype, device):
    """Gather plan of the whole ghost-extended box component ``d`` from
    the coarse MAC component ``d``."""
    def build():
        g, r, dim = ghost, box.ratio, box.dim
        axes = []
        for a in range(dim):
            i = torch.arange(-g, box.fine_n[a] + (1 if a == d else 0) + g,
                             dtype=dtype, device=device)
            # fine face i sits at coarse face index lo + i/r; a fine cell
            # center at coarse cell-center index lo + (i + 0.5)/r - 0.5
            axes.append(box.lo[a] + i / r if a == d
                        else box.lo[a] + (i + 0.5) / r - 0.5)
        pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
        lin, wgt = _interp_plan(coarse_shape, pts, order=2)
        return (lin, wgt, tuple(pts.shape[:-1]))

    return cached_plans(("mac", box, ghost, d, tuple(coarse_shape), dtype,
                         str(device)), build)


def fill_fine_ghosts_mac(uf: Vel, uc: Vel, box: FineBox,
                         ghost: int) -> Vel:
    """Ghost-extend fine-box MAC components with quadratic CF
    interpolation of the coarse MAC field at the fine face positions
    (the side-centered twin of ``amr.fill_fine_ghosts``): the whole
    extended component is interpolated and the interior put back."""
    g = ghost
    out = []
    for d in range(box.dim):
        plan = _mac_ghost_plan(box, g, d, uc[d].shape, uc[d].dtype,
                               uc[d].device)
        ext = _apply_plan(uc[d], *plan)
        inner = tuple(slice(g, g + box.fine_n[a] + (1 if a == d else 0))
                      for a in range(box.dim))
        ext[inner] = uf[d]
        out.append(ext)
    return tuple(out)


def box_strain_magnitude(uext: Vel, dx_f, g: int, fine_n):
    """|S| = sqrt(2 E:E) at cell centers of a ghost-extended box MAC
    field, keeping a (g-1)-deep ghost shell: input ghosts g, output
    ghosts g-1."""
    dim = len(uext)
    go = g - 1
    cells = tuple(n + 2 * go for n in fine_n)

    def diff(f, ax, step=1):
        m = f.shape[ax]
        return (stencils.axis_slice(f, ax, step, m)
                - stencils.axis_slice(f, ax, 0, m - step))

    ucc = [0.5 * (stencils.axis_slice(c, d, 0, c.shape[d] - 1)
                  + stencils.axis_slice(c, d, 1, c.shape[d]))
           for d, c in enumerate(uext)]
    acc = None
    for i in range(dim):
        Eii = diff(uext[i], i) / dx_f[i]
        Eii = Eii[tuple(slice(g - go, g - go + cells[a])
                        for a in range(dim))]
        t = Eii * Eii
        acc = t if acc is None else acc + t
        for j in range(i + 1, dim):
            a1 = diff(ucc[i], j, 2) / (2.0 * dx_f[j])
            a2 = diff(ucc[j], i, 2) / (2.0 * dx_f[i])

            def crop_mixed(a, lost_ax):
                sl = []
                for ax in range(dim):
                    base = g - 1 if ax == lost_ax else g
                    sl.append(slice(base - go, base - go + cells[ax]))
                return a[tuple(sl)]

            Eij = 0.5 * (crop_mixed(a1, j) + crop_mixed(a2, i))
            acc = acc + 2.0 * Eij * Eij
    return torch.sqrt(2.0 * acc)


def box_eddy_viscous_force(uext: Vel, mu_ext, dx_f, g: int, fine_n):
    """div(2 mu D(u)) on the ghost-extended box MAC layout. ``mu_ext`` is
    cell-centered with g-1 ghosts (box_strain_magnitude's output shell);
    the result is the interior box MAC components (shape fine_n + e_d).
    Needs g >= 3."""
    dim = len(uext)
    gm = g - 1

    def diff(f, ax):
        m = f.shape[ax]
        return (stencils.axis_slice(f, ax, 1, m)
                - stencils.axis_slice(f, ax, 0, m - 1))

    def face_crop(a, d, offs):
        return a[tuple(slice(offs[ax], offs[ax] + fine_n[ax]
                             + (1 if ax == d else 0))
                       for ax in range(dim))]

    forces = []
    for d in range(dim):
        acc = None
        for j in range(dim):
            if j == d:
                dudd = diff(uext[d], d) / dx_f[d]
                sl = tuple(slice(g - gm, g - gm + fine_n[a] + 2 * gm)
                           for a in range(dim))
                tau = 2.0 * mu_ext * dudd[sl]
                dtau = diff(tau, d) / dx_f[d]
                offs = [gm] * dim
                offs[d] = gm - 1
                term = face_crop(dtau, d, offs)
            else:
                dudj = diff(uext[d], j) / dx_f[j]
                dujd = diff(uext[j], d) / dx_f[d]

                def align(a, diffed_ax, kept_ax):
                    sl = []
                    for ax in range(dim):
                        if ax == diffed_ax:
                            start = g - gm
                            want = fine_n[ax] + 2 * gm - 1
                        elif ax == kept_ax:
                            start = g - gm + 1
                            want = fine_n[ax] + 2 * gm - 1
                        else:
                            start = g - gm
                            want = fine_n[ax] + 2 * gm
                        sl.append(slice(start, start + want))
                    return a[tuple(sl)]

                # mu at the (d, j) corners: the mean of the 4 cells
                m = mu_ext
                for ax in (d, j):
                    n = m.shape[ax]
                    m = 0.5 * (stencils.axis_slice(m, ax, 0, n - 1)
                               + stencils.axis_slice(m, ax, 1, n))
                tau = m * (align(dudj, j, d) + align(dujd, d, j))
                dtau = diff(tau, j) / dx_f[j]
                offs = [gm] * dim
                offs[d] = gm - 1
                offs[j] = gm - 1
                term = face_crop(dtau, d, offs)
            acc = term if acc is None else acc + term
        forces.append(acc)
    return tuple(forces)


def _box_convective_rate(uext: Vel, dx_f, g: int, fine_n) -> Vel:
    """Centered conservative N(u)_d on ghost-extended box MAC tensors;
    component d at its own faces (shape fine_n + e_d). The arithmetic of
    ``convection.convective_rate`` on the box layout."""
    dim = len(uext)
    out = []
    for d in range(dim):
        nd = tuple(fine_n[a] + (1 if a == d else 0) for a in range(dim))
        acc = torch.zeros(nd, dtype=uext[d].dtype, device=uext[d].device)
        for e in range(dim):
            if e == d:
                # flux at cell centers -1 .. n along d
                ncent = fine_n[d] + 2
                a0 = _shift(uext[d], d, g - 1, ncent)
                a1 = _shift(uext[d], d, g, ncent)
                for a in range(dim):
                    if a != d:
                        a0 = _shift(a0, a, g, fine_n[a])
                        a1 = _shift(a1, a, g, fine_n[a])
                adv = 0.5 * (a0 + a1)
                flux = adv * adv
                acc = acc + (_shift(flux, d, 1, nd[d])
                             - _shift(flux, d, 0, nd[d])) / dx_f[d]
            else:
                # edge fluxes at (lower d-face, lower e-face)
                ue = uext[e]
                b0 = _shift(ue, d, g - 1, nd[d])
                b1 = _shift(ue, d, g, nd[d])
                for a in range(dim):
                    if a == e:
                        b0 = _shift(b0, a, g, fine_n[e] + 1)
                        b1 = _shift(b1, a, g, fine_n[e] + 1)
                    elif a != d:
                        b0 = _shift(b0, a, g, fine_n[a])
                        b1 = _shift(b1, a, g, fine_n[a])
                adv = 0.5 * (b0 + b1)
                ud = uext[d]
                q0 = _shift(ud, e, g - 1, fine_n[e] + 1)
                q1 = _shift(ud, e, g, fine_n[e] + 1)
                for a in range(dim):
                    if a == d:
                        q0 = _shift(q0, a, g, nd[d])
                        q1 = _shift(q1, a, g, nd[d])
                    elif a != e:
                        q0 = _shift(q0, a, g, fine_n[a])
                        q1 = _shift(q1, a, g, fine_n[a])
                q = 0.5 * (q0 + q1)
                flux = adv * q
                acc = acc + (_shift(flux, e, 1, fine_n[e])
                             - _shift(flux, e, 0, fine_n[e])) / dx_f[e]
        out.append(acc)
    return tuple(out)


def _box_laplacian(uext: Vel, dx_f, g: int, fine_n) -> Vel:
    """Component Laplacians on ghost-extended box MAC tensors."""
    dim = len(uext)
    out = []
    for d in range(dim):
        nd = tuple(fine_n[a] + (1 if a == d else 0) for a in range(dim))
        c = uext[d]
        center = c
        for a in range(dim):
            center = _shift(center, a, g, nd[a])
        acc = torch.zeros_like(center)
        for a in range(dim):
            lo = c
            hi = c
            for b in range(dim):
                lo = _shift(lo, b, g - (1 if b == a else 0), nd[b])
                hi = _shift(hi, b, g + (1 if b == a else 0), nd[b])
            acc = acc + (hi - 2.0 * center + lo) / dx_f[a] ** 2
        out.append(acc)
    return tuple(out)


def _box_cc_laplacian(phi_ext: torch.Tensor, dx_f, fine_n) -> torch.Tensor:
    """5/7-point Laplacian of a 1-ghost-extended box cell tensor."""
    dim = phi_ext.ndim
    center = phi_ext[tuple(slice(1, 1 + n) for n in fine_n)]
    acc = torch.zeros_like(center)
    for a in range(dim):
        lo = phi_ext[tuple(slice(1 - (1 if b == a else 0),
                                 1 - (1 if b == a else 0) + fine_n[b])
                           for b in range(dim))]
        hi = phi_ext[tuple(slice(1 + (1 if b == a else 0),
                                 1 + (1 if b == a else 0) + fine_n[b])
                           for b in range(dim))]
        acc = acc + (hi - 2.0 * center + lo) / dx_f[a] ** 2
    return acc


def box_mac_gradient_correct(u_box: Vel, phi_ext: torch.Tensor,
                             dx_f) -> Vel:
    """``u - grad(phi)`` on box MAC faces (complete-face layout), the
    gradients from the 1-ghost-extended cell tensor."""
    dim = len(u_box)
    nf = tuple(s - 2 for s in phi_ext.shape)
    out = []
    for d in range(dim):
        lo = [slice(1, 1 + n) for n in nf]
        hi = [slice(1, 1 + n) for n in nf]
        lo[d] = slice(0, nf[d] + 1)
        hi[d] = slice(1, nf[d] + 2)
        g = (phi_ext[tuple(hi)] - phi_ext[tuple(lo)]) / dx_f[d]
        out.append(u_box[d] - g)
    return tuple(out)


def interface_flux_correction(lap_c, phi_eff, phi_ext, box: FineBox,
                              dx_c, dx_f):
    """Replace the parent flux through each CF interface face of ``box``
    by the restricted fine flux, adjusting the Laplacian of the outside
    neighbor cells (the flux-sync rows). ``lap_c``/``phi_eff`` are
    parent-level cell tensors, ``phi_ext`` the 1-ghost-extended child."""
    dim = lap_c.ndim
    r = box.ratio
    lap_c = lap_c.clone()
    for d in range(dim):
        for side in (0, 1):
            if side == 0:
                inner, ghostl = 1, 0
                cout, cin = box.lo[d] - 1, box.lo[d]
            else:
                inner, ghostl = box.fine_n[d], box.fine_n[d] + 1
                cout, cin = box.hi[d], box.hi[d] - 1
            sl_in = [slice(1, 1 + n) for n in box.fine_n]
            sl_gh = [slice(1, 1 + n) for n in box.fine_n]
            sl_in[d] = slice(inner, inner + 1)
            sl_gh[d] = slice(ghostl, ghostl + 1)
            # fine gradient across the interface, made +d directed
            gf = (phi_ext[tuple(sl_gh)] - phi_ext[tuple(sl_in)]) / dx_f[d]
            if side == 0:
                gf = -gf
            gf = gf.squeeze(d)
            tshape = []
            for a in range(dim):
                if a != d:
                    tshape += [box.shape[a], r]
            gf = gf.reshape(tshape).mean(
                dim=tuple(range(1, 2 * (dim - 1), 2))).unsqueeze(d)
            # the parent flux lap_c already used through that face
            sl_out = [slice(box.lo[a], box.hi[a]) for a in range(dim)]
            sl_inn = [slice(box.lo[a], box.hi[a]) for a in range(dim)]
            sl_out[d] = slice(cout, cout + 1)
            sl_inn[d] = slice(cin, cin + 1)
            gc = (phi_eff[tuple(sl_inn)] - phi_eff[tuple(sl_out)]) / dx_c[d]
            if side == 1:
                gc = -gc
            # the shared face is the outside cell's upper face on the lo
            # side (+1/h) and its lower face on the hi side (-1/h)
            sgn = 1.0 if side == 0 else -1.0
            lap_c[tuple(sl_out)] += sgn * (gf - gc) / dx_c[d]
    return lap_c


# -- composite projection -----------------------------------------------------

class CompositeProjection:
    """FGMRES solve of the two-level composite Poisson problem (module
    docstring), with velocity correction and interface sync.
    ``preconditioner`` replaces the default FFT + fast-diagonalization
    level solves (a seam, e.g. ``solvers.fac.FACCompositePoisson``'s
    ``precondition``)."""

    def __init__(self, grid: StaggeredGrid, box: FineBox,
                 tol: float = 1e-9, m: int = 24, restarts: int = 8,
                 preconditioner=None, device="cuda"):
        self.grid = grid
        self.box = box
        self.device = resolve_device(device)
        self._external_precond = preconditioner
        self._graphs = None
        self.last_solve_stats = None
        self.dx = grid.dx
        self.dx_f = tuple(h / box.ratio for h in grid.dx)
        self.tol = float(tol)
        self.m = int(m)
        self.restarts = int(restarts)
        self.box_sl = box_slices(box.lo, box.shape)
        self._covered = torch.zeros(grid.n, dtype=torch.bool,
                                    device=self.device)
        self._covered[self.box_sl] = True
        self.fine_solver = FastDiagSolver(
            box.fine_grid(grid), DomainBC(axes=(dirichlet_axis(),) * grid.dim),
            ("cc",) * grid.dim, device=self.device)

    def build_dense_coarse_solver(self) -> None:
        """The reference builds a dense-transform coarse inverse here for
        its sharded preconditioner; the port runs on one device."""
        raise NotImplementedError(
            "the sharded composite projection is not ported: it waits for "
            "the parallel/ slice of ROADMAP.md queue A (torch.distributed)")

    def _phi_eff(self, phi_c, phi_f):
        out = phi_c.clone()
        out[self.box_sl] = restrict_cc(phi_f)
        return out

    def operator(self, phi):
        """Composite Poisson operator. The covered coarse DOFs are
        decoupled identity rows at Laplacian-diagonal scale (the slaving
        uses restrict(phi_f) directly), and a rank-one shift removes the
        composite constant nullspace."""
        phi_c, phi_f = phi
        phi_eff = self._phi_eff(phi_c, phi_f)
        lap_c = stencils.laplacian(phi_eff, self.dx)
        phi_ext = fill_fine_ghosts(phi_f, phi_eff, self.box, ghost=1)
        lap_c = interface_flux_correction(lap_c, phi_eff, phi_ext,
                                          self.box, self.dx, self.dx_f)
        diag = sum(2.0 / h ** 2 for h in self.dx)
        out_c = torch.where(self._covered, -diag * phi_c, lap_c)
        out_c = out_c + diag * torch.mean(phi_eff)
        lap_f = _box_cc_laplacian(phi_ext, self.dx_f, self.box.fine_n)
        return (out_c, lap_f)

    def _precondition(self, r):
        if self._external_precond is not None:
            return self._external_precond(r)
        r_c, r_f = r
        diag = sum(2.0 / h ** 2 for h in self.dx)
        p_c = fft.solve_poisson_periodic(r_c, self.dx)
        p_c = torch.where(self._covered, -r_c / diag, p_c)
        p_f = self.fine_solver.solve(r_f, 0.0, 1.0)
        return (p_c, p_f)

    def flat_ops(self, template):
        """The composite operator and preconditioner as maps of flat
        vectors shaped like ``template``; on a CUDA device replayed as
        CUDA graphs (an external preconditioner stays eager)."""
        ops = flat_operators(self.operator, self._precondition, template)
        if self.device.type != "cuda":
            return ops
        if self._graphs is None:
            example = ravel(template)[0]
            graphed = [Graphed(f, example) for f in
                       (ops if self._external_precond is None else ops[:1])]
            self._graphs = tuple((lambda v, g=g: g(v).clone())
                                 for g in graphed) + ops[len(graphed):]
        return self._graphs

    def rhs(self, uc: Vel, uf: Vel, q_c: Optional[torch.Tensor] = None,
            q_f: Optional[torch.Tensor] = None):
        """The composite right-hand side (div u - q, zero on the covered
        coarse cells), linear in (u, q)."""
        div_c = stencils.divergence(uc, self.dx)
        if q_c is not None:
            div_c = div_c - q_c
        div_f = box_mac_divergence(uf, self.dx_f)
        if q_f is not None:
            div_f = div_f - q_f
        rhs_c = torch.where(self._covered, torch.zeros_like(div_c), div_c)
        return (rhs_c, div_f)

    def solve(self, rhs):
        """The FGMRES solve of the composite Poisson problem."""
        sol = fgmres_flat(*self.flat_ops(rhs), rhs, m=self.m, tol=self.tol,
                          restarts=self.restarts)
        record_solve_stats(
            self, sol, solver="fgmres",
            mirrors=(getattr(self._external_precond, "__self__", None),))
        return sol.x

    def project(self, uc: Vel, uf: Vel,
                q_c: Optional[torch.Tensor] = None,
                q_f: Optional[torch.Tensor] = None
                ) -> Tuple[Vel, Vel, torch.Tensor, torch.Tensor]:
        return self.correct(uc, uf, self.solve(self.rhs(uc, uf, q_c, q_f)))

    def correct(self, uc: Vel, uf: Vel, phi
                ) -> Tuple[Vel, Vel, torch.Tensor, torch.Tensor]:
        """Both levels corrected with the gradients of the solution
        ``phi = (phi_c, phi_f)``, then synchronized."""
        box = self.box
        phi_c, phi_f = phi
        phi_eff = self._phi_eff(phi_c, phi_f)

        # coarse correction (covered and interface faces are then
        # overwritten by the restriction)
        gc = stencils.gradient(phi_eff, self.dx)
        uc_new = tuple(c - g for c, g in zip(uc, gc))
        phi_ext = fill_fine_ghosts(phi_f, phi_eff, box, ghost=1)
        uf_new = box_mac_gradient_correct(uf, phi_ext, self.dx_f)
        uc_new = scatter_box_mac_to_coarse(uc_new, restrict_mac(uf_new), box)
        return uc_new, uf_new, phi_eff, phi_f


def scatter_box_mac_to_coarse(uc: Vel, ur: Vel, box: FineBox) -> Vel:
    """Covered coarse faces (the interface planes included) overwritten by
    the restricted fine faces, on copies."""
    out = []
    for d, c in enumerate(uc):
        c = c.clone()
        c[box_slices(box.lo, box.shape, extra_axis=d)] = ur[d]
        out.append(c)
    return tuple(out)


# -- the two-level integrator ---------------------------------------------------

class TwoLevelINSState(NamedTuple):
    uc: Vel
    uf: Vel
    t: torch.Tensor
    k: torch.Tensor


def level_dt_limit(us, dx, dim: int, rho: float, mu: float,
                   cfl: float = 0.5):
    """One level's explicit-predictor dt bound: the advective CFL against
    the level's max speed, and the explicit viscous limit
    rho dx^2/(2 dim mu)."""
    umax = torch.clamp(torch.max(torch.stack([torch.max(torch.abs(c))
                                              for c in us])), min=1e-12)
    out = cfl * min(dx) / umax
    if mu > 0.0:
        out = torch.clamp(out, max=rho * min(dx) ** 2 / (2.0 * dim * mu))
    return out


class TwoLevelINS:
    """Composite two-level INS: explicit convection + diffusion and an
    exact composite projection per step. The explicit treatment bounds
    dt by the fine level's viscous and advective limits."""

    def __init__(self, grid: StaggeredGrid, box: FineBox,
                 rho: float = 1.0, mu: float = 0.01,
                 convective: bool = True, proj_tol: float = 1e-9,
                 proj_m: int = 24, proj_restarts: int = 8,
                 precond_factory=None, device="cuda"):
        box.validate(grid, clearance=2)
        self.grid = grid
        self.box = box
        self.device = resolve_device(device)
        self.fine = box.fine_grid(grid)
        self.rho = float(rho)
        self.mu = float(mu)
        self.convective = bool(convective)
        self.dx_f = tuple(h / box.ratio for h in grid.dx)
        # ``precond_factory(grid, box) -> M``: a factory, so a regrid can
        # rebuild the preconditioner at the new box
        self.precond_factory = precond_factory
        precond = (precond_factory(grid, box)
                   if precond_factory is not None else None)
        self.proj = CompositeProjection(grid, box, tol=proj_tol, m=proj_m,
                                        restarts=proj_restarts,
                                        preconditioner=precond,
                                        device=self.device)

    def initialize(self, uc: Vel) -> TwoLevelINSState:
        """The fine level seeded by the divergence-preserving
        prolongation, so a div-free coarse field gives a div-free
        composite state."""
        uf = prolong_mac_div_preserving(uc, self.grid, self.box)
        uc_sync = scatter_box_mac_to_coarse(uc, restrict_mac(uf), self.box)
        return TwoLevelINSState(
            uc=uc_sync, uf=uf,
            t=torch.zeros((), dtype=uc[0].dtype, device=uc[0].device),
            k=torch.zeros((), dtype=torch.int32, device=uc[0].device))

    def step(self, state: TwoLevelINSState, dt: float,
             f_c: Optional[Vel] = None,
             f_f: Optional[Vel] = None) -> TwoLevelINSState:
        """One composite step; ``f_c``/``f_f`` are per-level MAC body
        forces (``f_f`` in box layout, e.g. the spread IB force)."""
        uc_new, uf_new, _, _ = self.proj.project(
            *self.predict(state, dt, f_c=f_c, f_f=f_f))
        return TwoLevelINSState(uc=uc_new, uf=uf_new,
                                t=state.t + dt, k=state.k + 1)

    def predict(self, state: TwoLevelINSState, dt: float,
                f_c: Optional[Vel] = None,
                f_f: Optional[Vel] = None) -> Tuple[Vel, Vel]:
        """The explicit predictor of both levels, the covered coarse faces
        slaved to the fine ones (the step before its projection)."""
        g = self.grid
        uc, uf = state.uc, state.uf
        rho, mu = self.rho, self.mu

        lap_c = stencils.laplacian_vel(uc, g.dx)
        n_c = (convective_rate(uc, g.dx, "centered") if self.convective
               else tuple(torch.zeros_like(c) for c in uc))
        uc_star = []
        for d in range(g.dim):
            rhs = -n_c[d] + (mu * lap_c[d]) / rho
            if f_c is not None:
                rhs = rhs + f_c[d] / rho
            uc_star.append(uc[d] + dt * rhs)

        gext = 2
        uext = fill_fine_ghosts_mac(uf, uc, self.box, ghost=gext)
        lap_f = _box_laplacian(uext, self.dx_f, gext, self.box.fine_n)
        n_f = (_box_convective_rate(uext, self.dx_f, gext, self.box.fine_n)
               if self.convective
               else tuple(torch.zeros_like(c) for c in lap_f))
        uf_star = []
        for d in range(g.dim):
            rhs = -n_f[d] + (mu * lap_f[d]) / rho
            if f_f is not None:
                rhs = rhs + f_f[d] / rho
            uf_star.append(uf[d] + dt * rhs)

        uc_star = scatter_box_mac_to_coarse(
            tuple(uc_star), restrict_mac(tuple(uf_star)), self.box)
        return uc_star, tuple(uf_star)

    def stable_dt(self, state: TwoLevelINSState, cfl: float = 0.5):
        """Advisory dt bound of the explicit predictor: the minimum over
        levels of the advective CFL and the viscous limit (the fine level
        binds)."""
        return torch.minimum(
            level_dt_limit(state.uc, self.grid.dx, self.grid.dim, self.rho,
                           self.mu, cfl),
            level_dt_limit(state.uf, self.dx_f, self.grid.dim, self.rho,
                           self.mu, cfl))

    def max_divergence(self, state: TwoLevelINSState):
        """max |div u| over the uncovered coarse cells (interface ring
        included) and the fine interior."""
        div_c = stencils.divergence(state.uc, self.grid.dx)
        div_c = torch.where(self.proj._covered, torch.zeros_like(div_c),
                            div_c)
        div_f = box_mac_divergence(state.uf, self.dx_f)
        return torch.maximum(torch.max(torch.abs(div_c)),
                             torch.max(torch.abs(div_f)))


def advance_two_level(integ: TwoLevelINS, state: TwoLevelINSState,
                      dt: float, num_steps: int,
                      f_c: Optional[Vel] = None,
                      f_f: Optional[Vel] = None) -> TwoLevelINSState:
    for _ in range(num_steps):
        state = integ.step(state, dt, f_c=f_c, f_f=f_f)
    return state


# -- IB on the composite hierarchy (refine around the structure) ---------------

class TwoLevelIBState(NamedTuple):
    fluid: TwoLevelINSState
    X: torch.Tensor
    U: torch.Tensor
    mask: torch.Tensor


class TwoLevelIBINS:
    """Explicit IB coupling on the two-level composite grid: the structure
    lives inside the fine box, transfers run at fine resolution through
    the strategy ``ib`` (the IBStrategy seam: ``compute_force``,
    ``interpolate_velocity`` and ``spread_force`` with the ``ctx``
    protocol, e.g. :class:`~ibamr_tpu_torch.integrators.ib.IBMethod`),
    and the coarse level sees the restricted force. The structure must
    keep delta-support clearance from the box boundary."""

    def __init__(self, grid: StaggeredGrid, box: FineBox, ib,
                 rho: float = 1.0, mu: float = 0.01,
                 convective: bool = True, proj_tol: float = 1e-9,
                 proj_m: int = 24, proj_restarts: int = 8,
                 precond_factory=None, device="cuda"):
        self.core = TwoLevelINS(grid, box, rho=rho, mu=mu,
                                convective=convective, proj_tol=proj_tol,
                                proj_m=proj_m, proj_restarts=proj_restarts,
                                precond_factory=precond_factory,
                                device=device)
        self.grid = grid
        self.box = box
        self.device = self.core.device
        self.fine_grid = box.fine_grid(grid)
        self.ib = ib

    def initialize(self, X0, uc: Optional[Vel] = None) -> TwoLevelIBState:
        X = torch.as_tensor(X0, device=self.device)
        if uc is None:
            uc = tuple(torch.zeros(self.grid.n, dtype=X.dtype,
                                   device=self.device)
                       for _ in range(self.grid.dim))
        fluid = self.core.initialize(uc)
        return TwoLevelIBState(
            fluid=fluid, X=X, U=torch.zeros_like(X),
            mask=torch.ones(X.shape[0], dtype=X.dtype, device=self.device))

    def _interp(self, uf_box: Vel, X, mask, ctx=None):
        u_per = stencils.mac_periodic_from_complete(uf_box,
                                                    self.box.fine_n)
        return self.ib.interpolate_velocity(u_per, self.fine_grid, X,
                                            mask, ctx=ctx)

    def _spread_two_level(self, F, X, mask, ctx=None):
        """A Lagrangian force at ``X`` spread onto both levels: the
        fine-window MAC force and the conservatively restricted coarse
        force. The structure keeps delta-support clearance from the box,
        so the duplicated wrap face of the box layout carries zero."""
        f_per = self.ib.spread_force(F, self.fine_grid, X, mask, ctx=ctx)
        f_f = stencils.mac_complete_from_periodic(f_per)
        f_c = scatter_box_mac_to_coarse(
            tuple(torch.zeros(self.grid.n, dtype=f_per[0].dtype,
                              device=f_per[0].device)
                  for _ in range(self.grid.dim)),
            restrict_mac(f_f), self.box)
        return f_c, f_f

    def step(self, state: TwoLevelIBState, dt: float) -> TwoLevelIBState:
        fluid = state.fluid
        X_n = state.X
        U_n = self._interp(fluid.uf, X_n, state.mask)
        X_half = X_n + 0.5 * dt * U_n
        t_half = fluid.t + 0.5 * dt
        F = self.ib.compute_force(X_half, U_n, t_half)
        # one transfer context per structural position, shared by the
        # spread and the midpoint interp
        ctx = self.ib.prepare(X_half, state.mask) \
            if hasattr(self.ib, "prepare") else None
        f_c, f_f = self._spread_two_level(F, X_half, state.mask, ctx=ctx)
        fluid_new = self.core.step(fluid, dt, f_c=f_c, f_f=f_f)
        u_mid = tuple(0.5 * (a + b) for a, b in zip(fluid.uf, fluid_new.uf))
        U_half = self._interp(u_mid, X_half, state.mask, ctx=ctx)
        X_new = X_n + dt * U_half
        return TwoLevelIBState(fluid=fluid_new, X=X_new, U=U_half,
                               mask=state.mask)


def advance_two_level_ib(integ: TwoLevelIBINS, state: TwoLevelIBState,
                         dt: float, num_steps: int) -> TwoLevelIBState:
    for _ in range(num_steps):
        state = integ.step(state, dt)
    return state


def _host(X) -> np.ndarray:
    return X.detach().cpu().numpy() if isinstance(X, torch.Tensor) \
        else np.asarray(X)


def _window_lo_from_markers(grid: StaggeredGrid, X, shape,
                            clearance: int = 2) -> Tuple[int, ...]:
    """Origin of a fixed-shape window centered on the marker bbox,
    clipped to proper nesting (host-side, in the markers' precision)."""
    Xn = _host(X)
    lo = []
    for d in range(grid.dim):
        c = (Xn[:, d] - grid.x_lo[d]) / grid.dx[d]
        center = 0.5 * (c.min() + c.max())
        l = int(round(center - shape[d] / 2.0))
        l = max(clearance, min(l, grid.n[d] - shape[d] - clearance))
        # the clipped window must still contain the structure with a
        # delta-support margin: markers outside the fine box would be
        # transferred against the wrong level
        margin = 3
        if c.min() < l + margin or c.max() > l + shape[d] - margin:
            raise ValueError(
                f"axis {d}: marker span [{c.min():.1f}, {c.max():.1f}] "
                f"cells does not fit the clipped window "
                f"[{l}, {l + shape[d]}] with margin {margin}; enlarge "
                f"the window shape or re-center the domain")
        lo.append(l)
    return tuple(lo)


def regrid_two_level_ib(integ: TwoLevelIBINS, state: TwoLevelIBState,
                        move_threshold: int = 2
                        ) -> Tuple[TwoLevelIBINS, TwoLevelIBState]:
    """Host-side moving-window regrid of the composite IB/INS hierarchy:
    retag a fixed-shape window from the current markers and, when it
    moves by ``move_threshold`` cells or more, rebuild the integrator and
    carry the fluid over: the divergence-preserving prolongation of the
    coarse field over the new window, the surviving fine data copied
    across the overlap, and one composite projection to clean the seam.
    Returns (integ, state), both unchanged when the window stays."""
    grid = integ.grid
    old = integ.box
    lo_new = _window_lo_from_markers(grid, state.X, old.shape)
    if max(abs(a - b) for a, b in zip(lo_new, old.lo)) < move_threshold:
        return integ, state

    new_box = FineBox(lo=lo_new, shape=old.shape, ratio=old.ratio)
    core = integ.core
    integ2 = TwoLevelIBINS(grid, new_box, integ.ib, rho=core.rho,
                           mu=core.mu, convective=core.convective,
                           proj_tol=core.proj.tol, proj_m=core.proj.m,
                           proj_restarts=core.proj.restarts,
                           precond_factory=core.precond_factory,
                           device=integ.device)
    uc = state.fluid.uc
    uf_new = [c.clone() for c in
              prolong_mac_div_preserving(uc, grid, new_box)]
    r = old.ratio
    ov_lo = [max(a, b) for a, b in zip(old.lo, lo_new)]
    ov_hi = [min(a, b) for a, b in zip(old.hi, new_box.hi)]
    if all(h > l for l, h in zip(ov_lo, ov_hi)):
        for d in range(grid.dim):
            src = [slice(r * (ov_lo[e] - old.lo[e]),
                         r * (ov_hi[e] - old.lo[e]) + (1 if e == d else 0))
                   for e in range(grid.dim)]
            dst = [slice(r * (ov_lo[e] - lo_new[e]),
                         r * (ov_hi[e] - lo_new[e]) + (1 if e == d else 0))
                   for e in range(grid.dim)]
            uf_new[d][tuple(dst)] = state.fluid.uf[d][tuple(src)]
    uc_sync = scatter_box_mac_to_coarse(uc, restrict_mac(tuple(uf_new)),
                                        new_box)
    uc_p, uf_p, _, _ = integ2.core.proj.project(uc_sync, tuple(uf_new))
    fluid = TwoLevelINSState(uc=uc_p, uf=uf_p, t=state.fluid.t,
                             k=state.fluid.k)
    return integ2, TwoLevelIBState(fluid=fluid, X=state.X, U=state.U,
                                   mask=state.mask)


def advance_with_regrids(integ, state, dt: float, num_steps: int,
                         regrid_interval: int, advance_fn, regrid_fn,
                         on_chunk=None):
    """The regrid cadence: chunks of ``regrid_interval`` steps of
    ``advance_fn(integ, state, dt, n)`` with ``regrid_fn(integ, state)``
    between them, and ``on_chunk(integ, state, steps_done)`` after every
    chunk. The chunks are eager loops (the reference jits one per
    window)."""
    done = 0
    while done < num_steps:
        n = min(regrid_interval, num_steps - done)
        state = advance_fn(integ, state, dt, n)
        done += n
        if on_chunk is not None:
            on_chunk(integ, state, done)
        if done < num_steps:
            integ, state = regrid_fn(integ, state)
    return integ, state


def advance_two_level_ib_regridding(integ: TwoLevelIBINS,
                                    state: TwoLevelIBState, dt: float,
                                    num_steps: int,
                                    regrid_interval: int = 20,
                                    on_chunk=None
                                    ) -> Tuple[TwoLevelIBINS,
                                               TwoLevelIBState]:
    """Advance with the window tracking the structure: chunks of
    ``regrid_interval`` steps with host-side marker-tagged regrids in
    between."""
    return advance_with_regrids(integ, state, dt, num_steps,
                                regrid_interval, advance_two_level_ib,
                                regrid_two_level_ib, on_chunk=on_chunk)


def box_from_markers(grid: StaggeredGrid, X, pad: int = 4,
                     even: bool = True) -> FineBox:
    """The fine box from marker positions (host-side, at set-up): the
    smallest coarse-cell box covering the structure plus ``pad`` cells of
    clearance; ``even`` rounds the box to even extents."""
    Xn = _host(X)
    lo, hi = [], []
    for d in range(grid.dim):
        c = (Xn[:, d] - grid.x_lo[d]) / grid.dx[d]
        l = int(np.floor(c.min())) - pad
        h = int(np.ceil(c.max())) + pad
        l = max(l, 2)
        h = min(h, grid.n[d] - 2)
        if even and (h - l) % 2:
            h = h - 1 if h - l > 2 else h
            if (h - l) % 2:
                l = l + 1
        lo.append(l)
        hi.append(h)
    return FineBox(lo=tuple(lo), shape=tuple(h - l for l, h in zip(lo, hi)))
