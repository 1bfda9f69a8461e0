"""L-level composite incompressible Navier-Stokes, and IB on it (port of
``ibamr_tpu/amr_ins_multilevel.py``).

The per-pair coarse-fine primitives of :mod:`ibamr_tpu_torch.amr_ins`
(quadratic CF ghost fill, coincident-face restriction, interface flux
synchronization) applied recursively over a nested-box hierarchy
(``amr_multilevel.build_hierarchy``), with one FGMRES solve of the whole
L-level composite Poisson system per step. Scheme (ratio-2 boxes, one box
per level, a shared dt bounded by the finest level):

1. explicit convective + viscous predictor per level, each box on
   ghost-extended tensors interpolated from its parent at MAC positions;
2. covered regions slaved bottom-up (coincident-face mean restriction);
3. the composite projection: FGMRES over ``(phi_0, ..., phi_{L-1})``;
   covered cells carry the slaving identity, uncovered cells the
   Laplacian with the flux through every CF interface face replaced by
   the transverse mean of the child fluxes, box cells the box Laplacian
   with CF-interpolated ghosts. The default preconditioner is the exact
   periodic FFT inverse at the root and a fast-diagonalization Dirichlet
   inverse on each box; ``solvers.fac.FACMultilevelPoisson`` can be put
   in its place through ``precond_factory``;
4. every level corrected with consistent gradients, then synchronized.

``MultiLevelIBINS`` keeps the structure inside the finest box: transfers
run at the finest resolution through the scatter oracle
(``ops.interaction``), and the spread force is restricted down the
hierarchy. The steps are eager; the FGMRES reads its residual to the host
once per restart. On a CUDA device the composite operator and the default
preconditioner are captured once per box chain as CUDA graphs and
replayed (bitwise the eager solve).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ibamr_tpu_torch.amr import (FineBox, box_mac_divergence, box_slices,
                                 fill_fine_ghosts, prolong_mac_div_preserving,
                                 restrict_cc, restrict_mac)
from ibamr_tpu_torch.amr_ins import (_box_cc_laplacian, _box_convective_rate,
                                     _box_laplacian, _window_lo_from_markers,
                                     advance_with_regrids,
                                     box_mac_gradient_correct,
                                     fill_fine_ghosts_mac,
                                     interface_flux_correction,
                                     level_dt_limit,
                                     scatter_box_mac_to_coarse)
from ibamr_tpu_torch.amr_multilevel import (LevelSpec, build_hierarchy,
                                            face_mesh)
from ibamr_tpu_torch.bc import DomainBC, dirichlet_axis
from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops import interaction, stencils
from ibamr_tpu_torch.ops.convection import convective_rate
from ibamr_tpu_torch.solvers import fft
from ibamr_tpu_torch.solvers.escalation import record_solve_stats
from ibamr_tpu_torch.solvers.fastdiag import FastDiagSolver
from ibamr_tpu_torch.solvers.krylov import fgmres_flat, flat_operators
from ibamr_tpu_torch.utils.cuda_graph import Graphed
from ibamr_tpu_torch.utils.tree import ravel

Vel = Tuple[torch.Tensor, ...]


class MultiLevelCompositeProjection:
    """FGMRES solve of the L-level composite Poisson problem. ``levels``
    come from ``build_hierarchy`` (level 0 the periodic root, level l >= 1
    a box in level l-1's index space); the solution is a tuple of
    per-level cell tensors."""

    def __init__(self, levels: Sequence[LevelSpec], tol: float = 1e-9,
                 m: int = 24, restarts: int = 8, preconditioner=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.levels = list(levels)
        self.L = len(self.levels)
        if self.L < 2:
            raise ValueError("need at least 2 levels (use the uniform "
                             "integrator for L=1)")
        self._external_precond = preconditioner
        self._graphs = None
        self.last_solve_stats = None
        self.tol = float(tol)
        self.m = int(m)
        self.restarts = int(restarts)
        self.dx = [spec.grid.dx for spec in self.levels]
        self.diag = [sum(2.0 / h ** 2 for h in spec.grid.dx)
                     for spec in self.levels]

        # per level l < L-1: the child-box slice in this level's index
        # space and the region it covers
        self.box_sl: List[Tuple[slice, ...]] = []
        self.covered: List[torch.Tensor] = []
        for l in range(self.L - 1):
            box = self.levels[l + 1].box
            sl = box_slices(box.lo, box.shape)
            self.box_sl.append(sl)
            cov = torch.zeros(self.levels[l].grid.n, dtype=torch.bool,
                              device=self.device)
            cov[sl] = True
            self.covered.append(cov)

        # the default preconditioner's level inverses: the periodic FFT
        # at the root, fast diagonalization (Dirichlet) on each box
        self.box_solvers = [
            FastDiagSolver(spec.grid,
                           DomainBC(axes=(dirichlet_axis(),)
                                    * spec.grid.dim),
                           ("cc",) * spec.grid.dim, device=self.device)
            for spec in self.levels[1:]]

    def build_dense_root_solver(self) -> None:
        """The reference builds a dense-transform root inverse here for
        its sharded preconditioner; the port runs on one device."""
        raise NotImplementedError(
            "the sharded L-level projection is not ported: it waits for "
            "the parallel/ slice of ROADMAP.md queue A (torch.distributed)")

    # -- composite operator ---------------------------------------------------
    def _effective(self, phis: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Top-down effective tensors: each level's covered region holds
        the restriction of the child's effective tensor."""
        eff = [None] * self.L
        eff[self.L - 1] = phis[self.L - 1]
        for l in range(self.L - 2, -1, -1):
            e = phis[l].clone()
            e[self.box_sl[l]] = restrict_cc(eff[l + 1])
            eff[l] = e
        return eff

    def _extended(self, eff: Sequence[torch.Tensor]
                  ) -> List[Optional[torch.Tensor]]:
        """1-ghost extensions of each box level from its parent's
        effective tensor (None at the root)."""
        exts: List[Optional[torch.Tensor]] = [None]
        for l in range(1, self.L):
            exts.append(fill_fine_ghosts(eff[l], eff[l - 1],
                                         self.levels[l].box, ghost=1))
        return exts

    def operator(self, phis):
        eff = self._effective(phis)
        exts = self._extended(eff)
        out = []
        for l in range(self.L):
            g = self.levels[l].grid
            if l == 0:
                lap = stencils.laplacian(eff[0], g.dx)
            else:
                lap = _box_cc_laplacian(exts[l], g.dx, g.n)
            if l + 1 < self.L:
                lap = interface_flux_correction(
                    lap, eff[l], exts[l + 1], self.levels[l + 1].box, g.dx,
                    self.levels[l + 1].grid.dx)
                lap = torch.where(self.covered[l], -self.diag[l] * phis[l],
                                  lap)
            if l == 0:
                # a rank-one shift removes the composite constant
                # nullspace (as in the two-level operator)
                lap = lap + self.diag[0] * torch.mean(eff[0])
            out.append(lap)
        return tuple(out)

    def _precondition(self, rs):
        if self._external_precond is not None:
            return tuple(self._external_precond(rs))
        out = [fft.solve_poisson_periodic(rs[0], self.dx[0])]
        for l in range(1, self.L):
            out.append(self.box_solvers[l - 1].solve(rs[l], 0.0, 1.0))
        for l in range(self.L - 1):
            out[l] = torch.where(self.covered[l], -rs[l] / self.diag[l],
                                 out[l])
        return tuple(out)

    def flat_ops(self, template):
        """The composite operator and preconditioner as maps of flat
        vectors shaped like ``template``; on a CUDA device replayed as
        CUDA graphs. An external preconditioner is replayed too when its
        object declares
        ``graph_safe`` (no host read, fixed shapes: the FAC V-cycles), and
        stays eager otherwise."""
        ops = flat_operators(self.operator, self._precondition, template)
        if self.device.type != "cuda":
            return ops
        if self._graphs is None:
            example = ravel(template)[0]
            owner = getattr(self._external_precond, "__self__", None)
            both = self._external_precond is None or \
                getattr(owner, "graph_safe", False)
            graphed = [Graphed(f, example) for f in
                       (ops if both else ops[:1])]
            self._graphs = tuple((lambda v, g=g: g(v).clone())
                                 for g in graphed) + ops[len(graphed):]
        return self._graphs

    def _divergences(self, us: Sequence[Vel]) -> List[torch.Tensor]:
        """Per-level MAC divergence, zero on the covered cells."""
        divs = []
        for l in range(self.L):
            g = self.levels[l].grid
            if l == 0:
                d = stencils.divergence(us[0], g.dx)
            else:
                d = box_mac_divergence(us[l], g.dx)
            if l + 1 < self.L:
                d = torch.where(self.covered[l], torch.zeros_like(d), d)
            divs.append(d)
        return divs

    # -- projection -----------------------------------------------------------
    def project(self, us: Sequence[Vel]) -> Tuple[Tuple[Vel, ...], int]:
        """Make the composite MAC field discretely divergence-free.
        ``us[0]`` is the periodic root field (lower faces), ``us[l >= 1]``
        box MAC tensors (complete faces). Returns the corrected per-level
        velocities and the FGMRES restart count."""
        rhs = tuple(self._divergences(us))
        sol = fgmres_flat(*self.flat_ops(rhs), rhs, m=self.m, tol=self.tol,
                          restarts=self.restarts)
        record_solve_stats(
            self, sol, solver="fgmres",
            mirrors=(getattr(self._external_precond, "__self__", None),))
        eff = self._effective(sol.x)
        exts = self._extended(eff)

        out: List[Vel] = []
        for l in range(self.L):
            g = self.levels[l].grid
            if l == 0:
                gc = stencils.gradient(eff[0], g.dx)
                out.append(tuple(c - gr for c, gr in zip(us[0], gc)))
            else:
                out.append(box_mac_gradient_correct(us[l], exts[l], g.dx))

        # synchronize bottom-up: covered parent faces take the restriction
        for l in range(self.L - 2, -1, -1):
            out[l] = scatter_box_mac_to_coarse(
                out[l], restrict_mac(out[l + 1]), self.levels[l + 1].box)
        return tuple(out), sol.iters

    def max_divergence(self, us: Sequence[Vel]) -> torch.Tensor:
        """max |div| over the uncovered cells of every level and the whole
        finest level."""
        return torch.max(torch.stack([torch.max(torch.abs(d))
                                      for d in self._divergences(us)]))


# -- the L-level integrator ---------------------------------------------------

class MultiLevelINSState(NamedTuple):
    us: Tuple[Vel, ...]     # per-level MAC fields
    t: torch.Tensor
    k: torch.Tensor


class MultiLevelINS:
    """Composite L-level INS: explicit convection and diffusion on every
    level (shared dt), one composite projection per step."""

    GHOST = 2     # MAC predictor ghost width

    def __init__(self, grid: StaggeredGrid, boxes: Sequence[FineBox],
                 rho: float = 1.0, mu: float = 0.01,
                 convective: bool = True, proj_tol: float = 1e-9,
                 proj_m: int = 24, proj_restarts: int = 8,
                 precond_factory=None, device="cuda"):
        self.device = resolve_device(device)
        self.levels = build_hierarchy(grid, boxes)
        self.L = len(self.levels)
        self.grid = grid
        self.rho = float(rho)
        self.mu = float(mu)
        self.convective = bool(convective)
        # ``precond_factory(levels) -> M``: a factory, so a regrid can
        # rebuild the preconditioner at the new boxes
        self.precond_factory = precond_factory
        precond = (precond_factory(self.levels)
                   if precond_factory is not None else None)
        self.proj = MultiLevelCompositeProjection(
            self.levels, tol=proj_tol, m=proj_m, restarts=proj_restarts,
            preconditioner=precond, device=self.device)

    def initialize(self, vel_fn=None,
                   dtype=torch.float64) -> MultiLevelINSState:
        """``vel_fn(d, face_coord_arrays) -> component d`` (host numpy)
        on every level's MAC faces (zeros when None), then the composite
        field projected divergence-free and synchronized."""
        us = []
        for l, spec in enumerate(self.levels):
            comps = []
            for d in range(spec.grid.dim):
                shape, mesh = face_mesh(spec.grid, d, complete=l > 0)
                if vel_fn is None:
                    comps.append(torch.zeros(shape, dtype=dtype,
                                             device=self.device))
                else:
                    comps.append(torch.as_tensor(
                        vel_fn(d, mesh), dtype=dtype, device=self.device))
            us.append(tuple(comps))
        us, _ = self.proj.project(us)
        return MultiLevelINSState(
            us=tuple(us),
            t=torch.zeros((), dtype=dtype, device=self.device),
            k=torch.zeros((), dtype=torch.int32, device=self.device))

    def _predict(self, us: Sequence[Vel], dt: float,
                 fs: Optional[Sequence[Optional[Vel]]] = None) -> List[Vel]:
        rho, mu = self.rho, self.mu
        stars: List[Vel] = []
        for l in range(self.L):
            g = self.levels[l].grid
            if l == 0:
                lap = stencils.laplacian_vel(us[0], g.dx)
                nc = (convective_rate(us[0], g.dx, "centered")
                      if self.convective
                      else tuple(torch.zeros_like(c) for c in us[0]))
            else:
                # the parent tensors (box layout for l >= 2) feed the MAC
                # CF ghost fill directly: under the >= 2-cell nesting
                # clearance its stencils stay interior
                uext = fill_fine_ghosts_mac(us[l], us[l - 1],
                                            self.levels[l].box,
                                            ghost=self.GHOST)
                lap = _box_laplacian(uext, g.dx, self.GHOST, g.n)
                nc = (_box_convective_rate(uext, g.dx, self.GHOST, g.n)
                      if self.convective
                      else tuple(torch.zeros_like(c) for c in lap))
            comps = []
            for d in range(g.dim):
                rhs = -nc[d] + (mu * lap[d]) / rho
                if fs is not None and fs[l] is not None:
                    rhs = rhs + fs[l][d] / rho
                comps.append(us[l][d] + dt * rhs)
            stars.append(tuple(comps))

        # slave the covered parent regions bottom-up
        for l in range(self.L - 2, -1, -1):
            stars[l] = scatter_box_mac_to_coarse(
                stars[l], restrict_mac(stars[l + 1]),
                self.levels[l + 1].box)
        return stars

    def step(self, state: MultiLevelINSState, dt: float,
             fs: Optional[Sequence[Optional[Vel]]] = None
             ) -> MultiLevelINSState:
        stars = self._predict(state.us, dt, fs=fs)
        us_new, _ = self.proj.project(stars)
        return MultiLevelINSState(us=tuple(us_new), t=state.t + dt,
                                  k=state.k + 1)

    def max_divergence(self, state: MultiLevelINSState) -> torch.Tensor:
        return self.proj.max_divergence(state.us)

    def stable_dt(self, state: MultiLevelINSState,
                  cfl: float = 0.5) -> torch.Tensor:
        """Advisory dt bound of the explicit predictor: the minimum over
        levels of the advective CFL and the viscous limit (the finest
        level binds)."""
        out = torch.full((), float("inf"), dtype=state.us[0][0].dtype,
                         device=state.us[0][0].device)
        for spec, us in zip(self.levels, state.us):
            out = torch.minimum(out, level_dt_limit(
                us, spec.grid.dx, spec.grid.dim, self.rho, self.mu, cfl))
        return out


def advance_multilevel(integ: MultiLevelINS, state: MultiLevelINSState,
                       dt: float, num_steps: int) -> MultiLevelINSState:
    for _ in range(num_steps):
        state = integ.step(state, dt)
    return state


# -- IB on the L-level hierarchy (structure inside the finest box) ------------

class MultiLevelIBState(NamedTuple):
    fluid: MultiLevelINSState
    X: torch.Tensor
    U: torch.Tensor
    mask: torch.Tensor


class MultiLevelIBINS:
    """Explicit IB coupling on the L-level composite grid: transfers at
    the finest resolution (the scatter oracle with ``ib.kernel``), the
    spread force restricted level by level down the hierarchy. The
    structure keeps delta-support clearance from the finest box."""

    def __init__(self, grid: StaggeredGrid, boxes: Sequence[FineBox], ib,
                 rho: float = 1.0, mu: float = 0.01,
                 convective: bool = True, proj_tol: float = 1e-9,
                 proj_m: int = 24, proj_restarts: int = 8,
                 precond_factory=None, device="cuda"):
        self.core = MultiLevelINS(grid, boxes, rho=rho, mu=mu,
                                  convective=convective, proj_tol=proj_tol,
                                  proj_m=proj_m, proj_restarts=proj_restarts,
                                  precond_factory=precond_factory,
                                  device=device)
        self.device = self.core.device
        self.levels = self.core.levels
        self.L = self.core.L
        self.grid = grid
        self.finest_grid = self.levels[-1].grid
        self.ib = ib

    def initialize(self, X0, vel_fn=None) -> MultiLevelIBState:
        X = torch.as_tensor(X0, device=self.device)
        fluid = self.core.initialize(vel_fn=vel_fn, dtype=X.dtype)
        return MultiLevelIBState(
            fluid=fluid, X=X, U=torch.zeros_like(X),
            mask=torch.ones(X.shape[0], dtype=X.dtype, device=self.device))

    def _interp(self, u_box: Vel, X, mask):
        u_per = stencils.mac_periodic_from_complete(u_box,
                                                    self.finest_grid.n)
        return interaction.interpolate_vel(u_per, self.finest_grid, X,
                                           kernel=self.ib.kernel,
                                           weights=mask)

    def _spread_forces(self, F, X, mask) -> List[Optional[Vel]]:
        """Spread at the finest resolution, restricted down the
        hierarchy: level l < L-1 sees the conservative restriction
        scattered into its (elsewhere zero) force tensor."""
        f_per = interaction.spread_vel(F, self.finest_grid, X,
                                       kernel=self.ib.kernel, weights=mask)
        fs: List[Optional[Vel]] = [None] * self.L
        fs[self.L - 1] = stencils.mac_complete_from_periodic(f_per)
        for l in range(self.L - 2, -1, -1):
            g = self.levels[l].grid
            zero = tuple(
                torch.zeros(tuple(g.n[e] + (1 if (l > 0 and e == d) else 0)
                                  for e in range(g.dim)),
                            dtype=f_per[0].dtype, device=f_per[0].device)
                for d in range(g.dim))
            fs[l] = scatter_box_mac_to_coarse(
                zero, restrict_mac(fs[l + 1]), self.levels[l + 1].box)
        return fs

    def step(self, state: MultiLevelIBState, dt: float) -> MultiLevelIBState:
        fluid = state.fluid
        X_n = state.X
        uf = fluid.us[self.L - 1]
        U_n = self._interp(uf, X_n, state.mask)
        X_half = X_n + 0.5 * dt * U_n
        t_half = fluid.t + 0.5 * dt
        F = self.ib.compute_force(X_half, U_n, t_half)
        fs = self._spread_forces(F, X_half, state.mask)
        fluid_new = self.core.step(fluid, dt, fs=fs)
        u_mid = tuple(0.5 * (a + b)
                      for a, b in zip(uf, fluid_new.us[self.L - 1]))
        U_half = self._interp(u_mid, X_half, state.mask)
        X_new = X_n + dt * U_half
        return MultiLevelIBState(fluid=fluid_new, X=X_new, U=U_half,
                                 mask=state.mask)


def advance_multilevel_ib(integ: MultiLevelIBINS, state: MultiLevelIBState,
                          dt: float, num_steps: int) -> MultiLevelIBState:
    for _ in range(num_steps):
        state = integ.step(state, dt)
    return state


# -- moving-window regrid at any depth ----------------------------------------

def regrid_multilevel_ib(integ: MultiLevelIBINS, state: MultiLevelIBState,
                         move_threshold: int = 2
                         ) -> Tuple[MultiLevelIBINS, MultiLevelIBState]:
    """Host-side marker-tagged regrid of the whole box chain: every
    level's fixed-shape window re-centered on the current markers in its
    parent's index space, nesting clearance enforced level by level (the
    markers are read to the host once a level). When any window moves:

    1. each new window's velocity is the divergence-preserving MAC
       prolongation of its (already transferred) parent field;
    2. surviving same-level data is copied across the old/new overlap,
       found in physical coordinates (a moved parent shifts the child's
       index frame);
    3. covered parent faces are re-slaved bottom-up and one composite
       projection cleans the seams.

    Returns (integ, state), both unchanged when no window moved."""
    old_levels = integ.levels
    L = integ.L
    grid = integ.grid

    new_boxes: List[FineBox] = []
    parent_grid = grid
    moved = False
    for l in range(1, L):
        old = old_levels[l].box
        lo = _window_lo_from_markers(parent_grid, state.X, old.shape)
        if max(abs(a - b) for a, b in zip(lo, old.lo)) < move_threshold \
                and not moved:
            # a moved ancestor forces the recomputation below it even if
            # this window's origin is unchanged in the parent frame
            lo = old.lo
        else:
            moved = moved or tuple(lo) != tuple(old.lo)
        new_boxes.append(FineBox(lo=tuple(lo), shape=old.shape,
                                 ratio=old.ratio))
        parent_grid = new_boxes[-1].fine_grid(parent_grid)
    if not moved:
        return integ, state

    core = integ.core
    integ2 = MultiLevelIBINS(grid, new_boxes, integ.ib, rho=core.rho,
                             mu=core.mu, convective=core.convective,
                             proj_tol=core.proj.tol, proj_m=core.proj.m,
                             proj_restarts=core.proj.restarts,
                             precond_factory=core.precond_factory,
                             device=integ.device)
    new_levels = integ2.levels

    us_new: List[Vel] = [state.fluid.us[0]]       # the root rides along
    for l in range(1, L):
        pg = new_levels[l - 1].grid
        box = new_levels[l].box
        parent = us_new[l - 1]
        if l >= 2:
            # box layout to the parent window's periodic layout; the wrap
            # images never reach the prolonged region (>= 2-cell nesting
            # clearance against the 1-cell prolongation stencil)
            parent = stencils.mac_periodic_from_complete(parent, pg.n)
        uf = [c.clone() for c in prolong_mac_div_preserving(parent, pg, box)]

        # the overlap copy in physical coordinates (whole cells at this
        # level's resolution: window origins lie on the parent lattice)
        og = old_levels[l].grid
        ng = new_levels[l].grid
        dxl = ng.dx
        ov_lo = [max(a, b) for a, b in zip(og.x_lo, ng.x_lo)]
        ov_hi = [min(a, b) for a, b in zip(og.x_up, ng.x_up)]
        if all(h > lo_ + 0.5 * dd for lo_, h, dd in zip(ov_lo, ov_hi, dxl)):
            src0 = [int(round((ov_lo[d] - og.x_lo[d]) / dxl[d]))
                    for d in range(grid.dim)]
            dst0 = [int(round((ov_lo[d] - ng.x_lo[d]) / dxl[d]))
                    for d in range(grid.dim)]
            cnt = [int(round((ov_hi[d] - ov_lo[d]) / dxl[d]))
                   for d in range(grid.dim)]
            for d in range(grid.dim):
                src = tuple(slice(src0[e], src0[e] + cnt[e]
                                  + (1 if e == d else 0))
                            for e in range(grid.dim))
                dst = tuple(slice(dst0[e], dst0[e] + cnt[e]
                                  + (1 if e == d else 0))
                            for e in range(grid.dim))
                uf[d][dst] = state.fluid.us[l][d][src]
        us_new.append(tuple(uf))

    # re-slave the covered parent faces bottom-up, then clean the seams
    for l in range(L - 2, -1, -1):
        us_new[l] = scatter_box_mac_to_coarse(
            us_new[l], restrict_mac(us_new[l + 1]), new_levels[l + 1].box)
    us_p, _ = integ2.core.proj.project(us_new)
    fluid = MultiLevelINSState(us=tuple(us_p), t=state.fluid.t,
                               k=state.fluid.k)
    return integ2, MultiLevelIBState(fluid=fluid, X=state.X, U=state.U,
                                     mask=state.mask)


def advance_multilevel_ib_regridding(integ: MultiLevelIBINS,
                                     state: MultiLevelIBState, dt: float,
                                     num_steps: int,
                                     regrid_interval: int = 20,
                                     on_chunk=None
                                     ) -> Tuple[MultiLevelIBINS,
                                                MultiLevelIBState]:
    """Advance with the whole window chain tracking the structure: chunks
    of ``regrid_interval`` steps with host-side regrids between them."""
    return advance_with_regrids(integ, state, dt, num_steps,
                                regrid_interval, advance_multilevel_ib,
                                regrid_multilevel_ib, on_chunk=on_chunk)
