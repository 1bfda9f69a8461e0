"""Variable-coefficient (two-phase) INS integrator with level-set
interface capture (port of ``ibamr_tpu/integrators/ins_vc.py``).

- density rho(phi) and viscosity mu(phi) blend the two phases through a
  smoothed Heaviside of the level set;
- explicit AB2 convection and an explicit variable-viscosity stress
  div(2 mu D(u));
- the variable-density projection div((dt/rho) grad p) = div u* by CG,
  preconditioned by one V-cycle of the variable-coefficient multigrid
  (a hierarchy coarsened from this step's density) or by the
  constant-coefficient FFT inverse;
- CSF surface tension sigma kappa delta(phi) grad phi and gravity as a
  density anomaly; no-slip walls, moving lids and an open outlet;
- Godunov advection of the level set with cadenced reinitialization.

The step counter ``k`` is a host int in the state, so the AB2 bootstrap,
the reinitialization cadence and the density resync branch on the host
without reading the device. The CG reads its stop test to the host once
per iteration; on a CUDA device the projection's operator and its
multigrid preconditioner replay as CUDA graphs, with the coefficient
set-up (face coefficients and the coarsened hierarchy from ``rho``) a
third graph replayed once per projection, so every solve sees its own
step's density (bitwise the eager solve).

The step also runs on block-resident state (``parallel.spmd.Blocks``,
from :meth:`INSVCStaggeredIntegrator.on_mesh` through
``parallel.mesh.make_sharded_vc_step``): every stencil of the step runs
its whole-grid body as a halo stencil on the padded blocks (the walled
shear and the wall masks by global index), the reductions combine
per-block partial sums, the CG takes Blocks, its preconditioner is the
multigrid V-cycle on blocks (or the pencil FFT's Poisson solve), and
the level set is advected and reinitialized on halos. The projection
there is eager (its graphs capture whole-tensor buffers).
"""

from __future__ import annotations

import copy
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.bc import (DIRICHLET, NEUMANN, AxisBC, DomainBC,
                                SideBC, neumann_axis, periodic_axis)
from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ins_walls import pin_normal
from ibamr_tpu_torch.ops import stencils
from ibamr_tpu_torch.ops.convection import (GHOST_WIDTH, convective_rate,
                                            convective_rate_bc)
from ibamr_tpu_torch.ops.godunov import advect
from ibamr_tpu_torch.parallel.spmd import Blocks, halo_stencil
from ibamr_tpu_torch.physics import level_set as ls
from ibamr_tpu_torch.solvers import fft, krylov
from ibamr_tpu_torch.solvers.multigrid import PoissonMultigrid
from ibamr_tpu_torch.utils.cuda_graph import Graphed

Vel = Tuple[torch.Tensor, ...]
take = stencils.axis_slice


class VCINSState(NamedTuple):
    u: Vel
    p: torch.Tensor
    phi: torch.Tensor        # level set (negative = phase 0)
    n_prev: Vel
    t: torch.Tensor          # 0-dim time
    k: int                   # step counter (host)


def _cc_to_face(f: torch.Tensor, d: int) -> torch.Tensor:
    return 0.5 * (f + torch.roll(f, 1, d))


def _cc_to_faces(f) -> Vel:
    """``f`` averaged to every face centering (a halo stencil on
    Blocks)."""
    return halo_stencil(
        lambda q: tuple(_cc_to_face(q, d) for d in range(q.ndim)), 1)(f)


class _Projection(NamedTuple):
    """The pieces of one variable-density projection: the face
    coefficients, the (negated, SPD) operator and its preconditioner;
    ``inv_out`` is the open outlet's half-cell coefficient."""
    inv_rho_face: Vel
    A: Callable
    M: Callable
    inv_out: Optional[torch.Tensor]


class INSVCStaggeredIntegrator:
    """Two-phase variable-coefficient INS."""

    def __init__(self, grid: StaggeredGrid,
                 rho0: float = 1.0, rho1: float = 1.0,
                 mu0: float = 0.01, mu1: float = 0.01,
                 sigma: float = 0.0,
                 gravity: Optional[Sequence[float]] = None,
                 convective_op_type: str = "upwind",
                 interface_eps: Optional[float] = None,
                 reinit_interval: int = 10,
                 cg_tol: float = 1e-8, cg_maxiter: int = 200,
                 precond: str = "mg",
                 wall_axes: Optional[Sequence[bool]] = None,
                 tangential=None,
                 open_outlet: bool = False,
                 still_level: Optional[float] = None,
                 dtype=torch.float32, device="cuda"):
        self.grid = grid
        self.device = resolve_device(device)
        self.rho = (float(rho0), float(rho1))
        self.mu = (float(mu0), float(mu1))
        self.sigma = float(sigma)
        self.gravity = (tuple(float(g) for g in gravity)
                        if gravity is not None else (0.0,) * grid.dim)
        self.convective_op_type = convective_op_type
        self.eps = (interface_eps if interface_eps is not None
                    else 1.5 * max(grid.dx))
        self.reinit_interval = int(reinit_interval)
        self.cg_tol = float(cg_tol)
        self.cg_maxiter = int(cg_maxiter)
        # wall_axes[d]: no-slip walls on both sides of axis d, in the
        # pinned-face storage of integrators/ins_walls.py;
        # tangential[(d, e, side)]: component d's velocity on the side
        # (0 = lo, 1 = hi) wall of axis e (a moving lid)
        self.wall_axes = (tuple(bool(w) for w in wall_axes)
                          if wall_axes is not None
                          else (False,) * grid.dim)
        self.tangential = dict(tangential or {})
        if precond not in ("fft", "mg"):
            raise ValueError(f"unknown preconditioner {precond!r}")
        if any(self.wall_axes) and precond == "fft":
            raise ValueError(
                "wall-bounded VC-INS requires the 'mg' preconditioner "
                "(the FFT inverse assumes a fully periodic domain)")
        self.precond = precond
        self.dtype = dtype
        # open_outlet: axis 0 becomes wall (lo) -> outlet (hi); the
        # axis-0 wrap slot of u_0 stores the outlet face, and gravity is
        # referenced to the still density profile so the outlet's p = 0
        # is exact for still water
        self.open_outlet = bool(open_outlet)
        self.still_level = still_level
        self._rho_still = None
        if self.open_outlet:
            if precond != "mg":
                raise ValueError(
                    "open_outlet requires the 'mg' preconditioner "
                    "(the FFT inverse assumes a periodic domain)")
            if self.wall_axes[0]:
                raise ValueError(
                    "open_outlet replaces axis 0's boundary pair "
                    "(wall lo -> outlet hi); wall_axes[0] must be "
                    "False")
            if still_level is None and any(
                    gv != 0.0 for gv in self.gravity):
                raise ValueError(
                    "open_outlet with gravity needs still_level (the "
                    "still free-surface height referencing the "
                    "hydrostatic profile so outlet p = 0 is exact)")
            if any(gv != 0.0 for gv in self.gravity[:grid.dim - 1]):
                raise ValueError(
                    "open_outlet supports gravity along the LAST axis "
                    "only (the still hydrostatic reference is a "
                    "z-profile; a transverse gravity component would "
                    "silently break the outlet's p = 0 exactness)")
            if still_level is not None:
                zax = grid.dim - 1
                z = grid.cell_centers(dtype, self.device)[zax]
                phi_still = (z - float(still_level)) * torch.ones(
                    grid.n, dtype=dtype, device=self.device)
                self._rho_still = self.density(phi_still)
        self._graphs = {}
        self._pencil = None          # the FFT preconditioner on a mesh
        self.last_solve_stats = {}
        self.cg_iterations = 0      # CG iterations over all projections
        self.projections = 0

    def on_mesh(self, mesh) -> "INSVCStaggeredIntegrator":
        """A shallow copy that steps block-resident state on ``mesh``
        (no graphed projection; the FFT preconditioner through the
        pencils). A grid the pencils cannot split raises."""
        from ibamr_tpu_torch.parallel.fftpar import PencilFFT

        integ = copy.copy(self)
        integ._graphs = {}
        if self.precond == "fft":
            integ._pencil = PencilFFT(self.grid, mesh)
        return integ

    def halo_width(self) -> Tuple[int, ...]:
        """Per grid axis, the widest ghost layer the block-resident step
        reads: the Godunov advection's 2, the surface tension's 3
        (curvature, then a face average), the convection scheme's
        (one more on a wall axis, where its pinned ghosts read one cell
        past the width)."""
        conv = (0 if self.convective_op_type == "none"
                else GHOST_WIDTH[self.convective_op_type])
        base = max(2, 3 if self.sigma else 1)
        return tuple(max(base, conv + (1 if w and conv else 0))
                     for w in self.wall_axes)

    # -- wall helpers --------------------------------------------------------
    def _pin_normal(self, c: torch.Tensor, d: int) -> torch.Tensor:
        """Zero the pinned wall-face slot of component d (wall axes)."""
        return pin_normal(c, d, self.wall_axes)

    def _proj_bc(self) -> DomainBC:
        """Pressure-Poisson BCs: Neumann at walls, periodic elsewhere."""
        return DomainBC(axes=tuple(
            neumann_axis() if w else AxisBC() for w in self.wall_axes))

    # -- material fields -----------------------------------------------------
    def density(self, phi: torch.Tensor) -> torch.Tensor:
        H = ls.heaviside(phi, self.eps)
        return self.rho[0] + (self.rho[1] - self.rho[0]) * H

    def viscosity(self, phi: torch.Tensor) -> torch.Tensor:
        H = ls.heaviside(phi, self.eps)
        return self.mu[0] + (self.mu[1] - self.mu[0]) * H

    # -- variable-density projection -----------------------------------------
    def _face_coeffs(self, rho_cc: torch.Tensor, face_rule: str) -> Vel:
        """1/rho on the faces ("harmonic": the mean of 1/rho;
        "arithmetic": 1 over the mean of rho), pinned at wall faces."""
        g = self.grid
        if face_rule == "harmonic":
            inv = _cc_to_faces(1.0 / rho_cc)
        elif face_rule == "arithmetic":
            inv = tuple(1.0 / c for c in _cc_to_faces(rho_cc))
        else:
            raise ValueError(f"unknown face_rule {face_rule!r}")
        return tuple(self._pin_normal(c, d) for d, c in enumerate(inv))

    def _open_bc(self) -> DomainBC:
        axes = [AxisBC(SideBC(NEUMANN), SideBC(DIRICHLET))]
        for d in range(1, self.grid.dim):
            axes.append(neumann_axis() if self.wall_axes[d]
                        else periodic_axis())
        return DomainBC(axes=tuple(axes))

    def _axis0_fluxes(self, p, inv_rho_face, inv_out, dt):
        """The open outlet's axis-0 face fluxes [wall 0, interior,
        outlet half-cell] (n0 + 1 planes)."""
        dx = self.grid.dx
        n0 = self.grid.n[0]
        gp_int = (take(p, 0, 1, n0) - take(p, 0, 0, n0 - 1)) / dx[0]
        flux_int = dt * take(inv_rho_face[0], 0, 1, n0) * gp_int
        flux_out = inv_out * (0.0 - take(p, 0, n0 - 1, n0)) / (0.5 * dx[0])
        return torch.cat([torch.zeros_like(flux_out), flux_int, flux_out],
                         dim=0)

    def _build_projection(self, rho_cc: torch.Tensor, dt: float,
                          face_rule: str, mg_sink=None) -> _Projection:
        """The eager projection pieces for this density. ``mg_sink``
        receives the multigrid hierarchy (the graph capture keeps it)."""
        g = self.grid
        dx = g.dx
        inv_rho_face = self._face_coeffs(rho_cc, face_rule)
        inv_out = None
        if self.open_outlet:
            n0 = g.n[0]
            inv_out = dt * take(1.0 / rho_cc, 0, n0 - 1, n0)

            def A(p):
                fx = self._axis0_fluxes(p, inv_rho_face, inv_out, dt)
                div = (take(fx, 0, 1, n0 + 1) - take(fx, 0, 0, n0)) / dx[0]
                for d in range(1, g.dim):
                    flux = dt * inv_rho_face[d] * (
                        (p - torch.roll(p, 1, d)) / dx[d])
                    div = div + (torch.roll(flux, -1, d) - flux) / dx[d]
                return -div

            mg = PoissonMultigrid(g.n, self._open_bc(), dx, D=dt / rho_cc,
                                  dtype=rho_cc.dtype, device=rho_cc.device)

            def M(r):
                return -mg.vcycle(torch.zeros_like(r), r)
        else:
            def A(p):
                gp = stencils.gradient(p, dx)
                flux = tuple(dt * rf * gc
                             for rf, gc in zip(inv_rho_face, gp))
                return -stencils.divergence(flux, dx)

            if self.precond == "mg":
                bc = (self._proj_bc() if any(self.wall_axes)
                      else DomainBC.periodic(g.dim))
                mg = PoissonMultigrid(g.n, bc, dx, D=dt / rho_cc,
                                      dtype=rho_cc.dtype,
                                      device=rho_cc.device)

                def M(r):
                    r = r - torch.mean(r)
                    q = mg.vcycle(torch.zeros_like(r), r)
                    return -(q - torch.mean(q))
            else:
                mg = None
                rho_ref = min(self.rho)
                if isinstance(rho_cc, Blocks):
                    poisson = self._pencil.poisson
                else:
                    def poisson(x):
                        return fft.solve_poisson_periodic(x, dx)

                def M(r):
                    return -poisson(r / (dt / rho_ref))
        if mg_sink is not None:
            mg_sink["mg"] = mg
        return _Projection(inv_rho_face, A, M, inv_out)

    def _graphed_projection(self, rho_cc: torch.Tensor, dt: float,
                            face_rule: str) -> _Projection:
        """The projection pieces replayed as CUDA graphs: the set-up
        graph recomputes the face coefficients and the multigrid
        hierarchy from ``rho_cc`` into its static buffers, which the
        operator and preconditioner graphs read."""
        key = (float(dt), face_rule, rho_cc.dtype)
        entry = self._graphs.get(key)
        if entry is None:
            sink = {}

            def setup(rho):
                proj = self._build_projection(rho, dt, face_rule,
                                              mg_sink=sink)
                sink["proj"] = proj
                return (proj.inv_rho_face, proj.inv_out)

            setup_g = Graphed(setup, rho_cc)
            proj = sink["proj"]          # the captured run's pieces
            example = torch.zeros(self.grid.n, dtype=rho_cc.dtype,
                                  device=rho_cc.device)
            A_g = Graphed(proj.A, example)
            M_g = Graphed(proj.M, example)
            entry = (setup_g, _Projection(
                proj.inv_rho_face, lambda v: A_g(v).clone(),
                lambda v: M_g(v).clone(), proj.inv_out))
            self._graphs[key] = entry
        setup_g, proj = entry
        setup_g(rho_cc)
        return proj

    def projection(self, rho_cc: torch.Tensor, dt: float,
                   face_rule: str = "harmonic",
                   graphed: Optional[bool] = None) -> _Projection:
        """The projection pieces for ``rho_cc``: graphed on a CUDA
        device with the multigrid preconditioner, eager otherwise (or
        when ``graphed`` is False, or on Blocks)."""
        if graphed is None:
            graphed = (isinstance(rho_cc, torch.Tensor)
                       and rho_cc.device.type == "cuda"
                       and self.precond == "mg")
        if graphed:
            return self._graphed_projection(rho_cc, dt, face_rule)
        return self._build_projection(rho_cc, dt, face_rule)

    def _cg(self, proj: _Projection, b: torch.Tensor):
        # clamp the tolerance to the dtype's reachable floor: an f32 run
        # configured with an f64-grade tolerance iterates to its
        # roundoff floor and stops
        eps = float(torch.finfo(b.dtype).eps)
        tol_eff = max(self.cg_tol, 20.0 * eps)
        res = krylov.cg(proj.A, b, M=proj.M, tol=tol_eff,
                        maxiter=self.cg_maxiter)
        self.last_solve_stats = {"solver": "cg", "iters": res.iters}
        self.cg_iterations += res.iters
        self.projections += 1
        return res

    def project_with(self, proj: _Projection, u: Vel,
                     dt: float) -> Tuple[Vel, torch.Tensor]:
        """Solve div((dt/rho) grad p) = div u* with ``proj``'s pieces and
        correct u <- u* - (dt/rho) grad p."""
        g = self.grid
        dx = g.dx
        rf = proj.inv_rho_face
        if self.open_outlet:
            n0 = g.n[0]
            ux = u[0]
            faces0 = torch.cat([torch.zeros_like(take(ux, 0, 0, 1)),
                                take(ux, 0, 1, n0), take(ux, 0, 0, 1)],
                               dim=0)
            div = (take(faces0, 0, 1, n0 + 1)
                   - take(faces0, 0, 0, n0)) / dx[0]
            for d in range(1, g.dim):
                div = div + (torch.roll(u[d], -1, d) - u[d]) / dx[d]
            p = self._cg(proj, -div).x
            corr_out = proj.inv_out * (0.0 - take(p, 0, n0 - 1, n0)) \
                / (0.5 * dx[0])
            u_new = [torch.cat(
                [take(u[0], 0, 0, 1) - corr_out,
                 take(u[0], 0, 1, n0) - dt * take(rf[0], 0, 1, n0)
                 * (take(p, 0, 1, n0) - take(p, 0, 0, n0 - 1)) / dx[0]],
                dim=0)]
            for d in range(1, g.dim):
                u_new.append(self._pin_normal(
                    u[d] - dt * rf[d] * ((p - torch.roll(p, 1, d)) / dx[d]),
                    d))
            return tuple(u_new), p
        div = stencils.divergence(u, dx)
        div = div - torch.mean(div)
        res = self._cg(proj, -div)
        p = res.x - torch.mean(res.x)
        gp = stencils.gradient(p, dx)
        u_new = tuple(self._pin_normal(c - dt * r * gc, d)
                      for d, (c, r, gc) in enumerate(zip(u, rf, gp)))
        return u_new, p

    def project_vc(self, u: Vel, rho_cc: torch.Tensor, dt: float,
                   face_rule: str = "harmonic") -> Tuple[Vel, torch.Tensor]:
        """Solve div((dt/rho) grad p) = div u*, correct
        u <- u* - (dt/rho) grad p. ``face_rule``: "harmonic" (the mean
        of 1/rho, the rule the multigrid's coefficient coarsening uses)
        or "arithmetic" (1 / mean(rho), the conservative integrator's
        rule). The correction uses the operator's coefficient, so
        div(u_new) = 0 holds discretely."""
        return self.project_with(self.projection(rho_cc, dt, face_rule),
                                 u, dt)

    # -- variable-viscosity stress -------------------------------------------
    def _viscous_force(self, u: Vel, mu_cc: torch.Tensor) -> Vel:
        """div(2 mu D(u)) on the MAC grid (explicit): diagonal terms with
        cell-centered mu, off-diagonal terms with mu averaged to the
        edges; across a wall axis the wall shear is the half-cell
        one-sided gradient against the wall's tangential velocity (on
        the wall faces, marked by global index: a halo stencil of radius
        1 on Blocks)."""
        dim = self.grid.dim
        acc = halo_stencil(lambda f: self._viscous_body(f[:dim], f[dim]),
                           1)((*u, mu_cc))
        return tuple(self._pin_normal(a, d) for d, a in enumerate(acc))

    def _viscous_body(self, u: Vel, mu_cc: torch.Tensor) -> Vel:
        dim = self.grid.dim
        dx = self.grid.dx
        out = []
        for d in range(dim):
            acc = None
            for j in range(dim):
                if j == d:
                    dudx = (torch.roll(u[d], -1, d) - u[d]) / dx[d]
                    tau = 2.0 * mu_cc * dudx
                    term = (tau - torch.roll(tau, 1, d)) / dx[d]
                else:
                    dudj = (u[d] - torch.roll(u[d], 1, j)) / dx[j]
                    dujd = (u[j] - torch.roll(u[j], 1, d)) / dx[d]
                    mu_e = 0.25 * (mu_cc + torch.roll(mu_cc, 1, d)
                                   + torch.roll(mu_cc, 1, j)
                                   + torch.roll(torch.roll(mu_cc, 1, d),
                                                1, j))
                    tau = mu_e * (dudj + dujd)
                    if self.wall_axes[j]:
                        # the lo wall face carries the lo shear; the hi
                        # wall face (past the last cell) the hi shear
                        is_lo, is_hi = stencils.wall_boundary_masks(
                            u[d].shape, j, u[d].device)
                        mu_d = 0.5 * (mu_cc + torch.roll(mu_cc, 1, d))
                        v_lo = self.tangential.get((d, j, 0), 0.0)
                        v_hi = self.tangential.get((d, j, 1), 0.0)
                        t_lo = mu_d * 2.0 * (u[d] - v_lo) / dx[j]
                        t_hi = mu_d * 2.0 * (v_hi - u[d]) / dx[j]
                        tau = torch.where(is_lo, t_lo, tau)
                        term = torch.where(
                            is_hi, (t_hi - tau) / dx[j],
                            (torch.roll(tau, -1, j) - tau) / dx[j])
                    else:
                        term = (torch.roll(tau, -1, j) - tau) / dx[j]
                acc = term if acc is None else acc + term
            out.append(acc)
        return tuple(out)

    # -- surface tension + gravity -------------------------------------------
    def _interface_forces(self, phi: torch.Tensor,
                          rho_cc: torch.Tensor) -> Vel:
        """CSF surface tension plus buoyancy as the density anomaly
        (rho - mean(rho)) g (net-force free); with an open outlet the
        anomaly is taken against the still hydrostatic profile. On
        Blocks, one halo stencil (radius 3 with surface tension: the
        curvature's 2 and a face average)."""
        if self._rho_still is not None:
            drho = rho_cc - self._rho_still
        else:
            drho = rho_cc - torch.mean(rho_cc)
        out = halo_stencil(lambda f: self._interface_body(*f),
                           3 if self.sigma else 1)((phi, drho))
        return tuple(self._pin_normal(f, d) for d, f in enumerate(out))

    def _interface_body(self, phi: torch.Tensor, drho: torch.Tensor) -> Vel:
        g = self.grid
        dx = g.dx
        kap = (ls.curvature(phi, dx, wall_axes=self.wall_axes)
               if self.sigma else None)
        dlt = ls.delta(phi, self.eps) if self.sigma else None
        out = []
        for d in range(g.dim):
            f = _cc_to_face(drho, d) * self.gravity[d]
            if self.sigma:
                gphi = (phi - torch.roll(phi, 1, d)) / dx[d]
                f = f + self.sigma * _cc_to_face(kap * dlt, d) * gphi
            out.append(f)
        return tuple(out)

    # -- state / stepping ----------------------------------------------------
    def _field(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(dtype=self.dtype, device=self.device)
        return torch.tensor(np.array(a), dtype=self.dtype,
                            device=self.device)

    def initialize(self, phi0, u0_arrays: Optional[Vel] = None
                   ) -> VCINSState:
        g = self.grid
        phi = self._field(phi0)
        if u0_arrays is not None:
            u = tuple(self._field(c) for c in u0_arrays)
        else:
            u = tuple(torch.zeros(g.n, dtype=self.dtype, device=self.device)
                      for _ in range(g.dim))
        zeros = lambda: torch.zeros(g.n, dtype=self.dtype,  # noqa: E731
                                    device=self.device)
        return VCINSState(
            u=u, p=zeros(), phi=phi,
            n_prev=tuple(zeros() for _ in range(g.dim)),
            t=torch.zeros((), dtype=self.dtype, device=self.device), k=0)

    def _ab2(self, u: Vel, n_prev: Vel, k: int) -> Tuple[Vel, Vel]:
        """(N(u^n), the AB2-extrapolated rate); forward Euler at k = 0."""
        if self.convective_op_type == "none":
            n_curr = tuple(torch.zeros_like(c) for c in u)
            return n_curr, n_curr
        n_curr = self._convective(u)
        c1, c2 = (1.0, 0.0) if k == 0 else (1.5, -0.5)
        return n_curr, tuple(c1 * a + c2 * b for a, b in zip(n_curr, n_prev))

    def step(self, state: VCINSState, dt: float,
             f: Optional[Vel] = None) -> VCINSState:
        g = self.grid
        dx = g.dx
        k = int(state.k)
        u, p, phi = state.u, state.p, state.phi

        rho_cc = self.density(phi)
        mu_cc = self.viscosity(phi)
        # harmonic-density face weights: the projection's own (1/rho)
        # operator, so the predictor's pressure gradient and the
        # increment correction stay consistent
        inv_rho_face = _cc_to_faces(1.0 / rho_cc)
        n_curr, n_star = self._ab2(u, state.n_prev, k)
        visc = self._viscous_force(u, mu_cc)
        body = self._interface_forces(phi, rho_cc)
        gp = stencils.gradient(p, dx)

        u_star = []
        for d in range(g.dim):
            rhs = (-n_star[d]
                   + (visc[d] + body[d] - gp[d]) * inv_rho_face[d])
            if f is not None:
                rhs = rhs + f[d] * inv_rho_face[d]
            u_star.append(self._pin_normal(u[d] + dt * rhs, d))

        if self.open_outlet:
            # seed the outlet face (axis-0 wrap slot) by zero-gradient
            # extrapolation; the projection then sets it
            n0 = g.n[0]
            u_star[0] = torch.cat([take(u_star[0], 0, n0 - 1, n0),
                                   take(u_star[0], 0, 1, n0)], dim=0)

        u_new, dp = self.project_vc(tuple(u_star), rho_cc, dt)
        phi_new = self._transport_level_set(phi, u_new, dt, k)
        return VCINSState(u=u_new, p=p + dp, phi=phi_new, n_prev=n_curr,
                          t=state.t + dt, k=k + 1)

    def _convective(self, u: Vel) -> Vel:
        """N(u): the BC-aware ghost-padded path when any axis is walled,
        periodic rolls otherwise."""
        if any(self.wall_axes):
            return convective_rate_bc(
                u, self.grid.dx, scheme=self.convective_op_type,
                wall_axes=self.wall_axes, wall_tangential=self.tangential)
        return halo_stencil(convective_rate,
                            GHOST_WIDTH[self.convective_op_type])(
            tuple(u), self.grid.dx, self.convective_op_type)

    def _reinit_due(self, k: int) -> bool:
        # the reference's jnp.mod(k + 1, 0) is 0: interval 0 reinitializes
        # every step
        iv = self.reinit_interval
        return iv == 0 or (k + 1) % iv == 0

    def _transport_level_set(self, phi, u_new: Vel, dt, k: int):
        """Godunov advection and the cadenced reinitialization (walled
        axes: the wall-face fluxes vanish, so phase volume is
        conserved in the closed box too)."""
        wa = self.wall_axes if any(self.wall_axes) else None
        phi_new = advect(phi, u_new, self.grid.dx, dt, wall_axes=wa)
        if self._reinit_due(k):
            phi_new = ls.reinitialize(phi_new, self.grid.dx, iters=20,
                                      wall_axes=wa)
        return phi_new

    # -- diagnostics ---------------------------------------------------------
    def max_divergence(self, state: VCINSState) -> torch.Tensor:
        return torch.max(torch.abs(stencils.divergence(state.u,
                                                       self.grid.dx)))

    def heavy_phase_volume(self, state: VCINSState) -> torch.Tensor:
        """Volume of the DENSER phase: phi > 0 carries rho1, so the heavy
        phase is phi > 0 when rho1 >= rho0, else phi < 0 (a regression
        pin: the phi < 0 volume alone normalized a drop's drift by the
        ambient volume)."""
        vol_neg = ls.phase_volume(state.phi, self.grid, self.eps)
        total = float(self.grid.num_cells) * self.grid.cell_volume
        if self.rho[1] >= self.rho[0]:
            return total - vol_neg
        return vol_neg


class VCConsState(NamedTuple):
    u: Vel
    p: torch.Tensor
    phi: torch.Tensor
    rho: torch.Tensor        # conservatively transported density
    t: torch.Tensor
    k: int


class INSVCConservativeIntegrator(INSVCStaggeredIntegrator):
    """Conservative-form variable-coefficient INS: density is a conserved
    state transported by upwind mass fluxes, and momentum is advected
    with the same fluxes interpolated to each momentum control volume.
    Face momentum densities are arithmetic means of the cells, and the
    projection uses the matching arithmetic coefficient, so uniform
    translation of a density jump is an exact discrete equilibrium and
    total momentum is conserved under net-force-free forcing.
    ``rho_resync_interval`` re-slaves rho to phi on a cadence."""

    def __init__(self, *args, rho_resync_interval: int = 0, **kw):
        super().__init__(*args, **kw)
        self.rho_resync_interval = int(rho_resync_interval)
        if self.convective_op_type not in ("upwind", "none"):
            raise ValueError(
                "the conservative form advects momentum with upwind "
                "mass fluxes; convective_op_type must be 'upwind' "
                f"(or 'none' for the Stokes limit), got "
                f"{self.convective_op_type!r}")

    def _mass_fluxes(self, u: Vel, rho_cc: torch.Tensor) -> Vel:
        """Upwind mass flux rho*u through every (lower) cell face."""
        def body(*f):
            u, rho = f[:-1], f[-1]
            return tuple(u[d] * torch.where(u[d] > 0,
                                            torch.roll(rho, 1, d), rho)
                         for d in range(len(u)))

        return halo_stencil(lambda f: body(*f), 1)((*u, rho_cc))

    def _momentum_advection(self, u: Vel, F: Vel) -> Vel:
        """div(F u) on each momentum control volume, upwinding u_d by the
        sign of the interpolated mass flux (a halo stencil of radius 1
        on Blocks)."""
        dim = self.grid.dim
        return halo_stencil(
            lambda f: self._momentum_body(f[:dim], f[dim:]), 1)((*u, *F))

    def _momentum_body(self, u: Vel, F: Vel) -> Vel:
        dim = self.grid.dim
        dx = self.grid.dx
        out = []
        for d in range(dim):
            acc = None
            for j in range(dim):
                if j == d:
                    Fc = 0.5 * (F[d] + torch.roll(F[d], -1, d))
                    u_up = torch.where(Fc > 0, u[d],
                                       torch.roll(u[d], -1, d))
                    G = Fc * u_up
                    term = (G - torch.roll(G, 1, d)) / dx[d]
                else:
                    Fe = 0.5 * (F[j] + torch.roll(F[j], 1, d))
                    u_up = torch.where(Fe > 0, torch.roll(u[d], 1, j),
                                       u[d])
                    G = Fe * u_up
                    term = (torch.roll(G, -1, j) - G) / dx[j]
                acc = term if acc is None else acc + term
            out.append(acc)
        return tuple(out)

    def initialize(self, phi0, u0_arrays: Optional[Vel] = None
                   ) -> VCConsState:
        base = super().initialize(phi0, u0_arrays=u0_arrays)
        return VCConsState(u=base.u, p=base.p, phi=base.phi,
                           rho=self.density(base.phi), t=base.t, k=base.k)

    def step(self, state: VCConsState, dt: float,
             f: Optional[Vel] = None) -> VCConsState:
        g = self.grid
        dx = g.dx
        k = int(state.k)
        u, p, phi, rho = state.u, state.p, state.phi, state.rho
        mu_cc = self.viscosity(phi)

        # 1. mass transport (conservative)
        F = self._mass_fluxes(u, rho)
        rho_new = rho - dt * stencils.divergence(F, dx)

        # 2. momentum update with the same fluxes
        if self.convective_op_type == "none":
            adv = tuple(torch.zeros_like(u[0]) for _ in range(g.dim))
            rho_new = rho
        else:
            adv = self._momentum_advection(u, F)
        visc = self._viscous_force(u, mu_cc)
        body = self._interface_forces(phi, rho)
        gp = stencils.gradient(p, dx)
        rho_f, rho_new_f = _cc_to_faces(rho), _cc_to_faces(rho_new)
        u_star = []
        for d in range(g.dim):
            m = rho_f[d] * u[d]
            rhs = -adv[d] + visc[d] + body[d] - gp[d]
            if f is not None:
                rhs = rhs + f[d]
            u_star.append(self._pin_normal(
                (m + dt * rhs) / rho_new_f[d], d))

        # 3. projection with the matching arithmetic face coefficient
        u_new, dp = self.project_vc(tuple(u_star), rho_new, dt,
                                    face_rule="arithmetic")

        # 4. interface transport and the optional density re-slaving
        phi_new = self._transport_level_set(phi, u_new, dt, k)
        if self.rho_resync_interval and \
                (k + 1) % self.rho_resync_interval == 0:
            rho_new = self.density(phi_new)
        return VCConsState(u=u_new, p=p + dp, phi=phi_new, rho=rho_new,
                           t=state.t + dt, k=k + 1)

    def total_mass(self, state: VCConsState) -> torch.Tensor:
        return torch.sum(state.rho) * self.grid.cell_volume

    def total_momentum(self, state: VCConsState) -> Vel:
        """Arithmetic-face momentum: the conserved quantity of this
        discretization."""
        return tuple(torch.sum(r * c) * self.grid.cell_volume
                     for r, c in zip(_cc_to_faces(state.rho), state.u))


def advance_vc_conservative(integ, state, dt: float, num_steps: int):
    return advance_vc(integ, state, dt, num_steps)


def advance_vc(integ: INSVCStaggeredIntegrator, state: VCINSState,
               dt: float, num_steps: int) -> VCINSState:
    """``num_steps`` fixed-dt steps (a loop where the reference scans);
    serves both forms."""
    for _ in range(num_steps):
        state = integ.step(state, dt)
    return state
