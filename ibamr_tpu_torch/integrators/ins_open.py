"""Navier-Stokes on inflow/outflow (open-boundary) boxes (port of
``ibamr_tpu/integrators/ins_open.py``).

Scheme: explicit convection (first-order upwind, or the stabilized PPM
operator) and a backward-Euler viscous step, with one coupled
velocity-pressure solve per step (``solvers/stokes.py``, FGMRES with the
projection preconditioner):

    (1/dt) u^{n+1} - mu lap u^{n+1} + grad p = (1/dt) u^n - N(u^n) + f
    div u^{n+1} = 0

The velocity is stored face-complete on non-periodic axes.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ibamr_tpu_torch.bc import pad_boundary_data
from ibamr_tpu_torch.ops.convection import _face_value_padded, _sh
from ibamr_tpu_torch.ops.stencils import axis_slice
from ibamr_tpu_torch.solvers.stokes import StaggeredStokesSolver, StokesBC

Vel = Tuple[torch.Tensor, ...]


class OpenINSState(NamedTuple):
    u: Vel
    p: torch.Tensor
    t: torch.Tensor


def _pad1(a: torch.Tensor, e: int, wrap: bool) -> torch.Tensor:
    """One layer along axis e on each side: periodic wrap or edge copy."""
    n = a.shape[e]
    lo, hi = ((axis_slice(a, e, n - 1, n), axis_slice(a, e, 0, 1)) if wrap
              else (axis_slice(a, e, 0, 1), axis_slice(a, e, n - 1, n)))
    return torch.cat([lo, a, hi], dim=e)


class INSOpenIntegrator:
    """Incompressible NS on a box with inflow, wall and open sides.
    ``bdry`` is the boundary data of
    :meth:`StaggeredStokesSolver.make_rhs`, ``{(d, e, side): value}``
    (inflow profiles, moving-wall tangential values), fixed at
    construction. ``convective_op_type`` is "upwind" or "stabilized_ppm"
    (PPM in the interior, blended to upwind within ``stab_band`` cells of
    the non-periodic boundaries). The default dtype is f64, as the
    reference's constructor declares; the drivers pass f32."""

    def __init__(self, n, dx, bc: StokesBC, mu: float, dt: float,
                 bdry: Optional[Dict] = None, rho: float = 1.0,
                 tol: float = 1e-8, dtype=torch.float64,
                 convective_op_type: str = "upwind", stab_band: int = 4,
                 device="cuda"):
        self.mu = float(mu)
        self.rho = float(rho)
        self.dt = float(dt)
        self.alpha = self.rho / self.dt
        op = convective_op_type.lower()
        if op not in ("upwind", "stabilized_ppm"):
            raise ValueError(f"unknown convective_op_type {op!r}")
        self.convective_op_type = op
        self.stab_band = int(stab_band)
        self.solver = StaggeredStokesSolver(
            n, dx, bc, alpha=self.alpha, mu=self.mu, tol=tol, dtype=dtype,
            device=device)
        self.bdry = dict(bdry or {})
        self.n = self.solver.n
        self.dx = self.solver.dx

    def initialize(self, u: Optional[Vel] = None) -> OpenINSState:
        s = self.solver
        kw = dict(dtype=s.dtype, device=s.device)
        if u is None:
            u = tuple(torch.zeros(sh, **kw) for sh in s.shapes)
        return OpenINSState(u=tuple(u), p=torch.zeros(s.n, **kw),
                            t=torch.zeros((), **kw))

    # -- advection helpers ---------------------------------------------------
    def _to_cells(self, u: Vel) -> Vel:
        """Every MAC component averaged to the cell centers (shape n)."""
        s = self.solver
        out = []
        for e, c in enumerate(u):
            if s.bc.periodic(e):
                out.append(0.5 * (c + torch.roll(c, -1, e)))
            else:
                n = c.shape[e]
                out.append(0.5 * (axis_slice(c, e, 0, n - 1)
                                  + axis_slice(c, e, 1, n)))
        return tuple(out)

    def _bdry_value(self, d: int, e: int, side: int, c: torch.Tensor):
        return pad_boundary_data(torch.as_tensor(
            self.bdry.get((d, e, side), 0.0), dtype=c.dtype,
            device=c.device), c, e)

    def _ghost_axis(self, c: torch.Tensor, d: int, e: int,
                    width: int) -> torch.Tensor:
        """``width`` ghost layers of component d along axis e with the
        boundary data: periodic wrap; along a tangential axis odd
        reflection about prescribed data and constant extrapolation past
        open sides; along its own axis (the boundary faces are slots 0 and
        -1) odd reflection through the boundary node or constant
        extrapolation."""
        s = self.solver
        n_e = c.shape[e]

        def take(lo, hi):
            return axis_slice(c, e, lo, hi)

        def rep(lo):
            return torch.cat([take(lo, lo + 1)] * width, dim=e)

        if s.bc.periodic(e):
            return torch.cat([take(n_e - width, n_e), c, take(0, width)],
                             dim=e)
        if e != d:
            lo_int = torch.flip(take(0, width), (e,))
            hi_int = torch.flip(take(n_e - width, n_e), (e,))
            lo_g = (2.0 * self._bdry_value(d, e, 0, c) - lo_int
                    if s.bc.side(e, 0).prescribed else rep(0))
            hi_g = (2.0 * self._bdry_value(d, e, 1, c) - hi_int
                    if s.bc.side(e, 1).prescribed else rep(n_e - 1))
        else:
            lo_g = (2.0 * take(0, 1) - torch.flip(take(1, width + 1), (e,))
                    if s.bc.side(e, 0).prescribed else rep(0))
            hi_g = (2.0 * take(n_e - 1, n_e)
                    - torch.flip(take(n_e - 1 - width, n_e - 1), (e,))
                    if s.bc.side(e, 1).prescribed else rep(n_e - 1))
        return torch.cat([lo_g, c, hi_g], dim=e)

    def _ghost_with_data(self, c: torch.Tensor, d: int) -> torch.Tensor:
        """One ghost layer on every axis, with the boundary data."""
        out = c
        for e in range(c.ndim):
            out = self._ghost_axis(out, d, e, width=1)
        return out

    def _advecting(self, uc: Vel, u: Vel, d: int, e: int) -> torch.Tensor:
        """Velocity component e at component d's faces."""
        s = self.solver
        if e == d:
            return u[d]
        ce = uc[e]
        if s.bc.periodic(d):
            return 0.5 * (ce + torch.roll(ce, 1, d))
        # interior faces: the mean of the adjacent cells; boundary: edge
        Gp = _pad1(ce, d, wrap=False)
        n = Gp.shape[d]
        return 0.5 * (axis_slice(Gp, d, 0, n - 1) + axis_slice(Gp, d, 1, n))

    def _advect(self, u: Vel) -> Vel:
        """First-order upwind ``N(u)_d = sum_e a_e d(u_d)/dx_e``."""
        s = self.solver
        uc = self._to_cells(u)
        out = []
        for d, c in enumerate(u):
            G = self._ghost_with_data(c, d)
            center = tuple(slice(1, -1) for _ in range(c.ndim))
            N = torch.zeros_like(c)
            for e in range(c.ndim):
                lo = list(center)
                hi = list(center)
                lo[e] = slice(0, -2)
                hi[e] = slice(2, None)
                dm = (c - G[tuple(lo)]) / s.dx[e]
                dp = (G[tuple(hi)] - c) / s.dx[e]
                a = self._advecting(uc, u, d, e)
                N = N + torch.where(a > 0, a * dm, a * dp)
            out.append(N)
        return tuple(out)

    def _stab_mask(self, shape, e: int, dtype, device) -> torch.Tensor:
        """Upwind blend weight along axis e: 1 at a non-periodic
        boundary, a linear ramp to 0 over ``stab_band`` cells."""
        s = self.solver
        n_e = shape[e]
        idx = torch.arange(n_e, dtype=dtype, device=device)
        chi = torch.zeros((n_e,), dtype=dtype, device=device)
        band = float(max(self.stab_band, 1))
        if not s.bc.periodic(e):
            chi = torch.maximum(chi, torch.clamp(1.0 - idx / band, 0.0, 1.0))
            chi = torch.maximum(chi, torch.clamp(
                1.0 - (n_e - 1 - idx) / band, 0.0, 1.0))
        sh = [1] * len(shape)
        sh[e] = n_e
        return chi.reshape(sh)

    def _advect_stabilized(self, u: Vel) -> Vel:
        """PPM-reconstructed advective derivatives in the interior,
        blended to first-order upwind within ``stab_band`` cells of the
        physical boundaries."""
        s = self.solver
        g = 3
        uc = self._to_cells(u)
        out = []
        for d, c in enumerate(u):
            N = torch.zeros_like(c)
            for e in range(c.ndim):
                a = self._advecting(uc, u, d, e)
                ap = _pad1(a, e, wrap=s.bc.periodic(e))
                n = ap.shape[e]
                a_lo = 0.5 * (a + axis_slice(ap, e, 0, n - 2))
                a_hi = 0.5 * (a + axis_slice(ap, e, 2, n))
                G = self._ghost_axis(c, d, e, width=g)
                n_e = c.shape[e]
                q_lo = _face_value_padded(G, a_lo, e, n_e, g, "ppm", shift=0)
                q_hi = _face_value_padded(G, a_hi, e, n_e, g, "ppm", shift=1)
                ppm_term = a * (q_hi - q_lo) / s.dx[e]
                c_m = _sh(G, e, -1, n_e, g)
                c_p = _sh(G, e, 1, n_e, g)
                up_term = torch.where(a > 0, a * (c - c_m) / s.dx[e],
                                      a * (c_p - c) / s.dx[e])
                chi = self._stab_mask(c.shape, e, c.dtype, c.device)
                N = N + chi * up_term + (1.0 - chi) * ppm_term
            out.append(N)
        return tuple(out)

    # -- the step --------------------------------------------------------------
    def step(self, state: OpenINSState, dt=None,
             f: Optional[Vel] = None) -> OpenINSState:
        """One step; ``dt`` None is the construction dt, else alpha =
        rho/dt is passed through the saddle solve."""
        s = self.solver
        if dt is None:
            dt, alpha = self.dt, None
            a_expl = self.alpha
        else:
            alpha = self.rho / dt
            a_expl = alpha
        if self.convective_op_type == "stabilized_ppm":
            N = self._advect_stabilized(state.u)
        else:
            N = self._advect(state.u)
        f_u = []
        for d in range(len(s.n)):
            r = a_expl * state.u[d] - self.rho * N[d]
            if f is not None:
                r = r + f[d]
            f_u.append(r)
        rhs = s.make_rhs(f_u=tuple(f_u), bdry=self.bdry)
        sol = s.solve(rhs, x0=(state.u, state.p), alpha=alpha)
        return OpenINSState(u=sol.u, p=sol.p, t=state.t + dt)

    def cfl_dt(self, state: OpenINSState, cfl: float = 0.5) -> float:
        """Largest stable dt by the advective CFL condition (a host
        read)."""
        umax = max(float(torch.max(torch.abs(c))) for c in state.u)
        if umax == 0.0:
            return math.inf
        return cfl * min(self.dx) / umax

    def max_divergence(self, state: OpenINSState) -> torch.Tensor:
        return torch.max(torch.abs(self.solver.divergence(state.u)))


def advance(integ: INSOpenIntegrator, state: OpenINSState, nsteps: int,
            f: Optional[Vel] = None) -> OpenINSState:
    """``nsteps`` steps at the construction dt (a loop where the reference
    scans)."""
    for _ in range(nsteps):
        state = integ.step(state, f=f)
    return state
