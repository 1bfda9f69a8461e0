"""Turbulence closures: Smagorinsky LES and Wilcox k-omega URANS (port of
``ibamr_tpu/physics/turbulence.py``).

- :func:`eddy_viscosity_smagorinsky`: nu_t = (Cs Delta)^2 |S|, composed
  with the variable-viscosity integrator (mu_eff = mu + rho nu_t), on
  one level or (``TwoLevelSmagorinskyINS``) on a refined window with
  each level's own filter width.
- :class:`KOmegaModel`: Wilcox (1988) two-equation transport with
  upwind advection, explicit variable-diffusivity diffusion, production
  from the resolved strain and pointwise-implicit dissipation.
- :func:`channel_komega`: the wall-resolved 1D channel in plus units,
  marched to steady state with local pseudo-time steps. The reference's
  ``lax.fori_loop`` of fused 1D ops becomes a loop; on a CUDA device a
  chunk of iterations replays as one CUDA graph (bitwise the eager
  loop).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops import stencils
from ibamr_tpu_torch.utils.cuda_graph import Graphed

Vel = Tuple[torch.Tensor, ...]


# ---------------------------------------------------------------------------
# Smagorinsky LES
# ---------------------------------------------------------------------------

def eddy_viscosity_smagorinsky(u: Vel, dx: Sequence[float],
                               cs: float = 0.17,
                               wall_axes=None) -> torch.Tensor:
    """Cell-centered LES eddy viscosity nu_t = (Cs Delta)^2 |S| with
    Delta = (prod dx)^(1/dim) and |S| = sqrt(2 E:E); one-sided strain
    at the boundary layers of ``wall_axes``."""
    dim = len(u)
    delta = math.prod(float(h) for h in dx) ** (1.0 / dim)
    S = stencils.strain_rate_magnitude_cc(u, dx, wall_axes=wall_axes)
    return (cs * delta) ** 2 * S


def _vc_step_with_extra_viscosity(vc, state, dt: float,
                                  mu_extra: torch.Tensor):
    """One VC step with ``viscosity(phi) + mu_extra``: the bound method
    is overridden for this call only and restored after it (do not
    interleave two models over one integrator from different threads)."""
    orig = vc.viscosity
    vc.viscosity = lambda phi: orig(phi) + mu_extra
    try:
        return vc.step(state, dt)
    finally:
        vc.viscosity = orig


class SmagorinskyINS:
    """Single-phase LES: the VC momentum machinery with
    mu_eff = mu + rho nu_t(u) refreshed from the resolved field every
    step (FFT-preconditioned periodic projection, or the multigrid one
    with walls)."""

    def __init__(self, grid: StaggeredGrid, mu: float, rho: float = 1.0,
                 cs: float = 0.17, convective_op_type: str = "upwind",
                 wall_axes=None, dtype=torch.float32, device="cuda"):
        from ibamr_tpu_torch.integrators.ins_vc import \
            INSVCStaggeredIntegrator

        self.grid = grid
        self.mu = float(mu)
        self.rho = float(rho)
        self.cs = float(cs)
        self.dtype = dtype
        walls = wall_axes is not None and any(wall_axes)
        self._vc = INSVCStaggeredIntegrator(
            grid, rho0=rho, rho1=rho, mu0=mu, mu1=mu,
            convective_op_type=convective_op_type,
            reinit_interval=0, precond="mg" if walls else "fft",
            wall_axes=wall_axes, dtype=dtype, device=device)
        self.device = self._vc.device

    def initialize(self, u0: Optional[Vel] = None):
        return self._vc.initialize(
            torch.zeros(self.grid.n, dtype=self.dtype, device=self.device),
            u0_arrays=u0)

    def step(self, state, dt: float):
        """Freeze mu_eff from the current resolved field, then take the
        VC step with that viscosity."""
        mu_t = self.rho * eddy_viscosity_smagorinsky(
            state.u, self.grid.dx, self.cs, wall_axes=self._vc.wall_axes)
        return _vc_step_with_extra_viscosity(self._vc, state, dt, mu_t)


class TwoLevelSmagorinskyINS:
    """LES in a refined window: the composite two-level INS core advances
    both levels with an explicit Smagorinsky eddy-stress force per level,
    each level's nu_t from its own resolved strain and filter width
    (coarse: the periodic VC stress divergence; fine: the ghost-extended
    box twins of ``amr_ins``). Molecular viscosity stays in the core."""

    def __init__(self, grid: StaggeredGrid, box, mu: float,
                 rho: float = 1.0, cs: float = 0.17,
                 convective: bool = True, proj_tol: float = 1e-9,
                 proj_m: int = 24, proj_restarts: int = 8,
                 device="cuda"):
        from ibamr_tpu_torch.amr_ins import TwoLevelINS
        from ibamr_tpu_torch.integrators.ins_vc import \
            INSVCStaggeredIntegrator

        self.core = TwoLevelINS(grid, box, rho=rho, mu=mu,
                                convective=convective, proj_tol=proj_tol,
                                proj_m=proj_m, proj_restarts=proj_restarts,
                                device=device)
        self.grid = grid
        self.box = box
        self.rho = float(rho)
        self.cs = float(cs)
        self._vc = INSVCStaggeredIntegrator(grid, rho0=rho, rho1=rho,
                                            mu0=mu, mu1=mu,
                                            reinit_interval=0,
                                            precond="fft", device=device)

    def initialize(self, uc):
        return self.core.initialize(uc)

    def _fine_strain(self, state, G: int = 3):
        from ibamr_tpu_torch.amr_ins import (box_strain_magnitude,
                                             fill_fine_ghosts_mac)

        uext = fill_fine_ghosts_mac(state.uf, state.uc, self.box, ghost=G)
        S = box_strain_magnitude(uext, self.core.dx_f, G, self.box.fine_n)
        delta_f = math.prod(float(h) for h in self.core.dx_f) \
            ** (1.0 / self.grid.dim)
        return uext, S, delta_f

    def _eddy_forces(self, state):
        from ibamr_tpu_torch.amr_ins import box_eddy_viscous_force

        g = self.grid
        mu_t_c = self.rho * eddy_viscosity_smagorinsky(state.uc, g.dx,
                                                       self.cs)
        f_c = self._vc._viscous_force(state.uc, mu_t_c)
        G = 3
        uext, S, delta_f = self._fine_strain(state, G)
        mu_ext = self.rho * (self.cs * delta_f) ** 2 * S
        f_f = box_eddy_viscous_force(uext, mu_ext, self.core.dx_f, G,
                                     self.box.fine_n)
        return f_c, f_f

    def step(self, state, dt: float):
        f_c, f_f = self._eddy_forces(state)
        return self.core.step(state, dt, f_c=f_c, f_f=f_f)

    def stable_dt(self, state, cfl: float = 0.5):
        """Advisory dt bound including the explicit eddy viscosity (the
        core's bound uses molecular mu only)."""
        dim = self.grid.dim
        mu = self.core.mu
        out = self.core.stable_dt(state, cfl)
        mu_t_c = self.rho * eddy_viscosity_smagorinsky(
            state.uc, self.grid.dx, self.cs)
        mu_eff_c = mu + torch.max(mu_t_c)
        out = torch.minimum(out, self.rho * min(self.grid.dx) ** 2
                            / (2.0 * dim * mu_eff_c))
        _, S, delta_f = self._fine_strain(state)
        mu_eff_f = mu + self.rho * (self.cs * delta_f) ** 2 * torch.max(S)
        return torch.minimum(out, self.rho * min(self.core.dx_f) ** 2
                             / (2.0 * dim * mu_eff_f))

    def max_divergence(self, state):
        return self.core.max_divergence(state)


# ---------------------------------------------------------------------------
# Wilcox k-omega
# ---------------------------------------------------------------------------

class KOmegaState(NamedTuple):
    k: torch.Tensor        # turbulent kinetic energy (cell-centered)
    omega: torch.Tensor    # specific dissipation rate


class KOmegaModel:
    """Wilcox (1988) k-omega closure on cell-centered fields:

      dk/dt + u.grad k  = P_k - beta* k omega
                          + div((nu + sigma* nu_t) grad k)
      dw/dt + u.grad w  = alpha (w/k) P_k - beta w^2
                          + div((nu + sigma nu_t) grad w)

    with nu_t = k/omega and P_k = nu_t |S|^2 limited to
    c_lim beta* k omega; pointwise-implicit sinks. ``wall_axes``: k = 0
    Dirichlet walls, omega imposed on the two near-wall layers by the
    smooth-wall asymptote 6 nu / (beta d^2)."""

    alpha: float = 5.0 / 9.0
    beta: float = 3.0 / 40.0
    beta_star: float = 9.0 / 100.0
    sigma: float = 0.5
    sigma_star: float = 0.5

    def __init__(self, grid: StaggeredGrid, nu: float,
                 prod_limit: float = 10.0, k_min: float = 1e-12,
                 omega_min: float = 1e-8, wall_axes=None):
        self.grid = grid
        self.nu = float(nu)
        self.prod_limit = float(prod_limit)
        self.k_min = float(k_min)
        self.omega_min = float(omega_min)
        self.wall_axes = (tuple(bool(w) for w in wall_axes)
                          if wall_axes is not None
                          else (False,) * grid.dim)

    def nu_t(self, st: KOmegaState) -> torch.Tensor:
        return st.k / torch.clamp(st.omega, min=self.omega_min)

    def _adv(self, q: torch.Tensor, u: Vel, dx) -> torch.Tensor:
        """First-order upwind flux-form advection by the MAC velocity."""
        flux_div = torch.zeros_like(q)
        for d in range(len(u)):
            uf = u[d]
            flux = uf * torch.where(uf > 0.0, torch.roll(q, 1, d), q)
            flux_div = flux_div + (torch.roll(flux, -1, d) - flux) / dx[d]
        return flux_div

    def _diff(self, q: torch.Tensor, D: torch.Tensor, dx,
              wall_dirichlet=None) -> torch.Tensor:
        """div(D grad q) with arithmetic face diffusivity; on wall axes the
        wall fluxes are one-sided against ``wall_dirichlet`` (None: zero
        flux)."""
        take = stencils.axis_slice
        out = torch.zeros_like(q)
        for d in range(q.ndim):
            Df = 0.5 * (D + torch.roll(D, 1, d))
            flux = Df * ((q - torch.roll(q, 1, d)) / dx[d])
            if self.wall_axes[d]:
                n = q.shape[d]
                interior = take(flux, d, 1, n)
                if wall_dirichlet is None:
                    f_lo = torch.zeros_like(take(flux, d, 0, 1))
                    f_hi = f_lo
                else:
                    wv = wall_dirichlet
                    f_lo = (take(D, d, 0, 1)
                            * 2.0 * (take(q, d, 0, 1) - wv) / dx[d])
                    f_hi = (take(D, d, n - 1, n)
                            * 2.0 * (wv - take(q, d, n - 1, n)) / dx[d])
                full = torch.cat([f_lo, interior, f_hi], dim=d)
                out = out + (take(full, d, 1, n + 1)
                             - take(full, d, 0, n)) / dx[d]
            else:
                out = out + (torch.roll(flux, -1, d) - flux) / dx[d]
        return out

    def _impose_omega_walls(self, w: torch.Tensor) -> torch.Tensor:
        if not any(self.wall_axes):
            return w
        w = w.clone()
        for d, is_wall in enumerate(self.wall_axes):
            if not is_wall:
                continue
            h = self.grid.dx[d]
            for layer in (0, 1):
                dist = (layer + 0.5) * h
                val = 6.0 * self.nu / (self.beta * dist * dist)
                idx = [slice(None)] * w.ndim
                idx[d] = slice(layer, layer + 1)
                w[tuple(idx)] = val
                idx[d] = slice(w.shape[d] - 1 - layer, w.shape[d] - layer)
                w[tuple(idx)] = val
        return w

    def advance(self, st: KOmegaState, u: Vel, dt: float) -> KOmegaState:
        dx = self.grid.dx
        k = torch.clamp(st.k, min=self.k_min)
        w = torch.clamp(st.omega, min=self.omega_min)
        nu_t = k / w
        S2 = stencils.strain_rate_magnitude_cc(
            u, dx, wall_axes=self.wall_axes) ** 2
        P_k = torch.minimum(nu_t * S2,
                            self.prod_limit * self.beta_star * k * w)
        k_star = (k + dt * (P_k - self._adv(k, u, dx)
                            + self._diff(k, self.nu
                                         + self.sigma_star * nu_t, dx,
                                         wall_dirichlet=0.0)))
        w_star = (w + dt * (self.alpha * (w / k) * P_k
                            - self._adv(w, u, dx)
                            + self._diff(w, self.nu
                                         + self.sigma * nu_t, dx)))
        k_new = k_star / (1.0 + dt * self.beta_star * w)
        w_new = self._impose_omega_walls(
            w_star / (1.0 + dt * self.beta * w))
        return KOmegaState(k=torch.clamp(k_new, min=self.k_min),
                           omega=torch.clamp(w_new, min=self.omega_min))


class KOmegaINS:
    """URANS: resolved INS (VC machinery, constant density) with
    mu_eff = mu + rho nu_t from a co-advanced k-omega pair."""

    def __init__(self, grid: StaggeredGrid, mu: float, rho: float = 1.0,
                 convective_op_type: str = "upwind",
                 wall_axes=None, dtype=torch.float32, device="cuda"):
        from ibamr_tpu_torch.integrators.ins_vc import \
            INSVCStaggeredIntegrator

        self.grid = grid
        self.mu = float(mu)
        self.rho = float(rho)
        self.dtype = dtype
        walls = wall_axes is not None and any(wall_axes)
        self.model = KOmegaModel(grid, nu=mu / rho, wall_axes=wall_axes)
        self._vc = INSVCStaggeredIntegrator(
            grid, rho0=rho, rho1=rho, mu0=mu, mu1=mu,
            convective_op_type=convective_op_type,
            reinit_interval=0, precond="mg" if walls else "fft",
            wall_axes=wall_axes, dtype=dtype, device=device)
        self.device = self._vc.device

    def initialize(self, u0: Optional[Vel] = None,
                   k0: float = 1e-4, omega0: float = 1.0):
        ins = self._vc.initialize(
            torch.zeros(self.grid.n, dtype=self.dtype, device=self.device),
            u0_arrays=u0)
        turb = KOmegaState(
            k=torch.full(self.grid.n, k0, dtype=self.dtype,
                         device=self.device),
            omega=torch.full(self.grid.n, omega0, dtype=self.dtype,
                             device=self.device))
        return ins, turb

    def step(self, ins_state, turb: KOmegaState, dt: float):
        mu_t = self.rho * self.model.nu_t(turb)
        ins_new = _vc_step_with_extra_viscosity(self._vc, ins_state, dt,
                                                mu_t)
        return ins_new, self.model.advance(turb, ins_new.u, dt)


# ---------------------------------------------------------------------------
# Wall-resolved k-omega channel
# ---------------------------------------------------------------------------

class ChannelProfile(NamedTuple):
    """Steady fully-developed channel solution in plus units."""
    y_plus: torch.Tensor
    u_plus: torch.Tensor
    k_plus: torch.Tensor
    omega_plus: torch.Tensor
    nu_t_plus: torch.Tensor


def _stretched_faces(re_tau: float, n: int, dy0: float) -> np.ndarray:
    """Geometric face distribution on [0, re_tau] with first spacing
    ``dy0`` (the stretching ratio by bisection, on the host)."""
    def span(r):
        if abs(r - 1.0) < 1e-12:
            return n * dy0
        return dy0 * (r ** n - 1.0) / (r - 1.0)

    lo, hi = 1.0, 1.5
    while span(hi) < re_tau:
        hi *= 1.02
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if span(mid) < re_tau:
            lo = mid
        else:
            hi = mid
    r = 0.5 * (lo + hi)
    dys = dy0 * r ** np.arange(n)
    faces = np.concatenate([[0.0], np.cumsum(dys)])
    faces *= re_tau / faces[-1]
    return faces


def channel_komega(re_tau: float = 590.0, n: int = 96,
                   dy0_plus: float = 0.4, iters: int = 40000,
                   cfl: float = 0.3, dtype=torch.float64, device="cuda",
                   chunk: int = 200) -> ChannelProfile:
    """Wall-resolved Wilcox k-omega solution of the fully-developed
    turbulent channel in plus units (nu = 1, u_tau = 1, half-height
    re_tau): total stress (1 + nu_t) du/dy = 1 - y/re_tau with the
    k/omega transport of :class:`KOmegaModel` reduced to 1D on a
    geometrically stretched grid; u = 0 and k = 0 at the wall, omega
    imposed on the two wall cells, symmetry at the centerline; ``iters``
    local pseudo-time steps. On a CUDA device ``chunk`` iterations replay
    as one CUDA graph."""
    dev = resolve_device(device)
    alpha = KOmegaModel.alpha
    beta = KOmegaModel.beta
    beta_star = KOmegaModel.beta_star
    sigma = KOmegaModel.sigma
    sigma_star = KOmegaModel.sigma_star

    faces = torch.as_tensor(_stretched_faces(re_tau, n, dy0_plus),
                            dtype=dtype, device=dev)
    yc = 0.5 * (faces[1:] + faces[:-1])
    dyc = faces[1:] - faces[:-1]
    dyf = yc[1:] - yc[:-1]
    omega_wall = 6.0 / (beta * yc ** 2)

    def interior_flux(q, D_face):
        return D_face * (q[1:] - q[:-1]) / dyf

    def edge(v, like):
        return (v.reshape(1) if isinstance(v, torch.Tensor)
                else torch.full((1,), v, dtype=like.dtype,
                                device=like.device))

    def div_flux(flux_int, flux_wall, flux_top):
        full = torch.cat([edge(flux_wall, flux_int), flux_int,
                          edge(flux_top, flux_int)])
        return (full[1:] - full[:-1]) / dyc

    def face_mean(D):
        return 0.5 * (D[1:] + D[:-1])

    def body(st):
        u, k, w = st
        w = torch.clamp(w, min=1e-10)
        k = torch.clamp(k, min=0.0)
        nu_t = k / w
        Du = 1.0 + nu_t
        fw_u = Du[0] * (u[0] - 0.0) / (yc[0] - 0.0)
        lap_u = div_flux(interior_flux(u, face_mean(Du)), fw_u, 0.0)
        g_int = (u[2:] - u[:-2]) / (yc[2:] - yc[:-2])
        g0 = u[0] / yc[0]
        gN = (u[-1] - u[-2]) / dyf[-1]
        grad_u = torch.cat([g0.reshape(1), g_int, gN.reshape(1)])
        P = torch.minimum(nu_t * grad_u ** 2, 10.0 * beta_star * k * w)

        Dk = 1.0 + sigma_star * nu_t
        fw_k = Dk[0] * (k[0] - 0.0) / yc[0]
        lap_k = div_flux(interior_flux(k, face_mean(Dk)), fw_k, 0.0)

        Dw = 1.0 + sigma * nu_t
        lap_w = div_flux(interior_flux(w, face_mean(Dw)), 0.0, 0.0)

        dt_u = cfl * dyc ** 2 / Du
        dt_s = cfl * dyc ** 2 / torch.maximum(Dk, Dw)

        u_new = u + dt_u * (lap_u + 1.0 / re_tau)
        k_star = k + dt_s * (P + lap_k)
        w_star = w + dt_s * (alpha * (w / torch.clamp(k, min=1e-12)) * P
                             + lap_w)
        k_new = k_star / (1.0 + dt_s * beta_star * w)
        w_new = w_star / (1.0 + dt_s * beta * w)
        w_new = torch.cat([omega_wall[:2], w_new[2:]])
        return (u_new, torch.clamp(k_new, min=0.0),
                torch.clamp(w_new, min=1e-10))

    u0 = torch.minimum(yc, torch.log(torch.clamp(yc, min=1.0)) / 0.41 + 5.0)
    st = (u0, 0.1 * torch.ones_like(yc), omega_wall)
    left = int(iters)
    if dev.type == "cuda" and left >= chunk:
        def run_chunk(s):
            for _ in range(chunk):
                s = body(s)
            return s

        graph = Graphed(run_chunk, st)
        while left >= chunk:
            st = graph(st)
            left -= chunk
        st = tuple(t.clone() for t in st)
    for _ in range(left):
        st = body(st)
    u, k, w = st
    return ChannelProfile(y_plus=yc, u_plus=u, k_plus=k, omega_plus=w,
                          nu_t_plus=k / torch.clamp(w, min=1e-10))
