"""Wave generation and damping (relaxation) zones for two-phase INS (port
of ``ibamr_tpu/physics/waves.py``).

Waves enter through a GENERATION zone where the solution is relaxed
toward an analytic incident-wave state, and leave through a DAMPING zone
relaxed toward still water: a post-step blend

    q <- (1 - w(x)) q + w(x) q_target,      w in [0, 1]

with the waves2Foam exponential ramp for w. Targets come from Stokes
wave theory at (x, z, t); irregular seas superpose linear components
along a leading axis. Level-set convention as ``integrators/ins_vc.py``:
phi < 0 is phase 0 (water), phi > 0 phase 1 (air), so
phi_target = z - elevation(x, t).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.physics.level_set import heaviside

Vel = Tuple[torch.Tensor, ...]


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip`` with scalar or tensor bounds."""
    return torch.minimum(torch.maximum(x, torch.as_tensor(
        lo, dtype=x.dtype, device=x.device)), torch.as_tensor(
        hi, dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Stokes wave targets
# ---------------------------------------------------------------------------

class StokesWave(NamedTuple):
    """One incident wave train (x-propagating); ``order=2`` adds the
    second-order Stokes corrections; dispersion from the finite-depth
    relation omega^2 = g k tanh(k depth)."""
    amplitude: float
    wavelength: float
    depth: float
    still_level: float
    gravity: float = 9.81
    order: int = 1
    phase: float = 0.0

    @property
    def k(self) -> float:
        return 2.0 * math.pi / self.wavelength

    @property
    def omega(self) -> float:
        return math.sqrt(self.gravity * self.k
                         * math.tanh(self.k * self.depth))

    def scaled(self, s) -> "StokesWave":
        """Amplitude-scaled copy (the soft-start hook)."""
        return self._replace(amplitude=self.amplitude * s)

    def elevation(self, x: torch.Tensor, t) -> torch.Tensor:
        """Free-surface elevation about ``still_level``."""
        k, om, a = self.k, self.omega, self.amplitude
        th = k * x - om * t + self.phase
        eta = a * torch.cos(th)
        if self.order >= 2:
            kd = k * self.depth
            coth = 1.0 / math.tanh(kd)
            eta = eta + (a * a * k * coth / 4.0
                         * (3.0 * coth * coth - 1.0)
                         * torch.cos(2.0 * th))
        return eta

    def velocity(self, x: torch.Tensor, z: torch.Tensor, t,
                 component: int) -> torch.Tensor:
        """Water-particle velocity (0: horizontal, 1: vertical) at height
        z, clipped to the water column."""
        k, om, a = self.k, self.omega, self.amplitude
        g0 = self.gravity
        th = k * x - om * t + self.phase
        zz = _clip(z - self.still_level, -self.depth, 2.0 * self.amplitude)
        kd = k * self.depth
        ch = torch.cosh(k * (zz + self.depth)) / math.cosh(kd)
        sh = torch.sinh(k * (zz + self.depth)) / math.cosh(kd)
        if component == 0:
            u = a * g0 * k / om * ch * torch.cos(th)
        else:
            u = a * g0 * k / om * sh * torch.sin(th)
        if self.order >= 2:
            c2 = 0.75 * a * a * om * k
            sh4 = math.sinh(kd) ** 4
            ch2 = torch.cosh(2.0 * k * (zz + self.depth)) / sh4
            sh2 = torch.sinh(2.0 * k * (zz + self.depth)) / sh4
            if component == 0:
                u = u + c2 * ch2 * torch.cos(2.0 * th)
            else:
                u = u + c2 * sh2 * torch.sin(2.0 * th)
        return u


class IrregularSea(NamedTuple):
    """Superposition of linear components: per-component amplitudes,
    wavelengths and phases over a shared depth and still level, summed
    over a leading component axis."""
    amplitudes: object
    wavelengths: object
    phases: object
    depth: float
    still_level: float
    gravity: float = 9.81

    def _arr(self, v, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v, dtype=np.float64)
                               if not isinstance(v, torch.Tensor) else v,
                               dtype=like.dtype, device=like.device)

    def _karr(self, ndim: int, like: torch.Tensor):
        shp = (-1,) + (1,) * ndim
        k = (2.0 * math.pi / self._arr(self.wavelengths, like)).reshape(shp)
        om = torch.sqrt(self.gravity * k * torch.tanh(k * self.depth))
        a = self._arr(self.amplitudes, like).reshape(shp)
        ph = self._arr(self.phases, like).reshape(shp)
        return k, om, a, ph

    @property
    def omega(self) -> float:
        """Smallest component frequency (longest period)."""
        k = 2.0 * math.pi / np.asarray(self.wavelengths, dtype=np.float64)
        return float(np.sqrt(self.gravity * k
                             * np.tanh(k * self.depth)).min())

    def scaled(self, s) -> "IrregularSea":
        amps = self.amplitudes
        if not isinstance(amps, torch.Tensor):
            amps = torch.as_tensor(np.asarray(amps, dtype=np.float64))
            if isinstance(s, torch.Tensor):
                amps = amps.to(dtype=s.dtype, device=s.device)
        return self._replace(amplitudes=amps * s)

    def elevation(self, x: torch.Tensor, t) -> torch.Tensor:
        k, om, a, ph = self._karr(x.ndim, x)
        th = k * x[None] - om * t + ph
        return torch.sum(a * torch.cos(th), dim=0)

    def velocity(self, x, z, t, component: int) -> torch.Tensor:
        k, om, a, ph = self._karr(max(x.ndim, z.ndim), x)
        th = k * x[None] - om * t + ph
        zz = _clip(z - self.still_level, -self.depth,
                   2.0 * torch.max(self._arr(self.amplitudes, x)))
        kd = k * self.depth
        ch = torch.cosh(k * (zz[None] + self.depth)) / torch.cosh(kd)
        sh = torch.sinh(k * (zz[None] + self.depth)) / torch.cosh(kd)
        comp = ch * torch.cos(th) if component == 0 else sh * torch.sin(th)
        return torch.sum(a * self.gravity * k / om * comp, dim=0)


# ---------------------------------------------------------------------------
# relaxation zones
# ---------------------------------------------------------------------------

def _ramp(sigma: torch.Tensor) -> torch.Tensor:
    """waves2Foam exponential relaxation weight: 1 at the outer end of the
    zone (sigma = 1), 0 at the working-region end (sigma = 0)."""
    s = torch.clamp(sigma, 0.0, 1.0)
    return (torch.exp(s ** 3.5) - 1.0) / (math.e - 1.0)


class RelaxationZone(NamedTuple):
    """Static relaxation weights on cells and faces; targets blend as
    q <- (1-w) q + w q_target with w = strength * ramp."""
    w_cc: torch.Tensor
    w_face: Vel
    kind: str                 # "generation" | "damping"


def make_zone(grid: StaggeredGrid, x_start: float, x_end: float,
              kind: str, outer: str, strength: float = 1.0,
              dtype=torch.float32, device="cuda") -> RelaxationZone:
    """A zone over [x_start, x_end] along axis 0; ``outer`` names the side
    that touches the domain boundary ("lo" for a left generation zone,
    "hi" for a right damping beach)."""
    assert kind in ("generation", "damping")
    assert outer in ("lo", "hi")
    device = resolve_device(device)
    width = float(x_end) - float(x_start)

    def weight_at(x):
        sigma = (x - x_start) / width
        if outer == "lo":
            sigma = 1.0 - sigma
        return strength * _ramp(sigma) * ((x >= x_start) & (x <= x_end))

    shape = (grid.n[0],) + (1,) * (grid.dim - 1)
    ones = torch.ones(grid.n, dtype=dtype, device=device)
    xc = grid.cell_coords_1d(0, dtype, device)
    w_cc = weight_at(xc).reshape(shape).to(dtype) * ones
    w_face = []
    for d in range(grid.dim):
        xf = (grid.face_coords_1d(0, dtype, device) if d == 0
              else grid.cell_coords_1d(0, dtype, device))
        w_face.append(weight_at(xf).reshape(shape).to(dtype) * ones)
    return RelaxationZone(w_cc=w_cc, w_face=tuple(w_face), kind=kind)


def cell_coords(grid: StaggeredGrid, dtype=torch.float32, device="cuda"):
    """Full-shape cell-center coordinates."""
    return tuple(torch.broadcast_to(c, grid.n)
                 for c in grid.cell_centers(dtype, resolve_device(device)))


def _face_coords(grid: StaggeredGrid, d: int, dtype=torch.float32,
                 device="cuda"):
    return tuple(torch.broadcast_to(c, grid.n)
                 for c in grid.face_centers(d, dtype, resolve_device(device)))


def wave_targets(grid: StaggeredGrid, wave, t, dtype=torch.float32,
                 device="cuda"):
    """(phi_target, u_target) of the incident wave at time t:
    phi = z - (still_level + elevation); velocities from wave theory
    tapered by the smooth water fraction (0 in the air)."""
    zax = grid.dim - 1
    device = resolve_device(device)
    cc = cell_coords(grid, dtype, device)
    eta = wave.elevation(cc[0], t)
    phi_t = cc[zax] - (wave.still_level + eta)
    eps = 1.5 * grid.dx[zax]
    u_t = []
    for d in range(grid.dim):
        fc = _face_coords(grid, d, dtype, device)
        if d == 0 or d == zax:
            comp = 0 if d == 0 else 1
            uf = wave.velocity(fc[0], fc[zax], t, comp)
            eta_f = wave.elevation(fc[0], t)
            phi_f = fc[zax] - (wave.still_level + eta_f)
            water = 1.0 - heaviside(phi_f, eps)
            u_t.append((uf * water).to(dtype))
        else:
            u_t.append(torch.zeros(grid.n, dtype=dtype, device=device))
    return phi_t.to(dtype), tuple(u_t)


def still_targets(grid: StaggeredGrid, still_level: float,
                  dtype=torch.float32, device="cuda"):
    """Still-water targets for a damping beach."""
    zax = grid.dim - 1
    device = resolve_device(device)
    cc = cell_coords(grid, dtype, device)
    phi_t = (cc[zax] - still_level).to(dtype)
    return phi_t, tuple(torch.zeros(grid.n, dtype=dtype, device=device)
                        for _ in range(grid.dim))


def apply_zone(phi: torch.Tensor, u: Vel, zone: RelaxationZone,
               phi_target: torch.Tensor, u_target: Vel):
    """One relaxation blend of (phi, u) toward the targets."""
    phi_new = phi + zone.w_cc * (phi_target - phi)
    u_new = tuple(ud + wf * (ut - ud)
                  for ud, wf, ut in zip(u, zone.w_face, u_target))
    return phi_new, u_new


class WaveTank:
    """A two-phase VC integrator with a generation zone at the left and a
    damping beach at the right. ``step`` = integrator step -> generation
    blend -> damping blend. ``floor`` / ``lid`` / ``end_wall`` add
    Brinkman-penalized solid slabs (clamped, then re-projected) that pin
    the periodic wraps the way a physical tank bottom, lid and end wall
    do; ``ramp_time`` soft-starts the incident amplitude (two periods by
    default)."""

    def __init__(self, integ, wave, gen_zone: RelaxationZone,
                 damp_zone: Optional[RelaxationZone] = None,
                 floor: float = 0.0, lid: float = 0.0,
                 end_wall: float = 0.0, eta_solid: float = 1e-3,
                 ramp_time: Optional[float] = None):
        self.integ = integ
        self.wave = wave
        self.gen = gen_zone
        self.damp = damp_zone
        if ramp_time is None:
            ramp_time = 2.0 * 2.0 * math.pi / wave.omega
        self.ramp_time = float(ramp_time)
        g = integ.grid
        dt_, dev = integ.dtype, integ.device
        zax = g.dim - 1
        self._solid = None
        if floor > 0.0 or lid > 0.0 or end_wall > 0.0:
            z_floor = g.x_lo[zax] + floor
            z_lid = g.x_up[zax] - lid
            x_wall = g.x_up[0] - end_wall
            chi = []
            for d in range(g.dim):
                fc = _face_coords(g, d, dt_, dev)
                zf = fc[zax]
                solid = torch.zeros(g.n, dtype=dt_, device=dev)
                if floor > 0.0:
                    solid = torch.maximum(solid, (zf < z_floor).to(dt_))
                if lid > 0.0:
                    solid = torch.maximum(solid, (zf > z_lid).to(dt_))
                if end_wall > 0.0:
                    solid = torch.maximum(solid, (fc[0] > x_wall).to(dt_))
                chi.append(solid)
            self._solid = tuple(chi)
        self.eta_solid = float(eta_solid)

    def step(self, state, dt: float):
        g = self.integ.grid
        dt_, dev = self.integ.dtype, self.integ.device
        st = self.integ.step(state, dt)
        t_new = st.t
        phi, u = st.phi, st.u
        if self.ramp_time > 0.0:
            r = torch.clamp(t_new / self.ramp_time, 0.0, 1.0)
            soft = 0.5 * (1.0 - torch.cos(math.pi * r))
            wv = self.wave.scaled(soft)
        else:
            wv = self.wave
        phi_t, u_t = wave_targets(g, wv, t_new, dtype=dt_, device=dev)
        if self._solid is not None:
            u_t = tuple(ut * (1.0 - chi)
                        for ut, chi in zip(u_t, self._solid))
        phi, u = apply_zone(phi, u, self.gen, phi_t, u_t)
        # the conservative integrator transports rho as its own state:
        # relax it toward the target interface's density too
        rho = getattr(st, "rho", None)
        if rho is not None:
            rho = rho + self.gen.w_cc * (self.integ.density(phi_t) - rho)
        if self.damp is not None:
            phi_s, u_s = still_targets(g, self.wave.still_level,
                                       dtype=dt_, device=dev)
            phi, u = apply_zone(phi, u, self.damp, phi_s, u_s)
            if rho is not None:
                rho = rho + self.damp.w_cc * (self.integ.density(phi_s)
                                              - rho)
        if self._solid is not None:
            u = tuple(ud / (1.0 + dt * chi / self.eta_solid)
                      for ud, chi in zip(u, self._solid))
            rho_cc = self.integ.density(phi) if rho is None else rho
            rule = "arithmetic" if rho is not None else "harmonic"
            u, _ = self.integ.project_vc(u, rho_cc, dt, face_rule=rule)
        wall_axes = getattr(self.integ, "wall_axes", None)
        if wall_axes is not None and any(wall_axes):
            u = tuple(self.integ._pin_normal(c, d) for d, c in enumerate(u))
        st = st._replace(phi=phi, u=u)
        if rho is not None:
            st = st._replace(rho=rho)
        return st

    def elevation_probe(self, state, x_index: int) -> torch.Tensor:
        """Free-surface height above still level at one x column, from
        the smoothed indicator of the level set."""
        g = self.integ.grid
        zax = g.dim - 1
        dz = g.dx[zax]
        col = state.phi[x_index] if g.dim == 2 else \
            state.phi[x_index, g.n[1] // 2]
        water = 1.0 - heaviside(col, 1.5 * dz)
        h = torch.sum(water) * dz
        return g.x_lo[zax] + h - self.wave.still_level
