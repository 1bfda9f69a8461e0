"""ConstraintIB: rigid and prescribed-kinematics bodies by momentum
projection (port of ``ibamr_tpu/integrators/constraint_ib.py``; Bhalla,
Bale, Griffith and Patankar, JCP 250 (2013) 446-476).

No constraint solve: after an unconstrained fluid step the velocity
inside each body is projected onto rigid modes (plus any prescribed
deformation) and imposed back on the grid, then made divergence-free.
One step:

  1. unconstrained INS step                         -> u*
  2. interpolate u* at the body markers             -> U_i
  3. least-squares rigid projection per body        -> (V_b, W_b)
     (free DOFs keep the projected momentum, prescribed DOFs take the
     kinematics; a density ratio adds the excess-inertia update)
  4. constrained marker velocity U_b = K(V, W) + U_def, the prescribed
     deformation velocity with its rigid part projected out
  5. u <- u* + S_norm (U_b - U_i): the spread correction normalized by
     the spread indicator, a velocity replacement
  6. re-project divergence-free; advance X with U_b.

Per-body sums are deterministic scatters over the static ``body_id``;
``advance_constraint_ib`` is a loop where the reference scans.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.integrators.cib import (RigidBodies, body_centroids,
                                             n_rigid_modes, rigid_velocity,
                                             segment_sum)
from ibamr_tpu_torch.integrators.ins import INSState, INSStaggeredIntegrator
from ibamr_tpu_torch.ops import interaction

Vel = Tuple[torch.Tensor, ...]


class ConstraintIBState(NamedTuple):
    ins: INSState
    X: torch.Tensor          # (N, dim) marker positions
    U_body: torch.Tensor     # (B, modes) last rigid motion (diagnostic)


def project_rigid(X: torch.Tensor, bodies: RigidBodies,
                  U: torch.Tensor) -> torch.Tensor:
    """Least-squares projection of marker velocities onto rigid modes per
    body -> (B, n_rigid_modes) = (V, W) about each centroid, with equal
    marker weights."""
    N, dim = X.shape
    nb, bid = bodies.n_bodies, bodies.body_id
    cnt = torch.clamp_min(segment_sum(X.new_ones((N, 1)), bid, nb), 1.0)
    V = segment_sum(U, bid, nb) / cnt
    r = X - body_centroids(X, bodies)[bid]
    u_rel = U - V[bid]
    if dim == 2:
        L = segment_sum(r[:, 0] * u_rel[:, 1] - r[:, 1] * u_rel[:, 0],
                        bid, nb)
        I = segment_sum(torch.sum(r * r, dim=1), bid, nb)
        return torch.cat([V, (L / torch.clamp_min(I, 1e-30))[:, None]],
                         dim=1)
    # 3D: I W = L with the batched inertia tensor
    L = segment_sum(torch.cross(r, u_rel, dim=-1), bid, nb)
    rr = segment_sum(r[:, :, None] * r[:, None, :], bid, nb)
    eye = torch.eye(dim, dtype=X.dtype, device=X.device)
    tr = torch.diagonal(rr, dim1=-2, dim2=-1).sum(-1)
    I = tr[:, None, None] * eye - rr + 1e-30 * eye
    W = torch.linalg.solve(I, L[..., None])[..., 0]
    return torch.cat([V, W], dim=1)


class ConstraintIBMethod:
    """Momentum-projection constraint IB coupling.

    ``free``: (B, n_rigid_modes) 0/1; 1 keeps the momentum-projected
    value, 0 takes ``prescribed_fn(t) -> (B, n_rigid_modes)``.
    ``deformation_fn(t, X) -> (N, dim)``: an optional prescribed
    deformation velocity (swimming gaits), its rigid part projected out.
    ``density_ratio`` (per body rho_b/rho_f) with optional ``gravity``
    adds the excess-inertia update ``V = V_f + a (V_prev + dt g - V_f)``,
    ``a = (s - 1)/(s + virtual_mass)``."""

    def __init__(self, ins: INSStaggeredIntegrator, bodies: RigidBodies,
                 free=None, prescribed_fn: Optional[Callable] = None,
                 deformation_fn: Optional[Callable] = None, kernel="IB_4",
                 indicator_floor: float = 1e-4, density_ratio=None,
                 gravity=None, virtual_mass: float = 1.0):
        self.ins = ins
        self.bodies = bodies
        dim = ins.grid.dim
        modes = n_rigid_modes(dim)
        kw = dict(dtype=ins.dtype, device=ins.device)
        if free is None:
            free = torch.ones((bodies.n_bodies, modes), **kw)
        self.free = torch.as_tensor(free, **kw)
        self.prescribed_fn = prescribed_fn
        self.deformation_fn = deformation_fn
        self.kernel = kernel
        # spread indicator below which a cell is outside every body
        self.indicator_floor = float(indicator_floor)
        self.density_ratio = None if density_ratio is None else \
            torch.as_tensor(np.asarray(density_ratio), **kw).reshape(-1, 1)
        self.virtual_mass = float(virtual_mass)
        if gravity is None:
            self._g_modes = None
        else:
            if self.density_ratio is None:
                raise ValueError(
                    "gravity without density_ratio has no effect: a "
                    "neutrally-buoyant body feels no net gravity; pass "
                    "density_ratio to enable the excess-mass dynamics")
            g = torch.as_tensor(np.asarray(gravity), **kw)
            self._g_modes = torch.cat(
                [g, torch.zeros(modes - dim, **kw)])[None, :]

    def _impose(self, u: Vel, X: torch.Tensor, dU: torch.Tensor) -> Vel:
        """u + S_norm(dU): the spread velocity correction normalized by the
        spread indicator (a partition of unity inside the body)."""
        grid = self.ins.grid
        ones = dU.new_ones(X.shape[0])
        floor = self.indicator_floor
        out = []
        for d in range(grid.dim):
            num = interaction.spread(dU[:, d], grid, X, centering=d,
                                     kernel=self.kernel)
            den = interaction.spread(ones, grid, X, centering=d,
                                     kernel=self.kernel)
            corr = torch.where(den > floor, num / torch.clamp_min(den, floor),
                               torch.zeros_like(num))
            out.append(u[d] + corr)
        return tuple(out)

    def step(self, state: ConstraintIBState,
             dt: float) -> ConstraintIBState:
        ins, grid, bodies = self.ins, self.ins.grid, self.bodies
        X = state.X
        ins_star = ins.step(state.ins, dt)                      # 1
        t_new = ins_star.t
        U_i = interaction.interpolate_vel(ins_star.u, grid, X,  # 2
                                          kernel=self.kernel)
        U_proj = project_rigid(X, bodies, U_i)                  # 3
        if self.density_ratio is not None:
            s = self.density_ratio
            U_prev = state.U_body
            if self._g_modes is not None:
                U_prev = U_prev + dt * self._g_modes
            U_proj = U_proj + (s - 1.0) / (s + self.virtual_mass) \
                * (U_prev - U_proj)
        if self.prescribed_fn is not None:
            U_pres = torch.as_tensor(self.prescribed_fn(t_new),
                                     dtype=U_proj.dtype,
                                     device=U_proj.device)
            U_body = self.free * U_proj + (1.0 - self.free) * U_pres
        else:
            U_body = U_proj
        U_b = rigid_velocity(X, bodies, U_body)                 # 4
        if self.deformation_fn is not None:
            U_def = self.deformation_fn(t_new, X)
            U_def = U_def - rigid_velocity(
                X, bodies, project_rigid(X, bodies, U_def))
            U_b = U_b + U_def
        u_corr = self._impose(ins_star.u, X, U_b - U_i)         # 5
        u_new, _ = ins.project(u_corr, grid.dx)                 # 6
        return ConstraintIBState(ins=ins_star._replace(u=u_new),
                                 X=X + dt * U_b, U_body=U_body)

    def initialize(self, X0, ins_state: Optional[INSState] = None
                   ) -> ConstraintIBState:
        kw = dict(dtype=self.ins.dtype, device=self.ins.device)
        X = torch.as_tensor(X0, **kw)
        if ins_state is None:
            ins_state = self.ins.initialize()
        modes = n_rigid_modes(self.ins.grid.dim)
        return ConstraintIBState(
            ins=ins_state, X=X,
            U_body=torch.zeros((self.bodies.n_bodies, modes), **kw))


def advance_constraint_ib(method: ConstraintIBMethod,
                          state: ConstraintIBState, dt: float,
                          num_steps: int) -> ConstraintIBState:
    """``num_steps`` steps of ``dt``."""
    for _ in range(num_steps):
        state = method.step(state, dt)
    return state


def fill_disc(center, radius: float, spacing: float, dtype=torch.float32,
              device="cuda") -> torch.Tensor:
    """Uniformly seeded solid disc of markers (the volumetric sampling
    ConstraintIB needs, against CIB's surface blobs)."""
    n = int(np.ceil(2 * radius / spacing)) + 1
    ax = np.linspace(-radius, radius, n)
    xx, yy = np.meshgrid(ax, ax, indexing="ij")
    keep = xx ** 2 + yy ** 2 <= radius ** 2
    pts = np.stack([xx[keep] + center[0], yy[keep] + center[1]], axis=1)
    return torch.as_tensor(pts, dtype=dtype, device=resolve_device(device))
