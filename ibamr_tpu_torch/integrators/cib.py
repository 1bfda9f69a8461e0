"""CIB: constrained rigid-body immersed boundary in Stokes flow (port of
``ibamr_tpu/integrators/cib.py``).

Rigid bodies are marker blobs; the constraint formulation solves for
Lagrange-multiplier forces ``lambda`` on the markers such that the flow
they induce moves every marker rigidly:

    M lambda = K U        (markers move with the rigid motion U)
    K^T lambda = F_ext    (force/torque balance on free bodies)

``M = J L^{-1} S`` is the marker mobility (spread, steady Stokes solve,
interpolate), ``K`` maps body rigid motions (V, W) to marker velocities.
One application of ``M`` is a spread, the steady Stokes solve (two FFT
passes on the periodic box, or the walled saddle FGMRES of
``solvers/stokes.py``) and an interpolation; ``M^{-1}`` is the CG of
``solvers/krylov.py``. The body resistance ``R = K^T M^{-1} K`` is built
column by column, one CG per rigid mode in a Python loop (the reference
vmaps them; a converged column freezes under vmap, so the columns are
the same), and solved densely. Per-body sums are deterministic
scatters over the static ``body_id``; ``lax.scan`` becomes a loop.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops import interaction
from ibamr_tpu_torch.ops.interaction import scatter_add
from ibamr_tpu_torch.solvers import fft, krylov


class RigidBodies(NamedTuple):
    """Static marker->body structure."""
    body_id: torch.Tensor    # (N,) int64 body index per marker
    n_bodies: int


def n_rigid_modes(dim: int) -> int:
    """Rigid-motion DOFs per body: translations + rotations."""
    return dim + (1 if dim == 2 else 3)


def segment_sum(v: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment sums of the rows of ``v`` -> (n, ...), deterministic."""
    return scatter_add(v.new_zeros((n,) + tuple(v.shape[1:])), ids, v)


def body_centroids(X: torch.Tensor, bodies: RigidBodies) -> torch.Tensor:
    """(B, dim) mean marker position per body; a body with no markers
    gets a zero centroid rather than NaN."""
    nb, bid = bodies.n_bodies, bodies.body_id
    sums = segment_sum(X, bid, nb)
    cnt = segment_sum(X.new_ones((X.shape[0], 1)), bid, nb)
    return sums / torch.clamp_min(cnt, 1.0)


def rigid_velocity(X: torch.Tensor, bodies: RigidBodies,
                   U: torch.Tensor) -> torch.Tensor:
    """K U: marker velocities of rigid motions ``U`` (B, n_rigid_modes)
    = (V, W) per body, about each body's centroid."""
    dim = X.shape[1]
    bid = bodies.body_id
    r = X - body_centroids(X, bodies)[bid]
    V = U[:, :dim][bid]
    if dim == 2:
        w = U[:, 2][bid]
        rot = torch.stack([-w * r[:, 1], w * r[:, 0]], dim=-1)
    else:
        rot = torch.cross(U[:, 3:6][bid], r, dim=-1)
    return V + rot


def rigid_force_torque(X: torch.Tensor, bodies: RigidBodies,
                       lam: torch.Tensor) -> torch.Tensor:
    """K^T lambda: net force and torque (about the centroid) per body,
    (B, n_rigid_modes); the exact adjoint of ``rigid_velocity``."""
    dim = X.shape[1]
    nb, bid = bodies.n_bodies, bodies.body_id
    r = X - body_centroids(X, bodies)[bid]
    F = segment_sum(lam, bid, nb)
    if dim == 2:
        tau = segment_sum(r[:, 0] * lam[:, 1] - r[:, 1] * lam[:, 0], bid, nb)
        return torch.cat([F, tau[:, None]], dim=-1)
    tau = segment_sum(torch.cross(r, lam, dim=-1), bid, nb)
    return torch.cat([F, tau], dim=-1)


class MobilityInfo(NamedTuple):
    """Convergence of the inner CG mobility solves."""
    converged: torch.Tensor   # bool: all inner solves converged
    max_resnorm: torch.Tensor  # worst final residual norm
    max_iters: int            # most iterations taken by any solve


class CIBMethod:
    """Mobility solver for rigid bodies in Stokes flow.

    ``solve_mobility``: external (F, T) per body -> rigid motions
    ``U = R^{-1} (F, T)``. ``solve_constraint``: prescribed rigid motions
    -> constraint forces lambda and the net (F, T) they need.
    ``domain`` "periodic" solves the fluid by FFT; "walled" by the
    coupled saddle FGMRES at alpha = 0 with no-slip walls on every side
    (``dtype`` is that solver's precision; bodies keep delta-support
    clearance from the walls)."""

    def __init__(self, grid: StaggeredGrid, bodies: RigidBodies,
                 mu: float = 1.0, kernel="IB_4", cg_tol: float = 1e-9,
                 cg_maxiter: int = 500, domain: str = "periodic",
                 stokes_tol: float = 1e-10, dtype=torch.float64,
                 device="cuda"):
        if domain not in ("periodic", "walled"):
            raise ValueError(f"unknown CIB domain {domain!r}")
        self.grid = grid
        self.bodies = bodies
        self.mu = float(mu)
        self.kernel = kernel
        self.cg_tol = float(cg_tol)
        self.cg_maxiter = int(cg_maxiter)
        self.domain = domain
        self.device = resolve_device(device)
        self._stokes = None
        if domain == "walled":
            from ibamr_tpu_torch.solvers.stokes import (StaggeredStokesSolver,
                                                        cavity_bc)

            self._stokes = StaggeredStokesSolver(
                grid.n, grid.dx, cavity_bc(grid.dim), alpha=0.0, mu=self.mu,
                tol=float(stokes_tol), dtype=dtype, device=self.device)

    # -- the mobility operator ---------------------------------------------
    def mobility_apply(self, X: torch.Tensor,
                       lam: torch.Tensor) -> torch.Tensor:
        """M lambda = J L^{-1} S lambda: spread the marker forces, solve
        steady Stokes, interpolate back (SPD up to the regularization, so
        CG applies)."""
        f = interaction.spread_vel(lam, self.grid, X, kernel=self.kernel)
        if self.domain == "walled":
            from ibamr_tpu_torch.ops.stencils import (
                mac_complete_from_periodic, mac_periodic_from_complete)

            s = self._stokes
            f_fc = mac_complete_from_periodic(tuple(c.to(s.dtype)
                                                    for c in f))
            sol = s.solve(s.make_rhs(f_u=f_fc))
            u = mac_periodic_from_complete(
                tuple(c.to(lam.dtype) for c in sol.u), self.grid.n)
        else:
            u, _ = fft.solve_stokes_periodic(f, self.grid.dx, self.mu)
        return interaction.interpolate_vel(u, self.grid, X,
                                           kernel=self.kernel)

    def mobility_solve(self, X: torch.Tensor,
                       rhs: torch.Tensor) -> krylov.SolveResult:
        """CG solve M lambda = rhs (rhs: (N, dim) marker velocities)."""
        return krylov.cg(lambda v: self.mobility_apply(X, v), rhs,
                         tol=self.cg_tol, maxiter=self.cg_maxiter)

    # -- dense body-space solves -------------------------------------------
    def _rigid_basis(self, X: torch.Tensor) -> torch.Tensor:
        """(B*nm, N, dim): K applied to each unit rigid mode."""
        nb = self.bodies.n_bodies
        nm = n_rigid_modes(self.grid.dim)
        eye = torch.eye(nb * nm, dtype=X.dtype,
                        device=X.device).reshape(nb * nm, nb, nm)
        return torch.stack([rigid_velocity(X, self.bodies, e) for e in eye])

    def resistance_matrix(self, X: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     MobilityInfo]:
        """R = K^T M^{-1} K (symmetric positive definite), Lam = M^{-1} K
        (B*nm, N, dim) and the CG diagnostics; one CG per column."""
        KE = self._rigid_basis(X)
        res = [self.mobility_solve(X, b) for b in KE]
        Lam = torch.stack([r.x for r in res])
        info = MobilityInfo(
            converged=torch.stack([r.converged for r in res]).all(),
            max_resnorm=torch.stack([r.resnorm for r in res]).max(),
            max_iters=max(r.iters for r in res))
        R = torch.einsum("and,bnd->ab", KE, Lam)
        return 0.5 * (R + R.T), Lam, info

    def solve_mobility(self, X: torch.Tensor, FT: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, MobilityInfo]:
        """Free-body mobility problem: external force/torque FT (B, nm)
        -> rigid motions U (B, nm), marker forces lambda, diagnostics."""
        nb = self.bodies.n_bodies
        nm = n_rigid_modes(self.grid.dim)
        R, Lam, info = self.resistance_matrix(X)
        U = torch.linalg.solve(R, FT.reshape(-1)).reshape(nb, nm)
        lam = torch.einsum("a,and->nd", U.reshape(-1), Lam)
        return U, lam, info

    def solve_constraint(self, X: torch.Tensor, U: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    MobilityInfo]:
        """Prescribed-kinematics problem: rigid motions U (B, nm) ->
        constraint forces lambda (N, dim), the net (F, T), diagnostics."""
        res = self.mobility_solve(X, rigid_velocity(X, self.bodies, U))
        FT = rigid_force_torque(X, self.bodies, res.x)
        return res.x, FT, MobilityInfo(converged=res.converged,
                                       max_resnorm=res.resnorm,
                                       max_iters=res.iters)

    # -- quasi-static time stepping ----------------------------------------
    def step(self, X: torch.Tensor, FT: torch.Tensor, dt: float
             ) -> Tuple[torch.Tensor, torch.Tensor, MobilityInfo]:
        """One forward-Euler step of free bodies under external
        force/torque FT (creeping flow: velocities are instantaneous)."""
        U, _, info = self.solve_mobility(X, FT)
        return X + dt * rigid_velocity(X, self.bodies, U), U, info

    def free_body_solver(self, X: torch.Tensor, radius: float,
                         inner_tol: Optional[float] = None,
                         outer_tol: float = 1e-7):
        """A ``KrylovFreeBodyMobilitySolver`` over this method's exact
        mobility; ``radius`` is the markers' hydrodynamic radius for the
        dense approximate tensors (the marker spacing, ~dx)."""
        from ibamr_tpu_torch.solvers.mobility import \
            KrylovFreeBodyMobilitySolver
        return KrylovFreeBodyMobilitySolver(
            lambda lam: self.mobility_apply(X, lam), self.bodies, X,
            radius, self.mu,
            inner_tol=self.cg_tol if inner_tol is None else inner_tol,
            inner_maxiter=self.cg_maxiter, outer_tol=outer_tol)

    def step_krylov(self, X: torch.Tensor, FT: torch.Tensor, dt: float,
                    radius: float):
        """Forward-Euler free-body step through one outer body-mobility
        solve instead of one resistance column per rigid mode."""
        res = self.free_body_solver(X, radius).solve(FT)
        return X + dt * rigid_velocity(X, self.bodies, res.U), res.U, res


class FreeBodyTrajectory(NamedTuple):
    X: torch.Tensor           # final marker positions (N, d)
    centroids: torch.Tensor   # (num_steps, B, d) per-step body centroids
    U: torch.Tensor           # (num_steps, B, nm) per-step rigid motions


def advance_free_bodies(method: CIBMethod, X: torch.Tensor, FT_fn,
                        dt: float, num_steps: int,
                        radius: Optional[float] = None
                        ) -> FreeBodyTrajectory:
    """Time-dependent free-body dynamics under the mobility formulation:
    ``FT_fn(t, centroids) -> (B, nm)`` each step, one body-mobility solve
    (the Krylov route when ``radius`` is given, else the resistance
    columns), then a forward-Euler rigid update of every marker."""
    bodies = method.bodies
    t = torch.zeros((), dtype=X.dtype, device=X.device)
    cents, Us = [], []
    for _ in range(num_steps):
        FT = FT_fn(t, body_centroids(X, bodies))
        if radius is not None:
            X, U, _ = method.step_krylov(X, FT, dt, radius)
        else:
            X, U, _ = method.step(X, FT, dt)
        t = t + dt
        cents.append(body_centroids(X, bodies))
        Us.append(U)
    return FreeBodyTrajectory(X=X, centroids=torch.stack(cents),
                              U=torch.stack(Us))


def make_disc(center: Sequence[float], radius: float, n_markers: int,
              dtype=torch.float64, device="cuda") -> torch.Tensor:
    """Marker ring for a 2D rigid disc boundary (CIB/ex0-style body),
    computed in ``dtype``."""
    th = torch.arange(n_markers, dtype=dtype,
                      device=resolve_device(device)) * (2.0 * math.pi
                                                        / n_markers)
    return torch.stack([center[0] + radius * torch.cos(th),
                        center[1] + radius * torch.sin(th)], dim=-1)


def make_sphere(center: Sequence[float], radius: float, n_lat: int,
                n_lon: int, dtype=torch.float64,
                device="cuda") -> torch.Tensor:
    """Marker shell for a 3D rigid sphere (latitude-longitude rings)."""
    pts = []
    for i in range(n_lat):
        phi = np.pi * (i + 0.5) / n_lat
        for j in range(n_lon):
            th = 2.0 * np.pi * j / n_lon
            pts.append([center[0] + radius * np.sin(phi) * np.cos(th),
                        center[1] + radius * np.sin(phi) * np.sin(th),
                        center[2] + radius * np.cos(phi)])
    return torch.as_tensor(np.asarray(pts), dtype=dtype,
                           device=resolve_device(device))
