"""CIB mobility-solver menu: the Direct, Krylov and KrylovFreeBody
solvers (port of ``ibamr_tpu/solvers/mobility.py``).

- The dense approximate mobility is one ``(N*d, N*d)`` pairwise tensor
  built by broadcasting and factorized by a dense Cholesky (a library
  call on a small matrix, as the reference's): the Rotne--Prager--
  Yamakawa tensor in 3D, the regularized-Stokeslet blob tensor in 2D.
- ``KrylovMobilitySolver`` runs the preconditioned CG of
  ``solvers/krylov.py`` on the exact grid mobility (spread, Stokes solve,
  interp) with the dense Cholesky solve as preconditioner.
- ``KrylovFreeBodyMobilitySolver`` runs FGMRES on the small body
  resistance system, each application one inner mobility solve,
  preconditioned by the dense approximate body mobility.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ibamr_tpu_torch.integrators.cib import (RigidBodies, n_rigid_modes,
                                             rigid_force_torque,
                                             rigid_velocity)
from ibamr_tpu_torch.solvers import krylov


def rpy_mobility_matrix(X: torch.Tensor, radius: float,
                        mu: float) -> torch.Tensor:
    """Dense 3D Rotne--Prager--Yamakawa mobility, ``(N*3, N*3)``: self
    term ``I/(6 pi mu a)``; far field (r > 2a) ``(1/(8 pi mu r)) [(1 +
    2a^2/(3r^2)) I + (1 - 2a^2/r^2) rhat rhat]``; overlapping (r <= 2a)
    ``(1/(6 pi mu a)) [(1 - 9r/(32a)) I + (3r/(32a)) rhat rhat]``, SPD
    for every configuration. Coincident distinct markers take the near
    branch (the guarded radius keeps the far branch finite)."""
    a = float(radius)
    N, d = X.shape
    if d != 3:
        raise ValueError("rpy_mobility_matrix is the 3D tensor; 2D uses "
                         "blob_mobility_matrix")
    dx = X[:, None, :] - X[None, :, :]               # (N, N, 3)
    r2 = torch.sum(dx * dx, dim=-1)
    r_true = torch.sqrt(r2)
    r2g = torch.where(r2 > 0, r2, torch.ones_like(r2))
    r = torch.sqrt(r2g)
    rhat = dx / r[..., None]
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    outer = rhat[..., :, None] * rhat[..., None, :]  # (N, N, 3, 3)
    far = (1.0 / (8.0 * math.pi * mu * r))[..., None, None] * (
        (1.0 + 2.0 * a * a / (3.0 * r2g))[..., None, None] * eye
        + (1.0 - 2.0 * a * a / r2g)[..., None, None] * outer)
    c0 = 1.0 / (6.0 * math.pi * mu * a)
    near = c0 * ((1.0 - 9.0 * r_true / (32.0 * a))[..., None, None] * eye
                 + (3.0 * r_true / (32.0 * a))[..., None, None] * outer)
    blocks = torch.where((r_true < 2.0 * a)[..., None, None], near, far)
    iN = torch.arange(N, device=X.device)
    blocks[iN, iN] = c0 * eye
    return blocks.permute(0, 2, 1, 3).reshape(N * d, N * d)


def blob_mobility_matrix(X: torch.Tensor, radius: float,
                         mu: float) -> torch.Tensor:
    """Dense 2D regularized-Stokeslet (blob) mobility, ``(N*2, N*2)``,
    blob width ``eps = radius``:

      G_ij = (1/(4 pi mu)) [ -delta_ij (ln(R + eps)
                                        - eps (R + 2 eps)/(R (R + eps)))
                             + x_i x_j (R + 2 eps)/(R (R + eps)^2) ],
      R = sqrt(r^2 + eps^2)."""
    eps = float(radius)
    N, d = X.shape
    if d != 2:
        raise ValueError("blob_mobility_matrix is the 2D tensor")
    dx = X[:, None, :] - X[None, :, :]
    R = torch.sqrt(torch.sum(dx * dx, dim=-1) + eps * eps)
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    diag_term = -(torch.log(R + eps)
                  - eps * (R + 2.0 * eps) / (R * (R + eps)))
    outer = dx[..., :, None] * dx[..., None, :]
    cross = (R + 2.0 * eps) / (R * (R + eps) ** 2)
    blocks = (1.0 / (4.0 * math.pi * mu)) * (
        diag_term[..., None, None] * eye + cross[..., None, None] * outer)
    return blocks.permute(0, 2, 1, 3).reshape(N * d, N * d)


def dense_mobility_matrix(X: torch.Tensor, radius: float,
                          mu: float) -> torch.Tensor:
    """Dimension dispatch: RPY in 3D, regularized blob in 2D."""
    return (rpy_mobility_matrix if X.shape[1] == 3
            else blob_mobility_matrix)(X, radius, mu)


class DirectMobilitySolver:
    """Dense approximate mobility: assemble, Cholesky-factorize (with a
    ``jitter`` diagonal shift relative to the mean diagonal), solve."""

    def __init__(self, X: torch.Tensor, radius: float, mu: float,
                 jitter: float = 1e-10):
        self.X = X
        self.radius = float(radius)
        self.mu = float(mu)
        self.dim = X.shape[1]
        M = dense_mobility_matrix(X, radius, mu)
        n = M.shape[0]
        scale = torch.mean(torch.diagonal(M))
        self._chol = torch.linalg.cholesky(
            M + (jitter * scale) * torch.eye(n, dtype=M.dtype,
                                             device=M.device))
        self._M = M

    def matrix(self) -> torch.Tensor:
        return self._M

    def apply(self, lam: torch.Tensor) -> torch.Tensor:
        """Mtilde lam, marker-shaped ``(N, d)`` in and out."""
        return (self._M @ lam.reshape(-1)).reshape(lam.shape)

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """Mtilde^{-1} rhs via the cached Cholesky factor."""
        L = self._chol
        y = torch.linalg.solve_triangular(L, rhs.reshape(-1, 1), upper=False)
        x = torch.linalg.solve_triangular(L.T, y, upper=True)
        return x.reshape(rhs.shape)

    def body_resistance(self, bodies: RigidBodies) -> torch.Tensor:
        """Dense approximate body resistance ``K^T Mtilde^{-1} K``
        (``(B*nm, B*nm)``, SPD)."""
        nb = bodies.n_bodies
        nm = n_rigid_modes(self.dim)
        eye = torch.eye(nb * nm, dtype=self.X.dtype,
                        device=self.X.device).reshape(nb * nm, nb, nm)
        KE = torch.stack([rigid_velocity(self.X, bodies, e) for e in eye])
        sols = torch.stack([self.solve(k) for k in KE])
        R = torch.einsum("and,bnd->ab", KE, sols)
        return 0.5 * (R + R.T)


class KrylovMobilitySolver:
    """Preconditioned CG on the exact grid mobility ``M = J L^{-1} S``
    (``mobility_apply``, e.g. ``CIBMethod.mobility_apply``), with the
    dense ``DirectMobilitySolver`` as preconditioner."""

    def __init__(self, mobility_apply: Callable[[torch.Tensor], torch.Tensor],
                 precond: Optional[DirectMobilitySolver] = None,
                 tol: float = 1e-9, maxiter: int = 500):
        self.mobility_apply = mobility_apply
        self.precond = precond
        self.tol = float(tol)
        self.maxiter = int(maxiter)

    def solve(self, rhs: torch.Tensor,
              x0: Optional[torch.Tensor] = None) -> krylov.SolveResult:
        M = self.precond.solve if self.precond is not None else None
        return krylov.cg(self.mobility_apply, rhs, x0=x0, M=M,
                         tol=self.tol, maxiter=self.maxiter)


class FreeBodyResult(NamedTuple):
    U: torch.Tensor           # (B, nm) rigid motions of the free bodies
    lam: torch.Tensor         # (N, d) constraint forces realizing them
    converged: torch.Tensor   # outer FGMRES convergence flag
    resnorm: torch.Tensor     # outer residual norm
    iters: int                # outer restarts


class KrylovFreeBodyMobilitySolver:
    """Matrix-free solve of the body mobility problem
    ``(K^T M^{-1} K) U = F_ext`` for force/torque-driven free bodies:
    FGMRES on the ``B * n_rigid_modes`` system, each application one
    inner preconditioned mobility solve, preconditioned by the inverse
    of the dense approximate body resistance. The tolerances have
    dtype-aware floors (50 and 200 machine epsilons)."""

    def __init__(self, mobility_apply: Callable[[torch.Tensor], torch.Tensor],
                 bodies: RigidBodies, X: torch.Tensor, radius: float,
                 mu: float, inner_tol: float = 1e-8,
                 inner_maxiter: int = 500, outer_tol: float = 1e-7,
                 outer_maxiter: int = 40):
        self.bodies = bodies
        self.X = X
        self.dim = X.shape[1]
        eps = float(torch.finfo(X.dtype).eps)
        inner_tol = max(float(inner_tol), 50.0 * eps)
        outer_tol = max(float(outer_tol), 200.0 * eps)
        self.direct = DirectMobilitySolver(X, radius, mu)
        self.inner = KrylovMobilitySolver(mobility_apply,
                                          precond=self.direct,
                                          tol=inner_tol,
                                          maxiter=inner_maxiter)
        self.outer_tol = float(outer_tol)
        self.outer_maxiter = int(outer_maxiter)
        self._N_approx = torch.linalg.inv(
            self.direct.body_resistance(bodies))

    def _resistance_apply(self, U: torch.Tensor) -> torch.Tensor:
        """(K^T M^{-1} K) U, flat (B*nm,) in and out."""
        nb = self.bodies.n_bodies
        nm = n_rigid_modes(self.dim)
        rhs = rigid_velocity(self.X, self.bodies, U.reshape(nb, nm))
        res = self.inner.solve(rhs)
        return rigid_force_torque(self.X, self.bodies, res.x).reshape(-1)

    def solve(self, FT: torch.Tensor) -> FreeBodyResult:
        """External force/torque ``FT`` (B, nm) -> free rigid motions."""
        nb = self.bodies.n_bodies
        nm = n_rigid_modes(self.dim)
        res = krylov.fgmres(self._resistance_apply, FT.reshape(-1),
                            M=lambda v: self._N_approx @ v,
                            m=min(self.outer_maxiter, nb * nm + 2),
                            tol=self.outer_tol, restarts=2)
        U = res.x.reshape(nb, nm)
        lam = self.inner.solve(rigid_velocity(self.X, self.bodies, U)).x
        return FreeBodyResult(U=U, lam=lam, converged=res.converged,
                              resnorm=res.resnorm, iters=res.iters)
