"""Stochastic forcing for fluctuating hydrodynamics (port of
``ibamr_tpu/ops/stochastic.py``).

The Landau-Lifshitz fluctuating stress: the momentum equation gains
div W with a Gaussian random stress of covariance

    <W_ij W_kl> = 2 kT mu (delta_ik delta_jl + delta_il delta_jk)
                  / (dV dt),

diagonal components at cell centers and the symmetrized off-diagonal
ones at the edges (nodes in 2D), with the conservative staggered
divergence as the MAC force, so the total momentum injected is exactly
zero. The reference draws with ``jax.random``; the port draws with an
explicit ``torch.Generator``. The map from unit normals to the stress
and its divergence is :meth:`StochasticStressForcing.stress_from_normals`
and :meth:`StochasticStressForcing.force_from_normals`, so given the same
normals the port's force equals the reference's.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid

Vel = Tuple[torch.Tensor, ...]


class StochasticStressForcing:
    """Fluctuating-stress MAC force generator: scale
    sqrt(2 kT mu / (dV dt)); ``sample(gen, dt)`` returns the MAC body
    force div W for one step, drawn from the generator ``gen``."""

    def __init__(self, grid: StaggeredGrid, mu: float, kT: float,
                 dtype=torch.float32, device="cuda"):
        self.grid = grid
        self.mu = float(mu)
        self.kT = float(kT)
        self.dtype = dtype
        self.device = resolve_device(device)

    def _scale(self, dt: float) -> float:
        return math.sqrt(2.0 * self.kT * self.mu
                         / (self.grid.cell_volume * dt))

    @property
    def n_draws(self) -> int:
        """Unit-normal fields one sample draws: dim diagonal plus
        dim(dim-1)/2 off-diagonal."""
        dim = self.grid.dim
        return dim + dim * (dim - 1) // 2

    def normals(self, gen: torch.Generator) -> Sequence[torch.Tensor]:
        """``n_draws`` unit-normal fields of the grid's shape."""
        return [torch.randn(self.grid.n, generator=gen, dtype=self.dtype,
                            device=self.device)
                for _ in range(self.n_draws)]

    def stress_from_normals(self, Z: Sequence[torch.Tensor], dt: float
                            ) -> Tuple[Vel, Dict[Tuple[int, int],
                                                 torch.Tensor]]:
        """The stress fields from unit normals ``Z`` (the diagonal first,
        then the off-diagonal pairs (i, j), i < j, in order): diagonal
        variance 2 s^2, one shared draw of variance s^2 for W_ij = W_ji."""
        dim = self.grid.dim
        s = self._scale(dt)
        diag = tuple(s * math.sqrt(2.0) * Z[d] for d in range(dim))
        off = {}
        k = dim
        for i in range(dim):
            for j in range(i + 1, dim):
                off[(i, j)] = s * Z[k]
                k += 1
        return diag, off

    def sample_stress(self, gen: torch.Generator, dt: float):
        return self.stress_from_normals(self.normals(gen), dt)

    def force_from_normals(self, Z: Sequence[torch.Tensor],
                           dt: float) -> Vel:
        """MAC force (div W)_d = d_d W_dd + sum_{j != d} d_j W_dj: W_dd
        at cell centers by a backward difference to the d-face, W_dj at
        the d-j edges by a forward difference along j."""
        dx = self.grid.dx
        dim = self.grid.dim
        diag, off = self.stress_from_normals(Z, dt)
        out = []
        for d in range(dim):
            acc = (diag[d] - torch.roll(diag[d], 1, d)) / dx[d]
            for j in range(dim):
                if j == d:
                    continue
                W = off[(min(d, j), max(d, j))]
                acc = acc + (torch.roll(W, -1, j) - W) / dx[j]
            out.append(acc)
        return tuple(out)

    def sample(self, gen: torch.Generator, dt: float) -> Vel:
        return self.force_from_normals(self.normals(gen), dt)


class StochasticFluxForcing:
    """Scalar fluctuating flux for adv-diff:
    dQ/dt += div(sqrt(2 kappa Q_ref / (dV dt)) Z), Z iid normal on the
    faces; conservative by the same telescoping."""

    def __init__(self, grid: StaggeredGrid, kappa: float,
                 Q_ref: float = 1.0, dtype=torch.float32, device="cuda"):
        self.grid = grid
        self.kappa = float(kappa)
        self.Q_ref = float(Q_ref)
        self.dtype = dtype
        self.device = resolve_device(device)

    def normals(self, gen: torch.Generator) -> Sequence[torch.Tensor]:
        return [torch.randn(self.grid.n, generator=gen, dtype=self.dtype,
                            device=self.device)
                for _ in range(self.grid.dim)]

    def source_from_normals(self, Z: Sequence[torch.Tensor],
                            dt: float) -> torch.Tensor:
        g = self.grid
        s = math.sqrt(2.0 * self.kappa * self.Q_ref / (g.cell_volume * dt))
        out = torch.zeros(g.n, dtype=self.dtype, device=self.device)
        for d in range(g.dim):
            F = s * Z[d]
            out = out + (torch.roll(F, -1, d) - F) / g.dx[d]
        return out

    def sample(self, gen: torch.Generator, dt: float) -> torch.Tensor:
        return self.source_from_normals(self.normals(gen), dt)
