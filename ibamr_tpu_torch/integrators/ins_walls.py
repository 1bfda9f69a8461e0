"""Wall-bounded (no-slip) operators for the staggered INS integrator (port
of ``ibamr_tpu/integrators/ins_walls.py``).

Storage convention on a wall axis: every MAC component keeps shape ``n``
per axis; for the wall-normal component, slot 0 along that axis is the
lo wall face, pinned to 0, and the hi wall face is the periodic image of
slot 0. So for homogeneous no-slip both wall faces carry 0 and the
periodic roll stencils for the divergence and the normal-axis Laplacian
stay exact; tangential components get odd-reflection ghosts, and the
pressure gradient is masked at the pinned faces. The solves go through
``solvers/fastdiag.py``: the velocity Helmholtz solve per component and
the pressure Poisson solve with homogeneous Neumann walls.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ibamr_tpu_torch import bc as bc_mod
from ibamr_tpu_torch.bc import AxisBC, DomainBC, dirichlet_axis, neumann_axis
from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops import stencils
from ibamr_tpu_torch.solvers.fastdiag import FastDiagSolver

Vel = Tuple[torch.Tensor, ...]


def pin_normal(c: torch.Tensor, d: int, wall_axes) -> torch.Tensor:
    """Zero the pinned wall-face slot of MAC component d (slot 0 along
    its own axis, when that axis has walls)."""
    if not wall_axes[d]:
        return c
    c = c.clone()
    idx = [slice(None)] * c.ndim
    idx[d] = slice(0, 1)
    c[tuple(idx)] = 0.0
    return c


class WallOps:
    """Per-grid wall-aware operators and solvers, built once per
    configuration. ``tangential[(d, e, side)]`` is component d's
    tangential velocity on the side (0 = lo, 1 = hi) wall of axis e != d
    (a moving lid): it enters the explicit Laplacian through the
    Dirichlet ghost fill and the implicit solve as a constant lift of
    the right-hand side."""

    def __init__(self, grid: StaggeredGrid, wall_axes: Sequence[bool],
                 tangential=None, device="cuda"):
        self.grid = grid
        self.wall_axes = tuple(bool(w) for w in wall_axes)
        self.tangential = dict(tangential or {})
        self.device = resolve_device(device)
        dim = grid.dim

        self.vel_solvers = []
        for d in range(dim):
            axes, cents = [], []
            for e in range(dim):
                if not self.wall_axes[e]:
                    axes.append(AxisBC())
                    cents.append("cc")
                else:
                    axes.append(dirichlet_axis())
                    cents.append("fc_pinned" if e == d else "cc")
            self.vel_solvers.append(FastDiagSolver(
                grid, DomainBC(axes=tuple(axes)), tuple(cents),
                device=self.device))

        p_axes = tuple(neumann_axis() if w else AxisBC()
                       for w in self.wall_axes)
        self.p_solver = FastDiagSolver(grid, DomainBC(axes=p_axes),
                                       ("cc",) * dim, device=self.device)

        # ghost-fill descriptors of the explicit stencils; component d
        # treats its own wall axis as periodic (pinned storage)
        self._p_lap_bc = DomainBC(axes=p_axes)
        self._vel_lap_bc = [
            DomainBC(axes=tuple(
                dirichlet_axis(self.tangential.get((d, e, 0), 0.0),
                               self.tangential.get((d, e, 1), 0.0))
                if (self.wall_axes[e] and e != d) else AxisBC()
                for e in range(dim)))
            for d in range(dim)]

        # RHS lift of the implicit solve: 2 V / dx_e^2 in the cell rows
        # next to a moving wall (f64, cast to the field's dtype at use)
        self._lift = []
        for d in range(dim):
            lift = None
            for e in range(dim):
                if not self.wall_axes[e] or e == d:
                    continue
                for side in (0, 1):
                    v = self.tangential.get((d, e, side), 0.0)
                    if v == 0.0:
                        continue
                    if lift is None:
                        lift = torch.zeros(grid.n, dtype=torch.float64,
                                           device=self.device)
                    idx = [slice(None)] * dim
                    idx[e] = slice(0, 1) if side == 0 else slice(-1, None)
                    lift[tuple(idx)] += 2.0 * v / grid.dx[e] ** 2
            self._lift.append(lift)

    def _pin_normal(self, c: torch.Tensor, d: int) -> torch.Tensor:
        return pin_normal(c, d, self.wall_axes)

    def laplacian_vel(self, u: Sequence[torch.Tensor],
                      dx: Sequence[float]) -> Vel:
        """Component Laplacians with no-slip ghosts (periodic wrap along a
        periodic axis and along a component's own wall axis, Dirichlet
        ghosts along the other wall axes)."""
        return tuple(
            self._pin_normal(bc_mod.laplacian_cc(c, self._vel_lap_bc[d], dx),
                             d)
            for d, c in enumerate(u))

    def pressure_gradient(self, p: torch.Tensor, dx: Sequence[float]) -> Vel:
        """grad p at the faces, zero at the pinned wall faces."""
        g = stencils.gradient(p, dx)
        return tuple(self._pin_normal(c, d) for d, c in enumerate(g))

    def laplacian_cc(self, f: torch.Tensor,
                     dx: Sequence[float]) -> torch.Tensor:
        """Cell-centered Laplacian with homogeneous-Neumann wall ghosts."""
        return bc_mod.laplacian_cc(f, self._p_lap_bc, dx)

    def helmholtz_vel(self, rhs: Vel, dx, alpha, beta) -> Vel:
        out = []
        for d, c in enumerate(rhs):
            if self._lift[d] is not None:
                c = c - beta * self._lift[d].to(c.dtype)
            out.append(self.vel_solvers[d].solve(c, alpha, beta))
        return tuple(out)

    def project(self, u: Vel, dx, q=None) -> Tuple[Vel, torch.Tensor]:
        """Leray projection with walls: the roll divergence, the Neumann
        Poisson solve (constant mode projected out) and the correction
        masked at the pinned faces. ``q`` is an optional cell-centered
        divergence source."""
        div = stencils.divergence(u, dx)
        if q is not None:
            div = div - q
        phi = self.p_solver.solve(div, 0.0, 1.0, zero_nullspace=True)
        g = self.pressure_gradient(phi, dx)
        u_new = tuple(self._pin_normal(c - gc, d)
                      for d, (c, gc) in enumerate(zip(u, g)))
        return u_new, phi
