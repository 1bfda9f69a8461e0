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

The same operators take block-resident leaves (``parallel.spmd.Blocks``)
once :meth:`WallOps.on_mesh` has bound them to a mesh: the stencils run
through the halo pass (ring ghosts at interior seams and along a
component's own wall axis; at a wall the ghost fill the whole-grid
stencil applies there), so they are bitwise the whole-grid ones; the
masks zero the pinned slot on the shards that hold it; the solves go
through the pencil fast-diagonalization (``parallel/fftpar.py``).
"""

from __future__ import annotations

import copy
from typing import Sequence, Tuple

import torch

from ibamr_tpu_torch import bc as bc_mod
from ibamr_tpu_torch.bc import AxisBC, DomainBC, dirichlet_axis, neumann_axis
from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops import stencils
from ibamr_tpu_torch.parallel.spmd import (Blocks, halo_apply, smap,
                                           zero_first_slot)
from ibamr_tpu_torch.solvers.fastdiag import FastDiagSolver

Vel = Tuple[torch.Tensor, ...]


def pin_normal(c: torch.Tensor, d: int, wall_axes) -> torch.Tensor:
    """Zero the pinned wall-face slot of MAC component d (slot 0 along
    its own axis, when that axis has walls; on Blocks, in the blocks that
    hold it)."""
    if not wall_axes[d]:
        return c
    return zero_first_slot(c, d)


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

        # the block path's wall ghosts: the Dirichlet (lid) fills of the
        # tangential components, the pressure's Neumann fill
        self._vel_lap_walls = [
            {e: bc_mod.ghost_rule_cc(ax, grid.dx[e])
             for e, ax in enumerate(b.axes) if not ax.periodic}
            for b in self._vel_lap_bc]
        self._p_lap_walls = [{e: bc_mod.ghost_rule_cc(ax, grid.dx[e])
                              for e, ax in enumerate(p_axes)
                              if not ax.periodic}]
        self.mesh = None

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

    def on_mesh(self, mesh, dtype: torch.dtype) -> "WallOps":
        """A copy whose operators take Blocks on ``mesh``: the solves
        through the pencil fast-diagonalization (components that share a
        plan batched), the lift cut into blocks of ``dtype`` here, once.
        A grid the pencils cannot split raises."""
        from ibamr_tpu_torch.parallel.fftpar import PencilFastDiag
        from ibamr_tpu_torch.parallel.mesh import grid_pspec

        ops = copy.copy(self)
        ops.mesh = mesh
        spec = grid_pspec(mesh, self.grid.dim)
        plans = {}
        ops._vel_groups = {}
        for d, s in enumerate(self.vel_solvers):
            key = (s.bc, s.centerings)
            if key not in plans:
                plans[key] = PencilFastDiag(s, mesh)
            ops._vel_groups.setdefault(key, []).append(d)
        ops._vel_pencils = plans
        ops._p_pencil = PencilFastDiag(self.p_solver, mesh)
        ops._lift = [None if lift is None
                     else Blocks.cut(mesh, lift.to(dtype), spec)
                     for lift in self._lift]
        return ops

    def _pin_normal(self, c: torch.Tensor, d: int) -> torch.Tensor:
        return pin_normal(c, d, self.wall_axes)

    def laplacian_vel(self, u: Sequence[torch.Tensor],
                      dx: Sequence[float]) -> Vel:
        """Component Laplacians with no-slip ghosts (periodic wrap along a
        periodic axis and along a component's own wall axis, Dirichlet
        ghosts along the other wall axes)."""
        if isinstance(u[0], Blocks):
            lap = halo_apply(
                u[0].mesh, u,
                lambda *cs: tuple(bc_mod.laplacian_cc(c, self._vel_lap_bc[d],
                                                      dx)
                                  for d, c in enumerate(cs)),
                1, self._vel_lap_walls)
        else:
            lap = tuple(bc_mod.laplacian_cc(c, self._vel_lap_bc[d], dx)
                        for d, c in enumerate(u))
        return tuple(self._pin_normal(c, d) for d, c in enumerate(lap))

    def pressure_gradient(self, p: torch.Tensor, dx: Sequence[float]) -> Vel:
        """grad p at the faces, zero at the pinned wall faces."""
        g = stencils.gradient(p, dx)
        return tuple(self._pin_normal(c, d) for d, c in enumerate(g))

    def laplacian_cc(self, f: torch.Tensor,
                     dx: Sequence[float]) -> torch.Tensor:
        """Cell-centered Laplacian with homogeneous-Neumann wall ghosts."""
        if isinstance(f, Blocks):
            return halo_apply(
                f.mesh, f, lambda q: bc_mod.laplacian_cc(q, self._p_lap_bc,
                                                         dx),
                1, self._p_lap_walls)
        return bc_mod.laplacian_cc(f, self._p_lap_bc, dx)

    def helmholtz_vel(self, rhs: Vel, dx, alpha, beta) -> Vel:
        if isinstance(rhs[0], Blocks):
            return self._helmholtz_vel_blocks(rhs, alpha, beta)
        out = []
        for d, c in enumerate(rhs):
            if self._lift[d] is not None:
                c = c - beta * self._lift[d].to(c.dtype)
            out.append(self.vel_solvers[d].solve(c, alpha, beta))
        return tuple(out)

    def _helmholtz_vel_blocks(self, rhs: Vel, alpha, beta) -> Vel:
        """The per-component solves on Blocks: the lift subtracted cell by
        cell, then one pencil solve per plan, its components stacked."""
        self._need_mesh(rhs[0])
        rhs = [c if self._lift[d] is None else c - beta * self._lift[d]
               for d, c in enumerate(rhs)]
        out = [None] * len(rhs)
        for key, comps in self._vel_groups.items():
            pencil = self._vel_pencils[key]
            if len(comps) == 1:
                out[comps[0]] = pencil.solve(rhs[comps[0]], alpha, beta)
                continue
            ref = rhs[comps[0]]
            stacked = smap(lambda ctx, *c: torch.stack(c), self.mesh,
                           *[rhs[d].blocks for d in comps])
            res = pencil._solve_blocks(
                stacked, pencil.op(False), (alpha, beta), lead=1)
            for k, d in enumerate(comps):
                out[d] = ref.like([r[k] for r in res])
        return tuple(out)

    def _need_mesh(self, x) -> None:
        if self.mesh is None or x.mesh is not self.mesh:
            raise ValueError("these wall operators are not bound to the "
                             "leaves' mesh: build them with on_mesh(mesh)")

    def project(self, u: Vel, dx, q=None) -> Tuple[Vel, torch.Tensor]:
        """Leray projection with walls: the roll divergence, the Neumann
        Poisson solve (constant mode projected out) and the correction
        masked at the pinned faces. ``q`` is an optional cell-centered
        divergence source."""
        blocks = isinstance(u[0], Blocks)
        div = stencils.divergence(u, dx)
        if q is not None:
            div = div - q
        if blocks:
            self._need_mesh(div)
            phi = self._p_pencil.solve(div, 0.0, 1.0, zero_nullspace=True)
        else:
            phi = self.p_solver.solve(div, 0.0, 1.0, zero_nullspace=True)
        g = self.pressure_gradient(phi, dx)
        u_new = tuple(self._pin_normal(c - gc, d)
                      for d, (c, gc) in enumerate(zip(u, g)))
        return u_new, phi
