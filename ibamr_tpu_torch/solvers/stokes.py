"""Staggered-Stokes saddle-point solver: the coupled (u, p) Krylov solve
with inflow, no-slip and open (traction-free) boundaries (port of
``ibamr_tpu/solvers/stokes.py``).

Face-complete MAC layout: on a non-periodic axis, that axis's normal
component stores all faces (n+1 along its own axis), so boundary faces
are explicit unknowns: prescribed faces are identity rows, open faces
live unknowns with one-sided momentum rows. The operator is linear and
homogeneous; all boundary data enters the right-hand side
(:meth:`StaggeredStokesSolver.make_rhs`). FGMRES solves the coupled
system, preconditioned by the block lower-triangular projection
preconditioner: ``nu`` red-black sweeps for the velocity Helmholtz block,
then the Cahouet-Chabard Schur proxy ``alpha L_p^{-1} - mu I`` with the
pressure Poisson problem taken by one multigrid V-cycle. On an
all-periodic box the saddle operator is diagonal in k-space, and the
solve is one batched spectral pass (``SpectralPlan.solve_stokes_saddle``).

On the card, one preconditioner call is some 4,000 small kernels (most
of them the 40 red-black sweeps of the coarsest multigrid level), and
launching them one by one from Python takes ~40 ms at 32x16. So on a
CUDA device the flat operator and preconditioner are each captured once
per ``(alpha, nu_sweeps)`` as a CUDA graph (``utils/cuda_graph.py``) and
replayed: the same kernels on the same data, so the solve is bitwise the
one that :func:`fgmres_flat` gives on the eager ``flat_operators``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.bc import (AxisBC, DIRICHLET, DomainBC, NEUMANN,
                                SideBC, periodic_axis)
from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.ops.stencils import axis_slice
from ibamr_tpu_torch.solvers.escalation import (escalate_solve,
                                                record_solve_stats)
from ibamr_tpu_torch.solvers.krylov import (SolveResult, fgmres_flat,
                                            flat_operators)
from ibamr_tpu_torch.solvers.multigrid import (PoissonMultigrid,
                                               checkerboard_masks)
from ibamr_tpu_torch.utils.cuda_graph import Graphed
from ibamr_tpu_torch.utils.tree import ravel

Vel = Tuple[torch.Tensor, ...]

WALL = "wall"        # no-slip / prescribed velocity (value may be 0)
INFLOW = "inflow"    # a wall with nonzero normal data
OPEN = "open"        # traction-free outflow: p = 0, du/dn = 0


@dataclasses.dataclass(frozen=True)
class VelocitySide:
    """One domain side's velocity condition: wall/inflow (prescribed
    velocity, data supplied at solve time) or open."""
    kind: str = WALL

    def __post_init__(self):
        if self.kind not in (WALL, INFLOW, OPEN):
            raise ValueError(f"unknown velocity BC kind {self.kind!r}")

    @property
    def prescribed(self) -> bool:
        return self.kind in (WALL, INFLOW)


@dataclasses.dataclass(frozen=True)
class StokesBC:
    """Per-axis (lo, hi) velocity sides; ``None`` marks a periodic axis."""
    axes: Tuple[Optional[Tuple[VelocitySide, VelocitySide]], ...]

    @property
    def dim(self) -> int:
        return len(self.axes)

    def periodic(self, e: int) -> bool:
        return self.axes[e] is None

    def side(self, e: int, s: int) -> VelocitySide:
        ax = self.axes[e]
        assert ax is not None
        return ax[s]


def channel_bc(dim: int, flow_axis: int = 0) -> StokesBC:
    """Inflow at the flow axis's lo side, open outflow at its hi side,
    no-slip walls elsewhere."""
    return StokesBC(axes=tuple(
        (VelocitySide(INFLOW), VelocitySide(OPEN)) if e == flow_axis
        else (VelocitySide(WALL), VelocitySide(WALL)) for e in range(dim)))


def cavity_bc(dim: int) -> StokesBC:
    return StokesBC(axes=tuple(
        (VelocitySide(WALL), VelocitySide(WALL)) for _ in range(dim)))


class StokesSolveResult(NamedTuple):
    u: Vel
    p: torch.Tensor
    iters: int
    resnorm: torch.Tensor
    converged: torch.Tensor


def _side_idx(dim: int, e: int, s: int):
    idx = [slice(None)] * dim
    idx[e] = slice(0, 1) if s == 0 else slice(-1, None)
    return tuple(idx)


class StaggeredStokesSolver:
    """Coupled solve of

        alpha u - mu lap u + grad p = f_u   (interior and open faces)
        u = data                            (prescribed boundary faces)
        -div u = f_p                        (every cell)

    on the face-complete MAC layout. Boundary data ``bdry[(d, e, side)]``
    is component d's value on the (e, side) boundary: normal data when
    e == d, tangential when e != d."""

    def __init__(self, n: Sequence[int], dx: Sequence[float], bc: StokesBC,
                 alpha: float, mu: float, nu_sweeps: int = 4,
                 tol: float = 1e-8, m: int = 40, restarts: int = 12,
                 dtype=torch.float64, device="cuda"):
        self.n = tuple(int(v) for v in n)
        self.dx = tuple(float(v) for v in dx)
        self.bc = bc
        self.alpha = float(alpha)
        self.mu = float(mu)
        self.nu_sweeps = int(nu_sweeps)
        self.tol = float(tol)
        self.m = int(m)
        self.restarts = int(restarts)
        self.last_solve_stats: Optional[dict] = None
        self._graphs: dict = {}
        self.dtype = dtype
        self.device = resolve_device(device)
        dim = len(self.n)
        assert bc.dim == dim

        self.has_open = any(
            not bc.periodic(e) and not bc.side(e, s).prescribed
            for e in range(dim) for s in (0, 1))
        # the constant pressure mode is free unless an open side pins it
        self.p_nullspace = not self.has_open

        self.shapes = [tuple(
            self.n[e] + (1 if (e == d and not bc.periodic(e)) else 0)
            for e in range(dim)) for d in range(dim)]

        # prescribed-face masks and the alpha-free diagonals
        self._masks, self._diags = [], []
        for d in range(dim):
            mask = np.zeros(self.shapes[d], dtype=bool)
            if not bc.periodic(d):
                for s in (0, 1):
                    if bc.side(d, s).prescribed:
                        mask[_side_idx(dim, d, s)] = True
            self._masks.append(torch.as_tensor(mask, device=self.device))
            self._diags.append(self._assemble_diag(d))
        self._rb = [checkerboard_masks(self.shapes[d], self.device)
                    for d in range(dim)]

        # pressure Poisson preconditioner: Neumann at prescribed sides,
        # Dirichlet at open sides
        p_axes = []
        for e in range(dim):
            if bc.periodic(e):
                p_axes.append(periodic_axis())
            else:
                p_axes.append(AxisBC(*(
                    SideBC(NEUMANN if bc.side(e, s).prescribed
                           else DIRICHLET) for s in (0, 1))))
        self.p_bc = DomainBC(axes=tuple(p_axes))
        self.p_mg = PoissonMultigrid(self.n, self.p_bc, self.dx, dtype=dtype,
                                     device=self.device)

        # all-periodic collapse to one spectral pass (set to None to
        # force the Krylov path)
        self.spectral = None
        if all(bc.periodic(e) for e in range(dim)):
            from ibamr_tpu_torch.solvers import spectral_plan
            self.spectral = spectral_plan.get_plan(self.n, self.dx, dtype,
                                                   self.device)

    # -- the homogeneous operator ----------------------------------------------
    def _ghost_pad(self, c: torch.Tensor, d: int) -> torch.Tensor:
        """One homogeneous ghost layer per axis of component d: wrap on
        periodic axes, the face itself along its own axis (open ends see
        du/dn = 0), odd reflection along a tangential wall, even along a
        tangential open side."""
        out = c
        for e in range(c.ndim):
            n = out.shape[e]
            lo_g, hi_g = axis_slice(out, e, 0, 1), axis_slice(out, e, n - 1, n)
            if self.bc.periodic(e):
                lo_g, hi_g = hi_g, lo_g
            elif e != d:
                if self.bc.side(e, 0).prescribed:
                    lo_g = -lo_g
                if self.bc.side(e, 1).prescribed:
                    hi_g = -hi_g
            out = torch.cat([lo_g, out, hi_g], dim=e)
        return out

    def _lap(self, c: torch.Tensor, d: int) -> torch.Tensor:
        G = self._ghost_pad(c, d)
        center = tuple(slice(1, -1) for _ in range(c.ndim))
        acc = torch.zeros_like(c)
        for e in range(c.ndim):
            lo = list(center)
            hi = list(center)
            lo[e] = slice(0, -2)
            hi[e] = slice(2, None)
            acc = acc + (G[tuple(lo)] - 2.0 * c + G[tuple(hi)]) \
                / self.dx[e] ** 2
        return acc

    def _grad_p(self, p: torch.Tensor, d: int) -> torch.Tensor:
        """grad p on component d's faces; an open boundary face sees the
        homogeneous Dirichlet ghost (p = 0 at the face)."""
        h = self.dx[d]
        if self.bc.periodic(d):
            return (p - torch.roll(p, 1, d)) / h
        n = p.shape[d]
        lo, hi = axis_slice(p, d, 0, 1), axis_slice(p, d, n - 1, n)
        ghost_lo = lo if self.bc.side(d, 0).prescribed else -lo
        ghost_hi = hi if self.bc.side(d, 1).prescribed else -hi
        ext = torch.cat([ghost_lo, p, ghost_hi], dim=d)
        return (axis_slice(ext, d, 1, n + 2) - axis_slice(ext, d, 0, n + 1)) / h

    def divergence(self, u: Vel) -> torch.Tensor:
        acc = None
        for d, c in enumerate(u):
            h = self.dx[d]
            if self.bc.periodic(d):
                dd = (torch.roll(c, -1, d) - c) / h
            else:
                n = c.shape[d]
                dd = (axis_slice(c, d, 1, n) - axis_slice(c, d, 0, n - 1)) / h
            acc = dd if acc is None else acc + dd
        return acc

    def _momentum(self, u: Vel, p: torch.Tensor, alpha=None) -> Vel:
        alpha = self.alpha if alpha is None else alpha
        out = []
        for d, c in enumerate(u):
            r = alpha * c - self.mu * self._lap(c, d) + self._grad_p(p, d)
            out.append(torch.where(self._masks[d], c, r))  # identity rows
        return tuple(out)

    def operator(self, x, alpha=None):
        u, p = x
        r_p = -self.divergence(u)
        if self.p_nullspace:
            # a rank-one shift pins the constant pressure mode
            r_p = r_p + torch.mean(p)
        return (self._momentum(u, p, alpha=alpha), r_p)

    # -- the preconditioner ----------------------------------------------------
    def _assemble_diag(self, d: int) -> torch.Tensor:
        """The alpha-free part of the smoother diagonal of component d."""
        dim = len(self.n)
        base = 2.0 * self.mu * sum(1.0 / h ** 2 for h in self.dx)
        diag = np.full(self.shapes[d], base, dtype=np.float64)
        for e in range(dim):
            if self.bc.periodic(e):
                continue
            for s in (0, 1):
                if e == d:
                    # the edge-padded ghost of a boundary face is itself
                    diag[_side_idx(dim, e, s)] -= self.mu / self.dx[e] ** 2
                else:
                    sgn = -1.0 if self.bc.side(e, s).prescribed else 1.0
                    diag[_side_idx(dim, e, s)] -= \
                        sgn * self.mu / self.dx[e] ** 2
        return torch.as_tensor(diag, dtype=self.dtype, device=self.device)

    def _diag(self, d: int, alpha=None) -> torch.Tensor:
        alpha = self.alpha if alpha is None else alpha
        base = self._diags[d] + alpha
        return torch.where(self._masks[d], torch.ones_like(base), base)

    def _vel_smooth(self, r_u: Vel, alpha=None,
                    nu_sweeps: Optional[int] = None) -> Vel:
        """``nu`` red-black sweeps on ``alpha u - mu lap u = r_u`` from
        zero (the velocity sub-solve of the preconditioner)."""
        a = self.alpha if alpha is None else alpha
        nu = self.nu_sweeps if nu_sweeps is None else int(nu_sweeps)
        out = []
        for d, rhs in enumerate(r_u):
            red, black = self._rb[d]
            diag = self._diag(d, alpha)
            c = torch.zeros_like(rhs)
            for _ in range(nu):
                for mask in (red, black):
                    Ac = a * c - self.mu * self._lap(c, d)
                    Ac = torch.where(self._masks[d], c, Ac)
                    upd = (rhs - Ac) / diag
                    c = c + torch.where(mask, upd, torch.zeros_like(upd))
            out.append(c)
        return tuple(out)

    def _schur(self, s: torch.Tensor, alpha=None) -> torch.Tensor:
        """Cahouet-Chabard Schur proxy ``alpha L_p^{-1} s - mu s`` with
        L_p^{-1} one multigrid V-cycle (skipped for a steady solve,
        alpha == 0)."""
        a = self.alpha if alpha is None else alpha
        out = -self.mu * s
        if alpha is None and self.alpha == 0.0:
            return out
        q = s
        if self.p_nullspace:
            q = q - torch.mean(q)
        q = self.p_mg.vcycle(torch.zeros_like(q), q)
        if self.p_nullspace:
            q = q - torch.mean(q)
        return out + a * q

    def precondition(self, r, alpha=None, nu_sweeps=None):
        r_u, r_p = r
        u1 = self._vel_smooth(r_u, alpha=alpha, nu_sweeps=nu_sweeps)
        s = r_p + self.divergence(u1)
        return (u1, self._schur(s, alpha=alpha))

    # -- the right-hand side (all boundary data enters here) --------------------
    def make_rhs(self, f_u: Optional[Vel] = None,
                 f_p: Optional[torch.Tensor] = None,
                 bdry: Optional[Dict] = None):
        """The rhs pytree of :meth:`solve`. ``bdry[(d, e, side)]``: normal
        data when e == d (the identity rows), tangential data when e != d
        (the Dirichlet ghost lift ``2 mu V / h^2``)."""
        dim = len(self.n)
        bdry = bdry or {}
        kw = dict(dtype=self.dtype, device=self.device)
        ru = []
        for d in range(dim):
            r = torch.zeros(self.shapes[d], **kw) if f_u is None \
                else torch.as_tensor(f_u[d], **kw).clone()
            # tangential lifts first, so that identity rows set after
            # them keep their prescribed values at the corners
            for e in range(dim):
                if e == d or self.bc.periodic(e):
                    continue
                for s in (0, 1):
                    if not self.bc.side(e, s).prescribed:
                        continue
                    val = bdry.get((d, e, s), None)
                    if val is None:
                        continue
                    r[_side_idx(dim, e, s)] += (
                        2.0 * self.mu * torch.as_tensor(val, **kw)
                        / self.dx[e] ** 2)
            if not self.bc.periodic(d):
                for s in (0, 1):
                    if self.bc.side(d, s).prescribed:
                        r[_side_idx(dim, d, s)] = torch.as_tensor(
                            bdry.get((d, d, s), 0.0), **kw)
            ru.append(r)
        rp = torch.zeros(self.n, **kw) if f_p is None \
            else torch.as_tensor(f_p, **kw)
        if self.p_nullspace:
            rp = rp - torch.mean(rp)
        return (tuple(ru), rp)

    # -- the solves --------------------------------------------------------------
    def _flat_ops(self, template, alpha, nu_sweeps):
        """The flat operator and preconditioner of the FGMRES solve; on a
        CUDA device each is a CUDA graph, captured at its first use per
        ``(alpha, nu_sweeps)``."""
        ops = flat_operators(
            lambda x: self.operator(x, alpha=alpha), lambda r:
            self.precondition(r, alpha=alpha, nu_sweeps=nu_sweeps), template)
        if self.device.type != "cuda":
            return ops
        key = (alpha, nu_sweeps)
        if key not in self._graphs:
            example = ravel(template)[0]
            graphs = [Graphed(f, example) for f in ops]
            self._graphs[key] = tuple((lambda v, g=g: g(v).clone())
                                      for g in graphs)
        return self._graphs[key]

    def solve(self, rhs, x0=None, alpha=None, *, m=None, restarts=None,
              nu_sweeps=None) -> StokesSolveResult:
        """FGMRES with the projection preconditioner (or the spectral pass
        on an all-periodic box). ``alpha`` overrides rho/dt;
        ``m``/``restarts``/``nu_sweeps`` override the solve geometry.
        Every solve records ``self.last_solve_stats``."""
        if self.spectral is not None:
            return self._solve_spectral(rhs, alpha=alpha)
        if x0 is None:
            x0 = (tuple(torch.zeros(s, dtype=self.dtype, device=self.device)
                        for s in self.shapes),
                  torch.zeros(self.n, dtype=self.dtype, device=self.device))
        Aop, Mop = self._flat_ops(rhs, alpha, nu_sweeps)
        sol = fgmres_flat(Aop, Mop, rhs, x0=x0,
                          m=self.m if m is None else int(m), tol=self.tol,
                          restarts=(self.restarts if restarts is None
                                    else int(restarts)))
        record_solve_stats(self, sol, solver="fgmres")
        u, p = sol.x
        if self.p_nullspace:
            p = p - torch.mean(p)
        return StokesSolveResult(u=u, p=p, iters=sol.iters,
                                 resnorm=sol.resnorm,
                                 converged=sol.converged)

    def _solve_spectral(self, rhs, alpha=None) -> StokesSolveResult:
        """The exact all-periodic saddle solve, plus one operator apply
        for the residual record (``|r|_2 <= tol |b|_2``, as FGMRES)."""
        a = self.alpha if alpha is None else alpha
        ru, rp = rhs
        u, p = self.spectral.solve_stokes_saddle(ru, rp, a, self.mu)
        Au, Ap = self.operator((u, p), alpha=alpha)
        rn2 = sum(torch.sum((c - r) ** 2) for c, r in zip(Au, ru)) \
            + torch.sum((Ap - rp) ** 2)
        bn2 = sum(torch.sum(r ** 2) for r in ru) + torch.sum(rp ** 2)
        resnorm = torch.sqrt(rn2)
        converged = resnorm <= self.tol * torch.sqrt(bn2)
        sol = SolveResult(x=(u, p), iters=0, resnorm=resnorm,
                          converged=converged)
        record_solve_stats(self, sol, solver="spectral")
        return StokesSolveResult(u=u, p=p, iters=0, resnorm=resnorm,
                                 converged=converged)

    def solve_escalated(self, rhs, x0=None, alpha=None, *, chain=None,
                        on_incident=None, step=None,
                        context="StaggeredStokesSolver"
                        ) -> StokesSolveResult:
        """Walk the escalation chain (more restarts, a longer basis,
        deeper preconditioner sweeps) until a solve converges; level 0 is
        the plain :meth:`solve`. Raises ``SolverBreakdown`` when the chain
        is exhausted."""
        def attempt(level, _i):
            return self.solve(
                rhs, x0=x0, alpha=alpha, m=self.m * level.m_scale,
                restarts=self.restarts * level.restarts_scale,
                nu_sweeps=self.nu_sweeps * level.inner_scale)

        return escalate_solve(attempt, context=context, chain=chain,
                              on_incident=on_incident, step=step)
