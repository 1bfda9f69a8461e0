"""Level-set machinery: signed-distance maintenance and interface
calculus (port of ``ibamr_tpu/physics/level_set.py``).

- :func:`reinitialize` relaxes |grad phi| -> 1 in pseudo-time
  (Sussman-Smereka-Osher) with Godunov upwinding and the Russo-Smereka
  subcell fix pinning the zero level; a fixed iteration count, a Python
  loop where the reference runs ``lax.fori_loop``.
- :func:`fast_sweeping_distance` keeps Gauss-Seidel causality along the
  swept axis (slice i reads slice i-1's updated values, so the slices
  run one after another: n small launches per directional pass) while
  each transverse slice updates as one tensor op.

Interface calculus: smoothed Heaviside/delta, phase volume, curvature,
the ingredients of the two-phase integrator (``integrators/ins_vc.py``).

On block-resident leaves (``parallel.spmd.Blocks``) the interface
functions act cell by cell, :func:`gradient_norm` and :func:`curvature`
run as halo stencils (radius 1 and 2), and :func:`reinitialize`
computes its frozen fields in one width-1 halo pass, then takes one
width-1 halo pass of the Godunov Hamiltonian per iteration, in the
whole-grid loop's order: the wall masks read global indices, so the
result is bitwise the whole grid's. :func:`fast_sweeping_distance`
sweeps slice by slice across every block and is not partitioned.
"""

from __future__ import annotations

import math
import warnings
from typing import Sequence

import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops.stencils import central_grad, wall_boundary_masks
from ibamr_tpu_torch.parallel.spmd import Blocks, halo_stencil


# -- smoothed interface functions -------------------------------------------

def heaviside(phi: torch.Tensor, eps: float) -> torch.Tensor:
    """Smoothed Heaviside H_eps(phi) over a band of half-width eps."""
    core = 0.5 * (1.0 + phi / eps
                  + torch.sin(math.pi * phi / eps) / math.pi)
    return torch.where(phi < -eps, 0.0, torch.where(phi > eps, 1.0, core))


def delta(phi: torch.Tensor, eps: float) -> torch.Tensor:
    """Smoothed interface delta (derivative of :func:`heaviside`)."""
    core = 0.5 / eps * (1.0 + torch.cos(math.pi * phi / eps))
    return torch.where(torch.abs(phi) > eps, 0.0, core)


def phase_volume(phi: torch.Tensor, grid: StaggeredGrid,
                 eps: float) -> torch.Tensor:
    """Volume of the phi < 0 phase (smoothed)."""
    return torch.sum(1.0 - heaviside(phi, eps)) * grid.cell_volume


def _walls(wall_axes, dim):
    return (False,) * dim if wall_axes is None else wall_axes


def gradient_norm(phi: torch.Tensor, dx: Sequence[float],
                  wall_axes=None) -> torch.Tensor:
    """|grad phi| with central differences; one-sided at walls when
    ``wall_axes`` marks an axis wall-bounded."""
    if isinstance(phi, Blocks):
        return halo_stencil(gradient_norm, 1)(phi, dx, wall_axes=wall_axes)
    wall_axes = _walls(wall_axes, phi.ndim)
    out = torch.zeros_like(phi)
    for d in range(phi.ndim):
        g = central_grad(phi, d, dx[d], wall_axes[d])
        out = out + g * g
    return torch.sqrt(out)


def curvature(phi: torch.Tensor, dx: Sequence[float],
              wall_axes=None) -> torch.Tensor:
    """Interface curvature kappa = div(grad phi / |grad phi|); one-sided
    wall differences when ``wall_axes`` is given."""
    if isinstance(phi, Blocks):
        return halo_stencil(curvature, 2)(phi, dx, wall_axes=wall_axes)
    dim = phi.ndim
    wall_axes = _walls(wall_axes, dim)
    grads = [central_grad(phi, d, dx[d], wall_axes[d]) for d in range(dim)]
    mag = torch.sqrt(sum(g * g for g in grads) + 1e-12)
    kap = torch.zeros_like(phi)
    for d in range(dim):
        kap = kap + central_grad(grads[d] / mag, d, dx[d], wall_axes[d])
    return kap


# -- Godunov Hamiltonian -----------------------------------------------------

def _godunov_grad_mag(phi: torch.Tensor, dx: Sequence[float],
                      sgn: torch.Tensor, wall_axes=None) -> torch.Tensor:
    """Godunov-upwinded |grad phi| for the reinitialization equation.
    ``wall_axes[d]`` zeroes the cross-wall (wrap) one-sided differences
    of axis d: the even-reflection ghost of a walled domain."""
    wall_axes = _walls(wall_axes, phi.ndim)
    acc = torch.zeros_like(phi)
    for d in range(phi.ndim):
        dm = (phi - torch.roll(phi, 1, d)) / dx[d]
        dp = (torch.roll(phi, -1, d) - phi) / dx[d]
        if wall_axes[d]:
            is_lo, is_hi = wall_boundary_masks(phi.shape, d, phi.device)
            dm = torch.where(is_lo, 0.0, dm)
            dp = torch.where(is_hi, 0.0, dp)
        a = torch.where(sgn >= 0,
                        torch.maximum(torch.clamp(dm, min=0.0) ** 2,
                                      torch.clamp(dp, max=0.0) ** 2),
                        torch.maximum(torch.clamp(dm, max=0.0) ** 2,
                                      torch.clamp(dp, min=0.0) ** 2))
        acc = acc + a
    return torch.sqrt(acc)


def _interface_cells(phi: torch.Tensor, wall_axes=None) -> torch.Tensor:
    """Mask of cells whose stencil straddles the zero level; on wall
    axes a cross-wall (wrap) sign change does not count."""
    wall_axes = _walls(wall_axes, phi.ndim)
    near = torch.zeros_like(phi, dtype=torch.bool)
    for d in range(phi.ndim):
        lo = phi * torch.roll(phi, 1, d) < 0.0
        hi = phi * torch.roll(phi, -1, d) < 0.0
        if wall_axes[d]:
            is_lo, is_hi = wall_boundary_masks(phi.shape, d, phi.device)
            lo = lo & ~is_lo
            hi = hi & ~is_hi
        near = near | lo | hi
    return near


def reinitialize(phi: torch.Tensor, dx: Sequence[float], iters: int = 40,
                 dtau: float = None, wall_axes=None) -> torch.Tensor:
    """Relaxation reinitialization toward a signed-distance function:
    d phi / d tau = S(phi_0) (1 - |grad phi|), Godunov upwinding, and in
    interface cells the Russo-Smereka fix relaxing phi toward the frozen
    subcell distance phi_0 / |grad phi_0| with the TRUE sign."""
    h = min(dx)
    if dtau is None:
        dtau = 0.5 * h
    phi0 = phi
    sgn = phi0 / torch.sqrt(phi0 * phi0 + h * h)
    sgn_hard = torch.where(phi0 >= 0.0, 1.0, -1.0).to(phi0.dtype)
    near, g0 = halo_stencil(
        lambda q: (_interface_cells(q, wall_axes=wall_axes),
                   gradient_norm(q, dx, wall_axes=wall_axes)), 1)(phi0)
    g0 = torch.clamp(g0, min=1e-8)
    D = phi0 / g0
    p = phi
    for _ in range(int(iters)):
        gm = halo_stencil(
            lambda qs: _godunov_grad_mag(qs[0], dx, qs[1],
                                         wall_axes=wall_axes), 1)((p, sgn))
        upd_far = p + dtau * sgn * (1.0 - gm)
        upd_near = p - dtau / h * (sgn_hard * torch.abs(p) - D)
        p = torch.where(near, upd_near, upd_far)
    return p


def _eikonal_solve(mins, h: float) -> torch.Tensor:
    """Upwind Eikonal solve sum_d ((u - a_d)/h)^2 = 1 from per-axis
    neighbor minima ``mins`` (near-isotropic spacing h)."""
    if len(mins) == 2:
        a = torch.minimum(mins[0], mins[1])
        b = torch.maximum(mins[0], mins[1])
        one_d = a + h
        disc = 2.0 * h * h - (b - a) ** 2
        two_d = 0.5 * (a + b + torch.sqrt(torch.clamp(disc, min=0.0)))
        return torch.where(one_d <= b, one_d, two_d)
    s = torch.sort(torch.stack(mins, dim=-1), dim=-1).values
    a, b, c = s[..., 0], s[..., 1], s[..., 2]
    u1 = a + h
    disc2 = 2.0 * h * h - (b - a) ** 2
    u2 = 0.5 * (a + b + torch.sqrt(torch.clamp(disc2, min=0.0)))
    sum3 = a + b + c
    disc3 = sum3 ** 2 - 3.0 * (a * a + b * b + c * c - h * h)
    u3 = (sum3 + torch.sqrt(torch.clamp(disc3, min=0.0))) / 3.0
    return torch.where(u1 <= b, u1, torch.where(u2 <= c, u2, u3))


def fast_sweeping_distance(phi: torch.Tensor, dx: Sequence[float],
                           iters: int = None, sweeps: int = 4,
                           wall_axes=None) -> torch.Tensor:
    """Signed distance by fast sweeping (Zhao 2004). The interface band
    keeps its subcell distances (phi / |grad phi|); outside it,
    ``sweeps`` rounds of the 2*dim directional passes propagate the
    upwind Eikonal update, each pass slice by slice along its axis with
    the transverse neighbours lagged. ``iters`` is accepted and ignored
    (with a ``DeprecationWarning``), as in the reference. ``wall_axes``:
    no distance information crosses a wall."""
    if iters is not None:
        warnings.warn(
            "fast_sweeping_distance(iters=...) is ignored: the "
            "directional-sweep solver's cost is set by `sweeps` "
            "(grid-size independent), not a Jacobi iteration count",
            DeprecationWarning, stacklevel=2)
    if isinstance(phi, Blocks):
        raise TypeError(
            "fast_sweeping_distance sweeps slice by slice along each axis "
            "across every block: it is not partitioned (assemble the "
            "level set first, or reinitialize it)")
    dim = phi.ndim
    wall_axes = tuple(bool(w) for w in _walls(wall_axes, dim))
    h = float(dx[0])
    near = _interface_cells(phi, wall_axes=wall_axes)
    g0 = torch.clamp(gradient_norm(phi, dx, wall_axes=wall_axes), min=1e-8)
    d_band = torch.abs(phi) / g0
    sgn = torch.where(phi >= 0, 1.0, -1.0).to(phi.dtype)
    big = float(sum(n * hh for n, hh in zip(phi.shape, dx)))
    u0 = torch.where(near, d_band, big)

    def sweep_axis(u, d, forward):
        um = torch.movedim(u, d, 0)
        nm = torch.movedim(near, d, 0)
        bm = torch.movedim(d_band, d, 0)
        if not forward:
            um, nm, bm = um.flip(0), nm.flip(0), bm.flip(0)
        down = torch.roll(um, -1, 0)
        if wall_axes[d]:
            down = down.clone()
            down[-1] = big
        tmins = []
        trans = [a for a in range(dim) if a != d]
        for k, a in enumerate(trans):
            ax = k + 1
            lo_n = torch.roll(um, 1, ax)
            hi_n = torch.roll(um, -1, ax)
            if wall_axes[a]:
                is_lo, is_hi = wall_boundary_masks(um.shape, ax, um.device)
                lo_n = torch.where(is_lo, big, lo_n)
                hi_n = torch.where(is_hi, big, hi_n)
            tmins.append(torch.minimum(lo_n, hi_n))
        carry = torch.full_like(um[-1], big) if wall_axes[d] else um[-1]
        out = []
        for i in range(um.shape[0]):
            a_d = torch.minimum(carry, down[i])
            cand = _eikonal_solve([a_d] + [t[i] for t in tmins], h)
            new = torch.where(nm[i], bm[i], torch.minimum(um[i], cand))
            out.append(new)
            carry = new
        um_new = torch.stack(out, 0)
        if not forward:
            um_new = um_new.flip(0)
        return torch.movedim(um_new, 0, d)

    u = u0
    for _ in range(int(sweeps)):
        for d in range(dim):
            u = sweep_axis(u, d, True)
            u = sweep_axis(u, d, False)
    return sgn * u
