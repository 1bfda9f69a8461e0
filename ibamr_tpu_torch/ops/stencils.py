"""Staggered-grid vector calculus (port of ``ibamr_tpu/ops/stencils.py``):
div, grad, Laplacian, curl, strain rate, cell/face interpolation and the
wall and MAC-layout helpers.

Periodic ``torch.roll`` forms on whole arrays (``divergence``,
``gradient`` and ``laplacian`` also take block-resident leaves,
``parallel.spmd.Blocks``, through the halo pass). Index conventions:
cell-centered ``p[i]``; face-centered ``u_d[i]`` on the lower face of
cell ``i``. ``divergence(gradient(p)) == laplacian(p)`` exactly, and
gradient is the negative adjoint of divergence.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from ibamr_tpu_torch.parallel.spmd import global_positions, halo_stencil

Vel = Tuple[torch.Tensor, ...]


def _dxm(f: torch.Tensor, axis: int, h: float) -> torch.Tensor:
    """Backward difference (f[i] - f[i-1]) / h: cell -> face derivative."""
    return (f - torch.roll(f, 1, axis)) / h


def _dxp(f: torch.Tensor, axis: int, h: float) -> torch.Tensor:
    """Forward difference (f[i+1] - f[i]) / h: face -> cell derivative."""
    return (torch.roll(f, -1, axis) - f) / h


@functools.partial(halo_stencil, width=1)
def divergence(u: Sequence[torch.Tensor], dx: Sequence[float]) -> torch.Tensor:
    """div u at cell centers from face-centered components."""
    out = _dxp(u[0], 0, dx[0])
    for d in range(1, len(u)):
        out = out + _dxp(u[d], d, dx[d])
    return out


@functools.partial(halo_stencil, width=1)
def gradient(p: torch.Tensor, dx: Sequence[float]) -> Vel:
    """grad p at faces from a cell-centered field."""
    return tuple(_dxm(p, d, dx[d]) for d in range(len(dx)))


@functools.partial(halo_stencil, width=1)
def laplacian(f: torch.Tensor, dx: Sequence[float]) -> torch.Tensor:
    """Standard 2d+1-point Laplacian on the field's own grid."""
    out = torch.zeros_like(f)
    for d in range(f.ndim):
        out = out + (torch.roll(f, -1, d) - 2.0 * f
                     + torch.roll(f, 1, d)) / (dx[d] ** 2)
    return out


def laplacian_vel(u: Sequence[torch.Tensor], dx: Sequence[float]) -> Vel:
    return tuple(laplacian(c, dx) for c in u)


# -- interpolations between centerings ------------------------------------------

def cc_to_fc(p: torch.Tensor) -> Vel:
    """Cell-centered scalar to each face centering (2-point average): the
    value at lower face i of axis d is (p[i-1] + p[i]) / 2."""
    return tuple(0.5 * (p + torch.roll(p, 1, d)) for d in range(p.ndim))


def fc_to_cc(u: Sequence[torch.Tensor]) -> Vel:
    """Each face-centered component to cell centers (2-point average)."""
    return tuple(0.5 * (c + torch.roll(c, -1, d)) for d, c in enumerate(u))


def fc_component_to_fc(u: Sequence[torch.Tensor], src: int,
                       dst: int) -> torch.Tensor:
    """Component ``src`` on the faces of component ``dst`` (4-point
    average in the src/dst plane; identity if src == dst)."""
    c = u[src]
    if src == dst:
        return c
    c = 0.5 * (c + torch.roll(c, -1, src))
    return 0.5 * (c + torch.roll(c, 1, dst))


# -- curl / vorticity -------------------------------------------------------------

def curl_2d_node(u: Sequence[torch.Tensor],
                 dx: Sequence[float]) -> torch.Tensor:
    """2D vorticity w = dv/dx - du/dy at the grid nodes."""
    return _dxm(u[1], 0, dx[0]) - _dxm(u[0], 1, dx[1])


def curl_2d_cc(u: Sequence[torch.Tensor],
               dx: Sequence[float]) -> torch.Tensor:
    """2D vorticity averaged to cell centers."""
    w = curl_2d_node(u, dx)
    w = 0.5 * (w + torch.roll(w, -1, 0))
    return 0.5 * (w + torch.roll(w, -1, 1))


def curl_3d_cc(u: Sequence[torch.Tensor], dx: Sequence[float]) -> Vel:
    """3D vorticity components averaged to cell centers."""
    ucc = fc_to_cc(u)

    def dcc(f, axis, h):
        return (torch.roll(f, -1, axis) - torch.roll(f, 1, axis)) / (2.0 * h)

    wx = dcc(ucc[2], 1, dx[1]) - dcc(ucc[1], 2, dx[2])
    wy = dcc(ucc[0], 2, dx[2]) - dcc(ucc[2], 0, dx[0])
    wz = dcc(ucc[1], 0, dx[0]) - dcc(ucc[0], 1, dx[1])
    return (wx, wy, wz)


def vorticity_magnitude_cc(u: Sequence[torch.Tensor],
                           dx: Sequence[float]) -> torch.Tensor:
    if len(u) == 2:
        return torch.abs(curl_2d_cc(u, dx))
    w = curl_3d_cc(u, dx)
    return torch.sqrt(w[0] ** 2 + w[1] ** 2 + w[2] ** 2)


# -- strain rate -------------------------------------------------------------------

def strain_rate_cc(u: Sequence[torch.Tensor], dx: Sequence[float],
                   wall_axes: Optional[Sequence[bool]] = None
                   ) -> Tuple[Tuple[torch.Tensor, ...], ...]:
    """Symmetric strain rate E_ij = (du_i/dx_j + du_j/dx_i)/2 at cell
    centers: the diagonal from the exact MAC face differences, the
    off-diagonals from :func:`central_grad` of the cell-averaged
    components (one-sided at the boundary layers of wall axes)."""
    dim = len(u)
    ucc = fc_to_cc(u)
    wall_axes = (tuple(bool(w) for w in wall_axes)
                 if wall_axes is not None else (False,) * dim)
    E = [[None] * dim for _ in range(dim)]
    for i in range(dim):
        E[i][i] = (torch.roll(u[i], -1, i) - u[i]) / dx[i]
        for j in range(i + 1, dim):
            Eij = 0.5 * (central_grad(ucc[i], j, dx[j], wall_axes[j])
                         + central_grad(ucc[j], i, dx[i], wall_axes[i]))
            E[i][j] = Eij
            E[j][i] = Eij
    return tuple(tuple(row) for row in E)


def strain_rate_magnitude_cc(u: Sequence[torch.Tensor], dx: Sequence[float],
                             wall_axes: Optional[Sequence[bool]] = None
                             ) -> torch.Tensor:
    """|E| = sqrt(2 E:E)."""
    acc = None
    for row in strain_rate_cc(u, dx, wall_axes):
        for e in row:
            t = e * e
            acc = t if acc is None else acc + t
    return torch.sqrt(2.0 * acc)


# -- wall helpers ------------------------------------------------------------------

def wall_boundary_masks(shape, axis: int, device=None):
    """(is_lo, is_hi) boolean masks of the first and last cell layer along
    ``axis``: of the grid, by global index (inside a halo body on a
    block, ``parallel.spmd.global_positions``: true on the edge shards
    only)."""
    bshape = [1] * len(shape)
    bshape[axis] = shape[axis]
    i, n = global_positions(shape[axis], axis, device)
    i = i.reshape(bshape).expand(tuple(shape))
    return i == 0, i == n - 1


def axis_slice(a: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """``a[..., lo:hi, ...]`` along ``axis``."""
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(lo, hi)
    return a[tuple(idx)]


def mac_complete_from_periodic(f):
    """Periodic lower-face MAC layout to face-complete (+1 on each
    component's own axis), duplicating the wrap face."""
    return tuple(torch.cat([c, axis_slice(c, d, 0, 1)], dim=d)
                 for d, c in enumerate(f))


def mac_periodic_from_complete(u, n):
    """Face-complete MAC layout to the periodic lower-face layout (drop
    each component's upper boundary face)."""
    return tuple(axis_slice(c, d, 0, n[d]) for d, c in enumerate(u))


def central_grad(phi: torch.Tensor, d: int, dx_d: float,
                 wall: bool = False) -> torch.Tensor:
    """Central difference along ``d``; with ``wall``, one-sided
    differences at the boundary cells instead of the periodic wrap."""
    g = (torch.roll(phi, -1, d) - torch.roll(phi, 1, d)) / (2.0 * dx_d)
    if wall:
        is_lo, is_hi = wall_boundary_masks(phi.shape, d, phi.device)
        one_lo = (torch.roll(phi, -1, d) - phi) / dx_d
        one_hi = (phi - torch.roll(phi, 1, d)) / dx_d
        g = torch.where(is_lo, one_lo, torch.where(is_hi, one_hi, g))
    return g
