"""Physical boundary conditions on the uniform MAC grid (port of
``ibamr_tpu/bc.py``).

Each domain side prescribes ``a Q + b dQ/dn = g`` (the Robin form):
``periodic`` wraps both sides of an axis, ``dirichlet`` is ``Q = g``
(a=1, b=0), ``neumann`` is ``dQ/dn = g`` (a=0, b=1) and ``robin`` takes
explicit (a, b). The conditions are hashable static metadata; a ghost
fill is padding plus arithmetic on whole tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

PERIODIC = "periodic"
DIRICHLET = "dirichlet"
NEUMANN = "neumann"
ROBIN = "robin"
_KINDS = (PERIODIC, DIRICHLET, NEUMANN, ROBIN)


@dataclasses.dataclass(frozen=True)
class SideBC:
    """One side's condition ``a Q + b dQ/dn = g``. ``value`` is the
    constant datum g; a spatially varying g comes at fill time through
    ``bdry_data``."""
    kind: str = PERIODIC
    value: float = 0.0
    a: float = 1.0             # robin coefficient on Q
    b: float = 0.0             # robin coefficient on dQ/dn

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown BC kind {self.kind!r}")
        if self.kind == ROBIN and self.a == 0.0 and self.b == 0.0:
            raise ValueError("robin BC needs a != 0 or b != 0")

    def coeffs(self):
        """(a, b) of ``a Q + b dQ/dn = g`` for any non-periodic kind."""
        if self.kind == DIRICHLET:
            return 1.0, 0.0
        if self.kind == NEUMANN:
            return 0.0, 1.0
        if self.kind == ROBIN:
            return self.a, self.b
        raise ValueError("periodic side has no Robin coefficients")


def ghost_reflect_coeff(side: SideBC, h: float) -> float:
    """``ghost = c * interior`` under the homogeneous condition:
    ``c = -(a/2 - b/h) / (a/2 + b/h)``. Shared by the ghost fill, the
    fast-diagonalization matrices and the multigrid diagonals."""
    a, b = side.coeffs()
    denom = 0.5 * a + b / h
    if denom == 0.0:
        raise ValueError(f"ill-posed ghost fill: a/2 + b/h == 0 for {side}")
    return -(0.5 * a - b / h) / denom


@dataclasses.dataclass(frozen=True)
class AxisBC:
    lo: SideBC = SideBC()
    hi: SideBC = SideBC()

    def __post_init__(self):
        if (self.lo.kind == PERIODIC) != (self.hi.kind == PERIODIC):
            raise ValueError("periodic must be set on both sides of an axis")

    @property
    def periodic(self) -> bool:
        return self.lo.kind == PERIODIC


def periodic_axis() -> AxisBC:
    return AxisBC()


def dirichlet_axis(lo: float = 0.0, hi: float = 0.0) -> AxisBC:
    return AxisBC(SideBC(DIRICHLET, lo), SideBC(DIRICHLET, hi))


def neumann_axis(lo: float = 0.0, hi: float = 0.0) -> AxisBC:
    return AxisBC(SideBC(NEUMANN, lo), SideBC(NEUMANN, hi))


def robin_axis(a: float, b: float, lo: float = 0.0,
               hi: float = 0.0) -> AxisBC:
    """``a Q + b dQ/dn = g`` on both sides (g = lo/hi constants)."""
    return AxisBC(SideBC(ROBIN, lo, a=a, b=b), SideBC(ROBIN, hi, a=a, b=b))


@dataclasses.dataclass(frozen=True)
class DomainBC:
    """Per-axis BCs of one cell-centered field (or of one velocity
    component's wall behavior in the INS machinery)."""
    axes: Tuple[AxisBC, ...]

    @property
    def all_periodic(self) -> bool:
        return all(a.periodic for a in self.axes)

    @classmethod
    def periodic(cls, dim: int) -> "DomainBC":
        return cls(axes=(AxisBC(),) * dim)


def _slab(Q: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    idx = [slice(None)] * Q.ndim
    idx[axis] = slice(lo, hi)
    return Q[tuple(idx)]


def _ghost_layers_cc(Q: torch.Tensor, axis: int, side: SideBC, h: float,
                     lo_side: bool, width: int, g=None) -> torch.Tensor:
    """``width`` ghost layers beyond a wall from the Robin condition, each
    (ghost_k, interior_k) pair reflected about the boundary face:
    ``a (ghost + int)/2 + b (ghost - int)/((2k-1) h) = g``. Layers come in
    array order (outermost first on the lo side)."""
    a, b = side.coeffs()
    if g is None:
        g = side.value
    n = Q.shape[axis]
    layers = []
    for k in range(1, width + 1):
        interior = _slab(Q, axis, k - 1, k) if lo_side else \
            _slab(Q, axis, n - k, n - k + 1)
        heff = (2 * k - 1) * h
        denom = 0.5 * a + b / heff
        if denom == 0.0:
            raise ValueError(
                f"ill-posed ghost fill: a/2 + b/h == 0 for {side}")
        layers.append((g - interior * (0.5 * a - b / heff)) / denom)
    if lo_side:
        layers = layers[::-1]
    return torch.cat(layers, dim=axis) if width > 1 else layers[0]


def fill_ghosts_cc(Q: torch.Tensor, bc: DomainBC, dx: Sequence[float],
                   bdry_data: Optional[dict] = None,
                   width: int = 1) -> torch.Tensor:
    """Pad a cell-centered field with ``width`` ghost layers per side
    (periodic wrap or Robin wall extrapolation); the output has
    ``n + 2 width`` cells per axis. ``bdry_data`` is an optional
    ``{(axis, side): tensor}`` of spatially varying boundary data g,
    each broadcastable to that side's face slab."""
    if width < 1:
        raise ValueError(f"ghost width must be >= 1, got {width}")
    if any(width > s for s in Q.shape):
        raise ValueError(
            f"ghost width {width} exceeds field extent {tuple(Q.shape)}")
    out = Q
    for d, axbc in enumerate(bc.axes):
        n = out.shape[d]
        if axbc.periodic:
            lo_ghost = _slab(out, d, n - width, n)
            hi_ghost = _slab(out, d, 0, width)
        else:
            g_lo = g_hi = None
            if bdry_data is not None:
                g_lo = bdry_data.get((d, 0))
                g_hi = bdry_data.get((d, 1))
            lo_ghost = _ghost_layers_cc(
                out, d, axbc.lo, dx[d], True, width,
                g=pad_boundary_data(g_lo, out, d, width))
            hi_ghost = _ghost_layers_cc(
                out, d, axbc.hi, dx[d], False, width,
                g=pad_boundary_data(g_hi, out, d, width))
        out = torch.cat([lo_ghost, out, hi_ghost], dim=d)
    return out


def _edge_pad(g: torch.Tensor, pads) -> torch.Tensor:
    """``numpy.pad(g, pads, mode="edge")``."""
    for d, (lo, hi) in enumerate(pads):
        if lo or hi:
            n = g.shape[d]
            parts = [_slab(g, d, 0, 1)] * lo + [g] \
                + [_slab(g, d, n - 1, n)] * hi
            g = torch.cat(parts, dim=d)
    return g


def pad_boundary_data(g, out, d, width: int = 1):
    """Boundary data sized for the unpadded grid, made to broadcast
    against the partially padded ``out``: singleton axes are prepended
    up to full rank, extent-1 axes broadcast, and axes that earlier axes
    of the fill grew by ``2 width`` are edge-padded (any other mismatch
    raises)."""
    if g is None or not isinstance(g, torch.Tensor) or g.ndim == 0:
        return g
    if g.ndim > out.ndim:
        raise ValueError(
            f"boundary data has rank {g.ndim} > field rank {out.ndim}")
    g = g.reshape((1,) * (out.ndim - g.ndim) + tuple(g.shape))
    target = list(out.shape)
    target[d] = 1
    if list(g.shape) == target:
        return g
    pads = []
    for gs, ts in zip(g.shape, target):
        if gs == ts or gs == 1:
            pads.append((0, 0))
        elif gs == ts - 2 * width:
            pads.append((width, width))
        else:
            raise ValueError(
                f"boundary data shape {tuple(g.shape)} incompatible with "
                f"face slab {tuple(target)} (ghost width {width})")
    return _edge_pad(g, pads)


def laplacian_cc(Q: torch.Tensor, bc: DomainBC, dx: Sequence[float],
                 bdry_data: Optional[dict] = None) -> torch.Tensor:
    """BC-aware 2d+1-point Laplacian of a cell-centered field (ghost fill,
    then difference)."""
    G = fill_ghosts_cc(Q, bc, dx, bdry_data=bdry_data)
    dim = Q.ndim
    center = tuple(slice(1, -1) for _ in range(dim))
    out = torch.zeros_like(Q)
    for d in range(dim):
        lo = list(center)
        hi = list(center)
        lo[d] = slice(0, -2)
        hi[d] = slice(2, None)
        out = out + (G[tuple(lo)] - 2.0 * Q + G[tuple(hi)]) / dx[d] ** 2
    return out
