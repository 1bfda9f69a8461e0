"""Eulerian <-> Lagrangian spread and interpolate, the scatter/gather
oracle (port of ``ibamr_tpu/ops/interaction.py``):

  spread:      f(x_g) += sum_m F_m prod_d phi((x_g - X_m)/h) / h^dim
  interpolate: U_m     = sum_g u(x_g) prod_d phi((x_g - X_m)/h)

Markers are an ``(N, dim)`` tensor; the ``prod_d s_d`` stencil weights of
each marker are tensor products of per-axis weights (a composite B-spline
takes another support along the face-normal axis), and the grid exchange is
one flattened gather (interp) or one accumulating scatter (spread).
Spread and interp use the same weights, so they are exact adjoints.

This is the ``scatter`` engine and the overflow fallback of the packed
engine. PyTorch's accumulating ``index_put_`` adds duplicates in a
run-dependent order on the CPU (threads) and on CUDA (atomics), so the
spread runs it under PyTorch's deterministic algorithms and is bitwise
run-to-run reproducible on both, as the reference's spread is.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops.delta import get_kernel_axes

Vel = Tuple[torch.Tensor, ...]


def _centering_offsets(grid: StaggeredGrid, centering) -> Tuple[float, ...]:
    """Grid-unit coordinate of index j along axis d is j + offset_d.
    centering: "cell" | int component for face-centered | explicit tuple."""
    if centering == "cell":
        return (0.5,) * grid.dim
    if isinstance(centering, int):
        return tuple(0.0 if d == centering else 0.5 for d in range(grid.dim))
    return tuple(centering)


def _axis_weights_indices(xi: torch.Tensor, n: int, support: int, phi):
    """Per-axis stencil indices (wrapped periodically) and delta weights of
    markers at grid-unit coordinate ``xi`` (N,) -> ``j, w`` (N, support)."""
    j = (torch.floor(xi - 0.5 * support).to(torch.int64) + 1)[:, None] \
        + torch.arange(support, dtype=torch.int64, device=xi.device)[None, :]
    w = phi(xi[:, None] - j.to(xi.dtype))
    return torch.remainder(j, n), w


def _stencil(grid: StaggeredGrid, X: torch.Tensor, centering, kernel):
    """Flattened linear grid indices (N, prod(s_d)) int64 and tensor-product
    weights. Kernels may be anisotropic (composite B-splines pick another
    order along the face-normal axis, ``delta.get_kernel_axes``)."""
    specs = get_kernel_axes(kernel, centering, grid.dim)
    offsets = _centering_offsets(grid, centering)
    idxs, ws = [], []
    for d in range(grid.dim):
        support_d, phi_d = specs[d]
        xi = (X[:, d] - grid.x_lo[d]) / grid.dx[d] - offsets[d]
        idx, w = _axis_weights_indices(xi, grid.n[d], support_d, phi_d)
        idxs.append(idx)
        ws.append(w)
    N = X.shape[0]
    return (_combine_linear(idxs, specs, grid, N),
            _combine_tensor(ws, specs, N))


def _combine_linear(idxs, specs, grid: StaggeredGrid, N: int):
    """Tensor-product linear grid index per stencil point -> (N, S)."""
    lin = idxs[0]
    for d in range(1, len(idxs)):
        lin = lin[..., :, None] * grid.n[d] + idxs[d].reshape(
            (N,) + (1,) * (lin.dim() - 1) + (specs[d][0],))
    return lin.reshape(N, -1)


def _combine_tensor(factors, specs, N: int):
    """Tensor-product combine of per-axis (N, s_d) factors -> (N, S)."""
    t = factors[0]
    for d in range(1, len(factors)):
        t = t[..., :, None] * factors[d].reshape(
            (N,) + (1,) * (t.dim() - 1) + (specs[d][0],))
    return t.reshape(N, -1)


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms for the enclosed ops (serial on
    the CPU, sort-based on CUDA), restoring the global setting after."""
    if torch.are_deterministic_algorithms_enabled():
        yield
        return
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def scatter_add(flat: torch.Tensor, index: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """``flat`` plus ``vals`` accumulated at ``index`` (duplicates sum),
    out of place and run-to-run deterministic on every device."""
    with _deterministic():
        return flat.index_put((index,), vals, accumulate=True)


def interpolate(field: torch.Tensor, grid: StaggeredGrid, X: torch.Tensor,
                centering="cell", kernel="IB_4",
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """U_m = sum_g field(x_g) * delta_h(x_g - X_m) * h^dim  -> (N,)"""
    lin, wgt = _stencil(grid, X, centering, kernel)
    out = torch.sum(field.reshape(-1)[lin] * wgt, dim=-1)
    if weights is not None:
        out = out * weights
    return out


def spread(F: torch.Tensor, grid: StaggeredGrid, X: torch.Tensor,
           centering="cell", kernel="IB_4",
           weights: Optional[torch.Tensor] = None,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f(x_g) += sum_m F_m * delta_h(x_g - X_m); delta_h carries the
    1/h^dim factor. Accumulates into ``out`` (not modified) if given."""
    lin, wgt = _stencil(grid, X, centering, kernel)
    inv_vol = 1.0 / math.prod(grid.dx)
    vals = (F * inv_vol)[:, None] * wgt
    if weights is not None:
        vals = vals * weights[:, None]
    if out is None:
        out = torch.zeros(grid.n, dtype=vals.dtype, device=vals.device)
    flat = scatter_add(out.reshape(-1), lin.reshape(-1), vals.reshape(-1))
    return flat.reshape(grid.n)


def interpolate_vel(u: Sequence[torch.Tensor], grid: StaggeredGrid,
                    X: torch.Tensor, kernel="IB_4",
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Interpolate a MAC velocity to markers -> (N, dim); component d is
    sampled at its own face centering."""
    return torch.stack([interpolate(u[d], grid, X, centering=d,
                                    kernel=kernel, weights=weights)
                        for d in range(grid.dim)], dim=-1)


def spread_vel(F: torch.Tensor, grid: StaggeredGrid, X: torch.Tensor,
               kernel="IB_4", weights: Optional[torch.Tensor] = None) -> Vel:
    """Spread marker forces (N, dim) onto the MAC grid, one scatter per
    component at its own centering (includes the 1/h^dim factor)."""
    return tuple(spread(F[:, d], grid, X, centering=d, kernel=kernel,
                        weights=weights)
                 for d in range(grid.dim))
