"""Eulerian <-> Lagrangian spread and interpolate, the scatter/gather
oracle (port of ``ibamr_tpu/ops/interaction.py``):

  spread:      f(x_g) += sum_m F_m prod_d phi((x_g - X_m)/h) / h^dim
  interpolate: U_m     = sum_g u(x_g) prod_d phi((x_g - X_m)/h)

Markers are an ``(N, dim)`` tensor; the ``prod_d s_d`` stencil weights of
each marker are tensor products of per-axis weights (a composite B-spline
takes another support along the face-normal axis), and the grid exchange is
one flattened gather (interp) or one accumulating scatter (spread).
Spread and interp use the same weights, so they are exact adjoints. The
kernel-gradient transfers at the end (the IMP material points) take the
derivative of each axis's ``phi`` by forward mode, which at the kernels'
knots is the reference's ``jax.grad`` (``ops/delta.py``).

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
from ibamr_tpu_torch.ops.delta import get_kernel_axes, validate_gradient_kernel

Vel = Tuple[torch.Tensor, ...]


def _centering_offsets(grid: StaggeredGrid, centering) -> Tuple[float, ...]:
    """Grid-unit coordinate of index j along axis d is j + offset_d.
    centering: "cell" | int component for face-centered | explicit tuple."""
    if centering == "cell":
        return (0.5,) * grid.dim
    if isinstance(centering, int):
        return tuple(0.0 if d == centering else 0.5 for d in range(grid.dim))
    return tuple(centering)


def _axis_weights_indices(xi: torch.Tensor, n: Optional[int], support: int,
                          phi):
    """Per-axis stencil indices (wrapped periodically) and delta weights of
    markers at grid-unit coordinate ``xi`` (N,) -> ``j, w`` (N, support);
    ``xi`` may carry more axes, (N, dim) -> (N, dim, support). ``n=None``
    leaves the indices unwrapped."""
    j = (torch.floor(xi - 0.5 * support).to(torch.int64) + 1)[..., None] \
        + torch.arange(support, dtype=torch.int64, device=xi.device)
    w = phi(xi[..., None] - j.to(xi.dtype))
    return (j if n is None else torch.remainder(j, n)), w


def _stencil(grid: StaggeredGrid, X: torch.Tensor, centering, kernel):
    """Flattened linear grid indices (N, prod(s_d)) int64 and tensor-product
    weights. Kernels may be anisotropic (composite B-splines pick another
    order along the face-normal axis, ``delta.get_kernel_axes``)."""
    specs = get_kernel_axes(kernel, centering, grid.dim)
    offsets = _centering_offsets(grid, centering)
    xis = [(X[:, d] - grid.x_lo[d]) / grid.dx[d] - offsets[d]
           for d in range(grid.dim)]
    if all(sp == specs[0] for sp in specs[1:]):
        # an isotropic kernel: every axis's weights in one pass (the
        # same elementwise arithmetic, a third of the launches)
        support, phi = specs[0]
        j, w = _axis_weights_indices(torch.stack(xis, dim=1), None,
                                     support, phi)
        idxs = [torch.remainder(j[:, d], grid.n[d])
                for d in range(grid.dim)]
        ws = [w[:, d] for d in range(grid.dim)]
    else:
        idxs, ws = [], []
        for d in range(grid.dim):
            support_d, phi_d = specs[d]
            idx, w = _axis_weights_indices(xis[d], grid.n[d], support_d,
                                           phi_d)
            idxs.append(idx)
            ws.append(w)
    N = X.shape[0]
    return (_combine_linear(idxs, specs, grid, N),
            _combine_tensor(ws, specs, N))


class Stencils:
    """The stencils of one marker position ``X``, each built once on
    first use and shared by every spread and interp at ``X`` (a midpoint
    step spreads and interpolates at the same half-step position): the
    same values as :func:`_stencil`, without building them again."""

    def __init__(self, X: torch.Tensor):
        self.X = X
        self._memo = {}

    def get(self, grid: StaggeredGrid, X: torch.Tensor, centering, kernel):
        if X is not self.X:
            return _stencil(grid, X, centering, kernel)
        key = (grid, centering, kernel)
        try:
            st = self._memo.get(key)
        except TypeError:              # an unhashable user-defined kernel
            return _stencil(grid, X, centering, kernel)
        if st is None:
            st = self._memo[key] = _stencil(grid, X, centering, kernel)
        return st


def _stencil_of(grid, X, centering, kernel, stencils):
    if stencils is None:
        return _stencil(grid, X, centering, kernel)
    return stencils.get(grid, X, centering, kernel)


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
                weights: Optional[torch.Tensor] = None,
                stencils: Optional[Stencils] = None) -> torch.Tensor:
    """U_m = sum_g field(x_g) * delta_h(x_g - X_m) * h^dim  -> (N,)"""
    lin, wgt = _stencil_of(grid, X, centering, kernel, stencils)
    out = torch.sum(field.reshape(-1)[lin] * wgt, dim=-1)
    if weights is not None:
        out = out * weights
    return out


def spread(F: torch.Tensor, grid: StaggeredGrid, X: torch.Tensor,
           centering="cell", kernel="IB_4",
           weights: Optional[torch.Tensor] = None,
           out: Optional[torch.Tensor] = None,
           stencils: Optional[Stencils] = None) -> torch.Tensor:
    """f(x_g) += sum_m F_m * delta_h(x_g - X_m); delta_h carries the
    1/h^dim factor. Accumulates into ``out`` (not modified) if given."""
    lin, wgt = _stencil_of(grid, X, centering, kernel, stencils)
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
                    weights: Optional[torch.Tensor] = None,
                    stencils: Optional[Stencils] = None) -> torch.Tensor:
    """Interpolate a MAC velocity to markers -> (N, dim); component d is
    sampled at its own face centering."""
    return torch.stack([interpolate(u[d], grid, X, centering=d,
                                    kernel=kernel, weights=weights,
                                    stencils=stencils)
                        for d in range(grid.dim)], dim=-1)


def spread_vel(F: torch.Tensor, grid: StaggeredGrid, X: torch.Tensor,
               kernel="IB_4", weights: Optional[torch.Tensor] = None,
               stencils: Optional[Stencils] = None) -> Vel:
    """Spread marker forces (N, dim) onto the MAC grid, one scatter per
    component at its own centering (includes the 1/h^dim factor)."""
    return tuple(spread(F[:, d], grid, X, centering=d, kernel=kernel,
                        weights=weights, stencils=stencils)
                 for d in range(grid.dim))


# -- kernel-gradient transfers (IMP material points: the velocity gradient
# at the points, dF/dt = (grad u) F, and the divergence-form stress spread
# f = -sum_p V_p P F^T grad(delta)) -------------------------------------------

def _dphi(phi, r: torch.Tensor) -> torch.Tensor:
    """phi'(r) elementwise (``phi`` acts elementwise, so the forward-mode
    derivative along ones is its derivative)."""
    return torch.func.jvp(phi, (r,), (torch.ones_like(r),))[1]


def _stencil_with_grad(grid: StaggeredGrid, X: torch.Tensor, centering,
                       kernel):
    """:func:`_stencil` plus the gradient of each tensor-product weight
    with respect to the marker position: lin (N, S), W (N, S), dW (N, S,
    dim) with dW[..., j] = (phi_j'(r)/h_j) prod_{d != j} phi_d(r_d). Only
    C^1 kernels (``delta.validate_gradient_kernel``)."""
    validate_gradient_kernel(kernel)
    specs = get_kernel_axes(kernel, centering, grid.dim)
    offsets = _centering_offsets(grid, centering)
    dim = grid.dim
    idxs, ws, dws = [], [], []
    for d in range(dim):
        support_d, phi_d = specs[d]
        xi = (X[:, d] - grid.x_lo[d]) / grid.dx[d] - offsets[d]
        j = (torch.floor(xi - 0.5 * support_d).to(torch.int64) + 1)[:, None] \
            + torch.arange(support_d, dtype=torch.int64,
                           device=xi.device)[None, :]
        r = xi[:, None] - j.to(xi.dtype)
        idxs.append(torch.remainder(j, grid.n[d]))
        ws.append(phi_d(r))
        dws.append(_dphi(phi_d, r) / grid.dx[d])
    N = X.shape[0]
    lin = _combine_linear(idxs, specs, grid, N)
    W = _combine_tensor(ws, specs, N)
    dW = torch.stack([_combine_tensor([dws[d] if d == j else ws[d]
                                       for d in range(dim)], specs, N)
                      for j in range(dim)], dim=-1)
    return lin, W, dW


def interpolate_vel_and_gradient(u: Sequence[torch.Tensor],
                                 grid: StaggeredGrid, X: torch.Tensor,
                                 kernel="BSPLINE_3",
                                 weights: Optional[torch.Tensor] = None):
    """(U, grad u) at the markers from one stencil and one gather per
    component: U (N, dim) and G (N, dim, dim) with G[:, i, j] =
    du_i/dx_j."""
    vals_rows, grad_rows = [], []
    for i in range(grid.dim):
        lin, W, dW = _stencil_with_grad(grid, X, i, kernel)
        vals = u[i].reshape(-1)[lin]
        vals_rows.append(torch.sum(vals * W, dim=-1))
        grad_rows.append(torch.sum(vals[..., None] * dW, dim=1))
    U = torch.stack(vals_rows, dim=-1)
    G = torch.stack(grad_rows, dim=1)
    if weights is not None:
        U = U * weights[:, None]
        G = G * weights[:, None, None]
    return U, G


def interpolate_gradient_vel(u: Sequence[torch.Tensor], grid: StaggeredGrid,
                             X: torch.Tensor, kernel="BSPLINE_3",
                             weights: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The velocity gradient at the markers, G[:, i, j] = du_i/dx_j
    (N, dim, dim), each component sampled at its own MAC centering."""
    return interpolate_vel_and_gradient(u, grid, X, kernel=kernel,
                                        weights=weights)[1]


def spread_stress(PFt: torch.Tensor, V: torch.Tensor, grid: StaggeredGrid,
                  X: torch.Tensor, kernel="BSPLINE_3",
                  weights: Optional[torch.Tensor] = None) -> Vel:
    """Divergence-form spread of the per-point stress ``PFt = P(F) F^T``
    (N, dim, dim) with reference volumes V (N,):
    f_i(x_g) = -(1/h^dim) sum_p V_p sum_j PFt[p, i, j] dW_g/dx_j.
    The total spread force is zero to roundoff (sum_g dW = 0)."""
    inv_vol = 1.0 / math.prod(grid.dx)
    out = []
    for i in range(grid.dim):
        lin, _, dW = _stencil_with_grad(grid, X, i, kernel)
        coeff = PFt[:, i, :] * V[:, None]
        if weights is not None:
            coeff = coeff * weights[:, None]
        vals = -inv_vol * torch.sum(coeff[:, None, :] * dW, dim=-1)
        flat = torch.zeros(math.prod(grid.n), dtype=vals.dtype,
                           device=vals.device)
        out.append(scatter_add(flat, lin.reshape(-1),
                               vals.reshape(-1)).reshape(grid.n))
    return tuple(out)
