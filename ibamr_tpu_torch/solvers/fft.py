"""Spectral solvers for the periodic uniform level (port of
``ibamr_tpu/solvers/fft.py``).

The inverted symbol is that of the discrete 2d+1-point Laplacian,
``sum_d (2 cos(2 pi k_d / n_d) - 2) / h_d^2``, so the spectral solves are
exact inverses of the stencils in ``ops/stencils.py`` and the projected
velocity is divergence-free to roundoff. The zero mode follows the
reference: the Poisson solve discards it (zero-mean solution), which is
the periodic compatibility projection. The transforms go to cuFFT (or
PocketFFT on the CPU) through ``torch.fft``; the symbol tables come from
the plan cache of ``solvers/spectral_plan.py``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

Vel = Tuple[torch.Tensor, ...]


def _freqs(n: int, last: bool, device) -> torch.Tensor:
    if last:
        return torch.fft.rfftfreq(n, dtype=torch.float64, device=device)
    return torch.fft.fftfreq(n, dtype=torch.float64, device=device)


def laplacian_symbol(shape: Sequence[int], dx: Sequence[float],
                     dtype, device) -> torch.Tensor:
    """Eigenvalues of the discrete periodic Laplacian on the rfftn grid
    of a real field of ``shape`` (broadcast to the full rfftn shape)."""
    dim = len(shape)
    sym = None
    for d in range(dim):
        k = _freqs(shape[d], d == dim - 1, device)
        lam = ((2.0 * torch.cos(2.0 * math.pi * k) - 2.0)
               / (dx[d] ** 2)).to(dtype)
        bshape = [1] * dim
        bshape[d] = lam.shape[0]
        lam = lam.reshape(bshape)
        sym = lam if sym is None else sym + lam
    return sym


def _staggered_div_symbols(shape: Sequence[int], dx: Sequence[float],
                           cdtype, device) -> Tuple[torch.Tensor, ...]:
    """Per-axis symbols of the staggered MAC divergence
    ``D_d = (e^{i theta_d} - 1) / h_d``; the matching gradient symbol is
    ``-conj(D_d)`` and ``sum_d |D_d|^2 = -laplacian_symbol``."""
    dim = len(shape)
    out = []
    for d in range(dim):
        theta = 2.0 * math.pi * _freqs(shape[d], d == dim - 1, device)
        Dd = (torch.exp(1j * theta.to(torch.complex128)) - 1.0) / dx[d]
        bshape = [1] * dim
        bshape[d] = Dd.shape[0]
        out.append(Dd.reshape(bshape).to(cdtype))
    return tuple(out)


def _plan(f: torch.Tensor, dx: Sequence[float]):
    from ibamr_tpu_torch.solvers import spectral_plan

    return spectral_plan.get_plan(f.shape, dx, f.dtype, f.device)


def solve_poisson_periodic(rhs: torch.Tensor,
                           dx: Sequence[float]) -> torch.Tensor:
    """Solve lap(p) = rhs on the periodic grid; the zero-mean solution
    (the mean of rhs is projected out)."""
    return _plan(rhs, dx).solve_poisson(rhs)


def solve_helmholtz_periodic(rhs: torch.Tensor, dx: Sequence[float],
                             alpha: float, beta: float) -> torch.Tensor:
    """Solve (alpha + beta lap) u = rhs on the periodic grid."""
    return _plan(rhs, dx).solve_helmholtz(rhs, alpha, beta)


def solve_helmholtz_periodic_vel(rhs: Vel, dx: Sequence[float],
                                 alpha: float, beta: float) -> Vel:
    """Component-wise Helmholtz solve of a MAC velocity (one symbol for
    every staggering)."""
    return tuple(solve_helmholtz_periodic(c, dx, alpha, beta) for c in rhs)


def solve_stokes_periodic(f: Vel, dx: Sequence[float],
                          mu: float) -> Tuple[Vel, torch.Tensor]:
    """Steady Stokes ``-mu lap u + grad p = f, div u = 0`` on the periodic
    MAC grid: p from lap(p) = div(f), then each component from
    ``-mu lap u_d = (P f)_d``; returns (u, p), both zero-mean."""
    f_proj, phi = project_divergence_free(f, dx)
    u = tuple(-solve_poisson_periodic(c, dx) / mu for c in f_proj)
    return u, phi


def helmholtz_project_periodic(rhs: Vel, dx: Sequence[float],
                               alpha: float, beta: float,
                               pinc_coeffs: Tuple[float, float],
                               spectral_dtype=None, filter_sym=None
                               ) -> Tuple[Vel, torch.Tensor]:
    """Fused spectral Stokes substep: one batched rfftn of the stacked
    MAC components, the Helmholtz inverse, the staggered Leray
    projection and the pressure-increment assembly as diagonal k-space
    algebra, then one batched irfftn. Returns ``(u_new, p_inc)`` with
    ``u_new = P (alpha + beta lap)^{-1} rhs`` and
    ``p_inc = (a + b lap) lap^{-1} div u_star`` for
    ``pinc_coeffs = (a, b)``; ``spectral_dtype`` and ``filter_sym`` as in
    :meth:`spectral_plan.SpectralPlan.substep`."""
    return _plan(rhs[0], dx).substep(rhs, alpha, beta, pinc_coeffs,
                                     spectral_dtype=spectral_dtype,
                                     filter_sym=filter_sym)


def project_divergence_free(u: Vel, dx: Sequence[float],
                            q=None) -> Tuple[Vel, torch.Tensor]:
    """Exact discrete Leray projection: ``phi = lap^{-1}(div u - q)``,
    ``u_proj = u - grad phi``; returns (u_proj, phi). ``q`` is an optional
    cell-centered divergence source; its mean has no periodic solution
    and is discarded with the k = 0 mode."""
    from ibamr_tpu_torch.ops import stencils

    div = stencils.divergence(u, dx)
    if q is not None:
        div = div - q
    phi = solve_poisson_periodic(div, dx)
    g = stencils.gradient(phi, dx)
    return tuple(c - gc for c, gc in zip(u, g)), phi
