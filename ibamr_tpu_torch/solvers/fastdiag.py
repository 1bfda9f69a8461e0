"""Fast-diagonalization Helmholtz/Poisson solver for wall-bounded boxes
(port of ``ibamr_tpu/solvers/fastdiag.py``).

The discrete Laplacian with BC-modified end rows is a symmetric
tridiagonal per axis. Each non-periodic axis is eigendecomposed once on
the host with ``numpy.linalg.eigh`` (the reference does the same, so both
packages apply the same eigenvectors ``V``), and ``V`` is applied as a
dense axis transform; periodic axes use the FFT. The operator is then
diagonal: forward transforms, divide, inverse transforms. The solve is
exact for the discrete operator.

The axis transforms are dense products outside any hand kernel, as in the
reference (where XLA ran them); here they are ``torch.tensordot`` at the
field's dtype (TF32 stays off, torch's default).

Centerings per axis:
- ``cc``        cell-centered unknowns, walls at the faces;
- ``fc_pinned`` the face-centered normal component: slot 0 is the lo
                boundary face, pinned to the BC value, and the hi
                boundary face is its periodic image; the unknowns are
                the interior faces 1..n-1.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch

from ibamr_tpu_torch.bc import AxisBC, DomainBC, ghost_reflect_coeff
from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid


def laplacian_1d_cc(n: int, h: float, axbc: AxisBC) -> np.ndarray:
    """BC-modified tridiagonal of a cell-centered axis (homogeneous): the
    end diagonal is ``(-2 + r)/h^2`` with ``r`` the ghost reflection
    coefficient of ``bc.ghost_reflect_coeff``."""
    A = np.zeros((n, n))
    inv = 1.0 / (h * h)
    for i in range(n):
        A[i, i] = -2.0 * inv
        if i > 0:
            A[i, i - 1] = inv
        if i < n - 1:
            A[i, i + 1] = inv
    for side, i in ((axbc.lo, 0), (axbc.hi, n - 1)):
        if side.kind == "periodic":
            raise ValueError("periodic axis has no 1D matrix")
        r = ghost_reflect_coeff(side, h)
        A[i, i] = (-2.0 + r) * inv
    return A


def laplacian_1d_fc_pinned(n: int, h: float) -> np.ndarray:
    """Interior-face unknowns (1..n-1) with Dirichlet boundary faces: the
    standard (n-1)-point Dirichlet tridiagonal."""
    m = n - 1
    A = np.zeros((m, m))
    inv = 1.0 / (h * h)
    for i in range(m):
        A[i, i] = -2.0 * inv
        if i > 0:
            A[i, i - 1] = inv
        if i < m - 1:
            A[i, i + 1] = inv
    return A


def laplacian_1d_periodic(n: int, h: float) -> np.ndarray:
    """Circulant 1D Laplacian (its eigh basis is a real orthogonal
    Fourier basis: the dense alternative to the FFT plan)."""
    eye = np.eye(n)
    return (-2.0 * eye + np.roll(eye, 1, axis=1)
            + np.roll(eye, -1, axis=1)) / (h * h)


def _periodic_symbol(n: int, h: float) -> np.ndarray:
    k = np.fft.fftfreq(n)
    return (2.0 * np.cos(2.0 * math.pi * k) - 2.0) / (h * h)


@functools.lru_cache(maxsize=64)
def _periodic_fft_plan(n: int, h: float, device: torch.device):
    return ("fft", torch.as_tensor(_periodic_symbol(n, h), device=device))


@functools.lru_cache(maxsize=64)
def _periodic_eig_plan(n: int, h: float, device: torch.device):
    lam, V = np.linalg.eigh(laplacian_1d_periodic(n, h))
    return ("eig", torch.as_tensor(V, device=device),
            torch.as_tensor(lam, device=device))


class FastDiagSolver:
    """Separable Helmholtz solve ``(alpha + beta lap) Q = rhs`` on one grid
    for one combination of per-axis (BC, centering). ``dense_periodic``
    applies periodic axes as dense real-Fourier eigenbasis products
    instead of FFTs."""

    def __init__(self, grid: StaggeredGrid, bc: DomainBC,
                 centerings: Sequence[str], dense_periodic: bool = False,
                 device="cuda"):
        self.grid = grid
        self.bc = bc
        self.centerings = tuple(centerings)
        self.device = resolve_device(device)
        self.plans = []            # per axis: ("fft", lam) | ("eig", V, lam)
        for axbc, cent, n, h in zip(bc.axes, self.centerings, grid.n,
                                    grid.dx):
            n, h = int(n), float(h)
            if axbc.periodic and dense_periodic:
                self.plans.append(_periodic_eig_plan(n, h, self.device))
            elif axbc.periodic:
                self.plans.append(_periodic_fft_plan(n, h, self.device))
            elif cent in ("cc", "fc_pinned"):
                A = (laplacian_1d_cc(n, h, axbc) if cent == "cc"
                     else laplacian_1d_fc_pinned(n, h))
                lam, V = np.linalg.eigh(A)
                self.plans.append(("eig",
                                   torch.as_tensor(V, device=self.device),
                                   torch.as_tensor(lam, device=self.device)))
            else:
                raise ValueError(f"unknown centering {cent!r}")

    @staticmethod
    def _axis_matmul(x: torch.Tensor, M: torch.Tensor,
                     axis: int) -> torch.Tensor:
        """Apply M (m_out, m_in) along ``axis`` of x."""
        moved = torch.movedim(x, axis, -1)
        out = torch.tensordot(moved, M.to(moved.dtype), dims=([-1], [1]))
        return torch.movedim(out, -1, axis)

    def _pinned(self):
        return [d for d, c in enumerate(self.centerings)
                if c == "fc_pinned" and not self.bc.axes[d].periodic]

    def solve(self, rhs: torch.Tensor, alpha, beta,
              zero_nullspace: bool = False) -> torch.Tensor:
        """Solve ``(alpha + beta lap) Q = rhs``. With alpha == 0 on an
        all-Neumann/periodic problem, ``zero_nullspace`` projects out the
        constant mode (eigenvalues within 1e-8 of the spectral radius of
        zero count as null)."""
        pinned = self._pinned()
        idx = [slice(None)] * rhs.ndim
        for d in pinned:
            idx[d] = slice(1, None)
        x = rhs[tuple(idx)]
        rdt = x.dtype
        cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
        dim = x.ndim

        for d, plan in enumerate(self.plans):
            if plan[0] == "eig":
                x = self._axis_matmul(x, plan[1].T, d)
        any_fft = any(p[0] == "fft" for p in self.plans)
        if any_fft:
            x = x.to(cdt)
            for d, plan in enumerate(self.plans):
                if plan[0] == "fft":
                    x = torch.fft.fft(x, dim=d)

        sym = torch.zeros((), dtype=rdt, device=x.device)
        for d, plan in enumerate(self.plans):
            lam = plan[1] if plan[0] == "fft" else plan[2]
            shape = [1] * dim
            shape[d] = lam.shape[0]
            sym = sym + lam.reshape(shape).to(rdt)
        denom = alpha + beta * sym
        if zero_nullspace:
            # eigh's nullspace eigenvalues are ~1e-13, never an exact 0
            tol = 1e-8 * torch.max(torch.abs(sym))
            null = torch.abs(denom) <= tol
            safe = torch.where(null, torch.ones_like(denom), denom)
            x = (x / safe).masked_fill(null, 0.0)
        else:
            x = x / denom

        if any_fft:
            for d, plan in enumerate(self.plans):
                if plan[0] == "fft":
                    x = torch.fft.ifft(x, dim=d)
            x = x.real.to(rdt)
        for d, plan in enumerate(self.plans):
            if plan[0] == "eig":
                x = self._axis_matmul(x, plan[1], d)

        # re-attach the pinned faces as zeros (homogeneous walls)
        for d in pinned:
            shape = list(x.shape)
            shape[d] = 1
            x = torch.cat([x.new_zeros(shape), x], dim=d)
        return x
