"""Regularized discrete delta functions (port of ``ibamr_tpu/ops/delta.py``).

The reference's kernel menu: PIECEWISE_LINEAR, COSINE, IB_3, IB_4, IB_6,
BSPLINE_2..6, the composite B-splines (COMPOSITE_BSPLINE_32/43/54,
anisotropic: resolve them per axis with :func:`get_kernel_axes`) and
user-defined ``(support, phi)`` pairs. Each kernel is a branch-free
expression on |r|, evaluated for all markers and stencil offsets at once;
multi-D weights are tensor products of these 1-D kernels.

The CUDA kernels (``csrc/delta_ib4.cuh``) evaluate IB_4 only, and the
engines that launch them raise for any other delta; the scatter oracle
and the ``packed`` engines take every kernel here.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Tuple, Union

import numpy as np
import torch

KernelFn = Callable[[torch.Tensor], torch.Tensor]
KernelSpec = Tuple[int, KernelFn]  # (support in grid points, phi(r))


def _phi_piecewise_linear(r: torch.Tensor) -> torch.Tensor:
    # |r| by a select and the clamp by ``maximum``: at the kinks their
    # derivatives are the reference's (+1 at r = 0 where torch.abs gives
    # 0; the mean of both sides at the clamp, where torch.clamp gives 1)
    return torch.maximum(1.0 - torch.where(r >= 0.0, r, -r),
                         torch.zeros_like(r))


def _phi_cosine(r: torch.Tensor) -> torch.Tensor:
    a = torch.abs(r)
    return torch.where(a < 2.0, 0.25 * (1.0 + torch.cos(0.5 * math.pi * a)),
                       torch.zeros_like(a))


class _SafeSqrt(torch.autograd.Function):
    """sqrt clamped at 0 with a finite derivative at the clamp (the
    reference's custom JVP): 1/(2 sqrt(x)) where the result is positive,
    0 at and below the clamp, where plain autograd gives inf * 0 = nan."""

    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(torch.clamp(x, min=0.0))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        pos = y > 0.0
        return torch.where(pos, g / torch.where(pos, 2.0 * y,
                                                torch.ones_like(y)),
                           torch.zeros_like(g))


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    # the same primal either way; the Function (and its cost per call on
    # the host) only where autograd records the call
    if torch.is_grad_enabled() and x.requires_grad:
        return _SafeSqrt.apply(x)
    return torch.sqrt(torch.clamp(x, min=0.0))


def _phi_ib3(r: torch.Tensor) -> torch.Tensor:
    a = torch.abs(r)
    inner = (1.0 + _safe_sqrt(1.0 - 3.0 * a * a)) / 3.0
    s = _safe_sqrt(1.0 - 3.0 * (1.0 - a) ** 2)
    outer = (5.0 - 3.0 * a - s) / 6.0
    return torch.where(a < 0.5, inner,
                       torch.where(a < 1.5, outer, torch.zeros_like(a)))


def _phi_ib4(r: torch.Tensor) -> torch.Tensor:
    a = torch.abs(r)
    # the linear part first: autograd then sums the root's terms of the
    # derivative before the linear one, so at r = +-1/2, where the root's
    # terms cancel, the gradient is exact whatever the last bit of sqrt
    lin_in = 3.0 - 2.0 * a
    s_in = _safe_sqrt(1.0 + 4.0 * a - 4.0 * a * a)
    inner = 0.125 * (lin_in + s_in)
    s_out = _safe_sqrt(-7.0 + 12.0 * a - 4.0 * a * a)
    outer = 0.125 * (5.0 - 2.0 * a - s_out)
    return torch.where(a < 1.0, inner,
                       torch.where(a < 2.0, outer, torch.zeros_like(a)))


def _integer_pow_raw(x: torch.Tensor, y: int) -> torch.Tensor:
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


class _IntegerPow(torch.autograd.Function):
    """``x ** y`` with the reference's derivative rule, in both modes:
    ``t * (y * x ** (y - 1))`` as one factor, where autograd through the
    product chain would sum one term per factor in its own order."""

    @staticmethod
    def forward(x, y):
        out = _integer_pow_raw(x, y)
        # y = 1 returns x itself, which autograd cannot save and return
        return out.view_as(out) if out is x else out

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, y = inputs
        ctx.y = y
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)

    @staticmethod
    def _slope(x, y):
        return y * _integer_pow_raw(x, y - 1)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _IntegerPow._slope(x, ctx.y), None

    @staticmethod
    def jvp(ctx, t, _):
        (x,) = ctx.saved_tensors
        return t * _IntegerPow._slope(x, ctx.y)


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """``x ** y`` by binary exponentiation, the products in the order the
    reference's integer power takes them (the B-splines' truncated
    powers cancel, so their rounding shows), and its derivative by the
    reference's rule."""
    if y == 0:
        return torch.ones_like(x)
    return _IntegerPow.apply(x, y)


def _make_bspline(order: int) -> KernelFn:
    """Cardinal B-spline M_k by the truncated-power formula
    M_k(x) = 1/(k-1)! sum_j (-1)^j C(k,j) (x + k/2 - j)_+^{k-1}:
    support k grid points, C^{k-2}, a partition of unity."""
    k = order
    coef = [((-1) ** j) * math.comb(k, j) / math.factorial(k - 1)
            for j in range(k + 1)]

    def phi(r: torch.Tensor) -> torch.Tensor:
        zeros = torch.zeros_like(r)
        out = zeros
        for j in range(k + 1):
            # ``maximum``, not ``clamp``: at the knot its derivative is
            # the mean of both sides, the reference's
            out = out + coef[j] * _integer_pow(
                torch.maximum(r + 0.5 * k - j, zeros), k - 1)
        return torch.where(torch.abs(r) < 0.5 * k, out, torch.zeros_like(r))

    return phi


@functools.lru_cache(maxsize=4)
def _ib6_table(m: int = 4096) -> np.ndarray:
    """The 6-point C3 kernel tabulated on a uniform r-grid over [-3, 3]
    (the reference's construction, value for value, in float64 numpy).

    For each fractional position x the six weights are the smooth
    solution of m0 = 1, m1 = 0, m2 = K, m3 = 0, sum_even = sum_odd = 1/2
    and sum of squares = C, with K = 59/60 - sqrt(29)/20 (Bao, Kaye and
    Peskin 2016) and C pinned by phi(+-3) = 0, solved at first use with
    the branch tracked continuously in x. Evaluation interpolates the
    table linearly (error ~ (1/m)^2)."""
    Kc = 59.0 / 60.0 - math.sqrt(29.0) / 20.0
    s6 = np.arange(-2, 4)
    even = (s6 % 2 == 0).astype(float)

    def lin(x):
        p = x - s6
        A = np.stack([np.ones(6), p, p * p, p ** 3, even])
        b = np.array([1.0, 0.0, Kc, 0.0, 0.5])
        w0, *_ = np.linalg.lstsq(A, b, rcond=None)
        _, _, Vt = np.linalg.svd(A)
        return w0, Vt[-1]

    w0, v = lin(0.0)
    t0 = -w0[5] / v[5]
    C = (w0 + t0 * v) @ (w0 + t0 * v)

    xs = np.linspace(0.0, 1.0, m, endpoint=False)
    W = np.zeros((m, 6))
    prev = w0 + t0 * v
    for i, x in enumerate(xs):
        w0, v = lin(x)
        t = math.sqrt(max(C - w0 @ w0, 0.0))
        ca, cb = w0 + t * v, w0 - t * v
        W[i] = ca if (np.linalg.norm(ca - prev)
                      <= np.linalg.norm(cb - prev)) else cb
        prev = W[i]
    # segment j covers r in [-3+j, -2+j): the weight of point s = 3-j at
    # fractional position x = r + 3 - j
    tab = np.zeros(6 * m + 1)
    for j in range(6):
        tab[j * m:(j + 1) * m] = W[:, 5 - j]
    tab[-1] = 0.0
    return tab


@functools.lru_cache(maxsize=8)
def _ib6_tensor(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_ib6_table(), device=device)


def _phi_ib6(r: torch.Tensor) -> torch.Tensor:
    tab = _ib6_tensor(r.device)
    m = (tab.shape[0] - 1) // 6
    t = (torch.clamp(r, -3.0, 3.0) + 3.0) * m
    i = torch.clamp(torch.floor(t).to(torch.int64), 0, 6 * m - 1)
    frac = t - i.to(t.dtype)
    lo, hi = tab[i], tab[i + 1]
    val = lo + frac * (hi - lo)
    return torch.where(torch.abs(r) < 3.0, val,
                       torch.zeros_like(val)).to(r.dtype)


_KERNELS: Dict[str, KernelSpec] = {
    "PIECEWISE_LINEAR": (2, _phi_piecewise_linear),
    "COSINE": (4, _phi_cosine),
    "IB_3": (3, _phi_ib3),
    "IB_4": (4, _phi_ib4),
    "IB_6": (6, _phi_ib6),
    "BSPLINE_2": (2, _make_bspline(2)),
    "BSPLINE_3": (3, _make_bspline(3)),
    "BSPLINE_4": (4, _make_bspline(4)),
    "BSPLINE_5": (5, _make_bspline(5)),
    "BSPLINE_6": (6, _make_bspline(6)),
}

# Composite B-splines: a MAC velocity component takes order n along its
# own (face-normal) axis and n-1 along the others; cell-centered fields
# take order n on every axis.
_COMPOSITE: Dict[str, Tuple[int, int]] = {
    "COMPOSITE_BSPLINE_32": (3, 2),
    "COMPOSITE_BSPLINE_43": (4, 3),
    "COMPOSITE_BSPLINE_54": (5, 4),
}

Kernel = Union[str, KernelSpec]


def is_composite(kernel: Kernel) -> bool:
    return isinstance(kernel, str) and kernel.upper() in _COMPOSITE


# kernels with a trustworthy derivative for kernel-gradient transfers: the
# C^1 closed forms (the hat and BSPLINE_2 are C^0, IB_3/IB_4 kink at their
# knots, IB_6 is a piecewise-linear table, COMPOSITE_BSPLINE_32's
# tangential axis is the hat)
_C1_GRADIENT_KERNELS = frozenset({
    "COSINE", "BSPLINE_3", "BSPLINE_4", "BSPLINE_5", "BSPLINE_6",
    "COMPOSITE_BSPLINE_43", "COMPOSITE_BSPLINE_54",
})


def validate_gradient_kernel(kernel: Kernel) -> None:
    """Raise ``ValueError`` for a named kernel that is not C^1 (its
    derivative is unreliable for kernel-gradient transfers). A
    user-defined ``(support, phi)`` pair passes: its smoothness is the
    caller's contract."""
    if isinstance(kernel, str) and \
            kernel.upper() not in _C1_GRADIENT_KERNELS:
        raise ValueError(
            f"kernel {kernel!r} is not C^1 (or its implementation has "
            "no trustworthy AD derivative) and cannot be used for "
            "kernel-gradient transfers (IMP); choose one of "
            f"{sorted(_C1_GRADIENT_KERNELS)} or pass a user-defined "
            "(support, phi) pair that is C^1")


def get_kernel_axes(kernel: Kernel, centering, dim: int
                    ) -> List[KernelSpec]:
    """Per-axis ``(support, phi)`` for a field of the given centering
    ("cell" or the int component of a MAC velocity). Plain kernels are
    isotropic; composite B-splines pick the order by normal/tangential
    axis."""
    if is_composite(kernel):
        n_norm, n_tang = _COMPOSITE[kernel.upper()]
        if isinstance(centering, int):
            return [get_kernel(f"BSPLINE_{n_norm}") if d == centering
                    else get_kernel(f"BSPLINE_{n_tang}")
                    for d in range(dim)]
        if centering != "cell":
            raise ValueError(
                "composite B-spline kernels need centering='cell' or an "
                "int MAC component (to identify the normal axis); got "
                f"{centering!r}")
        return [get_kernel(f"BSPLINE_{n_norm}")] * dim
    return [get_kernel(kernel)] * dim


def get_kernel(kernel: Kernel) -> KernelSpec:
    """``(support in grid points, phi)`` for a kernel name, or a
    user-defined ``(support, phi)`` pair as it is. A composite kernel is
    anisotropic and raises here: resolve it per axis with
    :func:`get_kernel_axes`."""
    if isinstance(kernel, str):
        name = kernel.upper()
        if name in _COMPOSITE:
            raise ValueError(
                f"{kernel!r} is a composite (anisotropic) kernel; use "
                "get_kernel_axes / the scatter interaction path")
        try:
            return _KERNELS[name]
        except KeyError:
            raise ValueError(
                f"unknown delta kernel {kernel!r}; have "
                f"{sorted(_KERNELS) + sorted(_COMPOSITE)}")
    support, fn = kernel
    return int(support), fn


def stencil_size(kernel: Kernel) -> int:
    """Points per axis of the stencil (the largest over the axes of a
    composite kernel)."""
    if is_composite(kernel):
        return max(_COMPOSITE[kernel.upper()])
    return get_kernel(kernel)[0]


def available_kernels() -> Tuple[str, ...]:
    return tuple(sorted(_KERNELS) + sorted(_COMPOSITE))


def is_ib4(kernel: Kernel) -> bool:
    """Whether ``kernel`` names IB_4, the one delta the CUDA kernels
    evaluate."""
    return isinstance(kernel, str) and kernel.upper() == "IB_4"
