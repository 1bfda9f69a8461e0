"""Spectral plan: cached symbol tables, the k-space-resident fused fluid
substep and the classic periodic solves that share them (port of
``ibamr_tpu/solvers/spectral_plan.py``).

A :class:`SpectralPlan` builds the discrete-Laplacian symbol and the
staggered divergence symbols once per ``(shape, dx, dtype, device)``;
:func:`get_plan` caches them in a bounded LRU with hit/miss/eviction
counts. :meth:`SpectralPlan.substep` is one batched ``rfftn``, the
diagonal algebra of :meth:`SpectralPlan.kspace_algebra`, one batched
``irfftn``.

``spectral_dtype`` selects the transform precision as in the reference:
``None`` is the working precision; ``torch.bfloat16`` rounds the
transform operands (the real input batch and the split-real spectrum
before the inverse transform) through bf16 while the transforms, tables
and algebra stay f32. ``torch.fft`` has no bf16 transform, and the
reference's transform runs at f32 too, so the rounding is emulated by a
cast to bf16 and back. ``torch.float64`` runs the whole substep on the
f64 twin plan and casts the result back.

The custom adjoint of the reference's substep is not ported; the
closed-form adjoint algebra :meth:`SpectralPlan.kspace_algebra_adjoint`
is.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch

from ibamr_tpu_torch.solvers import fft

Vel = Tuple[torch.Tensor, ...]

_SPECTRAL_DTYPE_ALIASES = {
    None: None, "none": None, "f32": None, "float32": None,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f64": torch.float64, "float64": torch.float64,
}


def canonical_spectral_dtype(spec):
    """Normalize the ``spectral_dtype`` knob to ``None`` (working
    precision), ``torch.bfloat16`` (compressed transform operands) or
    ``torch.float64`` (the f64 twin plan). Anything else raises."""
    if isinstance(spec, str):
        key = spec.lower()
        if key in _SPECTRAL_DTYPE_ALIASES:
            return _SPECTRAL_DTYPE_ALIASES[key]
        raise ValueError(
            f"spectral_dtype = {spec!r}: expected one of "
            f"{sorted(k for k in _SPECTRAL_DTYPE_ALIASES if k)} or None")
    if spec is None or spec is torch.bfloat16 or spec is torch.float64:
        return spec
    raise ValueError(f"spectral_dtype = {spec!r}: only bf16 operand "
                     "compression or f64 escalation is supported "
                     "(None = native precision)")


def _round_real(x: torch.Tensor, sdtype) -> torch.Tensor:
    """Round a real transform operand through the storage dtype; the
    transform itself still runs at f32."""
    return x.to(sdtype).to(torch.float32)


def _round_complex(z: torch.Tensor, sdtype) -> torch.Tensor:
    """Split-real rounding of a spectral operand: the real and imaginary
    planes are rounded through the storage dtype independently."""
    return torch.complex(z.real.to(sdtype).to(torch.float32),
                         z.imag.to(sdtype).to(torch.float32))


def _where0(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x.masked_fill(mask, 0.0)


class SpectralPlan:
    """Device-resident spectral symbol tables for one
    ``(shape, dx, dtype, device)`` and the solves that share them; build
    it through :func:`get_plan`."""

    def __init__(self, shape: Sequence[int], dx: Sequence[float], dtype,
                 device):
        self.shape = tuple(int(s) for s in shape)
        self.dx = tuple(float(h) for h in dx)
        self.dim = len(self.shape)
        # batched-transform axes behind a leading stack dimension
        self.axes = tuple(range(1, self.dim + 1))
        self.rdtype = dtype
        self.cdtype = (torch.complex128 if dtype == torch.float64
                       else torch.complex64)
        self.device = torch.device(device)
        self.sym = fft.laplacian_symbol(self.shape, self.dx, self.rdtype,
                                        self.device)
        self.D = fft._staggered_div_symbols(self.shape, self.dx,
                                            self.cdtype, self.device)
        self._k0 = self.sym == 0
        self._sym_safe = torch.where(self._k0, torch.ones_like(self.sym),
                                     self.sym)
        if self.rdtype != torch.float32:
            # f32 twins for the bf16 transform path
            sym32 = self.sym.to(torch.float32)
            k0 = sym32 == 0
            self._f32 = (sym32, tuple(d.to(torch.complex64) for d in self.D),
                         k0, torch.where(k0, torch.ones_like(sym32), sym32))
        else:
            self._f32 = (self.sym, self.D, self._k0, self._sym_safe)

    def _tables(self, f32: bool):
        """``(sym, D, k0, sym_safe)`` at the working precision, or their
        f32 twins; ``sym_safe`` is ``sym`` with its k = 0 entry set to 1."""
        if f32:
            return self._f32
        return self.sym, self.D, self._k0, self._sym_safe

    # -- fused substep --------------------------------------------------------
    def substep(self, rhs: Vel, alpha, beta,
                pinc_coeffs: Tuple[float, float], spectral_dtype=None,
                filter_sym: Optional[torch.Tensor] = None
                ) -> Tuple[Vel, torch.Tensor]:
        """One batched forward rfftn, :meth:`kspace_algebra`, one batched
        inverse irfftn. Returns ``(u_new, p_inc)`` with
        ``u_new = P (alpha + beta lap)^{-1} rhs`` and
        ``p_inc = (a + b lap) lap^{-1} div u_star``."""
        sdtype = canonical_spectral_dtype(spectral_dtype)
        if sdtype is torch.float64:
            if self.rdtype == torch.float64:
                return self.substep(rhs, alpha, beta, pinc_coeffs,
                                    filter_sym=filter_sym)
            plan64 = get_plan(self.shape, self.dx, torch.float64,
                              self.device)
            u64, p64 = plan64.substep(
                tuple(c.to(torch.float64) for c in rhs), alpha, beta,
                pinc_coeffs, filter_sym=filter_sym)
            return (tuple(c.to(self.rdtype) for c in u64),
                    p64.to(self.rdtype))
        x = torch.stack(tuple(rhs))
        if sdtype is not None:
            x = _round_real(x.to(torch.float32), sdtype)
        uh = torch.fft.rfftn(x, dim=self.axes)
        outh = self.kspace_algebra(uh, alpha, beta, pinc_coeffs,
                                   f32=sdtype is not None,
                                   filter_sym=filter_sym)
        if sdtype is not None:
            outh = _round_complex(outh, sdtype)
        out = torch.fft.irfftn(outh, s=self.shape, dim=self.axes)
        out = out.to(self.rdtype)
        return tuple(out[d] for d in range(self.dim)), out[self.dim]

    def kspace_algebra(self, uh: torch.Tensor, alpha, beta,
                       pinc_coeffs: Tuple[float, float], f32: bool = False,
                       filter_sym: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """The diagonal algebra between the substep's two transforms:
        ``uh`` is the stacked forward spectrum of the dim MAC components;
        returns the stacked dim+1 inverse-transform operand."""
        dim = self.dim
        sym, D, k0, sym_safe = self._tables(f32)
        wdtype = torch.float32 if f32 else self.rdtype
        if filter_sym is not None:
            uh = uh * filter_sym.to(wdtype)[None]
        uh = uh / (alpha + beta * sym).to(wdtype)[None]
        divh = D[0] * uh[0]
        for d in range(1, dim):
            divh = divh + D[d] * uh[d]
        # zero-mean pressure: the k = 0 mode of lap^{-1} is dropped
        phih = _where0(k0, divh / sym_safe)
        a, b = pinc_coeffs
        return torch.stack(
            [uh[d] + torch.conj(D[d]) * phih for d in range(dim)]
            + [((a + b * sym) * phih).to(uh.dtype)])

    def kspace_algebra_adjoint(self, ch: torch.Tensor, alpha, beta,
                               pinc_coeffs: Tuple[float, float],
                               f32: bool = False,
                               filter_sym: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
        """Conjugate transpose of :meth:`kspace_algebra`'s block symbol
        applied to the stacked ``dim + 1`` cotangent spectra ``ch``:
        ``(M^H c)_e = H P [c_e + conj(D_e)/lam (sum_d D_d c_d
        + (a + b lam) c_p)]``, the ``1/lam`` term zeroed at k = 0."""
        dim = self.dim
        sym, D, k0, sym_safe = self._tables(f32)
        wdtype = torch.float32 if f32 else self.rdtype
        a, b = pinc_coeffs
        g = D[0] * ch[0]
        for d in range(1, dim):
            g = g + D[d] * ch[d]
        g = g + ((a + b * sym) * ch[dim]).to(ch.dtype)
        psih = _where0(k0, g / sym_safe)
        denom = (alpha + beta * sym).to(wdtype)
        out = torch.stack([ch[d] + torch.conj(D[d]) * psih
                           for d in range(dim)]) / denom[None]
        if filter_sym is not None:
            out = out * filter_sym.to(wdtype)[None]
        return out

    # -- the classic solves, sharing the cached tables ------------------------
    def solve_poisson(self, rhs: torch.Tensor) -> torch.Tensor:
        """lap(p) = rhs; zero-mean solution (k = 0 mode discarded)."""
        rhat = torch.fft.rfftn(rhs)
        phat = _where0(self._k0, rhat / self._sym_safe)
        return torch.fft.irfftn(phat, s=self.shape).to(rhs.dtype)

    def solve_helmholtz(self, rhs: torch.Tensor, alpha, beta
                        ) -> torch.Tensor:
        """(alpha + beta lap) u = rhs (alpha + beta*lam != 0 required)."""
        rhat = torch.fft.rfftn(rhs)
        uhat = rhat / (alpha + beta * self.sym)
        return torch.fft.irfftn(uhat, s=self.shape).to(rhs.dtype)

    def solve_stokes_saddle(self, f_u: Vel, f_p: torch.Tensor, alpha,
                            mu) -> Tuple[Vel, torch.Tensor]:
        """Exact periodic saddle solve of
        ``alpha u - mu lap u + grad p = f_u, -div u = f_p`` as one batched
        spectral pass: ``p_hat = (sum_d D_d f_hat_d + A f_hat_p) / lam``
        (0 at k = 0), ``u_hat_d = (f_hat_d + conj(D_d) p_hat) / A`` with
        ``A = alpha - mu lam`` (0 where A = 0)."""
        dim = self.dim
        sym, D = self.sym, self.D
        fh = torch.fft.rfftn(torch.stack(tuple(f_u) + (f_p,)),
                             dim=self.axes)
        A = (alpha - mu * sym).to(self.rdtype)
        divf = D[0] * fh[0]
        for d in range(1, dim):
            divf = divf + D[d] * fh[d]
        ph = _where0(self._k0, (divf + A * fh[dim]) / self._sym_safe)
        A0 = A == 0
        A_safe = torch.where(A0, torch.ones_like(A), A)
        uh = torch.stack(
            [_where0(A0, (fh[d] + torch.conj(D[d]) * ph) / A_safe)
             for d in range(dim)] + [ph])
        out = torch.fft.irfftn(uh, s=self.shape, dim=self.axes)
        out = out.to(self.rdtype)
        return tuple(out[d] for d in range(dim)), out[dim]


# -- the LRU cache ------------------------------------------------------------

_CACHE_MAXSIZE = 16
_cache: "OrderedDict[tuple, SpectralPlan]" = OrderedDict()
_lock = threading.Lock()
_stats = {"hits": 0, "misses": 0, "evictions": 0}


def plan_key(shape: Sequence[int], dx: Sequence[float], dtype,
             device) -> tuple:
    return (tuple(int(s) for s in shape), tuple(float(h) for h in dx),
            dtype, torch.device(device))


def get_plan(shape: Sequence[int], dx: Sequence[float], dtype,
             device) -> SpectralPlan:
    """One table build per distinct ``(shape, dx, dtype, device)``,
    LRU-bounded at 16 plans."""
    key = plan_key(shape, dx, dtype, device)
    with _lock:
        plan = _cache.get(key)
        if plan is not None:
            _stats["hits"] += 1
            _cache.move_to_end(key)
            return plan
    plan = SpectralPlan(shape, dx, dtype, device)
    with _lock:
        existing = _cache.get(key)
        if existing is not None:
            _stats["hits"] += 1
            _cache.move_to_end(key)
            return existing
        _stats["misses"] += 1
        _cache[key] = plan
        while len(_cache) > _CACHE_MAXSIZE:
            _cache.popitem(last=False)
            _stats["evictions"] += 1
    return plan


def plan_cache_stats() -> dict:
    """``{hits, misses, evictions, size, maxsize}``."""
    with _lock:
        return dict(_stats, size=len(_cache), maxsize=_CACHE_MAXSIZE)


def clear_plan_cache() -> None:
    with _lock:
        _cache.clear()
        for k in _stats:
            _stats[k] = 0


def spectral_substep(rhs: Vel, dx: Sequence[float], alpha, beta,
                     pinc_coeffs: Tuple[float, float], spectral_dtype=None,
                     filter_sym: Optional[torch.Tensor] = None
                     ) -> Tuple[Vel, torch.Tensor]:
    """The plan-cached fused substep for ``rhs[0]``'s shape, dtype and
    device (see :meth:`SpectralPlan.substep`)."""
    plan = get_plan(rhs[0].shape, dx, rhs[0].dtype, rhs[0].device)
    return plan.substep(rhs, alpha, beta, pinc_coeffs,
                        spectral_dtype=spectral_dtype,
                        filter_sym=filter_sym)


def gaussian_filter_symbol(shape: Sequence[int], dx: Sequence[float],
                           width: float, dtype=torch.float32,
                           device="cuda") -> torch.Tensor:
    """Spectral symbol of a discrete Gaussian smoother of standard
    deviation ``width``: ``exp(width^2/2 lam)`` with ``lam`` the discrete
    Laplacian symbol, built at f64 and cast to ``dtype``."""
    from ibamr_tpu_torch.device import resolve_device

    lam = fft.laplacian_symbol(shape, dx, torch.float64,
                               resolve_device(device))
    return torch.exp(0.5 * float(width) ** 2 * lam).to(dtype)
