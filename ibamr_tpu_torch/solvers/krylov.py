"""Matrix-free Krylov solvers over pytrees of tensors (port of
``ibamr_tpu/solvers/krylov.py``): preconditioned CG, BiCGStab, flexible
GMRES(m) and Newton-Krylov.

The reference's ``lax.while_loop`` becomes a Python loop whose condition
is one host read per iteration (per restart for FGMRES). FGMRES runs
Arnoldi as ``m`` fixed steps with no host read inside, and tests its
convergence once per restart, as the reference does; its Krylov basis is
one (m+1, n) matrix, so the orthogonalization (classical Gram-Schmidt,
twice) is two matrix-vector products per step. The small least-squares
problem is solved by SVD with the reference's ``eps`` cutoff (singular
values below ``eps * s_max``, or zero, are dropped; ``torch.linalg.lstsq``
on CUDA takes no cutoff), and non-finite entries of its solution are
zeroed, as the reference zeroes them.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ibamr_tpu_torch.ops.norms import tree_dot, tree_dots
from ibamr_tpu_torch.utils.tree import leaves, ravel, tree_map

Pytree = Any
Operator = Callable[[Pytree], Pytree]


def _gnorm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v)


def tree_axpy(alpha, x: Pytree, y: Pytree) -> Pytree:
    """alpha * x + y"""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_scale(alpha, x: Pytree) -> Pytree:
    return tree_map(lambda xi: alpha * xi, x)


def tree_sub(x: Pytree, y: Pytree) -> Pytree:
    return tree_map(lambda xi, yi: xi - yi, x, y)


def _select(cond: torch.Tensor, a: Pytree, b: Pytree) -> Pytree:
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)


def _safe(x: torch.Tensor) -> torch.Tensor:
    """x, with 1 where x is 0 (a breakdown-guarded denominator)."""
    return torch.where(x == 0, torch.ones_like(x), x)


class SolveResult(NamedTuple):
    x: Pytree
    iters: int              # iterations (restarts for FGMRES) taken
    resnorm: torch.Tensor   # final |r|_2 (unweighted l2)
    converged: torch.Tensor  # bool


def _stop(tol, bnorm, atol):
    return torch.clamp(tol * bnorm, min=atol)


def cg(A: Operator, b: Pytree, x0: Optional[Pytree] = None,
       M: Optional[Operator] = None, tol: float = 1e-6, atol: float = 0.0,
       maxiter: int = 100) -> SolveResult:
    """Preconditioned conjugate gradient for SPD A. Stops when
    ``|r| <= max(tol |b|, atol)``, or once the residual has grown past
    1e4 times the best seen (below the dtype's floor the recurrence loses
    conjugacy); an unconverged solve returns its best iterate."""
    if x0 is None:
        x0 = tree_map(torch.zeros_like, b)
    if M is None:
        M = lambda r: r  # noqa: E731
    stop = _stop(tol, torch.sqrt(tree_dot(b, b)), atol)
    x = x0
    r = tree_sub(b, A(x0))
    z = M(r)
    p = z
    rz, rnsq = tree_dots([(r, z), (r, r)])
    rn = torch.sqrt(rnsq)
    xb, rb, k = x0, rn, 0
    while k < maxiter and bool((rn > stop) & (rn <= 1e4 * rb)):
        Ap = A(p)
        pAp = tree_dot(p, Ap)
        alpha = torch.where(pAp > 0, rz / _safe(pAp), torch.zeros_like(pAp))
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, Ap, r)
        z = M(r)
        rz_new, rnsq = tree_dots([(r, z), (r, r)])
        beta = torch.where(rz > 0, rz_new / _safe(rz), torch.zeros_like(rz))
        p = tree_axpy(beta, p, z)
        rz = rz_new
        rn = torch.sqrt(rnsq)
        better = rn < rb
        xb = _select(better, x, xb)
        rb = torch.minimum(rb, rn)
        k += 1
    converged = rn <= stop
    use_best = ~converged & (rb < rn)
    return SolveResult(x=_select(use_best, xb, x), iters=k,
                       resnorm=torch.where(use_best, rb, rn),
                       converged=converged)


def bicgstab(A: Operator, b: Pytree, x0: Optional[Pytree] = None,
             M: Optional[Operator] = None, tol: float = 1e-6,
             atol: float = 0.0, maxiter: int = 200) -> SolveResult:
    """Right-preconditioned BiCGStab for general A, with the same
    best-iterate guard as :func:`cg`."""
    if x0 is None:
        x0 = tree_map(torch.zeros_like, b)
    if M is None:
        M = lambda r: r  # noqa: E731
    stop = _stop(tol, torch.sqrt(tree_dot(b, b)), atol)
    x = x0
    r = tree_sub(b, A(x0))
    rhat = r
    one = torch.ones((), dtype=leaves(b)[0].dtype,
                     device=leaves(b)[0].device)
    rn = torch.sqrt(tree_dot(r, r))
    zeros = tree_map(torch.zeros_like, b)
    p, v = zeros, zeros
    rho, alpha, omega = one, one, one
    xb, rb, k = x0, rn, 0
    while k < maxiter and bool((rn > stop) & (rn <= 1e4 * rb)):
        rho_new = tree_dot(rhat, r)
        beta = (rho_new / _safe(rho * omega)) * (alpha / _safe(omega))
        p = tree_axpy(beta, tree_axpy(-omega, v, p), r)
        phat = M(p)
        v = A(phat)
        alpha = rho_new / _safe(tree_dot(rhat, v))
        s = tree_axpy(-alpha, v, r)
        shat = M(s)
        t = A(shat)
        tt, ts = tree_dots([(t, t), (t, s)])
        omega = ts / _safe(tt)
        x = tree_axpy(alpha, phat, tree_axpy(omega, shat, x))
        r = tree_axpy(-omega, t, s)
        rho = rho_new
        rn = torch.sqrt(tree_dot(r, r))
        better = rn < rb
        xb = _select(better, x, xb)
        rb = torch.minimum(rb, rn)
        k += 1
    converged = rn <= stop
    use_best = ~converged & (rb < rn)
    return SolveResult(x=_select(use_best, xb, x), iters=k,
                       resnorm=torch.where(use_best, rb, rn),
                       converged=converged)


def _lstsq_eps(H: torch.Tensor, e1: torch.Tensor) -> torch.Tensor:
    """Least-squares solution of ``H y = e1`` by SVD, dropping singular
    values that are zero or below ``eps * s_max`` (the reference's
    ``jnp.linalg.lstsq(H, e1, rcond=eps)``), non-finite entries zeroed."""
    eps = torch.finfo(H.dtype).eps
    # a non-finite entry makes every entry of the reference's SVD
    # solution non-finite, so y = 0; an all-zero system gives the same y
    # here without a host read
    ok = torch.isfinite(H).all() & torch.isfinite(e1).all()
    H = torch.where(ok, H, torch.zeros_like(H))
    e1 = torch.where(ok, e1, torch.zeros_like(e1))
    u, s, vt = torch.linalg.svd(H, full_matrices=False)
    keep = (s > 0) & (s >= eps * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    y = vt.T @ (s_inv * (u.T @ e1))
    return torch.where(torch.isfinite(y), y, torch.zeros_like(y))


def _fgmres_flat(Aop, b, x0, Mop, m, tol, atol, restarts):
    """Flexible right-preconditioned GMRES(m) on flat vectors; returns
    ``(x, resnorm, restarts taken)``."""
    n = b.shape[0]
    kw = dict(dtype=b.dtype, device=b.device)
    stop = _stop(tol, _gnorm(b), atol)
    x, rn, it = x0, torch.tensor(float("inf"), **kw), 0
    rows = torch.arange(m + 1, device=b.device)
    while it < restarts and bool(rn > stop):
        r = b - Aop(x)
        beta = _gnorm(r)
        V = torch.zeros((m + 1, n), **kw)
        V[0] = r / _safe(beta)
        Z = torch.zeros((m, n), **kw)
        H = torch.zeros((m + 1, m), **kw)
        for j in range(m):
            z = Mop(V[j])
            w = Aop(z)
            mask = (rows <= j).to(b.dtype)
            dots = (V @ w) * mask
            w = w - V.T @ dots
            dots2 = (V @ w) * mask
            w = w - V.T @ dots2
            wnorm = _gnorm(w)
            H[:, j] = dots + dots2
            H[j + 1, j] = wnorm
            V[j + 1] = w / _safe(wnorm)
            Z[j] = z
        e1 = torch.zeros(m + 1, **kw)
        e1[0] = beta
        x = x + Z.T @ _lstsq_eps(H, e1)
        rn = _gnorm(b - Aop(x))
        it += 1
    return x, rn, it


def _svd_jvp(H: torch.Tensor, dH: torch.Tensor):
    """The SVD of H (k = min shape) with its forward-mode tangents, by
    JAX's rule (``jax._src.lax.linalg._svd_jvp_rule``, thin SVD): only
    the diagonal of the singular-value difference matrix is guarded."""
    u, s, vt = torch.linalg.svd(H, full_matrices=False)
    v = vt.T
    dS = u.T @ dH @ v
    ds = torch.diagonal(dS)
    sd = s[None, :]
    s_diffs = (sd + sd.T) * (sd - sd.T)
    eye = torch.eye(s.shape[0], dtype=H.dtype, device=H.device)
    F = 1 / (s_diffs + eye) - eye
    dSS = sd * dS
    SdS = sd.T * dS
    s_zeros = (s == 0).to(s.dtype)
    s_inv = 1 / (s + s_zeros) - s_zeros
    dU = u @ (F * (dSS + dSS.T) + 0.5 * (dS - dS.T) * torch.diag(s_inv))
    dV = v @ (F * (SdS + SdS.T))
    m, n = H.shape
    if m > n:
        dAV = dH @ v
        dU = dU + (dAV - u @ (u.T @ dAV)) / sd
    if n > m:
        dAHU = dH.T @ u
        dV = dV + (dAHU - v @ (vt @ dAHU)) / sd
    return (u, s, vt), (dU, ds, dV.T)


def _lstsq_eps_jvp(H, e1, dH, de1):
    """:func:`_lstsq_eps` and its tangent, as JAX differentiates
    ``jnp.linalg.lstsq(H, e1, rcond=eps)`` followed by the reference's
    non-finite guard."""
    eps = torch.finfo(H.dtype).eps
    ok = torch.isfinite(H).all() & torch.isfinite(e1).all()
    zero = torch.zeros((), dtype=H.dtype, device=H.device)
    H, dH = torch.where(ok, H, zero), torch.where(ok, dH, zero)
    e1, de1 = torch.where(ok, e1, zero), torch.where(ok, de1, zero)
    (u, s, vt), (du, ds, dvt) = _svd_jvp(H, dH)
    keep = (s > 0) & (s >= eps * s[0])
    safe_s = torch.where(keep, s, torch.ones_like(s))
    s_inv = torch.where(keep, 1.0 / safe_s, torch.zeros_like(s))
    ds_inv = torch.where(keep, -torch.where(keep, ds, zero) / safe_s ** 2,
                         torch.zeros_like(s))
    uTb = u.T @ e1
    duTb = du.T @ e1 + u.T @ de1
    y = vt.T @ (s_inv * uTb)
    dy = dvt.T @ (s_inv * uTb) + vt.T @ (ds_inv * uTb + s_inv * duTb)
    fin = torch.isfinite(y)
    return (torch.where(fin, y, torch.zeros_like(y)),
            torch.where(fin, dy, torch.zeros_like(dy)))


def _norm_jvp(v, dv):
    n = _gnorm(v)
    return n, torch.dot(v, dv) / n


def fgmres_flat_jvp(Aop, Mop, b: torch.Tensor, db: torch.Tensor,
                    m: int = 30, tol: float = 1e-6, atol: float = 0.0,
                    restarts: int = 10):
    """:func:`fgmres_flat` from x0 = 0 together with its forward-mode
    tangent along ``db`` (flat vectors): the tangent of every Arnoldi
    quantity is carried beside it, and the iteration count is the
    primal's, as ``jax.jvp`` of the reference's loop. ``Aop`` and ``Mop``
    must be linear maps (their tangents are themselves applied to the
    tangents), so they may be CUDA-graph replays. Returns
    ``(SolveResult, dx)``; the primal is the plain solve's bitwise."""
    n = b.shape[0]
    kw = dict(dtype=b.dtype, device=b.device)
    stop = _stop(tol, _gnorm(b), atol)
    x, rn, it = torch.zeros_like(b), torch.tensor(float("inf"), **kw), 0
    dx = torch.zeros_like(b)
    rows = torch.arange(m + 1, device=b.device)
    while it < restarts and bool(rn > stop):
        r = b - Aop(x)
        dr = db - Aop(dx)
        beta, dbeta = _norm_jvp(r, dr)
        V = torch.zeros((m + 1, n), **kw)
        dV = torch.zeros((m + 1, n), **kw)
        V[0] = r / _safe(beta)
        dV[0] = torch.where(beta == 0, dr, (dr - V[0] * dbeta) / _safe(beta))
        Z = torch.zeros((m, n), **kw)
        dZ = torch.zeros((m, n), **kw)
        H = torch.zeros((m + 1, m), **kw)
        dH = torch.zeros((m + 1, m), **kw)
        for j in range(m):
            z, dz = Mop(V[j]), Mop(dV[j])
            w, dw = Aop(z), Aop(dz)
            mask = (rows <= j).to(b.dtype)
            dots = (V @ w) * mask
            ddots = (dV @ w + V @ dw) * mask
            w, dw = w - V.T @ dots, dw - dV.T @ dots - V.T @ ddots
            dots2 = (V @ w) * mask
            ddots2 = (dV @ w + V @ dw) * mask
            w, dw = w - V.T @ dots2, dw - dV.T @ dots2 - V.T @ ddots2
            wnorm, dwnorm = _norm_jvp(w, dw)
            H[:, j] = dots + dots2
            dH[:, j] = ddots + ddots2
            H[j + 1, j] = wnorm
            dH[j + 1, j] = dwnorm
            V[j + 1] = w / _safe(wnorm)
            dV[j + 1] = torch.where(wnorm == 0, dw,
                                    (dw - V[j + 1] * dwnorm) / _safe(wnorm))
            Z[j] = z
            dZ[j] = dz
        e1 = torch.zeros(m + 1, **kw)
        e1[0] = beta
        de1 = torch.zeros(m + 1, **kw)
        de1[0] = dbeta
        y, dy = _lstsq_eps_jvp(H, e1, dH, de1)
        x = x + Z.T @ y
        dx = dx + dZ.T @ y + Z.T @ dy
        rn = _gnorm(b - Aop(x))
        it += 1
    return SolveResult(x=x, iters=it, resnorm=rn, converged=rn <= stop), dx


def fgmres(A: Operator, b: Pytree, x0: Optional[Pytree] = None,
           M: Optional[Operator] = None, m: int = 30, tol: float = 1e-6,
           atol: float = 0.0, restarts: int = 10) -> SolveResult:
    """Flexible GMRES(m) over pytrees (the preconditioner may itself be
    an inner iteration); ``iters`` counts the restarts taken."""
    Aop, Mop = flat_operators(A, M, b)
    return fgmres_flat(Aop, Mop, b, x0=x0, m=m, tol=tol, atol=atol,
                       restarts=restarts)


def flat_operators(A: Operator, M: Optional[Operator], template: Pytree):
    """``A`` and ``M`` (None: the identity) as maps of flat vectors, for
    pytrees shaped like ``template``."""
    unravel = ravel(template)[1]

    def Aop(v):
        return ravel(A(unravel(v)))[0]

    if M is None:
        return Aop, lambda v: v

    def Mop(v):
        return ravel(M(unravel(v)))[0]

    return Aop, Mop


def fgmres_flat(Aop, Mop, b: Pytree, x0: Optional[Pytree] = None,
                m: int = 30, tol: float = 1e-6, atol: float = 0.0,
                restarts: int = 10) -> SolveResult:
    """:func:`fgmres` with the operator and preconditioner given as maps
    of flat vectors (see :func:`flat_operators`)."""
    bflat, unravel = ravel(b)
    x0flat = torch.zeros_like(bflat) if x0 is None else ravel(x0)[0]
    x, rn, it = _fgmres_flat(Aop, bflat, x0flat, Mop, m, tol, atol,
                             restarts)
    stop = _stop(tol, _gnorm(bflat), atol)
    return SolveResult(x=unravel(x), iters=it, resnorm=rn,
                       converged=rn <= stop)


def linearize_by_vjp(F, x: torch.Tensor, v: torch.Tensor):
    """``(F(x), J(x) v)`` for a map of flat vectors, J v as the transpose
    of the vector-Jacobian product: g(w) = J^T w is linear in w, so
    J v = d(g(w) . v)/dw. Two reverse passes of PyTorch's autograd and no
    second derivative of F. (Forward-mode dual tensors give the same
    product, but every operation that mixes a dual and a plain tensor
    costs ~0.3 ms on the host in PyTorch's zero-tangent path.)"""
    with torch.enable_grad():
        xl = x.detach().requires_grad_(True)
        y = F(xl)
        if not y.requires_grad:           # F does not depend on x
            return y, torch.zeros_like(y)
        w = torch.zeros_like(y, requires_grad=True)
        (g,) = torch.autograd.grad(y, xl, grad_outputs=w, create_graph=True,
                                   allow_unused=True)
        if g is None or not g.requires_grad:
            return y.detach(), torch.zeros_like(y)
        (jv,) = torch.autograd.grad(g, w, grad_outputs=v)
    return y.detach(), jv


class NewtonResult(NamedTuple):
    x: Pytree
    iters: int
    resnorm: torch.Tensor
    converged: torch.Tensor


def newton_krylov(F: Operator, x0: Pytree, tol: float = 1e-8,
                  atol: float = 0.0, maxiter: int = 10, inner_m: int = 20,
                  inner_restarts: int = 2, inner_tol: float = 1e-3,
                  jvp=None) -> NewtonResult:
    """Matrix-free Newton-Krylov for F(x) = 0: exact Jacobian-vector
    products (:func:`linearize_by_vjp`, or ``jvp(x, v)`` when given:
    eager, so a host read in F follows the primal), FGMRES inner solves and a
    backtracking line search that keeps the best trial (a non-finite
    trial never counts as an improvement)."""
    x, unravel = ravel(x0)

    def Fflat(v):
        return ravel(F(unravel(v)))[0]

    fnorm = _gnorm(Fflat(x))
    stop = torch.clamp(tol * torch.clamp(fnorm, min=1e-30), min=atol)
    it = 0
    while it < maxiter and bool(fnorm > stop):
        x_lin = x
        fx = Fflat(x_lin)

        def Jop(v):
            if jvp is not None:
                return ravel(jvp(unravel(x_lin), unravel(v)))[0]
            return linearize_by_vjp(Fflat, x_lin, v)[1]

        dx, _, _ = _fgmres_flat(Jop, -fx, torch.zeros_like(x),
                                lambda v: v, inner_m, inner_tol, 0.0,
                                inner_restarts)
        fn = _gnorm(Fflat(x + dx))
        one = torch.ones((), dtype=x.dtype, device=x.device)
        full_ok = torch.isfinite(fn)
        bs = torch.where(full_ok, one, one / 64.0)
        bfn = torch.where(full_ok, fn, torch.full_like(fn, float("inf")))
        s, tries = one, 0
        while tries < 6 and not bool(fn < fnorm):
            s = s * 0.5
            fn = _gnorm(Fflat(x + s * dx))
            better = fn < bfn
            bs = torch.where(better, s, bs)
            bfn = torch.where(better, fn, bfn)
            tries += 1
        x = x + bs * dx
        fnorm = bfn
        it += 1
    return NewtonResult(x=unravel(x), iters=it, resnorm=fnorm,
                        converged=fnorm <= stop)
