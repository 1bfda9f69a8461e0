"""Port parity of ``solvers/krylov.py`` and ``ops/norms.py``: CG,
BiCGStab, FGMRES and Newton-Krylov on seeded SPD and nonsymmetric
operators over pytrees, against ibamr_tpu at f64 on the CPU: the same
iteration (restart) counts and solutions within 1e-10 relative. The zero
right-hand side pins the least-squares step's handling of an all-zero
Hessenberg matrix (no NaN reaches the iterate)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.ops import norms as jnorms
from ibamr_tpu.solvers import krylov as jk
from ibamr_tpu_torch.ops import norms as tnorms
from ibamr_tpu_torch.solvers import krylov as tk

N1, N2 = 30, 24          # a pytree of two leaves: (N1,) and (4, 6)


def _ops(seed, spd, cond=50.0):
    rng = np.random.default_rng(seed)
    n = N1 + N2
    if spd:
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A = Q @ np.diag(np.linspace(1.0, cond, n)) @ Q.T
    else:
        A = np.eye(n) * 4.0 + rng.standard_normal((n, n)) / np.sqrt(n)
    Minv = np.diag(1.0 / np.diag(A))
    b = (rng.standard_normal(N1), rng.standard_normal((4, 6)))

    def make(lib, asarr):
        Am, Mm = asarr(A), asarr(Minv)

        def flat(x):
            return lib.concatenate([x[0].reshape(-1), x[1].reshape(-1)]) \
                if lib is jnp else torch.cat([x[0].reshape(-1),
                                              x[1].reshape(-1)])

        def tree(v):
            return (v[:N1], v[N1:].reshape(4, 6))

        return (lambda x: tree(Am @ flat(x)), lambda x: tree(Mm @ flat(x)),
                tuple(asarr(c) for c in b))

    return make(jnp, jnp.asarray), make(torch, torch.tensor)


def _close_tree(ref, got, rtol=1e-10):
    ref = np.concatenate([np.asarray(c).ravel() for c in ref])
    got = np.concatenate([c.numpy().ravel() for c in got])
    assert np.max(np.abs(got - ref)) <= rtol * np.max(np.abs(ref))


@pytest.mark.parametrize("solver,spd,cond", [
    ("cg", True, 50.0), ("bicgstab", False, None), ("bicgstab", True, 5.0),
    ("fgmres", False, None), ("fgmres", True, 50.0)])
@pytest.mark.parametrize("precond", [False, True])
def test_solvers_match_reference(solver, spd, cond, precond):
    """BiCGStab's SPD case is well conditioned: at condition 50 its
    recurrence wanders near the roundoff floor and the iteration count
    then depends on the last bit of a dot product."""
    (jA, jM, jb), (tA, tM, tb) = _ops(3 + spd, spd, cond)
    kw = dict(tol=1e-11)
    if solver == "fgmres":
        kw.update(m=8, restarts=40)
    ref = getattr(jk, solver)(jA, jb, M=jM if precond else None, **kw)
    got = getattr(tk, solver)(tA, tb, M=tM if precond else None, **kw)
    assert int(got.iters) == int(ref.iters) > 1
    assert bool(got.converged) and bool(ref.converged)
    _close_tree(ref.x, got.x)
    assert abs(float(got.resnorm) - float(ref.resnorm)) \
        <= 1e-3 * float(ref.resnorm) + 1e-14


def test_fgmres_unconverged_and_warm_start_match_reference():
    (jA, jM, jb), (tA, tM, tb) = _ops(5, False)
    x0 = (np.full(N1, 0.1), np.full((4, 6), -0.2))
    ref = jk.fgmres(jA, jb, x0=tuple(map(jnp.asarray, x0)), m=3,
                    restarts=2, tol=1e-12)
    got = tk.fgmres(tA, tb, x0=tuple(map(torch.tensor, x0)), m=3,
                    restarts=2, tol=1e-12)
    assert got.iters == int(ref.iters) == 2
    assert not bool(got.converged) and not bool(ref.converged)
    _close_tree(ref.x, got.x)


@pytest.mark.parametrize("solver", ["cg", "bicgstab", "fgmres"])
def test_zero_rhs(solver):
    """b = 0: the solution stays exactly 0. For FGMRES the restart
    residual is 0, the Hessenberg matrix all zero, and the least-squares
    step drops every direction instead of producing NaN."""
    (jA, _, jb), (tA, _, tb) = _ops(6, True)
    jz = tuple(jnp.zeros_like(c) for c in jb)
    tz = tuple(torch.zeros_like(c) for c in tb)
    ref = getattr(jk, solver)(jA, jz, tol=1e-8)
    got = getattr(tk, solver)(tA, tz, tol=1e-8)
    assert got.iters == int(ref.iters)
    assert all(torch.equal(c, torch.zeros_like(c)) for c in got.x)
    assert all(np.all(np.asarray(c) == 0) for c in ref.x)
    assert float(got.resnorm) == 0.0 and bool(got.converged)


def test_lstsq_step_matches_reference_cutoff():
    rng = np.random.default_rng(7)
    H = np.triu(rng.standard_normal((6, 5)), -1)
    H[:, 3] = 1e-20 * H[:, 3]       # a column below the eps cutoff
    e1 = np.zeros(6)
    e1[0] = 2.0
    ref, *_ = jnp.linalg.lstsq(jnp.asarray(H), jnp.asarray(e1),
                               rcond=float(np.finfo(np.float64).eps))
    got = tk._lstsq_eps(torch.tensor(H), torch.tensor(e1))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12 * np.max(np.abs(np.asarray(ref))))
    H[2, 1] = np.nan
    ref, *_ = jnp.linalg.lstsq(jnp.asarray(H), jnp.asarray(e1),
                               rcond=float(np.finfo(np.float64).eps))
    ref = np.where(np.isfinite(ref), ref, 0.0)
    got = tk._lstsq_eps(torch.tensor(H), torch.tensor(e1))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_newton_krylov_matches_reference():
    rng = np.random.default_rng(8)
    A = np.eye(12) * 3.0 + rng.standard_normal((12, 12)) / 4.0
    c = rng.standard_normal(12)

    def F(lib, asarr):
        Am, cm = asarr(A), asarr(c)
        return lambda x: (Am @ x[0] + 0.3 * x[0] ** 3 - cm,
                          x[1] ** 2 - 4.0)

    x0 = (np.zeros(12), np.ones(3))
    ref = jk.newton_krylov(F(jnp, jnp.asarray), tuple(map(jnp.asarray, x0)),
                           tol=1e-12)
    got = tk.newton_krylov(F(torch, torch.tensor),
                           tuple(map(torch.tensor, x0)), tol=1e-12)
    assert got.iters == int(ref.iters) and bool(got.converged)
    _close_tree(ref.x, got.x)
    np.testing.assert_allclose(got.x[1].numpy(), 2.0, rtol=1e-10)


def test_norms_match_reference():
    rng = np.random.default_rng(9)
    u = [rng.standard_normal((6, 5)) for _ in range(2)]
    v = [rng.standard_normal((6, 5)) for _ in range(2)]
    ju, jv = tuple(map(jnp.asarray, u)), tuple(map(jnp.asarray, v))
    tu, tv = tuple(map(torch.tensor, u)), tuple(map(torch.tensor, v))

    def close(a, b):
        assert abs(float(a) - float(b)) <= 1e-13 * max(abs(float(a)), 1.0)

    close(jnorms.l1_norm(ju[0], 0.5), tnorms.l1_norm(tu[0], 0.5))
    close(jnorms.l2_norm(ju[0], 0.5), tnorms.l2_norm(tu[0], 0.5))
    close(jnorms.max_norm(ju[0]), tnorms.max_norm(tu[0]))
    close(jnorms.vel_l2_norm(ju, 0.5), tnorms.vel_l2_norm(tu, 0.5))
    close(jnorms.vel_max_norm(ju), tnorms.vel_max_norm(tu))
    close(jnorms.dot(ju, jv, 0.5), tnorms.dot(tu, tv, 0.5))
    ref = jnorms.tree_dots([(ju, jv), (ju, ju), (jv, jv)])
    got = tnorms.tree_dots([(tu, tv), (tu, tu), (tv, tv)])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13)
    assert float(got[1]) == float(tnorms.tree_dot(tu, tu)) or \
        abs(float(got[1]) - float(tnorms.tree_dot(tu, tu))) < 1e-12
    assert tnorms.tree_dots([]).shape == (0,)
