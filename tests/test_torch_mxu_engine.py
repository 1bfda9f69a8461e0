"""Port parity of the ``mxu`` / ``mxu_bf16`` engine
(``ibamr_tpu_torch/ops/interaction_fast.FastInteraction``) against
``ibamr_tpu``'s ``FastInteraction`` on the CPU, on the cases of
``tests/test_interaction_fast.py``: the same markers, forces and fields
(numpy seeds, f64) through both engines.

Tolerances: the port equals the reference engine within ``1e-12·max|ref|``
at f64 (the contraction sums in another order) and the scatter oracle
within the reference test's ``1e-5·scale``; spread and interp are
adjoint within the reference's 1e-5; ``mxu_bf16`` equals the reference's
bf16 engine within ``1e-5·max|ref|`` (the same bf16 operands, f32 sums in
another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.ops import interaction as jinteraction
from ibamr_tpu.ops.interaction_fast import FastInteraction as JFast
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.ops import interaction as tinteraction
from ibamr_tpu_torch.ops.interaction_fast import FastInteraction as TFast

RTOL = 1e-12
ORACLE_TOL = 1e-5
BF16_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids(n):
    box = dict(x_lo=(0.0,) * len(n), x_up=(1.0,) * len(n))
    return JGrid(n=n, **box), TGrid(n=n, **box)


def _err(ref, got):
    """max |got - ref| over max |ref|."""
    ref = np.asarray(ref)
    return float(np.max(np.abs(got.numpy() - ref))
                 / max(np.max(np.abs(ref)), 1e-300))


def _both(jeng, teng, X, F, u, w=None):
    """Spread and interp through both engines on one bucketing each;
    asserts the layouts agree slot for slot and returns the four
    results."""
    jb = jeng.buckets(jnp.asarray(X), None if w is None else jnp.asarray(w))
    tX = torch.tensor(X)
    tb = teng.buckets(tX, None if w is None else torch.tensor(w))
    ref_b = convert.buckets(jb, device="cpu")
    for name in ("Xb", "wb", "slot_of_marker", "o_idx", "o_w", "counts"):
        assert torch.equal(getattr(ref_b, name).to(torch.float64),
                           getattr(tb, name).to(torch.float64)), name
    assert (ref_b.any_overflow, ref_b.exceeded) == (tb.any_overflow,
                                                     tb.exceeded)
    jf = jeng.spread_vel(jnp.asarray(F), jnp.asarray(X), b=jb)
    tf = teng.spread_vel(torch.tensor(F), tX, b=tb)
    jU = jeng.interpolate_vel(tuple(map(jnp.asarray, u)), jnp.asarray(X),
                              b=jb)
    tU = teng.interpolate_vel(tuple(map(torch.tensor, u)), tX, b=tb)
    return jf, tf, jU, tU, tb


@pytest.mark.parametrize("dim,n", [(2, 32), (3, 16)])
@pytest.mark.parametrize("kernel", ["IB_4", "IB_3", "BSPLINE_4"])
def test_matches_reference_and_scatter_oracle(dim, n, kernel):
    rng = np.random.RandomState(1)
    X = np.random.RandomState(0).rand(300, dim)
    F = rng.randn(300, dim)
    w = (rng.rand(300) > 0.1).astype(np.float64)
    jg, tg = _grids((n,) * dim)
    u = tuple(rng.randn(*tg.n) for _ in range(dim))
    jeng = JFast(jg, kernel=kernel, tile=8, cap=128)
    teng = TFast(tg, kernel=kernel, tile=8, cap=128, device="cpu")
    jf, tf, jU, tU, _ = _both(jeng, teng, X, F, u, w)
    for a, b in zip(jf, tf):
        assert _err(a, b) < RTOL
    assert _err(jU, tU) < RTOL
    tX, tw = torch.tensor(X), torch.tensor(w)
    f_or = tinteraction.spread_vel(torch.tensor(F), tg, tX, kernel=kernel,
                                   weights=tw)
    for a, b in zip(f_or, tf):
        assert float((a - b).abs().max()) < ORACLE_TOL * (
            float(a.abs().max()) + 1e-12)
    U_or = tinteraction.interpolate_vel(tuple(map(torch.tensor, u)), tg, tX,
                                        kernel=kernel, weights=tw)
    assert float((U_or - tU).abs().max()) < ORACLE_TOL * (
        float(U_or.abs().max()) + 1e-12)


@pytest.mark.parametrize("ocap", [None, 16])
def test_overflow_fallback_exact(ocap):
    # all markers in one tile and a cap of 8: most of them overflow,
    # buffered (None) or past the buffer (16)
    rng = np.random.RandomState(2)
    X = 0.1 + 0.05 * rng.rand(200, 2)
    F = rng.randn(200, 2)
    jg, tg = _grids((32, 32))
    u = tuple(rng.randn(32, 32) for _ in range(2))
    jeng = JFast(jg, tile=8, cap=8, overflow_cap=ocap)
    teng = TFast(tg, tile=8, cap=8, overflow_cap=ocap, device="cpu")
    jf, tf, jU, tU, tb = _both(jeng, teng, X, F, u)
    assert tb.any_overflow and tb.exceeded == (ocap is not None)
    for a, b in zip(jf, tf):
        assert _err(a, b) < RTOL
    assert _err(jU, tU) < RTOL
    f_or = jinteraction.spread_vel(jnp.asarray(F), jg, jnp.asarray(X))
    for a, b in zip(f_or, tf):
        assert _err(a, b) < ORACLE_TOL
    U_or = jinteraction.interpolate_vel(tuple(map(jnp.asarray, u)), jg,
                                        jnp.asarray(X))
    assert float(np.max(np.abs(tU.numpy() - np.asarray(U_or)))) < ORACLE_TOL


def test_adjointness():
    rng = np.random.RandomState(4)
    X = torch.tensor(np.random.RandomState(3).rand(150, 3))
    F = torch.tensor(rng.randn(150, 3))
    _, tg = _grids((16, 16, 16))
    u = tuple(torch.tensor(rng.randn(16, 16, 16)) for _ in range(3))
    eng = TFast(tg, tile=8, cap=64, device="cpu")
    b = eng.buckets(X)
    f = eng.spread_vel(F, X, b=b)
    U = eng.interpolate_vel(u, X, b=b)
    lhs = sum(float(torch.sum(a * c)) for a, c in zip(f, u)) * float(
        np.prod(tg.dx))
    rhs = float(torch.sum(F * U))
    assert abs(lhs - rhs) < 1e-5 * (abs(lhs) + abs(rhs) + 1e-12)


@pytest.mark.parametrize("dim,n", [(2, 32), (3, 16)])
def test_bf16_engine_matches_reference_bf16(dim, n):
    rng = np.random.RandomState(8)
    X = np.random.RandomState(7).rand(300, dim)
    F = rng.randn(300, dim)
    jg, tg = _grids((n,) * dim)
    u = tuple(rng.randn(*tg.n) for _ in range(dim))
    jeng = JFast(jg, tile=8, cap=128, compute_dtype=jnp.bfloat16)
    teng = TFast(tg, tile=8, cap=128, compute_dtype=torch.bfloat16,
                 device="cpu")
    jf, tf, jU, tU, _ = _both(jeng, teng, X, F, u)
    for a, b in zip(jf, tf):
        assert _err(a, b) < BF16_RTOL
    assert _err(jU, tU) < BF16_RTOL
    # and within the reference suite's bf16 class of the exact engine
    exact = TFast(tg, tile=8, cap=128, device="cpu")
    fe = exact.spread_vel(torch.tensor(F), torch.tensor(X))
    for a, b in zip(fe, tf):
        assert float((a - b).abs().max()) < 2e-2 * float(a.abs().max())
