"""Port parity of the fully blocked ``packed3`` / ``packed3_bf16`` engine
(``ibamr_tpu_torch/ops/interaction_packed3.py``) against ``ibamr_tpu``'s
``PackedInteraction3`` on the CPU, on the cases of
``tests/test_interaction_packed3.py`` (2D and 3D, unequal tiles per axis,
the hot tile, chunk-capacity overflow, adjointness, bf16). The same
markers, forces and fields (numpy seeds, f64) go through both engines.

Tolerances: every layout field equals the reference's slot for slot
(integers, flags and gathered floats exactly); spread and interp equal
the reference engine within ``1e-12·max|ref|`` at f64 (other sum orders)
and the scatter oracle within the reference test's ``1e-5·scale``;
adjoint within 1e-5; the bf16 engine is within the reference's 2e-2 of
the f32 one at f32 and, on f64 inputs, within ``1e-5·max|ref|`` of the
reference's bf16 engine (the same bf16 operands, f32 sums in another
order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.ops import interaction_packed3 as jp3
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.ops import interaction as tinteraction
from ibamr_tpu_torch.ops import interaction_packed3 as tp3

RTOL = 1e-12
ORACLE_TOL = 1e-5
BF16_TOL, BF16_RTOL = 2e-2, 1e-5


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
    ref = np.asarray(ref)
    return float(np.max(np.abs(got.numpy() - ref))
                 / max(np.max(np.abs(ref)), 1e-300))


def _assert_same_layout(jb, tb):
    ref = convert.packed_buckets3(jb, device="cpu")
    for name in tb._fields:
        a, b = getattr(ref, name), getattr(tb, name)
        if isinstance(a, bool):
            assert a == b, name
            continue
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert x.shape == y.shape, name
            assert torch.equal(x.to(torch.float64), y.to(torch.float64)), \
                name


def _engines(n, X, kernel="IB_4", tile_last=8, chunk=16, nchunks=None,
             **kw):
    jg, tg = _grids(n)
    if nchunks is None:
        nchunks = jp3.suggest_chunks3(jg, X, kernel=kernel, tile=8,
                                      tile_last=tile_last, chunk=chunk)
        assert tp3.suggest_chunks3(tg, torch.tensor(X), kernel=kernel,
                                   tile=8, tile_last=tile_last,
                                   chunk=chunk) == nchunks
    jeng = jp3.PackedInteraction3(jg, kernel=kernel, tile=8,
                                  tile_last=tile_last, chunk=chunk,
                                  nchunks=nchunks, **kw)
    tkw = dict(kw)
    if "compute_dtype" in tkw:
        tkw["compute_dtype"] = torch.bfloat16
    teng = tp3.PackedInteraction3(tg, kernel=kernel, tile=8,
                                  tile_last=tile_last, chunk=chunk,
                                  nchunks=nchunks, device="cpu", **tkw)
    assert tuple(jeng.geom) == tuple(teng.geom)
    return jg, tg, jeng, teng


def _run(jeng, teng, X, F, u, w=None, rtol=RTOL):
    """Both engines on one packing each: the layouts slot for slot, then
    spread and interp within ``rtol`` of the reference's; returns the
    port's spread, interp and layout."""
    jb = jeng.buckets(jnp.asarray(X), None if w is None else jnp.asarray(w))
    tX = torch.tensor(X)
    tb = teng.buckets(tX, None if w is None else torch.tensor(w))
    _assert_same_layout(jb, tb)
    jf = jeng.spread_vel(jnp.asarray(F), jnp.asarray(X), b=jb)
    tf = teng.spread_vel(torch.tensor(F), tX, b=tb)
    for a, b in zip(jf, tf):
        assert _err(a, b) < rtol
    jU = jeng.interpolate_vel(tuple(map(jnp.asarray, u)), jnp.asarray(X),
                              b=jb)
    tU = teng.interpolate_vel(tuple(map(torch.tensor, u)), tX, b=tb)
    assert _err(jU, tU) < rtol
    return tf, tU, tb


def _against_oracle(tg, X, F, u, tf, tU, kernel="IB_4", w=None):
    tX = torch.tensor(X)
    tw = None if w is None else torch.tensor(w)
    f_or = tinteraction.spread_vel(torch.tensor(F), tg, tX, kernel=kernel,
                                   weights=tw)
    for a, b in zip(f_or, tf):
        assert float((a - b).abs().max()) < ORACLE_TOL * (
            float(a.abs().max()) + 1e-12)
    U_or = tinteraction.interpolate_vel(tuple(map(torch.tensor, u)), tg, tX,
                                        kernel=kernel, weights=tw)
    assert float((U_or - tU).abs().max()) < ORACLE_TOL * (
        float(U_or.abs().max()) + 1e-12)


@pytest.mark.parametrize("dim,n,kernel", [
    (2, 32, "IB_4"), (2, 32, "IB_3"), (2, 32, "IB_6"),
    (3, 24, "IB_4"), (3, 32, "IB_6"),
])
def test_matches_reference_and_scatter_oracle(dim, n, kernel):
    rng = np.random.RandomState(1)
    X = np.random.RandomState(0).rand(300, dim)
    F = rng.randn(300, dim)
    w = (rng.rand(300) > 0.1).astype(np.float64)
    jg, tg, jeng, teng = _engines((n,) * dim, X, kernel)
    u = tuple(rng.randn(*tg.n) for _ in range(dim))
    tf, tU, _ = _run(jeng, teng, X, F, u, w)
    _against_oracle(tg, X, F, u, tf, tU, kernel, w)


def test_unequal_tiles_per_axis():
    rng = np.random.RandomState(6)
    X = np.random.RandomState(5).rand(400, 3)
    F = rng.randn(400, 3)
    jg, tg, jeng, teng = _engines((24, 24, 32), X, tile_last=16, chunk=32)
    assert teng.geom.tile == (8, 8, 16)
    u = tuple(rng.randn(*tg.n) for _ in range(3))
    tf, tU, _ = _run(jeng, teng, X, F, u)
    _against_oracle(tg, X, F, u, tf, tU)


def test_hot_tile_takes_many_chunks_no_overflow():
    rng = np.random.RandomState(2)
    X = 0.1 + 0.05 * rng.rand(200, 2)
    F = rng.randn(200, 2)
    jg, tg, jeng, teng = _engines((32, 32), X, nchunks=32)
    u = tuple(rng.randn(32, 32) for _ in range(2))
    tf, tU, tb = _run(jeng, teng, X, F, u)
    assert not tb.any_overflow
    used = (tb.wb > 0).sum(1)
    assert int(used.sum()) == 200 and int((used > 0).sum()) == 13
    _against_oracle(tg, X, F, u, tf, tU)


@pytest.mark.parametrize("ocap", [None, 64])
def test_chunk_capacity_overflow_exact(ocap):
    rng = np.random.RandomState(3)
    X = rng.rand(400, 2)
    F = rng.randn(400, 2)
    jg, tg, jeng, teng = _engines((32, 32), X, chunk=8, nchunks=6,
                                  overflow_cap=ocap)
    u = tuple(rng.randn(32, 32) for _ in range(2))
    tf, tU, tb = _run(jeng, teng, X, F, u)
    assert tb.any_overflow and tb.exceeded == (ocap is not None)
    _against_oracle(tg, X, F, u, tf, tU)


def test_adjointness():
    rng = np.random.RandomState(4)
    X = torch.tensor(np.random.RandomState(3).rand(150, 3))
    F = torch.tensor(rng.randn(150, 3))
    _, tg = _grids((16, 16, 16))
    u = tuple(torch.tensor(rng.randn(16, 16, 16)) for _ in range(3))
    eng = tp3.PackedInteraction3(tg, tile=8, tile_last=8, chunk=32,
                                 nchunks=24, device="cpu")
    b = eng.buckets(X)
    f = eng.spread_vel(F, X, b=b)
    U = eng.interpolate_vel(u, X, b=b)
    lhs = sum(float(torch.sum(a * c)) for a, c in zip(f, u)) * float(
        np.prod(tg.dx))
    rhs = float(torch.sum(F * U))
    assert abs(lhs - rhs) < 1e-5 * (abs(lhs) + abs(rhs) + 1e-12)


def test_bf16_matches_reference_and_f32_within_tolerance():
    rng = np.random.RandomState(8)
    X = np.random.RandomState(7).rand(300, 3)
    F = rng.randn(300, 3)
    jg, tg, jeng, teng = _engines((24, 24, 32), X, tile_last=16, chunk=32,
                                  compute_dtype=jnp.bfloat16)
    u = tuple(rng.randn(24, 24, 32) for _ in range(3))
    # against the reference's bf16 engine on f64 inputs (at f32 inputs the
    # two packages' weights differ in their last bits, which moves a few
    # bf16 roundings by one unit)
    _run(jeng, teng, X, F, u, rtol=BF16_RTOL)
    # the reference test's case: f32 inputs, bf16 within 2e-2 of exact
    exact = tp3.PackedInteraction3(tg, tile=8, tile_last=16, chunk=32,
                                   nchunks=teng.nchunks, device="cpu")
    tX, tF = torch.tensor(X, dtype=torch.float32), torch.tensor(
        F, dtype=torch.float32)
    tu = tuple(torch.tensor(c, dtype=torch.float32) for c in u)
    for a, b in zip(exact.spread_vel(tF, tX), teng.spread_vel(tF, tX)):
        assert float((a - b).abs().max()) < BF16_TOL * (
            float(a.abs().max()) + 1e-12)
    U, Ub = exact.interpolate_vel(tu, tX), teng.interpolate_vel(tu, tX)
    assert float((U - Ub).abs().max()) < BF16_TOL * (
        float(U.abs().max()) + 1e-12)
