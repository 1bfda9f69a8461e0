"""Port parity: the occupancy-packed chunk layout of ibamr_tpu_torch
against ibamr_tpu, slot for slot. Same markers (numpy seed, f64) go to
both ``pack_markers``/``refresh_packed``; every ``PackedBuckets`` field
must agree, integers and host flags exactly and floats exactly too
(they are gathered, not computed)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.ops import interaction_fast as jfast
from ibamr_tpu.ops import interaction_packed as jpk
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.ops import interaction_fast as tfast
from ibamr_tpu_torch.ops import interaction_packed as tpk


def _grids(n):
    box = dict(x_lo=(0.0,) * len(n), x_up=(1.0,) * len(n))
    return JGrid(n=n, **box), TGrid(n=n, **box)


def _assert_same(jb, tb):
    ref = convert.packed_buckets(jb, device="cpu")
    for name in tb._fields:
        a, b = getattr(ref, name), getattr(tb, name)
        if isinstance(a, bool):
            assert a == b, name
            continue
        if isinstance(a, tuple):
            assert len(a) == len(b), name
            pairs = zip(a, b)
        else:
            pairs = [(a, b)]
        for x, y in pairs:
            assert x.shape == y.shape, name
            if x.dtype.is_floating_point:
                assert torch.equal(x, y.to(x.dtype)), name
            else:
                assert torch.equal(x.to(torch.int64), y.to(torch.int64)), \
                    name


def _random(N, dim, seed):
    return np.random.default_rng(seed).uniform(-0.05, 1.05, (N, dim))


def _hot(N, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.30, 0.34, N), rng.uniform(0.30, 0.34, N),
                     rng.uniform(0, 1, N)], axis=1)


# (name, n, X, chunk, nchunks, overflow_cap, weights-mask?, expect)
CASES = {
    "random": ((16, 16, 32), _random(300, 3, 0), 32, None, None, False),
    "random_2d": ((32, 16), _random(200, 2, 1), 16, None, None, False),
    "masked": ((16, 16, 16), _random(180, 3, 2), 32, None, None, True),
    "hot_tile": ((16, 16, 16), _hot(150, 3), 16, 16, None, False),
    "overflow": ((16, 16, 16), _random(250, 3, 4), 16, 4, None, False),
    "exceeded": ((16, 16, 16), _random(250, 3, 5), 16, 4, 8, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_markers_matches_reference(case):
    n, X, chunk, Q, ocap, masked = CASES[case]
    jg, tg = _grids(n)
    if Q is None:
        Q = jpk.suggest_chunks(jg, X, tile=8, chunk=chunk)
        assert tpk.suggest_chunks(tg, torch.tensor(X), tile=8,
                                  chunk=chunk) == Q
    w = None
    if masked:
        w = (np.random.default_rng(9).uniform(size=len(X)) > 0.3) * 1.0
    jgeom = jfast.make_geometry(jg, "IB_4", tile=8, cap=chunk)
    tgeom = tfast.make_geometry(tg, "IB_4", tile=8, cap=chunk)
    assert tuple(jgeom) == tuple(tgeom)
    jb = jpk.pack_markers(jgeom, jg, jnp.asarray(X),
                          None if w is None else jnp.asarray(w),
                          nchunks=Q, overflow_cap=ocap)
    tb = tpk.pack_markers(tgeom, tg, torch.tensor(X),
                          None if w is None else torch.tensor(w),
                          nchunks=Q, overflow_cap=ocap)
    _assert_same(jb, tb)
    tid = tb.tile_of_chunk
    assert bool(torch.all(tid[1:] >= tid[:-1]))
    if case == "hot_tile":
        assert not tb.any_overflow
        assert int((tb.wb > 0).any(1).sum()) >= 9
    if case == "overflow":
        assert tb.any_overflow and not tb.exceeded
    if case == "exceeded":
        assert tb.any_overflow and tb.exceeded


@pytest.mark.parametrize("drift,want_hit", [(-0.4, True), (0.3, True),
                                            (2.5, False)])
def test_refresh_packed_matches_reference(drift, want_hit):
    n = (16, 16, 16)
    jg, tg = _grids(n)
    X = _random(150, 3, 6)
    Q = jpk.suggest_chunks(jg, X, tile=8, chunk=32)
    jgeom = jfast.make_geometry(jg, "IB_4", tile=8, cap=32)
    tgeom = tfast.make_geometry(tg, "IB_4", tile=8, cap=32)
    jb = jpk.pack_markers(jgeom, jg, jnp.asarray(X), nchunks=Q)
    tb = tpk.pack_markers(tgeom, tg, torch.tensor(X), nchunks=Q)
    Xd = X + drift * jg.dx[0]
    jb2, jhit = jpk.refresh_packed(jgeom, jg, jb, jnp.asarray(Xd))
    tb2, thit = tpk.refresh_packed(tgeom, tg, tb, torch.tensor(Xd))
    assert bool(jhit) == thit == want_hit
    _assert_same(jb2, tb2)


def test_compact_overflow_static_size_nonzero():
    # the cumsum/searchsorted compaction gives jnp.nonzero(size=, fill=N)
    rng = np.random.default_rng(7)
    N, ocap = 40, 12
    order = rng.permutation(N)
    keep = rng.uniform(size=N) > 0.25
    slot = np.where(keep, np.arange(N), 99)
    w = rng.uniform(size=N)
    ref = jfast.compact_overflow(jnp.asarray(order), jnp.asarray(keep),
                                 jnp.asarray(slot), jnp.asarray(w), N, ocap)
    got = tfast.compact_overflow(torch.tensor(order), torch.tensor(keep),
                                 torch.tensor(slot), torch.tensor(w), N,
                                 ocap)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("case", ["random_2d", "overflow_2d"])
def test_packed_2d_transfers_match_reference(case):
    """The 2D ``packed`` engine against the reference's: the layouts slot
    for slot, spread and interp within 1e-12·max|ref| at f64 (other sum
    orders)."""
    from ibamr_tpu.ops.interaction_packed import PackedInteraction as JP

    n = (32, 16)
    rng = np.random.default_rng(11)
    X = _random(200, 2, 1)
    F = rng.standard_normal((200, 2))
    u = tuple(rng.standard_normal(n) for _ in range(2))
    Q = 4 if case == "overflow_2d" else None
    jg, tg = _grids(n)
    if Q is None:
        Q = jpk.suggest_chunks(jg, X, tile=8, chunk=16)
    jeng = JP(jg, tile=8, chunk=16, nchunks=Q)
    teng = tpk.PackedInteraction(tg, tile=8, chunk=16, nchunks=Q,
                                 device="cpu")
    jb, tb = jeng.buckets(jnp.asarray(X)), teng.buckets(torch.tensor(X))
    _assert_same(jb, tb)
    assert tb.any_overflow == (case == "overflow_2d")
    jf = jeng.spread_vel(jnp.asarray(F), jnp.asarray(X), b=jb)
    tf = teng.spread_vel(torch.tensor(F), torch.tensor(X), b=tb)
    jU = jeng.interpolate_vel(tuple(map(jnp.asarray, u)), jnp.asarray(X),
                              b=jb)
    tU = teng.interpolate_vel(tuple(map(torch.tensor, u)), torch.tensor(X),
                              b=tb)
    for ref, got in list(zip(jf, tf)) + [(jU, tU)]:
        ref = np.asarray(ref)
        assert np.max(np.abs(got.numpy() - ref)) < 1e-12 * np.max(
            np.abs(ref))
