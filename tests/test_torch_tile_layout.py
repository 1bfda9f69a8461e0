"""Port parity: the per-tile marker layout (``Buckets``, the layout of the
``pallas`` transfer engine) of ibamr_tpu_torch against ibamr_tpu, slot
for slot. Same markers (numpy seed, f64) go to both ``bucket_markers``;
every field must agree exactly, integers, host flags and floats alike
(the floats are gathered, not computed), and so must ``suggest_cap``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.ops import interaction_fast as jfast
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.ops import interaction_fast as tfast


def _grids(n):
    box = dict(x_lo=(0.0,) * len(n), x_up=(1.0,) * len(n))
    return JGrid(n=n, **box), TGrid(n=n, **box)


def _assert_same(jb, tb):
    ref = convert.buckets(jb, device="cpu")
    assert type(tb) is tfast.Buckets
    for name in tb._fields:
        a, b = getattr(ref, name), getattr(tb, name)
        if isinstance(a, bool):
            assert a == b, name
            continue
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        if isinstance(a, tuple):
            assert len(a) == len(b), name
        for x, y in pairs:
            assert x.shape == y.shape, name
            if x.dtype.is_floating_point:
                assert y.dtype == x.dtype and torch.equal(x, y), name
            else:
                assert torch.equal(x.to(torch.int64), y.to(torch.int64)), \
                    name


def _random(N, dim, seed):
    return np.random.default_rng(seed).uniform(-0.05, 1.05, (N, dim))


def _hot(N, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.30, 0.34, N), rng.uniform(0.30, 0.34, N),
                     rng.uniform(0, 1, N)], axis=1)


# (n, X, cap, overflow_cap, weights-mask?)
CASES = {
    "random": ((16, 16, 32), _random(300, 3, 0), 128, None, False),
    "random_2d": ((32, 16), _random(200, 2, 1), 32, None, False),
    "masked": ((16, 16, 16), _random(180, 3, 2), 64, None, True),
    "hot_tile_overflow": ((16, 16, 16), _hot(150, 3), 16, None, False),
    "exceeded": ((16, 16, 16), _hot(250, 5), 16, 8, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bucket_markers_matches_reference(case):
    n, X, cap, ocap, masked = CASES[case]
    jg, tg = _grids(n)
    w = None
    if masked:
        w = (np.random.default_rng(9).uniform(size=len(X)) > 0.3) * 1.0
    jgeom = jfast.make_geometry(jg, "IB_4", tile=8, cap=cap)
    tgeom = tfast.make_geometry(tg, "IB_4", tile=8, cap=cap)
    jb = jfast.bucket_markers(jgeom, jg, jnp.asarray(X),
                              None if w is None else jnp.asarray(w),
                              overflow_cap=ocap)
    tb = tfast.bucket_markers(tgeom, tg, torch.tensor(X),
                              None if w is None else torch.tensor(w),
                              overflow_cap=ocap)
    _assert_same(jb, tb)
    # empty slots read the zero pad row: X = 0 and weight 0
    empty = torch.ones_like(tb.wb, dtype=torch.bool)
    live = tb.slot_of_marker[tb.slot_of_marker < tb.wb.numel()].long()
    empty.view(-1)[live] = False
    assert bool(torch.all(tb.Xb[empty] == 0)) and \
        bool(torch.all(tb.wb[empty] == 0))
    if case == "hot_tile_overflow":
        assert tb.any_overflow and not tb.exceeded
    if case == "exceeded":
        assert tb.any_overflow and tb.exceeded
    if case in ("random", "masked"):
        assert not tb.any_overflow


@pytest.mark.parametrize("slack", [1.2, 1.5])
def test_suggest_cap_matches_reference(slack):
    jg, tg = _grids((32, 32, 16))
    X = np.concatenate([_random(400, 3, 11), _hot(90, 12)])
    ref = jfast.suggest_cap(jg, X, tile=8, slack=slack)
    assert tfast.suggest_cap(tg, torch.tensor(X), tile=8,
                             slack=slack) == ref
    assert tfast.suggest_cap(tg, X, tile=8, slack=slack) == ref
    assert ref % 8 == 0
