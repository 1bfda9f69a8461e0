"""Port parity of the co-partitioned marker transfers
(``ibamr_tpu_torch/parallel/lagrangian.py``) against
``ibamr_tpu/parallel/lagrangian.py`` and the reference's scatter oracle
(``ibamr_tpu/ops/interaction.py``) on the CPU at f64.

Seeded markers (some within two cells of every face, some inactive) on
16^2, 32^2, 16^3 and 32x16x16 grids over 2-, 4- and 8-shard meshes, 1D
and 2D: the owner bucketing equals the reference's slot for slot
(``Xb``, ``wb``, ``slot_of_marker``, ``o_idx``, ``o_w`` and both
overflow flags exactly), also with a capacity small enough to overflow
into the compact buffer and past it; spread and interp equal the
scatter oracle within 1e-12 of the largest value on every one of those
paths, with every per-shard body under ``spmd.audit_blocks``; spread and
interp are adjoint; the engine's refusals carry the reference's
messages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.ops import interaction as jint
from ibamr_tpu.parallel.lagrangian import ShardedInteraction as JSharded
from ibamr_tpu.parallel.mesh import make_mesh as jmake_mesh
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.parallel import spmd
from ibamr_tpu_torch.parallel.lagrangian import ShardedInteraction
from ibamr_tpu_torch.parallel.mesh import make_mesh

TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids(shape, lo=0.0, hi=1.0):
    dim = len(shape)
    return (JGrid(n=shape, x_lo=(lo,) * dim, x_up=(hi,) * dim),
            StaggeredGrid(n=shape, x_lo=(lo,) * dim, x_up=(hi,) * dim))


def _markers(shape, N, seed):
    """N markers: a fifth within two cells of a face (both sides of the
    periodic seam), a seventh inactive."""
    rng = np.random.default_rng(seed)
    dim = len(shape)
    X = rng.uniform(0.0, 1.0, (N, dim))
    k = N // 5
    h = 1.0 / min(shape)
    X[:k] = np.mod(rng.uniform(-2 * h, 2 * h, (k, dim)), 1.0)
    w = np.ones(N)
    w[::7] = 0.0
    return X, w


# (shape, shards, mesh axes, N, cap, overflow_cap): the last three
# overflow into the compact buffer, and the last past it
CASES = [((32, 32), 4, 2, 300, None, None),
         ((16, 16), 2, 1, 200, None, None),
         ((32, 16, 16), 4, 1, 300, 16, None),
         ((16, 16, 16), 8, 2, 400, 8, None),
         ((16, 16, 16), 8, 2, 400, 8, 16)]


def _engines(shape, n_shards, axes, N, cap, ocap):
    jg, g = _grids(shape)
    kw = dict(n_markers=N, cap=cap, overflow_cap=ocap)
    return (JSharded(jg, jmake_mesh(n_shards, max_axes=axes), **kw),
            ShardedInteraction(g, make_mesh(n_shards, max_axes=axes,
                                            device="cpu"), **kw), jg, g)


@pytest.mark.parametrize("shape,n_shards,axes,N,cap,ocap", CASES)
def test_buckets_match_reference_slot_for_slot(shape, n_shards, axes, N, cap,
                                               ocap):
    je, te, _, _ = _engines(shape, n_shards, axes, N, cap, ocap)
    X, w = _markers(shape, N, seed=N + n_shards)
    jb = je.buckets(jnp.asarray(X), jnp.asarray(w))
    tb = te.buckets(torch.tensor(X), torch.tensor(w))
    for f in ("Xb", "wb", "slot_of_marker", "o_idx", "o_w",
              "any_overflow", "exceeded"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert tb.overflow == (bool(jb.any_overflow), bool(jb.exceeded))
    assert [b.shape[0] for b in tb.Xl] == [te.cap] * te.P


@pytest.mark.parametrize("shape,n_shards,axes,N,cap,ocap", CASES)
def test_transfers_match_scatter_oracle(shape, n_shards, axes, N, cap, ocap):
    _, te, jg, _ = _engines(shape, n_shards, axes, N, cap, ocap)
    dim = len(shape)
    X, w = _markers(shape, N, seed=3 * N + n_shards)
    rng = np.random.default_rng(N)
    F = rng.standard_normal((N, dim))
    u = tuple(rng.standard_normal(shape) for _ in range(dim))
    Xt, wt = torch.tensor(X), torch.tensor(w)
    with spmd.audit_blocks() as audit:
        b = te.buckets(Xt, wt)
        f_eul = te.spread_vel(torch.tensor(F), Xt, b=b)
        U = te.interpolate_vel(tuple(torch.tensor(c) for c in u), Xt, b=b)
    assert audit["bodies"] > 0
    want_f = jint.spread_vel(jnp.asarray(F), jg, jnp.asarray(X),
                             weights=jnp.asarray(w))
    want_U = np.asarray(jint.interpolate_vel(
        tuple(jnp.asarray(c) for c in u), jg, jnp.asarray(X),
        weights=jnp.asarray(w)))
    for a, r in zip(f_eul, want_f):
        r = np.asarray(r)
        assert np.abs(a.numpy() - r).max() <= TOL * np.abs(r).max()
    assert np.abs(U.numpy() - want_U).max() <= TOL * np.abs(want_U).max()


def test_spread_and_interp_are_adjoint():
    _, te, _, g = _engines((16, 16, 16), 8, 2, 400, 8, None)
    X, w = _markers((16, 16, 16), 400, seed=11)
    rng = np.random.default_rng(12)
    F = torch.tensor(rng.standard_normal((400, 3)))
    u = tuple(torch.tensor(rng.standard_normal((16, 16, 16)))
              for _ in range(3))
    b = te.buckets(torch.tensor(X), torch.tensor(w))
    lhs = sum(torch.sum(a * c) for a, c in zip(te.spread_vel(
        F, torch.tensor(X), b=b), u)) * g.cell_volume
    rhs = torch.sum(F * te.interpolate_vel(u, torch.tensor(X), b=b))
    assert abs(float(lhs - rhs)) <= 1e-12 * abs(float(rhs))


def test_inactive_markers_use_no_capacity():
    """A pool of parked (weight-0) markers must not evict real ones."""
    _, te, _, _ = _engines((16, 16), 4, 2, 64, 8, None)
    X = np.full((64, 2), 0.01)
    X[:8] = np.random.default_rng(0).uniform(0.0, 0.2, (8, 2))
    w = np.zeros(64)
    w[:8] = 1.0
    b = te.buckets(torch.tensor(X), torch.tensor(w))
    assert b.overflow == (False, False)
    assert int((b.slot_of_marker[8:] == te.P * te.cap).sum()) == 56


def test_refusals_match_reference():
    for shape, n, axes in (((16, 12), 8, 1), ((8, 8), 8, 2)):
        jg, g = _grids(shape)
        with pytest.raises(ValueError) as je:
            JSharded(jg, jmake_mesh(n, max_axes=axes), n_markers=10)
        with pytest.raises(ValueError) as te:
            ShardedInteraction(g, make_mesh(n, max_axes=axes, device="cpu"),
                               n_markers=10)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="n_markers or an explicit cap"):
        ShardedInteraction(_grids((16, 16))[1], make_mesh(2, device="cpu"))
