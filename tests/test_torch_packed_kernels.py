"""Port parity: the plain PyTorch versions of the two packed transfer
kernels (``ibamr_tpu_torch/ops/cuda_interaction.py``) and the engine
around them against the reference Pallas programs
(``PallasPackedInteraction``, interpret mode) on the CPU, in f32, with
the cases of ``tests/test_pallas_packed.py``. The two sides sum in
different orders: transfers agree to ``2e-6·max|ref|`` (the reference
suite's own tolerance). The CUDA kernels themselves are held against
these plain versions on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda_kernels.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.ops import pallas_interaction as jpal
from ibamr_tpu.ops.interaction import _centering_offsets
from ibamr_tpu.ops.interaction_fast import _extract_tiles as j_extract
from ibamr_tpu.ops.interaction_fast import bucketed_channel as j_channel
from ibamr_tpu.ops.interaction_packed import suggest_chunks
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.ops import cuda_interaction as ci
from ibamr_tpu_torch.ops.interaction_fast import _extract_tiles

TOL = 2e-6


def _grids(n):
    box = dict(x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    return JGrid(n=n, **box), TGrid(n=n, **box)


def _engines(n, X, chunk, nchunks=None, **kw):
    jg, tg = _grids(n)
    if nchunks is None:
        nchunks = suggest_chunks(jg, X, tile=8, chunk=chunk, slack=1.3)
    je = jpal.PallasPackedInteraction(jg, kernel="IB_4", tile=8, chunk=chunk,
                                      nchunks=nchunks, interpret=True, **kw)
    te = ci.PackedKernelInteraction(tg, kernel="IB_4", tile=8, chunk=chunk,
                                    nchunks=nchunks, device="cpu", **kw)
    return je, te


def _close(ref, got, tol=TOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def _inputs(seed, N, n):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    F = rng.standard_normal((N, 3)).astype(np.float32)
    u = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    return X, F, u


def _hot_inputs(seed, N, n):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(0.30, 0.34, N), rng.uniform(0.30, 0.34, N),
                  rng.uniform(0, 1, N)], axis=1).astype(np.float32)
    F = rng.standard_normal((N, 3)).astype(np.float32)
    return X, F


@pytest.mark.parametrize("centering", [0, 1, 2])
def test_spread_kernel_plain_matches_pallas(centering):
    n = (16, 16, 32)
    X, F, _ = _inputs(0, 300, n)
    je, te = _engines(n, X, chunk=64)
    jb = je.buckets(jnp.asarray(X))
    tb = convert.packed_buckets(jb, device="cpu")
    offs = _centering_offsets(je.grid, centering)
    coef = j_channel(jb, jnp.asarray(F[:, centering])) * jb.wb \
        / float(np.prod(je.grid.dx))
    B = int(np.prod(je.geom.nblk))
    call = jpal._packed_spread_kernel_3d(je.geom, je.grid, offs, je._phi,
                                         True)
    ref = call(jb.tile_of_chunk, jb.Xb, coef, B)
    ref = jnp.where(je._visited_mask(jb)[:, None, None], ref, 0.0)
    got = ci.packed_spread(te.geom, te.grid, offs, tb.tile_of_chunk, tb.Xb,
                           torch.tensor(np.asarray(coef)))
    _close(ref, got)


@pytest.mark.parametrize("centering", [0, 1, 2])
def test_interp_kernel_plain_matches_pallas(centering):
    n = (16, 16, 32)
    X, _, u = _inputs(1, 300, n)
    je, te = _engines(n, X, chunk=64)
    jb = je.buckets(jnp.asarray(X))
    tb = convert.packed_buckets(jb, device="cpu")
    offs = _centering_offsets(je.grid, centering)
    T = j_extract(je.geom, je.grid, jnp.asarray(u[centering]))
    Tt = _extract_tiles(te.geom, te.grid, torch.tensor(u[centering]))
    np.testing.assert_array_equal(np.asarray(T), Tt.numpy())
    call = jpal._packed_interp_kernel_3d(je.geom, je.grid, offs, je._phi,
                                         True)
    ref = np.asarray(call(jb.tile_of_chunk, jb.Xb, T))[:, 0, :]
    got = ci.packed_interp(te.geom, te.grid, offs, tb.tile_of_chunk, tb.Xb,
                           Tt)
    live = np.asarray(jb.wb) != 0     # empty slots are weighted by 0
    _close(ref * live, got * torch.tensor(live))


def test_engine_random_markers_match_pallas():
    n = (16, 16, 32)
    X, F, u = _inputs(2, 300, n)
    je, te = _engines(n, X, chunk=64)
    jb = je.buckets(jnp.asarray(X))
    tb = te.buckets(torch.tensor(X))
    for a, b in zip(je.spread_vel(jnp.asarray(F), jnp.asarray(X), b=jb),
                    te.spread_vel(torch.tensor(F), torch.tensor(X), b=tb)):
        _close(a, b)
    _close(je.interpolate_vel(tuple(map(jnp.asarray, u)), jnp.asarray(X),
                              b=jb),
           te.interpolate_vel(tuple(map(torch.tensor, u)), torch.tensor(X),
                              b=tb))


def test_hot_tile_accumulates_and_untouched_tiles_are_zero():
    n = (16, 16, 16)
    X, F = _hot_inputs(3, 150, n)
    je, te = _engines(n, X, chunk=16, nchunks=16)
    jb = je.buckets(jnp.asarray(X))
    tb = te.buckets(torch.tensor(X))
    assert not tb.any_overflow
    assert int((tb.wb > 0).any(1).sum()) >= 9
    for a, b in zip(je.spread_vel(jnp.asarray(F), jnp.asarray(X), b=jb),
                    te.spread_vel(torch.tensor(F), torch.tensor(X), b=tb)):
        _close(a, b)
    # kernel level: tiles no live chunk visits come out exactly zero
    offs = _centering_offsets(je.grid, 0)
    coef = torch.ones_like(tb.wb) * tb.wb
    T = ci.packed_spread(te.geom, te.grid, offs, tb.tile_of_chunk, tb.Xb,
                         coef)
    visited = torch.zeros(T.shape[0], dtype=torch.bool)
    visited[tb.tile_of_chunk[(tb.wb != 0).any(1)].long()] = True
    assert int(visited.sum()) == 1
    assert bool(torch.all(T[~visited] == 0))
    assert float(T[visited].abs().max()) > 0


def test_packed_spread_interp_adjointness():
    n = (16, 16, 16)
    X, F, u = _inputs(4, 120, n)
    _, te = _engines(n, X, chunk=32)
    Xt, Ft = torch.tensor(X, dtype=torch.float64), torch.tensor(F).double()
    ut = tuple(torch.tensor(c).double() for c in u)
    b = te.buckets(Xt)
    f = te.spread_vel(Ft, Xt, b=b)
    U = te.interpolate_vel(ut, Xt, b=b)
    h3 = float(np.prod(te.grid.dx))
    lhs = sum(float(torch.sum(a * c)) for a, c in zip(f, ut)) * h3
    rhs = float(torch.sum(Ft * U))
    assert abs(lhs - rhs) < 1e-12 * (abs(lhs) + abs(rhs))


def test_wrappers_refuse_other_devices():
    n = (16, 16, 16)
    _, tg = _grids(n)
    te = ci.PackedKernelInteraction(tg, chunk=16, nchunks=4, device="cpu")
    Xb = torch.zeros((4, 16, 3), device="meta")
    tid = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ci.packed_spread(te.geom, tg, (0.5,) * 3, tid, Xb,
                         torch.zeros((4, 16), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ci.packed_interp(te.geom, tg, (0.5,) * 3, tid, Xb,
                         torch.zeros((4, 169, 16), device="meta"))
