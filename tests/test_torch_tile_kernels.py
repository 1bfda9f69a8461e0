"""Port parity: the plain PyTorch versions of the two tile transfer
kernels (``ibamr_tpu_torch/ops/cuda_interaction.py``: ``tile_spread``,
``tile_interp``) and the ``pallas`` engine around them
(``TileKernelInteraction``) against the reference Pallas programs
(``_spread_kernel_3d``, ``_interp_kernel_3d``, ``PallasInteraction``, in
interpret mode) on the CPU, in f32, with the cases of
``tests/test_pallas_interaction.py``. The two sides sum in different
orders: transfers agree to ``2e-6·max|ref|`` (the reference suite's own
tolerance). The CUDA kernels themselves are held against these plain
versions on the card by ``chip_smoke.py`` and by
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
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.ops import cuda_interaction as ci
from ibamr_tpu_torch.ops import interaction as tinteraction
from ibamr_tpu_torch.ops.interaction_fast import _extract_tiles

TOL = 2e-6


def _grids(n):
    box = dict(x_lo=(0.0,) * len(n), x_up=(1.0,) * len(n))
    return JGrid(n=n, **box), TGrid(n=n, **box)


def _engines(n, cap, **kw):
    jg, tg = _grids(n)
    je = jpal.PallasInteraction(jg, kernel="IB_4", tile=8, cap=cap,
                                interpret=True, **kw)
    te = ci.TileKernelInteraction(tg, kernel="IB_4", tile=8, cap=cap,
                                  device="cpu", **kw)
    return je, te


def _close(ref, got, tol=TOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def _inputs(seed, N=300, n=(16, 16, 32)):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    F = rng.standard_normal((N, 3)).astype(np.float32)
    u = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    return X, F, u


@pytest.mark.parametrize("centering", [0, 1, 2])
def test_tile_spread_plain_matches_pallas(centering):
    n = (16, 16, 32)
    X, F, _ = _inputs(0, n=n)
    je, te = _engines(n, cap=128)
    jb = je.buckets(jnp.asarray(X))
    tb = convert.buckets(jb)
    offs = _centering_offsets(je.grid, centering)
    coef = j_channel(jb, jnp.asarray(F[:, centering])) * jb.wb \
        / float(np.prod(je.grid.dx))
    ref = jpal._spread_kernel_3d(je.geom, je.grid, offs, je._phi,
                                 True)(jb.Xb, coef)
    got = ci.tile_spread(te.geom, te.grid, offs, tb.Xb,
                         torch.tensor(np.asarray(coef)))
    _close(ref, got)
    # a tile whose coefs are all zero comes out exactly zero
    zero = torch.tensor(np.asarray(coef)).clone()
    zero[0] = 0
    got = ci.tile_spread(te.geom, te.grid, offs, tb.Xb, zero)
    assert bool(torch.all(got[0] == 0)) and float(got[1:].abs().max()) > 0


@pytest.mark.parametrize("centering", [0, 1, 2])
def test_tile_interp_plain_matches_pallas(centering):
    n = (16, 16, 32)
    X, _, u = _inputs(1, n=n)
    je, te = _engines(n, cap=128)
    jb = je.buckets(jnp.asarray(X))
    tb = convert.buckets(jb)
    offs = _centering_offsets(je.grid, centering)
    T = j_extract(je.geom, je.grid, jnp.asarray(u[centering]))
    Tt = _extract_tiles(te.geom, te.grid, torch.tensor(u[centering]))
    np.testing.assert_array_equal(np.asarray(T), Tt.numpy())
    ref = np.asarray(jpal._interp_kernel_3d(je.geom, je.grid, offs, je._phi,
                                            True)(jb.Xb, T))[:, 0, :]
    got = ci.tile_interp(te.geom, te.grid, offs, tb.Xb, Tt)
    assert bool(torch.isfinite(got).all())   # empty slots too (X = 0)
    live = np.asarray(jb.wb) != 0     # empty slots are weighted by 0
    _close(ref * live, got * torch.tensor(live))


def test_tile_engine_spread_matches_pallas():
    X, F, _ = _inputs(0)
    je, te = _engines((16, 16, 32), cap=64)
    jb, tb = je.buckets(jnp.asarray(X)), te.buckets(torch.tensor(X))
    for a, b in zip(je.spread_vel(jnp.asarray(F), jnp.asarray(X), b=jb),
                    te.spread_vel(torch.tensor(F), torch.tensor(X), b=tb)):
        _close(a, b)


def test_tile_engine_cell_centering_matches_pallas():
    X, F, _ = _inputs(1)
    je, te = _engines((16, 16, 32), cap=64)
    jb, tb = je.buckets(jnp.asarray(X)), te.buckets(torch.tensor(X))
    _close(je._spread.spread(jnp.asarray(F[:, 0]), jnp.asarray(X), "cell",
                             jb),
           te.spread(torch.tensor(F[:, 0]), torch.tensor(X), "cell", tb))


def test_tile_engine_spread_overflow_matches_pallas():
    rng = np.random.default_rng(2)
    N = 200
    X = np.stack([rng.uniform(0.0, 0.05, N), rng.uniform(0.0, 0.05, N),
                  rng.uniform(0, 1, N)], axis=1).astype(np.float32)
    F = rng.standard_normal((N, 3)).astype(np.float32)
    je, te = _engines((16, 16, 16), cap=16)
    jb, tb = je.buckets(jnp.asarray(X)), te.buckets(torch.tensor(X))
    assert tb.any_overflow and not tb.exceeded
    for a, b in zip(je.spread_vel(jnp.asarray(F), jnp.asarray(X), b=jb),
                    te.spread_vel(torch.tensor(F), torch.tensor(X), b=tb)):
        _close(a, b)
    # the exceeded buffer takes the full scatter, still exact
    _, te8 = _engines((16, 16, 16), cap=16, overflow_cap=8)
    tb8 = te8.buckets(torch.tensor(X))
    assert tb8.exceeded
    ref = tinteraction.spread_vel(torch.tensor(F), te8.grid, torch.tensor(X))
    for a, b in zip(ref, te8.spread_vel(torch.tensor(F), torch.tensor(X),
                                        b=tb8)):
        _close(a, b)


def test_tile_engine_total_force_conserved():
    X, F, _ = _inputs(3)
    _, te = _engines((16, 16, 32), cap=64)
    f = te.spread_vel(torch.tensor(F), torch.tensor(X))
    for d in range(3):
        np.testing.assert_allclose(float(torch.sum(f[d])) *
                                   te.grid.cell_volume,
                                   float(np.sum(F[:, d])), rtol=1e-5)


def test_tile_engine_rejects_2d():
    _, tg = _grids((16, 16))
    with pytest.raises(ValueError, match="3D-only"):
        ci.TileKernelInteraction(tg, device="cpu")


def test_tile_engine_interp_matches_pallas():
    rng = np.random.default_rng(3)
    n = (16, 16, 32)
    X = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    u = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    je, te = _engines(n, cap=64)
    _close(je.interpolate_vel(tuple(map(jnp.asarray, u)), jnp.asarray(X)),
           te.interpolate_vel(tuple(map(torch.tensor, u)), torch.tensor(X)))


def test_tile_engine_interp_overflow_and_mask_match_pallas():
    rng = np.random.default_rng(4)
    n = (16, 16, 16)
    X = (0.2 + 0.05 * rng.uniform(0, 1, (64, 3))).astype(np.float32)
    u = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    w = (np.arange(64) % 2).astype(np.float32)
    je, te = _engines(n, cap=4, overflow_cap=64)
    tb = te.buckets(torch.tensor(X), weights=torch.tensor(w))
    assert tb.any_overflow
    got = te.interpolate_vel(tuple(map(torch.tensor, u)), torch.tensor(X),
                             b=tb)
    _close(je.interpolate_vel(tuple(map(jnp.asarray, u)), jnp.asarray(X),
                              weights=jnp.asarray(w)), got)
    assert bool(torch.all(got[w == 0] == 0))


def test_tile_wrappers_refuse_other_devices():
    _, tg = _grids((16, 16, 16))
    te = ci.TileKernelInteraction(tg, cap=16, device="cpu")
    Xb = torch.zeros((4, 16, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ci.tile_spread(te.geom, tg, (0.5,) * 3, Xb,
                       torch.zeros((4, 16), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ci.tile_interp(te.geom, tg, (0.5,) * 3, Xb,
                       torch.zeros((4, 169, 16), device="meta"))
