"""Port parity: the plain PyTorch versions of the two tile transfer
kernels (``ibamr_tpu_torch/ops/cuda_interaction.py``: ``tile_spread``,
which writes the grid, and ``tile_interp``, which reads it, each over the
filled slots given by the per-tile ``counts``), their per-tile partial
forms, and the ``pallas`` engine around them (``TileKernelInteraction``)
against the reference Pallas programs (``_spread_kernel_3d`` followed by
``_overlap_add``, ``_interp_kernel_3d`` after ``_extract_tiles``,
``PallasInteraction``, in interpret mode) on the CPU, in f32, with the
cases of ``tests/test_pallas_interaction.py``, at nblk = 2 (a 16-cell
blocked axis) and nblk = 4. The two sides sum in different orders:
transfers agree to ``2e-6·max|ref|`` (the reference suite's own
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
from ibamr_tpu.ops import interaction_fast as jfast
from ibamr_tpu.ops.interaction_fast import _extract_tiles as j_extract
from ibamr_tpu.ops.interaction_fast import bucketed_channel as j_channel
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.ops import cuda_interaction as ci
from ibamr_tpu_torch.ops import interaction as tinteraction
from ibamr_tpu_torch.ops import interaction_fast as tfast
from ibamr_tpu_torch.ops.interaction_fast import _extract_tiles

TOL = 2e-6
# a 16-cell blocked axis (nblk = 2: a tile's two neighbours on an axis are
# one tile) and nblk = 4
SIZES = {"nblk2": (16, 16, 32), "nblk4": (32, 32, 32)}


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
    tb = convert.buckets(jb, device="cpu")
    offs = _centering_offsets(je.grid, centering)
    coef = j_channel(jb, jnp.asarray(F[:, centering])) * jb.wb \
        / float(np.prod(je.grid.dx))
    ref = jpal._spread_kernel_3d(je.geom, je.grid, offs, je._phi,
                                 True)(jb.Xb, coef)
    got = ci.tile_spread_partials_plain(te.geom, te.grid, offs, tb.Xb,
                                        torch.tensor(np.asarray(coef)))
    _close(ref, got)
    # a tile whose coefs are all zero comes out exactly zero
    zero = torch.tensor(np.asarray(coef)).clone()
    zero[0] = 0
    got = ci.tile_spread_partials_plain(te.geom, te.grid, offs, tb.Xb, zero)
    assert bool(torch.all(got[0] == 0)) and float(got[1:].abs().max()) > 0


@pytest.mark.parametrize("centering", [0, 1, 2])
def test_tile_interp_plain_matches_pallas(centering):
    n = (16, 16, 32)
    X, _, u = _inputs(1, n=n)
    je, te = _engines(n, cap=128)
    jb = je.buckets(jnp.asarray(X))
    tb = convert.buckets(jb, device="cpu")
    offs = _centering_offsets(je.grid, centering)
    T = j_extract(je.geom, je.grid, jnp.asarray(u[centering]))
    Tt = _extract_tiles(te.geom, te.grid, torch.tensor(u[centering]))
    np.testing.assert_array_equal(np.asarray(T), Tt.numpy())
    ref = np.asarray(jpal._interp_kernel_3d(je.geom, je.grid, offs, je._phi,
                                            True)(jb.Xb, T))[:, 0, :]
    got = ci.tile_interp_partials_plain(te.geom, te.grid, offs, tb.Xb, Tt)
    assert bool(torch.isfinite(got).all())   # empty slots too (X = 0)
    live = np.asarray(jb.wb) != 0     # empty slots are weighted by 0
    _close(ref * live, got * torch.tensor(live))


def _spread_case(n, centering, seed=0):
    X, F, _ = _inputs(seed, n=n)
    je, te = _engines(n, cap=128)
    jb = je.buckets(jnp.asarray(X))
    tb = convert.buckets(jb, device="cpu")
    offs = _centering_offsets(je.grid, centering)
    coef = j_channel(jb, jnp.asarray(F[:, centering])) * jb.wb \
        / float(np.prod(je.grid.dx))
    return je, te, jb, tb, offs, coef


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("centering", [0, 1, 2])
def test_tile_spread_grid_plain_matches_pallas(centering, size):
    n = SIZES[size]
    je, te, jb, tb, offs, coef = _spread_case(n, centering)
    T = jpal._spread_kernel_3d(je.geom, je.grid, offs, je._phi,
                               True)(jb.Xb, coef)
    T = T.reshape((T.shape[0],) + tuple(je.geom.width) + (n[2],))
    ref = jfast._overlap_add(je.geom, je.grid, T)
    got = ci.tile_spread(te.geom, te.grid, offs, tb.Xb,
                         torch.tensor(np.asarray(coef)), tb.counts)
    assert tuple(got.shape) == n
    _close(ref, got)
    # slots past a row's count are not read, whatever they hold
    junk = torch.tensor(np.asarray(coef)).clone()
    junk[~ci._filled(tb.Xb, tb.counts)] = 1e6
    torch.testing.assert_close(
        ci.tile_spread(te.geom, te.grid, offs, tb.Xb, junk, tb.counts), got,
        rtol=0, atol=0)


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("centering", [0, 1, 2])
def test_tile_interp_field_plain_matches_pallas(centering, size):
    n = SIZES[size]
    X, _, u = _inputs(1, n=n)
    je, te = _engines(n, cap=128)
    jb = je.buckets(jnp.asarray(X))
    tb = convert.buckets(jb, device="cpu")
    offs = _centering_offsets(je.grid, centering)
    f = u[centering]
    ref = np.asarray(jpal._interp_kernel_3d(je.geom, je.grid, offs, je._phi,
                                            True)(
        jb.Xb, j_extract(je.geom, je.grid, jnp.asarray(f))))[:, 0, :]
    got = ci.tile_interp(te.geom, te.grid, offs, tb.Xb, torch.tensor(f),
                         tb.counts)
    filled = ci._filled(tb.Xb, tb.counts)
    assert bool(torch.all(got[~filled] == 0))   # exact zeros past counts
    live = np.asarray(jb.wb) != 0     # empty slots are weighted by 0
    _close(ref * live, got * torch.tensor(live))


def _occupancy(jb):
    """The reference layout's per-tile occupancy: its markers' slots."""
    B, cap = jb.wb.shape
    slot = np.asarray(jb.slot_of_marker)
    return np.bincount(slot[slot < B * cap] // cap, minlength=B)


COUNT_CASES = {
    "random": (lambda rng, N: rng.uniform(-0.05, 1.05, (N, 3)), 64, False),
    "hot_tile_overflow": (lambda rng, N: np.stack(
        [rng.uniform(0.30, 0.34, N), rng.uniform(0.30, 0.34, N),
         rng.uniform(0, 1, N)], axis=1), 16, False),
    "masked": (lambda rng, N: rng.uniform(0, 1, (N, 3)), 64, True),
}


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("case", sorted(COUNT_CASES))
def test_tile_counts_match_reference_occupancy(case, size):
    make, cap, masked = COUNT_CASES[case]
    n = SIZES[size]
    rng = np.random.default_rng(11)
    X = make(rng, 250).astype(np.float32)
    w = (rng.uniform(size=len(X)) > 0.3).astype(np.float32) if masked \
        else None
    je, te = _engines(n, cap=cap)
    jb = je.buckets(jnp.asarray(X),
                    weights=None if w is None else jnp.asarray(w))
    tb = te.buckets(torch.tensor(X),
                    weights=None if w is None else torch.tensor(w))
    occ = _occupancy(jb)
    assert tb.counts.dtype == torch.int32
    np.testing.assert_array_equal(tb.counts.numpy(), occ)
    np.testing.assert_array_equal(convert.buckets(jb, device="cpu")
                                  .counts.numpy(), occ)
    if case == "hot_tile_overflow":
        assert tb.any_overflow and int(tb.counts.max()) == cap
    if masked:   # masked markers hold their slots, at weight 0
        assert int((tb.wb == 0).sum()) > int(te.geom.cap * np.prod(
            te.geom.nblk) - tb.counts.sum())
    # the filled prefix is exactly the slots the markers went to
    filled = np.zeros(tb.wb.numel(), dtype=bool)
    slot = tb.slot_of_marker.numpy()
    filled[slot[slot < tb.wb.numel()]] = True
    np.testing.assert_array_equal(
        ci._filled(tb.Xb, tb.counts).numpy().reshape(-1), filled)


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
    counts = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ci.tile_spread(te.geom, tg, (0.5,) * 3, Xb,
                       torch.zeros((4, 16), device="meta"), counts)
    with pytest.raises(ValueError, match="unsupported device"):
        ci.tile_interp(te.geom, tg, (0.5,) * 3, Xb,
                       torch.zeros(tg.n, device="meta"), counts)
