"""The CUDA kernels on the card: each against its plain PyTorch version
(``1e-5·max|plain|``, f32, other sum order) and bitwise run to run, at a
small size with several chunks per tile (packed kernels); the tile
kernels, which write and read the grid themselves, with more than 128
markers per tile, on a 16-cell blocked axis (nblk = 2: a tile's two
neighbours on an axis are one tile) and with markers within 2 cells of
every periodic face; a launch that reports a CUDA error raises. Needs
an NVIDIA GPU and skips without one. The file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops import cuda_interaction as ci
from ibamr_tpu_torch.ops.interaction import _centering_offsets
from ibamr_tpu_torch.ops.interaction_fast import (_extract_tiles,
                                                  bucketed_channel)


def _close(ref, got, tol):
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run "
                    "only there")
    n = (32, 32, 64)
    rng = np.random.default_rng(6)
    X = rng.uniform(0, 1, (6000, 3)).astype(np.float32)
    F = rng.standard_normal((6000, 3)).astype(np.float32)
    u = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    tg = StaggeredGrid(n=n, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    eng = ci.PackedKernelInteraction(tg, chunk=128, nchunks=64,
                                     device="cuda")
    Xc = torch.tensor(X, device="cuda")
    b = eng.buckets(Xc)
    chunks = torch.bincount(b.tile_of_chunk[(b.wb != 0).any(1)].long())
    assert not b.any_overflow and int(chunks.min()) >= 2
    for d in range(3):
        offs = _centering_offsets(tg, d)
        coef = (bucketed_channel(b, torch.tensor(F[:, d], device="cuda"))
                * b.wb).contiguous()
        k1 = ci.packed_spread(eng.geom, tg, offs, b.tile_of_chunk, b.Xb,
                              coef)
        k2 = ci.packed_spread(eng.geom, tg, offs, b.tile_of_chunk, b.Xb,
                              coef)
        ref = ci.packed_spread_plain(eng.geom, tg, offs, b.tile_of_chunk,
                                     b.Xb, coef)
        assert torch.equal(k1, k2)
        _close(ref, k1, 1e-5)
        T = _extract_tiles(eng.geom, tg, torch.tensor(u[d], device="cuda"))
        k = ci.packed_interp(eng.geom, tg, offs, b.tile_of_chunk, b.Xb, T)
        ref = ci.packed_interp_plain(eng.geom, tg, offs, b.tile_of_chunk,
                                     b.Xb, T)
        _close(ref * b.wb, k * b.wb, 1e-5)


def _faces(rng, N, n):
    """Markers within 2 cells of a periodic face on every axis."""
    near = rng.uniform(0, 2, (N, 3)) / np.asarray(n)
    return np.where(rng.uniform(size=(N, 3)) < 0.5, near, 1.0 - near)


# (grid, markers, cap): more than 128 markers in every tile; a 16-cell
# blocked axis and a ragged last z slab; markers at every periodic face
TILE_CASES = {
    "over_128_per_tile": ((32, 32, 64), lambda rng, n: rng.uniform(
        0, 1, (6000, 3)), 512),
    "nblk2": ((16, 16, 40), lambda rng, n: rng.uniform(0, 1, (1500, 3)),
              512),
    "faces": ((32, 32, 64), lambda rng, n: _faces(rng, 1000, n), 1024),
}


def _tile_case(case="over_128_per_tile"):
    """A per-tile layout on the card."""
    n, make, cap = TILE_CASES[case]
    rng = np.random.default_rng(7)
    X = make(rng, n).astype(np.float32)
    F = rng.standard_normal((X.shape[0], 3)).astype(np.float32)
    u = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    tg = StaggeredGrid(n=n, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    eng = ci.TileKernelInteraction(tg, cap=cap, device="cuda")
    b = eng.buckets(torch.tensor(X, device="cuda"))
    return tg, eng, b, F, u


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_tile_kernels_match_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run "
                    "only there")
    tg, eng, b, F, u = _tile_case(case)
    assert not b.any_overflow
    if case == "over_128_per_tile":
        assert int(b.counts.min()) > 128
    filled = ci._filled(b.Xb, b.counts)
    for d in range(3):
        offs = _centering_offsets(tg, d)
        coef = (bucketed_channel(b, torch.tensor(F[:, d], device="cuda"))
                * b.wb).contiguous()
        k1 = ci.tile_spread(eng.geom, tg, offs, b.Xb, coef, b.counts)
        k2 = ci.tile_spread(eng.geom, tg, offs, b.Xb, coef, b.counts)
        ref = ci.tile_spread_plain(eng.geom, tg, offs, b.Xb, coef, b.counts)
        assert k1.shape == tg.n and torch.equal(k1, k2)
        _close(ref, k1, 1e-5)
        f = torch.tensor(u[d], device="cuda")
        k1 = ci.tile_interp(eng.geom, tg, offs, b.Xb, f, b.counts)
        k2 = ci.tile_interp(eng.geom, tg, offs, b.Xb, f, b.counts)
        ref = ci.tile_interp_plain(eng.geom, tg, offs, b.Xb, f, b.counts)
        assert torch.equal(k1, k2) and bool(torch.isfinite(k1).all())
        assert bool(torch.all(k1[~filled] == 0))
        _close(ref * b.wb, k1 * b.wb, 1e-5)


@pytest.mark.cuda
def test_failed_launch_raises_on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run "
                    "only there")
    tg, eng, b, F, u = _tile_case()
    offs = _centering_offsets(tg, 0)
    coef = (bucketed_channel(b, torch.tensor(F[:, 0], device="cuda"))
            * b.wb).contiguous()
    f = torch.tensor(u[0], device="cuda")
    for name in ("tile_spread", "tile_interp"):
        _, limits = ci._launcher(name)
        monkeypatch.setitem(ci._bound, name, (lambda *a: 700, limits))
    before = dict(ci.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ci.tile_spread(eng.geom, tg, offs, b.Xb, coef, b.counts)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ci.tile_interp(eng.geom, tg, offs, b.Xb, f, b.counts)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        eng.spread_vel(torch.tensor(F, device="cuda"),
                       torch.zeros((6000, 3), device="cuda"), b=b)
    assert ci.LAUNCHES == before
