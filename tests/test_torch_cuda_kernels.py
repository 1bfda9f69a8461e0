"""The CUDA kernels on the card: each against its plain PyTorch version
(``1e-5·max|plain|``, f32, other sum order) and bitwise run to run. The
packed kernels with several chunks per tile, on a 16-cell blocked axis
(nblk = 2: a tile's two neighbours on an axis are one tile), with
markers within 2 cells of every periodic face, and with one hot tile of
40,000 markers (its columns hold more chunks than the spread's chunk
table and more live slots than 2^15), each with more chunks than the
pack needs (trailing chunks pinned to the last tile, X = 0); the packed
spread, which writes the grid itself, and the packed interp, which reads
it, on every slot; the packed engine's spread without any overlap-add and
its interp without any tile extraction; a packed spread past the
kernel's slot limit raises. The tile kernels,
which write and read the grid themselves, with more than 128 markers per
tile, on a 16-cell blocked axis and with markers at every periodic face.
A launch that reports a CUDA error raises. Every named delta (IB_3,
IB_4, IB_6, COSINE, PIECEWISE_LINEAR, BSPLINE_2 to BSPLINE_6) through the
four kernels on the faces layouts and a 16-cell blocked axis, against
the plain versions, bitwise run to run, with the launches counted by
delta. Needs an NVIDIA GPU and skips
without one. The file imports neither JAX nor
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
from ibamr_tpu_torch.ops.interaction_fast import bucketed_channel


def _close(ref, got, tol):
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= tol * scale


def _faces(rng, N, n):
    """Markers within 2 cells of a periodic face on every axis."""
    near = rng.uniform(0, 2, (N, 3)) / np.asarray(n)
    return np.where(rng.uniform(size=(N, 3)) < 0.5, near, 1.0 - near)


def _hot_tile(rng, N):
    """Every marker in one (x, y) tile (x, y in 0.3..0.4 of a 32-cell
    axis: stencil origins in cells 8..11), random z."""
    return np.stack([rng.uniform(0.3, 0.4, N), rng.uniform(0.3, 0.4, N),
                     rng.uniform(0, 1, N)], axis=1)


# (grid, markers, nchunks): several chunks in every tile; a 16-cell
# blocked axis; markers at every periodic face; one hot tile of 313
# chunks. Each pack leaves trailing chunks unallocated.
PACKED_CASES = {
    "hot_tile": ((32, 32, 64), lambda rng, n: _hot_tile(rng, 40000), 330),
    "several_chunks_per_tile": ((32, 32, 64), lambda rng, n: rng.uniform(
        0, 1, (6000, 3)), 64),
    "nblk2": ((16, 16, 40), lambda rng, n: rng.uniform(0, 1, (1500, 3)),
              16),
    "faces": ((32, 32, 64), lambda rng, n: _faces(rng, 1000, n), 32),
}


def _packed_case(case):
    """A packed layout on the card with trailing chunks pinned to the
    last tile."""
    n, make, nchunks = PACKED_CASES[case]
    rng = np.random.default_rng(6)
    X = make(rng, n).astype(np.float32)
    F = rng.standard_normal((X.shape[0], 3)).astype(np.float32)
    u = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    tg = StaggeredGrid(n=n, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    eng = ci.PackedKernelInteraction(tg, chunk=128, nchunks=nchunks,
                                     device="cuda")
    b = eng.buckets(torch.tensor(X, device="cuda"))
    B = int(np.prod(eng.geom.nblk))
    assert not b.any_overflow
    assert not bool((b.wb[-1] != 0).any())
    assert int(b.tile_of_chunk[-1]) == B - 1
    return tg, eng, b, X, F, u


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_cuda_kernels_match_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run "
                    "only there")
    tg, eng, b, X, F, u = _packed_case(case)
    if case == "several_chunks_per_tile":
        chunks = torch.bincount(b.tile_of_chunk[(b.wb != 0).any(1)].long())
        assert int(chunks.min()) >= 2
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
        assert k1.shape == tg.n and torch.equal(k1, k2)
        _close(ref, k1, 1e-5)
        f = torch.tensor(u[d], device="cuda")
        k1 = ci.packed_interp(eng.geom, tg, offs, b.tile_of_chunk, b.Xb, f)
        k2 = ci.packed_interp(eng.geom, tg, offs, b.tile_of_chunk, b.Xb, f)
        ref = ci.packed_interp_plain(eng.geom, tg, offs, b.tile_of_chunk,
                                     b.Xb, f)
        assert k1.shape == b.wb.shape and torch.equal(k1, k2)
        _close(ref, k1, 1e-5)      # every slot, empty and trailing ones too


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_packed_engine_interp_reads_the_grid_on_card(case, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run "
                    "only there")
    tg, eng, b, X, F, u = _packed_case(case)
    cpu = ci.PackedKernelInteraction(tg, chunk=128, nchunks=eng.nchunks,
                                     device="cpu")
    ref = cpu.interpolate_vel(tuple(map(torch.tensor, u)), torch.tensor(X))

    def no_extraction(*args, **kwargs):
        raise AssertionError("the packed engine extracted tiles on CUDA")

    monkeypatch.setattr(ci, "_extract_tiles", no_extraction)
    before = ci.LAUNCHES["packed_interp"]
    got = eng.interpolate_vel(tuple(torch.tensor(c, device="cuda")
                                    for c in u),
                              torch.tensor(X, device="cuda"), b=b)
    assert ci.LAUNCHES["packed_interp"] == before + 3
    _close(ref, got.cpu(), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_packed_engine_spread_writes_the_grid_on_card(case, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run "
                    "only there")
    tg, eng, b, X, F, u = _packed_case(case)
    cpu = ci.PackedKernelInteraction(tg, chunk=128, nchunks=eng.nchunks,
                                     device="cpu")
    ref = cpu.spread_vel(torch.tensor(F), torch.tensor(X))

    def no_overlap_add(*args, **kwargs):
        raise AssertionError("the packed engine folded tile partials on "
                             "CUDA")

    monkeypatch.setattr(ci, "_overlap_add", no_overlap_add)
    before = ci.LAUNCHES["packed_spread"]
    got = eng.spread_vel(torch.tensor(F, device="cuda"),
                         torch.tensor(X, device="cuda"), b=b)
    assert ci.LAUNCHES["packed_spread"] == before + 3
    for r, g in zip(ref, got):
        assert g.shape == tg.n
        _close(r, g.cpu(), 1e-5)


@pytest.mark.cuda
def test_packed_spread_past_its_limit_raises_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run "
                    "only there")
    tg = StaggeredGrid(n=(32, 32, 64), x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    eng = ci.PackedKernelInteraction(tg, chunk=128, nchunks=8,
                                     device="cuda")
    _, (max_slots, _, _) = ci._launcher("packed_spread", 4)
    Q = max_slots // 128 + 1
    tid = torch.zeros(Q, dtype=torch.int32, device="cuda")
    Xb = torch.zeros((Q, 128, 3), device="cuda")
    before = ci.LAUNCHES["packed_spread"]
    with pytest.raises(ValueError, match="needs slots <="):
        ci.packed_spread(eng.geom, tg, (0.5,) * 3, tid, Xb,
                         torch.zeros((Q, 128), device="cuda"))
    assert ci.LAUNCHES["packed_spread"] == before


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
        _, limits = ci._launcher(name, 4)
        monkeypatch.setitem(ci._bound, (name, 4), (lambda *a: 700, limits))
    before = dict(ci.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ci.tile_spread(eng.geom, tg, offs, b.Xb, coef, b.counts)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ci.tile_interp(eng.geom, tg, offs, b.Xb, f, b.counts)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        eng.spread_vel(torch.tensor(F, device="cuda"),
                       torch.zeros((6000, 3), device="cuda"), b=b)
    assert ci.LAUNCHES == before


DELTAS = ("PIECEWISE_LINEAR", "BSPLINE_2", "IB_3", "BSPLINE_3", "COSINE",
          "IB_4", "BSPLINE_4", "BSPLINE_5", "IB_6", "BSPLINE_6")
# On a cell size that is not a power of two the plain version's grid
# coordinate moves by an ulp from the kernel's: PyTorch divides a CUDA
# tensor by a Python scalar as a product with the scalar's rounded
# reciprocal, the kernel (as the reference) divides. The higher
# B-splines' truncated-power sums cancel to ~20 ulp of the weight, so
# that ulp comes back as f32 noise: this test measured 2.6e-5 of
# max|plain| for BSPLINE_6 at nz = 40 on an H100 80GB HBM3 at 700 W
# against a tolerance of 1e-5; BSPLINE_5 passed 1e-5 and is given twice
# it for the same cause.
TOL_DELTA = {"BSPLINE_5": 2e-5, "BSPLINE_6": 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("grid_n", [(32, 32, 64), (16, 16, 40)])
@pytest.mark.parametrize("kernel", DELTAS)
def test_kernels_match_plain_at_every_delta_on_card(kernel, grid_n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run "
                    "only there")
    rng = np.random.default_rng(8)
    X = np.concatenate([_faces(rng, 700, grid_n),
                        rng.uniform(0, 1, (700, 3))]).astype(np.float32)
    F = rng.standard_normal((X.shape[0], 3)).astype(np.float32)
    u = [rng.standard_normal(grid_n).astype(np.float32) for _ in range(3)]
    tg = StaggeredGrid(n=grid_n, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    pe = ci.PackedKernelInteraction(tg, kernel=kernel, chunk=128,
                                    nchunks=64, device="cuda")
    te = ci.TileKernelInteraction(tg, kernel=kernel, cap=1024,
                                  device="cuda")
    Xd = torch.tensor(X, device="cuda")
    pb, tb = pe.buckets(Xd), te.buckets(Xd)
    assert not pb.any_overflow and not tb.any_overflow
    ci.reset_launch_counts()
    for d in range(3):
        offs = _centering_offsets(tg, d)
        Fd = torch.tensor(F[:, d], device="cuda")
        f = torch.tensor(u[d], device="cuda")
        pc = (bucketed_channel(pb, Fd) * pb.wb).contiguous()
        tc = (bucketed_channel(tb, Fd) * tb.wb).contiguous()
        args = (pe.geom, tg, offs, pb.tile_of_chunk, pb.Xb)
        targs = (te.geom, tg, offs, tb.Xb)
        for fn, plain, a, extra in (
                (ci.packed_spread, ci.packed_spread_plain, args, (pc,)),
                (ci.packed_interp, ci.packed_interp_plain, args, (f,)),
                (ci.tile_spread, ci.tile_spread_plain, targs,
                 (tc, tb.counts)),
                (ci.tile_interp, ci.tile_interp_plain, targs,
                 (f, tb.counts))):
            k1 = fn(*a, *extra, kernel)
            k2 = fn(*a, *extra, kernel)
            ref = plain(*a, *extra, kernel)
            assert torch.equal(k1, k2), fn.__name__
            if fn is ci.tile_interp:
                k1, ref = k1 * tb.wb, ref * tb.wb
            _close(ref, k1, TOL_DELTA.get(kernel, 1e-5))
    for name in ci.LAUNCHES:
        assert ci.DELTA_LAUNCHES[(name, kernel)] == 6
        assert ci.LAUNCHES[name] == 6

