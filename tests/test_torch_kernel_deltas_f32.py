"""Port parity of the four transfer kernels' plain versions at f32 for
every named delta on both layouts: the spread onto the grid and the
interp, against the reference's programs in XLA ops (the same tile
weights, sums per layout row, per tile and the fold as its Pallas
programs, which the f64 files hold the plain versions to; an
interpret-mode Pallas call costs ~2 s, 40 of them too much for the
suite), within ``2e-6·max|ref|``, the tolerance of the reference's own
suite (``tests/test_pallas_packed.py``), except for the higher
B-splines. Their truncated-power sum, sum_j c_j (r + k/2 - j)_+^(k-1),
cancels terms up to ~20 times the weight it leaves, so f32 rounds each
weight to ~20 ulp; the two sides evaluate it in different orders (XLA's
fused elementwise ops, PyTorch's one op at a time). Measured on the CPU
on these markers (max|got - ref| / max|ref| of the spread and of the
interp):
BSPLINE_4 1.9e-6 and 1.7e-6, BSPLINE_5 3.3e-6 and 8.7e-6, BSPLINE_6
5.9e-6 and 3.4e-5 (the others 2.7e-7 to 1.1e-6); their tolerances are
4e-6, 2e-5 and 1e-4. Also the packed spread of a hot tile (every marker in one
tile, several chunks) at PIECEWISE_LINEAR, whose weights reach 1, the
largest of any delta, against the Pallas program at f64 within
``1e-12·max|ref|``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _kernel_deltas import (DELTAS, close, coef_of, grids, markers,
                            packed_case, ref_packed_interp,
                            ref_packed_spread, ref_tile_interp,
                            ref_tile_spread, tile_case)
from ibamr_tpu.ops import pallas_interaction as jpal
from ibamr_tpu.ops.interaction import _centering_offsets
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.ops import cuda_interaction as ci

TOL_F32 = {"BSPLINE_4": 4e-6, "BSPLINE_5": 2e-5, "BSPLINE_6": 1e-4}


@pytest.fixture(autouse=True)
def _one_thread():
    # six xdist workers oversubscribe the cores otherwise
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("layout", ["packed", "tile"])
@pytest.mark.parametrize("kernel", DELTAS)
def test_kernels_plain_match_reference_f32(kernel, layout):
    i = DELTAS.index(kernel)
    tol = TOL_F32.get(kernel, 2e-6)
    centering = (i + 2) % 3
    X, F, u = markers(40 + i, np.float32)
    f = u[centering]
    if layout == "packed":
        je, te, jb, tb = packed_case(kernel, X)
        offs = _centering_offsets(je.grid, centering)
        coef = coef_of(je, jb, F, centering)
        ref_s = ref_packed_spread(je, jb, centering, coef, pallas=False)
        got_s = ci.packed_spread(te.geom, te.grid, offs, tb.tile_of_chunk,
                                 tb.Xb, torch.tensor(np.asarray(coef)),
                                 kernel)
        ref_i = ref_packed_interp(je, jb, centering, jnp.asarray(f),
                                  pallas=False)
        got_i = ci.packed_interp(te.geom, te.grid, offs, tb.tile_of_chunk,
                                 tb.Xb, torch.tensor(f), kernel)
    else:
        je, te, jb, tb = tile_case(kernel, X)
        offs = _centering_offsets(je.grid, centering)
        coef = coef_of(je, jb, F, centering)
        ref_s = ref_tile_spread(je, jb, centering, coef, pallas=False)
        got_s = ci.tile_spread(te.geom, te.grid, offs, tb.Xb,
                               torch.tensor(np.asarray(coef)), tb.counts,
                               kernel)
        live = np.asarray(jb.wb) != 0
        ref_i = np.asarray(ref_tile_interp(
            je, jb, centering, jnp.asarray(f), pallas=False)) * live
        got_i = ci.tile_interp(te.geom, te.grid, offs, tb.Xb,
                               torch.tensor(f), tb.counts, kernel)
    assert got_s.dtype == got_i.dtype == torch.float32
    close(ref_s, got_s, tol)
    close(ref_i, got_i, tol)


def test_hot_tile_multi_chunk_spread_at_piecewise_linear():
    rng = np.random.default_rng(12)
    N = 150
    X = np.stack([rng.uniform(0.30, 0.34, N), rng.uniform(0.30, 0.34, N),
                  rng.uniform(0, 1, N)], axis=1)
    F = rng.standard_normal((N, 3))
    jg, tg = grids()
    kernel = "PIECEWISE_LINEAR"
    je = jpal.PallasPackedInteraction(jg, kernel=kernel, tile=8, chunk=16,
                                      nchunks=16, interpret=True)
    te = ci.PackedKernelInteraction(tg, kernel=kernel, tile=8, chunk=16,
                                    nchunks=16, device="cpu")
    jb = je.buckets(jnp.asarray(X))
    tb = convert.packed_buckets(jb, device="cpu")
    live = (tb.wb != 0).any(1)
    assert int(live.sum()) >= 9 and not tb.any_overflow
    assert len(set(tb.tile_of_chunk[live].tolist())) == 1
    coef = coef_of(je, jb, F, 0)
    close(ref_packed_spread(je, jb, 0, coef),
          ci.packed_spread(te.geom, tg, _centering_offsets(jg, 0),
                           tb.tile_of_chunk, tb.Xb,
                           torch.tensor(np.asarray(coef)), kernel), 1e-12)
