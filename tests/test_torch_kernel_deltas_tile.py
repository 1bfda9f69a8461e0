"""Port parity of the tile transfer kernels at every named delta: the
plain PyTorch versions of ``tile_spread`` and ``tile_interp``
(``ibamr_tpu_torch/ops/cuda_interaction.py``), which stand for the CUDA
kernels on the CPU, against the reference's Pallas programs
(``_spread_kernel_3d`` then ``_overlap_add``, ``_interp_kernel_3d``
after ``_extract_tiles``, interpret mode) for IB_3, IB_4, COSINE,
PIECEWISE_LINEAR and BSPLINE_2 to BSPLINE_6, and at IB_6 against the
same program in XLA ops (the Pallas program cannot trace IB_6's table),
at f64 within ``1e-12·max|ref|``: the spread onto the grid over the
filled slots, the interp on the filled slots (the kernel leaves exact
zeros past each row's count), on a 16³ grid with tile 8 and markers
whose supports reach past every face (``_kernel_deltas.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _kernel_deltas import (DELTAS, close, coef_of, markers,
                            ref_tile_interp, ref_tile_spread, tile_case)
from ibamr_tpu.ops.interaction import _centering_offsets
from ibamr_tpu_torch.ops import cuda_interaction as ci

TOL_F64 = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    # six xdist workers oversubscribe the cores otherwise
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kernel", DELTAS)
def test_tile_kernels_plain_match_reference_f64(kernel):
    centering = (DELTAS.index(kernel) + 1) % 3
    X, F, u = markers(20 + DELTAS.index(kernel), np.float64)
    je, te, jb, tb = tile_case(kernel, X)
    assert int(tb.counts.max()) > 0 and not tb.any_overflow
    offs = _centering_offsets(je.grid, centering)
    coef = coef_of(je, jb, F, centering)
    got = ci.tile_spread(te.geom, te.grid, offs, tb.Xb,
                         torch.tensor(np.asarray(coef)), tb.counts, kernel)
    assert got.dtype == torch.float64 and got.shape == te.grid.n
    close(ref_tile_spread(je, jb, centering, coef), got, TOL_F64)
    f = u[centering]
    got = ci.tile_interp(te.geom, te.grid, offs, tb.Xb, torch.tensor(f),
                         tb.counts, kernel)
    live = np.asarray(jb.wb) != 0
    assert bool(torch.all(got[~torch.tensor(live)] == 0))
    close(np.asarray(ref_tile_interp(je, jb, centering, jnp.asarray(f)))
          * live, got, TOL_F64)
