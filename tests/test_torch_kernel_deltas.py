"""Port parity of the packed transfer kernels at every named delta: the
plain PyTorch versions of ``packed_spread`` and ``packed_interp``
(``ibamr_tpu_torch/ops/cuda_interaction.py``), which stand for the CUDA
kernels on the CPU, against the reference's Pallas programs
(``_packed_spread_kernel_3d`` with its visited-tile mask and
``_overlap_add``, ``_packed_interp_kernel_3d`` after ``_extract_tiles``,
interpret mode) for IB_3, IB_4, COSINE, PIECEWISE_LINEAR and BSPLINE_2
to BSPLINE_6, at f64 within ``1e-12·max|ref|``, on a 16³ grid with tile
8 (the smallest legal size at support 6) and markers whose supports
reach past every face. The reference's Pallas programs cannot trace
IB_6 (its table would be a constant the kernel captures, which Pallas
refuses), so at IB_6 the reference side is the same program in XLA ops
(``_kernel_deltas.py``). Also: the host's delta map
(ids, supports and the fixed-point cut each spread term gives up, against
a dense evaluation of each phi) and the kernel engine's adjointness at
IB_6.
The tile kernels are in ``test_torch_kernel_deltas_tile.py``, f32 and
the hot tile in ``test_torch_kernel_deltas_f32.py``, the engines and a
coupled step in ``test_torch_kernel_deltas_engines.py`` (each Pallas
program costs ~2 s in interpret mode, so the cases are spread over four
files that the parallel run takes side by side); shared cases in
``_kernel_deltas.py``. The CUDA kernels themselves are held against
these plain versions on the card by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _kernel_deltas import (DELTAS, coef_of, close, grids, markers,
                            packed_case, ref_packed_interp,
                            ref_packed_spread)
from ibamr_tpu.ops.interaction import _centering_offsets
from ibamr_tpu_torch.ops import cuda_interaction as ci
from ibamr_tpu_torch.ops import delta as tdelta

TOL_F64 = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    # six xdist workers oversubscribe the cores otherwise
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kernel", DELTAS)
def test_packed_kernels_plain_match_reference_f64(kernel):
    centering = DELTAS.index(kernel) % 3
    X, F, u = markers(DELTAS.index(kernel), np.float64)
    je, te, jb, tb = packed_case(kernel, X)
    assert te.geom.support == tdelta.get_kernel(kernel)[0]
    offs = _centering_offsets(je.grid, centering)
    coef = coef_of(je, jb, F, centering)
    got = ci.packed_spread(te.geom, te.grid, offs, tb.tile_of_chunk, tb.Xb,
                           torch.tensor(np.asarray(coef)), kernel)
    assert got.dtype == torch.float64 and got.shape == te.grid.n
    close(ref_packed_spread(je, jb, centering, coef), got, TOL_F64)
    f = u[centering]
    got = ci.packed_interp(te.geom, te.grid, offs, tb.tile_of_chunk, tb.Xb,
                           torch.tensor(f), kernel)
    close(ref_packed_interp(je, jb, centering, jnp.asarray(f)), got,
          TOL_F64)


def test_cuda_delta_map_and_cuts():
    # every named isotropic delta has an id and the reference's support;
    # each spread term gives up cut bits so that (2 max phi)^3 <= 2^cut
    # (csrc/spread_column.cuh): checked on a dense evaluation of phi in
    # f32 and f64 and on IB_6's table
    assert set(tdelta.CUDA_DELTAS) == set(DELTAS)
    assert sorted(v[0] for v in tdelta.CUDA_DELTAS.values()) == \
        list(range(len(DELTAS)))
    expect = {"PIECEWISE_LINEAR": 3, "BSPLINE_2": 3, "IB_3": 2,
              "BSPLINE_3": 2, "BSPLINE_4": 2, "BSPLINE_5": 1,
              "BSPLINE_6": 1, "COSINE": 0, "IB_4": 0, "IB_6": 0}
    r = np.linspace(-3.0, 3.0, 60001)
    for name in DELTAS:
        nm, _, support, cut = tdelta.cuda_delta(name.lower())
        assert nm == name and cut == expect[name]
        assert support == tdelta.get_kernel(name)[0]
        phi = tdelta.get_kernel(name)[1]
        big = max(float(phi(torch.tensor(r, dtype=dt)).max())
                  for dt in (torch.float32, torch.float64))
        if name == "IB_6":
            big = max(big, float(tdelta._ib6_table().max()))
        assert (2.0 * big) ** 3 <= 2.0 ** cut
        assert cut == 0 or (2.0 * big) ** 3 > 2.0 ** (cut - 1)
    for bad in ("COMPOSITE_BSPLINE_32", "IB_5"):
        with pytest.raises(ValueError):
            tdelta.cuda_delta(bad)


def test_packed_engine_adjoint_at_ib6():
    # spread and interp evaluate the same weights: <S F, u> h^3 = <F, J u>
    X, F, u = markers(11, np.float64)
    _, tg = grids()
    te = ci.PackedKernelInteraction(tg, kernel="IB_6", tile=8, chunk=32,
                                    nchunks=32, device="cpu")
    Xt, Ft = torch.tensor(X), torch.tensor(F)
    ut = tuple(torch.tensor(c) for c in u)
    b = te.buckets(Xt)
    assert not b.any_overflow
    f = te.spread_vel(Ft, Xt, b=b)
    U = te.interpolate_vel(ut, Xt, b=b)
    lhs = sum(float(torch.sum(a * c)) for a, c in zip(f, ut)) \
        * float(np.prod(tg.dx))
    rhs = float(torch.sum(Ft * U))
    assert abs(lhs - rhs) < 1e-12 * (abs(lhs) + abs(rhs))
