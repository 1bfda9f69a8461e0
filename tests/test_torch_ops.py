"""Port parity: grid, IB_4 weights, stencils, convection and the
scatter/gather transfer oracle of ibamr_tpu_torch against ibamr_tpu at
f64 on the CPU. Inputs come from a numpy seed and go to both sides.
Elementwise ops in the same order agree to about 1e-14 relative."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu import grid as jgrid
from ibamr_tpu.ops import convection as jconv
from ibamr_tpu.ops import delta as jdelta
from ibamr_tpu.ops import interaction as jinter
from ibamr_tpu.ops import stencils as jst
from ibamr_tpu_torch import grid as tgrid
from ibamr_tpu_torch.ops import convection as tconv
from ibamr_tpu_torch.ops import delta as tdelta
from ibamr_tpu_torch.ops import interaction as tinter
from ibamr_tpu_torch.ops import stencils as tst

RTOL = 1e-14
N = (12, 10, 8)
BOX = dict(x_lo=(0.0, -0.5, 0.25), x_up=(1.0, 0.5, 1.5))


def _close(ref, got, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


def _fields(seed, k=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(N) for _ in range(k)]


def test_grid_geometry_and_face_centers():
    jg = jgrid.StaggeredGrid(n=N, **BOX)
    tg = tgrid.StaggeredGrid(n=N, **BOX)
    assert tg.dx == jg.dx and tg.cell_volume == jg.cell_volume
    for comp in range(3):
        for a, b in zip(jg.face_centers(comp, jnp.float64),
                        tg.face_centers(comp, torch.float64, "cpu")):
            _close(a, b)


def test_ib4_weights():
    r = np.random.default_rng(0).uniform(-3.0, 3.0, 4001)
    r[:9] = [-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, 1e-17, -1.9999999]
    _close(jdelta.get_kernel("IB_4")[1](jnp.asarray(r)),
           tdelta.get_kernel("IB_4")[1](torch.tensor(r)))
    assert tdelta.get_kernel("ib_4")[0] == 4


def test_other_delta_kernels_not_ported():
    # every named delta runs through the CUDA kernels' engines; a
    # user-defined (support, phi) pair does not (a Python callable cannot
    # run in a kernel)
    from ibamr_tpu_torch.ops.cuda_interaction import PackedKernelInteraction

    g = tgrid.StaggeredGrid(n=(16,) * 3, **BOX)
    assert tdelta.get_kernel("IB_6")[0] == 6
    eng = PackedKernelInteraction(g, kernel="IB_6", device="cpu")
    assert eng.kernel == "IB_6" and eng.geom.support == 6
    with pytest.raises(NotImplementedError, match="user-defined"):
        PackedKernelInteraction(g, kernel=(6, tdelta.get_kernel("IB_6")[1]),
                                device="cpu")


@pytest.mark.parametrize("op", ["divergence", "gradient", "laplacian",
                                "laplacian_vel"])
def test_stencils(op):
    f = _fields(1)
    dx = jgrid.StaggeredGrid(n=N, **BOX).dx
    if op == "divergence":
        args_j, args_t = [jnp.asarray(c) for c in f], [torch.tensor(c)
                                                       for c in f]
    elif op == "laplacian_vel":
        args_j, args_t = tuple(map(jnp.asarray, f)), tuple(
            map(torch.tensor, f))
    else:
        args_j, args_t = jnp.asarray(f[0]), torch.tensor(f[0])
    ref = getattr(jst, op)(args_j, dx)
    got = getattr(tst, op)(args_t, dx)
    if isinstance(ref, tuple):
        for a, b in zip(ref, got):
            _close(a, b)
    else:
        _close(ref, got)


def test_div_grad_is_laplacian():
    p = torch.tensor(_fields(2, 1)[0])
    dx = tgrid.StaggeredGrid(n=N, **BOX).dx
    _close(tst.laplacian(p, dx).numpy(),
           tst.divergence(tst.gradient(p, dx), dx), rtol=1e-12)


@pytest.mark.parametrize("scheme", ["centered", "upwind"])
def test_convective_rate(scheme):
    u = _fields(3)
    dx = jgrid.StaggeredGrid(n=N, **BOX).dx
    ref = jconv.convective_rate(tuple(map(jnp.asarray, u)), dx, scheme)
    got = tconv.convective_rate(tuple(map(torch.tensor, u)), dx, scheme)
    for a, b in zip(ref, got):
        _close(a, b)


@pytest.mark.parametrize("centering", ["cell", 0, 1, 2])
def test_scatter_oracle_spread_and_interp(centering):
    rng = np.random.default_rng(4)
    jg = jgrid.StaggeredGrid(n=N, **BOX)
    tg = tgrid.StaggeredGrid(n=N, **BOX)
    lo, hi = np.array(BOX["x_lo"]), np.array(BOX["x_up"])
    # markers inside and a few outside the box (periodic wrap)
    X = lo + rng.uniform(-0.1, 1.1, (200, 3)) * (hi - lo)
    F, w = rng.standard_normal(200), (rng.uniform(size=200) > 0.2) * 1.0
    f = rng.standard_normal(N)
    _close(jinter.spread(jnp.asarray(F), jg, jnp.asarray(X), centering,
                         weights=jnp.asarray(w)),
           tinter.spread(torch.tensor(F), tg, torch.tensor(X), centering,
                         weights=torch.tensor(w)))
    _close(jinter.interpolate(jnp.asarray(f), jg, jnp.asarray(X), centering,
                              weights=jnp.asarray(w)),
           tinter.interpolate(torch.tensor(f), tg, torch.tensor(X),
                              centering, weights=torch.tensor(w)))


def test_scatter_oracle_is_run_to_run_deterministic():
    # duplicates accumulate in a fixed order (the reference's spread is
    # bitwise reproducible; torch's default index_put_ is not)
    rng = np.random.default_rng(5)
    tg = tgrid.StaggeredGrid(n=N, **BOX)
    lo, hi = np.array(BOX["x_lo"]), np.array(BOX["x_up"])
    X = torch.tensor(lo + rng.uniform(size=(3000, 3)) * (hi - lo),
                     dtype=torch.float32)
    F = torch.tensor(rng.standard_normal(3000), dtype=torch.float32)
    runs = [tinter.spread(F, tg, X, 0) for _ in range(4)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("kernel", ["IB_4", "BSPLINE_3", "IB_6"])
def test_stencil_memo_matches_fresh_stencils_bitwise(kernel):
    """``Stencils`` (the scatter oracle's per-position context, built
    by ``IBMethod.prepare``) builds each stencil once and gives the same
    bits as building it anew; the isotropic one-pass stencil equals
    the reference's per-axis weights."""
    rng = np.random.default_rng(6)
    jg = jgrid.StaggeredGrid(n=N, **BOX)
    tg = tgrid.StaggeredGrid(n=N, **BOX)
    lo, hi = np.array(BOX["x_lo"]), np.array(BOX["x_up"])
    X = torch.tensor(lo + rng.uniform(-0.1, 1.1, (150, 3)) * (hi - lo))
    F = torch.tensor(rng.standard_normal((150, 3)))
    u = tuple(torch.tensor(f) for f in _fields(7))
    memo = tinter.Stencils(X)
    got_f = tinter.spread_vel(F, tg, X, kernel=kernel, stencils=memo)
    got_u = tinter.interpolate_vel(u, tg, X, kernel=kernel, stencils=memo)
    assert len(memo._memo) == 3
    again = memo.get(tg, X, 1, kernel)
    assert again is memo.get(tg, X, 1, kernel) and len(memo._memo) == 3
    ref_f = tinter.spread_vel(F, tg, X, kernel=kernel)
    ref_u = tinter.interpolate_vel(u, tg, X, kernel=kernel)
    assert all(torch.equal(a, b) for a, b in zip(got_f, ref_f))
    assert torch.equal(got_u, ref_u)
    # another position never reads the memo
    Y = X + 0.01
    assert torch.equal(tinter.interpolate_vel(u, tg, Y, kernel=kernel,
                                              stencils=memo),
                       tinter.interpolate_vel(u, tg, Y, kernel=kernel))
    if kernel == "IB_4":
        for d in range(3):
            _close(jinter.interpolate(jnp.asarray(u[d].numpy()), jg,
                                      jnp.asarray(X.numpy()), d),
                   got_u[:, d])
