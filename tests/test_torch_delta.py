"""Port parity of ``ops/delta.py`` and of the scatter oracle's per-axis
stencil: every kernel of the reference's menu, its metadata and the
``_safe_sqrt`` derivative in ibamr_tpu_torch against ibamr_tpu at f64 on
the CPU. The kernels are the same expressions evaluated in the same
order, so ``phi`` agrees to 1e-14 of its maximum; the spread and interp
of the scatter oracle in 2D and 3D, and the ``packed`` engine, agree to
1e-12 relative. The CUDA engines take every named isotropic delta and
raise for a composite B-spline or a user-defined pair."""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.ops import delta as jdelta
from ibamr_tpu.ops import interaction as jinter
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.ops import delta as tdelta
from ibamr_tpu_torch.ops import interaction as tinter

PHI_RTOL = 1e-14
TRANSFER_RTOL = 1e-12
PLAIN = ("PIECEWISE_LINEAR", "COSINE", "IB_3", "IB_4", "IB_6", "BSPLINE_2",
         "BSPLINE_3", "BSPLINE_4", "BSPLINE_5", "BSPLINE_6")
COMPOSITE = ("COMPOSITE_BSPLINE_32", "COMPOSITE_BSPLINE_43",
             "COMPOSITE_BSPLINE_54")


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                 1e-300))


def _r_grid():
    """r through every knot (multiples of 1/2 up to 3.5), just beside
    them, and random points in between."""
    knots = np.arange(-7, 8) * 0.5
    eps = 1e-12
    r = np.concatenate([knots, knots - eps, knots + eps,
                        np.random.default_rng(0).uniform(-3.6, 3.6, 2001)])
    return r


def test_menu_matches_reference():
    assert tdelta.available_kernels() == jdelta.available_kernels()
    assert set(tdelta.available_kernels()) == set(PLAIN + COMPOSITE)


@pytest.mark.parametrize("name", PLAIN)
def test_phi_matches_reference(name):
    r = _r_grid()
    js, jphi = jdelta.get_kernel(name)
    ts, tphi = tdelta.get_kernel(name.lower())
    assert ts == js == tdelta.stencil_size(name)
    assert _rel(jphi(jnp.asarray(r)), tphi(torch.tensor(r))) <= PHI_RTOL


def test_ib6_table_identical_to_reference():
    np.testing.assert_array_equal(tdelta._ib6_table(), jdelta._ib6_table())


@pytest.mark.parametrize("name", PLAIN + COMPOSITE)
def test_kernel_metadata_matches_reference(name):
    assert tdelta.is_composite(name) == jdelta.is_composite(name)
    assert tdelta.stencil_size(name) == jdelta.stencil_size(name)
    ok = True
    try:
        jdelta.validate_gradient_kernel(name)
    except ValueError:
        ok = False
    if ok:
        tdelta.validate_gradient_kernel(name)
    else:
        with pytest.raises(ValueError, match="not C\\^1"):
            tdelta.validate_gradient_kernel(name)
    r = _r_grid()
    for dim in (2, 3):
        for centering in ("cell",) + tuple(range(dim)):
            jspecs = jdelta.get_kernel_axes(name, centering, dim)
            tspecs = tdelta.get_kernel_axes(name, centering, dim)
            assert [s for s, _ in tspecs] == [s for s, _ in jspecs]
            for (_, jphi), (_, tphi) in zip(jspecs, tspecs):
                assert _rel(jphi(jnp.asarray(r)),
                            tphi(torch.tensor(r))) <= PHI_RTOL


def test_kernel_resolution_errors_and_user_pairs():
    for bad in ("IB_5", "gaussian"):
        with pytest.raises(ValueError, match="unknown delta kernel"):
            tdelta.get_kernel(bad)
    for name in COMPOSITE:
        with pytest.raises(ValueError, match="composite"):
            tdelta.get_kernel(name)
        with pytest.raises(ValueError, match="centering"):
            tdelta.get_kernel_axes(name, (0.5, 0.0), 2)
    pair = (4, tdelta.get_kernel("IB_4")[1])
    assert tdelta.get_kernel(pair) == pair and tdelta.stencil_size(pair) == 4
    tdelta.validate_gradient_kernel(pair)        # the caller's contract
    assert [s for s, _ in tdelta.get_kernel_axes(pair, 1, 3)] == [4] * 3
    assert tdelta.cuda_delta("ib_4") == ("IB_4", 0, 4, 0)
    with pytest.raises(NotImplementedError, match="user-defined"):
        tdelta.cuda_delta(pair)


def test_safe_sqrt_gradient_matches_jax():
    # at, below and off the clamp: 1/(2 sqrt(x)) where positive, else 0
    x = np.array([-2.0, -1e-300, 0.0, 1e-300, 1e-12, 0.25, 1.0, 7.5])
    jg = jax.vmap(jax.grad(jdelta._safe_sqrt))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y = tdelta._safe_sqrt(xt)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jdelta._safe_sqrt(x)))
    (g,) = torch.autograd.grad(y.sum(), xt)
    assert np.all(np.isfinite(g.numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-15)


@pytest.mark.parametrize("name", ["IB_3", "IB_4"])
def test_kernel_gradient_is_finite_and_matches_jax(name):
    # the unused branch's sqrt is clamped: plain autograd would give nan;
    # r avoids 0 and the piece knots, where the kinks' one-sided
    # derivatives are a matter of convention
    r = np.random.default_rng(1).uniform(-2.4, 2.4, 501)
    r = r[np.min(np.abs(r[:, None] - np.arange(-5, 6) * 0.5), axis=1) > 1e-6]
    jphi = jdelta.get_kernel(name)[1]
    jg = jax.vmap(jax.grad(jphi))(jnp.asarray(r))
    rt = torch.tensor(r, requires_grad=True)
    (g,) = torch.autograd.grad(tdelta.get_kernel(name)[1](rt).sum(), rt)
    assert np.all(np.isfinite(g.numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("n", [(16, 20), (16, 12, 20)])
@pytest.mark.parametrize("kernel", ["IB_3", "IB_6", "BSPLINE_4",
                                    "COMPOSITE_BSPLINE_43"])
def test_scatter_oracle_matches_reference(kernel, n):
    dim = len(n)
    box = dict(x_lo=(0.0,) * dim, x_up=(1.0,) + (1.25,) * (dim - 1))
    jg, tg = JGrid(n=n, **box), TGrid(n=n, **box)
    rng = np.random.default_rng(dim)
    N = 60
    X = rng.uniform(0, 1, (N, dim)) * np.array(box["x_up"])
    F = rng.standard_normal((N, dim))
    w = (rng.uniform(0, 1, N) > 0.2).astype(float)
    u = [rng.standard_normal(n) for _ in range(dim)]
    Xj, Xt = jnp.asarray(X), torch.tensor(X)
    for a, b in zip(
            jinter.spread_vel(jnp.asarray(F), jg, Xj, kernel=kernel,
                              weights=jnp.asarray(w)),
            tinter.spread_vel(torch.tensor(F), tg, Xt, kernel=kernel,
                              weights=torch.tensor(w))):
        assert _rel(a, b) <= TRANSFER_RTOL
    assert _rel(jinter.interpolate_vel([jnp.asarray(c) for c in u], jg, Xj,
                                       kernel=kernel),
                tinter.interpolate_vel([torch.tensor(c) for c in u], tg, Xt,
                                       kernel=kernel)) <= TRANSFER_RTOL
    # a cell-centered field (composite kernels take the normal order on
    # every axis there)
    assert _rel(jinter.spread(jnp.asarray(F[:, 0]), jg, Xj, kernel=kernel),
                tinter.spread(torch.tensor(F[:, 0]), tg, Xt,
                              kernel=kernel)) <= TRANSFER_RTOL
    assert _rel(jinter.interpolate(jnp.asarray(u[0]), jg, Xj, kernel=kernel),
                tinter.interpolate(torch.tensor(u[0]), tg, Xt,
                                   kernel=kernel)) <= TRANSFER_RTOL


@pytest.mark.parametrize("kernel", ["IB_3", "IB_6", "BSPLINE_3"])
def test_packed_engine_takes_other_deltas(kernel):
    from ibamr_tpu.ops.interaction_packed import PackedInteraction as JPacked
    from ibamr_tpu.ops.interaction_packed import suggest_chunks
    from ibamr_tpu_torch.ops.interaction_packed import \
        PackedInteraction as TPacked

    n = (16, 16, 16)
    box = dict(x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    jg, tg = JGrid(n=n, **box), TGrid(n=n, **box)
    rng = np.random.default_rng(3)
    X = rng.uniform(0, 1, (200, 3))
    F = rng.standard_normal((200, 3))
    u = [rng.standard_normal(n) for _ in range(3)]
    Q = suggest_chunks(jg, X, kernel=kernel, tile=8, chunk=64, slack=1.3)
    je = JPacked(jg, kernel=kernel, tile=8, chunk=64, nchunks=Q)
    te = TPacked(tg, kernel=kernel, tile=8, chunk=64, nchunks=Q,
                 device="cpu")
    jf, jU = jax.jit(lambda F, X, u: (je.spread_vel(F, X),
                                      je.interpolate_vel(u, X)))(
        jnp.asarray(F), jnp.asarray(X), [jnp.asarray(c) for c in u])
    Xt = torch.tensor(X)
    for a, b in zip(jf, te.spread_vel(torch.tensor(F), Xt)):
        assert _rel(a, b) <= TRANSFER_RTOL
    assert _rel(jU, te.interpolate_vel([torch.tensor(c) for c in u],
                                       Xt)) <= TRANSFER_RTOL


@pytest.mark.parametrize("kernel", ["IB_3", "IB_6", "BSPLINE_4",
                                    (4, tdelta.get_kernel("IB_4")[1]),
                                    "COMPOSITE_BSPLINE_43"])
def test_cuda_engines_raise_for_other_deltas(kernel):
    # the kernel engines take every named isotropic delta (their transfers
    # match the scatter oracle's); a user-defined pair and a composite
    # B-spline still raise
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.ops.cuda_interaction import (HybridKernelInteraction,
                                                      PackedKernelInteraction,
                                                      TileKernelInteraction)

    g = TGrid(n=(16,) * 3, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    engines = (PackedKernelInteraction, TileKernelInteraction,
               HybridKernelInteraction)
    if not isinstance(kernel, str):
        for cls in engines:
            with pytest.raises(NotImplementedError, match="user-defined"):
                cls(g, kernel=kernel, device="cpu")
        return
    if kernel.startswith("COMPOSITE"):
        for cls in engines:
            with pytest.raises(ValueError, match="composite"):
                cls(g, kernel=kernel, device="cpu")
        return
    rng = np.random.default_rng(3)
    X = torch.tensor(rng.uniform(0, 1, (60, 3)))
    F = torch.tensor(rng.standard_normal((60, 3)))
    u = [torch.tensor(rng.standard_normal(g.n)) for _ in range(3)]
    f_ref = tinter.spread_vel(F, g, X, kernel=kernel)
    U_ref = tinter.interpolate_vel(u, g, X, kernel=kernel)
    for cls in engines:
        eng = cls(g, kernel=kernel, device="cpu")
        for a, b in zip(f_ref, eng.spread_vel(F, X)):
            assert _rel(a.numpy(), b) <= TRANSFER_RTOL
        assert _rel(U_ref.numpy(), eng.interpolate_vel(u, X)) \
            <= TRANSFER_RTOL
    for engine in ("pallas_packed", "pallas", "hybrid_bf16"):
        integ, _ = build_shell_example(n_cells=16, n_lat=8, n_lon=8,
                                       kernel=kernel,
                                       use_fast_interaction=engine,
                                       device="cpu")
        assert integ.ib.fast.kernel == kernel
