"""Port parity of the kernel-gradient transfers of ``ops/interaction.py``
(``interpolate_vel_and_gradient``, ``interpolate_gradient_vel``,
``spread_stress``) against ibamr_tpu at f64 on the CPU, for every C^1
kernel in 2D and 3D, with random markers from a numpy seed plus markers
exactly on the kernels' knots (r = 0, +-1/2, +-1, ... in grid units):
within 1e-13 relative. The kernels that are not C^1 raise as in the
reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.ops import interaction as jint
from ibamr_tpu.ops.delta import get_kernel as jget_kernel
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.ops import interaction as tint
from ibamr_tpu_torch.ops.delta import get_kernel as tget_kernel


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores (these files run 2-3x faster single-threaded there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-13
C1 = ["COSINE", "BSPLINE_3", "BSPLINE_4", "BSPLINE_5", "BSPLINE_6",
      "COMPOSITE_BSPLINE_43", "COMPOSITE_BSPLINE_54"]


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                 1e-300))


def _setup(dim, seed=0):
    n = (16, 12, 10)[:dim]
    lo, up = (0.0,) * dim, (1.0, 0.75, 0.625)[:dim]
    rng = np.random.default_rng(seed)
    X = 0.1 + 0.5 * rng.random((30, dim))
    # knot markers: on a cell center (r = 0 in the cell-centered axes),
    # on a face (r = 0 on the face axis), a half and a quarter between
    h = 1.0 / 16
    knots = np.array([[0.5 * h, 0.5 * h, 0.5 * h],
                      [4 * h, 3 * h, 2 * h],
                      [4.5 * h, 3.5 * h, 5.0 * h],
                      [6.25 * h, 2.75 * h, 3.5 * h]])[:, :dim]
    X = np.concatenate([X, knots])
    u = [rng.standard_normal(n) for _ in range(dim)]
    return (JGrid(n=n, x_lo=lo, x_up=up), TGrid(n=n, x_lo=lo, x_up=up), X, u,
            rng)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kernel", C1)
def test_velocity_and_gradient_match_reference(dim, kernel):
    jg, tg, X, u, rng = _setup(dim)
    w = rng.random(len(X))
    ju, tu = tuple(jnp.asarray(c) for c in u), tuple(torch.tensor(c)
                                                     for c in u)
    jU, jG = jint.interpolate_vel_and_gradient(ju, jg, jnp.asarray(X),
                                               kernel=kernel,
                                               weights=jnp.asarray(w))
    tU, tG = tint.interpolate_vel_and_gradient(tu, tg, torch.tensor(X),
                                               kernel=kernel,
                                               weights=torch.tensor(w))
    assert _rel(jU, tU) <= TOL and _rel(jG, tG) <= TOL
    # the reference defines the gradient alone as the fused call's G
    tG2 = tint.interpolate_gradient_vel(tu, tg, torch.tensor(X),
                                        kernel=kernel,
                                        weights=torch.tensor(w))
    assert _rel(jG, tG2) <= TOL


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kernel", C1)
def test_spread_stress_matches_reference(dim, kernel):
    jg, tg, X, _, rng = _setup(dim, seed=1)
    PFt = rng.standard_normal((len(X), dim, dim))
    V = rng.random(len(X)) + 0.5
    w = (rng.random(len(X)) > 0.2).astype(np.float64)
    ref = jint.spread_stress(jnp.asarray(PFt), jnp.asarray(V), jg,
                             jnp.asarray(X), kernel=kernel,
                             weights=jnp.asarray(w))
    got = tint.spread_stress(torch.tensor(PFt), torch.tensor(V), tg,
                             torch.tensor(X), kernel=kernel,
                             weights=torch.tensor(w))
    for a, b in zip(ref, got):
        assert _rel(a, b) <= TOL
        assert abs(float(torch.sum(b))) <= 1e-12 * float(torch.sum(
            torch.abs(b)))


def test_user_kernel_pair_matches_reference():
    jg, tg, X, u, _ = _setup(2)
    jU, jG = jint.interpolate_vel_and_gradient(
        tuple(jnp.asarray(c) for c in u), jg, jnp.asarray(X),
        kernel=jget_kernel("BSPLINE_3"))
    tU, tG = tint.interpolate_vel_and_gradient(
        tuple(torch.tensor(c) for c in u), tg, torch.tensor(X),
        kernel=tget_kernel("BSPLINE_3"))
    assert _rel(jU, tU) <= TOL and _rel(jG, tG) <= TOL


@pytest.mark.parametrize("bad", ["IB_3", "IB_4", "IB_6", "PIECEWISE_LINEAR",
                                 "BSPLINE_2", "COMPOSITE_BSPLINE_32"])
def test_non_c1_kernels_raise_as_in_reference(bad):
    jg, tg, X, u, _ = _setup(2)
    with pytest.raises(ValueError, match="C\\^1"):
        jint.interpolate_vel_and_gradient(tuple(jnp.asarray(c) for c in u),
                                          jg, jnp.asarray(X), kernel=bad)
    with pytest.raises(ValueError, match="C\\^1"):
        tint.interpolate_vel_and_gradient(tuple(torch.tensor(c) for c in u),
                                          tg, torch.tensor(X), kernel=bad)
    with pytest.raises(ValueError, match="C\\^1"):
        tint.spread_stress(torch.zeros(len(X), 2, 2), torch.ones(len(X)),
                           tg, torch.tensor(X), kernel=bad)
