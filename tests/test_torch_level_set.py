"""Port parity of ``physics/level_set.py`` against ibamr_tpu at f64 on the
CPU: the smoothed interface functions, the interface calculus, the
Godunov Hamiltonian, relaxation reinitialization and fast sweeping, on
periodic and walled 2D grids and a 3D grid. The inputs are distorted
circles and seeded random fields (numpy). Every field agrees to 1e-12
relative (roundoff: the same operations in the same order)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.physics import level_set as jls
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.physics import level_set as tls

TOL = 1e-12
# the reference's sweeps compile once per configuration under jit (its
# eager scans compile one program per pass)
_J_FSM = jax.jit(jls.fast_sweeping_distance,
                 static_argnames=("dx", "sweeps", "wall_axes"))
WALLS = [None, (True, False), (True, True)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test (the suite runs in parallel
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref))
                 / max(np.max(np.abs(ref)), 1e-300))


def _distorted_circle(n=(32, 28), R=0.3, c=(0.5, 0.45)):
    """A level set with the circle's zero level and |grad phi| between
    ~0.6 and ~3 (the reference tests' distortion)."""
    xs = [(np.arange(m) + 0.5) / m for m in n]
    X, Y = np.meshgrid(*xs, indexing="ij")
    d = np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2) - R
    return d * (1.0 + 2.0 * d ** 2) * np.exp(0.5 * d)


def _dx(n):
    return tuple(1.0 / m for m in n)


@pytest.mark.parametrize("eps", [0.05, 0.1])
def test_smoothed_interface_functions_match(eps):
    phi = np.random.default_rng(0).uniform(-0.3, 0.3, (24, 20))
    phi[0, :4] = [-eps, eps, 0.0, -2 * eps]
    for fj, ft in ((jls.heaviside, tls.heaviside), (jls.delta, tls.delta)):
        assert _rel(fj(jnp.asarray(phi), eps), ft(torch.tensor(phi), eps)) \
            <= TOL
    jg = JGrid(n=(24, 20), x_lo=(0.0, 0.0), x_up=(1.0, 0.8))
    tg = TGrid(n=(24, 20), x_lo=(0.0, 0.0), x_up=(1.0, 0.8))
    a = float(jls.phase_volume(jnp.asarray(phi), jg, eps))
    b = float(tls.phase_volume(torch.tensor(phi), tg, eps))
    assert abs(a - b) <= TOL * abs(a)


@pytest.mark.parametrize("wall_axes", WALLS)
def test_gradient_norm_and_curvature_match(wall_axes):
    phi = _distorted_circle()
    dx = _dx(phi.shape)
    for fj, ft in ((jls.gradient_norm, tls.gradient_norm),
                   (jls.curvature, tls.curvature)):
        assert _rel(fj(jnp.asarray(phi), dx, wall_axes=wall_axes),
                    ft(torch.tensor(phi), dx, wall_axes=wall_axes)) <= TOL


@pytest.mark.parametrize("wall_axes", WALLS)
def test_godunov_hamiltonian_and_interface_cells_match(wall_axes):
    phi = _distorted_circle()
    dx = _dx(phi.shape)
    sgn = np.random.default_rng(1).uniform(-1.0, 1.0, phi.shape)
    a = jls._godunov_grad_mag(jnp.asarray(phi), dx, jnp.asarray(sgn),
                              wall_axes=wall_axes)
    b = tls._godunov_grad_mag(torch.tensor(phi), dx, torch.tensor(sgn),
                              wall_axes=wall_axes)
    assert _rel(a, b) <= TOL
    # a pool against the wrap: its floor row is an interface cell only
    # across a periodic axis
    pool = phi.copy()
    pool[:, -3:] = -np.abs(pool[:, -3:]) - 0.1
    pool[:, :3] = np.abs(pool[:, :3]) + 0.1
    for p in (phi, pool):
        np.testing.assert_array_equal(
            tls._interface_cells(torch.tensor(p), wall_axes).numpy(),
            np.asarray(jls._interface_cells(jnp.asarray(p), wall_axes)))


@pytest.mark.parametrize("wall_axes", WALLS)
def test_reinitialize_matches(wall_axes):
    phi = _distorted_circle()
    dx = _dx(phi.shape)
    a = jls.reinitialize(jnp.asarray(phi), dx, iters=40,
                         wall_axes=wall_axes)
    b = tls.reinitialize(torch.tensor(phi), dx, iters=40,
                         wall_axes=wall_axes)
    assert _rel(a, b) <= TOL
    # and with an explicit pseudo-time step
    a = jls.reinitialize(jnp.asarray(phi), dx, iters=7, dtau=0.3 / 32)
    b = tls.reinitialize(torch.tensor(phi), dx, iters=7, dtau=0.3 / 32)
    assert _rel(a, b) <= TOL


@pytest.mark.parametrize("wall_axes", WALLS)
def test_fast_sweeping_matches_2d(wall_axes):
    phi = _distorted_circle(n=(32, 32))
    dx = _dx(phi.shape)
    a = _J_FSM(jnp.asarray(phi), dx=dx, wall_axes=wall_axes)
    b = tls.fast_sweeping_distance(torch.tensor(phi), dx,
                                   wall_axes=wall_axes)
    assert _rel(a, b) <= TOL
    a = _J_FSM(jnp.asarray(phi), dx=dx, sweeps=2)
    b = tls.fast_sweeping_distance(torch.tensor(phi), dx, sweeps=2)
    assert _rel(a, b) <= TOL


@pytest.mark.parametrize("wall_axes", [None, (True, False, True)])
def test_fast_sweeping_matches_3d(wall_axes):
    n = (12, 10, 14)
    xs = [(np.arange(m) + 0.5) / 12 for m in n]
    X, Y, Z = np.meshgrid(*xs, indexing="ij")
    phi = np.sqrt((X - 0.5) ** 2 + (Y - 0.4) ** 2 + (Z - 0.6) ** 2) - 0.25
    phi = phi * (1.0 + phi)
    dx = (1.0 / 12,) * 3
    a = _J_FSM(jnp.asarray(phi), dx=dx, wall_axes=wall_axes)
    b = tls.fast_sweeping_distance(torch.tensor(phi), dx,
                                   wall_axes=wall_axes)
    assert _rel(a, b) <= TOL


def test_fast_sweeping_ignores_iters_with_a_warning():
    phi = torch.tensor(_distorted_circle(n=(16, 16)))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = tls.fast_sweeping_distance(phi, _dx((16, 16)), iters=5)
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    torch.testing.assert_close(
        out, tls.fast_sweeping_distance(phi, _dx((16, 16))), rtol=0, atol=0)
