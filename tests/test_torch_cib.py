"""Port parity of ``integrators/cib.py`` at f64: the rigid-mode maps,
``mobility_apply`` within 1e-10 of max|ref|; ``resistance_matrix`` (the CG
iteration counts equal column by column), ``solve_mobility``,
``solve_constraint``, the quasi-static ``step`` and
``advance_free_bodies`` on both routes (5 steps) within 1e-8: at the
reference's CG tolerance of 1e-9 the iterates carry roundoff amplified by
the mobility's conditioning (3e-10 relative seen); on the periodic box,
and the walled domain (the nested saddle FGMRES) at 16^2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators import cib as jc
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators import cib as tc


def _close(ref, got, tol=1e-10):
    ref = np.asarray(ref, dtype=float)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=float)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= tol * max(np.max(np.abs(ref)), 1e-300)



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _two_discs(n_markers=8):
    """Two disc bodies, (2N, 2) markers with their body ids."""
    a = np.asarray(jc.make_disc((0.35, 0.5), 0.12, n_markers))
    b = np.asarray(jc.make_disc((0.68, 0.45), 0.1, n_markers))
    X = np.concatenate([a, b])
    bid = np.repeat([0, 1], n_markers).astype(np.int32)
    return X, jc.RigidBodies(body_id=jnp.asarray(bid), n_bodies=2)


def _methods(n, domain="periodic", bodies=None, **kw):
    g = dict(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    kw = dict(mu=1.3, cg_tol=1e-9, cg_maxiter=200, domain=domain, **kw)
    return (jc.CIBMethod(JGrid(**g), bodies, **kw),
            tc.CIBMethod(TGrid(**g), convert.rigid_bodies(bodies, "cpu"),
                         device="cpu", **kw))


def test_rigid_maps_and_adjoint():
    X, bodies = _two_discs()
    tb = convert.rigid_bodies(bodies, "cpu")
    rng = np.random.default_rng(0)
    U = rng.standard_normal((2, 3))
    lam = rng.standard_normal(X.shape)
    _close(jc.body_centroids(jnp.asarray(X), bodies),
           tc.body_centroids(torch.tensor(X), tb), 1e-14)
    KU = tc.rigid_velocity(torch.tensor(X), tb, torch.tensor(U))
    _close(jc.rigid_velocity(jnp.asarray(X), bodies, jnp.asarray(U)), KU,
           1e-14)
    KtL = tc.rigid_force_torque(torch.tensor(X), tb, torch.tensor(lam))
    _close(jc.rigid_force_torque(jnp.asarray(X), bodies, jnp.asarray(lam)),
           KtL, 1e-14)
    # <K U, lam> == <U, K^T lam>
    assert abs(float((KU * torch.tensor(lam)).sum())
               - float((torch.tensor(U) * KtL).sum())) <= 1e-13
    # 3D: a sphere's modes
    S = np.asarray(jc.make_sphere((0.5,) * 3, 0.2, 4, 6))
    _close(S, tc.make_sphere((0.5,) * 3, 0.2, 4, 6, device="cpu"), 1e-15)
    b3 = jc.RigidBodies(body_id=jnp.zeros(len(S), jnp.int32), n_bodies=1)
    U3 = rng.standard_normal((1, 6))
    lam3 = rng.standard_normal(S.shape)
    tb3 = convert.rigid_bodies(b3, "cpu")
    _close(jc.rigid_velocity(jnp.asarray(S), b3, jnp.asarray(U3)),
           tc.rigid_velocity(torch.tensor(S), tb3, torch.tensor(U3)), 1e-14)
    _close(jc.rigid_force_torque(jnp.asarray(S), b3, jnp.asarray(lam3)),
           tc.rigid_force_torque(torch.tensor(S), tb3, torch.tensor(lam3)),
           1e-14)
    assert tc.n_rigid_modes(2) == 3 and tc.n_rigid_modes(3) == 6


def test_periodic_mobility_solves_match_reference():
    X, bodies = _two_discs()
    jm, tm = _methods(16, bodies=bodies)
    jX, tX = jnp.asarray(X), torch.tensor(X)
    lam = np.random.default_rng(1).standard_normal(X.shape)
    _close(jm.mobility_apply(jX, jnp.asarray(lam)),
           tm.mobility_apply(tX, torch.tensor(lam)))
    tol = 1e-8
    R, Lam, info = jax.jit(jm.resistance_matrix)(jX)
    tR, tLam, tinfo = tm.resistance_matrix(tX)
    _close(R, tR, tol)
    _close(Lam, tLam, tol)
    assert tinfo.max_iters == int(info.max_iters)
    assert bool(tinfo.converged) == bool(info.converged)
    FT = np.array([[0.0, -1.0, 0.1], [0.3, 0.0, 0.0]])
    U, lamj, _ = jax.jit(jm.solve_mobility)(jX, jnp.asarray(FT))
    tU, tlam, _ = tm.solve_mobility(tX, torch.tensor(FT))
    _close(U, tU, tol)
    _close(lamj, tlam, tol)
    Xn, Us, _ = jax.jit(lambda x: jm.step(x, jnp.asarray(FT), 0.01))(jX)
    tXn, tUs, _ = tm.step(tX, torch.tensor(FT), 0.01)
    _close(Xn, tXn, 1e-12)
    Up = np.array([[1.0, 0.0, 0.5], [0.0, -0.4, 0.0]])
    lc, FTc, ic = jax.jit(jm.solve_constraint)(jX, jnp.asarray(Up))
    tlc, tFTc, tic = tm.solve_constraint(tX, torch.tensor(Up))
    _close(lc, tlc, tol)
    _close(FTc, tFTc, tol)
    assert tic.max_iters == int(ic.max_iters) and bool(tic.converged)


@pytest.mark.parametrize("krylov", [False, True])
def test_advance_free_bodies_matches_reference(krylov):
    X = np.asarray(jc.make_disc((0.5, 0.6), 0.15, 10))
    bodies = jc.RigidBodies(body_id=jnp.zeros(10, jnp.int32), n_bodies=1)
    jm, tm = _methods(16, bodies=bodies)
    radius = 1.0 / 16 if krylov else None

    def jft(t, c):
        return jnp.stack([0.2 * t + jnp.zeros(1), -1.0 - c[:, 0],
                          0.1 * jnp.ones(1)], axis=1)

    def tft(t, c):
        return torch.stack([0.2 * t + torch.zeros(1, dtype=c.dtype),
                            -1.0 - c[:, 0],
                            0.1 * torch.ones(1, dtype=c.dtype)], dim=1)

    ref = jc.advance_free_bodies(jm, jnp.asarray(X), jft, 0.01, 5,
                                 radius=radius)
    got = tc.advance_free_bodies(tm, torch.tensor(X), tft, 0.01, 5,
                                 radius=radius)
    tol = 1e-8
    _close(ref.X, got.X, tol)
    _close(ref.centroids, got.centroids, tol)
    _close(ref.U, got.U, tol)


def test_walled_mobility_apply_matches_reference():
    X = np.asarray(jc.make_disc((0.5, 0.5), 0.2, 8))
    bodies = jc.RigidBodies(body_id=jnp.zeros(8, jnp.int32), n_bodies=1)
    jm, tm = _methods(16, "walled", bodies)
    lam = np.random.default_rng(2).standard_normal(X.shape)
    _close(jax.jit(jm.mobility_apply)(jnp.asarray(X), jnp.asarray(lam)),
           tm.mobility_apply(torch.tensor(X), torch.tensor(lam)), 1e-9)
    assert tm._stokes.last_solve_stats["iters"] >= 1


@pytest.mark.slow
def test_walled_solve_constraint_matches_reference():
    X = np.asarray(jc.make_disc((0.5, 0.5), 0.2, 8))
    bodies = jc.RigidBodies(body_id=jnp.zeros(8, jnp.int32), n_bodies=1)
    jm, tm = _methods(16, "walled", bodies)
    U = np.array([[1.0, 0.0, 0.0]])
    lam, FT, info = jax.jit(jm.solve_constraint)(jnp.asarray(X),
                                                 jnp.asarray(U))
    tlam, tFT, tinfo = tm.solve_constraint(torch.tensor(X), torch.tensor(U))
    assert bool(info.converged) and bool(tinfo.converged)
    assert tinfo.max_iters == int(info.max_iters)
    _close(lam, tlam, 1e-8)
    _close(FT, tFT, 1e-8)


def test_make_disc_in_f32_as_the_reference_computes_it():
    with jax.enable_x64(False):
        ref = np.asarray(jc.make_disc((0.5, 0.7), 0.1, 48))
    got = tc.make_disc((0.5, 0.7), 0.1, 48, dtype=torch.float32,
                       device="cpu")
    assert got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-7


def test_unknown_domain_raises():
    with pytest.raises(ValueError, match="unknown CIB domain"):
        tc.CIBMethod(TGrid(n=(8, 8), x_lo=(0.0, 0.0), x_up=(1.0, 1.0)),
                     None, domain="open", device="cpu")
