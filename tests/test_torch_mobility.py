"""Port parity of ``solvers/mobility.py`` at f64: the dense RPY (3D, with
overlapping and coincident markers) and blob (2D) mobility matrices
within 1e-13, the ``DirectMobilitySolver`` (solve, body resistance),
the ``KrylovMobilitySolver`` (iteration counts equal) and the
``KrylovFreeBodyMobilitySolver`` on the exact periodic mobility within
1e-8 of max|ref| (CG- and FGMRES-solved quantities)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators import cib as jc
from ibamr_tpu.solvers import mobility as jmob
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators import cib as tc
from ibamr_tpu_torch.solvers import mobility as tmob


def _close(ref, got, tol):
    ref = np.asarray(ref, dtype=float)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=float)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= tol * max(np.max(np.abs(ref)), 1e-300)


def test_rpy_matrix_matches_reference_with_overlaps():
    X = np.asarray(jc.make_sphere((0.5,) * 3, 0.1, 3, 5))
    X = np.concatenate([X, X[:1], X[:1] + 0.01])   # coincident, overlapping
    for a in (0.02, 0.05):
        ref = np.asarray(jmob.rpy_mobility_matrix(jnp.asarray(X), a, 1.3))
        got = tmob.rpy_mobility_matrix(torch.tensor(X), a, 1.3)
        assert np.all(np.isfinite(ref))
        _close(ref, got, 1e-13)
        _close(ref, tmob.dense_mobility_matrix(torch.tensor(X), a, 1.3),
               1e-13)
    with pytest.raises(ValueError, match="3D tensor"):
        tmob.rpy_mobility_matrix(torch.zeros(3, 2, dtype=torch.float64),
                                 0.1, 1.0)


def test_blob_matrix_and_direct_solver_match_reference():
    X = np.asarray(jc.make_disc((0.5, 0.5), 0.2, 16))
    ref = jmob.DirectMobilitySolver(jnp.asarray(X), 0.05, 1.0)
    got = tmob.DirectMobilitySolver(torch.tensor(X), 0.05, 1.0)
    _close(ref.matrix(), got.matrix(), 1e-13)
    rhs = np.random.default_rng(0).standard_normal(X.shape)
    _close(ref.apply(jnp.asarray(rhs)), got.apply(torch.tensor(rhs)), 1e-13)
    _close(ref.solve(jnp.asarray(rhs)), got.solve(torch.tensor(rhs)), 1e-9)
    bodies = jc.RigidBodies(body_id=jnp.zeros(16, jnp.int32), n_bodies=1)
    _close(ref.body_resistance(bodies),
           got.body_resistance(convert.rigid_bodies(bodies, "cpu")), 1e-9)
    with pytest.raises(ValueError, match="2D tensor"):
        tmob.blob_mobility_matrix(torch.zeros(3, 3, dtype=torch.float64),
                                  0.1, 1.0)


def _exact_mobility(n_markers=12):
    g = dict(n=(16, 16), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    X = np.asarray(jc.make_disc((0.5, 0.5), 0.2, n_markers))
    bodies = jc.RigidBodies(body_id=jnp.zeros(n_markers, jnp.int32),
                            n_bodies=1)
    jm = jc.CIBMethod(JGrid(**g), bodies, cg_tol=1e-10)
    tm = tc.CIBMethod(TGrid(**g), convert.rigid_bodies(bodies, "cpu"),
                      cg_tol=1e-10, device="cpu")
    return X, bodies, jm, tm


def test_krylov_mobility_solver_matches_reference():
    X, _, jm, tm = _exact_mobility()
    jX, tX = jnp.asarray(X), torch.tensor(X)
    rhs = np.random.default_rng(1).standard_normal(X.shape)
    for pre in (False, True):
        jp = jmob.DirectMobilitySolver(jX, 1.0 / 16, 1.0) if pre else None
        tp = tmob.DirectMobilitySolver(tX, 1.0 / 16, 1.0) if pre else None
        ref = jmob.KrylovMobilitySolver(lambda v: jm.mobility_apply(jX, v),
                                        jp, tol=1e-10).solve(jnp.asarray(rhs))
        got = tmob.KrylovMobilitySolver(lambda v: tm.mobility_apply(tX, v),
                                        tp, tol=1e-10).solve(
            torch.tensor(rhs))
        assert got.iters == int(ref.iters) and bool(got.converged)
        _close(ref.x, got.x, 1e-8)


def test_krylov_free_body_solver_matches_reference():
    X, bodies, jm, tm = _exact_mobility()
    FT = np.array([[0.2, -1.0, 0.05]])
    ref = jm.free_body_solver(jnp.asarray(X), 1.0 / 16).solve(
        jnp.asarray(FT))
    got = tm.free_body_solver(torch.tensor(X), 1.0 / 16).solve(
        torch.tensor(FT))
    assert got.iters == int(ref.iters) and bool(got.converged)
    _close(ref.U, got.U, 1e-8)
    _close(ref.lam, got.lam, 1e-8)
    Xr, Ur, _ = jm.step_krylov(jnp.asarray(X), jnp.asarray(FT), 0.01,
                               1.0 / 16)
    Xt, Ut, _ = tm.step_krylov(torch.tensor(X), torch.tensor(FT), 0.01,
                               1.0 / 16)
    _close(Ur, Ut, 1e-8)
    _close(Xr, Xt, 1e-12)
