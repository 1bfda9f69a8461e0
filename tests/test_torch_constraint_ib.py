"""Port parity of ``integrators/constraint_ib.py`` at f64:
``project_rigid`` in 2D and 3D within 1e-12, and 10 steps of
``ConstraintIBMethod`` (deformation kinematics, a density ratio with
gravity, prescribed DOFs) from the same converted state within 1e-10 of
max|ref|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators import cib as jc
from ibamr_tpu.integrators import constraint_ib as jci
from ibamr_tpu.integrators.ins import INSStaggeredIntegrator as JINS
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators import constraint_ib as tci
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator as TINS


def _close(ref, got, tol):
    ref = np.asarray(ref, dtype=float)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=float)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= tol * max(np.max(np.abs(ref)), 1e-300)


@pytest.mark.parametrize("dim", [2, 3])
def test_project_rigid_matches_reference(dim):
    rng = np.random.default_rng(dim)
    X = rng.random((30, dim))
    U = rng.standard_normal((30, dim))
    bid = np.repeat([0, 1, 2], 10).astype(np.int32)
    bodies = jc.RigidBodies(body_id=jnp.asarray(bid), n_bodies=3)
    ref = jci.project_rigid(jnp.asarray(X), bodies, jnp.asarray(U))
    got = tci.project_rigid(torch.tensor(X),
                            convert.rigid_bodies(bodies, "cpu"),
                            torch.tensor(U))
    _close(ref, got, 1e-12)


def test_fill_disc_matches_reference():
    ref = np.asarray(jci.fill_disc((0.4, 0.6), 0.1, 0.02,
                                   dtype=jnp.float64))
    got = tci.fill_disc((0.4, 0.6), 0.1, 0.02, dtype=torch.float64,
                        device="cpu")
    assert np.array_equal(got.numpy(), ref)


def _pair(**kw):
    g = dict(n=(32, 32), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    jins = JINS(JGrid(**g), mu=0.02, dtype=jnp.float64)
    tins = TINS(TGrid(**g), mu=0.02, dtype=torch.float64, device="cpu")
    a = np.asarray(jci.fill_disc((0.35, 0.5), 0.08, 0.015,
                                 dtype=jnp.float64))
    b = np.asarray(jci.fill_disc((0.7, 0.45), 0.06, 0.015,
                                 dtype=jnp.float64))
    X0 = np.concatenate([a, b])
    bid = np.r_[np.zeros(len(a)), np.ones(len(b))].astype(np.int32)
    bodies = jc.RigidBodies(body_id=jnp.asarray(bid), n_bodies=2)
    s = jnp.asarray(X0[:, 0])

    def jdef(t, X):
        return jnp.stack([0.0 * s, 0.3 * jnp.sin(6.0 * s - 4.0 * t)], axis=1)

    ts = torch.tensor(X0[:, 0])

    def tdef(t, X):
        return torch.stack([0.0 * ts, 0.3 * torch.sin(6.0 * ts - 4.0 * t)],
                           dim=1)

    jm = jci.ConstraintIBMethod(jins, bodies, deformation_fn=jdef, **kw)
    tm = tci.ConstraintIBMethod(tins, convert.rigid_bodies(bodies, "cpu"),
                                deformation_fn=tdef, **kw)
    return jm, tm, X0


@pytest.mark.parametrize("case", ["free", "inertial", "prescribed"])
def test_ten_steps_match_reference(case):
    kw = {"free": {},
          "inertial": dict(density_ratio=[2.0, 0.5], gravity=[0.0, -1.0]),
          "prescribed": dict(free=np.array([[1, 0, 1], [0, 1, 1]]))}[case]
    if case == "prescribed":
        jm, tm, X0 = _pair(prescribed_fn=lambda t: np.array(
            [[0.0, 0.1, 0.0], [-0.2, 0.0, 0.0]]), **kw)
    else:
        jm, tm, X0 = _pair(**kw)
    jst = jm.initialize(X0)
    tst = convert.constraint_ib_state(jst, device="cpu")
    _close(jst.X, tm.initialize(X0).X, 0.0)
    step = jax.jit(lambda s: jm.step(s, 2e-3))
    for _ in range(10):
        jst = step(jst)
        tst = tm.step(tst, 2e-3)
    _close(jst.X, tst.X, 1e-10)
    _close(jst.U_body, tst.U_body, 1e-10)
    for a, b in zip(jst.ins.u, tst.ins.u):
        _close(a, b, 1e-10)
    _close(jst.ins.p, tst.ins.p, 1e-10)
    assert float(tst.ins.t) == pytest.approx(float(jst.ins.t), abs=1e-15)


def test_advance_is_a_loop_of_steps():
    jm, tm, X0 = _pair()
    s = tm.initialize(X0)
    a = tci.advance_constraint_ib(tm, s, 1e-3, 3)
    for _ in range(3):
        s = tm.step(s, 1e-3)
    assert torch.equal(a.X, s.X) and torch.equal(a.U_body, s.U_body)
    with pytest.raises(ValueError, match="gravity without density_ratio"):
        tci.ConstraintIBMethod(tm.ins, tm.bodies, gravity=[0.0, -1.0])
