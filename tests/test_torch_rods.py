"""Port parity of the Kirchhoff rods (``ops/rods.py``) and the generalized
IB coupling (``integrators/gib.py``) against ibamr_tpu at f64 on the CPU,
on the set-ups of ``tests/test_rods.py`` with perturbations from a numpy
seed: strains and energy to 1e-12 relative, force and torque (PyTorch
autograd against ``jax.grad``) to 1e-12 relative, ``rodrigues`` through
its small-angle series, the couple force to 1e-12, and the twisted rod's
``advance_gib`` on 24^3 for 10 steps: X and the director frames within
1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators import gib as jgib
from ibamr_tpu.integrators.ins import INSStaggeredIntegrator as JINS
from ibamr_tpu.io.structures import StructureData as JData
from ibamr_tpu.ops import rods as jrods
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators import gib as tgib
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator as TINS
from ibamr_tpu_torch.io.structures import StructureData as TData
from ibamr_tpu_torch.ops import rods as trods


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores (these files run 2-3x faster single-threaded there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-12


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                 1e-300))


def _chain(n, ds, b=1.0, kappa=0.0, s=10.0):
    idx = np.arange(n - 1)
    return (jrods.make_rods(idx, idx + 1, b, kappa, s, ds,
                            dtype=jnp.float64),
            trods.make_rods(idx, idx + 1, b, kappa, s, ds,
                            dtype=torch.float64, device="cpu"))


def _perturbed_rod(n=12, L=1.1, seed=1, kappa=0.3):
    rng = np.random.default_rng(seed)
    X, D = jrods.straight_rod(n, L, dtype=jnp.float64)
    X = X + 0.05 * jnp.asarray(rng.standard_normal((n, 3)))
    D = jrods.rotate_frames(D, 0.2 * jnp.asarray(rng.standard_normal((n, 3))))
    js, ts = _chain(n, L / (n - 1), kappa=kappa)
    return X, D, js, ts


def test_straight_rod_matches_reference():
    jX, jD = jrods.straight_rod(8, 0.7, origin=(0.1, 0.2, 0.3),
                                axis=(1.0, 1.0, 0.5), dtype=jnp.float64)
    tX, tD = trods.straight_rod(8, 0.7, origin=(0.1, 0.2, 0.3),
                                axis=(1.0, 1.0, 0.5), dtype=torch.float64,
                                device="cpu")
    assert _rel(jX, tX) == 0.0 and _rel(jD, tD) == 0.0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_strains_energy_force_torque_match_reference(seed):
    X, D, js, ts = _perturbed_rod(seed=seed)
    tX, tD = torch.tensor(np.asarray(X)), torch.tensor(np.asarray(D))
    assert _rel(jrods.edge_frames(D, js), trods.edge_frames(tD, ts)) <= TOL
    for a, b in zip(jrods.rod_strains(X, D, js),
                    trods.rod_strains(tX, tD, ts)):
        assert _rel(a, b) <= TOL
    assert _rel(jrods.rod_energy(X, D, js), trods.rod_energy(tX, tD, ts)) \
        <= TOL
    for a, b in zip(jrods.rod_force_torque(X, D, js),
                    trods.rod_force_torque(tX, tD, ts)):
        assert _rel(a, b) <= TOL
    with torch.no_grad():
        F, N = trods.rod_force_torque(tX, tD, ts)
    assert np.allclose(F.sum(0).numpy(), 0.0, atol=1e-10)


def test_quaternions_match_reference():
    rng = np.random.default_rng(4)
    R = np.asarray(jrods.rodrigues(jnp.asarray(
        0.7 * rng.standard_normal((20, 3)))))
    q = jrods._quat_from_rot(jnp.asarray(R))
    assert _rel(q, trods._quat_from_rot(torch.tensor(R))) <= TOL
    assert _rel(jrods._rot_from_quat(q),
                trods._rot_from_quat(torch.tensor(np.asarray(q)))) <= TOL


def test_rodrigues_matches_reference_near_zero():
    w = np.concatenate([
        np.zeros((1, 3)), 1e-12 * np.ones((1, 3)), [[3e-9, 0.0, -4e-9]],
        [[2e-8, 0.0, 0.0]],
        0.5 * np.random.default_rng(2).standard_normal((5, 3))])
    ref = jrods.rodrigues(jnp.asarray(w))
    got = trods.rodrigues(torch.tensor(w))
    assert _rel(ref, got) <= TOL
    assert torch.equal(got[0], torch.eye(3, dtype=torch.float64))
    # away from w = 0 the derivatives agree; at w = 0 exactly the
    # reference's is NaN (the norm's derivative at 0) and PyTorch's the
    # exact generator d exp([w]_x)/dw_k = [e_k]_x
    w0 = jnp.asarray([1e-3, -2e-3, 5e-4])
    gj = jax.jacfwd(jrods.rodrigues)(w0)
    gt = torch.autograd.functional.jacobian(
        trods.rodrigues, torch.tensor(np.asarray(w0)))
    assert _rel(gj, gt) <= TOL
    assert bool(jnp.all(jnp.isnan(jax.jacfwd(jrods.rodrigues)(
        jnp.zeros(3)))))
    g0 = torch.autograd.functional.jacobian(
        trods.rodrigues, torch.zeros(3, dtype=torch.float64))
    skew = torch.zeros(3, 3, 3, dtype=torch.float64)   # [e_k]_x
    for k, (a, b) in enumerate(((2, 1), (0, 2), (1, 0))):
        skew[k, a, b], skew[k, b, a] = 1.0, -1.0
    assert torch.equal(g0.permute(2, 0, 1), skew)


def test_couple_force_matches_reference():
    kw = dict(n=(16, 16, 16), x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    rng = np.random.default_rng(3)
    n_cc = [rng.standard_normal((16, 16, 16)) for _ in range(3)]
    ref = jgib.couple_force_mac(tuple(jnp.asarray(c) for c in n_cc),
                                JGrid(**kw))
    got = tgib.couple_force_mac(tuple(torch.tensor(c) for c in n_cc),
                                TGrid(**kw))
    for a, b in zip(ref, got):
        assert _rel(a, b) <= TOL


def test_rod_specs_from_a_structure_table():
    rods = np.array([[0, 1, 0.1, 1.0, 1.0, 0.5, 5.0, 5.0, 10.0, 0.0, 0.2,
                      0.3], [1, 2, 0.1, 1.0, 1.0, 0.5, 5.0, 5.0, 10.0, 0.0,
                             0.2, 0.3]])
    verts = np.zeros((3, 3))
    js = JData(name="r", vertices=verts, rods=rods,
               index_offset=4).rod_specs(dtype=jnp.float64)
    ts = TData(name="r", vertices=verts, rods=rods,
               index_offset=4).rod_specs(dtype=torch.float64, device="cpu")
    for a, b in zip(js, ts):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert TData(name="r", vertices=verts).rod_specs(device="cpu") is None
    for a, b in zip(js, convert.rod_specs(js, "cpu")):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_twisted_rod_gib_matches_reference():
    kw = dict(n=(24, 24, 24), x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    n, L, rate = 12, 0.4, 3.0
    X, D = jrods.straight_rod(n, L, origin=(0.5, 0.5, 0.3),
                              dtype=jnp.float64)
    w = jnp.stack([jnp.zeros(n), jnp.zeros(n),
                   rate * jnp.arange(n) * L / (n - 1)], axis=-1)
    D = jrods.rotate_frames(D, w)
    js, ts = _chain(n, L / (n - 1), b=0.05, s=5.0)
    jm = jgib.GeneralizedIBMethod(
        JINS(JGrid(**kw), rho=1.0, mu=0.1, convective_op_type="none",
             dtype=jnp.float64), js)
    tm = tgib.GeneralizedIBMethod(
        TINS(TGrid(**kw), rho=1.0, mu=0.1, convective_op_type="none",
             dtype=torch.float64, device="cpu"), ts)
    jst = jm.initialize(X, D)
    tst = convert.gib_state(jst, "cpu")
    assert _rel(jm.energy(jst), tm.energy(tst)) <= TOL
    jst = jgib.advance_gib(jm, jst, 5e-4, 10)
    tst = tgib.advance_gib(tm, tst, 5e-4, 10)
    assert _rel(jst.X, tst.X) <= 1e-10
    assert _rel(jst.D, tst.D) <= 1e-10
    assert _rel(jm.energy(jst), tm.energy(tst)) <= 1e-10
    assert float(tm.energy(tst)) < float(jm.energy(jm.initialize(X, D)))


def test_gib_requires_3d():
    g2 = TGrid(n=(8, 8), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    with pytest.raises(ValueError, match="3D"):
        tgib.GeneralizedIBMethod(TINS(g2, device="cpu"), None)
