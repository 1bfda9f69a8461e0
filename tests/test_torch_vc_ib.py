"""Port parity of IB structures in two-phase flow: the explicit IB
coupling (``IBExplicitIntegrator`` with a marker membrane, and with the
FE solid ``IBFEMethod``) over the port's ``INSVCStaggeredIntegrator``,
through the ``step(state, dt, f=)`` seam, against ibamr_tpu at f64 on
the CPU. The set-ups are ``tests/test_vc_ib.py``'s (a heavy capsule in
a closed tank, a pre-stretched membrane, a pre-stretched FE disc), cut
to a few steps; both packages transfer through the scatter oracle.
Markers and fields agree to 1e-9 relative (CG at ``cg_tol`` 1e-10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.fe.fem import neo_hookean as jneo
from ibamr_tpu.fe.mesh import disc_mesh as jdisc
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators import ib as jib
from ibamr_tpu.integrators.ibfe import IBFEMethod as JIBFE
from ibamr_tpu.integrators.ins_vc import INSVCStaggeredIntegrator as JVC
from ibamr_tpu.models.membrane2d import make_circle_membrane as jmem
from ibamr_tpu_torch.fe.fem import neo_hookean as tneo
from ibamr_tpu_torch.fe.mesh import disc_mesh as tdisc
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators import ib as tib
from ibamr_tpu_torch.integrators.ibfe import IBFEMethod as TIBFE
from ibamr_tpu_torch.integrators.ins_vc import INSVCStaggeredIntegrator as TVC
from ibamr_tpu_torch.models.membrane2d import make_circle_membrane as tmem

SOLVE = 1e-9
T64 = dict(dtype=torch.float64, device="cpu")


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
    got = got.detach().cpu().numpy()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref))
                 / max(np.max(np.abs(ref)), 1e-300))


def _vc_pair(n, kw):
    jg = JGrid(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    tg = TGrid(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    return (JVC(jg, dtype=jnp.float64, cg_tol=1e-10, **kw),
            TVC(tg, cg_tol=1e-10, **T64, **kw))


def _check(js, ts):
    assert _rel(js.X, ts.X) <= SOLVE
    for a, b in zip(js.ins.u + (js.ins.p, js.ins.phi),
                    ts.ins.u + (ts.ins.p, ts.ins.phi)):
        assert _rel(a, b) <= SOLVE


def _stratified(n):
    y = (np.arange(n) + 0.5) / n
    return np.broadcast_to((0.5 - y)[None, :], (n, n)).copy()


def test_membrane_capsule_in_walled_two_phase_tank_matches():
    """A membrane around a heavy drop in a closed tank (gravity, walls,
    reinitialization at step 3), 4 steps."""
    n = 32
    r0, c0 = 0.12, (0.5, 0.62)
    jvc, tvc = _vc_pair(n, dict(rho0=1.0, rho1=5.0, mu0=0.02, mu1=0.05,
                                gravity=(0.0, -3.0), reinit_interval=3,
                                wall_axes=(True, True)))
    xx = (np.arange(n) + 0.5) / n
    X, Y = np.meshgrid(xx, xx, indexing="ij")
    phi0 = r0 - np.sqrt((X - c0[0]) ** 2 + (Y - c0[1]) ** 2)
    js_, ts_ = jmem(48, r0, c0, stiffness=1.0), tmem(48, r0, c0,
                                                     stiffness=1.0)
    ji = jib.IBExplicitIntegrator(jvc, jib.IBMethod(
        js_.force_specs(dtype=jnp.float64), kernel="IB_4"))
    ti = tib.IBExplicitIntegrator(tvc, tib.IBMethod(
        ts_.force_specs(**T64), kernel="IB_4"))
    js = ji.initialize(jnp.asarray(js_.vertices, jnp.float64),
                       ins_state=jvc.initialize(jnp.asarray(phi0)))
    ts = ti.initialize(ts_.vertices, ins_state=tvc.initialize(phi0))
    js = jib.advance_ib(ji, js, 5e-4, 4)
    ts = tib.advance_ib(ti, ts, 5e-4, 4)
    _check(js, ts)
    assert ts.ins.k == 4


def test_membrane_tension_drives_two_phase_flow_matches():
    """A pre-stretched loop in a quiescent stratified box (no
    convection, reinitialization every step): only the spread force
    through ``f=`` moves the fluid."""
    n = 24
    jvc, tvc = _vc_pair(n, dict(rho0=1.0, rho1=2.0, mu0=0.05, mu1=0.1,
                                convective_op_type="none",
                                reinit_interval=0))
    phi0 = _stratified(n)
    kw = dict(stiffness=5.0, aspect=1.3, rest_length_factor=0.7)
    js_, ts_ = jmem(40, 0.12, (0.5, 0.5), **kw), tmem(40, 0.12, (0.5, 0.5),
                                                      **kw)
    ji = jib.IBExplicitIntegrator(jvc, jib.IBMethod(
        js_.force_specs(dtype=jnp.float64), kernel="IB_4"))
    ti = tib.IBExplicitIntegrator(tvc, tib.IBMethod(
        ts_.force_specs(**T64), kernel="IB_4"))
    js = jib.advance_ib(ji, ji.initialize(
        jnp.asarray(js_.vertices, jnp.float64),
        ins_state=jvc.initialize(jnp.asarray(phi0))), 5e-4, 4)
    ts = tib.advance_ib(ti, ti.initialize(
        ts_.vertices, ins_state=tvc.initialize(phi0)), 5e-4, 4)
    _check(js, ts)
    assert max(float(torch.max(torch.abs(c))) for c in ts.ins.u) > 1e-6


def test_fe_capsule_in_two_phase_fluid_matches():
    """The FE disc of ``tests/test_vc_ib.py::test_fe_capsule_in_two_phase
    _fluid`` (neo-Hookean, pre-stretched), 4 steps."""
    n = 24
    jvc, tvc = _vc_pair(n, dict(rho0=1.0, rho1=2.0, mu0=0.05, mu1=0.1,
                                convective_op_type="none",
                                reinit_interval=0))
    phi0 = _stratified(n)
    jm = jdisc(radius=0.1, center=(0.5, 0.5), n_rings=3)
    tm = tdisc(radius=0.1, center=(0.5, 0.5), n_rings=3)
    S = np.diag([1.1, 1.0 / 1.1])
    X0 = (np.asarray(jm.nodes) - 0.5) @ S.T + 0.5
    ji = jib.IBExplicitIntegrator(jvc, JIBFE(jm, jneo(1.0, 4.0),
                                             kernel="IB_4",
                                             dtype=jnp.float64))
    ti = tib.IBExplicitIntegrator(tvc, TIBFE(tm, tneo(1.0, 4.0),
                                             kernel="IB_4", **T64))
    js = jib.advance_ib(ji, ji.initialize(
        jnp.asarray(X0), ins_state=jvc.initialize(jnp.asarray(phi0))),
        1e-3, 4)
    ts = tib.advance_ib(ti, ti.initialize(
        X0, ins_state=tvc.initialize(phi0)), 1e-3, 4)
    _check(js, ts)
