"""Port parity of ``integrators/ins_vc.py`` (the periodic two-phase
integrator, both forms) against ibamr_tpu at f64 on the CPU: the
variable-density projection with each preconditioner and face rule, the
viscous and interface forces, steps of a heavy drop with surface
tension and gravity (the reference's ``advance_vc`` scan), the
conservative form with its density resync, the reinitialization
cadence and the heavy-phase volume's sign rule. Inputs are built with
numpy from a seed. Explicit operators agree to 1e-12 relative; fields
that pass through CG at ``cg_tol`` 1e-10 agree to 1e-9 relative, with
the CG counts equal (or within one, the known fact "CG at its
tolerance")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators import ins_vc as jvc
from ibamr_tpu.solvers import krylov as jkrylov
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators import ins_vc as tvc

EXACT = 1e-12
SOLVE = 1e-9


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


def _pair(n, kw, x_up=None, cons=False):
    x_up = x_up or (1.0,) * len(n)
    jg = JGrid(n=n, x_lo=(0.0,) * len(n), x_up=x_up)
    tg = TGrid(n=n, x_lo=(0.0,) * len(n), x_up=x_up)
    jc = jvc.INSVCConservativeIntegrator if cons \
        else jvc.INSVCStaggeredIntegrator
    tc = tvc.INSVCConservativeIntegrator if cons \
        else tvc.INSVCStaggeredIntegrator
    return (jc(jg, dtype=jnp.float64, **kw),
            tc(tg, dtype=torch.float64, device="cpu", **kw))


def _drop(n, c=(0.5, 0.6), r=0.15):
    xs = [(np.arange(m) + 0.5) / m for m in n]
    X = np.meshgrid(*xs, indexing="ij")
    return r - np.sqrt(sum((x - cc) ** 2 for x, cc in zip(X, c)))


def _field(n, seed, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(n)


class _CGCounts:
    """Records the reference's CG iteration counts (eager calls)."""

    def __init__(self, monkeypatch):
        self.iters = []
        orig = jkrylov.cg

        def cg(*a, **k):
            res = orig(*a, **k)
            self.iters.append(int(res.iters))
            return res
        monkeypatch.setattr(jkrylov, "cg", cg)


DROP = dict(rho0=1.0, rho1=1000.0, mu0=0.01, mu1=0.1, sigma=0.5,
            gravity=(0.0, -1.0), cg_tol=1e-10)


@pytest.mark.parametrize("precond,rule", [("mg", "harmonic"),
                                          ("mg", "arithmetic"),
                                          ("fft", "harmonic")])
def test_project_vc_matches(monkeypatch, precond, rule):
    n = (32, 24)
    kw = dict(DROP, precond=precond)
    if precond == "fft":
        kw.update(rho1=10.0)
    ji, ti = _pair(n, kw, x_up=(1.0, 0.75))
    rho = ji.density(jnp.asarray(_drop(n)))
    u = tuple(_field(n, s) for s in (1, 2))
    counts = _CGCounts(monkeypatch)
    ju, jp = ji.project_vc(tuple(map(jnp.asarray, u)), rho, 2e-4,
                           face_rule=rule)
    tu, tp = ti.project_vc(tuple(map(torch.tensor, u)),
                           torch.tensor(np.asarray(rho)), 2e-4,
                           face_rule=rule)
    assert abs(ti.last_solve_stats["iters"] - counts.iters[0]) <= 1
    for a, b in zip(ju, tu):
        assert _rel(a, b) <= SOLVE
    assert _rel(jp, tp) <= SOLVE
    # discretely divergence-free
    assert float(ti.max_divergence(tvc.VCINSState(
        tu, tp, tp, tu, torch.zeros(()), 0))) < 1e-6


def test_viscous_and_interface_forces_match():
    n = (24, 20)
    ji, ti = _pair(n, DROP)
    phi = _drop(n)
    u = tuple(_field(n, s) for s in (3, 4))
    mu = ji.viscosity(jnp.asarray(phi))
    for a, b in zip(ji._viscous_force(tuple(map(jnp.asarray, u)), mu),
                    ti._viscous_force(tuple(map(torch.tensor, u)),
                                      torch.tensor(np.asarray(mu)))):
        assert _rel(a, b) <= EXACT
    rho = ji.density(jnp.asarray(phi))
    for a, b in zip(ji._interface_forces(jnp.asarray(phi), rho),
                    ti._interface_forces(torch.tensor(phi),
                                         torch.tensor(np.asarray(rho)))):
        assert _rel(a, b) <= EXACT


@pytest.mark.parametrize("conv", ["upwind", "centered", "none"])
def test_drop_steps_match(conv):
    """Five steps of a heavy drop (density ratio 1000, surface tension,
    gravity; a reinitialization at step 5) through the reference's
    scanned ``advance_vc`` and the port's loop."""
    n = (24, 24)
    kw = dict(DROP, convective_op_type=conv, reinit_interval=5)
    ji, ti = _pair(n, kw)
    phi = _drop(n)
    js = jvc.advance_vc(ji, ji.initialize(jnp.asarray(phi)), 2e-4, 5)
    ts = tvc.advance_vc(ti, ti.initialize(phi), 2e-4, 5)
    assert ts.k == 5 and int(js.k) == 5
    for a, b in zip(js.u, ts.u):
        assert _rel(a, b) <= SOLVE
    assert _rel(js.p, ts.p) <= SOLVE
    assert _rel(js.phi, ts.phi) <= SOLVE
    assert abs(float(js.t) - float(ts.t)) <= EXACT
    assert abs(float(ji.heavy_phase_volume(js))
               - float(ti.heavy_phase_volume(ts))) <= EXACT


def test_state_carried_over_continues_identically():
    """A reference state after 3 steps, converted, steps on in the port as
    it does in the reference (the AB2 history and the host counter)."""
    n = (20, 20)
    ji, ti = _pair(n, dict(DROP, reinit_interval=4))
    js = jvc.advance_vc(ji, ji.initialize(jnp.asarray(_drop(n))), 2e-4, 3)
    ts = convert.vc_ins_state(jax.tree_util.tree_map(np.asarray, js),
                              device="cpu")
    assert ts.k == 3 and isinstance(ts.k, int)
    js = jvc.advance_vc(ji, js, 2e-4, 2)
    ts = tvc.advance_vc(ti, ts, 2e-4, 2)
    for a, b in zip(js.u + (js.p, js.phi), ts.u + (ts.p, ts.phi)):
        assert _rel(a, b) <= SOLVE


@pytest.mark.parametrize("interval", [0, 2, 10])
def test_reinit_cadence_matches(interval):
    """The cadence ``(k + 1) % interval == 0``; interval 0 reinitializes
    every step, as the reference's ``jnp.mod(k + 1, 0) == 0``."""
    n = (20, 20)
    ji, ti = _pair(n, dict(DROP, reinit_interval=interval))
    phi = _drop(n) * 1.7
    u = tuple(0.3 * _field(n, s) for s in (5, 6))
    for k in range(3):
        a = ji._transport_level_set(jnp.asarray(phi),
                                    tuple(map(jnp.asarray, u)), 1e-3,
                                    jnp.asarray(k, jnp.int32))
        b = ti._transport_level_set(torch.tensor(phi),
                                    tuple(map(torch.tensor, u)), 1e-3, k)
        assert _rel(a, b) <= EXACT


@pytest.mark.parametrize("rhos", [(1.0, 1000.0), (1000.0, 1.0)])
def test_heavy_phase_volume_sign_rule(rhos):
    """The heavy phase is phi > 0 when rho1 >= rho0, else phi < 0."""
    n = (24, 24)
    ji, ti = _pair(n, dict(DROP, rho0=rhos[0], rho1=rhos[1]))
    phi = _drop(n)
    a = float(ji.heavy_phase_volume(ji.initialize(jnp.asarray(phi))))
    b = float(ti.heavy_phase_volume(ti.initialize(phi)))
    assert abs(a - b) <= EXACT * a
    drop_vol = np.pi * 0.15 ** 2
    assert (abs(b - drop_vol) < 0.05 * drop_vol) == (rhos[1] > rhos[0])


def test_conservative_steps_match():
    """The conservative form: mass fluxes, consistent momentum
    advection, the arithmetic-rule projection and a density resync every
    3 steps."""
    n = (24, 20)
    kw = dict(rho0=1.0, rho1=50.0, mu0=0.01, mu1=0.05, sigma=0.1,
              gravity=(0.0, -1.0), cg_tol=1e-10, rho_resync_interval=3)
    ji, ti = _pair(n, kw, cons=True)
    phi = _drop(n)
    u0 = tuple(0.1 * _field(n, s) for s in (7, 8))
    js = ji.initialize(jnp.asarray(phi), tuple(map(jnp.asarray, u0)))
    ts = ti.initialize(phi, u0)
    js = jvc.advance_vc_conservative(ji, js, 5e-4, 4)
    ts = tvc.advance_vc_conservative(ti, ts, 5e-4, 4)
    for a, b in zip(js.u + (js.p, js.phi, js.rho),
                    ts.u + (ts.p, ts.phi, ts.rho)):
        assert _rel(a, b) <= SOLVE
    assert abs(float(ji.total_mass(js)) - float(ti.total_mass(ts))) \
        <= EXACT * float(ji.total_mass(js))
    for a, b in zip(ji.total_momentum(js), ti.total_momentum(ts)):
        assert abs(float(a) - float(b)) <= 1e-9 * max(abs(float(a)), 1e-6)
    tc = convert.vc_cons_state(jax.tree_util.tree_map(np.asarray, js),
                               device="cpu")
    assert tc.k == 4 and _rel(js.rho, tc.rho) == 0.0


def test_conservative_stokes_limit_and_rejects_centered():
    n = (16, 16)
    kw = dict(rho0=1.0, rho1=5.0, gravity=(0.0, -1.0), cg_tol=1e-10,
              convective_op_type="none")
    ji, ti = _pair(n, kw, cons=True)
    phi = _drop(n)
    js = jvc.advance_vc(ji, ji.initialize(jnp.asarray(phi)), 1e-3, 2)
    ts = tvc.advance_vc(ti, ti.initialize(phi), 1e-3, 2)
    for a, b in zip(js.u + (js.rho,), ts.u + (ts.rho,)):
        assert _rel(a, b) <= SOLVE
    with pytest.raises(ValueError, match="upwind"):
        tvc.INSVCConservativeIntegrator(
            TGrid(n=n, x_lo=(0.0, 0.0), x_up=(1.0, 1.0)),
            convective_op_type="centered", device="cpu")
