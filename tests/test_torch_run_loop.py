"""Port parity of the run loop's remaining knobs and the entry point
against ``ibamr_tpu`` on the CPU: ``jitted_step``'s donation refusal,
``RunConfig.remat`` (gradients of a 2-step chunk loss through the
checkpointed steps equal the reference's ``jax.grad`` through
``checkpointed_step`` and the port's plain gradient, within 1e-12
relative at f64), the health probe riding the chunk's one host read,
the bus's driver spans and counters, ``profile_trace``, and ``entry()``
(its step equals ``__graft_entry__.entry()``'s within 1e-10 relative,
both built at f64)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators.ins import INSStaggeredIntegrator as JINS
from ibamr_tpu.models import shell3d as jshell
from ibamr_tpu.utils.hierarchy_driver import checkpointed_step as jckpt
from ibamr_tpu_torch import convert, obs
from ibamr_tpu_torch.entry import entry
from ibamr_tpu_torch.models.shell3d import build_shell_example
from ibamr_tpu_torch.tools import fault_injection as tfi
from ibamr_tpu_torch.utils.health import HealthProbe
from ibamr_tpu_torch.utils.hierarchy_driver import (REMAT_POLICIES,
                                                    HierarchyDriver,
                                                    RunConfig,
                                                    SimulationDiverged)
from ibamr_tpu_torch.utils.timers import TimerManager, profile_trace


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_jitted_step_refuses_donation_under_grad():
    integ, st = build_shell_example(n_cells=16, n_lat=6, n_lon=6,
                                    dtype=torch.float64, device="cpu")
    f = integ.jitted_step(donate=True)
    assert integ.jitted_step(donate=True) is f
    out = f(st, 1e-3)
    ref = integ.step(st, 1e-3)
    assert torch.equal(out.X, ref.X)
    out2, stats = integ.jitted_step(donate=True, with_stats=True)(st, 1e-3)
    assert torch.equal(out2.X, ref.X) and "refresh_hit" in stats
    grad_st = st._replace(X=st.X.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="require grad"):
        f(grad_st, 1e-3)
    g = integ.jitted_step(donate=False)(grad_st, 1e-3)
    g.X.sum().backward()
    assert grad_st.X.grad is not None


def _jax_tg(n=16):
    g = JGrid(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    integ = JINS(g, rho=1.0, mu=0.05, dtype=jnp.float64)
    xf, yc = g.face_centers(0, jnp.float64)
    xc, yf = g.face_centers(1, jnp.float64)
    u = jnp.sin(2 * jnp.pi * xf) * jnp.cos(2 * jnp.pi * yc) + 0 * yc
    v = -jnp.cos(2 * jnp.pi * xc) * jnp.sin(2 * jnp.pi * yf) + 0 * xc
    return integ, integ.initialize(u0_arrays=(u, v))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gradients_match_reference(remat):
    dt = 5e-3
    ji, js = _jax_tg()
    step = jckpt(ji.step, remat)

    def jloss(u):
        def body(s, _):
            return step(s, dt), None
        out, _ = jax.lax.scan(body, js._replace(u=u), None, length=2)
        return sum(jnp.sum(c ** 3) for c in out.u) + jnp.sum(out.p ** 2)

    jg = jax.grad(jloss)(js.u)

    ti, _ = tfi._tg16_setup(device="cpu", dtype=torch.float64)
    grads = {}
    for policy in (remat, None):
        ts = convert.ins_state(js, device="cpu")
        u = tuple(c.clone().requires_grad_(True) for c in ts.u)
        drv = HierarchyDriver(ti, RunConfig(dt=dt, num_steps=2,
                                            health_interval=2,
                                            remat=policy, donate=True))
        assert drv.donates is (policy is None)
        out, _ = drv._chunk(2)(ts._replace(u=u), dt)
        loss = sum(torch.sum(c ** 3) for c in out.u) + torch.sum(out.p ** 2)
        grads[policy] = torch.autograd.grad(loss, u)
    for a, b, c in zip(jg, grads[remat], grads[None]):
        a = np.asarray(a)
        scale = np.max(np.abs(a))
        assert np.max(np.abs(b.numpy() - a)) <= 1e-12 * scale
        assert np.max(np.abs(c.numpy() - a)) <= 1e-12 * scale
    assert set(REMAT_POLICIES) == {"full", "dots", "dots_no_batch"}
    with pytest.raises(ValueError):
        RunConfig(dt=dt, num_steps=2, remat="everything")


def test_probe_rides_the_chunks_one_read(tmp_path):
    integ, st0 = tfi._tg16_setup(device="cpu", dtype=torch.float64)
    cfg = RunConfig(dt=1e-3, num_steps=7, health_interval=3,
                    restart_interval=4)
    plain = HierarchyDriver(integ, cfg)
    probed = HierarchyDriver(integ, cfg,
                             health_probe=HealthProbe.for_integrator(integ),
                             timer=TimerManager())
    a = plain.run(st0)
    ledger = str(tmp_path / "ledger.jsonl")
    with obs.ledger(ledger):
        b = probed.run(st0)
    # chunks 0-3, 3-4, 4-7: one read each, the vitals in place of the flag
    assert plain.host_reads == probed.host_reads == 3
    assert torch.equal(a.u[0], b.u[0])
    assert probed.last_vitals["level"] == "ok" and probed.last_vitals[
        "step"] == 7
    recs = obs.read_ledger(ledger)
    spans = [r["path"] for r in recs if r["kind"] == "span"]
    assert spans.count("driver/chunk/HierarchyIntegrator::"
                       "advanceHierarchy") == 3
    assert spans.count("driver/chunk") == 3
    last = [r for r in recs if r["kind"] == "counters"][-1]
    assert last["step"] == 7 and last["counters"]["driver_steps_total"] >= 7
    bad = HierarchyDriver(integ, cfg, step_fn=tfi.nan_injector_step(
        integ.step, at_step=2, leaf_path="u[1]"),
        health_probe=HealthProbe.for_integrator(integ))
    with pytest.raises(SimulationDiverged) as ei:
        bad.run(st0)
    assert ei.value.step == 3 and ".u[1]" in ei.value.bad_leaves
    from ibamr_tpu_torch.parallel.mesh import make_lane_mesh
    with pytest.raises(ValueError, match="fleet mode"):
        HierarchyDriver(integ, cfg, lane_mesh=make_lane_mesh(2,
                                                            device="cpu"))


def test_profile_trace_writes_a_chrome_trace_named_in_the_ledger(tmp_path):
    integ, st = tfi._tg16_setup(device="cpu")
    with profile_trace(None):                  # no directory: a no-op
        st = integ.step(st, 1e-3)
    ledger = str(tmp_path / "ledger.jsonl")
    with obs.ledger(ledger), profile_trace(str(tmp_path / "p"), stage="s"):
        for _ in range(2):
            st = integ.step(st, 1e-3)
    rec = [r for r in obs.read_ledger(ledger) if r["kind"] == "profile"][0]
    assert rec["stage"] == "s" and os.path.getsize(rec["trace"]) > 0
    assert any(r.get("name") == "profile_trace" for r in
               obs.read_ledger(ledger))


def test_entry_matches_reference_entry(monkeypatch):
    monkeypatch.setattr(jshell, "build_shell_example", functools.partial(
        jshell.build_shell_example, dtype=jnp.float64))
    jfn, (js, jdt) = __graft_entry__.entry()
    tfn, (ts, tdt) = entry(device="cpu", dtype=torch.float64)
    assert tdt == jdt
    ref = jfn(js, jdt)
    got = tfn(ts, tdt)
    for a, b in zip((ref.X, *ref.ins.u, ref.ins.p),
                    (got.X, *got.ins.u, got.ins.p)):
        a = np.asarray(a)
        assert np.max(np.abs(b.numpy() - a)) <= 1e-10 * max(
            np.max(np.abs(a)), 1e-300)
    fn32, (s32, _) = entry(device="cpu")
    assert s32.X.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
