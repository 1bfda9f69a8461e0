"""Port parity of the supervised run loop (``utils/supervisor.py``,
``utils/checkpoint.py``'s async writer, ``solvers/escalation.py``,
``utils/watchdog.py``) against ``ibamr_tpu`` at f64 on the CPU.

The set-ups of the reference's ``run_smoke`` and ``run_silent_smoke``
drills (``tools/fault_injection.py``) run through both packages: the
incidents (event, kind, step, rollback step, dt, reasons) are equal and
the final states agree within 1e-12 relative. The async writer's retry
and the verified-checkpoint fallback, the escalation chain recovering at
``deep_x4_inner_x2`` and a watchdog stall incident are held as the
reference's drills hold them."""

import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators.ins import INSStaggeredIntegrator as JINS
from ibamr_tpu.solvers.escalation import escalate_solve as jescalate
from ibamr_tpu.solvers.krylov import fgmres as jfgmres
from ibamr_tpu.utils.checkpoint import restore_checkpoint as jrestore
from ibamr_tpu.utils.health import HealthProbe as JProbe
from ibamr_tpu.utils.hierarchy_driver import HierarchyDriver as JDriver
from ibamr_tpu.utils.hierarchy_driver import RunConfig as JConfig
from ibamr_tpu.utils.supervisor import ResilientDriver as JSupervisor
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.tools import fault_injection as tfi
from ibamr_tpu_torch.utils import checkpoint as tck
from ibamr_tpu_torch.utils.hierarchy_driver import (HierarchyDriver,
                                                    RunConfig)
from ibamr_tpu_torch.utils.supervisor import ResilientDriver
from tools import fault_injection as jfi

EXACT = 1e-12
INCIDENT_KEYS = ("event", "kind", "step", "rollback_step", "dt_before",
                 "dt_after", "reasons", "retry", "from_checkpoint",
                 "bad_leaves")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tg16():
    """The reference drills' 16^2 Taylor-Green set-up, at f64."""
    g = JGrid(n=(16, 16), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    integ = JINS(g, rho=1.0, mu=0.05, dtype=jnp.float64)
    xf, yc = g.face_centers(0, jnp.float64)
    xc, yf = g.face_centers(1, jnp.float64)
    u = jnp.sin(2 * jnp.pi * xf) * jnp.cos(2 * jnp.pi * yc) + 0 * yc
    v = -jnp.cos(2 * jnp.pi * xc) * jnp.sin(2 * jnp.pi * yf) + 0 * xc
    return integ, integ.initialize(u0_arrays=(u, v))


def _incidents(recs):
    return [{k: r.get(k) for k in INCIDENT_KEYS} for r in recs
            if r["event"] != "stall"]


def _rel_state(ref, got):
    ref = convert.ins_state(ref, device="cpu")
    worst = 0.0
    for a, b in zip(ref.u + (ref.p,), got.u + (got.p,)):
        a, b = a.numpy(), b.detach().numpy()
        worst = max(worst, float(np.max(np.abs(a - b))
                                 / max(np.max(np.abs(a)), 1e-300)))
    assert int(got.k) == int(ref.k)
    return worst


def test_run_smoke_matches_reference(tmp_path):
    integ, st0 = _jax_tg16()
    dt0 = 1e-3
    cfg = JConfig(dt=dt0, num_steps=12, restart_interval=4,
                  health_interval=2)
    drv = JDriver(integ, cfg, step_fn=jfi.nan_injector_step(
        integ.step, at_step=6, leaf_path="u[0]", dt_gate=dt0 * 0.99))
    sup = JSupervisor(drv, str(tmp_path / "j"), max_retries=2,
                      dt_backoff=0.5, handle_signals=False)
    jout = sup.run(st0)
    got = tfi.run_smoke(str(tmp_path / "t"), device="cpu",
                        dtype=torch.float64)
    assert _incidents(got["incidents"]) == _incidents(sup.incidents)
    assert got["rollback_step"] == 4 and got["flaky_write_calls"] == 2
    assert got["fallback_step"] < got["corrupt_step_skipped"]
    assert _rel_state(jout, got["state"]) <= EXACT
    # the port's checkpoints restore into the reference, leaf for leaf
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jst, step, _ = jrestore(str(tmp_path / "t"), template=jout,
                                step=8)
    assert step == 8 and int(jst.k) == 8


def test_run_silent_smoke_matches_reference(tmp_path):
    integ, st0 = _jax_tg16()
    dt0 = 1e-3
    probe = JProbe.for_integrator(integ, func_growth_warn=8.0, sustain=2)
    cfg = JConfig(dt=dt0, num_steps=12, restart_interval=4,
                  health_interval=2)
    drv = JDriver(integ, cfg, step_fn=jfi.growth_injector_step(
        integ.step, rate=1.5, leaf_path="u", dt_gate=dt0 * 0.99),
        health_probe=probe)
    sup = JSupervisor(drv, str(tmp_path / "j"), max_retries=2,
                      dt_backoff=0.5, handle_signals=False)
    jout = sup.run(st0)
    got = tfi.run_silent_smoke(str(tmp_path / "t"), device="cpu",
                               dtype=torch.float64)
    assert _incidents(got["incidents"]) == _incidents(sup.incidents)
    assert got["health_rollback_step"] == 4
    assert _rel_state(jout, got["state"]) <= EXACT
    # the escalation chain recovers at its last level, as the
    # reference's on the same diagonal system
    w = jnp.logspace(0, 2, 48)
    b = jnp.ones(48)
    jesc = []
    jescalate(lambda lv, _i: jfgmres(lambda x: w * x, b, m=8 * lv.m_scale,
                                     tol=1e-4,
                                     restarts=1 * lv.restarts_scale),
              context="silent_smoke_diag", on_incident=jesc.append)
    tesc = got["escalations"][0]
    assert got["escalation_recovered_level"] == "deep_x4_inner_x2"
    assert tesc["level"] == jesc[0]["level"]
    assert [(a["level"], a["converged"], a["iters"])
            for a in tesc["attempts"]] == \
        [(a["level"], a["converged"], a["iters"])
         for a in jesc[0]["attempts"]]
    assert got["breakdown_attempts"] == 3
    # the watchdog's stall: one incident in the same incidents.jsonl
    assert got["stall_incidents"] >= 1 and got["heartbeat_step"] == 8
    stalls = [json.loads(ln) for ln in open(
        tmp_path / "t" / "wd" / "incidents.jsonl")]
    assert any(r["event"] == "stall" and r["kind"] == "stall"
               for r in stalls)


def test_async_writer_retry_drop_and_surfaced_failure(tmp_path):
    integ, st0 = tfi._tg16_setup(device="cpu", dtype=torch.float64)
    w = tck.AsyncCheckpointWriter(str(tmp_path), keep=5)
    try:
        with tfi.failing_checkpoint_writes({0}) as ctr:
            w.save(st0, 1)
            w.wait()
        assert ctr["calls"] == 2 and tck.verify_checkpoint(str(tmp_path), 1)
        with tfi.failing_checkpoint_writes({0, 1}):
            w.save(st0, 2)
            with pytest.raises(OSError, match="injected"):
                w.wait()
        assert tck.latest_step(str(tmp_path)) == 1
        w.save(st0, 3)                       # the failure was dropped
        w.wait()
    finally:
        w.close()
    drop = tck.AsyncCheckpointWriter(str(tmp_path / "d"), max_pending=1,
                                     overflow="drop")
    try:
        import threading
        gate = threading.Event()
        orig = tck._write_arrays
        tck._write_arrays = lambda *a, **k: (gate.wait(5), orig(*a, **k))[1]
        try:
            assert drop.save(st0, 1) is not None
            assert drop.save(st0, 2) is None and drop.dropped_saves == 1
            assert drop.queue_depth() == 1
            gate.set()
            drop.wait()
        finally:
            tck._write_arrays = orig
    finally:
        drop.close()
    with pytest.raises(ValueError):
        tck.AsyncCheckpointWriter(str(tmp_path), overflow="spill")


def test_corruption_falls_back_to_newest_verified(tmp_path):
    _, st0 = tfi._tg16_setup(device="cpu", dtype=torch.float64)
    d = str(tmp_path)
    for k in (2, 4, 6):
        tck.save_checkpoint(d, st0._replace(t=st0.t + k), k, keep=5)
    tfi.corrupt_checkpoint(d, 6)
    tfi.truncate_checkpoint(d, 4)
    assert not tck.verify_checkpoint(d, 6)
    assert tck.latest_step(d) == 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        st, k, _ = tck.restore_checkpoint(d, st0)
    assert k == 2 and float(st.t) == float(st0.t) + 2
    with pytest.raises(tck.CheckpointCorruptError):
        tck.restore_checkpoint(d, st0, step=6)
    tfi.drop_sidecar(d, 2)
    assert tck.latest_step(d) is None


def test_supervisor_forces_donation_off_and_gives_up(tmp_path):
    integ, st0 = tfi._tg16_setup(device="cpu", dtype=torch.float64)
    cfg = RunConfig(dt=1e-3, num_steps=4, health_interval=2, donate=True)
    drv = HierarchyDriver(integ, cfg, step_fn=tfi.nan_injector_step(
        integ.step, at_step=2, leaf_path=".p"))
    assert drv.donates
    sup = ResilientDriver(drv, str(tmp_path), max_retries=1,
                          handle_signals=False)
    assert not cfg.donate and not drv.donates
    from ibamr_tpu_torch.utils.hierarchy_driver import SimulationDiverged
    with pytest.raises(SimulationDiverged):
        sup.run(st0)
    assert [r["event"] for r in sup.incidents] == ["divergence", "give_up"]
    assert sup.incidents[-1]["bad_leaves"] == [".p"]
    # sharded supervision (the parallel layer): the same episode, its
    # checkpoints in the sharded format only
    sh_dir = str(tmp_path / "sharded")
    sup = ResilientDriver(drv, sh_dir, max_retries=1, handle_signals=False,
                          sharded=True)
    with pytest.raises(SimulationDiverged):
        sup.run(st0)
    assert [r["event"] for r in sup.incidents] == ["divergence", "give_up"]
    assert not [f for f in os.listdir(sh_dir) if f.startswith("restore.")]
