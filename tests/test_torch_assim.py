"""Port parity of ensemble data assimilation (``ibamr_tpu_torch/assim``)
against ``ibamr_tpu/assim`` on the CPU, at f64 as in
``tests/test_assim.py``.

The same inputs (numpy seeds) go through both packages: the masked ESRF
equals the reference's analysis within 1e-12 relative (the analysis is
compared, never the eigenvectors: ``eigh`` may flip their signs or
rotate a repeated eigenvalue's basis), and the independent NumPy Kalman
oracle within the reference test's 1e-10; masked equals dense on the
alive lanes with dead rows bitwise frozen; posterior inflation scales the
spread exactly; QC's rejection matrix, its reports and its ledger
records equal the reference's; the state packer round-trips bitwise and
packs in the reference's order; the observation operator and the
synthesized sensor batches equal the reference's (the noise bit for bit,
the readings within 1e-12 relative); two supervised cycles of the shell
fleet equal the reference's cycle within 1e-9 relative; a spread
collapse rolls back and escalates the inflation; and the four-injector
drill runs at the reference's sizes."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu import assim as jassim
from ibamr_tpu_torch import assim as tassim
from ibamr_tpu_torch import convert
from ibamr_tpu_torch import obs as tobs

RNG = np.random.default_rng(20261018)
RTOL = 1e-12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_problem(rng, B=5, n=7, m=4):
    ens = rng.standard_normal((B, n))
    H = rng.standard_normal((m, n))
    obs_ens = ens @ H.T
    y = rng.standard_normal(m)
    r = 10.0 ** rng.uniform(-2.0, 0.0, m)
    return ens, obs_ens, y, r


def _both(ens, obs_ens, y, r, alive, om, infl):
    ja, jd = jassim.esrf_analysis(
        jnp.asarray(ens), jnp.asarray(obs_ens), jnp.asarray(y),
        jnp.asarray(r), jnp.asarray(alive), jnp.asarray(om),
        jnp.asarray(infl))
    ta, td = tassim.esrf_analysis(
        torch.tensor(ens), torch.tensor(obs_ens), torch.tensor(y),
        torch.tensor(r), torch.tensor(alive), torch.tensor(om),
        torch.tensor(infl, dtype=torch.float64))
    return np.asarray(ja), jd, ta.numpy(), td


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                 / max(float(np.max(np.abs(b))), 1e-300))


@pytest.mark.parametrize("seed", range(4))
def test_esrf_matches_reference_and_numpy_kalman_oracle(seed):
    rng = np.random.default_rng(seed)
    ens, obs_ens, y, r = _random_problem(rng)
    B = ens.shape[0]
    om = np.ones(y.size, bool)
    om[seed % y.size] = seed % 2 == 0
    ja, jd, ta, td = _both(ens, obs_ens, y, r, np.ones(B, bool), om, 1.0)
    assert _rel(ta, ja) < RTOL
    for a, b in zip(td, jd):
        assert abs(float(a) - float(b)) <= RTOL * max(abs(float(b)), 1.0)
    if not om.all():
        return
    xbar, ybar = ens.mean(0), obs_ens.mean(0)
    Zx, Zy = ens - xbar, obs_ens - ybar
    K = (Zx.T @ Zy / (B - 1)) @ np.linalg.inv(Zy.T @ Zy / (B - 1)
                                              + np.diag(r))
    np.testing.assert_allclose(ta.mean(0), xbar + K @ (y - ybar),
                               atol=1e-10)
    Za = ta - ta.mean(0)
    Pa = Zx.T @ Zx / (B - 1) - K @ (Zy.T @ Zx / (B - 1))
    np.testing.assert_allclose(Za.T @ Za / (B - 1), Pa, atol=1e-10)
    np.testing.assert_allclose(float(td.innov_rms),
                               float(np.sqrt(np.mean((y - ybar) ** 2))),
                               atol=1e-10)


def test_masked_equals_dense_on_alive_and_freezes_dead():
    ens, obs_ens, y, r = _random_problem(RNG, B=6)
    alive = np.array([True, True, False, True, False, True])
    om = np.ones(y.size, bool)
    ja, _, ta, td = _both(ens, obs_ens, y, r, alive, om, 1.0)
    sub = np.flatnonzero(alive)
    _, _, ta_d, _ = _both(ens[sub], obs_ens[sub], y, r,
                          np.ones(sub.size, bool), om, 1.0)
    np.testing.assert_allclose(ta[sub], ta_d, atol=1e-10)
    assert np.array_equal(ta[~alive], ens[~alive])
    assert _rel(ta, ja) < RTOL
    assert int(td.n_alive) == sub.size


def test_posterior_inflation_scales_spread_exactly():
    ens, obs_ens, y, r = _random_problem(RNG)
    B = ens.shape[0]
    args = (ens, obs_ens, y, r, np.ones(B, bool), np.ones(y.size, bool))
    _, _, _, d1 = _both(*args, 1.0)
    _, _, _, d2 = _both(*args, 1.4)
    np.testing.assert_allclose(float(d2.spread_a), 1.4 * float(d1.spread_a),
                               rtol=1e-12)


def test_analysis_skill_improves_with_ensemble_size():
    n = 12
    y, r = np.zeros(n), np.full(n, 1e-4)
    errs = {}
    for B in (4, 32):
        ens = RNG.standard_normal((B, n))
        _, _, ta, _ = _both(ens, ens, y, r, np.ones(B, bool),
                            np.ones(n, bool), 1.0)
        errs[B] = float(np.sqrt(np.mean(ta.mean(0) ** 2)))
        assert errs[B] < float(np.sqrt(np.mean(ens.mean(0) ** 2)))
    assert errs[32] < 0.2 * errs[4]


def test_qc_rejection_matrix_and_records_match_reference(tmp_path):
    from ibamr_tpu import obs as jobs

    values = np.array([np.nan, 5.0, 0.01, 0.0, 100.0])
    age = np.array([0.0, 0.0, 1e4, 0.0, 1e4])
    kw = dict(values=values, r=np.full(5, 1e-2), age_s=age, cycle=3,
              names=("a", "b", "c", "d", "e"))
    got = {}
    for name, mod, bus in (("t", tassim, tobs), ("j", jassim, jobs)):
        led = str(tmp_path / f"{name}.jsonl")
        with bus.ledger(led):
            accept, report = mod.screen(
                mod.ObservationBatch(**kw), ybar=np.zeros(5),
                hph=np.full(5, 1e-2),
                cfg=mod.QCConfig(k_sigma=4.0, max_age_s=60.0), step=8)
        recs = [{k: v for k, v in r.items()
                 if k not in ("seq", "run_id", "t")}
                for r in bus.read_ledger(led)
                if r["kind"] == "assim_qc_reject"]
        got[name] = (accept.tolist(), report, recs)
    assert got["t"] == got["j"]
    assert got["t"][0] == [False, False, False, True, False]
    assert got["t"][1]["by_reason"] == {"dropout": 1, "stale": 2,
                                        "outlier": 1}


def _shells(n_cells=8, n_lat=6, n_lon=8):
    from ibamr_tpu.models.shell3d import build_shell_example as jbuild
    from ibamr_tpu_torch.models.shell3d import build_shell_example as tbuild

    kw = dict(n_cells=n_cells, n_lat=n_lat, n_lon=n_lon, mu=0.05)
    ji, js = jbuild(**kw, dtype="float64")
    ti, ts = tbuild(**kw, dtype=torch.float64, device="cpu")
    return ji, js, ti, ts


def test_state_packer_roundtrip_bitwise_in_the_reference_order():
    _, js, _, ts = _shells()
    ts = convert.ib_state(js, device="cpu")
    pack, unpack, n = tassim.state_packer(ts)
    jpack, _, jn = jassim.state_packer(js)
    vec = pack(ts)
    assert vec.shape == (n,) and n == jn
    assert np.array_equal(vec.numpy(), np.asarray(jpack(js)))
    back = unpack(ts, vec * 2.0)
    assert torch.equal(back.ins.p, 2.0 * ts.ins.p)
    assert torch.equal(back.X, ts.X)
    st2 = unpack(ts, vec)
    from ibamr_tpu_torch.utils.tree import leaves
    for a, b in zip(leaves(ts), leaves(st2)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def _panels(ji, ti, n_lon):
    from ibamr_tpu.instruments import InstrumentPanel as JPanel
    from ibamr_tpu.instruments import make_meters as jmeters
    from ibamr_tpu_torch.instruments import InstrumentPanel as TPanel
    from ibamr_tpu_torch.instruments import make_meters as tmeters

    loops = [[2 * n_lon + j for j in range(n_lon)],
             [5 * n_lon + j for j in range(n_lon)]]
    jop = jassim.ObservationOperator(JPanel(
        ji.ins.grid, jmeters(loops, closed=True, dtype=jnp.float64)))
    top = tassim.ObservationOperator(TPanel(
        ti.ins.grid, tmeters(loops, closed=True, dtype=torch.float64,
                             device="cpu")))
    return jop, top


def test_observation_operator_and_batches_match_reference():
    ji, js, ti, ts = _shells(n_cells=16, n_lat=8, n_lon=16)
    jop, top = _panels(ji, ti, 16)
    assert top.channel_names() == jop.channel_names()
    assert top.n_obs == jop.n_obs == 4
    truth_j, truth_t, sj, st = [js], [ts], js, ts
    for _ in range(2):
        sj, st = ji.step(sj, 1e-3), ti.step(st, 1e-3)
        truth_j.append(sj)
        truth_t.append(st)
    assert _rel(top(truth_t[-1]).numpy(), np.asarray(jop(truth_j[-1]))) \
        < 1e-10
    bj = jassim.synthesize_batches(jop, truth_j, sigma=1e-5, seed=7)
    bt = tassim.synthesize_batches(top, truth_t, sigma=1e-5, seed=7)
    for a, b in zip(bt, bj):
        assert a.cycle == b.cycle and a.names == b.names
        assert np.array_equal(a.r, b.r) and np.array_equal(a.age_s, b.age_s)
        assert np.max(np.abs(a.values - b.values)) < 1e-10 * np.max(
            np.abs(b.values))
    from ibamr_tpu.utils.lanes import stack_lanes as jstack
    fl = jstack([truth_j[0], truth_j[2]])
    tf = convert.ib_state(fl, device="cpu")
    assert _rel(top.fleet(tf).numpy(), np.asarray(jop.fleet(fl))) < 1e-10


def test_two_supervised_cycles_match_the_reference_cycle(tmp_path):
    """Two cycles of 2 steps of a B=4 fleet of the 16^3 shell through
    both packages' ``AssimilationCycle`` (driver, analysis hook, QC,
    supervisor), from the same fleet and the same sensors."""
    from ibamr_tpu.serve.aot_cache import ExecutableCache as JCache
    from ibamr_tpu.utils.lanes import stack_lanes as jstack
    from ibamr_tpu_torch.serve.aot_cache import ExecutableCache as TCache

    ji, js, ti, _ = _shells(n_cells=16, n_lat=8, n_lon=16)
    jop, top = _panels(ji, ti, 16)
    truth, s = [], js
    for _ in range(2):
        for _ in range(2):
            s = ji.step(s, 1e-3)
        truth.append(s)
    batches = jassim.synthesize_batches(jop, truth, sigma=1e-5, seed=3)
    fleet = jstack([js._replace(ins=js.ins._replace(
        u=tuple(c + 2e-3 * (i + 1) for c in js.ins.u))) for i in range(4)])
    outs = []
    for name, mod, cache, st in (
            ("j", jassim, JCache(), fleet),
            ("t", tassim, TCache(), convert.ib_state(fleet, device="cpu"))):
        integ, op = (ji, jop) if name == "j" else (ti, top)
        cyc = mod.AssimilationCycle(
            integ, op, 4, mod.AssimConfig(steps_per_cycle=2, dt=1e-3),
            cache=cache)
        d = tmp_path / name
        d.mkdir()
        outs.append((cyc.run(st, batches, directory=str(d),
                             max_retries=1), cache.stats()))
    (jout, jst), (tout, tst) = outs
    for a, b in ((tout.ins.u[0], jout.ins.u[0]), (tout.ins.u[2],
                                                  jout.ins.u[2]),
                 (tout.ins.p, jout.ins.p), (tout.X, jout.X)):
        assert _rel(a.numpy(), np.asarray(b)) < 1e-9
    assert (tst["misses"], tst["hits"]) == (jst["misses"], jst["hits"]) \
        == (2, 2)


def test_rebaseline_drops_anchors_keeps_streaks():
    from ibamr_tpu_torch.utils.health import OK, HealthProbe

    def vitals(func):
        return np.array([1.0, 0.1, 0.1, 0.0, func, 1.0, 1.0])

    ctrl = HealthProbe(func_growth_warn=3.0, sustain=10)
    ctrl.classify(vitals(1.0), step=1, dt=1e-3)
    level, reasons, _ = ctrl.classify(vitals(10.0), step=2, dt=1e-3)
    assert level != OK and reasons
    probe = HealthProbe(func_growth_warn=3.0, sustain=10)
    assert probe.classify(vitals(1.0), step=1, dt=1e-3)[0] == OK
    probe._warn_streak = 2
    probe.rebaseline()
    assert probe._warn_streak == 2
    level, reasons, _ = probe.classify(vitals(10.0), step=2, dt=1e-3)
    assert level == OK and not reasons
    assert probe._warn_streak == 0


def test_spread_collapse_rolls_back_and_escalates_inflation(tmp_path):
    """A spread floor just above the filter's natural analysis spread
    trips ``FilterDegraded``; the supervisor rolls back and climbs the
    inflation ladder one rung per retry (1.0 -> 1.05 -> 1.1 cures a 7%
    deficit), and the retried cycle's analysis re-fires: no cycle is
    lost."""
    from ibamr_tpu_torch.serve.aot_cache import ExecutableCache
    from ibamr_tpu_torch.tools.fault_injection import assim_shell_setup
    from ibamr_tpu_torch.utils.health import HealthProbe

    B, n_cyc, spc = 4, 3, 2
    integ, op, fleet0, batches, _ = assim_shell_setup(
        B, n_cyc, spc, 1e-3, device="cpu", seed=11, n_cells=16, n_lat=8,
        n_lon=16, mu=0.05)

    def run(name, **cfg):
        d = tmp_path / name
        d.mkdir()
        led = str(d / "ledger.jsonl")
        cyc = tassim.AssimilationCycle(
            integ, op, B, tassim.AssimConfig(steps_per_cycle=spc, dt=1e-3,
                                             **cfg),
            probe=HealthProbe.for_integrator(integ),
            cache=ExecutableCache())
        with tobs.ledger(led):
            cyc.run(fleet0, batches, directory=str(d), max_retries=8)
        return cyc, tobs.read_ledger(led), d

    base, recs, _ = run("base")
    s_base = next(r["spread_a"] for r in recs
                  if r.get("kind") == "assim_cycle" and not r["skipped"])
    assert base.escalations == [] and base.inflation == 1.0
    cyc, recs, d = run("run", spread_floor=1.07 * s_base)
    assert cyc.escalations[:2] == [(1.0, 1.05), (1.05, 1.1)]
    assert cyc.inflation >= 1.1
    incidents = [json.loads(ln) for ln in
                 open(os.path.join(str(d), "incidents.jsonl"))]
    esc = [r for r in incidents if r.get("event") == "inflation_escalation"]
    assert [(r["inflation_before"], r["inflation_after"])
            for r in esc[:2]] == [(1.0, 1.05), (1.05, 1.1)]
    assert {r["cycle"] for r in recs
            if r.get("kind") == "assim_cycle"} == set(range(n_cyc))


def test_assim_drill_at_the_reference_sizes(tmp_path, capsys):
    """The four-injector drill (6 lanes of the 16^3 shell, 6 cycles,
    f64, the scatter oracle) on the CPU, through its CLI; its ledger
    renders the reference's assimilation block."""
    from ibamr_tpu_torch.tools import fault_injection as fi
    from ibamr_tpu_torch.tools import obs as tcli
    from tools import obs as jcli

    res = fi.run_assim_smoke(str(tmp_path), device="cpu")
    assert res["assim_smoke"] == "ok"
    assert res["analysis_compiles"] == 2
    assert res["analysis_cache_hits"] == 10
    assert sorted(map(tuple, res["qc_rejections"])) == [
        (1, "flux[0]", "dropout"), (2, "flux[1]", "outlier"),
        (3, "mean_pressure[0]", "stale")]
    assert res["forecast_error"] < res["open_loop_error"]
    records = tobs.read_ledger(res["ledger"])
    snap = tcli.last_counters(records)
    lines = tcli.render_assim(snap, records)
    assert lines == jcli.render_assim(snap, records)
    assert any("drill verdict" in ln for ln in lines)
