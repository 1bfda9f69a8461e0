"""Port parity of the serving SLO gate (``ibamr_tpu_torch/tools/slo.py``
and the port's ``ibamr_tpu_torch/SLO.json``) against ``tools/slo.py`` on
the CPU.

Every SLI function (``slis_from_ledger``, ``slis_from_drill``,
``soak_slis_from_ledger``, ``elastic_slis_from_ledger``,
``assim_slis_from_ledger``) equals the reference's on the same
hand-built ledgers (numpy seeds: admits, terminals, lost ids, cache
events, histogram snapshots, scale and mode records, assimilation
cycles); ``evaluate`` and the ``tighten_*`` rules equal the reference's;
``check`` exits 0/1/2 as the reference's does for the cold/warm, soak,
elastic and assimilation sections, on ledgers and on a fresh cold/warm
drill of the port on the CPU. The committed contract holds the
reference's drill sizes and pins the invariants at the reference's
values."""

import json
import os

import numpy as np
import pytest
import torch

import tools.slo as jslo
from ibamr_tpu_torch.tools import slo as tslo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM = 'serve_first_step_seconds{path="warm"}'


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hist(rng, n=16):
    counts = rng.integers(0, 5, n).tolist()
    return {"counts": counts, "count": int(sum(counts)),
            "sum": float(rng.random() * 3)}


def _ledger(seed, lost=1, hists=True):
    """A hand-built serving + elastic + assimilation ledger."""
    rng = np.random.default_rng(seed)
    recs, seq = [], 0

    def add(kind, **kw):
        nonlocal seq
        seq += 1
        recs.append(dict(kind=kind, seq=seq, **kw))

    n = int(rng.integers(12, 30))
    tids = [f"{i:016x}" for i in range(n)]
    for i, tid in enumerate(tids):
        cls = ("interactive", "batch")[int(rng.integers(0, 2))]
        add("request_admit", trace_id=tid, tenant=f"{cls}-0",
            tenant_class=cls, family="(8, 6, 8, None, None, 0.05)",
            steps=int(rng.integers(1, 5)))
        if i % 4 == 0:
            add("aot_cache", event=("miss" if i < 4 else "hit"), key="k")
    for i, tid in enumerate(tids[lost:]):
        if rng.random() < 0.2:
            add("request_shed", trace_id=tid, reason="queue_full",
                tenant_class="batch",
                queue_wait_s=float(rng.random()))
        else:
            add("request", trace_id=tid, cold=bool(i == 0),
                tenant_class=("interactive" if rng.random() < 0.6
                              else "batch"),
                quarantined=bool(rng.random() < 0.1),
                first_step_s=float(rng.random()),
                queue_wait_s=float(rng.random()),
                steps=int(rng.integers(1, 5)), total_s=float(rng.random()))
    for _ in range(int(rng.integers(0, 4))):
        add("pool_scale", action="warmed", warm_s=float(rng.random() * 3))
    add("pool_scale", action="grow")
    for m in ("brownout", "healthy")[:int(rng.integers(0, 3))]:
        add("serve_mode", mode=m)
    add("serving_restore", warm_s=float(rng.random()),
        fresh_compiles=int(rng.integers(0, 2)))
    ncyc = 6
    for c in range(ncyc):
        if c != 3 or not lost:
            add("assim_cycle", cycle=c, skipped=bool(c == 1),
                analysis_wall_s=float(rng.random()))
    add("assim_summary", cycles=ncyc,
        forecast_error=float(rng.random() * 1e-4),
        open_loop_error=float(1e-3 + rng.random() * 1e-3))
    if hists:
        add("counters", histograms={
            WARM: _hist(rng), "serve_padding_fraction": _hist(rng),
            "serve_queue_wait_seconds": _hist(rng),
            "assim_analysis_wall_seconds": _hist(rng)})
    return recs


def _write(path, recs):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return str(path)


_FNS = ("slis_from_ledger", "soak_slis_from_ledger",
        "elastic_slis_from_ledger", "assim_slis_from_ledger")


@pytest.mark.parametrize("fn", _FNS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slis_from_ledger_equal_reference(fn, seed):
    for lost, hists in ((0, True), (1, True), (2, False)):
        recs = _ledger(seed, lost=lost, hists=hists)
        assert getattr(tslo, fn)(recs) == getattr(jslo, fn)(recs)
    assert getattr(tslo, fn)([]) == getattr(jslo, fn)([])


def test_slis_from_drill_and_names_equal_reference():
    rng = np.random.default_rng(7)
    for _ in range(6):
        drill = {"warm_first_step_s": float(rng.random()),
                 "warm_p99_s": (float(rng.random()) if rng.random() < 0.5
                                else None),
                 "warm_compiles": int(rng.integers(0, 2)),
                 "warm_hits": int(rng.integers(0, 4)),
                 "cold_ok": bool(rng.random() < 0.8), "warm_ok": True}
        if rng.random() < 0.5:
            drill["histograms"] = {WARM: _hist(rng),
                                   "serve_padding_fraction": _hist(rng)}
        assert tslo.slis_from_drill(drill) == jslo.slis_from_drill(drill)
    for name in ("CEILINGS", "FLOORS", "SOAK_SLI_NAMES",
                 "ELASTIC_SLI_NAMES", "ASSIM_SLI_NAMES", "SLO_SCHEMA"):
        assert getattr(tslo, name) == getattr(jslo, name)


def test_evaluate_and_tighten_equal_reference(tmp_path):
    rng = np.random.default_rng(11)
    recs = _ledger(5, lost=0)
    slis = {**tslo.slis_from_ledger(recs), **tslo.soak_slis_from_ledger(
        recs), **tslo.elastic_slis_from_ledger(recs),
        **tslo.assim_slis_from_ledger(recs)}
    budget = {k: ({"floor": float(rng.random())} if rng.random() < 0.3
                  else {"ceiling": float(rng.random())})
              for k in slis}
    budget["bogus"] = {}
    budget["absent_sli"] = {"ceiling": 1.0}
    assert tslo.evaluate(slis, {"slos": budget}) == \
        jslo.evaluate(slis, {"slos": budget})
    assert tslo.tighten_contract(slis, {"n": 8})["slos"] == \
        jslo.tighten_contract(slis, {"n": 8})["slos"]
    cpath = _write(tmp_path / "c.json", [])
    json.dump({"slo_schema": 1, "slos": {"x": {"ceiling": 1}}},
              open(cpath, "w"))
    for t, j in ((tslo.tighten_soak, jslo.tighten_soak),
                 (tslo.tighten_elastic, jslo.tighten_elastic),
                 (tslo.tighten_assim, jslo.tighten_assim)):
        assert t(slis, {"k": 1}, cpath) == j(slis, {"k": 1}, cpath)


@pytest.mark.parametrize("section", ["", "--soak", "--elastic", "--assim"])
def test_check_exit_codes_on_ledgers(tmp_path, capsys, section):
    """0 clean / 2 violated / 1 unbudgeted or unmeasurable, as the
    reference's gate decides on the same ledger and contract."""
    key = {"": "slos", "--soak": "soak_slos", "--elastic": "elastic_slos",
           "--assim": "assim_slos"}[section]
    fn = {"": "slis_from_ledger", "--soak": "soak_slis_from_ledger",
          "--elastic": "elastic_slis_from_ledger",
          "--assim": "assim_slis_from_ledger"}[section]
    lp = _write(tmp_path / "ledger.jsonl", _ledger(3, lost=0))
    slis = getattr(tslo, fn)(_ledger(3, lost=0))
    loose = {k: {"ceiling": 1e9} for k, v in slis.items() if v is not None}
    tight = dict(loose)
    name = sorted(loose)[0]
    tight[name] = {"ceiling": -1.0}
    absent = dict(loose, never_measured={"ceiling": 1.0})
    cases = [({"slo_schema": 1, "slos": {}, key: loose}, 0),
             ({"slo_schema": 1, "slos": {}, key: tight}, 2),
             ({"slo_schema": 1, "slos": {}, key: absent}, 1)]
    if section:
        cases.append(({"slo_schema": 1, "slos": {}}, 1))
    for k, (doc, want) in enumerate(cases):
        cpath = str(tmp_path / f"c{k}.json")
        json.dump(doc, open(cpath, "w"))
        argv = ["check", "--ledger", lp, "--contract", cpath, "--json"] + (
            [section] if section else [])
        got_t = tslo.main(argv)
        out_t = json.loads(capsys.readouterr().out)
        got_j = jslo.main(argv)
        out_j = json.loads(capsys.readouterr().out)
        assert got_t == got_j == want
        assert out_t == out_j
    assert tslo.main(["check", "--ledger", lp, "--contract",
                      str(tmp_path / "absent.json")] + (
                          [section] if section else [])) == 1
    capsys.readouterr()


def test_check_tighten_merges_sections(tmp_path, capsys):
    lp = _write(tmp_path / "ledger.jsonl", _ledger(4, lost=0))
    cpath = str(tmp_path / "SLO.json")
    json.dump({"slo_schema": 1,
               "slos": {"warm_first_step_p99_s": {"ceiling": 2.0}}},
              open(cpath, "w"))
    for flag in ("--soak", "--elastic", "--assim"):
        assert tslo.main(["check", flag, "--ledger", lp, "--contract",
                          cpath, "--tighten"]) == 0
    doc = json.load(open(cpath))
    assert doc["slos"] == {"warm_first_step_p99_s": {"ceiling": 2.0}}
    assert doc["soak_slos"]["soak_lost_requests"] == {"ceiling": 0}
    assert doc["elastic_slos"]["elastic_lost_requests"] == {"ceiling": 0}
    assert doc["assim_slos"]["assim_lost_cycles"] == {"ceiling": 0}
    assert tslo.main(["check", "--soak", "--ledger", lp, "--contract",
                      cpath]) == 0
    capsys.readouterr()


def test_committed_contract_sections_and_invariants():
    port = tslo.load_contract()
    ref = jslo.load_contract()
    assert tslo.CONTRACT_PATH == os.path.join(REPO, "ibamr_tpu_torch",
                                              "SLO.json")
    for sec in ("drill", "soak", "elastic", "assim"):
        assert port[sec] == ref[sec]
    for sec in ("slos", "soak_slos", "elastic_slos", "assim_slos"):
        assert set(port[sec]) == set(ref[sec])
    pinned = {("slos", "warm_path_compiles"): 0,
              ("slos", "quarantine_rate"): 0.0,
              ("soak_slos", "soak_lost_requests"): 0,
              ("elastic_slos", "elastic_lost_requests"): 0,
              ("elastic_slos", "elastic_restart_fresh_compiles"): 0,
              ("assim_slos", "assim_lost_cycles"): 0,
              ("assim_slos", "assim_forecast_error_ratio"): 0.25}
    for (sec, name), want in pinned.items():
        assert port[sec][name] == {"ceiling": want} == ref[sec][name]
    assert "calibrated from the port's own runs on the CPU" in port["_doc"]


def test_fresh_drill_attains_the_committed_contract(tmp_path, capsys):
    """``check --device cpu`` runs the port's cold/warm drill at the
    contract's sizes (8^3, 2 lanes, 3 steps, 8 warm requests) and exits
    0 against the committed contract."""
    from ibamr_tpu_torch import obs as tobs

    tobs.reset_metrics()        # hermetic histograms for this ledger
    rc = tslo.main(["check", "--device", "cpu", "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0, doc
    assert doc["slis"]["warm_path_compiles"] == 0
    assert doc["slis"]["quarantine_rate"] == 0.0
    assert doc["slis"]["padding_fraction"] == 0.5
