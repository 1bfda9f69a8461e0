"""Port parity of the autotuner (``ibamr_tpu_torch/tune/``,
``ibamr_tpu_torch/tools/tune.py``) against ``ibamr_tpu/tune/`` and
``tools/tune.py`` on the CPU.

The port's ``enumerate_space``, ``validate_db``, ``shadowed_entries``
and ``merge_entry`` give the reference's answers (equal candidate and
prune lists, equal problem strings, equal documents) on the cases of
``tests/test_tune.py`` and on the committed ``TUNING_DB.json``; the check
gate's exit codes match the reference's on the same synthetic re-times;
a CPU search at 16^3 over ``scatter``, ``mxu`` and ``packed3`` finishes
with no trial error, and its published entry passes the reference's
``validate_db`` and steers the port's resolver under ``IBAMR_TUNING_DB``."""

import json
import os
import sys
from dataclasses import asdict
from pathlib import Path

import pytest
import torch

from ibamr_tpu.tune import db as jdb
from ibamr_tpu.tune import space as jspace
from ibamr_tpu_torch.models import engine_resolver as tres
from ibamr_tpu_torch.tools import tune as tcli
from ibamr_tpu_torch.tune import db as tdb
from ibamr_tpu_torch.tune import space as tspace
from ibamr_tpu_torch.tune import runner as trunner
from ibamr_tpu_torch.tune.runner import (TrialResult, db_entry_from_search,
                                         entry_from_search_dict, run_trial,
                                         search)

ROOT = Path(__file__).resolve().parent.parent
SUPPORT = 4


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One PyTorch CPU thread per test (the suite runs in parallel
    workers), and no engine override or tuning DB from the environment."""
    monkeypatch.delenv(tres.ENV_ENGINE, raising=False)
    monkeypatch.delenv(tres.ENV_TUNING_DB, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(cands, pruned):
    return ([asdict(c) for c in cands],
            [(asdict(c), r.replace("compile probe", "probe")
              .replace("kernel probe", "probe")) for c, r in pruned])


SPACE_CASES = {
    "not_8_divisible": dict(n=(12, 12, 12), n_markers=4096,
                            engines=("scatter", "packed", "packed3"),
                            spectral_dtypes=("f32",), chunk_lengths=(1,)),
    "no_z_tile": dict(n=(16, 16, 12), n_markers=4096,
                      engines=("scatter", "packed", "packed3"),
                      spectral_dtypes=("f32",), chunk_lengths=(1,)),
    "small_markers": dict(n=(16, 16, 16), n_markers=128,
                          engines=("scatter", "packed"),
                          spectral_dtypes=("f32",), chunk_lengths=(1,)),
    "bf16_walls": dict(n=(16, 16, 16), n_markers=128,
                       engines=("scatter", "packed"),
                       spectral_dtypes=("f32", "bf16"), chunk_lengths=(1,),
                       bc="dirichlet"),
    "default_menu": dict(n=(16, 16, 16), n_markers=128),
    "flagship_all": dict(n=(256, 256, 256), n_markers=99856,
                         engines=tres.RESOLVED_ENGINES),
}


@pytest.mark.parametrize("case", sorted(SPACE_CASES))
def test_enumerate_space_matches_reference(case):
    kw = dict(SPACE_CASES[case])
    n, markers = kw.pop("n"), kw.pop("n_markers")
    assert _rows(*tspace.enumerate_space(n, markers, SUPPORT, **kw)) \
        == _rows(*jspace.enumerate_space(n, markers, SUPPORT, **kw))
    assert tspace.DEFAULT_ENGINES == jspace.DEFAULT_ENGINES
    assert tspace.PROBED_ENGINES == jspace.PROBED_ENGINES


def test_probe_gating_memoized_and_unknown_engine():
    calls = []

    def probe(engine):
        calls.append(engine)
        raise RuntimeError("the kernel did not build")

    kw = dict(engines=("scatter", "pallas_packed"),
              spectral_dtypes=("f32", "bf16"), chunk_lengths=(1, 4),
              probe_fn=probe)
    got = tspace.enumerate_space((16, 16, 16), 128, SUPPORT, **kw)
    assert calls == ["pallas_packed"]
    assert _rows(*got) == _rows(*jspace.enumerate_space(
        (16, 16, 16), 128, SUPPORT, **kw))
    assert all("the kernel did not build" in r for _, r in got[1])
    for mod in (tspace, jspace):
        with pytest.raises(ValueError, match="unknown engine"):
            mod.enumerate_space((16, 16, 16), 128, SUPPORT,
                                engines=("scatterr",))


def test_probe_runs_each_engine_on_the_cpu():
    probe = tspace.make_probe_fn((16, 16, 16), 8, 16, device="cpu")
    for engine in tres.RESOLVED_ENGINES:
        probe(engine)


DB_DOCS = {
    "bad_shapes": {"schema": 99, "entries": [
        {"engine": "warp9"},
        {"engine": "packed", "markers_min": 500, "markers_max": 100},
        {"engine": "mxu", "n_cells": "big"},
        {"engine": "scatter", "measured": {"steps_per_s": "fast"}},
        {"engine": "packed3", "provenance": {"timestamp": "x"}}]},
    "shadowed": {"schema": 1, "entries": [
        {"engine": "mxu", "markers_min": 50, "markers_max": 500},
        {"engine": "packed", "markers_min": 100, "markers_max": 400},
        {"engine": "packed3", "n_cells": 64}]},
    "more_specific_later": {"schema": 1, "entries": [
        {"engine": "mxu", "markers_min": 50, "markers_max": 500},
        {"engine": "packed", "n_cells": 64, "markers_min": 100,
         "markers_max": 400}]},
    "committed": json.loads((ROOT / "TUNING_DB.json").read_text()),
}


@pytest.mark.parametrize("case", sorted(DB_DOCS))
def test_validate_and_shadow_lint_match_reference(case):
    doc = DB_DOCS[case]
    assert tdb.validate_db(doc) == jdb.validate_db(doc)
    entries = doc.get("entries") or []
    assert tdb.shadowed_entries(entries) == jdb.shadowed_entries(entries)
    if case == "committed":
        assert tdb.validate_db(doc) == []
    if case == "shadowed":
        assert [(j, i) for j, i, _ in tdb.shadowed_entries(entries)] \
            == [(1, 0)]


def test_merge_entry_and_roundtrip_match_reference(tmp_path):
    docs = []
    for mod in (tdb, jdb):
        doc = {"schema": 1, "entries": []}
        e = dict(n=[16, 16, 16], markers_min=64, markers_max=256,
                 spectral_dtype="f32", platform="cpu",
                 provenance=mod.make_provenance("cpu", "2026-08-06"))
        mod.merge_entry(doc, mod.make_entry(
            "scatter", measured={"steps_per_s": 10.0}, **e))
        mod.merge_entry(doc, mod.make_entry(
            "packed", measured={"steps_per_s": 20.0}, **e))
        e2 = {**e, "platform": "cuda",
              "provenance": mod.make_provenance("cuda", "2026-08-06")}
        mod.merge_entry(doc, mod.make_entry(
            "mxu_bf16", measured={"steps_per_s": 30.0}, **e2))
        docs.append(doc)
    assert docs[0] == docs[1]
    assert [e["engine"] for e in docs[0]["entries"]] == ["packed",
                                                         "mxu_bf16"]
    p = tmp_path / "db.json"
    full = tdb.new_db()
    full["entries"] = docs[0]["entries"]
    tdb.save_db(full, str(p))
    assert tdb.load_db(str(p)) == full == jdb.load_db(str(p))
    with pytest.raises(ValueError, match="platform"):
        tdb.make_provenance("", "2026-08-06")


def _cpu_doc(winner="packed", winner_sps=90.0, runner="scatter",
             runner_sps=30.0):
    doc = tdb.new_db()
    tdb.merge_entry(doc, tdb.make_entry(
        winner, n=[16, 16, 16], markers_min=64, markers_max=256,
        spectral_dtype="f32", platform="cpu",
        measured={"steps_per_s": winner_sps, "chunk_length": 1,
                  "reps": 2, "n_lat": 8, "n_lon": 16,
                  "runner_up": runner, "runner_up_steps_per_s": runner_sps,
                  "runner_up_chunk_length": 1,
                  "margin": round(winner_sps / runner_sps, 4)},
        provenance=tdb.make_provenance("cpu", "2026-08-06")))
    return doc


def test_check_exit_codes_match_reference():
    sys.path.insert(0, str(ROOT / "tools"))
    import tune as jcli

    def fake(rates):
        def retime(cand, **kw):
            return TrialResult(candidate=cand,
                               steps_per_s=rates.get(cand.engine, 0.0))
        return retime

    for doc, platform, rates, rc in (
            (_cpu_doc(), "cpu", {"packed": 91.0, "scatter": 31.0}, 0),
            (_cpu_doc(), "cpu", {"packed": 50.0, "scatter": 31.0}, 1),
            (_cpu_doc(), "cpu", {"packed": 30.0, "scatter": 90.0}, 2),
            ({"schema": 99, "entries": []}, "cpu", {}, 2),
            (_cpu_doc(), "cuda", {}, 0)):
        got, lines = tcli.check_db(doc, platform=platform,
                                   retime_fn=fake(rates))
        ref, _ = jcli.check_db(doc, platform=platform,
                               retime_fn=fake(rates))
        assert got == ref == rc, lines
    # the command on a DB of another platform's entries: schema and lint
    # only, no device touched
    assert tcli.main(["check", "--db", str(ROOT / "TUNING_DB.json")]) == 0
    assert tcli.main(["show", "--db", str(ROOT / "TUNING_DB.json")]) == 0


def test_cpu_search_publishes_an_entry_the_resolver_picks(tmp_path,
                                                          monkeypatch):
    res = search(n_cells=16, n_lat=8, n_lon=16,
                 engines=("scatter", "mxu", "packed3"),
                 spectral_dtypes=("f32",), chunk_lengths=(1,), reps=1,
                 device="cpu")
    assert not res.pruned and len(res.trials) == 3
    assert all(t.error is None and t.steps_per_s > 0 for t in res.trials)
    d = res.to_dict()
    assert d["winner"]["engine"] in ("scatter", "mxu", "packed3")
    assert d["runner_up"]["engine"] != d["winner"]["engine"]
    entry = db_entry_from_search(res, platform="cpu",
                                 timestamp="2026-10-18",
                                 device_kind="host",
                                 torch_version=torch.__version__)
    doc = {"schema": 1, "entries": [entry]}
    assert jdb.validate_db(doc) == [] == tdb.validate_db(doc)
    p = tmp_path / "db.json"
    assert tcli.publish_entries([entry], str(p)) == []
    monkeypatch.setenv(tres.ENV_TUNING_DB, str(p))
    w = res.winner().candidate
    assert tres.resolve_engine((16, 16, 16), 128, SUPPORT,
                               spectral_dtype=w.spectral_dtype,
                               platform="cpu") == w.engine
    # the printed line publishes the same entry
    line = json.loads(json.dumps({**d, "platform": "cpu"}))
    twin = entry_from_search_dict(line, platform="cpu",
                                  timestamp="2026-10-18",
                                  device_kind="host",
                                  torch_version=torch.__version__)
    assert twin == entry and twin["markers_max"] == 256


def test_publish_refuses_probe_prune_and_trial_error(tmp_path, monkeypatch,
                                                     capsys):
    """A kernel engine its probe prunes, or a trial that fails, never
    yields a DB entry: ``search --publish`` and ``publish`` write nothing
    and exit 2, while ``search`` alone still reports the prune."""
    def raising_probe_fn(*a, **kw):
        def probe(engine):
            raise RuntimeError("no kernel image for this device")
        return probe

    monkeypatch.setattr(trunner, "make_probe_fn", raising_probe_fn)
    db = tmp_path / "db.json"
    argv = ["search", "--cpu", "--n", "16", "--engines",
            "scatter,pallas_packed", "--dtypes", "f32", "--chunk-lengths",
            "1", "--reps", "1", "--db", str(db)]
    assert tcli.main(argv) == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["winner"]["engine"] == "scatter"
    assert [p["engine"] for p in d["pruned"]] == ["pallas_packed"]
    assert len(trunner.publish_blockers(d)) == 1
    assert tcli.main(argv + ["--publish"]) == 2 and not db.exists()
    assert "no kernel image" in capsys.readouterr().err
    # a captured search whose trial failed: the offline publication
    # refuses too; the same capture without the failure publishes
    d["pruned"] = []
    d["trials"].append({**d["trials"][0], "engine": "packed3",
                        "steps_per_s": 0.0, "error": "RuntimeError: boom"})
    cap = tmp_path / "search.jsonl"
    cap.write_text(json.dumps(d) + "\n")
    assert tcli.main(["publish", str(cap), "--db", str(db)]) == 2
    assert not db.exists()
    d["trials"].pop()
    cap.write_text(json.dumps(d) + "\n")
    assert tcli.main(["publish", str(cap), "--db", str(db)]) == 0
    assert tdb.load_db(str(db))["entries"][0]["engine"] == "scatter"


def test_trial_build_failure_reported_not_raised():
    # no z tile at n_z = 12: the error lands in the result
    res = run_trial(tspace.Candidate(engine="packed3"), n_cells=12,
                    n_lat=6, n_lon=8, reps=1, device="cpu")
    assert res.error is not None and "z tile" in res.error
    assert res.steps_per_s == 0.0
    assert not os.path.exists(tres.DEFAULT_DB_PATH)
