"""Port parity of the telemetry bus (``ibamr_tpu_torch/obs``) against
``ibamr_tpu/obs`` on the CPU: histogram percentiles, the Prometheus
text, the ledger's torn-tail and non-finite handling, span nesting and
the shard merge give the same results for the same operations."""

import json
import math
import os

import numpy as np
import pytest

from ibamr_tpu import obs as jobs
from ibamr_tpu_torch import obs as tobs

RNG = np.random.default_rng(20261018)


def test_quantiles_from_counts_match_reference_and_numpy():
    vals = 10.0 ** RNG.uniform(-5, 1, size=2000)
    bounds = tobs.HISTOGRAM_BOUNDS
    assert bounds == jobs.HISTOGRAM_BOUNDS
    counts = [0] * (len(bounds) + 1)
    for v in vals:
        counts[np.searchsorted(bounds, v, side="right")] += 1
    qs = [0.0, 0.1, 0.5, 0.9, 0.99, 1.0]
    got = tobs.quantiles_from_counts(counts, qs)
    assert got == jobs.quantiles_from_counts(counts, qs)
    ratio = 10 ** (1 / 6)
    for q, est in zip(qs[1:-1], got[1:-1]):
        ref = float(np.quantile(vals, q))
        # the estimator interpolates inside one bucket of the lattice
        assert ref / ratio <= est <= ref * ratio
    h_t = tobs.histogram("torch_obs_test_seconds", case="q")
    h_j = jobs.histogram("torch_obs_test_seconds", case="q")
    for h in (h_t, h_j):
        for i in range(len(h.counts)):
            h.counts[i] = 0
        h.sum = 0.0
        for v in vals:
            h.observe(v)
    assert h_t.counts == h_j.counts and h_t.sum == h_j.sum
    assert [h_t.quantile(q) for q in qs] == [h_j.quantile(q) for q in qs]
    assert tobs.quantiles_from_counts([0] * 56, [0.5]) == [None]


def _ops(bus):
    bus.describe("torch_obs_test_total", "Test counter.")
    bus.counter("torch_obs_test_total", kind="a").inc(3)
    bus.counter("torch_obs_test_total", kind='b"q').inc()
    bus.gauge("torch_obs_test_depth", writer="single").set(2.5)
    h = bus.histogram("torch_obs_test_wall", stage="x")
    for v in (1e-4, 3e-3, 0.2, 5.0, 2e3):
        h.observe(v)
    snap = bus.metrics_snapshot()
    keep = {kind: {k: v for k, v in d.items()
                   if k.startswith("torch_obs_test_")}
            for kind, d in snap.items()}
    return keep


def test_prometheus_text_matches_reference():
    tsnap, jsnap = _ops(tobs), _ops(jobs)
    assert tsnap == jsnap
    t = tobs.prometheus_text(**tsnap)
    j = jobs.prometheus_text(**jsnap)
    assert t == j
    assert '# HELP torch_obs_test_total Test counter.' in t
    assert 'torch_obs_test_wall_bucket{le="+Inf",stage="x"} 5' in t


def test_ledger_torn_tail_and_non_finite(tmp_path):
    out = {}
    for name, bus in (("t", tobs), ("j", jobs)):
        path = str(tmp_path / f"{name}.jsonl")
        with bus.ledger(path, run_id="r0"):
            bus.emit("probe", value=float("nan"), arr=np.array([1.0,
                                                                math.inf]),
                     ok=True)
        with open(path, "ab") as f:
            f.write(b'{"seq": 9, "kind": "torn"')       # a kill mid-write
        led = bus.RunLedger(path, run_id="r0")          # resume the file
        led.append("after", {"x": 1})
        led.close()
        recs = bus.read_ledger(path)
        out[name] = [{k: v for k, v in r.items()
                      if k not in ("t", "pid", "overhead_s")} for r in recs]
    assert out["t"] == out["j"]
    # the resumed ledger's run_start (seq 3) lands on the torn line's
    # bytes and is skipped with it; the sequence continues after both
    kinds = [r["kind"] for r in out["t"]]
    assert kinds == ["run_start", "probe", "run_end", "after"]
    assert [r["seq"] for r in out["t"]] == [0, 1, 2, 4]
    probe = out["t"][1]
    assert probe["value"] is None and probe["arr"] == [1.0, None]


def _nested(bus, path):
    with bus.ledger(path, run_id="r1"):
        with bus.span("outer", step=1):
            with bus.span("mid"):
                with bus.span("inner"):
                    pass
            try:
                with bus.span("boom"):
                    raise ValueError("x")
            except ValueError:
                pass
    return [(r["name"], r["path"], r["depth"], r.get("error"),
             r.get("attrs")) for r in bus.read_ledger(path)
            if r["kind"] == "span"]


def test_span_nesting_matches_reference(tmp_path):
    t = _nested(tobs, str(tmp_path / "t.jsonl"))
    j = _nested(jobs, str(tmp_path / "j.jsonl"))
    assert t == j
    assert t[0] == ("inner", "outer/mid/inner", 2, None, None)
    assert t[-1] == ("outer", "outer", 0, None, {"step": 1})
    assert ("boom", "outer/boom", 1, "ValueError", None) in t


def test_shard_merge_matches_reference(tmp_path):
    for proc in (0, 1):
        path = tobs.shard_path(str(tmp_path) + os.sep, proc)
        assert path == jobs.shard_path(str(tmp_path) + os.sep, proc)
        with tobs.ledger(str(tmp_path) + os.sep, run_id="same", proc=proc):
            tobs.counter("torch_obs_test_total", kind="m").inc(proc + 1)
            tobs.chunk_boundary(step=proc, chunk_wall_s=0.5)
    t, j = tobs.merge_ledgers(str(tmp_path)), jobs.merge_ledgers(
        str(tmp_path))
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True)
    assert t["procs"] == ["0", "1"] and t["run_id"] == "same"
    assert tobs.fleet_prometheus_text(t) == jobs.fleet_prometheus_text(j)
    with pytest.raises(ValueError):
        other = tmp_path / "ledger-2.jsonl"
        with tobs.ledger(str(other), run_id="other"):
            pass
        tobs.merge_ledgers(str(tmp_path))
