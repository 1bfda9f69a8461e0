"""Port parity of the run-ledger CLI (``ibamr_tpu_torch/tools/obs.py``)
against the reference's ``tools/obs.py`` on the CPU.

One ledger carries every record kind the renderers read (spans,
counter snapshots with labeled counters, gauges and histograms, the
executable cache's records, requests with their admissions, sheds and
retries, tuner trials, pool scaling, design iterations, assimilation
cycles with QC rejections and inflation escalations, incidents,
replays and a ``device_time`` attribution), its values drawn from a
numpy seed. Each renderer of both modules gives the same lines for the
same records, and ``summary`` (with ``--device`` and ``--fleet``),
``tail``, ``trace`` and ``compare`` print the same text."""

import json
import os
import time

import numpy as np
import pytest
import torch

from ibamr_tpu_torch import obs as tobs
from ibamr_tpu_torch.tools import obs as tcli
from tools import obs as jcli

RNG = np.random.default_rng(20261018)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u(lo=0.0, hi=1.0):
    return float(RNG.uniform(lo, hi))


def _write_ledger(path, proc=None, fingerprint=None, scale=1.0):
    """A run ledger with every record kind the renderers read; returns
    the trace id of one served request."""
    tobs.reset_metrics()
    fp = fingerprint or {"platform": "cpu", "engine": "pallas_packed",
                         "spectral_dtype": "f32", "config_digest": "ab" * 8}
    tid = None
    with tobs.ledger(path, fingerprint=fp, proc=proc):
        for chunk in range(3):
            with tobs.span("driver/chunk", step=2 * chunk, length=2):
                with tobs.span("interp"):
                    pass
            tobs.counter("driver_steps_total").inc(2)
            tobs.counter("aot_cache_hits_total").inc(int(RNG.integers(1, 5)))
            tobs.counter("aot_cache_misses_total").inc()
            for reason in ("dropout", "stale", "outlier"):
                tobs.counter("assim_qc_rejections_total",
                             reason=reason).inc()
            tobs.counter("serve_shed_total", reason="queue_full").inc()
            tobs.counter("serve_retries_total", reason="timeout").inc()
            tobs.gauge("serve_families_live").set(float(chunk + 1))
            tobs.histogram("serve_queue_wait_seconds").observe(_u(1e-3, 0.2))
            tobs.histogram("driver_chunk_wall_seconds").observe(
                _u(0.01, 0.1) * scale)
            tobs.chunk_boundary(step=2 * chunk + 2,
                                chunk_wall_s=_u(0.01, 0.1) * scale)
        for event in ("miss", "hit", "hit", "evict", "release", "corrupt"):
            tobs.emit("aot_cache", event=event, key=f"{RNG.integers(9999)}",
                      label="assim_analyze", compile_s=_u())
        for i in range(4):
            t = tobs.new_trace_id()
            tid = tid or t
            with tobs.trace_scope(t):
                tobs.emit("request_admit", scenario="shell", bucket=8,
                          tenant_class=("gold", "bronze")[i % 2])
                with tobs.span("serve/request"):
                    pass
                if i == 3:
                    tobs.emit("request_shed", reason="queue_full",
                              queue_wait_s=_u(), tenant_class="bronze")
                    tobs.emit("request_retry", reason="timeout", attempt=1)
                else:
                    tobs.emit("request", cold=i == 0,
                              first_step_s=_u(0.1, 2.0), queue_wait_s=_u(),
                              tenant_class=("gold", "bronze")[i % 2],
                              verdict="ok")
        for eng in ("pallas_packed", "scatter", "packed"):
            tobs.emit("tune_trial", engine=eng, n=16, markers=128,
                      steps_per_s=_u(5, 50), warmup_s=_u(), chunk_length=4,
                      dtype="f32", cache_hit=bool(RNG.integers(2)))
        tobs.emit("tune_trial", engine="mxu", n=16, markers=128,
                  error="RuntimeError: boom")
        for action, reason in (("warmed", "load"), ("drained", "idle")):
            tobs.emit("pool_scale", action=action, reason=reason,
                      warm_s=_u(), family="shell")
        tobs.emit("serve_mode", prev="normal", mode="brownout")
        tobs.emit("serving_manifest", families=2, path="m.json")
        tobs.emit("serving_restore", fresh_compiles=0, families=2)
        for it in range(3):
            tobs.emit("design_iter", label="eel", iteration=it,
                      objective=_u(), cache_misses=int(it == 0),
                      wall_s=_u(0.1, 1.0), grad_norm=_u())
        for cyc in range(4):
            tobs.emit("assim_cycle", cycle=cyc, step=2 * cyc + 2,
                      skipped=cyc == 0, forecast_error=_u(1e-5, 1e-3),
                      spread_f=_u(1e-4, 1e-3), spread_a=_u(1e-5, 1e-4),
                      consistency=_u(0.5, 2.0), inflation=1.05,
                      n_alive=5, n_obs=4, analysis_wall_s=_u())
            tobs.emit("assim_qc_reject", instrument=f"flux[{cyc % 2}]",
                      reason=("dropout", "outlier", "stale")[cyc % 3],
                      cycle=cyc, step=2 * cyc + 2, value=None,
                      innovation=None, threshold=_u(), age_s=0.0)
        tobs.emit("incident", event="divergence", step=5, reason="nan",
                  rollback_step=4, dt_after=5e-4)
        tobs.emit("incident", event="inflation_escalation",
                  inflation_before=1.0, inflation_after=1.05, step=6)
        tobs.emit("replay", verdict="reproduced", capsule="x", bitwise=True)
        tobs.emit("assim_summary", forecast_error=1e-4,
                  open_loop_error=4e-4, cycles=4)
        tobs.emit("device_time", capture_dir="cap", total_device_s=0.05,
                  attributed_s=0.048, unattributed_s=0.002,
                  fraction_attributed=0.96,
                  spans={"driver/chunk": 0.047 * scale,
                         "driver/chunk/interp": 0.001},
                  op_classes={"fft_s": 0.03, "dot_s": 0.0, "comm_s": 0.001,
                              "other_s": 0.019})
    return tid


@pytest.fixture
def ledger(tmp_path):
    path = str(tmp_path / "run" / "ledger.jsonl")
    tid = _write_ledger(path)
    return path, tid


RENDERERS = ("render_serving", "render_tuning", "render_traffic",
             "render_elastic", "render_design", "render_assim")


@pytest.mark.parametrize("name", RENDERERS)
def test_block_renderers_match_reference(ledger, name):
    path, _ = ledger
    records = tobs.read_ledger(path)
    snap = tcli.last_counters(records)
    assert snap == jcli.last_counters(records)
    got = getattr(tcli, name)(snap, records)
    assert got, name
    assert got == getattr(jcli, name)(snap, records)


def test_tree_counter_latency_incident_device_renderers_match(ledger):
    path, tid = ledger
    records = tobs.read_ledger(path)
    snap = tcli.last_counters(records)
    assert tcli.span_tree(records) == jcli.span_tree(records)
    assert tcli.render_span_tree(records, 1.0) == \
        jcli.render_span_tree(records, 1.0)
    assert tcli.render_counters(snap) == jcli.render_counters(snap)
    assert tcli.render_latency(snap) == jcli.render_latency(snap)
    assert tcli.render_incidents(records, 0.0) == \
        jcli.render_incidents(records, 0.0)
    dev = tcli.device_spans(records)
    assert dev == jcli.device_spans(records) and dev
    assert tcli.render_device_table(records, dev) == \
        jcli.render_device_table(records, dev)
    assert tcli.render_trace(records, tid) == jcli.render_trace(records, tid)
    for rec in records:
        assert tcli._one_line(rec) == jcli._one_line(rec)


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, out


@pytest.mark.parametrize("argv", [["summary"], ["summary", "--device"],
                                  ["trace"], ["tail"]])
def test_commands_print_the_reference_text(ledger, argv, capsys):
    path, tid = ledger
    args = [argv[0], path] + argv[1:]
    if argv[0] == "trace":
        args.append(tid[:8])
    if argv[0] == "tail":
        args += ["--max-seconds", "0.01", "--interval", "0.01"]
    rt, ot = _run(tcli.main, args, capsys)
    rj, oj = _run(jcli.main, args, capsys)
    assert (rt, ot) == (rj, oj)
    assert rt == 0 and ot


def test_compare_two_ledgers_and_two_fleets(tmp_path, capsys,
                                           monkeypatch):
    a = str(tmp_path / "a" / "ledger.jsonl")
    b = str(tmp_path / "b" / "ledger.jsonl")
    _write_ledger(a)
    _write_ledger(b, scale=3.0)
    fleets = []
    for name, scale in (("fa", 1.0), ("fb", 2.0)):
        d = str(tmp_path / name)
        os.makedirs(d)
        fp = {"platform": "cpu", "engine": "scatter", "config_digest": name}
        for proc in range(2):
            _write_ledger(d, proc=proc, fingerprint=fp, scale=scale)
        fleets.append(d)
    # both CLIs print the age of the last record from their own clock
    # reads: pin the clock for the CLI calls, after the ledgers' records
    # have read it, so that both render at the same ``now``
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)
    assert _run(tcli.main, ["compare", a, b], capsys) == \
        _run(jcli.main, ["compare", a, b], capsys)
    for argv in (["compare", *fleets], ["summary", fleets[0], "--fleet"]):
        rt, ot = _run(tcli.main, argv, capsys)
        rj, oj = _run(jcli.main, argv, capsys)
        assert (rt, ot) == (rj, oj) and ot, argv


def test_profile_entries_read_old_and_new_manifests():
    payloads = ({"profiles": ["/tmp/p/n256_ab12cd3"]},
                {"profiles": [{"dir": "/tmp/p/n256_ab12cd3", "stage": "n256",
                               "rev": "ab1", "bytes": 123,
                               "attributed": True,
                               "summary": {"total_device_s": 1.0}}]})
    for p in payloads:
        assert tcli._profile_entries(p) == jcli._profile_entries(p)
    recs = [{"kind": "span", "path": p, "dur_s": d} for p, d in
            (("a", 2.0), ("a/b", 0.5), ("a/b/c", 0.25), ("d", 1.0))]
    for p in ("a", "a/b", "a/b/c", "d"):
        assert tcli.percent_of_parent(tcli.span_tree(recs), p) == \
            jcli.percent_of_parent(jcli.span_tree(recs), p)
    assert json.dumps(tcli._fmt_s(0.5)) == json.dumps(jcli._fmt_s(0.5))
