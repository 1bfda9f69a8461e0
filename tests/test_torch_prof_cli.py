"""Port parity of the profile CLI (``ibamr_tpu_torch/tools/prof.py``)
against the reference's ``tools/prof.py`` on the CPU.

``diff`` gives the reference's verdict and text on the same attributed
summaries (capture dirs, summary files and summaries embedded in JSON
documents; a clean self-diff, an inflated chunk, noise inside the band,
a tightened band and floor, the comm gate advisory on a capture without
a device lane and enforced on one with it). ``show``, ``check`` and
``archive`` print and refuse as the reference does, and ``attribute
--ledger`` on a torch capture appends the reference's ``device_time``
record."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from ibamr_tpu_torch import obs as tobs
from ibamr_tpu_torch.obs import deviceprof as tdp
from ibamr_tpu_torch.tools import prof as tprof
from tools import prof as jprof

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


def _trace(scale=1.0, comm_scale=1.0, seed=0):
    """A torch trace of 4 chunks: random kernel times inside the host
    ``chunk`` range (scaled by ``scale``), one NCCL kernel (scaled by
    ``comm_scale``) and a memcpy outside every range."""
    rng = np.random.default_rng(seed)
    ev = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
           "args": {"name": "stream 7"}}]
    corr = 0
    for c in range(4):
        t0 = 10000.0 * c
        ev.append({"ph": "X", "cat": "user_annotation", "name": "chunk",
                   "pid": 1, "tid": 1, "ts": t0, "dur": 5000.0})
        for j, name in enumerate(("packed_spread_kernel", "regular_fft",
                                  "elementwise_kernel",
                                  "ncclDevKernel_AllReduce")):
            corr += 1
            dur = float(rng.uniform(100, 400)) * (
                comm_scale if "nccl" in name else scale)
            ev.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
                       "ts": t0 + 10 + j, "dur": 2.0,
                       "args": {"correlation": corr}})
            ev.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                       "tid": 7, "ts": t0 + 100 + 500 * j, "dur": dur,
                       "args": {"correlation": corr}})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
               "pid": 0, "tid": 7, "ts": 90000.0, "dur": 50.0,
               "args": {"correlation": 999}})
    return {"traceEvents": ev}


def _capture(tmp_path, name, **kw):
    cap = tmp_path / name / "cap"
    cap.mkdir(parents=True)
    (cap / "trace.json").write_text(json.dumps(_trace(**kw)))
    assert tprof.main(["attribute", str(cap), "--span",
                       "driver/chunk"]) == 0
    return str(cap)


def _both(argv, capsys):
    rt = tprof.main(argv)
    ot = capsys.readouterr()
    rj = jprof.main(argv)
    oj = capsys.readouterr()
    return (rt, ot.out, ot.err), (rj, oj.out, oj.err)


DIFFS = {
    "self": (dict(), []),
    "inflated": (dict(scale=10.0), []),
    "noise": (dict(scale=1.1), []),
    "tight_band": (dict(scale=1.1), ["--tol-pct", "5"]),
    "tight_floor": (dict(scale=1.1), ["--tol-pct", "5", "--abs-floor",
                                      "10e-6"]),
    "comm_gate": (dict(comm_scale=3.0), ["--comm-tol-pct", "10",
                                         "--abs-floor", "1e-6"]),
}


@pytest.mark.parametrize("case", sorted(DIFFS))
def test_diff_verdicts_match_reference(tmp_path, case, capsys):
    kw, flags = DIFFS[case]
    a = _capture(tmp_path, "a")
    b = a if case == "self" else _capture(tmp_path, "b", **kw)
    if case == "comm_gate":
        # the port's torch lane is a device lane; the reference knows a
        # device lane by its trace-viewer process name only
        assert tprof.main(["diff", a, b, *flags]) == 2
        for cap in (a, b):
            s = tdp.read_summary(cap)
            for lane in s["lanes"]:
                lane["process"] = "/device:GPU:0"
            tdp.write_summary(cap, s)
    capsys.readouterr()
    for pair in ((a, b), (b, a)):
        got, ref = _both(["diff", *pair, *flags], capsys)
        assert got == ref
    if case in ("self", "noise"):
        assert got[0] == 0
    if case == "inflated":
        assert tprof.main(["diff", a, b]) == 2
        assert tprof.main(["diff", b, a]) == 1


def test_comm_gate_advisory_without_device_lane(tmp_path, capsys):
    """Strip the lanes (as a capture with no GPU lane has none): the
    comm gate only advises, in both CLIs."""
    a = _capture(tmp_path, "a")
    b = _capture(tmp_path, "b", comm_scale=3.0)
    for cap in (a, b):
        s = tdp.read_summary(cap)
        s["lanes"] = []
        tdp.write_summary(cap, s)
    capsys.readouterr()
    argv = ["diff", a, b, "--comm-tol-pct", "10", "--abs-floor", "1e-6"]
    got, ref = _both(argv, capsys)
    assert got == ref and "ADVISORY" in got[1]


def test_diff_of_embedded_summaries(tmp_path, capsys):
    a = _capture(tmp_path, "a")
    b = _capture(tmp_path, "b", scale=10.0)

    def doc(cap, path):
        payload = {"profiles": [{"dir": cap, "stage": "flagship",
                                 "summary": tdp.compact_summary(
                                     tdp.read_summary(cap))}]}
        path.write_text(json.dumps(payload))
        return str(path)

    ja, jb = doc(a, tmp_path / "A.json"), doc(b, tmp_path / "B.json")
    capsys.readouterr()
    for pair in ((ja, ja), (ja, jb), (jb, ja)):
        got, ref = _both(["diff", *pair], capsys)
        assert got == ref
    assert tprof.main(["diff", ja, jb]) == 2
    assert tprof.load_summaries(ja) == jprof.load_summaries(ja)


def test_show_check_archive_match_reference(tmp_path, capsys):
    a = _capture(tmp_path, "a")
    capsys.readouterr()
    got, ref = _both(["show", a], capsys)
    assert got == ref and "per-span device time" in got[1]
    assert tprof.render_summary(tdp.read_summary(a)) == \
        jprof.render_summary(tdp.read_summary(a))
    got, ref = _both(["check", a], capsys)
    assert got == ref and got[0] == 0
    s = tdp.read_summary(a)
    bad = copy.deepcopy(s)
    bad["attributed_s"] = -1.0
    with open(os.path.join(a, tdp.SUMMARY_NAME), "w") as f:
        json.dump(bad, f)
    for argv in (["check", a], ["archive", a]):
        got, ref = _both(argv, capsys)
        assert got == ref and got[0] == 2
    assert tdp.find_trace_files(a)
    tdp.write_summary(a, s)
    assert tprof.main(["archive", a]) == 0
    assert tdp.find_trace_files(a) == []
    assert tdp.validate_summary(tdp.read_summary(a)) == []


def test_attribute_appends_the_device_time_record(tmp_path, capsys):
    led = tmp_path / "run" / "ledger.jsonl"
    with tobs.ledger(str(led)):
        with tobs.span("driver/chunk"):
            pass
    cap = tmp_path / "cap"
    cap.mkdir()
    (cap / "trace.json").write_text(json.dumps(_trace()))
    assert tprof.main(["attribute", str(cap), "--ledger", str(led),
                       "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["spans"]["driver/chunk"]["device_s"] > 0
    recs = tobs.read_ledger(str(led))
    dev = [r for r in recs if r["kind"] == "device_time"]
    assert len(dev) == 1 and dev[0]["seq"] == recs[-2]["seq"] + 1
    assert set(dev[0]) == {"seq", "run_id", "t", "kind", "capture_dir",
                           "total_device_s", "attributed_s",
                           "unattributed_s", "fraction_attributed",
                           "spans", "op_classes"}
    assert dev[0]["run_id"] == recs[0]["run_id"]
    assert dev[0]["op_classes"]["comm_s"] > 0
    assert dev[0]["op_classes"]["fft_s"] > 0
