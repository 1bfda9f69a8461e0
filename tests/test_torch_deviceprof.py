"""Port parity of device-time attribution (``ibamr_tpu_torch/obs/
deviceprof.py``) against ``ibamr_tpu/obs/deviceprof.py`` on the CPU.

The reference's synthetic trace-viewer cases (``tests/test_deviceprof.py``)
go through both modules and give equal summaries. Hand-built torch
(Kineto) Chrome traces cover the port's front end: the
``gpu_user_annotation`` rows that overlap the kernels are not counted,
a kernel finds its scope through its ``correlation`` id and the host
``user_annotation`` ranges around its launch, every kernel of a
``cudaGraphLaunch`` joins that launch, a kernel with no launch record
takes the device-side annotation ranges around it, the card's kernel
names fall into the FFT, GEMM and NCCL classes, and a trace with no GPU
process totals 0 and validates. Sums are exact (the same additions);
durations compare with ``pytest.approx`` at 1e-12."""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from ibamr_tpu.obs import deviceprof as jdp
from ibamr_tpu_torch.obs import deviceprof as tdp

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


# ---------------------------------------------------------------------------
# the reference's synthetic trace-viewer cases
# ---------------------------------------------------------------------------

def _meta(pid, pname, threads):
    out = [{"ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": pname}}]
    for tid, tname in threads.items():
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name", "args": {"name": tname}})
    return out


def _x(name, dur_us, pid=1, tid=1, ts=0, args=None, cat=None):
    e = {"ph": "X", "pid": pid, "tid": tid, "ts": ts, "dur": dur_us,
         "name": name, "args": args}
    if cat is not None:
        e["cat"] = cat
    return e


def _cpu_style_trace():
    events = _meta(1, "python", {1: "MainThread", 2: "pool-0"})
    events += [
        _x("FuncGraph", 5000, tid=1),
        _x("backend_compile", 2000, tid=1),
        _x("fusion.1", 500, tid=1,
           args={"hlo_module": "jit_chunk", "hlo_op": "fusion.1"}),
        _x("fft.2", 300, tid=2,
           args={"hlo_module": "jit_chunk", "hlo_op": "fft.2"}),
        _x("dot_general.3", 100, tid=2,
           args={"hlo_module": "jit_chunk", "hlo_op": "dot.3"}),
        _x("exp.4", 60, tid=2,
           args={"hlo_module": "jit_exp", "hlo_op": "exp.4"}),
        _x("mystery_op", 40, tid=2, args={"hlo_op": "mystery_op"}),
    ]
    return {"displayTimeUnit": "ns", "traceEvents": events}


def _tpu_style_trace():
    events = _meta(7, "/device:TPU:0 (chip 0)", {1: "Steps", 2: "XLA Ops"})
    events += _meta(3, "python", {1: "MainThread"})
    events += [
        _x("step 0", 1000, pid=7, tid=1),
        _x("fusion.9", 700, pid=7, tid=2,
           args={"tf_op": "jit(chunk)/driver/chunk/interp/fusion.9"}),
        _x("fft.1", 200, pid=7, tid=2,
           args={"tf_op": "jit(chunk)/driver/chunk/fft.1"}),
        _x("copy.2", 100, pid=7, tid=2, args={}),
        _x("all-reduce.3", 50, pid=7, tid=2,
           args={"tf_op": "jit(chunk)/driver/chunk/comm/all-reduce.3"}),
        _x("host python", 4000, pid=3, tid=1),
    ]
    return {"displayTimeUnit": "ns", "traceEvents": events}


CASES = {
    "cpu_module": (_cpu_style_trace, ["driver", "driver/chunk"], None),
    "tpu_scope": (_tpu_style_trace,
                  ["driver/chunk", "driver/chunk/interp"], None),
    "module_map": (_cpu_style_trace, [], {"jit_exp": "driver/warmup"}),
    "no_spans": (_tpu_style_trace, [], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_cases_give_equal_summaries(case):
    make, spans, module_map = CASES[case]
    ev_j, lanes_j = jdp.device_op_events(make())
    ev_t, lanes_t = tdp.trace_device_events(make())
    assert ev_t == ev_j and lanes_t == lanes_j
    sj = jdp.attribute_events(ev_j, spans, module_map)
    st = tdp.attribute_events(ev_t, spans, module_map)
    assert st == sj
    assert st["attributed_s"] + st["unattributed_s"] == pytest.approx(
        st["total_device_s"], rel=1e-12)


def test_span_leaf_map_and_validation_match_reference(tmp_path):
    paths = ["a/chunk", "chunk", "b/c/chunk", "driver/chunk/interp"]
    assert tdp.span_leaf_map(paths) == jdp.span_leaf_map(paths)
    ev, _ = jdp.device_op_events(_cpu_style_trace())
    s = jdp.attribute_events(ev, ["driver/chunk"])
    s.update(schema=jdp.PROF_SCHEMA)
    for bad in (s, dict(s, attributed_s=0.0), dict(s, schema=99),
                dict(s, fraction_attributed=1.5), "not a dict",
                dict(s, spans={"x": {"device_s": -1.0}})):
        assert tdp.validate_summary(bad) == jdp.validate_summary(bad)
    full = dict(s, census={"label": "n16", "n": 16, "executions": 2,
                           "fft_ops": 1}, roofline=None)
    assert tdp.compact_summary(full) == jdp.compact_summary(full)


def test_capture_roundtrip_reference_layout(tmp_path):
    d = tmp_path / "cap" / "plugins" / "profile" / "2026_10_18"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wb") as f:
        f.write(json.dumps(_cpu_style_trace()).encode())
    cap = str(tmp_path / "cap")
    sj = jdp.attribute_capture(cap, span_paths=["driver/chunk"])
    st = tdp.attribute_capture(cap, span_paths=["driver/chunk"])
    assert st == sj
    path = tdp.write_summary(cap, st)
    assert tdp.read_summary(cap) == json.load(open(path))
    assert jdp.read_summary(cap) == tdp.read_summary(cap)


# ---------------------------------------------------------------------------
# the torch (Kineto) front end
# ---------------------------------------------------------------------------

HOST, GPU = 4242, 0


def _torch_meta():
    return [
        {"ph": "M", "name": "process_name", "pid": HOST, "tid": 0,
         "args": {"name": "python"}},
        {"ph": "M", "name": "thread_name", "pid": HOST, "tid": HOST,
         "args": {"name": "thread 4242 (python)"}},
        {"ph": "M", "name": "process_name", "pid": GPU, "tid": 0,
         "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": GPU, "tid": 0,
         "args": {"labels": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": GPU, "tid": 7,
         "args": {"name": "stream 7"}},
    ]


def _ann(name, ts, dur, cat="user_annotation", pid=HOST, tid=HOST):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": {"External id": 1}}


def _launch(corr, ts, name="cudaLaunchKernel", cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": name, "pid": HOST, "tid": HOST,
            "ts": ts, "dur": 3.0, "args": {"correlation": corr}}


def _kernel(name, corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": GPU, "tid": 7,
            "ts": ts, "dur": dur,
            "args": {"correlation": corr, "device": 0, "stream": 7}}


def _driver_trace():
    """Two chunks, each an ``interp`` and a ``spread`` launch inside the
    host ``chunk`` range plus one cuFFT and one GEMM kernel; the device
    lane also carries the overlapping ``gpu_user_annotation`` rows; a
    memcpy outside every range; the profiler's own ``Trace`` row."""
    ev = _torch_meta()
    ev.append({"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
               "pid": "Spans", "tid": "PyTorch Profiler", "ts": 0,
               "dur": 1e6, "args": {}})
    corr = 100
    for c in range(2):
        t0 = 1000.0 * c
        ev.append(_ann("chunk", t0, 500.0))
        ev.append(_ann("chunk", t0 + 10, 900.0, cat="gpu_user_annotation",
                       pid=GPU, tid=7))
        for j, (name, dur) in enumerate((
                ("packed_interp_kernel", 12.5), ("packed_spread_kernel", 40.0),
                ("void regular_fft<256u, 4u>(float2*)", 30.0),
                ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n", 8.0))):
            corr += 1
            ev.append(_launch(corr, t0 + 20 + 50 * j))
            ev.append(_kernel(name, corr, t0 + 100 + 100 * j, dur))
        ev.append(_ann("interp", t0 + 300, 100.0))
        corr += 1
        ev.append(_launch(corr, t0 + 310))
        ev.append(_kernel("ncclDevKernel_AllReduce_Sum_f32", corr,
                          t0 + 700, 5.0))
    corr += 1
    ev.append(_launch(corr, 5000.0, name="cudaMemcpyAsync"))
    ev.append(_kernel("Memcpy DtoH (Device -> Pageable)", corr, 5010.0,
                      20.0, cat="gpu_memcpy"))
    return {"schemaVersion": 1, "traceEvents": ev}


def test_torch_front_end_joins_launches_and_excludes_annotations():
    trace = _driver_trace()
    assert tdp.is_torch_trace(trace)
    events, lanes = tdp.trace_device_events(trace)
    # 2 x 5 kernels and one memcpy; no annotation row counted
    assert len(events) == 11
    assert sum(e["dur"] for e in events) == pytest.approx(
        2 * (12.5 + 40 + 30 + 8 + 5) + 20, rel=1e-12)
    assert [ln["thread"] for ln in lanes] == ["stream 7"]
    assert lanes[0]["device"] is True
    s = tdp.attribute_events(events, ["driver", "driver/chunk",
                                      "driver/chunk/interp"])
    chunk = s["spans"]["driver/chunk"]
    assert chunk["device_s"] == pytest.approx(2 * 90.5e-6, rel=1e-12)
    assert chunk["via"] == {"scope": 8}
    assert s["spans"]["driver/chunk/interp"]["device_s"] == pytest.approx(
        10e-6, rel=1e-12)
    assert set(s["unattributed"]) == {"Memcpy DtoH (Device -> Pageable)"}
    assert s["attributed_s"] + s["unattributed_s"] == pytest.approx(
        s["total_device_s"], rel=1e-12)
    oc = s["op_classes"]
    assert oc["fft_s"] == pytest.approx(60e-6, rel=1e-12)
    assert oc["dot_s"] == pytest.approx(16e-6, rel=1e-12)
    assert oc["comm_s"] == pytest.approx(10e-6, rel=1e-12)
    assert {"packed_interp_kernel", "packed_spread_kernel"} <= set(
        chunk["ops"])
    ev = {e["name"]: e for e in events}
    assert ev["packed_spread_kernel"]["args"]["scope"] == \
        "chunk/packed_spread_kernel"
    assert tdp.validate_summary(dict(s, schema=tdp.PROF_SCHEMA)) == []


def test_graph_launch_claims_every_replayed_kernel():
    ev = _torch_meta()
    ev += [_ann("driver", 0.0, 2000.0), _ann("chunk", 10.0, 1500.0),
           _launch(9, 20.0, name="cudaGraphLaunch")]
    names = [f"kernel_{i}" for i in range(6)]
    ev += [_kernel(n, 9, 100.0 + 30 * i, 7.0) for i, n in enumerate(names)]
    events, _ = tdp.torch_device_events({"traceEvents": ev})
    assert {e["args"]["scope"] for e in events} == {
        f"driver/chunk/{n}" for n in names}
    s = tdp.attribute_events(events, ["driver/chunk"])
    assert s["spans"]["driver/chunk"]["events"] == 6
    assert s["fraction_attributed"] == 1.0


def test_kernel_without_launch_takes_device_annotations():
    ev = _torch_meta()
    ev += [_ann("chunk", 0.0, 100.0, cat="gpu_user_annotation", pid=GPU,
                tid=7),
           _ann("interp", 10.0, 30.0, cat="gpu_user_annotation", pid=GPU,
                tid=7),
           _kernel("k_inner", 1, 15.0, 10.0),
           _kernel("k_outer", 2, 60.0, 10.0),
           _kernel("k_none", 3, 500.0, 10.0)]
    events, _ = tdp.torch_device_events({"traceEvents": ev})
    scopes = {e["name"]: e["args"].get("scope") for e in events}
    assert scopes == {"k_inner": "chunk/interp/k_inner",
                      "k_outer": "chunk/k_outer", "k_none": None}
    s = tdp.attribute_events(events, ["driver/chunk"])
    assert s["spans"]["driver/chunk"]["device_s"] == pytest.approx(
        20e-6, rel=1e-12)
    assert s["unattributed"] == {"k_none": pytest.approx(10e-6)}


def test_card_kernel_names_classify_and_reference_names_still_do():
    names = {"void regular_fft<64u>(float2*)": "fft",
             "void vector_fft<32u, 8u>(float2*)": "fft",
             "void composite_2way_fft<128u>(float2*)": "fft",
             "spRadix0064B::kernel1Mem<unsigned int>": "fft",
             "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize": "dot",
             "ampere_sgemm_128x64_nn": "dot",
             "cutlass::Kernel2<cutlass_80_tensorop_s1688gemm>": "dot",
             "nvjet_tst_64x8_64x16_2x1_v_bz_TNT": "dot",
             "ncclDevKernel_AllGather_RING_LL": "comm",
             "packed_spread_kernel": "other",
             "void at::native::elementwise_kernel<128, 2>": "other",
             "fft.2": "fft", "dot.3": "dot", "all-reduce.1": "comm",
             "fusion.9": "other"}
    ev = [_x(n, 10.0, args={"hlo_op": n}) for n in names]
    st = tdp.attribute_events(ev)
    for cls in ("fft", "dot", "comm"):
        n = sum(1 for v in names.values() if v == cls)
        assert st["op_classes"][f"{cls}_s"] == pytest.approx(
            n * 10e-6, rel=1e-12)
    # the reference classifies the XLA names alike and none of the card's
    ref = ("fft.2", "dot.3", "all-reduce.1", "fusion.9")
    sj = jdp.attribute_events([_x(n, 10.0, args={"hlo_op": n})
                               for n in ref])
    stt = tdp.attribute_events([_x(n, 10.0, args={"hlo_op": n})
                                for n in ref])
    assert sj["op_classes"] == stt["op_classes"]


def test_random_nested_annotations_match_brute_force():
    """The sweep that nests annotations around each launch agrees with a
    brute-force containment search on random properly nested ranges."""
    ev = _torch_meta()
    ranges, corr = [], 0

    def nest(t0, t1, depth, prefix):
        nonlocal corr
        t = t0
        while t < t1 and depth < 4:
            a = t + RNG.uniform(1, 20)
            b = min(t1, a + RNG.uniform(5, 200))
            if b - a < 2:
                break
            name = f"{prefix}{len(ranges)}"
            ranges.append((a, b, name))
            ev.append(_ann(name, a, b - a))
            nest(a, b, depth + 1, name + ".")
            t = b
    nest(0.0, 3000.0, 0, "r")
    launches = RNG.uniform(0, 3000, size=60)
    for ts in launches:
        corr += 1
        ev.append(_launch(corr, float(ts)))
        ev.append(_kernel(f"k{corr}", corr, 4000.0 + corr, 1.0))
    events, _ = tdp.torch_device_events({"traceEvents": ev})
    for e, ts in zip(events, launches):
        enclosing = sorted((a, -(b - a), n) for a, b, n in ranges
                           if a <= ts <= b)
        want = [n for _, _, n in enclosing]
        got = (e["args"].get("scope") or "").split("/")[:-1]
        assert got == want


def test_trace_with_no_gpu_process_totals_zero(tmp_path):
    """A real CPU capture through the port's ``profile_trace`` (the
    reference test's chunk loop, in torch ops): no device event, total
    0, and the summary validates."""
    from ibamr_tpu_torch import obs
    from ibamr_tpu_torch.utils.timers import profile_trace

    cap = str(tmp_path / "cap")
    led = str(tmp_path / "led" / "ledger.jsonl")
    x = torch.ones(32, 32)
    with obs.ledger(led):
        with profile_trace(cap, stage="solo"):
            for step in range(4):
                with obs.span("driver/chunk", step=step, block_on=x):
                    x = torch.fft.irfftn(torch.fft.rfftn(torch.sin(x)),
                                         s=x.shape)
    assert tdp.find_trace_files(cap) == [os.path.join(cap, "trace.json")]
    s = tdp.attribute_capture(cap, ledger=os.path.dirname(led))
    assert s["total_device_s"] == 0.0 and s["fraction_attributed"] == 1.0
    assert s["lanes"] == [] and s["spans"] == {}
    assert tdp.validate_summary(s) == []
    assert tdp.spans_from_ledger(led) == jdp.spans_from_ledger(led)
    assert "profile_trace/driver/chunk" in tdp.spans_from_ledger(led)
    freed = tdp.prune_raw_traces(cap)
    assert freed > 0 and tdp.find_trace_files(cap) == []


def test_torch_capture_dir_attributes_and_joins_census(tmp_path):
    cap = tmp_path / "cap"
    cap.mkdir()
    (cap / "trace.json").write_text(json.dumps(_driver_trace()))
    census = {"schema": 1, "label": "flagship", "executions": 2,
              "fft_ops": 4, "fft_bytes": 3_000_000, "dot_flops": 1_000_000,
              "dot_count": 1, "dot_lhs_bytes": 0, "dot_rhs_bytes": 0,
              "dot_out_bytes": 0}
    (cap / tdp.CENSUS_NAME).write_text(json.dumps(census))
    s = tdp.attribute_capture(str(cap), span_paths=["driver/chunk"])
    assert tdp.validate_summary(s) == []
    assert s["trace_files"] == 1
    # 60 us of FFT over 2 executions, 3 MB each -> 100 GB/s
    assert s["roofline"]["fft"]["achieved_gb_per_s"] == pytest.approx(100.0)
    from ibamr_tpu.obs.roofline import roofline_join as jjoin
    assert s["roofline"] == jjoin(s, census)
