"""Device-time attribution: join profiler traces back to spans (port of
``ibamr_tpu/obs/deviceprof.py``).

Every phase of a run is a ledger span, and ``obs.span`` enters
``torch.profiler.record_function`` with the span's leaf name, so a
profiler capture is annotated. This module reads a capture back: it
parses the Chrome trace that ``utils/timers.profile_trace`` writes
(``<dir>/trace.json``), extracts the device events, and attributes each
event's time to a span path, producing the per-span ``device_time_s``
table that merges with the host span tree
(``python -m ibamr_tpu_torch.tools.obs summary --device``) and the
``prof_summary.json`` artifact ``python -m ibamr_tpu_torch.tools.prof
diff`` gates drift on.

**The torch front end** (:func:`torch_device_events`). Device time is
the complete events of category ``kernel``, ``gpu_memcpy`` and
``gpu_memset``. The ``gpu_user_annotation`` ranges on the same device
lanes overlap those kernels and are excluded, as the reference excludes
its ``Steps`` rows, or every second would count twice. A kernel event
carries no scope path, so one is built: the kernel's ``correlation`` id
joins it to the host launch (``cudaLaunchKernel``, ``cuLaunchKernel``,
or ``cudaGraphLaunch`` for every kernel of a replayed CUDA graph), and
the host ``user_annotation`` ranges that enclose that launch on its
thread, outermost first, become the path (``chunk/<kernel>``). A kernel
with no launch record takes the ``gpu_user_annotation`` ranges that
enclose it on its own lane. A CPU-only capture has no device events: its
total is 0, and it validates.

**The attribution core** is the reference's, unchanged: the deepest
scope component that matches a known span LEAF wins (so the driver's
``driver/chunk`` span claims every kernel launched inside it); the
reference's module-name layers stay for its own trace-viewer captures
(:func:`device_op_events`, which :func:`attribute_capture` uses for a
file that is not a torch trace). Anything left lands in an EXPLICIT
``unattributed`` breakdown keyed by event name, and the invariant
``attributed_s + unattributed_s == total_device_s`` is part of the
summary schema (:func:`validate_summary`).

**Op classes** for the roofline join: the reference's patterns match
XLA op names (``fft.2``, ``dot.3``, ``all-reduce``); the card's kernel
names are matched as well (cuFFT's ``regular_fft``/``vector_fft``/
radix kernels as fft, cuBLAS, cuBLASLt and CUTLASS GEMMs as dot, NCCL
as comm).

Everything here is offline and host-side: stdlib only, usable on a
machine that never saw the card.
"""

from __future__ import annotations

import glob
import gzip
import json
import math
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

PROF_SCHEMA = 1
SUMMARY_NAME = "prof_summary.json"
CENSUS_NAME = "census_counts.json"

# trace-viewer process names that mark an accelerator timeline
_DEVICE_PROC_RE = re.compile(r"/device:|^TPU|^GPU", re.IGNORECASE)
# thread names that are op lanes on TPU/GPU timelines (preferred over
# "XLA Modules"/"Steps" rows, which overlap the op rows and would
# double-count every nanosecond)
_OP_LANE_RE = re.compile(r"XLA Ops|TensorFlow Ops", re.IGNORECASE)
# args keys that can carry a slash-separated framework scope path
_SCOPE_ARG_KEYS = ("tf_op", "op_name", "long_name", "name", "scope")
# op-class buckets for the roofline join: FFT ops, contractions, and
# collectives.  A device op is comm when its HLO opcode is a
# collective (sync or async -start/-done halves) OR its framework scope
# path passes through a ``comm`` component — the named scope the
# parallel layer (fftpar/lagrangian/mesh/norms/krylov) wraps every
# cross-device exchange in — so partitioner-materialized resharding
# that keeps a fused non-collective opcode still lands in ``comm_s``.
_FFT_OP_RE = re.compile(r"(^|[./])i?r?fft", re.IGNORECASE)
_DOT_OP_RE = re.compile(r"(^|[./])(dot|convolution|gemm|matmul)",
                        re.IGNORECASE)
_COMM_OP_RE = re.compile(
    r"(^|[./])(all-reduce|all-gather|all-to-all|collective-permute|"
    r"reduce-scatter|collective-broadcast)(-start|-done)?(\.|$)",
    re.IGNORECASE)
_COMM_SCOPE = "comm"
# the card's kernel names, matched anywhere in the name: cuFFT's
# transform kernels (``regular_fft``, ``vector_fft``, ``composite_2way_fft``,
# the ``spRadix``/``dpRadix`` families), cuBLAS / cuBLASLt / CUTLASS GEMMs
# (``..._gemm_...``, ``xmma``, ``cutlass``, ``nvjet``, ``gemv``, split-K
# reduction) and NCCL's device kernels
_FFT_KERNEL_RE = re.compile(r"fft|[sd]pRadix\d", re.IGNORECASE)
_DOT_KERNEL_RE = re.compile(
    r"gemm|gemv|xmma|cutlass|nvjet|splitKreduce|dot_kernel",
    re.IGNORECASE)
_COMM_KERNEL_RE = re.compile(r"nccl", re.IGNORECASE)

# torch (Kineto) Chrome-trace categories: device time, host launches
# and the two annotation projections
_TORCH_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_TORCH_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_TORCH_HOST_ANNOTATION = "user_annotation"
_TORCH_GPU_ANNOTATION = "gpu_user_annotation"
_TORCH_CATS = set(_TORCH_DEVICE_CATS + _TORCH_LAUNCH_CATS) | {
    _TORCH_HOST_ANNOTATION, _TORCH_GPU_ANNOTATION, "cpu_op",
    "python_function", "cuda_sync", "Trace"}


# ---------------------------------------------------------------------------
# capture-dir / trace-file plumbing
# ---------------------------------------------------------------------------

def find_trace_files(capture_dir: str) -> List[str]:
    """Every trace JSON in a capture dir: the ``trace.json`` that
    ``utils/timers.profile_trace`` writes, and the reference's
    trace-viewer layout (``<dir>/plugins/profile/<ts>/<host>.trace.json.gz``,
    plain ``.trace.json`` too)."""
    out: List[str] = []
    for pat in ("**/trace.json", "**/*.trace.json.gz", "**/*.trace.json"):
        out.extend(glob.glob(os.path.join(capture_dir, pat),
                             recursive=True))
    return sorted(set(out))


def load_trace(path: str) -> dict:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        return json.loads(f.read())


def capture_bytes(capture_dir: str) -> int:
    """Total on-disk bytes of a capture directory."""
    total = 0
    for root, _, files in os.walk(capture_dir):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:
                pass
    return total


# ---------------------------------------------------------------------------
# device-lane op events
# ---------------------------------------------------------------------------

def _lane_meta(trace: dict) -> Tuple[Dict[int, str], Dict[tuple, str]]:
    """(pid -> process name, (pid, tid) -> thread name) from the
    trace's metadata ('M') events."""
    procs: Dict[int, str] = {}
    threads: Dict[tuple, str] = {}
    for e in trace.get("traceEvents") or []:
        if e.get("ph") != "M":
            continue
        args = e.get("args") or {}
        if e.get("name") == "process_name":
            procs[e.get("pid")] = str(args.get("name", ""))
        elif e.get("name") == "thread_name":
            threads[(e.get("pid"), e.get("tid"))] = \
                str(args.get("name", ""))
    return procs, threads


def device_op_events(trace: dict) -> Tuple[List[dict], List[dict]]:
    """(op events, device-lane descriptions) for one trace.

    TPU/GPU timelines: processes named ``/device:*`` — take the
    ``XLA Ops`` threads (falling back to every thread of the device
    process when no lane is labeled), and count every complete ('X')
    event there as device-op time. CPU (TFRT) timelines: there is no
    device process, and the executor's op events are scattered across
    pool threads — an op event is exactly an X event carrying
    ``hlo_op``/``hlo_module`` args, wherever it sits (the python host
    thread's function-trace events carry neither and are excluded).
    """
    procs, threads = _lane_meta(trace)
    dev_pids = {pid for pid, name in procs.items()
                if _DEVICE_PROC_RE.search(name or "")}
    op_lanes = {key for key, name in threads.items()
                if key[0] in dev_pids and _OP_LANE_RE.search(name or "")}
    labeled_pids = {pid for pid, _ in op_lanes}
    events: List[dict] = []
    lane_busy: Dict[tuple, dict] = {}
    for e in trace.get("traceEvents") or []:
        if e.get("ph") != "X":
            continue
        key = (e.get("pid"), e.get("tid"))
        args = e.get("args") or {}
        if key[0] in dev_pids:
            # device process: only labeled op lanes when any exist FOR
            # THIS pid (module/step rows overlap the op rows)
            if key[0] in labeled_pids and key not in op_lanes:
                continue
        elif "hlo_op" not in args and "hlo_module" not in args:
            continue                      # host-side python/runtime event
        events.append(e)
        lane = lane_busy.setdefault(key, {
            "pid": key[0], "tid": key[1],
            "process": procs.get(key[0], ""),
            "thread": threads.get(key, ""),
            "events": 0, "busy_s": 0.0})
        lane["events"] += 1
        lane["busy_s"] += float(e.get("dur") or 0.0) / 1e6
    lanes = sorted(lane_busy.values(),
                   key=lambda d: -(d["busy_s"]))
    for d in lanes:
        d["busy_s"] = round(d["busy_s"], 9)
    return events, lanes


# ---------------------------------------------------------------------------
# the torch front end: Kineto Chrome traces
# ---------------------------------------------------------------------------

def is_torch_trace(trace: dict) -> bool:
    """Whether a trace is a torch profiler export (its complete events
    carry Kineto categories), rather than a trace-viewer capture."""
    return any(e.get("ph") == "X" and e.get("cat") in _TORCH_CATS
               for e in trace.get("traceEvents") or [])


def _nest(ranges: List[dict], points: List[tuple]) -> Dict[object, List[str]]:
    """For properly nested ``ranges`` (complete events of one thread or
    lane) and ``points`` ``(key, ts)``, the names of the ranges that
    enclose each point, outermost first: one sweep in time order."""
    order = sorted(ranges, key=lambda r: (float(r["ts"]),
                                          -float(r.get("dur") or 0.0)))
    out: Dict[object, List[str]] = {}
    stack: List[tuple] = []
    i = 0
    for key, ts in sorted(points, key=lambda p: p[1]):
        while i < len(order) and float(order[i]["ts"]) <= ts:
            r = order[i]
            start = float(r["ts"])
            while stack and stack[-1][0] <= start:
                stack.pop()
            stack.append((start + float(r.get("dur") or 0.0),
                          str(r.get("name"))))
            i += 1
        while stack and stack[-1][0] < ts:
            stack.pop()
        out[key] = [name for end, name in stack if end >= ts]
    return out


def torch_device_events(trace: dict) -> Tuple[List[dict], List[dict]]:
    """(device events, device-lane descriptions) of one torch trace.

    Each returned event is the trace's kernel / memcpy / memset event
    with ``args["scope"]`` set to ``"<outer>/<inner>/<kernel>"`` when
    annotations enclose it (see the module docstring), so the reference's
    :func:`_resolve` reads it as a scope path. ``gpu_user_annotation``
    ranges are never counted as device time."""
    procs, threads = _lane_meta(trace)
    events = [e for e in trace.get("traceEvents") or []
              if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in _TORCH_DEVICE_CATS]
    launches = {}
    host_ann: Dict[tuple, List[dict]] = {}
    gpu_ann: Dict[tuple, List[dict]] = {}
    for e in events:
        cat = e.get("cat")
        if cat in _TORCH_LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
        elif cat == _TORCH_HOST_ANNOTATION:
            host_ann.setdefault((e.get("pid"), e.get("tid")), []).append(e)
        elif cat == _TORCH_GPU_ANNOTATION:
            gpu_ann.setdefault((e.get("pid"), e.get("tid")), []).append(e)

    # scope of each device event: its launch's enclosing host ranges,
    # else the device-side annotation ranges enclosing it on its lane
    host_points: Dict[tuple, List[tuple]] = {}
    lane_points: Dict[tuple, List[tuple]] = {}
    for i, e in enumerate(device):
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is not None:
            key = (launch.get("pid"), launch.get("tid"))
            host_points.setdefault(key, []).append((i, float(launch["ts"])))
        else:
            key = (e.get("pid"), e.get("tid"))
            lane_points.setdefault(key, []).append(
                (i, float(e["ts"]) + 0.5 * float(e.get("dur") or 0.0)))
    scopes: Dict[int, List[str]] = {}
    for key, pts in host_points.items():
        scopes.update(_nest(host_ann.get(key, []), pts))
    for key, pts in lane_points.items():
        scopes.update(_nest(gpu_ann.get(key, []), pts))

    out: List[dict] = []
    lane_busy: Dict[tuple, dict] = {}
    for i, e in enumerate(device):
        ev = dict(e)
        args = dict(e.get("args") or {})
        path = scopes.get(i) or []
        if path:
            args["scope"] = "/".join(
                path + [str(e.get("name")).replace("/", "|")])
        ev["args"] = args
        out.append(ev)
        key = (e.get("pid"), e.get("tid"))
        lane = lane_busy.setdefault(key, {
            "pid": key[0], "tid": key[1], "device": True,
            "process": procs.get(key[0]) or f"GPU {key[0]}",
            "thread": threads.get(key, "") or f"stream {key[1]}",
            "events": 0, "busy_s": 0.0})
        lane["events"] += 1
        lane["busy_s"] += float(e.get("dur") or 0.0) / 1e6
    lanes = sorted(lane_busy.values(), key=lambda d: -(d["busy_s"]))
    for d in lanes:
        d["busy_s"] = round(d["busy_s"], 9)
    return out, lanes


def trace_device_events(trace: dict) -> Tuple[List[dict], List[dict]]:
    """The device events of any trace: the torch front end for a torch
    export, the reference's lane rules otherwise."""
    if is_torch_trace(trace):
        return torch_device_events(trace)
    return device_op_events(trace)


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------

def _norm_component(comp: str) -> str:
    """``jit(step)`` -> ``step``; ``transpose[permutation=...]`` ->
    ``transpose``; named-scope components pass through."""
    comp = comp.split("[")[0].strip()
    m = re.match(r"^(?:p?jit|vmap|scan|while|named)\((.*)\)$", comp)
    if m:
        comp = m.group(1)
    return comp


def _norm_module(module: str) -> str:
    """``jit_chunk`` / ``jit__chunk`` / ``jit_step.7`` -> ``chunk`` /
    ``chunk`` / ``step`` — the wrapped function's name, which is what
    a span leaf can plausibly match."""
    m = re.sub(r"\.\d+$", "", str(module))
    m = re.sub(r"^(?:p?jit_+)", "", m)
    return m.strip("_") or str(module)


def _scope_components(event: dict) -> List[str]:
    """The framework scope path of one op event, as components, or []
    when the event carries none (the CPU backend)."""
    args = event.get("args") or {}
    for key in _SCOPE_ARG_KEYS:
        v = args.get(key)
        if isinstance(v, str) and "/" in v:
            return [c for c in v.split("/") if c]
    name = event.get("name")
    if isinstance(name, str) and "/" in name:
        return [c for c in name.split("/") if c]
    return []


def span_leaf_map(span_paths: Iterable[str]) -> Dict[str, str]:
    """leaf name -> full span path. ``obs.span`` enters
    ``torch.profiler.record_function`` with the LEAF of the span name (everything
    after the last ``/`` and ``::``), so the leaf is the token that can
    appear inside a trace. Ambiguous leaves resolve to the SHALLOWEST
    path (deterministic: sorted by depth then name)."""
    leaf_map: Dict[str, str] = {}
    for path in sorted(set(span_paths),
                       key=lambda p: (p.count("/"), p)):
        leaf = path.split("/")[-1].split("::")[-1]
        leaf_map.setdefault(leaf, path)
    return leaf_map


def _resolve(event: dict, leaf_map: Dict[str, str],
             module_map: Dict[str, str]):
    """(key, via) for one op event — ``via`` in {"scope", "module",
    "module-name"} — or (None, None) when nothing identifies it."""
    comps = _scope_components(event)
    for comp in reversed(comps):
        leaf = _norm_component(comp)
        if leaf in leaf_map:
            return leaf_map[leaf], "scope"
    module = (event.get("args") or {}).get("hlo_module")
    if module:
        if module in module_map:
            return module_map[module], "module"
        norm = _norm_module(module)
        if norm in module_map:
            return module_map[norm], "module"
        if norm in leaf_map:
            return leaf_map[norm], "module"
        return norm, "module-name"
    return None, None


def attribute_events(events: List[dict],
                     span_paths: Iterable[str] = (),
                     module_map: Optional[Dict[str, str]] = None,
                     max_ops: int = 16) -> dict:
    """Attribute device-op events to span paths.

    Returns the core of a :data:`SUMMARY_NAME` document; every second
    of device-lane time lands either in ``spans`` (attributed — via
    scope prefix, module match, or module identity) or in the explicit
    ``unattributed`` breakdown. ``op_classes`` tallies
    FFT/contraction/collective op time for the roofline join; the
    classes partition ``total_device_s`` exactly (``other_s`` is the
    remainder), independent of the span accounting identity."""
    leaf_map = span_leaf_map(span_paths)
    module_map = dict(module_map or {})
    spans: Dict[str, dict] = {}
    unattributed: Dict[str, float] = {}
    total = attributed = 0.0
    fft_s = dot_s = comm_s = 0.0
    for e in events:
        dur = float(e.get("dur") or 0.0) / 1e6
        total += dur
        opname = str((e.get("args") or {}).get("hlo_op")
                     or e.get("name") or "?")
        # comm wins over fft/dot: a collective (or an op inside the
        # parallel layer's ``comm`` named scope) is wire time even when
        # its fused opcode also mentions a compute class
        if _COMM_OP_RE.search(opname) or _COMM_KERNEL_RE.search(opname) \
                or any(_norm_component(c) == _COMM_SCOPE
                       for c in _scope_components(e)):
            comm_s += dur
        elif _FFT_OP_RE.search(opname) or _FFT_KERNEL_RE.search(opname):
            fft_s += dur
        elif _DOT_OP_RE.search(opname) or _DOT_KERNEL_RE.search(opname):
            dot_s += dur
        key, via = _resolve(e, leaf_map, module_map)
        if key is None:
            unattributed[opname] = unattributed.get(opname, 0.0) + dur
            continue
        attributed += dur
        node = spans.setdefault(key, {"device_s": 0.0, "events": 0,
                                      "via": {}, "ops": {}})
        node["device_s"] += dur
        node["events"] += 1
        node["via"][via] = node["via"].get(via, 0) + 1
        node["ops"][opname] = node["ops"].get(opname, 0.0) + dur
    for node in spans.values():
        node["device_s"] = round(node["device_s"], 9)
        top = sorted(node["ops"].items(), key=lambda kv: -kv[1])
        node["ops"] = {k: round(v, 9) for k, v in top[:max_ops]}
    return {
        "total_device_s": round(total, 9),
        "attributed_s": round(attributed, 9),
        "unattributed_s": round(total - attributed, 9),
        "fraction_attributed": round(attributed / total, 6)
        if total > 0 else 1.0,
        "spans": spans,
        "unattributed": {
            k: round(v, 9)
            for k, v in sorted(unattributed.items(),
                               key=lambda kv: -kv[1])[:max_ops]},
        "op_classes": {"fft_s": round(fft_s, 9),
                       "dot_s": round(dot_s, 9),
                       "comm_s": round(comm_s, 9),
                       "other_s": round(total - fft_s - dot_s
                                        - comm_s, 9)},
    }


def spans_from_ledger(ledger_path: str) -> List[str]:
    """Distinct span paths recorded in a run ledger (the host side of
    the join)."""
    from ibamr_tpu_torch.obs.bus import read_ledger

    return sorted({r.get("path") or r.get("name")
                   for r in read_ledger(ledger_path)
                   if r.get("kind") == "span"
                   and (r.get("path") or r.get("name"))})


def attribute_capture(capture_dir: str,
                      span_paths: Iterable[str] = (),
                      module_map: Optional[Dict[str, str]] = None,
                      ledger: Optional[str] = None) -> dict:
    """Parse + attribute every trace file in ``capture_dir`` into one
    :data:`SUMMARY_NAME` document. ``ledger`` (a ``ledger.jsonl`` path
    or its directory) contributes its recorded span paths; the
    ``census_counts.json`` sidecar, when present (bench writes it at
    capture time), is joined into a roofline block."""
    paths = list(span_paths)
    if ledger:
        if os.path.isdir(ledger):
            ledger = os.path.join(ledger, "ledger.jsonl")
        paths.extend(spans_from_ledger(ledger))
    files = find_trace_files(capture_dir)
    events: List[dict] = []
    lanes: List[dict] = []
    for f in files:
        ev, ln = trace_device_events(load_trace(f))
        events.extend(ev)
        lanes.extend(ln)
    summary = attribute_events(events, paths, module_map)
    summary.update(schema=PROF_SCHEMA,
                   capture_dir=os.path.abspath(capture_dir),
                   trace_files=len(files), lanes=lanes,
                   capture_bytes=capture_bytes(capture_dir))
    census = read_census(capture_dir)
    summary["census"] = census
    if census:
        from ibamr_tpu_torch.obs.roofline import roofline_join

        summary["roofline"] = roofline_join(summary, census)
    else:
        summary["roofline"] = None
    return summary


# ---------------------------------------------------------------------------
# the summary artifact
# ---------------------------------------------------------------------------

def summary_path(path: str) -> str:
    """A directory means its ``prof_summary.json``."""
    if os.path.isdir(path):
        return os.path.join(path, SUMMARY_NAME)
    return path


def write_summary(capture_dir: str, summary: dict) -> str:
    """Atomically land ``prof_summary.json`` next to the capture."""
    path = os.path.join(capture_dir, SUMMARY_NAME)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(summary, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_summary(path: str) -> dict:
    with open(summary_path(path)) as f:
        return json.load(f)


def read_census(capture_dir_or_path: str) -> Optional[dict]:
    path = capture_dir_or_path
    if os.path.isdir(path):
        path = os.path.join(path, CENSUS_NAME)
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else None
    except (OSError, ValueError):
        return None


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and math.isfinite(v)


def validate_summary(summary) -> List[str]:
    """Schema check; returns problems ([] = valid).

    This is what makes a malformed ``prof_summary.json`` fail LOUDLY
    (``tools/prof.py check`` exits 2) instead of being archived as
    garbage — including the accounting invariant that attributed plus
    unattributed time reconstructs the device total, so time can never
    be silently dropped by a parser bug."""
    probs: List[str] = []
    if not isinstance(summary, dict):
        return ["summary is not an object"]
    if summary.get("schema") != PROF_SCHEMA:
        probs.append(f"schema != {PROF_SCHEMA}: "
                     f"{summary.get('schema')!r}")
    for key in ("total_device_s", "attributed_s", "unattributed_s"):
        v = summary.get(key)
        if not _num(v) or v < 0:
            probs.append(f"{key} not a finite non-negative number: "
                         f"{v!r}")
    frac = summary.get("fraction_attributed")
    if not _num(frac) or not (0.0 <= frac <= 1.0):
        probs.append(f"fraction_attributed outside [0, 1]: {frac!r}")
    spans = summary.get("spans")
    if not isinstance(spans, dict):
        probs.append("spans is not an object")
        spans = {}
    span_sum = 0.0
    for key, node in spans.items():
        dv = node.get("device_s") if isinstance(node, dict) else node
        if not _num(dv) or dv < 0:
            probs.append(f"spans[{key!r}].device_s invalid: {dv!r}")
        else:
            span_sum += dv
    if not isinstance(summary.get("unattributed"), dict):
        probs.append("unattributed breakdown missing")
    if not probs:
        total = summary["total_device_s"]
        tol = max(1e-6, 1e-4 * total)
        if abs(summary["attributed_s"] + summary["unattributed_s"]
               - total) > tol:
            probs.append("attributed_s + unattributed_s != "
                         "total_device_s (time dropped)")
        if abs(span_sum - summary["attributed_s"]) > tol:
            probs.append("sum(spans.device_s) != attributed_s")
    return probs


def compact_summary(summary: dict) -> dict:
    """The embeddable slice (bench JSON ``profiles[*].summary``): the
    tables a diff needs, without per-lane/per-op detail."""
    return {
        "schema": summary.get("schema"),
        "total_device_s": summary.get("total_device_s"),
        "attributed_s": summary.get("attributed_s"),
        "unattributed_s": summary.get("unattributed_s"),
        "fraction_attributed": summary.get("fraction_attributed"),
        "spans": {k: {"device_s": (v.get("device_s")
                                   if isinstance(v, dict) else v)}
                  for k, v in (summary.get("spans") or {}).items()},
        "unattributed": summary.get("unattributed") or {},
        "op_classes": summary.get("op_classes"),
        "census": {k: v for k, v in (summary.get("census") or {}).items()
                   if k in ("label", "n", "executions")} or None,
        "roofline": summary.get("roofline"),
    }


# ---------------------------------------------------------------------------
# pruning (the archive step)
# ---------------------------------------------------------------------------

_RAW_SUFFIXES = ("trace.json", ".trace.json.gz", ".xplane.pb",
                 ".memory_profile.json.gz", ".overview_page.pb",
                 ".input_pipeline.pb", ".tensorflow_stats.pb",
                 ".kernel_stats.pb", ".hlo_proto.pb")


def prune_raw_traces(capture_dir: str) -> int:
    """Delete the raw multi-MB profiler outputs under ``capture_dir``
    (the ``plugins/profile`` tree), keeping the compact
    ``prof_summary.json`` / ``census_counts.json``. Returns bytes
    freed. Callers MUST validate the summary first — ``tools/prof.py
    archive`` refuses to prune when :func:`validate_summary` fails."""
    freed = 0
    for root, dirs, files in os.walk(capture_dir, topdown=False):
        for name in files:
            if not name.endswith(_RAW_SUFFIXES):
                continue
            path = os.path.join(root, name)
            try:
                freed += os.path.getsize(path)
                os.unlink(path)
            except OSError:
                pass
        for d in dirs:
            try:
                os.rmdir(os.path.join(root, d))   # only if now empty
            except OSError:
                pass
    return freed
