"""The telemetry bus: spans, counters/gauges, and the run ledger (port
of ``ibamr_tpu/obs/bus.py``).

Everything here is HOST-side and rides the run loop's existing
one-read-per-chunk sync points. Nothing in this module reads a device
value: the only thing a span contributes on the device side is a
``torch.profiler.record_function`` range, which names the phase in a
profiler trace and costs nothing when no profiler is active.

Concurrency model: counter/gauge updates are plain attribute writes on
per-metric instances (GIL-atomic, no lock on the hot path — the
"cheap lock-free increments" contract); the registry lock is taken
only on metric creation and snapshot. Ledger appends serialize one
whole line into a single ``os.write`` on an ``O_APPEND`` fd, so a
SIGKILL between records never tears a line and concurrent writers
never interleave bytes.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import threading
import time
from bisect import bisect_right
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

LEDGER_SCHEMA = 1

# ---------------------------------------------------------------------------
# counters / gauges
# ---------------------------------------------------------------------------

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_OK = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize_name(name: str) -> str:
    name = _NAME_OK.sub("_", str(name))
    return name if name and not name[0].isdigit() else "_" + name


def _render_key(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    """Prometheus-style sample key: ``name{k="v",...}`` with labels
    sorted and values escaped — the one rendering used everywhere
    (registry, ledger snapshots, the exporter), so a counter looks the
    same in ``ledger.jsonl`` and on a future ``/metrics`` endpoint."""
    name = _sanitize_name(name)
    if not labels:
        return name
    parts = []
    for k, v in labels:
        k = _LABEL_OK.sub("_", str(k))
        v = (str(v).replace("\\", "\\\\").replace('"', '\\"')
             .replace("\n", "\\n"))
        parts.append(f'{k}="{v}"')
    return name + "{" + ",".join(parts) + "}"


class Counter:
    """Monotonic cumulative counter. ``inc`` is a bare attribute
    update — no lock, no ledger write; the value reaches the ledger
    only via per-chunk snapshots."""

    __slots__ = ("name", "labels", "key", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.key = _render_key(name, labels)
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value (queue depths, watermarks)."""

    __slots__ = ("name", "labels", "key", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.key = _render_key(name, labels)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


# Fixed log-spaced histogram bounds shared by every histogram: six
# buckets per decade over 1e-6 .. 1e3 (sub-microsecond observes through
# ~17-minute walls; anything above lands in the +Inf bucket). One
# process-wide lattice keeps snapshots mergeable and the percentile
# estimator's worst-case error a single bucket ratio (10^(1/6) ~ 1.47x).
HISTOGRAM_BOUNDS: Tuple[float, ...] = tuple(
    10.0 ** (-6.0 + k / 6.0) for k in range(55))


class Histogram:
    """Fixed-bucket latency/size distribution.

    ``observe`` is the hot path and follows the counter contract:
    the bucket index is computed first (the only function call), then
    the bucket count and running sum update as straight-line attribute
    arithmetic — GIL-atomic, no lock, no ledger write. Bucket counts
    are NON-cumulative in memory; the exporter cumulates them into
    Prometheus ``le`` series and :func:`quantiles_from_counts`
    estimates percentiles by interpolating within the target bucket.
    """

    __slots__ = ("name", "labels", "key", "counts", "sum")

    bounds = HISTOGRAM_BOUNDS

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.key = _render_key(name, labels)
        self.counts = [0] * (len(HISTOGRAM_BOUNDS) + 1)
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect_right(HISTOGRAM_BOUNDS, v)
        self.counts[i] += 1
        self.sum += v

    @property
    def count(self) -> int:
        return sum(self.counts)

    def snapshot(self) -> dict:
        """``{"sum": s, "count": n, "counts": [...]}`` — the per-chunk
        ledger form (raw per-bucket counts, shared bounds implied)."""
        counts = list(self.counts)
        return {"sum": self.sum, "count": sum(counts), "counts": counts}

    def quantile(self, q: float) -> Optional[float]:
        return quantiles_from_counts(self.counts, [q])[0]


def quantiles_from_counts(counts, qs, bounds=HISTOGRAM_BOUNDS):
    """Percentile estimates from per-bucket (non-cumulative) counts.

    For each quantile ``q`` in ``qs``: find the bucket holding the
    ``q``-th ranked observation and interpolate linearly between its
    bounds (the first bucket's lower bound is 0; the +Inf bucket
    reports the last finite bound — the estimator cannot see past it).
    Returns one value per ``q``, ``None`` where the histogram is empty.
    """
    total = sum(counts)
    out = []
    for q in qs:
        if total == 0:
            out.append(None)
            continue
        q = min(max(float(q), 0.0), 1.0)
        rank = q * total
        cum = 0.0
        idx = len(counts) - 1
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank and c:
                idx = i
                break
        if idx >= len(bounds):                 # +Inf bucket
            out.append(float(bounds[-1]))
            continue
        lo = 0.0 if idx == 0 else float(bounds[idx - 1])
        hi = float(bounds[idx])
        below = cum - counts[idx]
        frac = (rank - below) / counts[idx] if counts[idx] else 0.0
        out.append(lo + (hi - lo) * min(max(frac, 0.0), 1.0))
    return out


_REG_LOCK = threading.Lock()
_COUNTERS: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Counter] = {}
_GAUGES: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Gauge] = {}
_HISTOGRAMS: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                  Histogram] = {}
_HELP: Dict[str, str] = {}


def counter(name: str, **labels) -> Counter:
    """The process-wide counter for ``(name, labels)`` (created on
    first use). Cache the returned instance at module level for hot
    paths — ``inc`` on the instance is the lock-free part."""
    key = (name, tuple(sorted((str(k), str(v))
                              for k, v in labels.items())))
    c = _COUNTERS.get(key)
    if c is None:
        with _REG_LOCK:
            c = _COUNTERS.setdefault(key, Counter(name, key[1]))
    return c


def gauge(name: str, **labels) -> Gauge:
    key = (name, tuple(sorted((str(k), str(v))
                              for k, v in labels.items())))
    g = _GAUGES.get(key)
    if g is None:
        with _REG_LOCK:
            g = _GAUGES.setdefault(key, Gauge(name, key[1]))
    return g


def histogram(name: str, **labels) -> Histogram:
    """The process-wide histogram for ``(name, labels)`` — registry
    semantics identical to :func:`counter` (created on first use, lock
    only on creation and snapshot, ``reset_metrics`` zeroes values in
    place so module-cached handles stay live). Cache the returned
    instance on hot paths; ``observe`` is the lock-free part."""
    key = (name, tuple(sorted((str(k), str(v))
                              for k, v in labels.items())))
    h = _HISTOGRAMS.get(key)
    if h is None:
        with _REG_LOCK:
            h = _HISTOGRAMS.setdefault(key, Histogram(name, key[1]))
    return h


def peek_gauge(name: str, **labels) -> Optional[float]:
    """The gauge's value WITHOUT creating it — ``None`` when no
    subsystem ever touched that metric. Lets an observer (the watchdog
    heartbeat) report serving fields only on runs that actually serve,
    keeping the solo heartbeat schema untouched."""
    key = (name, tuple(sorted((str(k), str(v))
                              for k, v in labels.items())))
    g = _GAUGES.get(key)
    return None if g is None else g.value


def describe(name: str, text: str) -> None:
    """Register the ``# HELP`` line for a metric family (by bare
    name). Subsystems call this next to the ``counter()``/
    ``histogram()`` creation; the exporter falls back to a generic
    line for families nobody described."""
    with _REG_LOCK:
        _HELP[_sanitize_name(name)] = str(text)


def help_for(name: str) -> Optional[str]:
    with _REG_LOCK:
        return _HELP.get(_sanitize_name(name))


def metrics_snapshot() -> dict:
    """``{"counters": {key: value}, "gauges": {key: value},
    "histograms": {key: {sum, count, counts}}}`` with
    Prometheus-rendered keys. The instant snapshot written into the
    ledger at every chunk boundary and serialized by the exporter."""
    with _REG_LOCK:
        return {
            "counters": {c.key: c.value for c in _COUNTERS.values()},
            "gauges": {g.key: g.value for g in _GAUGES.values()},
            "histograms": {h.key: h.snapshot()
                           for h in _HISTOGRAMS.values()},
        }


def reset_metrics() -> None:
    """Zero every metric WITHOUT dropping the instances: subsystems
    cache ``counter(...)`` returns at module level, and clearing the
    registry would silently orphan those live handles (they would keep
    counting into objects no snapshot ever reads). Test harness use."""
    with _REG_LOCK:
        for c in _COUNTERS.values():
            c.value = 0
        for g in _GAUGES.values():
            g.value = 0.0
        for h in _HISTOGRAMS.values():
            for i in range(len(h.counts)):
                h.counts[i] = 0
            h.sum = 0.0


def iter_metrics():
    """Yield ``(kind, name, labels, key, value)`` for the exporter.
    Histogram values are their :meth:`Histogram.snapshot` dicts."""
    with _REG_LOCK:
        items = ([("counter", c, c.value) for c in _COUNTERS.values()]
                 + [("gauge", g, g.value) for g in _GAUGES.values()]
                 + [("histogram", h, h.snapshot())
                    for h in _HISTOGRAMS.values()])
    for kind, m, value in items:
        yield kind, m.name, m.labels, m.key, value


# ---------------------------------------------------------------------------
# the run ledger
# ---------------------------------------------------------------------------

def _jsonable(v: Any) -> Any:
    """Strict-JSON coercion: numpy scalars/arrays to Python, non-finite
    floats to ``None`` (a ledger line must parse under any strict
    reader — the same bug class satellite 1 fixes in MetricsLogger)."""
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "item") and getattr(v, "ndim", None) in (0, None):
        try:
            return _jsonable(v.item())
        except Exception:
            pass
    if hasattr(v, "tolist"):
        try:
            return _jsonable(v.tolist())
        except Exception:
            pass
    return str(v)


def run_id_from_fingerprint(fingerprint: Optional[dict]) -> str:
    """The run identity: a stable digest of the flight-recorder
    fingerprint (config digest, integrator spec, engine chain,
    versions, platform — :meth:`FlightRecorder.fingerprint`). The SAME
    fingerprint yields the same ``run_id``, which is what lets a
    ledger, an incident capsule, a heartbeat, and a ``ckpt_fsck``
    report cross-reference one run."""
    if not fingerprint:
        # no fingerprint available (bare tooling): a random identity
        # still correlates the records of THIS process's ledger
        return hashlib.sha256(os.urandom(16)).hexdigest()[:16]
    blob = json.dumps(_jsonable(fingerprint), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


_PROC_OK = re.compile(r"[^A-Za-z0-9_.-]")


def shard_path(path: str, proc) -> str:
    """The ledger-shard filename for one process of a multi-process
    run: a directory (or a ``.../ledger.jsonl`` path) becomes
    ``.../ledger-<proc>.jsonl``. Every host of a pod run passes the
    SAME ``path`` and its own ``proc`` (the process rank), so the
    shards land side by side for :mod:`ibamr_tpu_torch.obs.merge`."""
    p = _PROC_OK.sub("_", str(proc)) or "0"
    if os.path.isdir(path) or path.endswith(os.sep):
        return os.path.join(path, f"ledger-{p}.jsonl")
    d, base = os.path.split(path)
    root, ext = os.path.splitext(base or "ledger.jsonl")
    return os.path.join(d, f"{root}-{p}{ext or '.jsonl'}")


class RunLedger:
    """Per-run append-only ``ledger.jsonl``.

    Every record is one line: ``{"seq": N, "run_id": ..., "t": ...,
    "kind": ..., ...payload}``. ``seq`` is monotonic per ledger FILE —
    reopening an existing ledger (a resumed run) continues the
    sequence, so cross-references stay unambiguous across restarts.
    Each line lands in a single ``os.write`` on an ``O_APPEND`` fd:
    a kill between records cannot tear a committed line, and
    :func:`read_ledger` tolerates (skips) a torn final line from a
    kill mid-write. ``overhead_s`` accumulates the wall cost of every
    append — the observability bill, kept in-band so the <2% budget is
    enforced, not promised.

    ``proc`` is the process identity of a multi-host run:
    ``None`` (the default) keeps single-process behavior bit-for-bit;
    a process index reroutes the file to :func:`shard_path`'s
    ``ledger-<proc>.jsonl`` and stamps ``proc`` on every record, while
    ``run_id`` — a fingerprint digest, identical on every host of the
    same run — stays the cross-shard join key."""

    def __init__(self, path: str,
                 fingerprint: Optional[dict] = None,
                 run_id: Optional[str] = None,
                 proc: Optional[object] = None):
        self.proc = None if proc is None else str(proc)
        if self.proc is not None:
            path = shard_path(path, self.proc)
        self.path = path
        self.run_id = run_id or run_id_from_fingerprint(fingerprint)
        self.overhead_s = 0.0
        self._lock = threading.Lock()
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        self._seq = -1
        if os.path.exists(path):
            for rec in read_ledger(path):
                if rec["seq"] > self._seq:
                    self._seq = rec["seq"]
        self._fd = os.open(path,
                           os.O_APPEND | os.O_CREAT | os.O_WRONLY,
                           0o644)
        self.append("run_start", {
            "schema": LEDGER_SCHEMA,
            "pid": os.getpid(),
            "fingerprint": _jsonable(fingerprint)
            if fingerprint else None})

    @property
    def last_seq(self) -> int:
        return self._seq

    def append(self, kind: str, payload: Optional[dict] = None) -> int:
        """Append one record; returns its ``seq``."""
        t0 = time.perf_counter()
        rec = dict(_jsonable(payload or {}))
        if self.proc is not None and "proc" not in rec:
            rec["proc"] = self.proc
        with self._lock:
            self._seq += 1
            rec.update(seq=self._seq, run_id=self.run_id,
                       t=round(time.time(), 6), kind=str(kind))
            line = (json.dumps(rec) + "\n").encode()
            os.write(self._fd, line)
            seq = self._seq
        self.overhead_s += time.perf_counter() - t0
        return seq

    def close(self) -> None:
        if self._fd is None:
            return
        with self._lock:
            fd, self._fd = self._fd, None
        try:
            os.fsync(fd)
        except OSError:
            pass
        os.close(fd)

    def __enter__(self) -> "RunLedger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_ledger(path: str) -> list:
    """Parse a ledger, SKIPPING any line that does not parse or lacks a
    ``seq`` — a kill mid-write leaves at most one torn final line, and
    a strict reader must never accept it as a record."""
    out = []
    try:
        with open(path, "rb") as f:
            for raw in f:
                try:
                    rec = json.loads(raw)
                except ValueError:
                    continue
                if isinstance(rec, dict) and isinstance(
                        rec.get("seq"), int):
                    out.append(rec)
    except OSError:
        return []
    return out


# ---------------------------------------------------------------------------
# the process-current ledger
# ---------------------------------------------------------------------------

_CURRENT: Optional[RunLedger] = None


def attach(ledger_: RunLedger) -> Optional[RunLedger]:
    """Make ``ledger_`` the process-current sink; returns the previous
    one (caller re-attaches it when nesting)."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, ledger_
    return prev


def detach() -> Optional[RunLedger]:
    global _CURRENT
    prev, _CURRENT = _CURRENT, None
    return prev


def current() -> Optional[RunLedger]:
    return _CURRENT


def last_seq() -> Optional[int]:
    led = _CURRENT
    return led.last_seq if led is not None else None


def emit(kind: str, **payload) -> Optional[int]:
    """Append to the current ledger; ``None`` when none is attached
    (telemetry-off runs pay nothing). Records emitted inside a
    :func:`trace_scope` are stamped with the active trace identity
    unless the payload already carries one."""
    led = _CURRENT
    if led is None:
        return None
    _stamp_trace(payload)
    return led.append(kind, payload)


@contextmanager
def ledger(path: str, fingerprint: Optional[dict] = None,
           run_id: Optional[str] = None,
           proc: Optional[object] = None):
    """Open, attach, and on exit detach + fsync-close a run ledger."""
    led = RunLedger(path, fingerprint=fingerprint, run_id=run_id,
                    proc=proc)
    prev = attach(led)
    try:
        yield led
    finally:
        led.append("run_end", {"overhead_s": round(led.overhead_s, 6)})
        if current() is led:
            detach()
        if prev is not None:
            attach(prev)
        led.close()


# ---------------------------------------------------------------------------
# trace identity: request-scoped correlation across ledger records
# ---------------------------------------------------------------------------

_TLS = threading.local()


def new_trace_id() -> str:
    """Mint a request-scoped trace identity (16 hex). Unlike
    ``run_id`` — a digest of the run fingerprint, the root of the
    trace tree — a trace_id names ONE request's path through the
    process: admission, bucket wait, any compile it paid for, ack,
    cruise chunks, completion or quarantine."""
    return hashlib.sha256(os.urandom(16)).hexdigest()[:16]


def _trace_stack() -> list:
    st = getattr(_TLS, "trace", None)
    if st is None:
        st = _TLS.trace = []
    return st


def current_trace() -> Tuple[str, ...]:
    """The innermost active trace identity — ``()`` outside any
    :func:`trace_scope`. Thread-local: a worker thread doing traced
    work on a request's behalf must enter its own scope (the router
    hands the waiting requests' ids to the background pool build)."""
    st = getattr(_TLS, "trace", None)
    return st[-1] if st else ()


@contextmanager
def trace_scope(*trace_ids):
    """Attribute everything emitted in this block — ledger records via
    :func:`emit`, closing spans, capsule manifests — to the given
    trace id(s). A batch serving several requests carries all their
    ids; ``None`` entries are dropped so callers can pass optional
    ids straight through."""
    ids = tuple(str(t) for t in trace_ids if t)
    st = _trace_stack()
    st.append(ids)
    try:
        yield ids
    finally:
        st.pop()


def _stamp_trace(payload: dict) -> None:
    """Stamp the active trace identity into a ledger payload (single
    id as ``trace_id``, several as ``trace_ids``) unless the caller
    already set one explicitly — explicit beats ambient, so a
    per-lane record can name ITS request inside a batch scope."""
    if "trace_id" in payload or "trace_ids" in payload:
        return
    ids = current_trace()
    if not ids:
        return
    if len(ids) == 1:
        payload["trace_id"] = ids[0]
    else:
        payload["trace_ids"] = list(ids)


def record_trace_ids(rec: dict) -> Tuple[str, ...]:
    """Every trace id a ledger record names (reader-side helper:
    ``tools/obs.py trace`` matches on this)."""
    ids = []
    if rec.get("trace_id"):
        ids.append(str(rec["trace_id"]))
    for t in rec.get("trace_ids") or ():
        ids.append(str(t))
    return tuple(ids)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


@contextmanager
def span(name: str, block_on=None, **attrs):
    """One nested wall-clock span.

    Enters ``torch.profiler.record_function`` with the leaf name so the
    phase also lands in profiler traces; on exit optionally blocks on
    ``block_on`` (a pytree of tensors: the async-dispatch discipline of
    ``utils/timers.py``) BEFORE reading the clock, then closes the span
    into the current ledger (kind ``span``, with the full slash ``path``
    so readers rebuild the tree without matching open/close pairs).
    Without an attached ledger the cost is two clock reads, a list
    push/pop and the profiler range."""
    import torch

    st = _stack()
    st.append(str(name))
    path = "/".join(st)
    depth = len(st) - 1
    t0 = time.perf_counter()
    err = None
    try:
        with torch.profiler.record_function(
                str(name).split("::")[-1].split("/")[-1]):
            yield
    except BaseException as e:
        err = type(e).__name__
        raise
    finally:
        if block_on is not None:
            try:
                from ibamr_tpu_torch.utils.timers import block_until_ready
                block_until_ready(block_on)
            except Exception:
                pass
        dur = time.perf_counter() - t0
        st.pop()
        led = _CURRENT
        if led is not None:
            payload = {"name": str(name), "path": path, "depth": depth,
                       "dur_s": round(dur, 9)}
            if attrs:
                payload["attrs"] = attrs
            if err is not None:
                payload["error"] = err
            _stamp_trace(payload)
            led.append("span", payload)


# ---------------------------------------------------------------------------
# chunk boundaries: counters snapshot + device-memory watermarks
# ---------------------------------------------------------------------------

def sample_memory_watermarks() -> int:
    """Read the CUDA caching allocator's ``memory_allocated`` and
    ``max_memory_allocated`` of every visible GPU into
    ``device_bytes_in_use`` / ``device_peak_bytes_in_use`` gauges
    (labeled by device index). Returns the number of gauge samples
    taken; 0, a clean no-op, without a GPU (the CPU reports no device
    memory, as the reference's CPU backend does)."""
    try:
        import torch
        if not torch.cuda.is_available():
            return 0
        count = torch.cuda.device_count()
    except Exception:
        return 0
    sampled = 0
    for d in range(count):
        try:
            stats = {"bytes_in_use": torch.cuda.memory_allocated(d),
                     "peak_bytes_in_use": torch.cuda.max_memory_allocated(d)}
        except Exception:
            continue
        for src, gname in (("bytes_in_use", "device_bytes_in_use"),
                           ("peak_bytes_in_use",
                            "device_peak_bytes_in_use")):
            gauge(gname, device=str(d)).set(stats[src])
            sampled += 1
    return sampled


def chunk_boundary(step: Optional[int] = None,
                   chunk_wall_s: Optional[float] = None) -> Optional[int]:
    """Per-chunk telemetry flush, called by the driver at the existing
    post-chunk host sync (the one-transfer-per-chunk point). Samples
    device-memory watermarks, snapshots every counter/gauge, and
    appends ONE ``counters`` record. A no-op returning ``None`` when
    no ledger is attached — an un-instrumented run pays zero."""
    led = _CURRENT
    if led is None:
        return None
    t0 = time.perf_counter()
    sample_memory_watermarks()
    snap = metrics_snapshot()
    extra = time.perf_counter() - t0   # append() accounts for itself
    led.overhead_s += extra
    rec = {
        "step": step,
        "chunk_wall_s": chunk_wall_s,
        "counters": snap["counters"],
        "gauges": snap["gauges"],
        "obs_overhead_s": round(led.overhead_s, 6)}
    if snap["histograms"]:
        rec["histograms"] = snap["histograms"]
    return led.append("counters", rec)
