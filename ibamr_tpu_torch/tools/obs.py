"""Run-ledger reader: summarize, follow, and compare telemetry (port of
the reference's ``tools/obs.py``).

The ledger (``ibamr_tpu_torch.obs``) is an append-only ``ledger.jsonl`` —
spans, per-chunk counter snapshots, incidents — every record stamped
with the run fingerprint digest (``run_id``) and a monotonic ``seq``.
This tool is the operator's side of that contract:

- ``summary``: one screen per run — the span tree aggregated by path
  with percent-of-parent, the counter/gauge table from the LAST
  per-chunk snapshot (counters are cumulative, so the last snapshot IS
  the run total — no summing, which is what makes supervised retries
  double-count-proof), and the incident timeline cross-referenced by
  seq.
- ``tail``: live follow of a growing ledger alongside the watchdog
  heartbeat (staleness age), for watching a run without attaching to
  its process; ``--grep``/``--trace`` narrow the stream to one
  substring or one request's trace id.
- ``trace``: one served request's full admission→completion timeline
  (admission record, spans with parentage, cache events, quarantine,
  completion verdict) reconstructed from the ledger alone by its
  ``trace_id`` (unique prefixes accepted).
- ``compare``: two ledgers -> per-phase wall deltas; two bench JSONs
  (``BENCH_r*.json`` or raw ``bench.py`` output) -> per-stage,
  per-phase, and serve-leg latency-percentile deltas between
  revisions; two fleet directories (auto-detected by their
  ``ledger-<proc>.jsonl`` shards) -> per-proc deltas.
- ``summary --fleet``: one multi-process run's merged rollup — the
  directory's per-process ledger shards interleaved in ``(seq, proc)``
  order: per-proc span trees, each proc's comm fraction from its
  newest ``device_time`` attribution, per-host last-record staleness,
  and the proc-labeled counter registry (cumulative per process,
  never summed across procs).

Examples::

    python -m ibamr_tpu_torch.tools.obs summary /tmp/fleet/ledger.jsonl
    python -m ibamr_tpu_torch.tools.obs summary /tmp/fleet_dir --fleet
    python -m ibamr_tpu_torch.tools.obs tail /tmp/fleet --max-seconds 30 --trace 3fa2
    python -m ibamr_tpu_torch.tools.obs trace /tmp/serve/ledger.jsonl 3fa2
    python -m ibamr_tpu_torch.tools.obs compare /tmp/a/ledger.jsonl /tmp/b/ledger.jsonl
    python -m ibamr_tpu_torch.tools.obs compare BENCH_r04.json BENCH_r05.json
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

from ibamr_tpu_torch.obs import (
    quantiles_from_counts,
    read_ledger,
    record_trace_ids,
)

LEDGER_NAME = "ledger.jsonl"


def resolve_ledger(path: str) -> str:
    """A directory is accepted and means its ``ledger.jsonl``."""
    if os.path.isdir(path):
        return os.path.join(path, LEDGER_NAME)
    return path


def _fmt_s(v) -> str:
    if v is None:
        return "-"
    v = float(v)
    if v >= 100:
        return f"{v:.1f}s"
    if v >= 0.1:
        return f"{v:.3f}s"
    return f"{v * 1e3:.2f}ms"


def _fmt_num(v) -> str:
    if isinstance(v, float) and v == int(v):
        v = int(v)
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


# ---------------------------------------------------------------------------
# summary
# ---------------------------------------------------------------------------

def span_tree(records: list) -> dict:
    """Aggregate span records by slash ``path``:
    ``{path: {"count": n, "total_s": s, "errors": e, "depth": d}}``."""
    tree: dict = {}
    for rec in records:
        if rec.get("kind") != "span":
            continue
        path = rec.get("path") or rec.get("name", "?")
        node = tree.setdefault(path, {"count": 0, "total_s": 0.0,
                                      "errors": 0,
                                      "depth": path.count("/")})
        node["count"] += 1
        node["total_s"] += float(rec.get("dur_s") or 0.0)
        if rec.get("error"):
            node["errors"] += 1
    return tree


def percent_of_parent(tree: dict, path: str,
                      wall_s=None) -> float | None:
    """Share of the parent phase's wall time this phase accounts for.
    Roots are charged against ``wall_s`` (the run's first->last record
    span) when known, else against the sum of all root phases."""
    total = tree[path]["total_s"]
    denom = 0.0
    p = path
    while "/" in p:
        # nearest ancestor that actually has spans (a slash inside a
        # single span NAME does not invent a phantom parent)
        p = p.rsplit("/", 1)[0]
        denom = tree.get(p, {}).get("total_s") or 0.0
        if denom:
            break
    if not denom:
        roots = [q for q in tree
                 if not any(q != r and q.startswith(r + "/")
                            for r in tree)]
        denom = wall_s if wall_s else sum(
            tree[q]["total_s"] for q in roots)
        if path not in roots and not wall_s:
            return None
    if not denom:
        return None
    return 100.0 * total / denom


def render_span_tree(records: list, wall_s=None) -> list:
    tree = span_tree(records)
    lines = []
    if not tree:
        return ["  (no spans)"]

    def eff_depth(path):
        # indent by ancestors that actually exist as spans, so a slash
        # inside one span NAME does not indent under a phantom parent
        return sum(1 for r in tree
                   if r != path and path.startswith(r + "/"))

    width = max(len(p.split("/")[-1]) + 2 * eff_depth(p)
                for p in tree) + 2
    for path in sorted(tree):
        node = tree[path]
        pct = percent_of_parent(tree, path, wall_s)
        label = "  " * eff_depth(path) + path.split("/")[-1]
        err = f"  errors={node['errors']}" if node["errors"] else ""
        lines.append(
            f"  {label:<{width}} {_fmt_s(node['total_s']):>10}"
            f"  x{node['count']:<5}"
            f" {'' if pct is None else f'{pct:5.1f}%':>7}{err}")
    return lines


def last_counters(records: list):
    """The newest ``counters`` record (cumulative => run totals)."""
    snap = None
    for rec in records:
        if rec.get("kind") == "counters":
            snap = rec
    return snap


def render_counters(snap) -> list:
    if snap is None:
        return ["  (no counter snapshots)"]
    lines = []
    for kind in ("counters", "gauges"):
        table = snap.get(kind) or {}
        for key in sorted(table):
            lines.append(f"  {key:<58} {_fmt_num(table[key]):>14}")
    return lines or ["  (empty snapshot)"]


def render_latency(snap) -> list:
    """Latency-percentile table from the histogram snapshots of the
    last ``counters`` record (cumulative => run distribution). Empty
    when the run recorded no histograms."""
    hists = (snap or {}).get("histograms") or {}
    rows = []
    for key in sorted(hists):
        s = hists[key]
        n = s.get("count") or 0
        if not n:
            continue
        p50, p95, p99 = quantiles_from_counts(s["counts"],
                                              [0.5, 0.95, 0.99])
        rows.append((key, n, float(s.get("sum") or 0.0) / n,
                     p50, p95, p99))
    if not rows:
        return []
    width = max(len(k) for k, *_ in rows) + 2
    lines = [f"  {'histogram':<{width}} {'count':>7} {'mean':>10}"
             f" {'p50':>10} {'p95':>10} {'p99':>10}"]
    for key, n, mean, p50, p95, p99 in rows:
        # *_seconds families render as durations; dimensionless
        # histograms (padding fraction) as plain numbers
        fmt = (_fmt_s if key.split("{", 1)[0].endswith("_seconds")
               else lambda v: _fmt_num(round(float(v), 6)))
        lines.append(f"  {key:<{width}} {n:>7} {fmt(mean):>10}"
                     f" {fmt(p50):>10} {fmt(p95):>10}"
                     f" {fmt(p99):>10}")
    return lines


def render_serving(snap, records: list) -> list:
    """Warm-pool efficacy block: the AOT executable cache's
    hit ratio plus the router's request/quarantine/padding totals,
    from the counter snapshot; per-request ``request`` records add the
    cold-vs-warm first-step latency split. Empty when the run never
    touched the serving layer."""
    table = (snap or {}).get("counters") or {}
    hits = table.get("aot_cache_hits_total", 0)
    misses = table.get("aot_cache_misses_total", 0)
    if not (hits or misses):
        # router-only runs never emit a counters snapshot (no driver
        # chunk accounting) — fall back to the per-event records
        events = [r.get("event") for r in records
                  if r.get("kind") == "aot_cache"]
        hits = events.count("hit")
        misses = events.count("miss")
    reqs = [r for r in records if r.get("kind") == "request"]
    if not (hits or misses or reqs):
        return []
    lines = []
    total = hits + misses
    ratio = f" ({100.0 * hits / total:.1f}% warm)" if total else ""
    lines.append(f"  executables: {hits} hit(s) / {misses} miss(es)"
                 f"{ratio}")
    for key, label in (("aot_cache_evictions_total", "evictions"),
                       ("aot_cache_corrupt_total",
                        "corrupt entries refused"),
                       ("aot_cache_inflight_waits_total",
                        "in-flight compile waits"),
                       ("serve_requests_total", "requests served"),
                       ("serve_cold_requests_total", "cold requests"),
                       ("serve_quarantined_total", "lanes quarantined"),
                       ("serve_padded_lanes_total", "padded lanes")):
        if table.get(key):
            lines.append(f"  {label}: {_fmt_num(table[key])}")
    if reqs:
        cold = [r["first_step_s"] for r in reqs
                if r.get("cold") and r.get("first_step_s") is not None]
        warm = [r["first_step_s"] for r in reqs
                if not r.get("cold")
                and r.get("first_step_s") is not None]
        if cold:
            lines.append(f"  cold first-step: "
                         f"{_fmt_s(max(cold))} worst of {len(cold)}")
        if warm:
            lines.append(f"  warm first-step: "
                         f"{_fmt_s(max(warm))} worst of {len(warm)}")
    return lines


def render_tuning(snap, records: list) -> list:
    """Autotuner block: the resolver's DB hit/fallback/skip
    totals plus the measured winner per searched configuration key,
    from ``tune_trial`` ledger records. Empty when the run never
    touched the tuner or the tuning DB."""
    table = (snap or {}).get("counters") or {}
    trials = [r for r in records if r.get("kind") == "tune_trial"]
    counter_keys = ("tuning_db_hits_total", "tuning_db_fallbacks_total",
                    "tuning_db_provenance_skips_total",
                    "tune_trials_total", "tune_pruned_total",
                    "tune_errors_total")
    if not trials and not any(table.get(k) for k in counter_keys):
        return []
    lines = []
    for key, label in ((counter_keys[0], "DB hits"),
                       (counter_keys[1], "DB fallbacks (heuristic)"),
                       (counter_keys[2], "DB provenance skips"),
                       (counter_keys[3], "trials measured"),
                       (counter_keys[4], "candidates pruned"),
                       (counter_keys[5], "trial errors")):
        if table.get(key):
            lines.append(f"  {label}: {_fmt_num(table[key])}")
    # winner per configuration key (n, markers), with its margin over
    # the best OTHER engine — the same ranking tune.py publishes
    by_key = {}
    for r in trials:
        if r.get("error") or not r.get("steps_per_s"):
            continue
        by_key.setdefault((r.get("n"), r.get("markers")), []).append(r)
    for (n, markers), rows in sorted(by_key.items(),
                                     key=lambda kv: kv[0]):
        rows.sort(key=lambda r: r["steps_per_s"], reverse=True)
        w = rows[0]
        ru = next((r for r in rows[1:]
                   if r.get("engine") != w.get("engine")), None)
        margin = (f", {w['steps_per_s'] / ru['steps_per_s']:.2f}x over "
                  f"{ru['engine']}" if ru and ru.get("steps_per_s")
                  else "")
        lines.append(
            f"  n={n} markers={markers}: {w.get('engine')}"
            f"/{w.get('spectral_dtype')}/L{w.get('chunk_length')} "
            f"{w['steps_per_s']:.2f} steps/s ({len(rows)} trials"
            f"{margin})")
    return lines


_REASON_RE = re.compile(r'reason="([^"]*)"')


def render_traffic(snap, records: list) -> list:
    """Admission & overload block: shed totals by reason,
    retry totals, reclaimed quarantined slots, queue-wait percentiles
    from the ``serve_queue_wait_seconds`` histogram, and a per-tenant-
    class request table joined from the
    ``request_admit``/``request``/``request_shed``/``request_retry``
    records. Empty when the run saw no admission-control activity
    (no sheds, retries, reclaims, or nonzero queue waits) — a plain
    serving run keeps its summary unchanged."""
    table = (snap or {}).get("counters") or {}
    hists = (snap or {}).get("histograms") or {}
    sheds = [r for r in records if r.get("kind") == "request_shed"]
    retries = [r for r in records if r.get("kind") == "request_retry"]
    shed_counters = {k: v for k, v in table.items()
                     if k.startswith("serve_shed_total")}
    retry_counters = {k: v for k, v in table.items()
                      if k.startswith("serve_retries_total")}
    reclaimed = table.get("serve_slots_reclaimed_total", 0)
    qsnap = hists.get("serve_queue_wait_seconds")
    waited = bool(qsnap and qsnap.get("count") and qsnap.get("sum"))
    if not (sheds or retries or shed_counters or retry_counters
            or reclaimed or waited):
        return []
    lines = []
    by_reason: dict = {}
    if shed_counters:
        for k, v in shed_counters.items():
            m = _REASON_RE.search(k)
            by_reason[m.group(1) if m else "?"] = int(v)
    else:
        for r in sheds:
            key = r.get("reason") or "?"
            by_reason[key] = by_reason.get(key, 0) + 1
    total_shed = sum(by_reason.values())
    if total_shed:
        detail = ", ".join(f"{k}={v}"
                           for k, v in sorted(by_reason.items()))
        lines.append(f"  shed: {total_shed} ({detail})")
    by_retry: dict = {}
    if retry_counters:
        for k, v in retry_counters.items():
            m = _REASON_RE.search(k)
            by_retry[m.group(1) if m else "?"] = int(v)
    else:
        for r in retries:
            key = r.get("reason") or "?"
            by_retry[key] = by_retry.get(key, 0) + 1
    if by_retry:
        detail = ", ".join(f"{k}={v}"
                           for k, v in sorted(by_retry.items()))
        lines.append(f"  retries: {sum(by_retry.values())} ({detail})")
    if reclaimed:
        lines.append(f"  quarantined slots reclaimed: "
                     f"{_fmt_num(reclaimed)}")
    if qsnap and qsnap.get("count"):
        p50, p99 = quantiles_from_counts(qsnap["counts"], [0.5, 0.99])
        lines.append(f"  queue wait: p50 {_fmt_s(p50)}  "
                     f"p99 {_fmt_s(p99)} "
                     f"({_fmt_num(qsnap['count'])} admissions)")
    else:
        qwaits = sorted(r["queue_wait_s"] for r in records
                        if r.get("kind") in ("request", "request_shed")
                        and r.get("queue_wait_s") is not None)
        if qwaits:
            import math
            idx = lambda q: qwaits[min(len(qwaits) - 1,  # noqa: E731
                                       max(0, math.ceil(q * len(qwaits))
                                           - 1))]
            lines.append(f"  queue wait: p50 {_fmt_s(idx(0.5))}  "
                         f"p99 {_fmt_s(idx(0.99))} "
                         f"({_fmt_num(len(qwaits))} requests)")
    classes: dict = {}

    def _cls(r):
        return classes.setdefault(
            r.get("tenant_class") or "?",
            {"admitted": 0, "completed": 0, "shed": 0, "retried": 0})

    for r in records:
        kind = r.get("kind")
        if kind == "request_admit":
            _cls(r)["admitted"] += 1
        elif kind == "request":
            _cls(r)["completed"] += 1
        elif kind == "request_shed":
            _cls(r)["shed"] += 1
        elif kind == "request_retry":
            _cls(r)["retried"] += 1
    for cls, c in sorted(classes.items()):
        lines.append(f"  class {cls:<12} admitted={c['admitted']:<5} "
                     f"completed={c['completed']:<5} "
                     f"shed={c['shed']:<5} retried={c['retried']}")
    return lines


def render_elastic(snap, records: list) -> list:
    """Elastic-pool block: scale events by action+reason from
    the ``pool_scale`` records, the serve-mode ladder history from
    ``serve_mode`` transitions, and the restart drill's
    checkpoint/restore outcome from
    ``serving_manifest``/``serving_restore``. Empty when the run had
    no elastic manager — a static-router summary is unchanged."""
    scales = [r for r in records if r.get("kind") == "pool_scale"]
    modes = [r for r in records if r.get("kind") == "serve_mode"]
    manifests = [r for r in records
                 if r.get("kind") == "serving_manifest"]
    restores = [r for r in records
                if r.get("kind") == "serving_restore"]
    if not (scales or modes or manifests or restores):
        return []
    lines = []
    by_action: dict = {}
    for r in scales:
        key = (r.get("action") or "?", r.get("reason") or "?")
        by_action[key] = by_action.get(key, 0) + 1
    if by_action:
        detail = ", ".join(f"{a}/{re}={n}" for (a, re), n
                           in sorted(by_action.items()))
        lines.append(f"  scale events: {len(scales)} ({detail})")
    warmed = [r.get("warm_s") for r in scales
              if r.get("action") == "warmed"
              and r.get("warm_s") is not None]
    if warmed:
        lines.append(f"  scale-up latency: max {_fmt_s(max(warmed))} "
                     f"over {len(warmed)} grow(s)")
    fams = ((snap or {}).get("gauges")
            or {}).get("serve_families_live")
    if fams is not None:
        lines.append(f"  families live (last): {int(fams)}")
    if modes:
        hist = " -> ".join([modes[0].get("prev") or "?"]
                           + [m.get("mode") or "?" for m in modes])
        lines.append(f"  mode ladder: {hist} "
                     f"({len(modes)} transition(s))")
    for r in manifests:
        lines.append(f"  manifest saved: {r.get('path')} "
                     f"({r.get('families')} families, "
                     f"digest {str(r.get('scale_digest'))[:12]})")
    for r in restores:
        lines.append(f"  restart: {r.get('warmed')}/"
                     f"{r.get('families')} re-warmed in "
                     f"{_fmt_s(r.get('warm_s'))}, "
                     f"fresh_compiles={r.get('fresh_compiles')} "
                     f"persistent_loads={r.get('persistent_loads')}")
    return lines


def render_design(snap, records: list) -> list:
    """Design-loop block: per-label iteration counts, the
    objective trajectory, compile accounting (cold misses vs warm
    hits — the adjoint-at-primal-cost contract says warm iterations
    pay ZERO compiles), and cold-vs-warm iteration wall from the
    ``design_iter`` records the design loop's ``DesignLoop``
    emits. Empty when the run had no design loop."""
    iters = [r for r in records if r.get("kind") == "design_iter"]
    if not iters:
        return []
    lines = []
    by_label: dict = {}
    for r in iters:
        by_label.setdefault(r.get("label") or "?", []).append(r)
    for label, rs in sorted(by_label.items()):
        rs = sorted(rs, key=lambda r: (r.get("iteration") or 0))
        objs = [r.get("objective") for r in rs]
        misses = sum(int(r.get("cache_misses") or 0) for r in rs)
        warm_miss = sum(int(r.get("cache_misses") or 0)
                        for r in rs[1:])
        warm_wall = [r.get("wall_s") for r in rs[1:]
                     if r.get("wall_s") is not None]
        lines.append(f"  {label}: {len(rs)} iteration(s), "
                     f"objective {objs[0]:.4e} -> {objs[-1]:.4e}"
                     + (" (decreasing)" if len(objs) > 1
                        and all(b < a for a, b in zip(objs, objs[1:]))
                        else ""))
        lines.append(f"    compiles: {misses} total, {warm_miss} warm"
                     + ("  [warm iterations recompiled!]"
                        if warm_miss else ""))
        if rs and rs[0].get("wall_s") is not None and warm_wall:
            lines.append(
                f"    wall: cold {_fmt_s(rs[0].get('wall_s'))}, "
                f"warm mean {_fmt_s(sum(warm_wall) / len(warm_wall))}")
        gn = [r.get("grad_norm") for r in rs
              if r.get("grad_norm") is not None]
        if gn:
            lines.append(f"    grad norm: {gn[0]:.3e} -> {gn[-1]:.3e}")
    return lines


def render_assim(snap, records: list) -> list:
    """Assimilation block: forecast-error trajectory and
    spread trend from the ``assim_cycle`` records, QC rejections by
    reason from the labelled counter (record fallback), inflation
    escalations from the supervisor's incident stream, and the drill
    verdict (``assim_summary``) when one landed. Empty when the run
    never assimilated."""
    cycles = [r for r in records if r.get("kind") == "assim_cycle"]
    rejects = [r for r in records
               if r.get("kind") == "assim_qc_reject"]
    summaries = [r for r in records
                 if r.get("kind") == "assim_summary"]
    if not (cycles or rejects or summaries):
        return []
    lines = []
    analyzed = [r for r in cycles if not r.get("skipped")]
    if cycles:
        lines.append(f"  cycles: {len(cycles)} "
                     f"({len(analyzed)} analyzed, "
                     f"{len(cycles) - len(analyzed)} skipped)")
    errs = [r["forecast_error"] for r in analyzed
            if r.get("forecast_error") is not None]
    if errs:
        shown = (errs if len(errs) <= 6
                 else errs[:3] + [None] + errs[-2:])
        traj = " -> ".join("..." if e is None else f"{e:.3e}"
                           for e in shown)
        lines.append(f"  forecast error: {traj}")
    spreads = [(r.get("spread_f"), r.get("spread_a"))
               for r in analyzed if r.get("spread_f") is not None]
    if spreads:
        f0, a0 = spreads[0]
        fl, al = spreads[-1]
        lines.append(f"  spread (forecast/analysis): "
                     f"{f0:.3e}/{a0:.3e} -> {fl:.3e}/{al:.3e}")
    if analyzed and analyzed[-1].get("consistency") is not None:
        lines.append(f"  innovation consistency (last): "
                     f"{analyzed[-1]['consistency']:.3f} "
                     f"(1 = spread matches error)")

    # QC rejections by reason: the counter labels are authoritative;
    # the structured reject records are the fallback
    by_reason: dict = {}
    for k, v in ((snap or {}).get("counters") or {}).items():
        if k.startswith("assim_qc_rejections_total"):
            m = _REASON_RE.search(k)
            by_reason[m.group(1) if m else "?"] = int(v)
    if not by_reason:
        for r in rejects:
            key = r.get("reason") or "?"
            by_reason[key] = by_reason.get(key, 0) + 1
    if by_reason:
        detail = ", ".join(f"{k}={n}"
                           for k, n in sorted(by_reason.items()))
        lines.append(f"  qc rejections: {sum(by_reason.values())} "
                     f"({detail})")
    escal = [r for r in records
             if r.get("kind") == "incident"
             and r.get("event") == "inflation_escalation"]
    if escal:
        ladder = " -> ".join(
            [f"{escal[0].get('inflation_before')}"]
            + [f"{r.get('inflation_after')}" for r in escal])
        lines.append(f"  inflation escalations: {len(escal)} "
                     f"({ladder})")
    elif analyzed:
        lines.append(f"  inflation (last): "
                     f"{analyzed[-1].get('inflation')}")
    for r in summaries:
        fe, ol = r.get("forecast_error"), r.get("open_loop_error")
        if fe is not None and ol:
            lines.append(f"  drill verdict: forecast {fe:.3e} vs "
                         f"open-loop {ol:.3e} "
                         f"({ol / fe:.1f}x better)")
    return lines


def render_incidents(records: list, t0=None) -> list:
    lines = []
    for rec in records:
        if rec.get("kind") not in ("incident", "replay"):
            continue
        rel = ("     -" if t0 is None or rec.get("t") is None
               else f"{rec['t'] - t0:+9.2f}s")
        what = rec.get("event") or rec.get("incident_kind") \
            or rec.get("verdict") or rec["kind"]
        extra = " ".join(
            f"{k}={rec[k]}" for k in ("incident_kind", "step", "lane",
                                      "retry", "verdict")
            if rec.get(k) is not None and rec.get(k) != what)
        lines.append(f"  seq={rec['seq']:<6} {rel}  {what:<22} {extra}")
    return lines or ["  (no incidents)"]


# ---------------------------------------------------------------------------
# the device column: host spans x attributed device time
# ---------------------------------------------------------------------------

def device_spans(records: list, summary_path: str = ""):
    """Per-span device seconds + total, from an explicit
    ``prof_summary.json`` or from the ledger's LAST ``device_time``
    record (``python -m ibamr_tpu_torch.tools.prof attribute --ledger`` appends one).
    Returns ``(spans, total_device_s)`` or ``None``."""
    if summary_path:
        from ibamr_tpu_torch.obs.deviceprof import read_summary

        s = read_summary(summary_path)
        spans = {k: (v.get("device_s") if isinstance(v, dict) else v)
                 for k, v in (s.get("spans") or {}).items()}
        return spans, s.get("total_device_s")
    recs = [r for r in records if r.get("kind") == "device_time"]
    if not recs:
        return None
    last = recs[-1]
    return (last.get("spans") or {}), last.get("total_device_s")


def render_device_table(records: list, dev) -> list:
    """host vs attributed device time per phase: host share of the
    run, device share of the capture, and the host/device gap — the
    dispatch/python overhead the device never saw (a host phase much
    wider than its device time is overhead; the reverse is a span that
    closed before its async work drained)."""
    spans, dev_total = dev
    tree = span_tree(records)
    host_total = sum(n["total_s"] for p, n in tree.items()
                     if not any(p != r and p.startswith(r + "/")
                                for r in tree)) or None
    paths = sorted(set(tree) | set(spans))
    if not paths:
        return ["  (no spans on either side)"]
    width = max(len(p) for p in paths) + 2
    lines = [f"  {'phase':<{width}} {'host':>10} {'host%':>7}"
             f" {'device':>10} {'dev%':>7} {'gap':>10}"]
    for p in paths:
        h = tree.get(p, {}).get("total_s")
        d = spans.get(p)
        hp = (f"{100.0 * h / host_total:6.1f}%"
              if h is not None and host_total else "      -")
        dp = (f"{100.0 * d / dev_total:6.1f}%"
              if d is not None and dev_total else "      -")
        gap = (_fmt_s(h - d) if h is not None and d is not None
               else "-")
        lines.append(f"  {p:<{width}} {_fmt_s(h):>10} {hp:>7}"
                     f" {_fmt_s(d):>10} {dp:>7} {gap:>10}")
    if dev_total is not None:
        lines.append(f"  {'(device total)':<{width}} {'':>10} {'':>7}"
                     f" {_fmt_s(dev_total):>10}")
    return lines


# ---------------------------------------------------------------------------
# fleet: merged multi-process rollup
# ---------------------------------------------------------------------------

def _proc_records(merged: dict, proc: str) -> list:
    return [r for r in merged["records"]
            if str(r.get("proc", "")) == proc]


def _comm_line(records: list):
    """The comm rollup of one proc's NEWEST ``device_time`` record
    (``python -m ibamr_tpu_torch.tools.prof attribute --ledger`` appends one per capture) —
    comm seconds, device total, and the comm fraction — or ``None``
    when no attribution with op classes has run on that shard."""
    for rec in reversed(records):
        if rec.get("kind") != "device_time":
            continue
        oc = rec.get("op_classes") or {}
        total = rec.get("total_device_s")
        if "comm_s" not in oc or not total:
            continue
        comm = float(oc["comm_s"] or 0.0)
        return (f"  comm: {_fmt_s(comm)} of {_fmt_s(total)} device "
                f"({100.0 * comm / float(total):.1f}% of capture)")
    return None


def _census_line(records: list):
    """The structural comm split of one proc's NEWEST ``graph_census``
    record (``tools/fleet.py`` emits one per supervised run) —
    how many data-moving collectives the chunk issues and how many have
    an independent-compute window to hide behind. Backend-independent,
    so it complements the measured ``comm_s`` line even on captures
    where the CPU scheduler serialized everything."""
    for rec in reversed(records):
        if rec.get("kind") != "graph_census":
            continue
        total = rec.get("structural_collectives")
        if total is None:
            continue
        hid = int(rec.get("hidden_collectives") or 0)
        unhid = int(rec.get("unhidden_collectives") or 0)
        frac = rec.get("hidden_fraction")
        extra = ""
        if rec.get("mesh_devices"):
            extra = (f" [lanes={rec.get('lanes')} x "
                     f"D={rec['mesh_devices']}]")
        if int(total) == 0:
            return (f"  comm graph: 0 data-moving collectives in the "
                    f"chunk (fully lane-local){extra}")
        return (f"  comm graph: {total} data-moving collectives, "
                f"{hid} hidden / {unhid} unhidden "
                f"({frac}% structurally hidden){extra}")
    return None


def cmd_fleet_summary(args) -> int:
    from ibamr_tpu_torch.obs.merge import fleet_counters, merge_ledgers

    try:
        merged = merge_ledgers(args.ledger)
    except ValueError as e:
        print(f"[obs] {e}", file=sys.stderr)
        return 1
    if not merged["records"]:
        print(f"[obs] no ledger shards under {args.ledger} "
              f"(expected ledger-<proc>.jsonl)", file=sys.stderr)
        return 1
    now = time.time()
    print(f"run_id: {merged['run_id']}   procs: "
          f"{len(merged['procs'])}   records: "
          f"{len(merged['records'])}")
    for proc in merged["procs"]:
        recs = _proc_records(merged, proc)
        info = merged["per_proc"][proc]
        times = [r["t"] for r in recs
                 if isinstance(r.get("t"), (int, float))]
        wall = (max(times) - min(times)) if len(times) > 1 else None
        stale = (f"{now - info['last_t']:.1f}s ago"
                 if info.get("last_t") else "-")
        ended = any(r.get("kind") == "run_end" for r in recs)
        print(f"\nproc {proc}: {info['records']} records   wall "
              f"{_fmt_s(wall)}   last record {stale}"
              + ("" if ended else "   (no run_end — alive or killed)"))
        for ln in render_span_tree(recs, wall):
            print(ln)
        comm = _comm_line(recs)
        if comm:
            print(comm)
        census = _census_line(recs)
        if census:
            print(census)
    snap = fleet_counters(merged)
    if snap["counters"] or snap["gauges"]:
        print("\nfleet counters (last snapshot per proc, "
              "proc-labeled — cumulative per process, never summed):")
        for kind in ("counters", "gauges"):
            for key in sorted(snap[kind]):
                print(f"  {key:<58} {_fmt_num(snap[kind][key]):>14}")
    print("\nincidents (all procs, merged order):")
    times = [r["t"] for r in merged["records"]
             if isinstance(r.get("t"), (int, float))]
    t0 = min(times) if times else None
    for ln in render_incidents(merged["records"], t0):
        print(ln)
    return 0


def cmd_summary(args) -> int:
    if getattr(args, "fleet", False):
        return cmd_fleet_summary(args)
    path = resolve_ledger(args.ledger)
    records = read_ledger(path)
    if not records:
        print(f"[obs] no readable records in {path}", file=sys.stderr)
        return 1
    start = next((r for r in records if r.get("kind") == "run_start"),
                 records[0])
    end = next((r for r in records if r.get("kind") == "run_end"), None)
    times = [r["t"] for r in records if isinstance(r.get("t"),
                                                   (int, float))]
    wall = (max(times) - min(times)) if len(times) > 1 else None
    print(f"run_id: {start.get('run_id')}   records: {len(records)}"
          f"   wall: {_fmt_s(wall)}"
          + ("" if end is None else
             f"   obs_overhead: {_fmt_s(end.get('overhead_s'))}"))
    fp = start.get("fingerprint") or {}
    if fp:
        print(f"fingerprint: platform={fp.get('platform')}"
              f" engine={fp.get('engine')}"
              f" spectral_dtype={fp.get('spectral_dtype')}"
              f" config_digest={str(fp.get('config_digest'))[:12]}")
    print("\nphases (total, calls, % of parent):")
    for ln in render_span_tree(records, wall):
        print(ln)
    if getattr(args, "device", None) is not None:
        dev = device_spans(records, "" if args.device is True
                           else args.device)
        print("\ndevice time (host vs attributed device, per phase):")
        if dev is None:
            print("  (no device_time record in the ledger — run "
                  "`python -m ibamr_tpu_torch.tools.prof attribute <capture> --ledger ...`, "
                  "or pass --device <prof_summary.json>)")
        else:
            for ln in render_device_table(records, dev):
                print(ln)
    print("\ncounters (last snapshot = run totals):")
    for ln in render_counters(last_counters(records)):
        print(ln)
    latency = render_latency(last_counters(records))
    if latency:
        print("\nlatency (histogram percentiles, last snapshot):")
        for ln in latency:
            print(ln)
    serving = render_serving(last_counters(records), records)
    if serving:
        print("\nserving (warm-pool efficacy):")
        for ln in serving:
            print(ln)
    tuning = render_tuning(last_counters(records), records)
    if tuning:
        print("\ntuning (autotuner + resolver DB):")
        for ln in tuning:
            print(ln)
    traffic = render_traffic(last_counters(records), records)
    if traffic:
        print("\ntraffic (admission & overload):")
        for ln in traffic:
            print(ln)
    elastic = render_elastic(last_counters(records), records)
    if elastic:
        print("\nelastic pools (scaling, brownout, restart):")
        for ln in elastic:
            print(ln)
    design = render_design(last_counters(records), records)
    if design:
        print("\ndesign loop (adjoint iterations, compile "
              "accounting):")
        for ln in design:
            print(ln)
    assim = render_assim(last_counters(records), records)
    if assim:
        print("\nassimilation (filter health, QC, forecast skill):")
        for ln in assim:
            print(ln)
    print("\nincidents:")
    t0 = min(times) if times else None
    for ln in render_incidents(records, t0):
        print(ln)
    return 0


# ---------------------------------------------------------------------------
# tail
# ---------------------------------------------------------------------------

def _one_line(rec: dict) -> str:
    kind = rec.get("kind")
    if kind == "span":
        return (f"seq={rec['seq']:<6} span      "
                f"{rec.get('path')}  {_fmt_s(rec.get('dur_s'))}")
    if kind == "counters":
        n = len(rec.get("counters") or {}) + len(rec.get("gauges") or {})
        return (f"seq={rec['seq']:<6} counters  step={rec.get('step')} "
                f"chunk={_fmt_s(rec.get('chunk_wall_s'))} "
                f"({n} metrics)")
    if kind == "profile":
        return (f"seq={rec['seq']:<6} profile   "
                f"stage={rec.get('stage')} -> {rec.get('capture_dir')}")
    if kind == "request":
        return (f"seq={rec['seq']:<6} request   "
                f"tenant={rec.get('tenant')} "
                f"{'cold' if rec.get('cold') else 'warm'} "
                f"lane={rec.get('lane')} "
                f"first_step={_fmt_s(rec.get('first_step_s'))} "
                f"ok={rec.get('ok')}")
    if kind == "request_shed":
        return (f"seq={rec['seq']:<6} shed      "
                f"tenant={rec.get('tenant')} "
                f"reason={rec.get('reason')} "
                f"queue_wait={_fmt_s(rec.get('queue_wait_s'))} "
                f"retries={rec.get('retries')}")
    if kind == "request_retry":
        return (f"seq={rec['seq']:<6} retry     "
                f"tenant={rec.get('tenant')} "
                f"attempt={rec.get('attempt')} "
                f"reason={rec.get('reason')} "
                f"backoff={_fmt_s(rec.get('backoff_s'))}")
    if kind == "tune_trial":
        return (f"seq={rec['seq']:<6} tune      "
                f"{rec.get('engine')}/{rec.get('spectral_dtype')}"
                f"/L{rec.get('chunk_length')} n={rec.get('n')} "
                f"{rec.get('steps_per_s')} steps/s "
                f"{'HIT' if rec.get('cache_hit') else 'compile'}"
                + (f" ERROR={rec.get('error')}" if rec.get("error")
                   else ""))
    if kind == "aot_cache":
        return (f"seq={rec['seq']:<6} aot_cache "
                f"{rec.get('event')} key={rec.get('key')} "
                f"label={rec.get('label')}")
    if kind == "pool_scale":
        return (f"seq={rec['seq']:<6} scale     "
                f"{rec.get('action')} family={rec.get('family')} "
                f"reason={rec.get('reason')} "
                f"live={rec.get('families_live')}"
                + (f" warm={_fmt_s(rec.get('warm_s'))}"
                   if rec.get("warm_s") is not None else ""))
    if kind == "serve_mode":
        return (f"seq={rec['seq']:<6} mode      "
                f"{rec.get('prev')} -> {rec.get('mode')} "
                f"queue_p99={_fmt_s(rec.get('queue_p99_s'))} "
                f"backlog={rec.get('backlog')}")
    if kind == "serving_manifest":
        return (f"seq={rec['seq']:<6} manifest  "
                f"{rec.get('path')} families={rec.get('families')} "
                f"digest={str(rec.get('scale_digest'))[:12]}")
    if kind == "serving_restore":
        return (f"seq={rec['seq']:<6} restore   "
                f"warmed={rec.get('warmed')}/{rec.get('families')} "
                f"{_fmt_s(rec.get('warm_s'))} "
                f"fresh={rec.get('fresh_compiles')} "
                f"persistent={rec.get('persistent_loads')}")
    if kind == "assim_cycle":
        if rec.get("skipped"):
            return (f"seq={rec['seq']:<6} assim     "
                    f"cycle={rec.get('cycle')} step={rec.get('step')} "
                    f"SKIPPED accepted={rec.get('accepted')} "
                    f"rejected={rec.get('rejected')}")
        return (f"seq={rec['seq']:<6} assim     "
                f"cycle={rec.get('cycle')} step={rec.get('step')} "
                f"err={rec.get('forecast_error'):.3e} "
                f"spread={rec.get('spread_a'):.3e} "
                f"infl={rec.get('inflation')} "
                f"alive={rec.get('n_alive')} "
                f"wall={_fmt_s(rec.get('analysis_wall_s'))}")
    if kind == "assim_qc_reject":
        return (f"seq={rec['seq']:<6} qc_reject "
                f"cycle={rec.get('cycle')} "
                f"{rec.get('instrument')} reason={rec.get('reason')} "
                f"innovation={rec.get('innovation')}")
    if kind == "device_time":
        return (f"seq={rec['seq']:<6} device    "
                f"{_fmt_s(rec.get('total_device_s'))} device, "
                f"{100.0 * (rec.get('fraction_attributed') or 0):.1f}% "
                f"attributed ({rec.get('capture_dir')})")
    body = {k: v for k, v in rec.items()
            if k not in ("seq", "run_id", "t", "kind")}
    return f"seq={rec['seq']:<6} {kind:<9} {json.dumps(body)[:140]}"


def _tail_match(rec: dict, grep: str, trace: str) -> bool:
    """Both filters must pass: ``grep`` is a substring match against
    the raw record JSON, ``trace`` a (prefix-tolerant) trace-id match —
    together they let one request be followed live."""
    if trace and not any(t == trace or t.startswith(trace)
                         for t in record_trace_ids(rec)):
        return False
    if grep and grep not in json.dumps(rec):
        return False
    return True


def cmd_tail(args) -> int:
    path = resolve_ledger(args.ledger)
    hb_path = args.heartbeat or os.path.join(
        os.path.dirname(path) or ".", "heartbeat.json")
    from ibamr_tpu_torch.utils.watchdog import heartbeat_age
    seen = -1
    deadline = (time.monotonic() + args.max_seconds
                if args.max_seconds else None)
    last_hb_print = 0.0
    while True:
        for rec in read_ledger(path):
            if rec["seq"] > seen:
                seen = rec["seq"]
                if _tail_match(rec, args.grep, args.trace):
                    print(_one_line(rec), flush=True)
        now = time.monotonic()
        if now - last_hb_print >= args.heartbeat_every:
            last_hb_print = now
            age = heartbeat_age(hb_path)
            if age is not None:
                print(f"[heartbeat] age={age:.1f}s ({hb_path})",
                      file=sys.stderr, flush=True)
        if deadline is not None and now >= deadline:
            return 0
        time.sleep(args.interval)


# ---------------------------------------------------------------------------
# trace: one request's timeline, from the ledger alone
# ---------------------------------------------------------------------------

def render_trace(records: list, tid: str) -> list:
    """One request's full admission→completion timeline: every record
    carrying ``tid``, chronological, spans indented by their recorded
    depth (parentage), times relative to the first record (admission).
    Empty when nothing carries the id."""
    matched = [r for r in records if tid in record_trace_ids(r)]
    if not matched:
        return []
    t0 = next((r["t"] for r in matched
               if isinstance(r.get("t"), (int, float))), None)
    run_id = matched[0].get("run_id")
    admit = next((r for r in matched
                  if r.get("kind") == "request_admit"), None)
    done = next((r for r in matched if r.get("kind") == "request"),
                None)
    tenant = admit.get("tenant") if admit else None
    lines = [f"trace {tid}  (run {run_id}"
             + (f", tenant {tenant}" if tenant else "")
             + f")  {len(matched)} record(s)"]
    for rec in matched:
        rel = ("        -" if t0 is None
               or not isinstance(rec.get("t"), (int, float))
               else f"{rec['t'] - t0:+9.3f}s")
        kind = rec.get("kind")
        if kind == "span":
            indent = "  " * int(rec.get("depth") or 0)
            desc = (f"{indent}span {rec.get('path')}  "
                    f"{_fmt_s(rec.get('dur_s'))}")
        elif kind == "request_admit":
            desc = (f"admitted         tenant={rec.get('tenant')} "
                    f"steps={rec.get('steps')}"
                    + (f" class={rec.get('tenant_class')}"
                       if rec.get("tenant_class") else ""))
        elif kind == "request":
            qw = rec.get("queue_wait_s")
            desc = (f"completed        "
                    f"{'cold' if rec.get('cold') else 'warm'} "
                    f"ok={rec.get('ok')} lane={rec.get('lane')} "
                    f"first_step={_fmt_s(rec.get('first_step_s'))} "
                    f"total={_fmt_s(rec.get('total_s'))}"
                    + (f" queue_wait={_fmt_s(qw)}" if qw else "")
                    + (f" retries={rec.get('retries')}"
                       if rec.get("retries") else "")
                    + (" QUARANTINED" if rec.get("quarantined")
                       else ""))
        elif kind == "request_shed":
            desc = (f"SHED             "
                    f"reason={rec.get('reason')} "
                    f"queue_wait={_fmt_s(rec.get('queue_wait_s'))} "
                    f"retries={rec.get('retries')}"
                    + (f" error={rec.get('error')}"
                       if rec.get("error") else ""))
        elif kind == "request_retry":
            desc = (f"retry #{rec.get('attempt')}         "
                    f"reason={rec.get('reason')} "
                    f"backoff={_fmt_s(rec.get('backoff_s'))}")
        elif kind == "aot_cache":
            desc = (f"aot_cache {rec.get('event'):<7}"
                    f"label={rec.get('label')}"
                    + (f" compile={_fmt_s(rec.get('compile_s'))}"
                       if rec.get("compile_s") is not None else ""))
        elif kind == "lane_quarantine":
            desc = (f"lane_quarantine  lane={rec.get('lane')} "
                    f"step={rec.get('step')}")
        elif kind == "pool_scale":
            desc = (f"SCALE {rec.get('action'):<10} "
                    f"family={rec.get('family')} "
                    f"reason={rec.get('reason')}"
                    + (f" warm={_fmt_s(rec.get('warm_s'))}"
                       if rec.get("warm_s") is not None else ""))
        elif kind == "serve_mode":
            desc = (f"MODE             {rec.get('prev')} -> "
                    f"{rec.get('mode')} "
                    f"queue_p99={_fmt_s(rec.get('queue_p99_s'))} "
                    f"backlog={rec.get('backlog')}")
        elif kind == "assim_cycle":
            if rec.get("skipped"):
                desc = (f"assim cycle #{rec.get('cycle')}  SKIPPED "
                        f"(accepted={rec.get('accepted')} of "
                        f"{(rec.get('accepted') or 0) + (rec.get('rejected') or 0)})")
            else:
                desc = (f"assim cycle #{rec.get('cycle')}  "
                        f"err={rec.get('forecast_error'):.3e} "
                        f"spread={rec.get('spread_a'):.3e} "
                        f"infl={rec.get('inflation')} "
                        f"alive={rec.get('n_alive')} "
                        f"wall={_fmt_s(rec.get('analysis_wall_s'))}")
        elif kind == "assim_qc_reject":
            desc = (f"QC REJECT        {rec.get('instrument')} "
                    f"reason={rec.get('reason')} "
                    f"innovation={rec.get('innovation')}")
        else:
            body = {k: v for k, v in rec.items()
                    if k not in ("seq", "run_id", "t", "kind",
                                 "trace_id", "trace_ids")}
            desc = f"{kind:<16} {json.dumps(body)[:120]}"
        lines.append(f"  seq={rec['seq']:<6} {rel}  {desc}")
    if done is not None:
        verdict = ("ok" if done.get("ok")
                   else "quarantined" if done.get("quarantined")
                   else "failed")
        lines.append(f"  verdict: {verdict}")
    else:
        shed = next((r for r in matched
                     if r.get("kind") == "request_shed"), None)
        if shed is not None:
            lines.append(f"  verdict: shed ({shed.get('reason')})")
    return lines


def cmd_trace(args) -> int:
    path = resolve_ledger(args.ledger)
    records = read_ledger(path)
    wanted = args.trace_id
    full = sorted({t for r in records for t in record_trace_ids(r)
                   if t == wanted or t.startswith(wanted)})
    if not full:
        print(f"[obs] no records carry trace id {wanted!r} in {path}",
              file=sys.stderr)
        return 1
    if len(full) > 1 and wanted not in full:
        print(f"[obs] ambiguous trace-id prefix {wanted!r}: "
              f"{', '.join(full)}", file=sys.stderr)
        return 1
    tid = wanted if wanted in full else full[0]
    for ln in render_trace(records, tid):
        print(ln)
    return 0


# ---------------------------------------------------------------------------
# compare
# ---------------------------------------------------------------------------

def _is_ledger(path: str) -> bool:
    return os.path.isdir(path) or path.endswith(".jsonl")


def _bench_payload(path: str) -> dict:
    """Accept a raw ``bench.py`` JSON or a ``BENCH_r*.json`` wrapper
    (a wrapped run stores the parsed result under ``parsed``)."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict) and isinstance(data.get("parsed"), dict):
        return data["parsed"]
    return data


def _delta_line(name: str, a, b) -> str:
    if a in (None, 0) or b is None:
        return f"  {name:<34} {_fmt_num(a):>12} -> {_fmt_num(b):>12}"
    return (f"  {name:<34} {_fmt_num(a):>12} -> {_fmt_num(b):>12}"
            f"   {100.0 * (float(b) - float(a)) / float(a):+7.1f}%")


def compare_ledgers(path_a: str, path_b: str) -> list:
    lines = []
    ta = span_tree(read_ledger(resolve_ledger(path_a)))
    tb = span_tree(read_ledger(resolve_ledger(path_b)))
    lines.append("per-phase wall (A -> B):")
    for path in sorted(set(ta) | set(tb)):
        a = ta.get(path, {}).get("total_s")
        b = tb.get(path, {}).get("total_s")
        lines.append(_delta_line(path, a, b))
    ca = last_counters(read_ledger(resolve_ledger(path_a)))
    cb = last_counters(read_ledger(resolve_ledger(path_b)))
    if ca or cb:
        lines.append("counters (last snapshot, A -> B):")
        ka = (ca or {}).get("counters") or {}
        kb = (cb or {}).get("counters") or {}
        for key in sorted(set(ka) | set(kb)):
            lines.append(_delta_line(key, ka.get(key), kb.get(key)))
    return lines


def _profile_entries(payload: dict) -> dict:
    """{stage label: entry dict} from a bench JSON's ``profiles``
    manifest — dict entries (``{dir, stage, rev, bytes,
    attributed, summary?}``) or the bare path strings older bench
    JSONs recorded (``<label>_<rev>`` dirs -> label)."""
    out = {}
    for e in payload.get("profiles") or []:
        if isinstance(e, dict):
            out[e.get("stage") or e.get("dir", "?")] = e
        elif isinstance(e, str):
            label = os.path.basename(os.path.normpath(e))
            label = label.rsplit("_", 1)[0] if "_" in label else label
            out[label] = {"dir": e, "stage": label, "bytes": None,
                          "attributed": False}
    return out


def compare_bench(path_a: str, path_b: str) -> list:
    a, b = _bench_payload(path_a), _bench_payload(path_b)
    lines = []
    sa = {s.get("n"): s for s in (a.get("stages") or [])}
    sb = {s.get("n"): s for s in (b.get("stages") or [])}
    lines.append("stages steps/s (A -> B):")
    for n in sorted(set(sa) | set(sb), key=lambda x: (x is None, x)):
        lines.append(_delta_line(
            f"n={n}", sa.get(n, {}).get("steps_per_sec"),
            sb.get(n, {}).get("steps_per_sec")))
    pa, pb = a.get("phases") or {}, b.get("phases") or {}
    keys = [k for k in sorted(set(pa) | set(pb))
            if isinstance(pa.get(k), (int, float))
            or isinstance(pb.get(k), (int, float))]
    if keys:
        lines.append("phases (A -> B):")
        for k in keys:
            lines.append(_delta_line(k, pa.get(k), pb.get(k)))
    for key in ("value", "mxu_vs_scatter"):
        if a.get(key) is not None or b.get(key) is not None:
            lines.append(_delta_line(key, a.get(key), b.get(key)))
    va, vb = a.get("serve") or {}, b.get("serve") or {}
    serve_keys = [k for k in ("cold_first_step_s", "warm_first_step_s",
                              "warm_p50_s", "warm_p99_s",
                              "warm_over_cold")
                  if va.get(k) is not None or vb.get(k) is not None]
    if serve_keys:
        lines.append("serve (cold/warm drill, A -> B):")
        for k in serve_keys:
            lines.append(_delta_line(k, va.get(k), vb.get(k)))
        ha = (va.get("histograms") or {})
        hb = (vb.get("histograms") or {})
        for key in sorted(set(ha) | set(hb)):
            sa_, sb_ = ha.get(key), hb.get(key)
            pa_ = (quantiles_from_counts(sa_["counts"], [0.99])[0]
                   if sa_ and sa_.get("count") else None)
            pb_ = (quantiles_from_counts(sb_["counts"], [0.99])[0]
                   if sb_ and sb_.get("count") else None)
            if pa_ is not None or pb_ is not None:
                lines.append(_delta_line(
                    f"p99[{key}]",
                    None if pa_ is None else round(pa_, 6),
                    None if pb_ is None else round(pb_, 6)))
    fa, fb = _profile_entries(a), _profile_entries(b)
    if fa or fb:
        lines.append("profiles (attributed device s/capture, A -> B;"
                     " gate drift with python -m ibamr_tpu_torch.tools.prof diff):")
        for label in sorted(set(fa) | set(fb)):
            lines.append(_delta_line(
                f"device[{label}]",
                ((fa.get(label) or {}).get("summary")
                 or {}).get("total_device_s"),
                ((fb.get(label) or {}).get("summary")
                 or {}).get("total_device_s")))
    return lines


def _is_fleet(path: str) -> bool:
    """A directory holding >= 2 ledger shards, or a shard file —
    compare then goes per-proc."""
    from ibamr_tpu_torch.obs.merge import find_shards

    if os.path.isfile(path):
        return os.path.basename(path).startswith("ledger-")
    return os.path.isdir(path) and len(find_shards(path)) > 1


def compare_fleet(path_a: str, path_b: str) -> list:
    """Per-proc deltas between two merged fleet ledgers: each proc's
    span tree compared proc-to-proc (proc ids name the same rank of
    the fleet on both sides), then the proc-labeled counter registry."""
    from ibamr_tpu_torch.obs.merge import fleet_counters, merge_ledgers

    ma, mb = merge_ledgers(path_a), merge_ledgers(path_b)
    lines = [f"fleet: A procs={ma['procs']} run={ma['run_id']}   "
             f"B procs={mb['procs']} run={mb['run_id']}"]
    for proc in sorted(set(ma["procs"]) | set(mb["procs"])):
        ta = span_tree(_proc_records(ma, proc))
        tb = span_tree(_proc_records(mb, proc))
        if not (ta or tb):
            continue
        lines.append(f"proc {proc} per-phase wall (A -> B):")
        for path in sorted(set(ta) | set(tb)):
            lines.append(_delta_line(path,
                                     ta.get(path, {}).get("total_s"),
                                     tb.get(path, {}).get("total_s")))
    ka = fleet_counters(ma)["counters"]
    kb = fleet_counters(mb)["counters"]
    if ka or kb:
        lines.append("fleet counters (last snapshot per proc, A -> B):")
        for key in sorted(set(ka) | set(kb)):
            lines.append(_delta_line(key, ka.get(key), kb.get(key)))
    return lines


def cmd_compare(args) -> int:
    if _is_fleet(args.a) and _is_fleet(args.b):
        try:
            lines = compare_fleet(args.a, args.b)
        except ValueError as e:
            print(f"[obs] {e}", file=sys.stderr)
            return 1
    elif _is_ledger(args.a) and _is_ledger(args.b):
        lines = compare_ledgers(args.a, args.b)
    else:
        lines = compare_bench(args.a, args.b)
    print(f"A: {args.a}\nB: {args.b}")
    for ln in lines:
        print(ln)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run-ledger summary / tail / compare")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summary", help="phase tree + counters + "
                                       "incident timeline")
    s.add_argument("ledger", help="ledger.jsonl or its directory")
    s.add_argument("--fleet", action="store_true",
                   help="merge the directory's ledger-<proc>.jsonl "
                        "shards (one multi-process run) into per-proc span "
                        "trees, comm fractions, staleness, and a "
                        "proc-labeled counter rollup")
    s.add_argument("--device", nargs="?", const=True, default=None,
                   metavar="PROF_SUMMARY",
                   help="add the host-vs-device table per phase, from "
                        "the ledger's device_time record (bare flag) "
                        "or an explicit prof_summary.json / capture "
                        "dir")
    s.set_defaults(fn=cmd_summary)

    t = sub.add_parser("tail", help="follow a growing ledger (plus "
                                    "heartbeat staleness)")
    t.add_argument("ledger")
    t.add_argument("--interval", type=float, default=1.0)
    t.add_argument("--heartbeat", default="",
                   help="heartbeat.json (default: next to the ledger)")
    t.add_argument("--heartbeat-every", type=float, default=5.0)
    t.add_argument("--max-seconds", type=float, default=0.0,
                   help="exit after this long (0 = follow forever)")
    t.add_argument("--grep", default="",
                   help="only records whose JSON contains this "
                        "substring")
    t.add_argument("--trace", default="",
                   help="only records carrying this trace id (prefix "
                        "ok) — follow one request live")
    t.set_defaults(fn=cmd_tail)

    tr = sub.add_parser("trace", help="one request's full "
                                      "admission->completion timeline "
                                      "from the ledger")
    tr.add_argument("ledger", help="ledger.jsonl or its directory")
    tr.add_argument("trace_id", help="trace id (unique prefix ok)")
    tr.set_defaults(fn=cmd_trace)

    c = sub.add_parser("compare", help="two ledgers, or two bench "
                                       "JSONs (BENCH_r*.json)")
    c.add_argument("a")
    c.add_argument("b")
    c.set_defaults(fn=cmd_compare)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
