"""Device-profile attribution, roofline, and drift gate (port of the
reference's ``tools/prof.py``), on the port's
:mod:`~ibamr_tpu_torch.obs.deviceprof`:

- ``attribute``: parse the ``trace.json`` that
  ``utils/timers.profile_trace`` writes into a capture dir, attribute
  its device time to span paths (joining a run ledger's recorded spans
  when given), and land ``prof_summary.json`` next to the capture.
- ``show``: render a summary (span table, residual, roofline) without
  re-parsing the trace.
- ``check``: validate a ``prof_summary.json`` against the schema;
  exit 2 on malformation.
- ``diff``: compare two attributed summaries (capture dirs, summary
  files, or the summaries embedded in two JSON documents under
  ``profiles[*].summary``) per span path with tolerance bands: 0 within
  band, 1 improved beyond band, 2 regressed beyond band.
  ``--comm-tol-pct`` arms a tighter gate on the ``comm_s`` op class
  alone, advisory (printed, never enforced) on a capture with no device
  lane.
- ``archive``: attribute if needed, validate, and only then prune the
  raw trace, keeping the compact summary; a malformed summary exits 2
  and prunes nothing.

Examples::

    python -m ibamr_tpu_torch.tools.prof attribute /tmp/prof/cap \
        --ledger /tmp/run/ledger.jsonl
    python -m ibamr_tpu_torch.tools.prof show /tmp/prof/cap
    python -m ibamr_tpu_torch.tools.prof diff /tmp/prof/a /tmp/prof/b \
        --tol-pct 30
    python -m ibamr_tpu_torch.tools.prof archive /tmp/prof/cap

All offline and host-side: no device, usable on a laptop against a
capture copied off the card's machine.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ibamr_tpu_torch.obs import deviceprof
from ibamr_tpu_torch.obs.roofline import render_roofline

# drift bands (mirroring graph_audit's clean/improved/regressed): a
# span drifts only when BOTH the relative band and the absolute floor
# are exceeded — CPU captures jitter by whole percents on sub-ms spans,
# and the floor keeps that noise from paging anyone
DEFAULT_TOL_PCT = 25.0
DEFAULT_ABS_FLOOR_S = 200e-6


def _fmt_s(v) -> str:
    if v is None:
        return "-"
    v = float(v)
    if v >= 1.0:
        return f"{v:.3f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.3f}ms"
    return f"{v * 1e6:.1f}us"


# ---------------------------------------------------------------------------
# attribute / show / check
# ---------------------------------------------------------------------------

def _parse_module_map(spec: str) -> dict:
    out = {}
    for part in (spec or "").split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def render_summary(summary: dict) -> list:
    total = summary.get("total_device_s") or 0.0
    frac = summary.get("fraction_attributed")
    lines = [
        f"device time: {_fmt_s(total)} across "
        f"{summary.get('trace_files', '?')} trace file(s), "
        f"{len(summary.get('lanes') or [])} lane(s)",
        f"attributed:  {_fmt_s(summary.get('attributed_s'))} "
        f"({100.0 * frac:.1f}%)" if frac is not None else "attributed: -",
        "",
        "per-span device time:",
    ]
    spans = summary.get("spans") or {}
    width = max([len(p) for p in spans] + [20]) + 2
    for path in sorted(spans,
                       key=lambda p: -(spans[p].get("device_s") or 0)):
        node = spans[path]
        dv = node.get("device_s") or 0.0
        pct = 100.0 * dv / total if total else 0.0
        via = ",".join(sorted(node.get("via") or ()))
        lines.append(f"  {path:<{width}} {_fmt_s(dv):>10} {pct:6.1f}%"
                     f"   x{node.get('events', '?'):<6} {via}")
    unatt = summary.get("unattributed") or {}
    lines.append(f"residual (unattributed: "
                 f"{_fmt_s(summary.get('unattributed_s'))}):")
    for name in sorted(unatt, key=lambda k: -unatt[k]):
        lines.append(f"  {name:<{width}} {_fmt_s(unatt[name]):>10}")
    if not unatt:
        lines.append("  (none)")
    lines.append("roofline:")
    lines.extend(render_roofline(summary.get("roofline")))
    return lines


def cmd_attribute(args) -> int:
    summary = deviceprof.attribute_capture(
        args.capture_dir,
        span_paths=args.span or (),
        module_map=_parse_module_map(args.module_map),
        ledger=args.ledger or None)
    probs = deviceprof.validate_summary(summary)
    if probs:
        for p in probs:
            print(f"[prof] INVALID: {p}", file=sys.stderr)
        return 2
    path = deviceprof.write_summary(args.capture_dir, summary)
    if args.ledger:
        _ledger_device_record(args.ledger, summary)
    if args.json:
        print(json.dumps(deviceprof.compact_summary(summary), indent=1,
                         sort_keys=True))
    else:
        print(f"wrote {path}")
        for ln in render_summary(summary):
            print(ln)
    return 0


def _ledger_device_record(ledger: str, summary: dict) -> None:
    """Append the per-span device-time table to the run ledger as a
    ``device_time`` record — the ledger's device column. Appended
    directly (one ``os.write`` on an ``O_APPEND`` fd, continuing the
    run's ``seq`` and ``run_id``) rather than through ``RunLedger``,
    whose constructor stamps a fresh ``run_start`` — post-hoc
    attribution is part of the SAME run, not a new one."""
    import time

    from ibamr_tpu_torch.obs.bus import read_ledger

    if os.path.isdir(ledger):
        ledger = os.path.join(ledger, "ledger.jsonl")
    records = read_ledger(ledger)
    seq = max((r["seq"] for r in records), default=-1) + 1
    run_id = next((r.get("run_id") for r in records
                   if r.get("run_id")), None)
    rec = {
        "seq": seq, "run_id": run_id, "t": round(time.time(), 6),
        "kind": "device_time",
        "capture_dir": summary.get("capture_dir"),
        "total_device_s": summary.get("total_device_s"),
        "attributed_s": summary.get("attributed_s"),
        "unattributed_s": summary.get("unattributed_s"),
        "fraction_attributed": summary.get("fraction_attributed"),
        "spans": {k: (v.get("device_s") if isinstance(v, dict) else v)
                  for k, v in (summary.get("spans") or {}).items()},
        "op_classes": summary.get("op_classes"),
    }
    fd = os.open(ledger, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
    try:
        os.write(fd, (json.dumps(rec) + "\n").encode())
    finally:
        os.close(fd)


def cmd_show(args) -> int:
    summary = deviceprof.read_summary(args.path)
    probs = deviceprof.validate_summary(summary)
    for p in probs:
        print(f"[prof] WARNING: {p}", file=sys.stderr)
    print(f"summary: {deviceprof.summary_path(args.path)}")
    for ln in render_summary(summary):
        print(ln)
    return 0


def cmd_check(args) -> int:
    try:
        summary = deviceprof.read_summary(args.path)
    except (OSError, ValueError) as e:
        print(f"[prof] unreadable: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    probs = deviceprof.validate_summary(summary)
    if probs:
        for p in probs:
            print(f"[prof] INVALID: {p}", file=sys.stderr)
        return 2
    print(f"ok: {deviceprof.summary_path(args.path)}")
    return 0


# ---------------------------------------------------------------------------
# diff
# ---------------------------------------------------------------------------

def _bench_payload(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict) and isinstance(data.get("parsed"), dict):
        return data["parsed"]
    return data if isinstance(data, dict) else {}


def load_summaries(path: str) -> dict:
    """{label: summary} from a capture dir, a ``prof_summary.json``, or
    a bench JSON with embedded ``profiles[*].summary`` entries."""
    if os.path.isdir(path) or path.endswith(deviceprof.SUMMARY_NAME):
        s = deviceprof.read_summary(path)
        label = ((s.get("census") or {}).get("label")
                 or os.path.basename(os.path.normpath(
                     s.get("capture_dir") or path)))
        return {label: s}
    data = _bench_payload(path)
    if data.get("schema") == deviceprof.PROF_SCHEMA \
            and "total_device_s" in data:
        return {(data.get("census") or {}).get("label") or path: data}
    out = {}
    for entry in data.get("profiles") or []:
        if isinstance(entry, dict) and isinstance(entry.get("summary"),
                                                  dict):
            out[entry.get("stage")
                or (entry.get("summary").get("census") or {}).get("label")
                or entry.get("dir", "?")] = entry["summary"]
    return out


def _per_exec(summary: dict, seconds: float) -> float:
    execs = ((summary.get("roofline") or {}).get("executions")
             or (summary.get("census") or {}).get("executions") or 0)
    return seconds / execs if execs and execs > 0 else seconds


def _cpu_capture(summary: dict) -> bool:
    """True when the capture has no device lane (a torch trace's GPU
    lane, or the reference's ``/device:*`` timeline process): there
    ``comm_s`` measures a serialized copy, not overlap headroom. Unknown
    (no lanes recorded) counts as CPU: advisory beats a false page."""
    lanes = summary.get("lanes") or []
    return not any(ln.get("device") or "/device:" in str(
        ln.get("process") or "") for ln in lanes)


def diff_summaries(sa: dict, sb: dict, tol_pct: float,
                   floor_s: float, comm_tol_pct=None) -> tuple:
    """(report lines, verdict) for one pair — verdict in
    {"clean", "improved", "regressed"}. Times are normalized
    per-execution when both sides recorded execution counts, so a diff
    between a 40-step and an 80-step capture compares steps, not
    captures.

    ``comm_tol_pct`` arms the dedicated comm gate: a tighter
    band on ``op_class/comm_s`` alone, because on a multi-device run comm
    time is the one class the overlap work is supposed to keep flat —
    a comm_s growth that stays inside the general band is exactly how
    a halo that quietly stopped overlapping would slip through. On CPU
    captures (no device timeline) the gate is ADVISORY: it prints, but
    never flips the verdict."""
    lines = []
    verdict = "clean"

    def judge(name, a, b):
        nonlocal verdict
        a, b = float(a or 0.0), float(b or 0.0)
        delta = b - a
        pct = 100.0 * delta / a if a > 0 else (100.0 if b > 0 else 0.0)
        mark = ""
        if abs(delta) > floor_s and abs(pct) > tol_pct:
            if delta > 0:
                mark = "  REGRESSED"
                verdict = "regressed"
            else:
                mark = "  improved"
                if verdict != "regressed":
                    verdict = "improved"
        lines.append(f"  {name:<38} {_fmt_s(a):>10} -> {_fmt_s(b):>10}"
                     f" {pct:+7.1f}%{mark}")

    judge("total_device", _per_exec(sa, sa.get("total_device_s") or 0),
          _per_exec(sb, sb.get("total_device_s") or 0))
    spa = {k: (v.get("device_s") if isinstance(v, dict) else v)
           for k, v in (sa.get("spans") or {}).items()}
    spb = {k: (v.get("device_s") if isinstance(v, dict) else v)
           for k, v in (sb.get("spans") or {}).items()}
    for path in sorted(set(spa) | set(spb)):
        judge(path, _per_exec(sa, spa.get(path) or 0.0),
              _per_exec(sb, spb.get(path) or 0.0))
    judge("unattributed",
          _per_exec(sa, sa.get("unattributed_s") or 0),
          _per_exec(sb, sb.get("unattributed_s") or 0))
    # op-class drift: comm_s is the multi-device health line — a halo
    # that stopped overlapping or a new resharding shows up here even
    # when the owning span's total stays inside the band. other_s is a
    # remainder (total minus the named classes) so judging it would
    # double-report every named-class move.
    oca = sa.get("op_classes") or {}
    ocb = sb.get("op_classes") or {}
    for cls in sorted((set(oca) | set(ocb)) - {"other_s"}):
        judge(f"op_class/{cls}", _per_exec(sa, oca.get(cls) or 0.0),
              _per_exec(sb, ocb.get(cls) or 0.0))
    if comm_tol_pct is not None:
        ca = _per_exec(sa, float(oca.get("comm_s") or 0.0))
        cb = _per_exec(sb, float(ocb.get("comm_s") or 0.0))
        delta = cb - ca
        pct = 100.0 * delta / ca if ca > 0 else (100.0 if cb > 0
                                                 else 0.0)
        if delta > floor_s and pct > comm_tol_pct:
            cpu = _cpu_capture(sa) or _cpu_capture(sb)
            if cpu:
                lines.append(
                    f"  comm gate (>{comm_tol_pct:.0f}%): comm_s "
                    f"{_fmt_s(ca)} -> {_fmt_s(cb)} {pct:+.1f}% — "
                    f"ADVISORY (cpu capture: collectives lower "
                    f"synchronously, comm_s is not overlap headroom)")
            else:
                lines.append(
                    f"  comm gate (>{comm_tol_pct:.0f}%): comm_s "
                    f"{_fmt_s(ca)} -> {_fmt_s(cb)} {pct:+.1f}%"
                    f"  REGRESSED")
                verdict = "regressed"
        else:
            lines.append(f"  comm gate (>{comm_tol_pct:.0f}%): comm_s "
                         f"{_fmt_s(ca)} -> {_fmt_s(cb)} within band")
    return lines, verdict


def cmd_diff(args) -> int:
    try:
        a_map, b_map = load_summaries(args.a), load_summaries(args.b)
    except (OSError, ValueError) as e:
        print(f"[prof] cannot load summaries: {e}", file=sys.stderr)
        return 2
    for label, path in (("A", args.a), ("B", args.b)):
        m = a_map if label == "A" else b_map
        if not m:
            print(f"[prof] no attributed summaries in {label}: {path}"
                  " (run `prof.py attribute` first?)", file=sys.stderr)
            return 2
    print(f"A: {args.a}\nB: {args.b}   "
          f"(band: >{args.tol_pct:.0f}% and >{_fmt_s(args.abs_floor)})")
    worst = "clean"
    shared = sorted(set(a_map) & set(b_map))
    if not shared:
        print(f"[prof] no common stage labels: A={sorted(a_map)} "
              f"B={sorted(b_map)}", file=sys.stderr)
        return 2
    for label in shared:
        print(f"\nstage {label} (per-execution device time, A -> B):")
        lines, verdict = diff_summaries(
            a_map[label], b_map[label], args.tol_pct, args.abs_floor,
            comm_tol_pct=args.comm_tol_pct)
        for ln in lines:
            print(ln)
        if verdict == "regressed" or (verdict == "improved"
                                      and worst == "clean"):
            worst = verdict
    only = sorted(set(a_map) ^ set(b_map))
    if only:
        print(f"\n(unpaired stages ignored: {only})")
    print(f"\nverdict: {worst}")
    return {"clean": 0, "improved": 1, "regressed": 2}[worst]


# ---------------------------------------------------------------------------
# archive
# ---------------------------------------------------------------------------

def cmd_archive(args) -> int:
    spath = os.path.join(args.capture_dir, deviceprof.SUMMARY_NAME)
    if not os.path.exists(spath):
        summary = deviceprof.attribute_capture(
            args.capture_dir, ledger=args.ledger or None)
        probs = deviceprof.validate_summary(summary)
        if probs:
            for p in probs:
                print(f"[prof] INVALID: {p}", file=sys.stderr)
            print(f"[prof] refusing to archive {args.capture_dir}",
                  file=sys.stderr)
            return 2
        deviceprof.write_summary(args.capture_dir, summary)
    else:
        try:
            summary = deviceprof.read_summary(spath)
        except (OSError, ValueError) as e:
            print(f"[prof] unreadable summary: {e}", file=sys.stderr)
            return 2
        probs = deviceprof.validate_summary(summary)
        if probs:
            for p in probs:
                print(f"[prof] INVALID: {p}", file=sys.stderr)
            print(f"[prof] refusing to prune {args.capture_dir}",
                  file=sys.stderr)
            return 2
    freed = 0
    if not args.keep_raw:
        freed = deviceprof.prune_raw_traces(args.capture_dir)
    print(f"archived {args.capture_dir}: "
          f"{_fmt_s(summary.get('total_device_s'))} device, "
          f"{100.0 * (summary.get('fraction_attributed') or 0):.1f}% "
          f"attributed, {freed / 1e6:.1f} MB raw pruned")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="device-profile attribution / roofline / drift gate")
    sub = ap.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("attribute", help="parse a capture dir into "
                                         "prof_summary.json")
    a.add_argument("capture_dir")
    a.add_argument("--ledger", default="",
                   help="run ledger (.jsonl or its dir): contributes "
                        "span paths and receives the device_time record")
    a.add_argument("--span", action="append",
                   help="extra span path to attribute against "
                        "(repeatable)")
    a.add_argument("--module-map", default="",
                   help="hlo_module=span/path overrides, comma-sep")
    a.add_argument("--json", action="store_true",
                   help="print the compact summary as JSON")
    a.set_defaults(fn=cmd_attribute)

    s = sub.add_parser("show", help="render an existing summary")
    s.add_argument("path", help="capture dir or prof_summary.json")
    s.set_defaults(fn=cmd_show)

    k = sub.add_parser("check", help="schema-validate a summary "
                                     "(exit 2 when malformed)")
    k.add_argument("path")
    k.set_defaults(fn=cmd_check)

    d = sub.add_parser("diff", help="drift gate: 0 clean / 1 improved "
                                    "/ 2 regressed")
    d.add_argument("a", help="capture dir, prof_summary.json, or "
                             "bench JSON with embedded summaries")
    d.add_argument("b")
    d.add_argument("--tol-pct", type=float, default=DEFAULT_TOL_PCT)
    d.add_argument("--abs-floor", type=float, default=DEFAULT_ABS_FLOOR_S,
                   help="seconds; drift needs BOTH bands exceeded")
    d.add_argument("--comm-tol-pct", type=float, default=None,
                   metavar="PCT",
                   help="arm the dedicated comm gate: regress "
                        "when op_class/comm_s alone grows more than "
                        "PCT%% (and the abs floor) — tighter than the "
                        "general band, because overlapped pipelines "
                        "are supposed to keep comm flat; advisory "
                        "(printed, not enforced) on CPU captures")
    d.set_defaults(fn=cmd_diff)

    r = sub.add_parser("archive", help="attribute + validate, then "
                                       "prune raw traces (exit 2 and "
                                       "keep raw when malformed)")
    r.add_argument("capture_dir")
    r.add_argument("--ledger", default="")
    r.add_argument("--keep-raw", action="store_true")
    r.set_defaults(fn=cmd_archive)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
