"""Autotuner command line: the measured engine search and the tuning-DB
lifecycle (port of ``tools/tune.py``).

    python -m ibamr_tpu_torch.tools.tune search [--n 16,256] [--engines ...]
        [--dtypes f32,bf16] [--chunk-lengths 1,4] [--reps 3] [--cpu]
        [--publish] [--db PATH]
    python -m ibamr_tpu_torch.tools.tune show [--db PATH]
    python -m ibamr_tpu_torch.tools.tune publish SEARCH.jsonl [--db PATH]
    python -m ibamr_tpu_torch.tools.tune check [--db PATH] [--cpu]

``search`` walks the engine x spectral_dtype x chunk-length grid for each
grid size on the card (``--cpu``: the host), printing ONE JSON line per
size; ``--publish`` merges each size's winner into the DB (an atomic
write; a re-publication replaces the entry of the same key). ``show``
renders the DB: entries, margins, provenance and the shadowed-entry
lint. ``publish`` merges a captured ``search`` output into the DB. Both
publications refuse, write nothing and exit 2 when a kernel probe pruned
a candidate or a trial failed: the port never degrades, so a broken
engine is a fault to fix, not a loser to rank.
``check`` is the revalidation gate, exit 0 (schema and lint clean, every
re-timed winner still wins), 1 (STALE: a winner's steps/s drifted beyond
``--band``) or 2 (REGRESSED: schema or lint errors, or a re-timed
runner-up beats its winner by more than ``--band``); it re-times only
the entries whose ``provenance.platform`` is the device it runs on
(``cuda``, or ``cpu`` with ``--cpu``).

The default DB is the port's ``ibamr_tpu_torch/TUNING_DB.json``, the
file the resolver reads. An entry's provenance platform is ``cuda`` (or
``cpu``) and its ``device_kind`` the card's name. The command runs with
cuBLAS f32 products without TF32 (``exact_f32_matmul``), as the
reference's at ``Precision.HIGHEST``; the setting is restored after.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from ibamr_tpu_torch.models.engine_resolver import DEFAULT_DB_PATH
from ibamr_tpu_torch.ops.interaction_fast import exact_f32_matmul

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _git_rev() -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10,
                             cwd=PACKAGE).stdout
        return out.strip() or "norev"
    except Exception:
        return "norev"


def _device_kind(platform: str) -> str:
    return torch.cuda.get_device_name(0) if platform == "cuda" else "host"


def _auto_markers(n: int, n_lat: int, n_lon: int):
    """The flagship-matched marker lattice per size (316^2 at >= 256,
    180^2 at >= 128, else 8x16) unless --n-lat/--n-lon pin it."""
    if n_lat and n_lon:
        return n_lat, n_lon
    side = 316 if n >= 256 else (180 if n >= 128 else 0)
    return (side or 8, side or 16)


def _csv(text, cast):
    return tuple(cast(v.strip()) for v in str(text).split(",")
                 if v.strip())


def publish_entries(entries, db_path: str) -> list:
    """Merge entries into the DB at ``db_path`` (created if absent),
    validated before the write: a publication that fails the gate never
    lands. Returns the problems (empty = written)."""
    from ibamr_tpu_torch.tune import db as _db

    doc = _db.load_db(db_path) if os.path.exists(db_path) \
        else _db.new_db()
    for e in entries:
        _db.merge_entry(doc, e)
    problems = _db.validate_db(doc)
    if not problems:
        _db.save_db(doc, db_path)
    return problems


def _report_publish(entries, db_path: str, blockers=()) -> int:
    if blockers:
        for b in blockers:
            print(f"[tune] publish refused: {b}", file=sys.stderr)
        return 2
    problems = publish_entries(entries, db_path)
    if problems:
        for p in problems:
            print(f"[tune] publish refused: {p}", file=sys.stderr)
        return 2
    print(f"[tune] published {len(entries)} entr"
          f"{'y' if len(entries) == 1 else 'ies'} -> {db_path}",
          file=sys.stderr)
    return 0


def cmd_search(args) -> int:
    from ibamr_tpu_torch.tune import runner

    platform = "cpu" if args.cpu else "cuda"   # the device is the platform
    timestamp = args.timestamp or time.strftime("%Y-%m-%d")
    entries, blockers = [], []
    for n in _csv(args.n, int):
        n_lat, n_lon = _auto_markers(n, args.n_lat, args.n_lon)
        res = runner.search(
            n_cells=n, n_lat=n_lat, n_lon=n_lon,
            engines=_csv(args.engines, str),
            spectral_dtypes=_csv(args.dtypes, str),
            chunk_lengths=_csv(args.chunk_lengths, int),
            reps=args.reps, dt=args.dt, probe=not args.no_probe,
            device=platform)
        d = res.to_dict()
        d["platform"] = platform
        print(json.dumps(d, sort_keys=True), flush=True)
        blockers += runner.publish_blockers(d)
        entry = runner.entry_from_search_dict(
            d, platform=platform, timestamp=timestamp,
            device_kind=_device_kind(platform),
            torch_version=torch.__version__, git_rev=_git_rev(),
            source=f"tools/tune.py search @{n}^3")
        if entry is not None:
            entries.append(entry)
    if not args.publish:
        return 0
    if not entries:
        print("[tune] nothing to publish (no trial succeeded)",
              file=sys.stderr)
        return 1
    return _report_publish(entries, args.db, blockers)


def cmd_publish(args) -> int:
    from ibamr_tpu_torch.tune import runner

    with open(args.from_file) as f:
        results = [json.loads(line) for line in f
                   if line.strip().startswith("{")]
    timestamp = args.timestamp or time.strftime("%Y-%m-%d")
    blockers = [b for d in results for b in runner.publish_blockers(d)]
    entries = [e for e in (runner.entry_from_search_dict(
        d, platform=d.get("platform") or "cpu", timestamp=timestamp,
        git_rev=_git_rev(),
        source=f"tools/tune.py publish {os.path.basename(args.from_file)}")
        for d in results) if e is not None]
    if not entries:
        print("[tune] no winners in the search capture", file=sys.stderr)
        return 1
    return _report_publish(entries, args.db, blockers)


def cmd_show(args) -> int:
    from ibamr_tpu_torch.tune import db as _db

    doc = _db.load_db(args.db)
    entries = doc.get("entries") or []
    print(f"tuning DB {args.db}: schema {doc.get('schema')}, "
          f"{len(entries)} entr{'y' if len(entries) == 1 else 'ies'}")
    for i, e in enumerate(entries):
        match = ", ".join(
            f"{f}={e[f]}" for f in
            ("n", "n_cells", "markers_min", "markers_max",
             "spectral_dtype", "platform", "chunk_length")
            if e.get(f) is not None)
        m, prov = e.get("measured") or {}, e.get("provenance") or {}
        margin = (f", margin {m['margin']}x over {m.get('runner_up')}"
                  if m.get("margin") else "")
        print(f"  [{i}] {e.get('engine')}  ({match or 'matches all'})")
        if m:
            print(f"      measured {m.get('steps_per_s')} steps/s{margin}")
        if prov:
            print(f"      provenance: {prov.get('platform')}"
                  f" {prov.get('device_kind') or ''}"
                  f" rev={prov.get('git_rev')}"
                  f" @{prov.get('timestamp')}")
    problems = _db.validate_db(doc)
    for p in problems:
        print(f"  LINT: {p}")
    return 2 if problems else 0


def _retime_entry(entry: dict, band: float, reps: int, retime_fn) -> tuple:
    """(verdict, lines) for one platform-matching entry, 'ok' / 'stale'
    / 'flip': the winner and the runner-up re-timed at the entry's
    recorded configuration."""
    from ibamr_tpu_torch.tune.space import Candidate

    m = entry.get("measured") or {}
    cfg_n = entry.get("n") or [entry.get("n_cells") or 16] * 3
    n_cells = int(cfg_n[0])
    n_lat = int(m.get("n_lat") or 8)
    n_lon = int(m.get("n_lon") or 16)
    sd = entry.get("spectral_dtype") or "f32"
    win = Candidate(engine=entry["engine"], spectral_dtype=sd,
                    chunk_length=int(m.get("chunk_length") or 1))
    ru = Candidate(engine=m["runner_up"], spectral_dtype=sd,
                   chunk_length=int(m.get("runner_up_chunk_length")
                                    or m.get("chunk_length") or 1))
    tw = retime_fn(win, n_cells=n_cells, n_lat=n_lat, n_lon=n_lon,
                   reps=reps)
    tr = retime_fn(ru, n_cells=n_cells, n_lat=n_lat, n_lon=n_lon,
                   reps=reps)
    lines = []
    if tw.error or tr.error:
        lines.append(f"{win.label()} vs {ru.label()}: re-time failed "
                     f"({tw.error or tr.error})")
        return "flip", lines
    lines.append(f"{entry['engine']} {tw.steps_per_s:.3f} steps/s vs "
                 f"runner-up {m['runner_up']} {tr.steps_per_s:.3f} "
                 f"(recorded {m.get('steps_per_s')})")
    if tr.steps_per_s > tw.steps_per_s * (1.0 + band):
        lines.append(
            f"RANKING FLIP: {m['runner_up']} beats {entry['engine']} "
            f"by {tr.steps_per_s / max(tw.steps_per_s, 1e-12):.2f}x "
            f"(> 1 + band {band})")
        return "flip", lines
    rec = float(m.get("steps_per_s") or 0.0)
    if rec > 0 and abs(tw.steps_per_s - rec) > band * rec:
        lines.append(
            f"stale: winner drifted {tw.steps_per_s / rec:.2f}x vs "
            f"recorded (band {band}); re-run search --publish")
        return "stale", lines
    return "ok", lines


def check_db(doc: dict, *, platform: str, band: float = 0.15,
             reps: int = 2, retime_fn=None) -> tuple:
    """(exit_code, report_lines): the gate's body, apart from the command
    so that tests can drive it with a synthetic ``retime_fn``."""
    from ibamr_tpu_torch.tune import db as _db

    problems = _db.validate_db(doc)
    lines = [f"schema/lint: {p}" for p in problems]
    if problems:
        return 2, lines
    if retime_fn is None:
        from ibamr_tpu_torch.tune.runner import run_trial

        def retime_fn(cand, **kw):
            return run_trial(cand, device=platform, **kw)
    rc = 0
    retimed = 0
    for entry in doc.get("entries") or []:
        prov = entry.get("provenance") or {}
        if str(prov.get("platform", "")).lower() != platform:
            lines.append(
                f"{entry.get('engine')}: provenance platform "
                f"{prov.get('platform')!r} != {platform!r}: not "
                f"re-timed here (schema/lint only)")
            continue
        if not (entry.get("measured") or {}).get("runner_up"):
            lines.append(f"{entry.get('engine')}: no recorded "
                         f"runner-up, nothing to re-race")
            continue
        verdict, vlines = _retime_entry(entry, band, reps, retime_fn)
        retimed += 1
        lines.extend(vlines)
        rc = max(rc, {"ok": 0, "stale": 1, "flip": 2}[verdict])
    lines.append(f"re-timed {retimed} entr"
                 f"{'y' if retimed == 1 else 'ies'} on {platform}")
    return rc, lines


def cmd_check(args) -> int:
    from ibamr_tpu_torch.tune import db as _db

    try:
        doc = _db.load_db(args.db)
    except FileNotFoundError:
        print(f"[tune] no DB at {args.db}: nothing to check")
        return 0
    except ValueError as e:
        print(f"[tune] {e}")
        return 2
    platform = "cpu" if args.cpu else "cuda"   # the device is the platform
    rc, lines = check_db(doc, platform=platform, band=args.band,
                         reps=args.reps)
    if args.as_json:
        print(json.dumps({"exit": rc, "db": args.db, "platform": platform,
                          "report": lines}, indent=1, sort_keys=True))
        return rc
    for ln in lines:
        print(f"[tune] {ln}")
    verdict = {0: "clean: the DB's winners hold",
               1: "STALE: re-run search --publish to refresh",
               2: "REGRESSED: a winner flipped (or the DB is malformed); "
                  "the resolver is being steered wrong"}[rc]
    print(f"[tune] {verdict}")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="measured-search engine autotuner: search/show/"
                    "publish/check the tuning DB")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("search", help="measure the engine grid; one JSON "
                                      "line per size")
    s.add_argument("--n", type=str, default="16",
                   help="comma-separated grid sizes (cells/axis)")
    s.add_argument("--n-lat", type=int, default=0,
                   help="marker rings (0 = flagship-matched auto)")
    s.add_argument("--n-lon", type=int, default=0)
    s.add_argument("--engines", type=str,
                   default="scatter,packed,packed_bf16,pallas_packed")
    s.add_argument("--dtypes", type=str, default="f32,bf16",
                   help="spectral dtypes to search")
    s.add_argument("--chunk-lengths", type=str, default="1,4")
    s.add_argument("--reps", type=int, default=3)
    s.add_argument("--dt", type=float, default=5e-5)
    s.add_argument("--no-probe", action="store_true",
                   help="skip the kernel engines' probes")
    s.add_argument("--cpu", action="store_true",
                   help="run on the host instead of the card")
    s.add_argument("--publish", action="store_true",
                   help="merge each size's winner into --db")
    s.add_argument("--db", type=str, default=DEFAULT_DB_PATH)
    s.add_argument("--timestamp", type=str, default="",
                   help="provenance timestamp (default: today)")
    s.set_defaults(fn=cmd_search)

    p = sub.add_parser("publish", help="merge a captured search output "
                                       "into the DB")
    p.add_argument("from_file", type=str)
    p.add_argument("--db", type=str, default=DEFAULT_DB_PATH)
    p.add_argument("--timestamp", type=str, default="")
    p.set_defaults(fn=cmd_publish)

    w = sub.add_parser("show", help="render the DB and its shadow lint")
    w.add_argument("--db", type=str, default=DEFAULT_DB_PATH)
    w.set_defaults(fn=cmd_show)

    c = sub.add_parser("check", help="revalidation gate: schema, lint and "
                                     "winner-vs-runner-up re-race (exit "
                                     "0/1/2)")
    c.add_argument("--db", type=str, default=DEFAULT_DB_PATH)
    c.add_argument("--band", type=float, default=0.15,
                   help="tolerated ratio drift before a flip/staleness "
                        "verdict")
    c.add_argument("--reps", type=int, default=2)
    c.add_argument("--cpu", action="store_true",
                   help="re-time the cpu entries on the host")
    c.add_argument("--json", action="store_true", dest="as_json")
    c.set_defaults(fn=cmd_check)

    args = ap.parse_args(argv)
    with exact_f32_matmul():
        return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
