"""Merge per-process ledger shards into one fleet view.

A pod run writes one ledger PER PROCESS — each host opens
``RunLedger(dir, proc=<process rank>)`` and appends to its own
``ledger-<proc>.jsonl`` shard (:func:`ibamr_tpu_torch.obs.bus.shard_path`),
because O_APPEND atomicity is a per-file, per-host guarantee and a
shared file over NFS is exactly the torn-interleaved-bytes failure the
bus was designed to rule out. The ``run_id`` — a digest of the flight
recorder fingerprint, identical on every host of the same run — is the
cross-shard join key.

This module is the read side: collect the shards of a directory, check
they belong to one run, and interleave them into a single record
stream a fleet summary can walk. Merge order is ``(seq, proc)`` — seq
is each process's own monotonic counter and proc breaks ties — NOT
wall-clock ``t``, so the merge is deterministic under host clock skew
(the per-record ``t`` stays available for staleness display). Each
shard is read with the bus's torn-tail-tolerant :func:`read_ledger`,
so a SIGKILL mid-write on one host costs at most that host's final
line, never the merge.

Counters are cumulative PER PROCESS (last-snapshot-wins within one
shard), so a fleet rollup must never sum the same proc's snapshots
across time or fold two procs into one key. :func:`fleet_counters`
takes the LAST ``counters`` record of each proc and namespaces every
metric key with a ``proc="<p>"`` label (the exporter's label-splice),
which makes the merged registry safe to export: per-proc series stay
distinct, and cross-proc totals are an explicit reader-side sum.

Host-side, stdlib-only, offline — usable on a machine that never ran
the job.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

from ibamr_tpu_torch.obs.bus import read_ledger

__all__ = ["find_shards", "merge_ledgers", "fleet_counters",
           "fleet_prometheus_text"]

_SHARD_RE = re.compile(r"^ledger-([A-Za-z0-9_.-]+)\.jsonl$")


def find_shards(path: str) -> Dict[str, str]:
    """``{proc: shard_path}`` for one run directory.

    ``ledger-<proc>.jsonl`` files are the shards; a bare
    ``ledger.jsonl`` (a single-process run, proc never set) is
    accepted as proc ``"0"`` when no shard already claims that name —
    so every tool that grew ``--fleet`` still reads yesterday's solo
    layout. A file path is treated as a single shard (proc parsed
    from its name when it matches, else ``"0"``)."""
    if os.path.isfile(path):
        m = _SHARD_RE.match(os.path.basename(path))
        return {m.group(1) if m else "0": path}
    shards: Dict[str, str] = {}
    try:
        names = sorted(os.listdir(path))
    except OSError:
        return {}
    for name in names:
        m = _SHARD_RE.match(name)
        if m:
            shards[m.group(1)] = os.path.join(path, name)
    solo = os.path.join(path, "ledger.jsonl")
    if os.path.exists(solo) and "0" not in shards:
        shards["0"] = solo
    return shards


def merge_ledgers(path_or_shards,
                  allow_mixed_run_ids: bool = False) -> dict:
    """Interleave the ledger shards of one run.

    ``path_or_shards`` is a run directory / shard file (routed through
    :func:`find_shards`) or an explicit ``{proc: path}`` map. Returns::

        {"run_id": ...,            # the common run identity (or None)
         "procs": [...],           # sorted proc ids with >= 1 record
         "records": [...],         # all records, sorted (seq, proc),
                                   #   each stamped with its "proc"
         "per_proc": {proc: {"path", "records", "last_seq", "last_t",
                             "run_id"}}}

    Shards whose ``run_id`` disagrees raise ``ValueError`` — merging
    two different runs silently is how a fleet dashboard lies —
    unless ``allow_mixed_run_ids`` (then ``run_id`` is the first
    shard's and the per-proc table shows each shard's own). Records
    from a shard written without ``proc=`` (yesterday's solo writer)
    are stamped with the proc inferred from the filename, so
    downstream grouping never needs a fallback path."""
    shards = (dict(path_or_shards) if isinstance(path_or_shards, dict)
              else find_shards(path_or_shards))
    records: List[dict] = []
    per_proc: Dict[str, dict] = {}
    run_id: Optional[str] = None
    for proc in sorted(shards):
        recs = read_ledger(shards[proc])
        proc_run: Optional[str] = None
        for r in recs:
            if "proc" not in r:
                r = dict(r, proc=proc)
            records.append(r)
            if proc_run is None and r.get("run_id"):
                proc_run = str(r["run_id"])
        per_proc[proc] = {
            "path": shards[proc],
            "records": len(recs),
            "last_seq": max((r["seq"] for r in recs), default=None),
            "last_t": max((r["t"] for r in recs
                           if isinstance(r.get("t"), (int, float))),
                          default=None),
            "run_id": proc_run,
        }
        if proc_run is not None:
            if run_id is None:
                run_id = proc_run
            elif proc_run != run_id and not allow_mixed_run_ids:
                raise ValueError(
                    f"ledger shards disagree on run_id: proc {proc!r} "
                    f"has {proc_run}, earlier shards have {run_id} — "
                    f"not one run (pass allow_mixed_run_ids=True to "
                    f"merge anyway)")
    records.sort(key=lambda r: (r["seq"], str(r.get("proc", ""))))
    return {"run_id": run_id,
            "procs": [p for p in sorted(per_proc)
                      if per_proc[p]["records"]],
            "records": records,
            "per_proc": per_proc}


def fleet_counters(merged: dict) -> dict:
    """The merged metric registry: each proc's LAST ``counters``
    record, every key namespaced with a ``proc="<p>"`` label.

    Returns ``{"counters": {...}, "gauges": {...}, "histograms":
    {...}}`` in exactly the shapes :func:`~ibamr_tpu_torch.obs.export.
    prometheus_text` accepts. Cumulative counters stay per-proc series
    — nothing here sums across processes, so a proc that restarted (and
    reset its counters) cannot silently deflate another's totals."""
    from ibamr_tpu_torch.obs.export import _splice_label

    last: Dict[str, dict] = {}
    for r in merged.get("records") or []:
        if r.get("kind") == "counters":
            last[str(r.get("proc", ""))] = r   # (seq, proc) order: last wins
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for proc in sorted(last):
        rec = last[proc]
        label = f'proc="{proc}"'
        for kind in ("counters", "gauges", "histograms"):
            for key, value in (rec.get(kind) or {}).items():
                out[kind][_splice_label(key, label)] = value
    return out


def fleet_prometheus_text(merged: dict) -> str:
    """Prometheus text for a merged fleet ledger (proc-labeled)."""
    from ibamr_tpu_torch.obs.export import prometheus_text

    snap = fleet_counters(merged)
    return prometheus_text(counters=snap["counters"],
                           gauges=snap["gauges"],
                           histograms=snap["histograms"])
