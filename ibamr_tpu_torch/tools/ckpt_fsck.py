"""Offline checkpoint auditor for BOTH on-disk formats (port of
``tools/ckpt_fsck.py``): the single-host ``restore.<step>.npz`` +
sidecar layout and the sharded ``sharded.<step>/shard-*.npz`` +
manifest layout, which the two packages share.

The run-time verifiers (``verify_checkpoint`` /
``verify_sharded_checkpoint``) answer "can I restore THIS step right
now"; this tool answers "what is the state of this whole run
directory", without loading a model or touching a device:

- walks a run directory recursively and finds every checkpoint step of
  either format;
- re-verifies every digest from the bytes on disk (whole-file CRC32 and
  size per array or shard file) and every per-leaf CRC32 against the
  sidecar or manifest, so damage is attributed to the leaf;
- reports per step: ``verified``, ``torn`` (no or a torn commit
  marker), ``corrupt`` (marker present, digest mismatch or missing
  shard), ``partial`` (a lane-stacked fleet checkpoint whose damage is
  confined to some lanes' slices, which ``restore_lane`` can still
  serve), and whether the step is ``prunable``;
- ``--repair`` QUARANTINES corrupt and torn steps (renamed into
  ``<dir>/quarantine/``, never deleted); the newest verified step is
  never touched, and a directory whose every step is damaged keeps its
  last candidate;
- exits ``0`` on a clean tree, ``1`` on corruption, ``2`` on usage
  errors; ``--json`` prints the report as one JSON object.

Usage::

    python -m ibamr_tpu_torch.tools.ckpt_fsck RUN_DIR [--repair] [--json] [-q]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ibamr_tpu_torch.utils import checkpoint as ckpt
from ibamr_tpu_torch.utils import checkpoint_sharded as cksh

QUARANTINE_DIR = "quarantine"


# ---------------------------------------------------------------------------
# per-step audits
# ---------------------------------------------------------------------------

def _leaf_crcs_of_npz(path: str) -> dict:
    with np.load(path) as z:
        return {k: ckpt._leaf_crc(z[k]) for k in z.files}


def _lane_audit(fname: str, integ: dict):
    """Per-lane re-verification of a DAMAGED lane-stacked step.

    The fleet sidecar records one CRC32 per lane slice of every
    lane-stacked leaf (``integrity.lanes.leaves``). When the whole-file
    or whole-leaf digests fail, those per-lane digests tell the
    operator WHICH lanes' slices are still intact — the difference
    between a dead checkpoint and one ``restore_lane`` can still serve
    for B-1 lanes. Returns ``{count, lanes_ok, lanes_bad}``, or
    ``None`` when the damage is not lane-attributable (no lane record,
    unparseable file, missing/reshaped leaf)."""
    lanes = integ.get("lanes") or {}
    count = int(lanes.get("count", 0))
    lane_leaves = lanes.get("leaves") or {}
    if count < 1 or not lane_leaves:
        return None
    bad: set = set()
    try:
        with np.load(fname) as z:
            for key, crcs in lane_leaves.items():
                if key not in z.files:
                    return None          # structural, not lane-local
                arr = z[key]
                if (arr.ndim < 1 or arr.shape[0] != count
                        or len(crcs) != count):
                    return None
                for i in range(count):
                    if ckpt._leaf_crc(arr[i]) != int(crcs[i]):
                        bad.add(i)
    except Exception:
        return None
    return {"count": count,
            "lanes_ok": [i for i in range(count) if i not in bad],
            "lanes_bad": sorted(bad)}


def audit_single_step(directory: str, step: int) -> dict:
    """One ``restore.<step>`` checkpoint, re-verified from bytes."""
    rec = {"format": "single", "step": step, "status": "verified",
           "problems": []}
    fname = os.path.join(directory, f"restore.{step:08d}.npz")
    meta = ckpt._read_sidecar(directory, step)
    if meta is None:
        rec["status"] = "torn"
        rec["problems"].append("sidecar missing or torn (uncommitted)")
        return rec
    integ = meta.get("integrity")
    if integ is None:
        rec["status"] = "legacy"
        rec["problems"].append("pre-integrity sidecar (trusted as-is)")
        return rec
    try:
        if os.path.getsize(fname) != integ.get("npz_size"):
            rec["problems"].append("array file size mismatch")
        elif ckpt._file_crc(fname) != integ.get("npz_crc32"):
            rec["problems"].append("array file CRC32 mismatch")
    except OSError as e:
        rec["problems"].append(f"array file unreadable: {e}")
    if not rec["problems"]:
        # whole-file digest held: attribute any in-file damage per leaf
        try:
            found = _leaf_crcs_of_npz(fname)
        except Exception as e:
            rec["problems"].append(f"array file unparseable: {e}")
        else:
            recorded = {k: int(v)
                        for k, v in (integ.get("leaves") or {}).items()}
            for k, v in recorded.items():
                if k not in found:
                    rec["problems"].append(f"leaf {k!r} missing")
                elif found[k] != v:
                    rec["problems"].append(f"leaf {k!r} CRC32 mismatch")
    if rec["problems"]:
        rec["status"] = "corrupt"
        lanes = _lane_audit(fname, integ)
        if lanes is not None and lanes["lanes_bad"] \
                and lanes["lanes_ok"]:
            # damage confined to some lanes' slices of a fleet
            # checkpoint: the step is PARTIALLY restorable, and saying
            # only "corrupt" would hide the B-1 recoverable lanes
            rec["status"] = "partial"
            rec["lanes"] = lanes
            rec["problems"].append(
                f"lane slices {lanes['lanes_bad']} corrupt; lanes "
                f"{lanes['lanes_ok']} verify per-lane "
                f"(restore_lane-servable)")
    return rec


def audit_sharded_step(directory: str, step: int) -> dict:
    """One ``sharded.<step>`` checkpoint, re-verified from bytes down
    to every manifest-recorded chunk CRC."""
    rec = {"format": "sharded", "step": step, "status": "verified",
           "problems": []}
    sdir = cksh._step_dir(directory, step)
    manifest = cksh.read_manifest(directory, step)
    if manifest is None or manifest.get("step") != step:
        rec["status"] = "torn"
        rec["problems"].append("manifest missing or torn (uncommitted)")
        return rec
    shard_leaf_crcs: dict = {}
    for name, srec in (manifest.get("shards") or {}).items():
        path = os.path.join(sdir, name)
        try:
            if os.path.getsize(path) != srec.get("size"):
                rec["problems"].append(f"{name}: size mismatch "
                                       f"(stale or truncated shard)")
                continue
            if ckpt._file_crc(path) != srec.get("crc32"):
                rec["problems"].append(f"{name}: file CRC32 mismatch")
                continue
            shard_leaf_crcs[name] = _leaf_crcs_of_npz(path)
        except OSError:
            rec["problems"].append(f"{name}: missing or unreadable")
        except Exception as e:
            rec["problems"].append(f"{name}: unparseable: {e}")
    if not rec["problems"]:
        for key, meta in (manifest.get("leaves") or {}).items():
            for ch in meta.get("chunks", []):
                name = cksh._shard_name(int(ch["shard"]))
                crcs = shard_leaf_crcs.get(name, {})
                if key not in crcs:
                    rec["problems"].append(
                        f"{name}: leaf {key!r} missing")
                elif crcs[key] != int(ch["crc32"]):
                    rec["problems"].append(
                        f"{name}: leaf {key!r} chunk CRC32 mismatch")
    if rec["problems"]:
        rec["status"] = "corrupt"
    return rec


# ---------------------------------------------------------------------------
# directory walk
# ---------------------------------------------------------------------------

def _checkpoint_dirs(root: str):
    """Directories under ``root`` holding checkpoints of either format
    (including ``root`` itself); quarantine subtrees are skipped."""
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in sorted(dirnames)
                       if d != QUARANTINE_DIR]
        has_single = any(f.startswith("restore.") and f.endswith(".npz")
                         for f in filenames)
        has_sharded = bool(cksh._all_sharded_steps(dirpath))
        if has_single or has_sharded:
            yield dirpath


def audit_dir(directory: str) -> dict:
    """Audit one checkpoint directory: every step of both formats."""
    steps = []
    for s in ckpt._all_steps(directory):
        steps.append(audit_single_step(directory, s))
    for s in cksh._all_sharded_steps(directory):
        steps.append(audit_sharded_step(directory, s))
    steps.sort(key=lambda r: (r["step"], r["format"]))
    newest_verified = max(
        (r["step"] for r in steps if r["status"] in ("verified",
                                                     "legacy")),
        default=None)
    for r in steps:
        r["prunable"] = (newest_verified is not None
                         and r["step"] < newest_verified)
    return {"directory": directory, "steps": steps,
            "newest_verified": newest_verified,
            "counts": _counts(steps)}


def _counts(steps) -> dict:
    c = {"verified": 0, "legacy": 0, "torn": 0, "corrupt": 0,
         "partial": 0, "prunable": 0}
    for r in steps:
        c[r["status"]] += 1
        if r.get("prunable"):
            c["prunable"] += 1
    return c


def audit(root: str) -> dict:
    """Audit a whole run tree. ``clean`` is False iff any torn,
    corrupt, or partial step exists anywhere under ``root`` (a partial
    step is damage too — just lane-attributed damage)."""
    dirs = [audit_dir(d) for d in _checkpoint_dirs(root)]
    total = _counts([r for d in dirs for r in d["steps"]])
    return {"root": os.path.abspath(root), "dirs": dirs,
            "run_id": _ledger_run_id(root),
            "counts": total,
            "clean": (total["torn"] == 0 and total["corrupt"] == 0
                      and total["partial"] == 0)}


def _ledger_run_id(root: str):
    """The ``run_id`` of the run that wrote this tree, read from its
    ``ledger.jsonl``, so an fsck report, the ledger, and the
    incident capsules of one run cross-reference by the same id.
    ``None`` when the run predates the ledger."""
    path = os.path.join(root, "ledger.jsonl")
    try:
        from ibamr_tpu_torch.obs import read_ledger
        for rec in read_ledger(path):
            rid = rec.get("run_id")
            if rid:
                return rid
    except Exception:
        pass
    return None


# ---------------------------------------------------------------------------
# repair (quarantine, never delete)
# ---------------------------------------------------------------------------

def _step_paths(directory: str, rec: dict):
    if rec["format"] == "sharded":
        return [cksh._step_dir(directory, rec["step"])]
    base = os.path.join(directory, f"restore.{rec['step']:08d}")
    return [p for p in (base + ".npz", base + ".json")
            if os.path.exists(p)]


def repair_dir(dir_report: dict) -> list:
    """Quarantine every torn/corrupt step of one audited directory.
    Moves (never deletes) into ``<dir>/quarantine/``; refuses to touch
    the newest verified step, and — when NO step verified — leaves the
    newest damaged candidate in place (the run-time fallback may still
    salvage leaves from it; an empty directory salvages nothing).
    ``partial`` steps are NEVER quarantined: their intact lane slices
    are exactly what ``restore_lane`` needs after a lane fault.
    Returns the quarantined step records."""
    directory = dir_report["directory"]
    bad = [r for r in dir_report["steps"]
           if r["status"] in ("torn", "corrupt")]
    if dir_report["newest_verified"] is None and bad:
        spared = max(bad, key=lambda r: r["step"])
        bad = [r for r in bad if r is not spared]
    moved = []
    qdir = os.path.join(directory, QUARANTINE_DIR)
    for r in bad:
        os.makedirs(qdir, exist_ok=True)
        for p in _step_paths(directory, r):
            dst = os.path.join(qdir, os.path.basename(p))
            if os.path.exists(dst):      # re-run after a prior repair
                i = 1
                while os.path.exists(f"{dst}.{i}"):
                    i += 1
                dst = f"{dst}.{i}"
            os.replace(p, dst)
        r["quarantined"] = True
        moved.append(r)
    return moved


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="offline checkpoint auditor: re-verify every CRC "
                    "of both checkpoint formats under a run directory")
    ap.add_argument("root", help="run directory to audit")
    ap.add_argument("--repair", action="store_true",
                    help="quarantine torn/corrupt steps into "
                         "<dir>/quarantine/ (never deletes; never "
                         "touches the newest verified step)")
    ap.add_argument("--json", action="store_true",
                    help="print the full report as JSON")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print nothing but the exit code")
    args = ap.parse_args(argv)

    if not os.path.isdir(args.root):
        ap.error(f"{args.root!r} is not a directory")

    report = audit(args.root)
    if args.repair:
        report["repaired"] = [
            {"directory": d["directory"],
             "quarantined": [{"format": r["format"], "step": r["step"]}
                             for r in repair_dir(d)]}
            for d in report["dirs"]]

    if args.json:
        print(json.dumps(report, indent=1))
    elif not args.quiet:
        for d in report["dirs"]:
            c = d["counts"]
            print(f"{d['directory']}: {c['verified']} verified"
                  + (f", {c['legacy']} legacy" if c["legacy"] else "")
                  + (f", {c['torn']} torn" if c["torn"] else "")
                  + (f", {c['corrupt']} corrupt" if c["corrupt"] else "")
                  + (f", {c['partial']} partial" if c["partial"] else "")
                  + (f", {c['prunable']} prunable"
                     if c["prunable"] else "")
                  + (f" (newest verified: {d['newest_verified']})"
                     if d["newest_verified"] is not None else ""))
            for r in d["steps"]:
                if r["status"] in ("torn", "corrupt", "partial"):
                    tag = " [quarantined]" if r.get("quarantined") else ""
                    print(f"  {r['format']} step {r['step']}: "
                          f"{r['status']}{tag} — "
                          + "; ".join(r["problems"]))
        if not report["dirs"]:
            print(f"{args.root}: no checkpoints found")
    return 0 if report["clean"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
