"""Tuning-DB schema v1: versioned, provenance-stamped measured winners
(port of ``ibamr_tpu/tune/db.py``).

One DB document::

    {"schema": 1,
     "entries": [
       {"engine": "pallas_packed",
        "n": [256, 256, 256],              # match fields (the resolver's
        "markers_min": 49928,              #  vocabulary, models/
        "markers_max": 199712,             #  engine_resolver.py)
        "platform": "cuda",
        "spectral_dtype": "f32",
        "measured": {"steps_per_s": ..., "runner_up": ...,
                     "runner_up_steps_per_s": ..., "margin": ...,
                     "chunk_length": 1},
        "provenance": {"platform": "cuda",     # the resolver skips an
                       "device_kind": "...",   # entry of another platform
                       "torch_version": "...", "git_rev": "...",
                       "timestamp": "YYYY-MM-DD"}}]}

:func:`validate_db` checks the schema version, the engine vocabulary,
the match-field types and the shadowed-entry lint: an entry no query can
reach (every query it matches is won by a more specific or earlier entry)
is dead data and fails. Writes are atomic (tmp + ``os.replace``). The
provenance ``timestamp`` is supplied by the caller: this module reads no
clock, so a publication is reproducible from its inputs.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

from ibamr_tpu_torch.models.engine_resolver import (DB_SCHEMA, MATCH_FIELDS,
                                                    RESOLVED_ENGINES,
                                                    entry_specificity,
                                                    normalize_spectral_dtype)

_DOC = ("Measured-search tuning DB of the PyTorch/CUDA port "
        "(ibamr_tpu_torch/tune/): per-configuration transfer-engine "
        "winners consulted by ibamr_tpu_torch/models/engine_resolver.py "
        "(most-specific match wins; entries whose provenance.platform "
        "differs from the running device's are skipped). Validated by "
        "python -m ibamr_tpu_torch.tools.tune check.")


def new_db() -> dict:
    return {"schema": DB_SCHEMA, "_doc": _DOC, "entries": []}


def load_db(path: str) -> dict:
    """The whole DB document; raises on unreadable input. A schema-less
    document is read as schema 1."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"tuning DB {path}: expected a JSON object")
    doc.setdefault("schema", DB_SCHEMA)
    doc.setdefault("entries", [])
    return doc


def save_db(doc: dict, path: str) -> None:
    """Atomic write (tmp + ``os.replace``): a torn publication never
    leaves a half-written DB for the resolver."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def make_provenance(platform: str, timestamp: str, *,
                    device_kind: Optional[str] = None,
                    torch_version: Optional[str] = None,
                    git_rev: Optional[str] = None,
                    fingerprint: Optional[dict] = None,
                    source: Optional[str] = None) -> dict:
    """Provenance block. ``platform`` is mandatory: an entry without one
    would steer every device. ``timestamp`` is an ISO date."""
    if not platform:
        raise ValueError("provenance requires a platform")
    prov = {"platform": str(platform).lower(), "timestamp": timestamp}
    if device_kind:
        prov["device_kind"] = device_kind
    if torch_version:
        prov["torch_version"] = torch_version
    if git_rev:
        prov["git_rev"] = git_rev
    if fingerprint:
        from ibamr_tpu_torch.utils.flight_recorder import canonicalize
        prov["fingerprint"] = canonicalize(fingerprint)
    if source:
        prov["source"] = source
    return prov


def make_entry(engine: str, *, n: Optional[Sequence[int]] = None,
               n_cells: Optional[int] = None,
               markers_min: Optional[int] = None,
               markers_max: Optional[int] = None,
               spectral_dtype: Optional[str] = None,
               platform: Optional[str] = None,
               chunk_length: Optional[int] = None,
               measured: Optional[dict] = None,
               provenance: Optional[dict] = None) -> dict:
    entry: dict = {"engine": engine}
    if n is not None:
        entry["n"] = [int(v) for v in n]
    if n_cells is not None:
        entry["n_cells"] = int(n_cells)
    if markers_min is not None:
        entry["markers_min"] = int(markers_min)
    if markers_max is not None:
        entry["markers_max"] = int(markers_max)
    if spectral_dtype is not None:
        entry["spectral_dtype"] = normalize_spectral_dtype(spectral_dtype)
    if platform is not None:
        entry["platform"] = str(platform).lower()
    if chunk_length is not None:
        entry["chunk_length"] = int(chunk_length)
    if measured is not None:
        entry["measured"] = dict(measured)
    if provenance is not None:
        entry["provenance"] = dict(provenance)
    return entry


def _match_key(entry: dict) -> tuple:
    """The identity a publication replaces: the match fields plus the
    provenance platform (winners of two platforms for one key coexist)."""
    prov = entry.get("provenance") or {}
    key = [(f, json.dumps(entry.get(f))) for f in MATCH_FIELDS]
    key.append(("provenance.platform", prov.get("platform")))
    return tuple(key)


def merge_entry(doc: dict, entry: dict) -> dict:
    """Insert ``entry``, replacing an entry of the same match identity
    (a re-publication updates in place instead of shadowing)."""
    entries = doc.setdefault("entries", [])
    key = _match_key(entry)
    for i, old in enumerate(entries):
        if isinstance(old, dict) and _match_key(old) == key:
            entries[i] = entry
            return doc
    entries.append(entry)
    return doc


def _effective(entry: dict) -> dict:
    """Match constraints with the provenance platform folded in: for the
    shadow analysis the provenance skip acts as a platform pin."""
    eff = {f: entry.get(f) for f in MATCH_FIELDS}
    prov_plat = (entry.get("provenance") or {}).get("platform")
    if eff["platform"] is None and prov_plat is not None:
        eff["platform"] = prov_plat
    return eff


def _implies(b: dict, a: dict) -> bool:
    """True when every query matching constraints ``b`` also matches
    ``a``."""
    for f in ("n", "spectral_dtype", "platform", "chunk_length"):
        if a[f] is not None and json.dumps(a[f]) != json.dumps(b[f]):
            return False
    if a["n_cells"] is not None:
        cubic = (b["n"] is not None
                 and all(int(v) == int(a["n_cells"]) for v in b["n"]))
        if b["n_cells"] != a["n_cells"] and not cubic:
            return False
    if a["markers_min"] is not None:
        if b["markers_min"] is None \
                or int(b["markers_min"]) < int(a["markers_min"]):
            return False
    if a["markers_max"] is not None:
        if b["markers_max"] is None \
                or int(b["markers_max"]) > int(a["markers_max"]):
            return False
    return True


def shadowed_entries(entries: list) -> list:
    """Indices of fully shadowed entries ``[(j, i, reason), ...]``: entry
    j is dead when some entry i matches every query j matches and wins
    the most-specific / file-order tie-break on all of them."""
    out = []
    effs = [_effective(e) if isinstance(e, dict) else None
            for e in entries]
    scores = [entry_specificity(e) if isinstance(e, dict) else -1
              for e in entries]
    for j, ej in enumerate(entries):
        if effs[j] is None:
            continue
        for i, ei in enumerate(entries):
            if i == j or effs[i] is None:
                continue
            if not _implies(effs[j], effs[i]):
                continue
            if scores[i] > scores[j] or (scores[i] == scores[j]
                                         and i < j):
                out.append((
                    j, i,
                    f"entry[{j}] ({ej.get('engine')}) is fully "
                    f"shadowed by entry[{i}] ({ei.get('engine')}): "
                    f"every query it matches is won by entry[{i}] "
                    f"(specificity {scores[i]} vs {scores[j]}"
                    + (", earlier in file" if scores[i] == scores[j]
                       else "") + ")"))
                break
    return out


def validate_db(doc: dict) -> list:
    """Problem strings (empty = valid): schema version, entry shape,
    engine vocabulary, match-field types, marker-band sanity and the
    shadowed-entry lint."""
    problems = []
    if doc.get("schema") != DB_SCHEMA:
        problems.append(f"schema: expected {DB_SCHEMA}, "
                        f"got {doc.get('schema')!r}")
    entries = doc.get("entries")
    if not isinstance(entries, list):
        problems.append("entries: expected a list")
        return problems
    for i, e in enumerate(entries):
        where = f"entries[{i}]"
        if not isinstance(e, dict):
            problems.append(f"{where}: expected an object")
            continue
        eng = e.get("engine")
        if eng not in RESOLVED_ENGINES:
            problems.append(
                f"{where}.engine: {eng!r} not in RESOLVED_ENGINES")
        for f in ("n_cells", "markers_min", "markers_max",
                  "chunk_length"):
            if e.get(f) is not None and not isinstance(e[f], int):
                problems.append(f"{where}.{f}: expected an integer, "
                                f"got {e[f]!r}")
        if e.get("n") is not None and (
                not isinstance(e["n"], list)
                or not all(isinstance(v, int) for v in e["n"])):
            problems.append(f"{where}.n: expected a list of integers")
        if (isinstance(e.get("markers_min"), int)
                and isinstance(e.get("markers_max"), int)
                and e["markers_min"] > e["markers_max"]):
            problems.append(f"{where}: empty marker band "
                            f"[{e['markers_min']}, {e['markers_max']}]")
        m = e.get("measured")
        if m is not None:
            if not isinstance(m, dict):
                problems.append(f"{where}.measured: expected an object")
            elif not isinstance(m.get("steps_per_s"), (int, float)):
                problems.append(
                    f"{where}.measured.steps_per_s: expected a number")
        prov = e.get("provenance")
        if prov is not None and (not isinstance(prov, dict)
                                 or not prov.get("platform")):
            problems.append(
                f"{where}.provenance: expected an object with a "
                f"'platform' field")
    for _, _, reason in shadowed_entries(entries):
        problems.append(f"shadow lint: {reason}")
    return problems
