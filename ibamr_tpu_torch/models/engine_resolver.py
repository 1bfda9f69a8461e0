"""Transfer-engine resolver: the ``auto`` engine to a concrete name (port
of ``ibamr_tpu/models/engine_resolver.py``).

``build_shell_example`` resolves an absent or ``"auto"`` engine here, in
order:

1. ``IBAMR_TRANSFER_ENGINE``: an explicit override, validated against the
   engine vocabulary (``"auto"`` or empty defers).
2. A JSON tuning database: ``IBAMR_TUNING_DB`` when set (``none``,
   ``off`` or ``0`` disable the lookup), else the port's own
   ``ibamr_tpu_torch/TUNING_DB.json`` when it exists. Schema v1
   (``{"schema": 1, "entries": [...]}``; the schema-less
   ``{"entries": [...]}`` form is read too). Entries match on grid shape
   (``n_cells``, ``n``), marker band (``markers_min``, ``markers_max``),
   ``spectral_dtype``, ``platform`` and ``chunk_length``; the most
   specific match wins, earlier in the file at equal specificity. An
   entry whose ``provenance.platform`` differs from the current platform
   is skipped.
3. The built-in rule: ``packed`` for a tile-divisible grid carrying at
   least 4,096 markers, ``scatter`` otherwise.

The platform of the port is its device's type, ``"cuda"`` or ``"cpu"``:
an entry pinned to the JAX package's ``tpu`` or ``gpu`` never steers it.
The result is a resolved name, never ``"auto"``. A bad override or a
malformed database raises.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import torch

ENV_ENGINE = "IBAMR_TRANSFER_ENGINE"
ENV_TUNING_DB = "IBAMR_TUNING_DB"

# IBAMR_TUNING_DB values that disable the lookup (the default file too)
DB_DISABLE_VALUES = ("none", "off", "0")

DEFAULT_DB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "TUNING_DB.json")

DB_SCHEMA = 1

# the resolved-name vocabulary; "auto" is absent: resolution ends here
RESOLVED_ENGINES = (
    "scatter", "mxu", "packed", "pallas", "pallas_packed", "mxu_bf16",
    "packed_bf16", "packed3", "packed3_bf16", "hybrid_packed",
    "hybrid_packed_bf16", "hybrid_bf16")

# an entry's specificity is the weighted count of its pinned fields: an
# exact grid list counts 2, every other field 1
MATCH_FIELDS = ("n_cells", "n", "markers_min", "markers_max",
                "spectral_dtype", "platform", "chunk_length")
_FIELD_WEIGHT = {"n": 2}


def default_rule(n: Sequence[int], n_markers: int, support: int) -> str:
    """``packed`` when the blocked axes are tile-divisible and at least
    tile + support + 1 cells long and there are >= 4,096 markers, else
    ``scatter``."""
    eligible = (
        n_markers >= 4096
        and all(v % 8 == 0 for v in n[:-1])
        and all(v >= 8 + support + 1 for v in n[:-1]))
    return "packed" if eligible else "scatter"


def _validate(name: str, source: str) -> str:
    if name not in RESOLVED_ENGINES:
        raise ValueError(
            f"{source}: unknown transfer engine {name!r}; expected one "
            f"of {RESOLVED_ENGINES}")
    return name


def normalize_spectral_dtype(value) -> str:
    """Canonical spectral-dtype token: ``None`` is the default "f32"."""
    return str(value).strip().lower() if value else "f32"


# parsed databases by path, with the file's mtime
_db_cache: dict = {}


def load_tuning_db(path: str) -> list:
    """The entries of a tuning-database file; raises on an unreadable or
    malformed file or an unknown schema."""
    try:
        mtime = os.path.getmtime(path)
        cached = _db_cache.get(path)
        if cached is not None and cached[0] == mtime:
            return cached[1]
    except OSError:
        mtime = None
    with open(path) as f:
        doc = json.load(f)
    schema = doc.get("schema")
    if schema is not None and schema != DB_SCHEMA:
        raise ValueError(
            f"tuning DB {path}: unknown schema {schema!r} "
            f"(this build reads schema {DB_SCHEMA})")
    entries = doc.get("entries")
    if not isinstance(entries, list):
        raise ValueError(
            f"tuning DB {path}: expected a top-level 'entries' list")
    if mtime is not None:
        _db_cache[path] = (mtime, entries)
    return entries


def entry_specificity(entry: dict) -> int:
    """The weighted count of the entry's pinned match fields."""
    return sum(_FIELD_WEIGHT.get(f, 1) for f in MATCH_FIELDS
               if entry.get(f) is not None)


def entry_matches(entry: dict, n: Sequence[int], n_markers: int,
                  spectral_dtype: Optional[str] = None,
                  platform: Optional[str] = None,
                  chunk_length: Optional[int] = None) -> bool:
    """Does ``entry`` match the query? A pinned field the query does not
    supply (no platform, no chunk length) does not match."""
    if entry.get("n_cells") is not None:
        if not all(int(v) == int(entry["n_cells"]) for v in n):
            return False
    if entry.get("n") is not None:
        if [int(v) for v in entry["n"]] != [int(v) for v in n]:
            return False
    if entry.get("markers_min") is not None \
            and n_markers < int(entry["markers_min"]):
        return False
    if entry.get("markers_max") is not None \
            and n_markers > int(entry["markers_max"]):
        return False
    if entry.get("spectral_dtype") is not None:
        if (normalize_spectral_dtype(entry["spectral_dtype"])
                != normalize_spectral_dtype(spectral_dtype)):
            return False
    if entry.get("platform") is not None:
        if platform is None \
                or str(entry["platform"]).lower() != str(platform).lower():
            return False
    if entry.get("chunk_length") is not None:
        if chunk_length is None \
                or int(entry["chunk_length"]) != int(chunk_length):
            return False
    return True


def provenance_compatible(entry: dict,
                          platform: Optional[str]) -> bool:
    """An entry with a ``provenance.platform`` serves only that platform;
    an unknown current platform matches no such entry."""
    pinned = (entry.get("provenance") or {}).get("platform")
    if pinned is None:
        return True
    return (platform is not None
            and str(pinned).lower() == str(platform).lower())


def current_platform(device="cuda") -> str:
    """The port's platform name for ``device``: its type, "cuda" or
    "cpu"."""
    return torch.device(device).type


def lookup_tuning_db(entries: list, n: Sequence[int], n_markers: int,
                     spectral_dtype: Optional[str] = None,
                     platform: Optional[str] = None,
                     chunk_length: Optional[int] = None
                     ) -> Optional[dict]:
    """The winning entry for a query, or None: the most specific match,
    the earlier one at equal specificity, after skipping the entries
    whose provenance pins another platform."""
    best, best_score = None, -1
    for entry in entries:
        if not isinstance(entry, dict):
            raise ValueError(f"tuning DB entry is not an object: "
                             f"{entry!r}")
        if not provenance_compatible(entry, platform):
            continue
        if not entry_matches(entry, n, n_markers,
                             spectral_dtype=spectral_dtype,
                             platform=platform,
                             chunk_length=chunk_length):
            continue
        score = entry_specificity(entry)
        if score > best_score:      # ties keep the earlier entry
            best, best_score = entry, score
    return best


def resolve_engine(n: Sequence[int], n_markers: int, support: int,
                   env: Optional[dict] = None, *,
                   spectral_dtype: Optional[str] = None,
                   platform: Optional[str] = None,
                   chunk_length: Optional[int] = None) -> str:
    """Resolve ``auto`` to an engine name for a grid of extents ``n``
    carrying ``n_markers`` markers under a delta of half-width
    ``support``: the override, then the tuning database, then
    :func:`default_rule`. ``env`` stands in for ``os.environ``;
    ``platform`` defaults to the GPU's, "cuda"."""
    env = os.environ if env is None else env
    override = str(env.get(ENV_ENGINE, "") or "").strip().lower()
    if override and override != "auto":
        return _validate(override, f"${ENV_ENGINE}")
    db_path = str(env.get(ENV_TUNING_DB, "") or "").strip()
    if db_path.lower() in DB_DISABLE_VALUES:
        return default_rule(n, n_markers, support)
    if not db_path and os.path.exists(DEFAULT_DB_PATH):
        db_path = DEFAULT_DB_PATH
    if db_path:
        entries = load_tuning_db(db_path)
        if platform is None:
            platform = current_platform()
        hit = lookup_tuning_db(
            entries, n, n_markers, spectral_dtype=spectral_dtype,
            platform=platform, chunk_length=chunk_length)
        if hit is not None:
            return _validate(str(hit.get("engine", "")).lower(),
                             f"tuning DB {db_path}")
    return default_rule(n, n_markers, support)
