"""Prometheus text-exposition snapshot exporter.

A serving front end needs a ``/metrics`` endpoint;
everything before it needs the same serialization for artifacts:
:func:`prometheus_text` renders the live registry (or ``counters`` /
``gauges`` / ``histograms`` dicts lifted from a ledger record) in the
Prometheus text format — ``# HELP``/``# TYPE`` headers, sanitized
metric names, escaped label values, and the full cumulative
``_bucket{le=...}`` / ``_sum`` / ``_count`` series per histogram —
and :func:`write_prometheus` lands it atomically so a scraper never
reads a torn file.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

from ibamr_tpu_torch.obs.bus import HISTOGRAM_BOUNDS, help_for, iter_metrics


def _base_name(key: str) -> str:
    return key.split("{", 1)[0]


def _splice_label(key: str, label: str) -> str:
    """Insert one pre-rendered ``name="value"`` pair into a rendered
    metric key, preserving any labels the key already carries."""
    if "{" in key:
        base, rest = key.split("{", 1)
        return f"{base}{{{label},{rest}"
    return f"{key}{{{label}}}"


def _fmt_value(value: float) -> str:
    v = float(value)
    return repr(int(v)) if v == int(v) else repr(v)


def _fmt_bound(b: float) -> str:
    return f"{b:.6g}"


def _histogram_lines(key: str, snap: dict, lines: list) -> None:
    """Expand one histogram snapshot into the cumulative Prometheus
    series: ``<base>_bucket{le=...}``, ``<base>_sum``, ``<base>_count``."""
    counts = snap.get("counts") or []
    bounds = list(HISTOGRAM_BOUNDS)[: max(len(counts) - 1, 0)]
    cum = 0
    for b, c in zip(bounds, counts):
        cum += int(c)
        le = _splice_label(key, f'le="{_fmt_bound(b)}"')
        base, rest = le.split("{", 1)
        lines.append(f"{base}_bucket{{{rest} {cum}")
    cum = sum(int(c) for c in counts)
    le = _splice_label(key, 'le="+Inf"')
    base, rest = le.split("{", 1)
    lines.append(f"{base}_bucket{{{rest} {cum}")
    if "{" in key:
        base, rest = key.split("{", 1)
        lines.append(f"{base}_sum{{{rest} {_fmt_value(snap.get('sum', 0.0))}")
        lines.append(f"{base}_count{{{rest} {cum}")
    else:
        lines.append(f"{key}_sum {_fmt_value(snap.get('sum', 0.0))}")
        lines.append(f"{key}_count {cum}")


def prometheus_text(counters: Optional[dict] = None,
                    gauges: Optional[dict] = None,
                    histograms: Optional[dict] = None) -> str:
    """Render metrics in the Prometheus text exposition format.

    With no arguments, serializes the LIVE registry. Passing
    ``counters``/``gauges``/``histograms`` dicts (rendered-key ->
    value/snapshot, exactly what a ledger ``counters`` record holds)
    renders a historical snapshot instead — ``tools/obs.py`` uses this
    to export from a ledger of a finished run. Histogram values are
    snapshot dicts ``{"sum", "count", "counts"}``; they expand into
    cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``."""
    samples = []            # (kind, base_name, key, value)
    if counters is None and gauges is None and histograms is None:
        for kind, _name, _labels, key, value in iter_metrics():
            samples.append((kind, _base_name(key), key, value))
    else:
        for key, value in (counters or {}).items():
            samples.append(("counter", _base_name(key), key, value))
        for key, value in (gauges or {}).items():
            samples.append(("gauge", _base_name(key), key, value))
        for key, snap in (histograms or {}).items():
            samples.append(("histogram", _base_name(key), key, snap))

    lines = []
    seen_type = set()
    # group by (kind, base name); stable sort keeps families together
    for kind, base, key, value in sorted(samples, key=lambda s: s[:3]):
        if (kind, base) not in seen_type:
            seen_type.add((kind, base))
            help_text = help_for(base)
            if help_text:
                lines.append(f"# HELP {base} {help_text}")
            lines.append(f"# TYPE {base} {kind}")
        if kind == "histogram":
            _histogram_lines(key, value, lines)
        else:
            lines.append(f"{key} {_fmt_value(value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(path: str, counters: Optional[dict] = None,
                     gauges: Optional[dict] = None,
                     histograms: Optional[dict] = None) -> str:
    """Atomically write :func:`prometheus_text` to ``path`` (temp +
    ``os.replace``, the repo-wide torn-read discipline)."""
    text = prometheus_text(counters=counters, gauges=gauges,
                           histograms=histograms)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".metrics-", suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path
