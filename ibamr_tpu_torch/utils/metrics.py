"""Structured per-step metrics logging (the port's own copy of
``ibamr_tpu/utils/metrics.py``; a 0-dim tensor, like a 0-dim array, logs
as its Python scalar).

Reference parity: SAMRAI ``tbox::PIO`` per-step log lines (time, dt, CFL,
Krylov iters) + ``IBInstrumentPanel`` text outputs (SURVEY.md §5.5). Here:
one JSONL stream of per-step dicts, plus a human-readable console echo.
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Any, Dict, IO, Optional

import numpy as np


def _jsonable(v: Any) -> Any:
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.integer,)):
        return int(v)
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = False,
                 stream: Optional[IO[str]] = None):
        self.path = path
        self.echo = echo
        self.stream = stream or sys.stdout
        self._fh: Optional[IO[str]] = None
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def log(self, record: Dict[str, Any]) -> None:
        rec = {}
        for k, v in record.items():
            v = _jsonable(v)
            if isinstance(v, float) and not math.isfinite(v):
                # strict-JSON stream: a NaN/Inf vital must neither
                # break downstream json.loads (json.dumps would emit
                # bare NaN) nor vanish silently — null the value and
                # flag it, so the non-finite event stays queryable
                rec[k] = None
                rec[f"{k}_nonfinite"] = repr(v)
            else:
                rec[k] = v
        line = json.dumps(rec, allow_nan=False)
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            brief = "  ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items())
            print(brief, file=self.stream)

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.flush()
                os.fsync(self._fh.fileno())
            except (OSError, ValueError):
                pass            # closed/unsyncable stream: still close
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
