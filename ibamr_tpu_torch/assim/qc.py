"""Observation quality control: the gate between sensors and the gain
(port of ``ibamr_tpu/assim/qc.py``).

Real sensor streams drop out (NaN), go stale (a feed that keeps
repeating its last value ages without failing), and spike (electrical
outliers many sigma off the flow). Letting any of those into the
analysis corrupts EVERY lane at once — the one failure mode lane
quarantine cannot contain — so QC screens per channel BEFORE the
update and the analysis only ever sees an (m,) accept mask (shapes
static, one cached analysis; see :mod:`ibamr_tpu_torch.assim.enkf`).

Screening order per channel: dropout (non-finite value), stale
(``age_s`` beyond ``max_age_s``), then innovation magnitude
``|y - ybar| > k_sigma * sqrt(HPH + R)`` against the ensemble's own
predicted spread — the classic background check, self-scaling as the
ensemble tightens. Every rejection is a structured ledger record
(kind ``assim_qc_reject``) plus a reason-labeled counter, so
``python -m ibamr_tpu_torch.tools.obs summary`` can report rejections
by reason and the drill can pin "every injected bad observation was
rejected".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ibamr_tpu_torch import obs as _obs

_REJECTS = _obs.counter  # labeled per reason at call time
_obs.describe("assim_qc_rejections_total",
              "observation channels rejected by the QC gate, by reason")
_obs.describe("assim_qc_accepted_total",
              "observation channels accepted into the analysis")


@dataclass
class QCConfig:
    """Gate thresholds. ``k_sigma`` is deliberately loose (4 sigma):
    QC protects against *bad sensors*, not surprising flow — a filter
    that rejects every informative innovation never corrects."""
    k_sigma: float = 4.0
    max_age_s: float = 60.0
    min_accept: int = 1     # fewer accepted channels -> skip analysis


def screen(batch, ybar: np.ndarray, hph: np.ndarray,
           cfg: QCConfig, *, step: int = 0,
           cycle: Optional[int] = None) -> Tuple[np.ndarray, dict]:
    """Per-channel accept mask for one observation batch.

    batch: :class:`~ibamr_tpu_torch.assim.observe.ObservationBatch`;
    ybar: (m,) ensemble-mean predicted obs; hph: (m,) ensemble
    variance of the predicted obs (the diag of H P H^T).

    Returns ``(accept (m,) bool, report)`` where report counts
    rejections by reason. Emits one ledger record per rejection.
    """
    y = np.asarray(batch.values, np.float64)
    r = np.asarray(batch.r, np.float64)
    age = np.asarray(batch.age_s, np.float64)
    ybar = np.asarray(ybar, np.float64)
    hph = np.maximum(np.asarray(hph, np.float64), 0.0)
    m = y.shape[0]
    names = batch.names or tuple(f"ch[{i}]" for i in range(m))
    cyc = batch.cycle if cycle is None else cycle

    accept = np.ones(m, dtype=bool)
    reasons: dict = {"dropout": 0, "stale": 0, "outlier": 0}
    for j in range(m):
        reason = None
        innov = y[j] - ybar[j]
        thresh = cfg.k_sigma * float(np.sqrt(hph[j] + r[j]))
        if not np.isfinite(y[j]):
            reason = "dropout"
        elif age[j] > cfg.max_age_s:
            reason = "stale"
        elif abs(innov) > thresh:
            reason = "outlier"
        if reason is None:
            continue
        accept[j] = False
        reasons[reason] += 1
        _REJECTS("assim_qc_rejections_total", reason=reason).inc()
        _obs.emit("assim_qc_reject",
                  instrument=names[j], reason=reason,
                  cycle=int(cyc), step=int(step),
                  value=(float(y[j]) if np.isfinite(y[j]) else None),
                  innovation=(float(innov) if np.isfinite(innov)
                              else None),
                  threshold=thresh, age_s=float(age[j]))
    n_acc = int(accept.sum())
    _obs.counter("assim_qc_accepted_total").inc(n_acc)
    report = {"accepted": n_acc, "rejected": int(m - n_acc),
              "by_reason": {k: v for k, v in reasons.items() if v}}
    return accept, report
