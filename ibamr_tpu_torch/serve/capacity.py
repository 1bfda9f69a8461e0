"""Serving capacity model: measured chunk cost -> sustainable load (port
of ``ibamr_tpu/serve/capacity.py``, pure functions over ledger records).

The elastic manager (:mod:`ibamr_tpu_torch.serve.autoscale`) reacts to
traffic; this module PREDICTS what the reaction can sustain, joining
two things the repo already measures:

- **per-request chunk cost** — ``request`` ledger records carry warm
  ``total_s`` and ``steps`` per family, so a family's per-step warm
  cost (and its lane width) falls straight out of any soak ledger;
- **the scaling policy** — how many lanes serve a family
  concurrently.

The model is a first-order M/M/1-style queueing bound, documented
rather than hidden: with mean service time ``E[S]`` per request and
``c`` effective servers (lanes), sojourn p99 under exponential
assumptions is roughly ``E[S] * ln(100) / (1 - rho)`` — so the
largest utilization meeting ``p99 <= X`` is
``rho_max = 1 - E[S] * ln(100) / X`` (clamped to [0, 0.95]) and the
sustainable arrival rate is ``rho_max * c / E[S]``. Crude, but it is
a CEILING with honest inputs: the elastic smoke checks its healthy
offered rate against this prediction, and ``python -m
ibamr_tpu_torch.tools.slo check --elastic`` carries the per-family
costs in its artifact.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

LN100 = math.log(100.0)
MAX_UTILIZATION = 0.95


def family_costs_from_records(records: Sequence[dict]) -> dict:
    """Per-family warm cost model from ``request`` ledger records:
    ``{family: {"per_step_s", "mean_service_s", "lanes", "samples"}}``.
    Cold completions are excluded — compile cost is the autoscaler's
    problem (scale-up latency), not steady-state capacity."""
    acc: Dict[str, dict] = {}
    for r in records:
        if r.get("kind") != "request" or r.get("cold"):
            continue
        steps = int(r.get("steps") or 0)
        total = float(r.get("total_s") or 0.0)
        if steps <= 0 or total <= 0.0:
            continue
        fam = str(r.get("family"))
        a = acc.setdefault(fam, {"steps": 0, "total_s": 0.0,
                                 "samples": 0, "lanes": 1})
        a["steps"] += steps
        a["total_s"] += total
        a["samples"] += 1
        a["lanes"] = max(a["lanes"], int(r.get("bucket_lanes") or 1))
    out = {}
    for fam, a in acc.items():
        per_step = a["total_s"] / a["steps"]
        out[fam] = {"per_step_s": round(per_step, 6),
                    "mean_service_s": round(a["total_s"] / a["samples"],
                                            6),
                    "lanes": a["lanes"],
                    "samples": a["samples"]}
    return out


def mix_service_time(costs: dict, mix: Optional[dict] = None,
                     steps_by_family: Optional[dict] = None) -> dict:
    """Mix-weighted mean service time and effective lane count.
    ``mix`` maps family -> share (defaults to sample-weighted shares
    from ``costs``); ``steps_by_family`` overrides the measured mean
    steps with a planned demand profile."""
    if not costs:
        return {"mean_service_s": None, "lanes": 0}
    if mix is None:
        total = sum(c["samples"] for c in costs.values())
        mix = {f: c["samples"] / total for f, c in costs.items()}
    norm = sum(mix.get(f, 0.0) for f in costs)
    if norm <= 0:
        return {"mean_service_s": None, "lanes": 0}
    es = 0.0
    lanes = 0
    for fam, c in costs.items():
        w = mix.get(fam, 0.0) / norm
        if w <= 0:
            continue
        service = (c["per_step_s"] * steps_by_family[fam]
                   if steps_by_family and fam in steps_by_family
                   else c["mean_service_s"])
        es += w * service
        lanes = max(lanes, c["lanes"])
    return {"mean_service_s": es, "lanes": lanes}


def sustainable_rps(costs: dict, p99_ceiling_s: float,
                    mix: Optional[dict] = None,
                    steps_by_family: Optional[dict] = None) -> dict:
    """Predicted sustainable arrival rate keeping sojourn p99 under
    ``p99_ceiling_s`` for the given family mix (module docstring has
    the queueing bound). Returns the full reasoning, not just the
    number: ``{"rps", "utilization", "mean_service_s", "lanes",
    "p99_ceiling_s"}`` — ``rps`` is ``None`` when the model has no
    warm samples or the ceiling is below one service time."""
    st = mix_service_time(costs, mix=mix,
                          steps_by_family=steps_by_family)
    es, lanes = st["mean_service_s"], st["lanes"]
    out = {"rps": None, "utilization": None,
           "mean_service_s": (None if es is None else round(es, 6)),
           "lanes": lanes,
           "p99_ceiling_s": float(p99_ceiling_s)}
    if es is None or es <= 0.0 or p99_ceiling_s <= 0.0:
        return out
    rho = 1.0 - (es * LN100) / float(p99_ceiling_s)
    rho = max(0.0, min(MAX_UTILIZATION, rho))
    if rho <= 0.0:
        out["utilization"] = 0.0
        return out            # one service time already busts the p99
    out["utilization"] = round(rho, 4)
    out["rps"] = round(rho * max(lanes, 1) / es, 3)
    return out


def capacity_report(records: Sequence[dict], p99_ceiling_s: float,
                    mix: Optional[dict] = None) -> dict:
    """One-call capacity artifact from a soak ledger: per-family
    costs + the sustainable-rate prediction (the shape the elastic
    smoke embeds)."""
    costs = family_costs_from_records(records)
    return {"families": costs,
            "prediction": sustainable_rps(costs, p99_ceiling_s,
                                          mix=mix)}
