"""Serving-path SLO gate (port of ``tools/slo.py``).

    python -m ibamr_tpu_torch.tools.slo check [--soak | --elastic |
        --assim] [--ledger L | --drill-json J] [--device cpu]
        [--tighten] [--json] [--contract PATH]

``check`` evaluates measured SLIs against the port's versioned
``ibamr_tpu_torch/SLO.json`` contract — the latency/health counterpart
of the ``python -m ibamr_tpu_torch.tools.serve check`` build-count
contract. SLIs come from a run ledger: by default the command runs a
fresh ``cold_warm_drill`` with a ledger attached (on the card, or the
host with ``--device cpu``), flushes the metric registry into it, and
reads the SLIs back from the ledger alone — the same computation works
on any production ledger via ``--ledger``, and on a saved drill JSON via
``--drill-json``.

SLIs (:func:`slis_from_ledger`):

- ``warm_first_step_p99_s`` — p99 request-to-first-step latency on the
  warm path, estimated from the
  ``serve_first_step_seconds{path="warm"}`` histogram snapshot in the
  last ``counters`` record (empirical fallback from ``request``
  records when no snapshot landed);
- ``warm_path_compiles`` — ``aot_cache`` miss records at or after the
  first warm request's admission (the "warm path is free" claim
  restated as an SLO);
- ``padding_fraction`` — mean of the ``serve_padding_fraction``
  histogram (dead lanes stepped per batch);
- ``quarantine_rate`` — quarantined / completed requests;
- ``cache_hit_ratio`` — executable-cache hits / (hits + misses).

Soak mode: ``check --soak`` runs the bounded deterministic soak
(``serve.loadgen.soak_drill`` — seeded Poisson + burst arrivals over
the heavy-tailed mix, open loop, committed tenant-class policies)
instead of the cold/warm drill, and evaluates the SOAK SLIs against the
contract's separate ``soak_slos`` section (:func:`soak_slis_from_ledger`):

- ``soak_warm_p99_s`` — warm first-step p99 UNDER SUSTAINED TRAFFIC;
- ``soak_queue_wait_p99_s`` — admission queue-wait p99 from the
  ``serve_queue_wait_seconds`` histogram;
- ``soak_shed_rate`` — shed / admitted;
- ``soak_lost_requests`` — admitted trace_ids with no terminal
  ``request``/``request_shed`` record (the no-lost-request liveness
  invariant; budgeted at exactly 0).

``--soak --tighten`` merges a fresh ``soak_slos`` section into the
existing contract without touching the cold/warm ``slos``.

Elastic mode: ``check --elastic`` runs the elastic warm-pool drill
(``tools.fault_injection.run_elastic_smoke`` — a mid-soak mix shift
onto an unseen family under memory pressure, then a crash-safe
restart) and evaluates the ELASTIC SLIs against the contract's
``elastic_slos`` section (:func:`elastic_slis_from_ledger`):

- ``elastic_scale_up_latency_s`` — worst grow-decision-to-warm
  latency (``pool_scale`` warmed confirmations);
- ``elastic_restart_to_warm_s`` — manifest-restore-to-all-warm wall
  time (the ``serving_restore`` record);
- ``elastic_restart_fresh_compiles`` — fresh builds paid by the
  restart re-warm (executable-cache ``cold_source`` attribution: a
  family the cache directory had never seen; budgeted at exactly 0);
- ``elastic_lost_requests`` — the no-lost-request join, through scale
  events, brownout, and shed (exactly 0);
- ``elastic_mode_transitions`` — serve-mode ladder transitions (an
  oscillating ladder fails the budget, not just the drill);
- ``elastic_interactive_p99_s`` — warm INTERACTIVE first-step p99
  while batch is capped/shed (brownout protects it, or this trips).

Assimilation mode: ``check --assim`` runs the chaos assimilation drill
(``tools.fault_injection.run_assim_smoke`` — all four observation/member
injectors armed at once against the supervised ensemble filter) and
evaluates the ASSIM SLIs against the contract's ``assim_slos`` section
(:func:`assim_slis_from_ledger`):

- ``assim_lost_cycles`` — observation cycles with no ``assim_cycle``
  ledger record, derived by joining the ``assim_summary`` expected
  count against the cycle stream (budgeted at EXACTLY 0);
- ``assim_forecast_error_ratio`` — final forecast error over the
  open-loop (no-assimilation) baseline from the same drill; any
  ceiling below 1.0 IS the "assimilation helps" claim;
- ``assim_analysis_wall_p99_s`` — p99 analysis wall time per cycle
  (histogram snapshot when one landed, else empirical from the
  ``assim_cycle`` records).

``--elastic --tighten`` and ``--assim --tighten`` merge fresh sections,
same discipline as soak.

Exit convention (the ``graph_audit`` family, with one deliberate
difference): **headroom under a ceiling is attainment, not drift** —
a warm p99 far below budget is the system working, so it exits 0, not
1. Exit 1 means the check could not be evaluated (no contract, or a
budgeted SLI the measurement cannot produce); exit 2 means an SLO is
violated. ``--tighten`` rewrites the contract from the measurement
with slack on the latency/ratio budgets.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

CONTRACT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "SLO.json")
SLO_SCHEMA = 1

# SLI names and their direction; a contract may budget any subset
CEILINGS = ("warm_first_step_p99_s", "warm_path_compiles",
            "padding_fraction", "quarantine_rate")
FLOORS = ("cache_hit_ratio",)
SLI_NAMES = CEILINGS + FLOORS

_WARM_FIRST_KEY = 'serve_first_step_seconds{path="warm"}'
_PADFRAC_KEY = "serve_padding_fraction"

# soak SLIs: all ceilings, evaluated against the contract's
# separate "soak_slos" section so the cold/warm check stays untouched
SOAK_SLI_NAMES = ("soak_warm_p99_s", "soak_queue_wait_p99_s",
                  "soak_shed_rate", "soak_lost_requests")
_QWAIT_KEY = "serve_queue_wait_seconds"

# elastic SLIs: the autoscaling/brownout/restart invariants of
# the elastic warm-pool drill, evaluated against the contract's
# separate "elastic_slos" section. All ceilings; the two count SLIs
# (lost requests, fresh restart compiles) are budgeted at EXACTLY 0.
ELASTIC_SLI_NAMES = ("elastic_scale_up_latency_s",
                     "elastic_restart_to_warm_s",
                     "elastic_restart_fresh_compiles",
                     "elastic_lost_requests",
                     "elastic_mode_transitions",
                     "elastic_interactive_p99_s")

# assimilation SLIs: the forecasting-service invariants of
# the chaos assimilation drill, evaluated against the contract's
# separate "assim_slos" section. All ceilings; lost cycles pin at
# EXACTLY 0 and the error ratio's ceiling sits below 1.0 by
# construction (beating the open loop is the product claim).
ASSIM_SLI_NAMES = ("assim_lost_cycles",
                   "assim_forecast_error_ratio",
                   "assim_analysis_wall_p99_s")
_AWALL_KEY = "assim_analysis_wall_seconds"


def _last_histograms(records) -> dict:
    """The histogram snapshot of the LAST ``counters`` record carrying
    one (cumulative, so the last wins)."""
    out = {}
    for rec in records:
        if rec.get("kind") == "counters" and rec.get("histograms"):
            out = rec["histograms"]
    return out


def _empirical_quantile(values, q):
    if not values:
        return None
    vs = sorted(values)
    return vs[min(len(vs) - 1, max(0, math.ceil(q * len(vs)) - 1))]


def slis_from_ledger(records) -> dict:
    """Compute every SLI the ledger can support; absent ones are
    ``None`` (a budgeted-but-``None`` SLI makes the check exit 1)."""
    from ibamr_tpu_torch.obs.bus import quantiles_from_counts

    requests = [r for r in records if r.get("kind") == "request"]
    admits = [r for r in records if r.get("kind") == "request_admit"]
    cache_ev = [r for r in records if r.get("kind") == "aot_cache"]
    warm = [r for r in requests if not r.get("cold")]

    slis: dict = {name: None for name in SLI_NAMES}
    hists = _last_histograms(records)

    # warm first-step p99: histogram estimate, else empirical
    snap = hists.get(_WARM_FIRST_KEY)
    if snap and snap.get("count"):
        slis["warm_first_step_p99_s"] = quantiles_from_counts(
            snap["counts"], [0.99])[0]
    elif warm:
        slis["warm_first_step_p99_s"] = _empirical_quantile(
            [r["first_step_s"] for r in warm
             if r.get("first_step_s") is not None], 0.99)

    # builds on the warm path: aot_cache misses at/after the first
    # warm request's admission (trace ids join the two record kinds)
    if warm:
        warm_tids = {r["trace_id"] for r in warm if r.get("trace_id")}
        warm_admits = [a["seq"] for a in admits
                       if a.get("trace_id") in warm_tids]
        if warm_admits:
            first_warm_seq = min(warm_admits)
            slis["warm_path_compiles"] = sum(
                1 for e in cache_ev
                if e.get("event") == "miss"
                and e.get("seq", -1) >= first_warm_seq)

    snap = hists.get(_PADFRAC_KEY)
    if snap and snap.get("count"):
        slis["padding_fraction"] = (float(snap["sum"])
                                    / float(snap["count"]))

    if requests:
        slis["quarantine_rate"] = (
            sum(1 for r in requests if r.get("quarantined"))
            / len(requests))

    hits = sum(1 for e in cache_ev if e.get("event") == "hit")
    misses = sum(1 for e in cache_ev if e.get("event") == "miss")
    if hits + misses:
        slis["cache_hit_ratio"] = hits / (hits + misses)
    return slis


def slis_from_drill(drill: dict) -> dict:
    """SLIs from a saved ``cold_warm_drill`` / ``tools.serve bench``
    JSON (the ``--drill-json`` path — no ledger needed)."""
    from ibamr_tpu_torch.obs.bus import quantiles_from_counts

    slis: dict = {name: None for name in SLI_NAMES}
    hists = drill.get("histograms") or {}
    snap = hists.get(_WARM_FIRST_KEY)
    if snap and snap.get("count"):
        slis["warm_first_step_p99_s"] = quantiles_from_counts(
            snap["counts"], [0.99])[0]
    elif drill.get("warm_p99_s") is not None:
        slis["warm_first_step_p99_s"] = drill["warm_p99_s"]
    elif drill.get("warm_first_step_s") is not None:
        slis["warm_first_step_p99_s"] = drill["warm_first_step_s"]
    if drill.get("warm_compiles") is not None:
        slis["warm_path_compiles"] = drill["warm_compiles"]
    snap = hists.get(_PADFRAC_KEY)
    if snap and snap.get("count"):
        slis["padding_fraction"] = (float(snap["sum"])
                                    / float(snap["count"]))
    oks = [drill.get("cold_ok"), drill.get("warm_ok")]
    if all(o is not None for o in oks):
        slis["quarantine_rate"] = sum(0 if o else 1 for o in oks) / 2
    hits = drill.get("warm_hits")
    if hits is not None:
        misses = (drill.get("warm_compiles") or 0)
        if hits + misses:
            slis["cache_hit_ratio"] = hits / (hits + misses)
    return slis


def soak_slis_from_ledger(records) -> dict:
    """Soak SLIs from a traffic ledger (``soak_drill`` with a ledger
    attached, or any production ledger). Absent SLIs are ``None``."""
    from ibamr_tpu_torch.obs.bus import quantiles_from_counts

    records = list(records)
    requests = [r for r in records if r.get("kind") == "request"]
    sheds = [r for r in records if r.get("kind") == "request_shed"]
    admits = [r for r in records if r.get("kind") == "request_admit"]
    warm = [r for r in requests if not r.get("cold")]
    hists = _last_histograms(records)

    slis: dict = {name: None for name in SOAK_SLI_NAMES}

    snap = hists.get(_WARM_FIRST_KEY)
    if snap and snap.get("count"):
        slis["soak_warm_p99_s"] = quantiles_from_counts(
            snap["counts"], [0.99])[0]
    elif warm:
        slis["soak_warm_p99_s"] = _empirical_quantile(
            [r["first_step_s"] for r in warm
             if r.get("first_step_s") is not None], 0.99)

    snap = hists.get(_QWAIT_KEY)
    if snap and snap.get("count"):
        slis["soak_queue_wait_p99_s"] = quantiles_from_counts(
            snap["counts"], [0.99])[0]
    else:
        qwaits = [r["queue_wait_s"] for r in requests + sheds
                  if r.get("queue_wait_s") is not None]
        if qwaits:
            slis["soak_queue_wait_p99_s"] = _empirical_quantile(
                qwaits, 0.99)

    terminal = len(requests) + len(sheds)
    if terminal:
        slis["soak_shed_rate"] = len(sheds) / terminal

    # the liveness invariant, from the ledger alone: every admitted
    # trace_id must reach a terminal record
    if admits:
        done = {r.get("trace_id") for r in requests + sheds
                if r.get("trace_id")}
        slis["soak_lost_requests"] = sum(
            1 for a in admits
            if a.get("trace_id") and a["trace_id"] not in done)
    return slis


def elastic_slis_from_ledger(records) -> dict:
    """Elastic SLIs from an elastic-drill (or production) ledger:
    scaling latency from ``pool_scale`` warm confirmations, restart
    health from the ``serving_restore`` record, mode-ladder stability
    from ``serve_mode`` transitions, and the interactive warm p99 +
    no-lost-request join from the request stream. Absent SLIs are
    ``None``."""
    records = list(records)
    requests = [r for r in records if r.get("kind") == "request"]
    sheds = [r for r in records if r.get("kind") == "request_shed"]
    admits = [r for r in records if r.get("kind") == "request_admit"]

    slis: dict = {name: None for name in ELASTIC_SLI_NAMES}

    warmed = [r.get("warm_s") for r in records
              if r.get("kind") == "pool_scale"
              and r.get("action") == "warmed"
              and r.get("warm_s") is not None]
    if warmed:
        slis["elastic_scale_up_latency_s"] = max(warmed)

    restores = [r for r in records
                if r.get("kind") == "serving_restore"]
    if restores:
        last = restores[-1]          # the drill's (only) restart
        slis["elastic_restart_to_warm_s"] = last.get("warm_s")
        slis["elastic_restart_fresh_compiles"] = last.get(
            "fresh_compiles")

    modes = [r for r in records if r.get("kind") == "serve_mode"]
    if modes or restores or warmed:
        # zero transitions is a measurement (a quiet drill), but only
        # when the ledger demonstrably came from an elastic run
        slis["elastic_mode_transitions"] = len(modes)

    interactive = [r["first_step_s"] for r in requests
                   if not r.get("cold")
                   and r.get("tenant_class") == "interactive"
                   and r.get("first_step_s") is not None]
    if interactive:
        slis["elastic_interactive_p99_s"] = _empirical_quantile(
            interactive, 0.99)

    if admits:
        done = {r.get("trace_id") for r in requests + sheds
                if r.get("trace_id")}
        slis["elastic_lost_requests"] = sum(
            1 for a in admits
            if a.get("trace_id") and a["trace_id"] not in done)
    return slis


def assim_slis_from_ledger(records) -> dict:
    """Assimilation SLIs from an assimilation-drill (or production)
    ledger. Lost cycles come from joining the ``assim_summary``
    record's expected-cycle count against the observed
    ``assim_cycle`` stream — self-reported verdicts are NOT trusted;
    the forecast-error ratio has to come from the summary because the
    open-loop baseline runs outside the ledger. Absent SLIs are
    ``None``."""
    from ibamr_tpu_torch.obs.bus import quantiles_from_counts

    records = list(records)
    cycles = [r for r in records if r.get("kind") == "assim_cycle"]
    summaries = [r for r in records
                 if r.get("kind") == "assim_summary"]
    hists = _last_histograms(records)

    slis: dict = {name: None for name in ASSIM_SLI_NAMES}

    if summaries:
        last = summaries[-1]
        expected = last.get("cycles")
        if expected is not None:
            done = {r.get("cycle") for r in cycles}
            slis["assim_lost_cycles"] = sum(
                1 for c in range(int(expected)) if c not in done)
        fe, ol = last.get("forecast_error"), last.get("open_loop_error")
        if fe is not None and ol:
            slis["assim_forecast_error_ratio"] = float(fe) / float(ol)

    snap = hists.get(_AWALL_KEY)
    if snap and snap.get("count"):
        slis["assim_analysis_wall_p99_s"] = quantiles_from_counts(
            snap["counts"], [0.99])[0]
    else:
        walls = [r["analysis_wall_s"] for r in cycles
                 if not r.get("skipped")
                 and r.get("analysis_wall_s") is not None]
        if walls:
            slis["assim_analysis_wall_p99_s"] = _empirical_quantile(
                walls, 0.99)
    return slis


def load_contract(path: str = CONTRACT_PATH) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("slo_schema") != SLO_SCHEMA:
        raise ValueError(f"unsupported slo_schema "
                         f"{doc.get('slo_schema')!r} in {path}")
    return doc


def evaluate(slis: dict, contract: dict):
    """(violations, unmeasurable, met) — human-readable lines for each
    budgeted SLO. Attainment headroom is 'met', never drift."""
    violations, unmeasurable, met = [], [], []
    for name, budget in sorted((contract.get("slos") or {}).items()):
        got = slis.get(name)
        if "ceiling" in budget:
            want, floor = float(budget["ceiling"]), False
        elif "floor" in budget:
            want, floor = float(budget["floor"]), True
        else:
            unmeasurable.append(f"{name}: budget has neither ceiling "
                                f"nor floor")
            continue
        if got is None:
            unmeasurable.append(f"{name}: not measurable from this "
                                f"ledger")
            continue
        got = float(got)
        bad = got < want if floor else got > want
        word = "floor" if floor else "ceiling"
        if bad:
            violations.append(f"{name}: measured {got:.6g} vs {word} "
                              f"{want:.6g} (VIOLATED)")
        else:
            met.append(f"{name}: measured {got:.6g} within {word} "
                       f"{want:.6g}")
    return violations, unmeasurable, met


def tighten_contract(slis: dict, drill_cfg: dict) -> dict:
    """A fresh contract from measured SLIs, with slack where variance
    lives: latency ceilings at 2x measured (floored at 0.5 s), ratio
    ceilings +0.2, the hit-ratio floor −0.2; count SLOs pin exactly."""
    slos = {}
    if slis.get("warm_first_step_p99_s") is not None:
        slos["warm_first_step_p99_s"] = {"ceiling": round(
            max(2.0 * slis["warm_first_step_p99_s"], 0.5), 4)}
    if slis.get("warm_path_compiles") is not None:
        slos["warm_path_compiles"] = {
            "ceiling": int(slis["warm_path_compiles"])}
    if slis.get("padding_fraction") is not None:
        slos["padding_fraction"] = {"ceiling": round(
            min(slis["padding_fraction"] + 0.2, 1.0), 4)}
    if slis.get("quarantine_rate") is not None:
        slos["quarantine_rate"] = {
            "ceiling": round(slis["quarantine_rate"], 4)}
    if slis.get("cache_hit_ratio") is not None:
        slos["cache_hit_ratio"] = {"floor": round(
            max(slis["cache_hit_ratio"] - 0.2, 0.0), 4)}
    return {
        "_doc": ("Serving-path SLO contract (tools/slo.py check; see "
                 "docs/SERVING.md). Ceilings violate UP, floors "
                 "violate DOWN; headroom is attainment, not drift. "
                 "Written by --tighten."),
        "slo_schema": SLO_SCHEMA,
        "drill": drill_cfg,
        "slos": slos,
    }


def run_drill_ledger(args, ledger_path: str) -> dict:
    """Run ``cold_warm_drill`` on ``args.device`` with a fresh attached
    ledger and flush the metric registry into it; returns the drill
    output."""
    from ibamr_tpu_torch import obs as _obs
    from ibamr_tpu_torch.serve.router import cold_warm_drill

    with _obs.ledger(ledger_path):
        out = cold_warm_drill(
            n_cells=args.n, n_lat=args.n_lat, n_lon=args.n_lon,
            lanes=args.lanes, steps=args.steps, dt=args.dt,
            engine=args.engine or None,
            warm_requests=args.warm_requests, device=args.device)
        # land the histogram snapshots in the ledger: the SLI
        # computation must work from the ledger ALONE
        _obs.chunk_boundary()
    return out


def run_soak_ledger(args, ledger_path: str) -> dict:
    """Run the bounded open-loop soak on ``args.device`` with a fresh
    attached ledger and flush the metric registry into it; returns the
    traffic summary."""
    from ibamr_tpu_torch import obs as _obs
    from ibamr_tpu_torch.serve.loadgen import soak_drill

    with _obs.ledger(ledger_path):
        out = soak_drill(seed=args.soak_seed,
                         duration_s=args.soak_duration,
                         rate_rps=args.soak_rate,
                         burst_factor=args.soak_burst,
                         n_cells=args.n, n_lat=args.n_lat,
                         n_lon=args.n_lon, lanes=args.lanes,
                         time_scale=args.soak_time_scale,
                         device=args.device)
        _obs.chunk_boundary()
    return out


def run_elastic_drill(args, directory: str) -> dict:
    """Run the bounded elastic warm-pool drill on ``args.device`` in
    ``directory``; the drill owns its own attached ledger
    (``<directory>/elastic_ledger.jsonl``) and raises on any broken
    invariant before the SLO layer even evaluates."""
    from ibamr_tpu_torch.tools.fault_injection import run_elastic_smoke

    return run_elastic_smoke(directory,
                             duration_s=args.elastic_duration,
                             rate_rps=args.elastic_rate,
                             time_scale=args.elastic_time_scale,
                             shift_frac=args.elastic_shift_frac,
                             device=args.device)


def run_assim_drill(args, directory: str) -> dict:
    """Run the chaos assimilation drill on ``args.device`` in
    ``directory``; the drill owns its own attached ledger
    (``<directory>/assim_ledger.jsonl``) and raises on any broken
    invariant (unrejected bad obs, unquarantined member, lost cycle,
    new signature) before the SLO layer even evaluates."""
    from ibamr_tpu_torch.tools.fault_injection import run_assim_smoke

    return run_assim_smoke(directory,
                           fleet_size=args.assim_fleet,
                           cycles=args.assim_cycles,
                           device=args.device)


def tighten_assim(slis: dict, assim_cfg: dict, contract_path: str):
    """Merge a fresh ``assim_slos`` section (plus the drill cfg) into
    the existing contract, leaving every other section untouched.
    Lost cycles pin EXACTLY (zero is the invariant); the error-ratio
    ceiling gets 4x slack but is clamped BELOW 1.0 — a contract that
    tolerated losing to the open loop would not be a forecasting SLO;
    the wall ceiling gets 3x slack floored at 0.5 s (the p99 of a
    short drill IS the first cycle, which pays the one-time analysis
    build — noisier than a steady-state latency)."""
    assim_slos = {}
    if slis.get("assim_lost_cycles") is not None:
        assim_slos["assim_lost_cycles"] = {
            "ceiling": int(slis["assim_lost_cycles"])}
    if slis.get("assim_forecast_error_ratio") is not None:
        assim_slos["assim_forecast_error_ratio"] = {"ceiling": round(
            min(max(4.0 * slis["assim_forecast_error_ratio"], 0.25),
                0.9), 4)}
    if slis.get("assim_analysis_wall_p99_s") is not None:
        assim_slos["assim_analysis_wall_p99_s"] = {"ceiling": round(
            max(3.0 * slis["assim_analysis_wall_p99_s"], 0.5), 4)}
    try:
        doc = load_contract(contract_path)
    except FileNotFoundError:
        doc = {"slo_schema": SLO_SCHEMA, "slos": {}}
    doc["assim"] = assim_cfg
    doc["assim_slos"] = assim_slos
    return doc


def tighten_elastic(slis: dict, elastic_cfg: dict,
                    contract_path: str):
    """Merge a fresh ``elastic_slos`` section (plus the drill cfg)
    into the existing contract, leaving ``slos``/``soak_slos``
    untouched. Latency ceilings get 2x slack (floored at 1 s), the
    transition ceiling +2; lost requests and fresh restart compiles
    pin EXACTLY (zero is the invariant, not a budget)."""
    elastic_slos = {}
    if slis.get("elastic_scale_up_latency_s") is not None:
        elastic_slos["elastic_scale_up_latency_s"] = {"ceiling": round(
            max(2.0 * slis["elastic_scale_up_latency_s"], 1.0), 4)}
    if slis.get("elastic_restart_to_warm_s") is not None:
        elastic_slos["elastic_restart_to_warm_s"] = {"ceiling": round(
            max(2.0 * slis["elastic_restart_to_warm_s"], 1.0), 4)}
    if slis.get("elastic_restart_fresh_compiles") is not None:
        elastic_slos["elastic_restart_fresh_compiles"] = {
            "ceiling": int(slis["elastic_restart_fresh_compiles"])}
    if slis.get("elastic_lost_requests") is not None:
        elastic_slos["elastic_lost_requests"] = {
            "ceiling": int(slis["elastic_lost_requests"])}
    if slis.get("elastic_mode_transitions") is not None:
        elastic_slos["elastic_mode_transitions"] = {
            "ceiling": int(slis["elastic_mode_transitions"]) + 2}
    if slis.get("elastic_interactive_p99_s") is not None:
        elastic_slos["elastic_interactive_p99_s"] = {"ceiling": round(
            max(2.0 * slis["elastic_interactive_p99_s"], 1.0), 4)}
    try:
        doc = load_contract(contract_path)
    except FileNotFoundError:
        doc = {"slo_schema": SLO_SCHEMA, "slos": {}}
    doc["elastic"] = elastic_cfg
    doc["elastic_slos"] = elastic_slos
    return doc


def tighten_soak(slis: dict, soak_cfg: dict, contract_path: str):
    """Merge a fresh ``soak_slos`` section (plus the soak drill cfg)
    into the existing contract, leaving the cold/warm ``slos``
    untouched. Latency ceilings get 2x slack (floored at 0.5 s), the
    shed-rate ceiling +0.2; lost requests pin EXACTLY (zero is the
    invariant, not a budget)."""
    soak_slos = {}
    if slis.get("soak_warm_p99_s") is not None:
        soak_slos["soak_warm_p99_s"] = {"ceiling": round(
            max(2.0 * slis["soak_warm_p99_s"], 0.5), 4)}
    if slis.get("soak_queue_wait_p99_s") is not None:
        soak_slos["soak_queue_wait_p99_s"] = {"ceiling": round(
            max(2.0 * slis["soak_queue_wait_p99_s"], 0.5), 4)}
    if slis.get("soak_shed_rate") is not None:
        soak_slos["soak_shed_rate"] = {"ceiling": round(
            min(slis["soak_shed_rate"] + 0.2, 1.0), 4)}
    if slis.get("soak_lost_requests") is not None:
        soak_slos["soak_lost_requests"] = {
            "ceiling": int(slis["soak_lost_requests"])}
    try:
        doc = load_contract(contract_path)
    except FileNotFoundError:
        doc = {"slo_schema": SLO_SCHEMA, "slos": {}}
    doc["soak"] = soak_cfg
    doc["soak_slos"] = soak_slos
    return doc


def cmd_check(args) -> int:
    if getattr(args, "assim", False):
        return _check_assim(args)
    if getattr(args, "elastic", False):
        return _check_elastic(args)
    if getattr(args, "soak", False):
        return _check_soak(args)
    if args.ledger:
        from ibamr_tpu_torch.obs.bus import read_ledger
        slis = slis_from_ledger(read_ledger(args.ledger))
        drill_cfg = {"source": args.ledger}
    elif args.drill_json:
        with open(args.drill_json) as f:
            doc = json.load(f)
        drill = doc.get("serve", doc)   # bench artifact or raw drill
        slis = slis_from_drill(drill)
        drill_cfg = {"source": args.drill_json}
    else:
        from ibamr_tpu_torch.obs.bus import read_ledger
        with tempfile.TemporaryDirectory(prefix="slo-") as td:
            lp = os.path.join(td, "ledger.jsonl")
            run_drill_ledger(args, lp)
            records = read_ledger(lp)
        slis = slis_from_ledger(records)
        drill_cfg = {"n": args.n, "n_lat": args.n_lat,
                     "n_lon": args.n_lon, "lanes": args.lanes,
                     "steps": args.steps,
                     "warm_requests": args.warm_requests}

    if args.tighten:
        doc = tighten_contract(slis, drill_cfg)
        with open(args.contract, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"[slo] wrote {args.contract}")
        return 0

    try:
        contract = load_contract(args.contract)
    except FileNotFoundError:
        contract = None
    if contract is None:
        violations, unmeasurable, met = [], [], []
    else:
        violations, unmeasurable, met = evaluate(slis, contract)
    rc = (2 if violations
          else 1 if unmeasurable or contract is None
          else 0)
    if args.as_json:
        print(json.dumps({
            "exit": rc, "slis": slis,
            "violated": violations, "unmeasurable": unmeasurable,
            "met": met, "unbudgeted": contract is None},
            indent=1, sort_keys=True))
        return rc
    for line in violations:
        print(f"[slo] {line}")
    for line in unmeasurable:
        print(f"[slo] {line}")
    for line in met:
        print(f"[slo] {line}")
    if contract is None:
        print(f"[slo] no contract at {args.contract} — run --tighten "
              f"to pin")
    verdict = {0: "clean — every SLO attained",
               1: "unevaluable — missing contract or SLI "
                  "(run --tighten to pin)",
               2: "VIOLATED — the serving path is out of SLO"}[rc]
    print(f"[slo] {verdict}")
    return rc


def _check_assim(args) -> int:
    """The ``check --assim`` path: assimilation SLIs vs the
    contract's ``assim_slos`` section, same exit convention as the
    cold/warm check. Without ``--ledger`` the chaos assimilation
    drill runs first — its own pinned invariants (every injected bad
    obs rejected, the diverged member quarantined, zero lost cycles,
    one signature, filter beats open loop) raise before the budget is
    even consulted, so exit 2 here means a BUDGET regression on a
    drill that still satisfies the hard invariants."""
    from ibamr_tpu_torch.obs.bus import read_ledger

    if args.ledger:
        records = read_ledger(args.ledger)
        assim_cfg = {"source": args.ledger}
    else:
        with tempfile.TemporaryDirectory(prefix="slo-assim-") as td:
            run_assim_drill(args, td)
            records = read_ledger(
                os.path.join(td, "assim_ledger.jsonl"))
        assim_cfg = {"fleet_size": args.assim_fleet,
                     "cycles": args.assim_cycles}
    slis = assim_slis_from_ledger(records)

    if args.tighten:
        doc = tighten_assim(slis, assim_cfg, args.contract)
        with open(args.contract, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"[slo] wrote {args.contract} (assim_slos)")
        return 0

    try:
        contract = load_contract(args.contract)
    except FileNotFoundError:
        contract = None
    budget = (contract or {}).get("assim_slos")
    if not budget:
        violations, unmeasurable, met = [], [], []
    else:
        violations, unmeasurable, met = evaluate(slis, {"slos": budget})
    unbudgeted = not budget
    rc = (2 if violations
          else 1 if unmeasurable or unbudgeted
          else 0)
    if args.as_json:
        print(json.dumps({
            "exit": rc, "slis": slis,
            "violated": violations, "unmeasurable": unmeasurable,
            "met": met, "unbudgeted": unbudgeted},
            indent=1, sort_keys=True))
        return rc
    for line in violations + unmeasurable + met:
        print(f"[slo] {line}")
    if unbudgeted:
        print(f"[slo] no assim_slos in {args.contract} — run "
              f"--assim --tighten to pin")
    verdict = {0: "clean — every assimilation SLO attained",
               1: "unevaluable — missing assim_slos or SLI (run "
                  "--assim --tighten to pin)",
               2: "VIOLATED — the forecasting service is out of "
                  "SLO"}[rc]
    print(f"[slo] {verdict}")
    return rc


def _check_elastic(args) -> int:
    """The ``check --elastic`` path: elastic SLIs vs the contract's
    ``elastic_slos`` section, same exit convention as the cold/warm
    check. Without ``--ledger`` the bounded elastic drill runs first
    — its own pinned invariants raise before the budget is even
    consulted, so exit 2 here means a BUDGET regression on a drill
    that still satisfies the hard invariants."""
    from ibamr_tpu_torch.obs.bus import read_ledger

    if args.ledger:
        records = read_ledger(args.ledger)
        elastic_cfg = {"source": args.ledger}
    else:
        with tempfile.TemporaryDirectory(prefix="slo-elastic-") as td:
            run_elastic_drill(args, td)
            records = read_ledger(
                os.path.join(td, "elastic_ledger.jsonl"))
        elastic_cfg = {"duration_s": args.elastic_duration,
                       "rate_rps": args.elastic_rate,
                       "shift_frac": args.elastic_shift_frac,
                       "time_scale": args.elastic_time_scale}
    slis = elastic_slis_from_ledger(records)

    if args.tighten:
        doc = tighten_elastic(slis, elastic_cfg, args.contract)
        with open(args.contract, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"[slo] wrote {args.contract} (elastic_slos)")
        return 0

    try:
        contract = load_contract(args.contract)
    except FileNotFoundError:
        contract = None
    budget = (contract or {}).get("elastic_slos")
    if not budget:
        violations, unmeasurable, met = [], [], []
    else:
        violations, unmeasurable, met = evaluate(slis, {"slos": budget})
    unbudgeted = not budget
    rc = (2 if violations
          else 1 if unmeasurable or unbudgeted
          else 0)
    if args.as_json:
        print(json.dumps({
            "exit": rc, "slis": slis,
            "violated": violations, "unmeasurable": unmeasurable,
            "met": met, "unbudgeted": unbudgeted},
            indent=1, sort_keys=True))
        return rc
    for line in violations + unmeasurable + met:
        print(f"[slo] {line}")
    if unbudgeted:
        print(f"[slo] no elastic_slos in {args.contract} — run "
              f"--elastic --tighten to pin")
    verdict = {0: "clean — every elastic SLO attained",
               1: "unevaluable — missing elastic_slos or SLI (run "
                  "--elastic --tighten to pin)",
               2: "VIOLATED — the elastic serving path is out of "
                  "SLO"}[rc]
    print(f"[slo] {verdict}")
    return rc


def _check_soak(args) -> int:
    """The ``check --soak`` path: soak SLIs vs the contract's
    ``soak_slos`` section, same exit convention as the cold/warm
    check."""
    from ibamr_tpu_torch.obs.bus import read_ledger

    if args.ledger:
        records = read_ledger(args.ledger)
        soak_cfg = {"source": args.ledger}
    else:
        with tempfile.TemporaryDirectory(prefix="slo-soak-") as td:
            lp = os.path.join(td, "ledger.jsonl")
            run_soak_ledger(args, lp)
            records = read_ledger(lp)
        soak_cfg = {"seed": args.soak_seed,
                    "duration_s": args.soak_duration,
                    "rate_rps": args.soak_rate,
                    "burst_factor": args.soak_burst,
                    "time_scale": args.soak_time_scale,
                    "n": args.n, "n_lat": args.n_lat,
                    "n_lon": args.n_lon, "lanes": args.lanes}
    slis = soak_slis_from_ledger(records)

    if args.tighten:
        doc = tighten_soak(slis, soak_cfg, args.contract)
        with open(args.contract, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"[slo] wrote {args.contract} (soak_slos)")
        return 0

    try:
        contract = load_contract(args.contract)
    except FileNotFoundError:
        contract = None
    budget = (contract or {}).get("soak_slos")
    if not budget:
        violations, unmeasurable, met = [], [], []
    else:
        violations, unmeasurable, met = evaluate(slis, {"slos": budget})
    unbudgeted = not budget
    rc = (2 if violations
          else 1 if unmeasurable or unbudgeted
          else 0)
    if args.as_json:
        print(json.dumps({
            "exit": rc, "slis": slis,
            "violated": violations, "unmeasurable": unmeasurable,
            "met": met, "unbudgeted": unbudgeted},
            indent=1, sort_keys=True))
        return rc
    for line in violations + unmeasurable + met:
        print(f"[slo] {line}")
    if unbudgeted:
        print(f"[slo] no soak_slos in {args.contract} — run "
              f"--soak --tighten to pin")
    verdict = {0: "clean — every soak SLO attained",
               1: "unevaluable — missing soak_slos or SLI (run "
                  "--soak --tighten to pin)",
               2: "VIOLATED — the serving path is out of SLO under "
                  "sustained traffic"}[rc]
    print(f"[slo] {verdict}")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serving-path SLO gate: evaluate a ledger (or a "
                    "fresh drill) against the port's SLO.json")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("check", help="evaluate SLIs vs the contract "
                                     "(exit 0 clean / 1 unevaluable / "
                                     "2 violated)")
    c.add_argument("--contract", type=str, default=CONTRACT_PATH)
    c.add_argument("--ledger", type=str, default="",
                   help="evaluate an existing ledger.jsonl instead of "
                        "running a drill")
    c.add_argument("--drill-json", type=str, default="",
                   help="evaluate a saved drill/bench JSON instead of "
                        "running a drill")
    c.add_argument("--device", default="cuda",
                   help="where a fresh drill runs: cuda (the card, the "
                        "default) or cpu (the hermetic run)")
    c.add_argument("--n", type=int, default=8)
    c.add_argument("--n-lat", type=int, default=6)
    c.add_argument("--n-lon", type=int, default=8)
    c.add_argument("--lanes", type=int, default=2)
    c.add_argument("--steps", type=int, default=3)
    c.add_argument("--dt", type=float, default=5e-5)
    c.add_argument("--engine", type=str, default="",
                   help="engine name ('' = auto via the resolver)")
    c.add_argument("--warm-requests", type=int, default=8)
    c.add_argument("--soak", action="store_true",
                   help="run the bounded open-loop soak instead of "
                        "the cold/warm drill and evaluate the "
                        "soak_slos section")
    c.add_argument("--soak-duration", type=float, default=6.0,
                   help="virtual seconds of arrivals in the soak")
    c.add_argument("--soak-rate", type=float, default=6.0,
                   help="base arrival rate (requests per virtual s)")
    c.add_argument("--soak-seed", type=int, default=0)
    c.add_argument("--soak-burst", type=float, default=4.0,
                   help="rate multiplier inside the burst window")
    c.add_argument("--soak-time-scale", type=float, default=0.5,
                   help="wall seconds per virtual second (0.5 = "
                        "replay the schedule at 2x speed)")
    c.add_argument("--elastic", action="store_true",
                   help="run the elastic warm-pool drill (mix shift "
                        "+ memory pressure + restart) and evaluate "
                        "the elastic_slos section")
    c.add_argument("--elastic-duration", type=float, default=5.0,
                   help="virtual seconds of arrivals in the elastic "
                        "drill")
    c.add_argument("--elastic-rate", type=float, default=8.0,
                   help="base arrival rate (requests per virtual s)")
    c.add_argument("--elastic-shift-frac", type=float, default=0.4,
                   help="fraction of the run after which the mix "
                        "rotates to the unseen family")
    c.add_argument("--elastic-time-scale", type=float, default=0.5,
                   help="wall seconds per virtual second")
    c.add_argument("--assim", action="store_true",
                   help="run the chaos assimilation drill (all four "
                        "obs/member injectors armed) and evaluate "
                        "the assim_slos section")
    c.add_argument("--assim-fleet", type=int, default=6,
                   help="ensemble size B for the assimilation drill")
    c.add_argument("--assim-cycles", type=int, default=6,
                   help="observation cycles in the assimilation "
                        "drill")
    c.add_argument("--tighten", action="store_true",
                   help="rewrite the contract from the measured SLIs "
                        "(with slack on latency/ratio budgets)")
    c.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable report on stdout")
    c.set_defaults(fn=cmd_check)

    args = ap.parse_args(argv)
    if args.device == "cpu" and not (args.ledger or args.drill_json):
        # the drills serve from many request threads at once, each
        # running small ops: intra-op threads only contend for the cores
        import torch

        torch.set_num_threads(1)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
