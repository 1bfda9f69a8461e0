"""Deterministic open-loop load generator for the warm-pool router
(port of ``ibamr_tpu/serve/loadgen.py``).

- **arrivals** — :func:`poisson_burst_schedule` draws a seeded Poisson
  process (exponential inter-arrival gaps from
  ``np.random.default_rng(seed)``) with named burst windows where the
  instantaneous rate multiplies by ``burst_factor``. The schedule is a
  pure function of its arguments — virtual timestamps, no wall clock —
  and draws exactly the reference's numbers: the same seed gives the
  reference's schedule bit for bit.
- **scenario mix** — :data:`SCENARIO_MIX` is heavy-tailed in service
  demand (steps per request), modeled on the repo's example drivers:
  most arrivals are short interactive probes, a minority are long batch
  campaign chunks. Every mix entry shares ONE scenario family (shape,
  physics), so a bounded soak pays exactly one bucket build and then
  rides the zero-build warm path — heterogeneous ``steps``/``dt`` are
  per-lane values and never change a signature.
- **open loop** — :func:`run_open_loop` submits each arrival at its
  scheduled (scaled) time from its own thread regardless of earlier
  completions, which is what makes overload REAL: a closed loop would
  politely self-throttle and never exercise admission control. Thread
  count is bounded; saturation is counted, never silently dropped.
- **the soak** — :func:`soak_drill` composes the above against a fresh
  router with committed tenant-class policies and returns the traffic
  summary ``python -m ibamr_tpu_torch.tools.slo check --soak``
  evaluates. Chaos (build storms, killed builds, stragglers) rides on
  top in ``ibamr_tpu_torch.tools.fault_injection.run_soak_smoke``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np

from ibamr_tpu_torch import obs as _obs
from ibamr_tpu_torch.serve.router import (BucketSpec, ScenarioRequest,
                                    TenantClassPolicy, WarmPoolRouter)

# ---------------------------------------------------------------------------
# scenario mix: heavy-tailed service demand over ONE warm family
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Scenario:
    """One entry of the load mix: a named request template with a
    sampling weight. ``name`` references the example-driver scale the
    entry is modeled on; ``steps`` carries the heavy tail.

    ``family`` optionally overrides the bucket-family fields
    of generated requests (any of ``n_cells``/``n_lat``/``n_lon``/
    ``engine``/``spectral_dtype``/``mu`` as a mapping) — the
    mix-shift soak routes part of the mix onto families the router
    has never built. ``None`` (the default) keeps the schedule's
    single shared family exactly as before."""
    name: str
    weight: float
    tenant_class: str
    steps: int
    dt: float = 5e-5
    deadline_s: Optional[float] = None
    family: Optional[tuple] = None      # (("n_lon", 12), ...) mapping


# Heavy-tailed mix (weights sum to 1): ~80% short interactive probes,
# ~20% long batch chunks with 3-8x the service demand — the shape of
# the example-driver population (many small demo probes, few long
# campaign sweeps), restated as one bucket family.
SCENARIO_MIX: Sequence[Scenario] = (
    Scenario("ib/shell_probe", 0.55, "interactive", steps=1),
    Scenario("navier_stokes/cavity_ack", 0.25, "interactive", steps=2),
    Scenario("adv_diff/batch_sweep", 0.15, "batch", steps=4),
    Scenario("ibfe/campaign_chunk", 0.05, "batch", steps=8),
)


@dataclass(frozen=True)
class Arrival:
    """One scheduled submission: virtual time + the request to send."""
    t: float
    scenario: str
    request: ScenarioRequest


def poisson_burst_schedule(seed: int, duration_s: float,
                           rate_rps: float,
                           burst_factor: float = 4.0,
                           burst_start_frac: float = 0.4,
                           burst_len_frac: float = 0.3,
                           mix: Sequence[Scenario] = SCENARIO_MIX,
                           n_cells: int = 8, n_lat: int = 6,
                           n_lon: int = 8,
                           tenants_per_class: int = 2,
                           tenant_prefix: str = "",
                           mix_schedule: Optional[Sequence] = None) -> list:
    """Seeded Poisson arrivals over ``[0, duration_s)`` virtual
    seconds at ``rate_rps``, multiplied by ``burst_factor`` inside the
    burst window (``[start_frac, start_frac + len_frac) * duration``).
    Deterministic: a pure function of the arguments.

    ``mix_schedule`` makes the mix PIECEWISE in virtual time:
    a sequence of ``(start_frac, mix)`` pairs, each active from
    ``start_frac * duration_s`` until the next — the mix-shift soak
    rotates arrivals onto unseen families mid-run this way. ``None``
    (the default) uses ``mix`` throughout with the same rng draw
    sequence as a single-mix schedule."""
    rng = np.random.default_rng(int(seed))
    if mix_schedule is None:
        segments = [(0.0, tuple(mix))]
    else:
        segments = sorted(((float(f), tuple(m))
                           for f, m in mix_schedule),
                          key=lambda seg: seg[0])
        if not segments or segments[0][0] > 0.0:
            segments.insert(0, (0.0, tuple(mix)))
    seg_weights = []
    for _, m in segments:
        w = np.asarray([s.weight for s in m], dtype=float)
        seg_weights.append(w / w.sum())
    b0 = burst_start_frac * duration_s
    b1 = b0 + burst_len_frac * duration_s
    arrivals: list = []
    t = 0.0
    k = 0
    while True:
        rate = rate_rps * (burst_factor if b0 <= t < b1 else 1.0)
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        if t >= duration_s:
            break
        active = 0
        for si, (frac, _) in enumerate(segments):
            if t >= frac * duration_s:
                active = si
        seg_mix, weights = segments[active][1], seg_weights[active]
        sc = seg_mix[int(rng.choice(len(seg_mix), p=weights))]
        fam = dict(sc.family) if sc.family else {}
        tenant = (f"{tenant_prefix}{sc.tenant_class}"
                  f"-{k % max(tenants_per_class, 1)}")
        arrivals.append(Arrival(
            t=t, scenario=sc.name,
            request=ScenarioRequest(
                tenant=tenant,
                n_cells=fam.get("n_cells", n_cells),
                n_lat=fam.get("n_lat", n_lat),
                n_lon=fam.get("n_lon", n_lon),
                steps=sc.steps, dt=sc.dt,
                engine=fam.get("engine"),
                spectral_dtype=fam.get("spectral_dtype"),
                mu=fam.get("mu", 0.05),
                tenant_class=sc.tenant_class,
                deadline_s=sc.deadline_s)))
        k += 1
    return arrivals


# ---------------------------------------------------------------------------
# open-loop driver
# ---------------------------------------------------------------------------


def run_open_loop(router: WarmPoolRouter, arrivals: Sequence[Arrival],
                  time_scale: float = 1.0, max_threads: int = 32,
                  join_timeout_s: float = 120.0) -> dict:
    """Fire ``arrivals`` at the router open-loop: each submission at
    ``t * time_scale`` wall seconds after start, from its own bounded
    worker thread, independent of earlier completions. Returns
    ``{"results": [RequestResult...], "wall_s", "overruns",
    "hung_threads"}`` — ``hung_threads > 0`` means a worker failed to
    finish inside ``join_timeout_s`` (the soak drill's deadlock
    tripwire); ``overruns`` counts submissions that could not start on
    schedule because all workers were busy (they still run, late)."""
    results: list = []
    errors: list = []
    lock = threading.Lock()
    gate = threading.Semaphore(int(max_threads))
    overruns = [0]
    t0 = time.perf_counter()

    def fire(arr: Arrival):
        try:
            out = router.serve([arr.request])
            with lock:
                results.extend(out)
        except Exception as e:  # noqa: BLE001 - counted, not fatal
            with lock:
                errors.append(f"{type(e).__name__}: {e}")
        finally:
            gate.release()

    threads = []
    for arr in arrivals:
        delay = arr.t * time_scale - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        if not gate.acquire(blocking=False):
            overruns[0] += 1
            gate.acquire()          # open loop saturated: run late
        th = threading.Thread(target=fire, args=(arr,), daemon=True)
        th.start()
        threads.append(th)
    deadline = time.monotonic() + join_timeout_s
    hung = 0
    for th in threads:
        th.join(max(deadline - time.monotonic(), 0.0))
        if th.is_alive():
            hung += 1
    return {"results": results, "errors": errors,
            "wall_s": time.perf_counter() - t0,
            "overruns": overruns[0], "hung_threads": hung}


def _quantile(values, q):
    if not values:
        return None
    vs = sorted(values)
    import math
    return vs[min(len(vs) - 1, max(0, math.ceil(q * len(vs)) - 1))]


def traffic_summary(results, wall_s: float) -> dict:
    """Per-class traffic rollup of a result list: completed/shed/
    quarantined counts, shed rate, warm first-step and queue-wait
    percentiles — the shape the soak artifact carries."""
    total = len(results)
    shed = [r for r in results if r.shed]
    served = [r for r in results if not r.shed]
    by_reason: dict = {}
    for r in shed:
        by_reason[r.shed_reason] = by_reason.get(r.shed_reason, 0) + 1
    classes: dict = {}
    for r in results:
        # RequestResult has no class field; recover it from shed
        # records vs served tenants (tenant names are class-prefixed
        # by the schedule generator)
        cls = r.tenant.rsplit("-", 1)[0]
        c = classes.setdefault(cls, {"submitted": 0, "completed": 0,
                                     "shed": 0, "quarantined": 0,
                                     "retried": 0})
        c["submitted"] += 1
        if r.shed:
            c["shed"] += 1
        else:
            c["completed"] += 1
        if r.quarantined:
            c["quarantined"] += 1
        if r.retries:
            c["retried"] += 1
    warm_first = [r.first_step_s for r in served
                  if not r.cold and r.first_step_s is not None]
    qwaits = [r.queue_wait_s for r in results
              if r.queue_wait_s is not None]
    return {
        "submitted": total,
        "completed": len(served),
        "ok": sum(1 for r in served if r.ok),
        "shed": len(shed),
        "shed_rate": round(len(shed) / total, 4) if total else None,
        "shed_by_reason": by_reason,
        "quarantined": sum(1 for r in results if r.quarantined),
        "retried": sum(1 for r in results if r.retries),
        "requests_per_s": (round(len(served) / wall_s, 3)
                           if wall_s > 0 else None),
        "warm_first_step_p50_s": _round(_quantile(warm_first, 0.5)),
        "warm_first_step_p99_s": _round(_quantile(warm_first, 0.99)),
        "queue_wait_p99_s": _round(_quantile(qwaits, 0.99)),
        "classes": classes,
    }


def _round(v, nd: int = 6):
    return None if v is None else round(float(v), nd)


# ---------------------------------------------------------------------------
# the bounded soak drill (python -m ibamr_tpu_torch.tools.slo check --soak)
# ---------------------------------------------------------------------------

# Committed soak policies: interactive traffic is slot-bounded with a
# strict-ish deadline and one retry; batch traffic queues deeper and
# waits longer. The drill ships these so the gate measures the SAME
# admission behavior every round.
SOAK_POLICIES = {
    "interactive": TenantClassPolicy(
        max_inflight=4, queue_depth=16, queue_timeout_s=30.0,
        deadline_s=30.0, retry_budget=1),
    "batch": TenantClassPolicy(
        max_inflight=2, queue_depth=8, queue_timeout_s=60.0,
        deadline_s=60.0, retry_budget=1),
    "chaos": TenantClassPolicy(
        max_inflight=2, queue_depth=2, queue_timeout_s=5.0,
        deadline_s=5.0, retry_budget=1),
}


def soak_drill(seed: int = 0, duration_s: float = 6.0,
               rate_rps: float = 6.0, burst_factor: float = 4.0,
               n_cells: int = 8, n_lat: int = 6, n_lon: int = 8,
               lanes: int = 2, cache_dir: Optional[str] = None,
               time_scale: float = 1.0,
               policies: Optional[dict] = None,
               mix: Sequence[Scenario] = SCENARIO_MIX,
               router: Optional[WarmPoolRouter] = None,
               warm: bool = True, device="cuda") -> dict:
    """One bounded deterministic soak: a fresh router (unless one is
    injected) on ``device`` (the GPU unless ``device="cpu"``) with the
    committed :data:`SOAK_POLICIES`, pre-warmed,
    driven open-loop by a seeded Poisson + ``burst_factor``x burst
    schedule over the heavy-tailed mix. Returns the traffic summary
    plus config echo; with a ledger attached
    (``obs.ledger(path)``), the soak SLIs are computable from the
    ledger alone (``tools/slo.py soak_slis_from_ledger``)."""
    from ibamr_tpu_torch.serve import aot_cache

    if router is None:
        spec = BucketSpec(n_cells=n_cells, n_lat=n_lat, n_lon=n_lon,
                          lanes=lanes, chunk_steps=2)
        router = WarmPoolRouter(
            [spec], cache=aot_cache.ExecutableCache(directory=cache_dir),
            allow_dynamic=True,
            policies=dict(policies if policies is not None
                          else SOAK_POLICIES),
            device=device)
        if warm:
            with _obs.span("soak/warm"):
                router.warm(spec)
    arrivals = poisson_burst_schedule(
        seed=seed, duration_s=duration_s, rate_rps=rate_rps,
        burst_factor=burst_factor, mix=mix, n_cells=n_cells,
        n_lat=n_lat, n_lon=n_lon)
    with _obs.span("soak/open_loop", arrivals=len(arrivals)):
        run = run_open_loop(router, arrivals, time_scale=time_scale)
    # shed requests can leave bucket builds in flight; drain them so
    # a soak process exits cleanly (a daemon thread mid-build at
    # interpreter teardown can abort the process)
    router.drain_builds(timeout_s=60.0)
    out = traffic_summary(run["results"], run["wall_s"])
    out.update({
        "seed": int(seed), "duration_s": duration_s,
        "rate_rps": rate_rps, "burst_factor": burst_factor,
        "arrivals": len(arrivals), "wall_s": round(run["wall_s"], 3),
        "overruns": run["overruns"], "hung_threads": run["hung_threads"],
        "loadgen_errors": run["errors"][:5],
    })
    return out


def chaos_mix(base: Sequence[Scenario] = SCENARIO_MIX,
              novel_families: int = 3) -> list:
    """The chaos tenant's mix: the base mix re-classed to ``chaos``
    plus requests that will land on NOVEL dynamic families (distinct
    ``n_lon``), each a fresh bucket build — the build-storm fuel.
    Returned scenarios carry ``steps`` tags the schedule generator
    maps onto distinct families via :func:`chaos_requests`."""
    out = [replace(s, tenant_class="chaos", weight=s.weight * 0.5)
           for s in base]
    for i in range(novel_families):
        out.append(Scenario(f"chaos/novel_family_{i}",
                            weight=0.5 / max(novel_families, 1),
                            tenant_class="chaos", steps=1))
    return out
