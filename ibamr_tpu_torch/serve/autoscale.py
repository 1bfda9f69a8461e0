"""Elastic warm pools: traffic-driven autoscaling, brownout
degradation, and crash-safe router restart (port of
``ibamr_tpu/serve/autoscale.py``).

The router's admission control serves a FIXED set of bucket families;
this module closes the loop from observed traffic to warm capacity, in
four legs:

- **traffic-driven scaling** — :class:`MixEstimator` folds the
  router's ``request_admit`` stream into per-family EWMA arrival
  shares over deterministic virtual-time windows (a pure function of
  the ``(family, t)`` stream — no wall clock enters the estimate, so
  the same schedule replays the same decisions).
  :class:`ElasticPoolManager` grows hot families by building them
  ASYNCHRONOUSLY on the router's build threads through the
  ``ExecutableCache`` — serving never stalls on a grow, and a family is
  routable only once its pool is warm — and shrinks cold families under
  hysteresis (min-dwell since last arrival, never a family with a
  batch in flight), releasing their entries and bytes. Every decision
  is a ``pool_scale`` ledger record carrying the reason and the mix
  snapshot that justified it.
- **brownout degradation** — a pressure signal (queue-wait p99 from
  the live ``serve_queue_wait_seconds`` histogram delta + the build
  backlog + the executable-cache bytes watermark, which reads each
  pool's resident device bytes) moves the router through the explicit
  mode ladder ``healthy -> brownout -> shed_batch``: brownout caps
  batch-class cruise chunks to the warm length-1 ack (degraded
  throughput, ZERO new builds) and defers non-urgent pre-builds;
  shed_batch sheds batch tenants with ``shed_reason="brownout"`` so
  interactive p99 stays in band. Escalation is immediate,
  de-escalation waits out ``mode_min_dwell_s`` — the oscillation
  guard. Every transition is a ``serve_mode`` ledger record and the
  ``serve_mode`` gauge.
- **crash-safe restart** — :meth:`ElasticPoolManager.save_manifest`
  checkpoints the serving state (live families, tenant policies,
  scale-history digest) to ``serving_manifest.json`` via the atomic
  write discipline (tmp + fsync + replace, digest-protected like the
  executable cache's sidecars); :func:`restore_serving_manifest`
  rebuilds a fresh router from it and re-warms the working set with
  BOUNDED concurrency (no cold storm). PyTorch has no persistent
  compilation cache, so the port's meaning of a fresh build is the
  executable cache's ``cold_source``: ``"compile"`` for a family this
  cache directory has never seen, ``"persistent"`` for a family it has
  (a valid manifest sidecar predates the build). The restart drill pins
  zero fresh builds: every family re-warmed from a family this cache
  directory has seen, not served from a disk compile cache.

The capacity model that predicts what this machinery can sustain
lives in :mod:`ibamr_tpu_torch.serve.capacity`; the composed chaos
drill is ``ibamr_tpu_torch.tools.fault_injection.run_elastic_smoke``
and the ceilings live in the port's ``SLO.json`` ``elastic_slos``
(``python -m ibamr_tpu_torch.tools.slo check --elastic``).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import threading
import time
from dataclasses import asdict, dataclass
from typing import Callable, Optional, Sequence

from ibamr_tpu_torch import obs as _obs
from ibamr_tpu_torch.serve.router import (BucketSpec, TenantClassPolicy,
                                    WarmPoolRouter)
from ibamr_tpu_torch.utils.checkpoint import _atomic_write

SERVING_MANIFEST_SCHEMA = 1

# The mode ladder, in escalation order. Gauge value = list index, so
# the watchdog heartbeat and SLO gate read modes without string labels.
MODES = ("healthy", "brownout", "shed_batch")

_obs.describe("serve_families_live",
              "Warm pool families currently routable.")
_obs.describe("serve_precompiles_inflight",
              "Async pool builds currently in flight (the precompile "
              "backlog leg of the brownout pressure signal).")
_obs.describe("serve_mode",
              "Degradation mode: 0=healthy, 1=brownout, 2=shed_batch.")
_obs.describe("serve_pool_scale_total",
              "Elastic scaling decisions, by action=grow|warmed|"
              "shrink|deferred.")


@dataclass(frozen=True)
class ScalePolicy:
    """The committed elastic policy: when to grow/shrink and where the
    brownout ladder trips. Enter thresholds sit strictly above exit
    thresholds (the hysteresis dead band), and every dwell is in the
    SAME virtual-time units the estimator observes."""
    # -- mix estimation ----------------------------------------------------
    window_s: float = 0.5          # virtual-time window length
    ewma_alpha: float = 0.5        # per-window EWMA smoothing
    # -- grow / shrink -----------------------------------------------------
    grow_share: float = 0.10       # mix share that makes a family hot
    grow_min_arrivals: int = 2     # arrivals before a grow can trigger
    shrink_share: float = 0.02     # mix share below which a family is cold
    min_dwell_s: float = 3.0       # virtual dwell before a shrink
    # absolute no-arrivals horizon after which a family is cold even
    # if its NORMALIZED share stays high (proportional EWMA decay
    # preserves relative shares when the whole stream goes quiet, so
    # share alone can never expire the last traffic pattern seen)
    idle_evict_s: float = 30.0
    max_live_families: int = 8
    # -- brownout ladder (enter > exit: the dead band) ---------------------
    brownout_queue_p99_s: float = 1.0
    brownout_exit_queue_p99_s: float = 0.25
    brownout_backlog: int = 2      # builds in flight
    brownout_exit_backlog: int = 0
    brownout_cache_frac: float = 0.90   # bytes / max_bytes watermark
    brownout_exit_cache_frac: float = 0.70
    shed_queue_p99_s: float = 4.0
    shed_backlog: int = 4
    mode_min_dwell_s: float = 1.0  # de-escalation dwell (virtual s)
    urgent_share: float = 0.20     # brownout still grows above this
    batch_classes: Sequence[str] = ("batch",)
    # -- restart -----------------------------------------------------------
    restore_concurrency: int = 2   # bounded re-warm (no cold storm)


class MixEstimator:
    """Windowed EWMA arrival-mix estimator over DETERMINISTIC virtual
    time: arrivals land in window ``floor(t / window_s)``; when an
    observation crosses a window boundary the completed window's
    per-family shares fold into the EWMA (empty windows decay it
    toward zero). A pure function of the observed ``(family, t)``
    stream — replaying a schedule replays the mix bit-for-bit."""

    def __init__(self, window_s: float = 0.5, alpha: float = 0.5):
        self.window_s = float(window_s)
        self.alpha = float(alpha)
        self._ewma: dict = {}
        self._win_idx: Optional[int] = None
        self._win_counts: dict = {}
        self._totals: dict = {}

    def advance(self, t: float) -> None:
        """Roll the window clock forward to ``t`` WITHOUT an arrival:
        completed windows flush, arrival-free windows decay every
        family toward zero — a family nobody asks for cools at the
        same deterministic rate it heated. Idle ticks call this, so
        shrink decisions do not need traffic to age the mix."""
        idx = int(math.floor(float(t) / self.window_s))
        if self._win_idx is None:
            self._win_idx = idx
            return
        if idx > self._win_idx:
            self._flush()
            for _ in range(idx - self._win_idx - 1):
                self._decay()
            self._win_idx = idx

    def observe(self, family, t: float) -> None:
        self.advance(t)
        # late/out-of-order observations fold into the current window
        self._win_counts[family] = self._win_counts.get(family, 0) + 1
        self._totals[family] = self._totals.get(family, 0) + 1

    def _flush(self) -> None:
        total = sum(self._win_counts.values())
        shares = ({f: c / total for f, c in self._win_counts.items()}
                  if total else {})
        for f in set(self._ewma) | set(shares):
            self._ewma[f] = ((1.0 - self.alpha) * self._ewma.get(f, 0.0)
                             + self.alpha * shares.get(f, 0.0))
        self._win_counts = {}

    def _decay(self) -> None:
        for f in list(self._ewma):
            self._ewma[f] *= (1.0 - self.alpha)

    def mix(self) -> dict:
        """Normalized family -> share, blending the EWMA with the
        current (partial) window so a fresh burst registers before its
        window closes. Families below 1e-6 are dropped."""
        total = sum(self._win_counts.values())
        cur = ({f: c / total for f, c in self._win_counts.items()}
               if total else {})
        raw = {}
        for f in set(self._ewma) | set(cur):
            raw[f] = ((1.0 - self.alpha) * self._ewma.get(f, 0.0)
                      + self.alpha * cur.get(f, 0.0))
        norm = sum(raw.values())
        if norm <= 0:
            return {}
        return {f: v / norm for f, v in raw.items() if v / norm > 1e-6}

    def arrivals(self, family) -> int:
        """Total arrivals ever observed for ``family``."""
        return self._totals.get(family, 0)


def _spec_dict(spec: BucketSpec) -> dict:
    return asdict(spec)


def _scale_digest(events: Sequence[dict]) -> str:
    blob = json.dumps(events, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class ElasticPoolManager:
    """Closes the loop from observed traffic to warm capacity (module
    docstring has the four legs). Attach one manager per router; the
    router calls :meth:`observe_admit` per admitted request and
    consults :meth:`should_shed` / :meth:`cruise_cap` on the
    admission and cruise paths.

    All decision state is guarded by one re-entrant lock; grow builds
    run on the router's async build threads (one watcher thread per
    grow awaits publication and emits the ``warmed`` record), so a
    scaling decision NEVER blocks the admitting request."""

    def __init__(self, router: WarmPoolRouter,
                 policy: Optional[ScalePolicy] = None,
                 manifest_path: Optional[str] = None,
                 pressure_fn: Optional[Callable[[], dict]] = None):
        self.router = router
        self.policy = policy or ScalePolicy()
        self.manifest_path = manifest_path
        # test seam: override the measured pressure signal with a
        # synthetic one (the brownout mode-matrix drill)
        self.pressure_fn = pressure_fn
        self.estimator = MixEstimator(self.policy.window_s,
                                      self.policy.ewma_alpha)
        self._lock = threading.RLock()
        self.mode = "healthy"
        self._mode_since = 0.0
        self._now = 0.0                  # latest virtual time seen
        self.transitions: list = []      # (t, from, to, reason)
        self.scale_events: list = []     # digest material
        self._last_active: dict = {}     # family -> last admit t
        self._grown_at: dict = {}        # family -> warm-publication t
        self._growing: dict = {}         # family -> decision t
        self._deferred: list = []        # (family, t) parked in brownout
        self._watchers: list = []
        # queue-wait baseline = the histogram AS OF construction, so a
        # manager built late in a process (restart drill) measures its
        # own traffic's pressure, not the previous router's history
        snap = _obs.metrics_snapshot()["histograms"].get(
            "serve_queue_wait_seconds")
        self._qwait_counts: Optional[list] = (
            None if snap is None else list(snap["counts"]))
        self._t0 = time.monotonic()
        router.manager = self
        self._set_gauges()

    # -- observation --------------------------------------------------------

    def observe_admit(self, request, t: Optional[float] = None,
                      trace_id: Optional[str] = None) -> None:
        """Fold one admitted request into the mix estimate and run a
        scaling/mode tick. ``t`` is virtual seconds (tests, drills);
        when omitted, monotonic seconds since manager creation — the
        estimator never reads a clock itself."""
        if t is None:
            t = time.monotonic() - self._t0
        family = request.family()
        with self._lock:
            self._now = max(self._now, float(t))
            self.estimator.observe(family, t)
            self._last_active[family] = float(t)
            self._tick_locked(float(t), trace_id)

    def tick(self, t: Optional[float] = None) -> None:
        """Run one scaling/mode tick without an arrival (drain paths,
        tests). Idle traffic still exits brownout this way."""
        if t is None:
            t = time.monotonic() - self._t0
        with self._lock:
            self._now = max(self._now, float(t))
            self.estimator.advance(float(t))
            self._tick_locked(float(t), None)

    def _tick_locked(self, t: float, trace_id: Optional[str]) -> None:
        self._update_mode(t, trace_id)
        mix = self.estimator.mix()
        live = self.router.live_families()
        growing = dict(self._growing)
        # -- grow: hot families not yet routable ---------------------------
        for family, share in sorted(mix.items(), key=lambda kv: -kv[1]):
            if family in live or family in growing:
                continue
            if share < self.policy.grow_share:
                continue
            if (self.estimator.arrivals(family)
                    < self.policy.grow_min_arrivals):
                continue
            seen = self._last_active.get(family)
            if seen is not None and \
                    t - seen >= self.policy.idle_evict_s:
                # a normalized share survives a quiet stream forever
                # (see idle_evict_s) — never grow on stale share alone
                continue
            if (len(live) + len(growing)
                    >= self.policy.max_live_families):
                break
            if (self.mode != "healthy"
                    and share < self.policy.urgent_share):
                # brownout defers non-urgent pre-builds; the build
                # fires when the router de-escalates to healthy
                if family not in {f for f, _ in self._deferred}:
                    self._deferred.append((family, t))
                    self._emit_scale("deferred", family, t, "brownout",
                                     mix, trace_id)
                continue
            self._grow(family, t, "mix_shift", mix, trace_id)
            growing[family] = t
        # -- shrink: cold families past their dwell ------------------------
        for family, spec in live.items():
            if len(self.router.live_families()) <= 1:
                break                      # never scale to zero
            if self.router.family_inflight(family):
                continue                   # never the family serving now
            seen = max(self._last_active.get(family, 0.0),
                       self._grown_at.get(family, 0.0))
            if t - seen < self.policy.min_dwell_s:
                continue                   # hysteresis: min-dwell
            idle = (t - seen) >= self.policy.idle_evict_s
            if mix.get(family, 0.0) > self.policy.shrink_share \
                    and not idle:
                continue
            self._shrink(family, spec, t,
                         "idle_family" if idle else "cold_family",
                         mix, trace_id)
        self._set_gauges()

    # -- scaling ------------------------------------------------------------

    def _emit_scale(self, action: str, family, t: float, reason: str,
                    mix: dict, trace_id: Optional[str],
                    **extra) -> None:
        event = dict(action=action, family=str(family),
                     t=round(float(t), 4), reason=reason,
                     mix={str(f): round(s, 4) for f, s in mix.items()},
                     **extra)
        self.scale_events.append(event)
        _obs.counter("serve_pool_scale_total", action=action).inc()
        _obs.emit("pool_scale", trace_id=trace_id or None,
                  families_live=len(self.router.live_families()),
                  **event)

    def _grow(self, family, t: float, reason: str, mix: dict,
              trace_id: Optional[str]) -> None:
        spec = self.router._bucket_for(family,
                                       self.router.default_lanes)
        self._growing[family] = t
        self._emit_scale("grow", family, t, reason, mix, trace_id,
                         lanes=spec.lanes)
        wait = self.router._ensure_pool(
            spec, trace_ids=(trace_id,) if trace_id else ())
        t_wall = time.perf_counter()
        watcher = threading.Thread(
            target=self._await_grow,
            args=(family, spec, wait, t, t_wall, trace_id),
            daemon=True)
        self._watchers.append(watcher)
        watcher.start()

    def _await_grow(self, family, spec, wait, t_decided: float,
                    t_wall: float, trace_id: Optional[str]) -> None:
        """Grow watcher: awaits the async build's publication and
        stamps the family routable. Runs OFF the serving path — a
        failed build just clears the in-flight mark (the next hot
        tick retries)."""
        error = None
        try:
            wait()
        except Exception as e:  # noqa: BLE001 - retried by next tick
            error = f"{type(e).__name__}: {e}"
        warm_s = time.perf_counter() - t_wall
        with self._lock:
            self._growing.pop(family, None)
            if error is None:
                self._grown_at[family] = t_decided
            mix = self.estimator.mix()
            if error is None:
                self._emit_scale("warmed", family, t_decided,
                                 "build_done", mix, trace_id,
                                 warm_s=round(warm_s, 4))
            else:
                self._emit_scale("grow_failed", family, t_decided,
                                 "build_failed", mix, trace_id,
                                 error=error)
            self._set_gauges()

    def _shrink(self, family, spec, t: float, reason: str, mix: dict,
                trace_id: Optional[str]) -> None:
        released = self.router.release_pool(spec)
        # keep _last_active: arrival recency stays true across a
        # shrink, and the grow loop's stale-share guard needs it
        # (popping it would re-grow the family on the next tick)
        self._grown_at.pop(family, None)
        self._emit_scale("shrink", family, t, reason, mix, trace_id,
                         lanes=spec.lanes, released_entries=released)

    def drain(self, timeout_s: float = 60.0) -> int:
        """Join grow watchers + the router's build threads (process
        exit hygiene, same contract as ``router.drain_builds``)."""
        deadline = time.monotonic() + max(float(timeout_s), 0.0)
        alive = 0
        with self._lock:
            watchers = list(self._watchers)
        for w in watchers:
            w.join(max(deadline - time.monotonic(), 0.0))
            alive += int(w.is_alive())
        return alive + self.router.drain_builds(
            max(deadline - time.monotonic(), 0.0))

    # -- brownout ladder ----------------------------------------------------

    def pressure(self) -> dict:
        """The measured pressure signal: queue-wait p99 over the
        histogram DELTA since the last call (recent pressure, not
        process-lifetime), the build backlog, and the cache-bytes
        watermark fraction (the pools' resident bytes over the cache's
        ``max_bytes``; 0 when no ceiling is set)."""
        snap = _obs.metrics_snapshot()["histograms"].get(
            "serve_queue_wait_seconds")
        p99 = 0.0
        if snap is not None:
            counts = list(snap["counts"])
            base = self._qwait_counts
            delta = (counts if base is None else
                     [int(a) - int(b) for a, b in zip(counts, base)])
            self._qwait_counts = counts
            if sum(delta) > 0:
                (p99,) = _obs.quantiles_from_counts(delta, [0.99])
        cache = self.router.cache
        frac = 0.0
        max_bytes = getattr(cache, "max_bytes", None)
        if max_bytes:
            frac = cache.bytes() / float(max_bytes)
        return {"queue_p99_s": float(p99),
                "backlog": self.router.build_backlog(),
                "cache_frac": float(frac)}

    def _target_mode(self, p: dict) -> str:
        pol = self.policy
        if (p["queue_p99_s"] >= pol.shed_queue_p99_s
                or p["backlog"] >= pol.shed_backlog):
            return "shed_batch"
        if (p["queue_p99_s"] >= pol.brownout_queue_p99_s
                or p["backlog"] >= pol.brownout_backlog
                or p["cache_frac"] >= pol.brownout_cache_frac):
            return "brownout"
        if (p["queue_p99_s"] <= pol.brownout_exit_queue_p99_s
                and p["backlog"] <= pol.brownout_exit_backlog
                and p["cache_frac"] <= pol.brownout_exit_cache_frac):
            return "healthy"
        # dead band (between brownout exit and entry): brownout holds,
        # but shed_batch steps down — pressure below the BROWNOUT
        # entry can never justify the harsher mode (monotonicity)
        if self.mode == "shed_batch":
            return "brownout"
        return self.mode          # inside the dead band: hold

    def _update_mode(self, t: float, trace_id: Optional[str]) -> None:
        p = (self.pressure_fn() if self.pressure_fn is not None
             else self.pressure())
        target = self._target_mode(p)
        cur, tgt = MODES.index(self.mode), MODES.index(target)
        if tgt > cur:
            nxt = MODES[cur + 1]       # escalate one rung, immediately
        elif tgt < cur:
            # de-escalation waits out the dwell: the oscillation guard
            if t - self._mode_since < self.policy.mode_min_dwell_s:
                return
            nxt = MODES[cur - 1]
        else:
            return
        prev, self.mode = self.mode, nxt
        self._mode_since = t
        self.transitions.append((round(float(t), 4), prev, nxt))
        _obs.emit("serve_mode", trace_id=trace_id or None,
                  t=round(float(t), 4), mode=nxt, prev=prev,
                  queue_p99_s=round(p["queue_p99_s"], 4),
                  backlog=int(p["backlog"]),
                  cache_frac=round(p["cache_frac"], 4))
        _obs.gauge("serve_mode").set(MODES.index(nxt))
        if nxt == "healthy" and self._deferred:
            deferred, self._deferred = self._deferred, []
            mix = self.estimator.mix()
            for family, _ in deferred:
                if (family not in self.router.live_families()
                        and family not in self._growing
                        and mix.get(family, 0.0)
                        >= self.policy.shrink_share):
                    self._grow(family, t, "deferred_resume", mix,
                               trace_id)

    # -- router consultation seams ------------------------------------------

    def should_shed(self, tenant_class: str) -> bool:
        """True when the current mode sheds this class pre-admission
        (``shed_reason="brownout"``): shed_batch sheds batch tenants;
        interactive traffic is never mode-shed."""
        return (self.mode == "shed_batch"
                and tenant_class in self.policy.batch_classes)

    def cruise_cap(self, tenant_classes: Sequence[str]) -> Optional[int]:
        """Chunk-length cap for a packed batch: under brownout (or
        worse) an all-batch batch cruises on the already-warm
        length-1 ack chunk — degraded throughput, zero fresh builds.
        Mixed batches keep full cruise (an interactive member must not
        pay the degradation)."""
        if self.mode == "healthy" or not tenant_classes:
            return None
        if all(c in self.policy.batch_classes for c in tenant_classes):
            return 1
        return None

    def _set_gauges(self) -> None:
        _obs.gauge("serve_families_live").set(
            len(self.router.live_families()))
        _obs.gauge("serve_precompiles_inflight").set(
            self.router.build_backlog())
        _obs.gauge("serve_mode").set(MODES.index(self.mode))

    # -- crash-safe restart --------------------------------------------------

    def manifest(self) -> dict:
        """The serving-state snapshot ``save_manifest`` persists: live
        families (full BucketSpecs), tenant policies, the mode, and a
        digest over the scale-event history (restore proves it resumed
        the same story, not a look-alike)."""
        with self._lock:
            live = self.router.live_specs()
            policies = {cls: asdict(pol) for cls, pol
                        in self.router.admission._policies.items()}
            return {
                "manifest_schema": SERVING_MANIFEST_SCHEMA,
                "families": [_spec_dict(s) for s in live],
                "policies": policies,
                "mode": self.mode,
                "scale_events": len(self.scale_events),
                "scale_digest": _scale_digest(self.scale_events),
                "cache_dir": getattr(self.router.cache, "directory",
                                     None),
                "saved_t": round(self._now, 4),
            }

    def save_manifest(self, path: Optional[str] = None) -> str:
        """Checkpoint the serving state to ``serving_manifest.json``:
        atomic tmp + fsync + replace with a whole-body digest (the
        executable cache's sidecar discipline) — a torn
        or tampered manifest is refused at restore, never restored
        wrong."""
        path = path or self.manifest_path
        if not path:
            raise ValueError("no manifest path configured")
        body = self.manifest()
        blob = json.dumps(body, sort_keys=True)
        doc = {"digest": hashlib.sha256(blob.encode()).hexdigest(),
               "body": body}
        payload = json.dumps(doc, indent=1, sort_keys=True).encode()
        _atomic_write(path, lambda f: f.write(payload))
        _obs.emit("serving_manifest", path=os.path.basename(path),
                  families=len(body["families"]),
                  scale_digest=body["scale_digest"])
        return path


def read_serving_manifest(path: str) -> dict:
    """Digest-verified manifest body. Raises ``ValueError`` on a torn,
    tampered, or wrong-schema manifest — corruption never restores."""
    with open(path) as f:
        doc = json.load(f)
    body = doc.get("body")
    if body is None:
        raise ValueError("serving manifest has no body")
    blob = json.dumps(body, sort_keys=True)
    if doc.get("digest") != hashlib.sha256(blob.encode()).hexdigest():
        raise ValueError("serving manifest digest mismatch")
    if body.get("manifest_schema") != SERVING_MANIFEST_SCHEMA:
        raise ValueError(
            f"unknown serving manifest schema "
            f"{body.get('manifest_schema')!r}")
    return body


def restore_serving_manifest(path: str, cache=None,
                             policy: Optional[ScalePolicy] = None,
                             concurrency: Optional[int] = None,
                             warm: bool = True, device="cuda",
                             dtype=None):
    """Rebuild a router + manager from a serving manifest and re-warm
    the persisted working set with BOUNDED concurrency (at most
    ``concurrency`` builds in flight — a restart must not cold-storm
    the build executor). The pools are built on ``device`` at
    ``dtype`` (the GPU and f32 unless given). Returns ``(router,
    manager, stats)``; stats carries ``fresh_compiles``: cache entries
    whose ``cold_source`` is ``"compile"``, i.e. built with no valid
    manifest sidecar in the cache directory. In the port that count
    means families re-warmed that this cache directory has never seen
    (PyTorch has no disk compile cache to serve a build from); the
    restart drill pins it to ZERO when the cache's manifests survive
    the crash."""
    from ibamr_tpu_torch.serve import aot_cache

    body = read_serving_manifest(path)
    specs = [BucketSpec(**f) for f in body["families"]]
    policies = {cls: TenantClassPolicy(**p)
                for cls, p in body["policies"].items()}
    if cache is None:
        cache = aot_cache.ExecutableCache(
            directory=body.get("cache_dir"))
    router = WarmPoolRouter(specs, cache=cache, policies=policies,
                            device=device, dtype=dtype)
    manager = ElasticPoolManager(router, policy=policy,
                                 manifest_path=path)
    pol = manager.policy
    width = max(1, int(concurrency if concurrency is not None
                       else pol.restore_concurrency))
    t0 = time.perf_counter()
    errors: list = []
    if warm:
        with _obs.span("serve/restore", families=len(specs),
                       concurrency=width):
            for i in range(0, len(specs), width):
                waits = [router._ensure_pool(s)
                         for s in specs[i:i + width]]
                for w in waits:
                    try:
                        w()
                    except Exception as e:  # noqa: BLE001 - reported
                        errors.append(f"{type(e).__name__}: {e}")
    warm_s = time.perf_counter() - t0
    fresh = persistent = 0
    for key in cache.keys():
        ent = cache.get(key)
        if ent is None:
            continue
        if ent.cold_source == "compile":
            fresh += 1
        else:
            persistent += 1
    stats = {"families": len(specs),
             "warmed": len(router.live_specs()),
             "fresh_compiles": fresh,
             "persistent_loads": persistent,
             "warm_s": round(warm_s, 4),
             "concurrency": width,
             "scale_digest": body["scale_digest"],
             "errors": errors[:5]}
    manager._set_gauges()
    _obs.emit("serving_restore", **stats)
    return router, manager, stats
