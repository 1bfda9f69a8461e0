"""Warm-pool scenario router: scenario requests onto warm fleet-lane
buckets (port of ``ibamr_tpu/serve/router.py``).

Request lifecycle:

1. **submit** — requests are grouped by scenario family (shape,
   engine, spectral dtype, physics constants baked into the integrator).
2. **bucket** — each group is packed into the nearest declared
   ``(family, B)`` bucket: smallest ``B >= group size``; oversize
   groups split across batches; short groups are PADDED to ``B`` with
   copies of their last lane marked not-alive
   (:func:`ibamr_tpu_torch.utils.lanes.pad_lanes`) — the fleet chunk's
   alive mask freezes padding.
3. **warm / miss** — a warm bucket serves immediately from its warm
   lane chunks; a miss builds ASYNCHRONOUSLY (one background build per
   bucket, published to the shared
   :class:`~ibamr_tpu_torch.serve.aot_cache.ExecutableCache`) while the
   requests wait — the build lands in the cold requests'
   request-to-first-step latency and nowhere else. A build in the port
   is the pool's integrator, its template and one warm-up call of each
   chunk length (the kernels' build, the cuFFT plans, the layouts): the
   fleet chunk reads dt and the alive mask on the host and steps its
   lanes in a Python loop, so it is never captured as a CUDA graph, and
   a capture on a build thread would also break the launches of the
   threads serving beside it. Every pool entry is a warm EAGER callable.
4. **run** — the warm chunk advances all lanes; per-lane finite health
   quarantines a bad tenant's lane (the fleet chunk steps each lane
   alone and freezes dead lanes with ``torch.where``, a select) without
   perturbing neighbours. Per-lane dt and the alive mask are host numpy
   arrays: heterogeneous requests never change a signature, and a
   served chunk reads the device exactly once (its health vector). One
   chunk runs at a time in the process: eager chunks from many request
   threads at once only queue for the GIL and the one device stream.
5. **account** — every request emits a ``request`` ledger record
   (tenant, family key, bucket, lane, cold/warm, first-step and total
   latency, steps, verdict) plus ``serve_*_total`` counters.

The router runs only chunk lengths it warmed (1 for the first-step
ack, ``chunk_steps`` for cruise), so a warm second request of the same
family performs ZERO builds — pinned structurally by ``python -m
ibamr_tpu_torch.tools.serve check`` against the port's
``SERVE_CONTRACT.json``.

Each pool's cache entries carry the device bytes the pool pins (its
template, the lane-stacked template of a served batch, the spectral
plan's k-space tables for its grid, its force specs and its packed
marker layout), split across its ack and cruise entries, so
``cache.bytes()``, :meth:`WarmPoolRouter.release_pool` and the elastic
manager's bytes watermark see real memory.

Traffic robustness: step 1 above is a real admission gate. Every
request belongs to a **tenant class** (``ScenarioRequest.tenant_class``)
with a :class:`TenantClassPolicy`: a bounded inflight-slot pool plus a
bounded wait queue (overflow or timeout SHEDS the request —
``serve_shed_total{reason=...}`` / a terminal ``request_shed`` ledger
record, queue time on ``serve_queue_wait_seconds``), an
admission-to-first-step **deadline budget** (enforced at the two
host-side wait points: the admission queue and the bucket-build wait;
an ack chunk already in flight is never cancelled), and a **retry
budget** with deterministic jittered backoff for transient failures (a
failed or killed async pool build, a quarantined-lane landing) so a
build storm cannot amplify itself. A quarantined or shed request
RELEASES its admission slot immediately and wakes one queued waiter
(``serve_slots_reclaimed_total``). Every admitted ``trace_id`` reaches
exactly one terminal record kind (``request`` or ``request_shed``) even
when ``serve`` raises: the no-lost-request invariant the soak drill
(``tools.fault_injection.run_soak_smoke``) pins.

Elastic pools: an optional
:class:`~ibamr_tpu_torch.serve.autoscale.ElasticPoolManager` attaches as
``router.manager`` and closes the loop from the admit stream to warm
capacity — grow pre-builds hot families async (the family is routable
only once warm), shrink releases cold pools via
:meth:`WarmPoolRouter.release_pool` (never a family with a batch in
flight — ``family_inflight``), and the brownout mode ladder caps batch
cruise chunks to the warm length-1 ack and sheds batch tenants
pre-admission with ``shed_reason="brownout"``.

Pools are built on ``device`` (the GPU unless the caller passes
``device="cpu"``) at ``dtype`` (f32 unless given); neither enters a
bucket's family.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ibamr_tpu_torch import obs as _obs
from ibamr_tpu_torch.serve import aot_cache
from ibamr_tpu_torch.utils import lanes as _lanes

_REQS = _obs.counter("serve_requests_total")
_COLD = _obs.counter("serve_cold_requests_total")
_QUAR = _obs.counter("serve_quarantined_total")
_PADS = _obs.counter("serve_padded_lanes_total")

# Request-latency distributions. Handles are module-cached —
# ``reset_metrics`` zeroes values in place, so these stay live.
_H_REQ = {p: _obs.histogram("serve_request_seconds", path=p)
          for p in ("cold", "warm")}
_H_FIRST = {p: _obs.histogram("serve_first_step_seconds", path=p)
            for p in ("cold", "warm")}
_H_WAIT = _obs.histogram("serve_bucket_wait_seconds")
_H_PADFRAC = _obs.histogram("serve_padding_fraction")
_H_QWAIT = _obs.histogram("serve_queue_wait_seconds")
_RECLAIMS = _obs.counter("serve_slots_reclaimed_total")
_obs.describe("serve_requests_total", "Requests completed by the router.")
_obs.describe("serve_cold_requests_total",
              "Requests that paid a bucket compile (cold path).")
_obs.describe("serve_quarantined_total",
              "Requests whose lane was quarantined mid-flight.")
_obs.describe("serve_padded_lanes_total",
              "Dead padding lanes stepped alongside live requests.")
_obs.describe("serve_request_seconds",
              "End-to-end request latency (submit to completion), "
              "by path=cold|warm.")
_obs.describe("serve_first_step_seconds",
              "Request-to-first-step ack latency, by path=cold|warm.")
_obs.describe("serve_bucket_wait_seconds",
              "Wait for the bucket's warm pool (compile time on a miss).")
_obs.describe("serve_padding_fraction",
              "Per-batch fraction of bucket lanes that were padding.")
_obs.describe("serve_requests_inflight",
              "Requests admitted and not yet completed.")
_obs.describe("serve_requests_completed",
              "Requests completed since process start.")
_obs.describe("serve_shed_total",
              "Requests shed by admission control, by reason="
              "queue_full|queue_timeout|deadline_exceeded|"
              "build_failed|no_bucket|router_error|brownout.")
_obs.describe("serve_queue_wait_seconds",
              "Admission-queue wait per request (0 for immediate "
              "admission).")
_obs.describe("serve_retries_total",
              "Retry hops taken for transient failures, by "
              "reason=build_failed|lane_quarantined.")
_obs.describe("serve_slots_reclaimed_total",
              "Admission slots reclaimed from quarantined/shed "
              "requests and handed to queued waiters.")
_obs.describe("serve_requests_queued",
              "Requests currently waiting in an admission queue.")
_obs.describe("serve_requests_shed",
              "Requests shed since process start (cumulative gauge "
              "for the watchdog heartbeat).")


class PoolWaitTimeout(Exception):
    """A request's deadline budget expired while its bucket's warm
    pool was still building (the admission-to-first-step timeout)."""


@dataclass(frozen=True)
class TenantClassPolicy:
    """Admission policy for one tenant class.

    ``max_inflight`` caps concurrently-admitted requests of the class;
    beyond it, up to ``queue_depth`` requests WAIT (bounded by
    ``queue_timeout_s`` and the per-request deadline) and the rest are
    shed immediately (``queue_full``). ``deadline_s`` is the default
    admission-to-first-step budget (a request's own ``deadline_s``
    wins). ``retry_budget`` bounds jittered-backoff retries of
    transient failures — 0 (the default) fails fast."""
    max_inflight: int = 1 << 20
    queue_depth: int = 1 << 20
    queue_timeout_s: float = 120.0
    deadline_s: Optional[float] = None
    retry_budget: int = 0
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 0.5


DEFAULT_POLICY = TenantClassPolicy()


class _ClassState:
    __slots__ = ("inflight", "queued", "cond")

    def __init__(self, lock):
        self.inflight = 0
        self.queued = 0
        self.cond = threading.Condition(lock)


class AdmissionController:
    """Per-tenant-class bounded admission: inflight slots + a bounded
    wait queue, one condition variable per class (shared lock). All
    waits are time-bounded, so admission can never deadlock — the
    worst case is a shed."""

    def __init__(self, policies=None, default: TenantClassPolicy = DEFAULT_POLICY):
        self._policies = dict(policies or {})
        self._default = default
        self._lock = threading.Lock()
        self._classes: dict = {}

    def policy(self, cls: str) -> TenantClassPolicy:
        return self._policies.get(cls, self._default)

    def _state_locked(self, cls: str) -> _ClassState:
        st = self._classes.get(cls)
        if st is None:
            st = self._classes[cls] = _ClassState(self._lock)
        return st

    def admit(self, cls: str, deadline_left: Optional[float] = None):
        """Try to take an inflight slot for ``cls``; queue (bounded)
        when the class is saturated. Returns ``(admitted, wait_s,
        shed_reason)`` — ``shed_reason`` is ``None`` on admission,
        else ``queue_full`` / ``queue_timeout`` /
        ``deadline_exceeded``."""
        pol = self.policy(cls)
        if deadline_left is not None and deadline_left <= 0:
            return False, 0.0, "deadline_exceeded"
        t0 = time.perf_counter()
        with self._lock:
            st = self._state_locked(cls)
            if st.inflight < pol.max_inflight:
                st.inflight += 1
                _H_QWAIT.observe(0.0)
                return True, 0.0, None
            if st.queued >= pol.queue_depth:
                return False, 0.0, "queue_full"
            budget, reason = pol.queue_timeout_s, "queue_timeout"
            if deadline_left is not None and deadline_left < budget:
                budget, reason = deadline_left, "deadline_exceeded"
            st.queued += 1
            gq = _obs.gauge("serve_requests_queued")
            gq.set(gq.value + 1)
            try:
                while st.inflight >= pol.max_inflight:
                    remaining = budget - (time.perf_counter() - t0)
                    if remaining <= 0:
                        wait_s = time.perf_counter() - t0
                        _H_QWAIT.observe(wait_s)
                        return False, wait_s, reason
                    st.cond.wait(min(remaining, 0.25))
                st.inflight += 1
                wait_s = time.perf_counter() - t0
                _H_QWAIT.observe(wait_s)
                return True, wait_s, None
            finally:
                st.queued -= 1
                gq.set(max(gq.value - 1, 0))

    def release(self, cls: str, reclaimed: bool = False) -> None:
        """Return a slot; ``reclaimed=True`` marks a slot freed by a
        quarantined/shed request (the dead lane's capacity handed to a
        waiter — ``serve_slots_reclaimed_total``)."""
        with self._lock:
            st = self._state_locked(cls)
            st.inflight = max(st.inflight - 1, 0)
            if reclaimed:
                _RECLAIMS.inc()
            st.cond.notify()


@dataclass(frozen=True)
class BucketSpec:
    """One warm-pool bucket: a warm (shape, engine, dtype, B) fleet-lane
    family. Family fields select the pool; ``lanes`` is the batch
    capacity; ``chunk_steps`` the cruise chunk length (also the
    quarantine-triage cadence)."""
    n_cells: int
    n_lat: int
    n_lon: int
    lanes: int
    engine: Optional[str] = None            # None = auto -> resolver
    spectral_dtype: Optional[str] = None
    mu: float = 0.05
    dt: float = 5e-5                        # template dt (dt is a value)
    chunk_steps: int = 2

    def family(self):
        return (self.n_cells, self.n_lat, self.n_lon, self.engine,
                self.spectral_dtype, self.mu)


@dataclass
class ScenarioRequest:
    """One tenant's scenario. Family fields select the bucket; value
    fields (``dt``, ``steps``, ``perturb``) are per-lane values or
    host-side loop bounds and never change a signature."""
    tenant: str
    n_cells: int
    n_lat: int = 8
    n_lon: int = 16
    steps: int = 3
    dt: float = 5e-5
    engine: Optional[str] = None
    spectral_dtype: Optional[str] = None
    mu: float = 0.05
    # per-lane initial velocity offset amplitude; a non-finite value
    # poisons the lane's state (the quarantine drill)
    perturb: float = 0.0
    # admission class (selects the TenantClassPolicy) and an optional
    # per-request admission-to-first-step deadline overriding the
    # class default
    tenant_class: str = "standard"
    deadline_s: Optional[float] = None

    def family(self):
        return (self.n_cells, self.n_lat, self.n_lon, self.engine,
                self.spectral_dtype, self.mu)


@dataclass
class RequestResult:
    """Per-request accounting (mirrors the ``request`` ledger record)."""
    tenant: str
    ok: bool
    quarantined: bool
    cold: bool
    bucket_lanes: int
    lane: int
    steps_done: int
    first_step_s: float
    total_s: float
    family_key: str
    error: Optional[str] = None
    trace_id: Optional[str] = None
    # traffic accounting: shed requests never ran a step; queue_wait_s
    # is the admission-queue time, retries the number of backoff hops
    # taken before this (terminal) outcome
    shed: bool = False
    shed_reason: Optional[str] = None
    retries: int = 0
    queue_wait_s: float = 0.0


def _tensor_bytes(tree, seen: Optional[set] = None) -> int:
    """Bytes of the distinct tensor storages among ``tree``'s leaves
    (``seen`` carries the storages already counted across calls)."""
    import torch

    from ibamr_tpu_torch.utils.tree import leaves

    seen = set() if seen is None else seen
    total = 0
    for t in leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        key = (t.untyped_storage().data_ptr(), t.device)
        if key in seen:
            continue
        seen.add(key)
        total += t.untyped_storage().nbytes()
    return total


def pool_resident_bytes(integ, template, lanes: int) -> int:
    """Device bytes a warm pool pins: its template state, the
    ``lanes``-lane stacked template a served batch holds, the spectral
    plan's k-space tables for the integrator's grid, the force specs
    and the marker layout of the template's markers (the packed layout
    on a packed engine), each storage counted once."""
    from ibamr_tpu_torch.solvers import spectral_plan

    seen: set = set()
    tmpl = _tensor_bytes(template, seen)
    total = tmpl * (1 + int(lanes))
    ins = integ.ins
    if getattr(ins, "fused_stokes", None) is not None:
        plan = spectral_plan.get_plan(ins.grid.n, ins.grid.dx, ins.dtype,
                                      ins.device)
        total += _tensor_bytes((plan.sym, plan.D, plan._k0,
                                plan._sym_safe, plan._f32), seen)
    ib = integ.ib
    total += _tensor_bytes(ib.specs, seen)
    fast = getattr(ib, "fast", None)
    if fast is not None and hasattr(fast, "buckets"):
        layout = fast.buckets(template.X)
        total += _tensor_bytes(
            [v for v in layout if not isinstance(v, bool)], seen)
    return int(total)


# One warm chunk runs at a time in the process. The chunks are eager:
# each is thousands of small ops, each releasing and retaking the GIL, on
# the one device stream; request threads running them side by side
# only queue for the GIL and the stream, and each thread's ops wait out
# the others' switch intervals. Taken inside the chunk's callable, so a
# wrapper's host-side delay (a straggler) holds no other tenant back.
_RUN_LOCK = threading.Lock()


def _one_at_a_time(fn):
    def run(*args):
        with _RUN_LOCK:
            return fn(*args)
    return run


class WarmPool:
    """One warm bucket: integrator + template state + the warm lane
    chunks (length 1 for the first-step ack, ``chunk_steps`` for
    cruise), all published through the shared executable cache."""

    def __init__(self, spec: BucketSpec, cache, device="cuda",
                 dtype=None):
        import torch

        from ibamr_tpu_torch.models.shell3d import build_shell_example
        from ibamr_tpu_torch.utils.hierarchy_driver import (HierarchyDriver,
                                                            RunConfig)

        self.spec = spec
        self.cache = cache
        engine_arg = (None if spec.engine in (None, "auto")
                      else {"scatter": False,
                            "mxu": True}.get(spec.engine, spec.engine))
        self.integ, self.template = build_shell_example(
            n_cells=spec.n_cells, n_lat=spec.n_lat, n_lon=spec.n_lon,
            radius=0.25, aspect=1.2, stiffness=1.0,
            rest_length_factor=0.75, mu=spec.mu,
            use_fast_interaction=engine_arg,
            spectral_dtype=spec.spectral_dtype,
            dtype=torch.float32 if dtype is None else dtype,
            device=device)
        self.engine = self.integ.ib.engine_name
        cfg = RunConfig(dt=spec.dt, num_steps=spec.chunk_steps,
                        health_interval=spec.chunk_steps)
        self.driver = HierarchyDriver(self.integ, cfg, lanes=spec.lanes)
        self.fingerprint = aot_cache.step_fingerprint(self.integ)
        self.key = aot_cache.cache_key(
            self.fingerprint,
            extra={"kind": "fleet_chunk", "lanes": spec.lanes})
        # the reference's f32 dt vector, on the host (the fleet chunk
        # reads dt there)
        self._dt_vec = np.full((spec.lanes,), spec.dt, dtype=np.float32)
        self._sig = None
        self.resident_bytes = pool_resident_bytes(self.integ,
                                                  self.template, spec.lanes)

    def _lengths(self) -> list:
        return sorted({1, self.spec.chunk_steps})

    def _template_args(self, live: int = 1):
        stacked, alive = _lanes.pad_lanes([self.template] * live,
                                          self.spec.lanes)
        return stacked, self._dt_vec, alive.numpy()

    def _signature(self) -> list:
        """The argument signature of the pool's chunks (computed once:
        every chunk of the pool takes the same shapes)."""
        if self._sig is None:
            self._sig = aot_cache.arg_signature(
                self._template_args(live=self.spec.lanes))
        return self._sig

    def _entry_bytes(self, length: int) -> int:
        """This entry's share of :attr:`resident_bytes`: the pool's
        bytes split across its ack and cruise entries, so the cache
        counts each byte once per pool."""
        lengths = self._lengths()
        share, rest = divmod(self.resident_bytes, len(lengths))
        return share + (rest if length == lengths[0] else 0)

    def contract_args(self, length: int = 1, live: int = 1):
        """(fn, args, donate_argnums) of this pool's chunk: the serving
        ack path runs the same fleet chunk as a batch run."""
        return self.driver._chunk(length), self._template_args(live=live), ()

    def ensure_compiled(self) -> None:
        """Warm the ack (length 1) and cruise chunks through the cache.
        Idempotent; this is the whole cost of a bucket miss."""
        for length in self._lengths():
            self.chunk(length)

    def _build(self, length: int):
        entry = aot_cache.aot_compile(
            _one_at_a_time(self.driver._chunk(length)),
            self._template_args(live=self.spec.lanes))
        entry.size_bytes = self._entry_bytes(length)
        return entry

    def chunk(self, length: int):
        """The warm fleet chunk of ``length`` steps. EVERY call goes
        through the hash-cons — a warm pool reads as cache hits (the
        ``warm_hits`` contract observable), a cold one as exactly one
        miss per (family, lanes, length)."""
        entry = self.cache.get_or_compile(
            self.fingerprint,
            lambda: self._build(length),
            extra={"kind": "fleet_chunk", "lanes": self.spec.lanes,
                   "length": length,
                   "args": self._signature()},
            label=(f"pool:{self.spec.n_cells}^3"
                   f"x{self.spec.lanes}:len{length}"))
        return entry.executable

    def entry_keys(self) -> list:
        """The cache keys of this pool's ack/cruise chunks, computed
        WITHOUT building — the elastic shrink path releases exactly
        these from the shared cache (``router.release_pool``)."""
        sig = self._signature()
        return [aot_cache.cache_key(
                    self.fingerprint,
                    extra={"kind": "fleet_chunk",
                           "lanes": self.spec.lanes,
                           "length": length, "args": sig})
                for length in self._lengths()]

    def request_state(self, req: ScenarioRequest):
        """Template state with the request's perturbation applied: a
        per-component constant velocity offset (divergence-free) —
        values only, never shapes/dtypes (the family contract). A new
        state: the shared template is never written."""
        import torch

        if req.perturb == 0.0:
            return self.template
        st = self.template
        u = tuple(c + torch.as_tensor(req.perturb * 1e-3 * (d + 1),
                                      dtype=c.dtype, device=c.device)
                  for d, c in enumerate(st.ins.u))
        return st._replace(ins=st.ins._replace(u=u))


class _PoolBuild:
    __slots__ = ("event", "pool", "error", "thread", "trace_ids")

    def __init__(self, trace_ids=()):
        self.event = threading.Event()
        self.pool = None
        self.error = None
        self.thread = None
        # the cold requests waiting on this build: the background
        # build's spans and aot_cache records bill to THEIR traces
        self.trace_ids = tuple(t for t in trace_ids if t)


class WarmPoolRouter:
    """Packs scenario requests into warm-pool buckets (module docstring
    has the request lifecycle). Pools live on ``device`` (the GPU unless
    ``device="cpu"``) at ``dtype`` (f32 unless given)."""

    def __init__(self, buckets: Sequence[BucketSpec] = (), cache=None,
                 allow_dynamic: bool = True, default_lanes: int = 2,
                 policies: Optional[dict] = None,
                 default_policy: TenantClassPolicy = DEFAULT_POLICY,
                 device="cuda", dtype=None):
        self.cache = cache if cache is not None else aot_cache.get_cache()
        self._specs = list(buckets)
        self._pools: dict = {}
        self._inflight: dict = {}
        self._serving: dict = {}       # family -> batches in flight
        self._lock = threading.Lock()
        self.allow_dynamic = allow_dynamic
        self.default_lanes = int(default_lanes)
        self.device = device
        self.dtype = dtype
        # per-tenant-class admission control; the default policy is
        # permissive (huge slots, no deadline, no retries)
        self.admission = AdmissionController(policies, default_policy)
        # optional elastic pool manager: observes admissions, sheds
        # batch tenants in shed_batch mode, caps batch cruise chunks in
        # brownout. None = static routing.
        self.manager = None

    # -- pool lifecycle -----------------------------------------------------

    def is_warm(self, spec: BucketSpec) -> bool:
        with self._lock:
            return spec in self._pools

    def live_specs(self) -> list:
        """Specs with a published warm pool (routable families)."""
        with self._lock:
            return list(self._pools)

    def live_families(self) -> dict:
        """family tuple -> BucketSpec for every warm pool."""
        with self._lock:
            return {s.family(): s for s in self._pools}

    def build_backlog(self) -> int:
        """Async pool builds currently in flight (the prebuild backlog
        leg of the elastic manager's pressure signal)."""
        with self._lock:
            return len(self._inflight)

    def family_inflight(self, family) -> int:
        """Batches of ``family`` currently being served — the elastic
        manager's never-evict-active guard reads this."""
        with self._lock:
            return self._serving.get(family, 0)

    def release_pool(self, spec: BucketSpec) -> int:
        """Evict a warm pool (elastic shrink): the family stops being
        routable, its spec leaves the declared set, and its ack/cruise
        entries (and their bytes) are released from the shared cache.
        Returns how many cache entries were released. A family mid-
        serve must not be released — the manager checks
        :meth:`family_inflight` first (a released pool under a live
        batch would not crash, but the batch's next chunk would pay a
        fresh build)."""
        with self._lock:
            pool = self._pools.pop(spec, None)
            try:
                self._specs.remove(spec)
            except ValueError:
                pass
        if pool is None:
            return 0
        return self.cache.release(pool.entry_keys())

    def drain_builds(self, timeout_s: float = 60.0) -> int:
        """Join any in-flight pool-build threads (bounded); returns
        how many are still alive after the timeout. A shed request
        leaves its bucket build running (the next arrival gets the
        warm pool), so call this before process exit — a daemon thread
        inside a build at interpreter teardown can abort the
        process."""
        with self._lock:
            threads = [f.thread for f in self._inflight.values()
                       if f.thread is not None]
        deadline = time.monotonic() + max(float(timeout_s), 0.0)
        alive = 0
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0.0))
            alive += int(t.is_alive())
        return alive

    def warm(self, spec: Optional[BucketSpec] = None,
             block: bool = True):
        """Pre-build bucket(s) (``spec=None`` warms every declared
        bucket). ``block=False`` returns immediately with the builds
        running in the background."""
        specs = [spec] if spec is not None else list(self._specs)
        waits = [self._ensure_pool(s) for s in specs]
        if block:
            return [w() for w in waits]
        return waits

    def _ensure_pool(self, spec: BucketSpec, trace_ids=()):
        """Warm pool for ``spec``, built asynchronously on a miss (one
        background build per bucket, published to the shared
        executable cache). Returns a ``wait()`` callable producing the
        pool — a cold request's latency includes this wait; every
        other family keeps serving meanwhile. ``trace_ids`` names the
        requests whose cold path this build is (thread-locals do not
        cross threads, so the identity is handed over explicitly); a
        build already in flight keeps its original attribution."""
        with self._lock:
            pool = self._pools.get(spec)
            if pool is not None:
                return lambda timeout=None: pool
            flight = self._inflight.get(spec)
            if (flight is not None and flight.thread is not None
                    and not flight.thread.is_alive()
                    and not flight.event.is_set()):
                # the build thread died without publishing (killed
                # mid-build): fail the flight over so its waiters see
                # a retryable build error instead of hanging forever,
                # and let a fresh build start
                self._inflight.pop(spec, None)
                flight.error = RuntimeError(
                    "pool build thread died before publishing")
                flight.event.set()
                flight = None
            if flight is None:
                flight = _PoolBuild(trace_ids=trace_ids)
                self._inflight[spec] = flight
                t = threading.Thread(target=self._build_pool,
                                     args=(spec, flight), daemon=True)
                flight.thread = t
                t.start()

        def wait(timeout=None):
            deadline = (None if timeout is None
                        else time.monotonic() + max(float(timeout), 0.0))
            # sliced wait: each slice re-checks the build thread's
            # liveness, so a killed build fails over instead of
            # deadlocking every waiter (soak invariant: no deadlock)
            while not flight.event.is_set():
                if (deadline is not None
                        and time.monotonic() >= deadline):
                    raise PoolWaitTimeout(
                        f"pool build for {spec.n_cells}^3 "
                        f"x{spec.lanes} exceeded the deadline budget")
                slice_s = (0.25 if deadline is None
                           else min(0.25, max(
                               deadline - time.monotonic(), 0.001)))
                if flight.event.wait(slice_s):
                    break
                th = flight.thread
                if (th is not None and not th.is_alive()
                        and not flight.event.is_set()):
                    with self._lock:
                        if self._inflight.get(spec) is flight:
                            self._inflight.pop(spec, None)
                    flight.error = RuntimeError(
                        "pool build thread died before publishing")
                    flight.event.set()
            if flight.error is not None:
                raise flight.error
            return flight.pool

        return wait

    def _build_pool(self, spec: BucketSpec, flight: _PoolBuild) -> None:
        try:
            with _obs.trace_scope(*flight.trace_ids), \
                    _obs.span("serve/pool_build",
                              lanes=spec.lanes, n=spec.n_cells):
                pool = WarmPool(spec, self.cache, device=self.device,
                                dtype=self.dtype)
                pool.ensure_compiled()
            with self._lock:
                self._pools[spec] = pool
                self._inflight.pop(spec, None)
            flight.pool = pool
        except Exception as e:  # noqa: BLE001 - delivered to waiters
            with self._lock:
                self._inflight.pop(spec, None)
            flight.error = e
        finally:
            flight.event.set()

    # -- bucketing ----------------------------------------------------------

    def _bucket_for(self, family, count: int) -> BucketSpec:
        """Nearest bucket: same family, smallest ``lanes >= count``;
        else the largest same-family bucket (the group splits); else a
        dynamic bucket when allowed."""
        with self._lock:
            cands = [s for s in self._specs if s.family() == family]
        if not cands:
            if not self.allow_dynamic:
                raise KeyError(
                    f"no declared bucket for scenario family {family} "
                    f"(allow_dynamic=False)")
            lanes = max(self.default_lanes, count)
            spec = BucketSpec(n_cells=family[0], n_lat=family[1],
                              n_lon=family[2], lanes=lanes,
                              engine=family[3], spectral_dtype=family[4],
                              mu=family[5])
            with self._lock:
                self._specs.append(spec)
            cands = [spec]
        fits = sorted((s for s in cands if s.lanes >= count),
                      key=lambda s: s.lanes)
        return fits[0] if fits else max(cands, key=lambda s: s.lanes)

    # -- serving ------------------------------------------------------------

    def serve(self, requests: Sequence[ScenarioRequest]):
        """Serve a batch of scenario requests; returns one
        :class:`RequestResult` per request, input order preserved.

        Admission mints each request a ``trace_id`` and emits a
        ``request_admit`` ledger record; every record and span the
        request touches downstream carries the id, so ``python -m
        ibamr_tpu_torch.tools.obs trace <id>`` rebuilds the full
        admission→completion timeline from the ledger alone. Every
        admitted id reaches exactly one TERMINAL record (``request``
        or ``request_shed``) — even when ``serve`` raises, the
        unserved remainder is shed first (the no-lost-request
        invariant)."""
        g_in = _obs.gauge("serve_requests_inflight")
        g_done = _obs.gauge("serve_requests_completed")
        tids = [_obs.new_trace_id() for _ in requests]
        t_admit = time.perf_counter()
        g_in.set(g_in.value + len(requests))
        for r, tid in zip(requests, tids):
            _obs.emit("request_admit", trace_id=tid, tenant=r.tenant,
                      tenant_class=r.tenant_class,
                      family=str(r.family()), steps=int(r.steps))
        mgr = self.manager
        if mgr is not None:
            # elastic observation: fold arrivals into the mix estimate
            # + run a scaling/mode tick. A manager bug must degrade to
            # static routing, never down the router.
            for r, tid in zip(requests, tids):
                try:
                    mgr.observe_admit(r, trace_id=tid)
                except Exception:  # noqa: BLE001 - degrade, don't die
                    _obs.counter("serve_manager_errors_total").inc()
        results: list = [None] * len(requests)
        try:
            groups: dict = {}
            for i, r in enumerate(requests):
                groups.setdefault(r.family(), []).append((i, r))
            for family, members in groups.items():
                pos = 0
                while pos < len(members):
                    spec = self._bucket_for(family, len(members) - pos)
                    batch = members[pos:pos + spec.lanes]
                    pos += len(batch)
                    out = self._admit_and_serve(spec, batch, tids,
                                                t_admit)
                    for (i, _), res in zip(batch, out):
                        results[i] = res
        except BaseException as e:
            reason = ("no_bucket" if isinstance(e, KeyError)
                      else "router_error")
            for i, r in enumerate(requests):
                if results[i] is None:
                    results[i] = self._shed(
                        r, tids[i], reason, 0.0,
                        error=f"{type(e).__name__}: {e}")
            raise
        finally:
            g_in.set(max(g_in.value - len(requests), 0))
        g_done.set(g_done.value + len(requests))
        return results

    # -- admission / shed / retry -------------------------------------------

    def _shed(self, req: ScenarioRequest, tid: Optional[str],
              reason: str, queue_wait_s: float, retries: int = 0,
              error: Optional[str] = None) -> RequestResult:
        """Terminal shed: counter + cumulative gauge + the
        ``request_shed`` ledger record (the shed counterpart of the
        ``request`` accounting record)."""
        _obs.counter("serve_shed_total", reason=reason).inc()
        gs = _obs.gauge("serve_requests_shed")
        gs.set(gs.value + 1)
        payload = dict(trace_id=tid or None, tenant=req.tenant,
                       tenant_class=req.tenant_class,
                       family=str(req.family()), reason=reason,
                       queue_wait_s=round(queue_wait_s, 4),
                       retries=int(retries))
        if error:
            payload["error"] = error
        _obs.emit("request_shed", **payload)
        return RequestResult(
            tenant=req.tenant, ok=False, quarantined=False,
            cold=False, bucket_lanes=0, lane=-1, steps_done=0,
            first_step_s=0.0, total_s=0.0,
            family_key=str(req.family()),
            error=error or f"shed ({reason})", trace_id=tid,
            shed=True, shed_reason=reason, retries=int(retries),
            queue_wait_s=queue_wait_s)

    def _deadline_left(self, req: ScenarioRequest,
                       t_admit: float) -> Optional[float]:
        deadline = (req.deadline_s if req.deadline_s is not None
                    else self.admission.policy(req.tenant_class
                                               ).deadline_s)
        if deadline is None:
            return None
        return deadline - (time.perf_counter() - t_admit)

    @staticmethod
    def _backoff_s(pol: TenantClassPolicy, attempt: int,
                   tid: Optional[str]) -> float:
        """Exponential backoff with DETERMINISTIC jitter derived from
        the trace id (no RNG state, replays identically)."""
        base = min(pol.backoff_cap_s,
                   pol.backoff_base_s * (2 ** max(attempt - 1, 0)))
        jitter = (int((tid or "0")[:8], 16) % 1000) / 1000.0
        return base * (0.5 + 0.5 * jitter)

    def _admit_and_serve(self, spec: BucketSpec, batch, tids,
                         t_admit: float):
        """Admission-gate one packed batch, serve the admitted
        members (with retries), and release every admitted slot —
        reclaimed slots (quarantined/shed requests) wake a queued
        waiter so dead lanes return capacity."""
        out: list = [None] * len(batch)
        admitted: list = []
        qwaits: dict = {}
        mgr = self.manager
        for j, (i, r) in enumerate(batch):
            if mgr is not None and mgr.should_shed(r.tenant_class):
                # mode-driven shed: shed_batch drops batch tenants
                # BEFORE they take a slot, so interactive p99 rides the
                # capacity brownout protects
                out[j] = self._shed(r, tids[i], "brownout", 0.0)
                continue
            ok, wait_s, reason = self.admission.admit(
                r.tenant_class, self._deadline_left(r, t_admit))
            if ok:
                admitted.append(j)
                qwaits[j] = wait_s
            else:
                out[j] = self._shed(r, tids[i], reason, wait_s)
        if not admitted:
            return out
        try:
            self._serve_admitted(spec, batch, tids, t_admit, admitted,
                                 qwaits, out)
        finally:
            for j in admitted:
                res = out[j]
                reclaimed = (isinstance(res, RequestResult)
                             and (res.quarantined or res.shed))
                self.admission.release(batch[j][1].tenant_class,
                                       reclaimed=reclaimed)
        return out

    def _serve_admitted(self, spec: BucketSpec, batch, tids,
                        t_admit: float, admitted, qwaits, out):
        """The retry loop: serve the admitted members, classify
        transient failures (failed/killed pool build, quarantined
        lane), back off and retry within the class budget; everything
        else is terminal. ``out[j]`` is a RequestResult for every
        admitted ``j`` on exit."""
        pending = list(admitted)
        attempt = 0
        while pending:
            reqs = [batch[j][1] for j in pending]
            btids = [tids[batch[j][0]] for j in pending]
            lefts = [self._deadline_left(r, t_admit) for r in reqs]
            bq = [qwaits[j] for j in pending]
            err: Optional[BaseException] = None
            try:
                res = self._serve_batch(spec, reqs, btids, qwaits=bq,
                                        attempt=attempt,
                                        deadline_lefts=lefts)
            except Exception as e:  # noqa: BLE001 - pool build failed
                res, err = None, e
            retry: list = []
            reasons: dict = {}
            for k, j in enumerate(pending):
                i, r = batch[j]
                pol = self.admission.policy(r.tenant_class)
                left = self._deadline_left(r, t_admit)
                can_retry = (attempt < pol.retry_budget
                             and (left is None
                                  or left > self._backoff_s(
                                      pol, attempt + 1, tids[i])))
                if err is not None:
                    if can_retry:
                        retry.append(j)
                        reasons[j] = "build_failed"
                    else:
                        out[j] = self._shed(
                            r, tids[i], "build_failed", qwaits[j],
                            retries=attempt,
                            error=f"{type(err).__name__}: {err}")
                    continue
                rres = res[k]
                if rres.quarantined and can_retry:
                    retry.append(j)
                    reasons[j] = "lane_quarantined"
                else:
                    out[j] = rres
            if retry:
                attempt += 1
                backoff = 0.0
                for j in retry:
                    i, r = batch[j]
                    pol = self.admission.policy(r.tenant_class)
                    b = self._backoff_s(pol, attempt, tids[i])
                    backoff = max(backoff, b)
                    _obs.counter("serve_retries_total",
                                 reason=reasons[j]).inc()
                    _obs.emit("request_retry", trace_id=tids[i],
                              tenant=r.tenant,
                              tenant_class=r.tenant_class,
                              attempt=attempt, reason=reasons[j],
                              backoff_s=round(b, 4))
                time.sleep(backoff)
            pending = retry

    def _serve_batch(self, spec: BucketSpec,
                     reqs: Sequence[ScenarioRequest],
                     tids: Sequence[Optional[str]] = (),
                     qwaits: Sequence[float] = (),
                     attempt: int = 0,
                     deadline_lefts: Sequence[Optional[float]] = ()):
        """Serving-count bookkeeping around :meth:`_serve_batch_run`:
        while a family has a batch in flight the elastic manager's
        shrink path must not release its pool
        (``family_inflight`` — the never-evict-active guard)."""
        family = spec.family()
        with self._lock:
            self._serving[family] = self._serving.get(family, 0) + 1
        try:
            return self._serve_batch_run(spec, reqs, tids, qwaits,
                                         attempt, deadline_lefts)
        finally:
            with self._lock:
                n = self._serving.get(family, 1) - 1
                if n <= 0:
                    self._serving.pop(family, None)
                else:
                    self._serving[family] = n

    def _serve_batch_run(self, spec: BucketSpec,
                         reqs: Sequence[ScenarioRequest],
                         tids: Sequence[Optional[str]] = (),
                         qwaits: Sequence[float] = (),
                         attempt: int = 0,
                         deadline_lefts: Sequence[Optional[float]] = ()):
        tids = list(tids) or [None] * len(reqs)
        qwaits = list(qwaits) or [0.0] * len(reqs)
        lefts = list(deadline_lefts) or [None] * len(reqs)
        t_submit = time.perf_counter()
        with _obs.trace_scope(*tids), \
                _obs.span("serve/request", lanes=spec.lanes,
                          requests=len(reqs)):
            cold = not self.is_warm(spec)
            wait = self._ensure_pool(spec, trace_ids=tids)
            # the deadline budget binds the pool wait only when every
            # member carries one — the most patient member keeps the
            # build alive for the others
            finite = [x for x in lefts if x is not None]
            budget = (max(finite)
                      if finite and len(finite) == len(reqs) else None)
            with _obs.span("bucket_wait", cold=cold):
                t_wait = time.perf_counter()
                try:
                    pool = wait(budget)    # cold: the build lands here
                except PoolWaitTimeout:
                    # every member's admission-to-first-step budget
                    # expired while the bucket built: terminal shed (a
                    # deadline, unlike a failed build, never retries —
                    # the budget is already gone)
                    return [self._shed(r, tids[k],
                                       "deadline_exceeded", qwaits[k],
                                       retries=attempt)
                            for k, r in enumerate(reqs)]
                finally:
                    _H_WAIT.observe(time.perf_counter() - t_wait)
            results: list = [None] * len(reqs)
            elapsed = time.perf_counter() - t_submit
            live_idx = []
            for k, r in enumerate(reqs):
                if lefts[k] is not None and lefts[k] - elapsed <= 0:
                    # admission-to-first-step budget burned in the
                    # bucket wait: shed before spending device time
                    results[k] = self._shed(r, tids[k],
                                            "deadline_exceeded",
                                            qwaits[k], retries=attempt)
                else:
                    live_idx.append(k)
            if not live_idx:
                return results
            sreqs = [reqs[k] for k in live_idx]
            stids = [tids[k] for k in live_idx]
            B = spec.lanes
            pads = B - len(sreqs)
            if pads:
                _PADS.inc(pads)
            _H_PADFRAC.observe(pads / B)
            stacked, _ = _lanes.pad_lanes(
                [pool.request_state(r) for r in sreqs], B)
            # host arrays: the fleet chunk reads dt and the mask there,
            # so a served chunk's one device read is its health vector
            dt_vec = np.asarray(
                [r.dt for r in sreqs] + [sreqs[-1].dt] * pads,
                dtype=pool._dt_vec.dtype)

            steps_done = np.zeros(B, dtype=int)
            target = np.array([r.steps for r in sreqs] + [0] * pads)
            quarantined = np.zeros(B, dtype=bool)
            alive_host = np.arange(B) < len(sreqs)
            first_step_s = None
            state = stacked
            while True:
                remaining = target - steps_done
                live = alive_host & (remaining > 0)
                if not live.any():
                    break
                # only warm lengths run (1 and chunk_steps): the warm
                # path performs ZERO builds by construction
                length = (spec.chunk_steps
                          if first_step_s is not None
                          and int(remaining[live].max())
                          >= spec.chunk_steps
                          else 1)
                # brownout cruise cap: an all-batch batch is degraded
                # to the warm length-1 ack chunk — reduced throughput,
                # still zero fresh builds
                mgr = self.manager
                if mgr is not None and length > 1:
                    cap = mgr.cruise_cap(
                        [r.tenant_class for r in sreqs])
                    if cap is not None:
                        length = min(length, cap)
                run_mask = live & (remaining >= length)
                with _obs.span("ack" if first_step_s is None
                               else "cruise", steps=length):
                    state, health = pool.chunk(length)(
                        state, dt_vec, run_mask)
                    # one transfer per chunk
                    h = health.detach().cpu().numpy()
                if first_step_s is None:
                    first_step_s = time.perf_counter() - t_submit
                steps_done[run_mask] += length
                newly_bad = run_mask & (h < 0.5)
                for lane in np.nonzero(newly_bad)[0]:
                    if lane >= len(sreqs):
                        continue
                    _obs.emit("lane_quarantine",
                              trace_id=stids[lane] or None,
                              tenant=sreqs[lane].tenant,
                              family=pool.key, lane=int(lane),
                              step=int(steps_done[lane]))
                quarantined |= newly_bad
                alive_host &= ~newly_bad

            total_s = time.perf_counter() - t_submit
            if first_step_s is None:          # zero-step requests
                first_step_s = total_s
            path = "cold" if cold else "warm"
            for lane, r in enumerate(sreqs):
                q = bool(quarantined[lane])
                ok = bool(steps_done[lane] >= r.steps) and not q
                _REQS.inc()
                if cold:
                    _COLD.inc()
                if q:
                    _QUAR.inc()
                _H_REQ[path].observe(total_s)
                _H_FIRST[path].observe(first_step_s)
                qw = qwaits[live_idx[lane]]
                results[live_idx[lane]] = RequestResult(
                    tenant=r.tenant, ok=ok, quarantined=q, cold=cold,
                    bucket_lanes=B, lane=lane,
                    steps_done=int(steps_done[lane]),
                    first_step_s=first_step_s, total_s=total_s,
                    family_key=pool.key, trace_id=stids[lane],
                    error=("lane quarantined (non-finite state)" if q
                           else None),
                    retries=int(attempt), queue_wait_s=qw)
                _obs.emit("request", trace_id=stids[lane] or None,
                          tenant=r.tenant,
                          tenant_class=r.tenant_class,
                          family=pool.key,
                          engine=pool.engine, bucket_lanes=B,
                          lane=lane, cold=cold, ok=ok, quarantined=q,
                          steps=int(steps_done[lane]),
                          first_step_s=round(first_step_s, 4),
                          total_s=round(total_s, 4),
                          queue_wait_s=round(qw, 4),
                          retries=int(attempt))
        return results


def _histogram_delta(before: dict, after: dict) -> dict:
    """Per-key difference of two ``metrics_snapshot()["histograms"]``
    dicts, keeping only keys that saw observes in between — the drill
    reports ITS distribution even when the process served before."""
    out = {}
    for key, snap in after.items():
        b = before.get(key)
        if b is None:
            counts = list(snap["counts"])
            s = float(snap["sum"])
        else:
            counts = [int(a) - int(x)
                      for a, x in zip(snap["counts"], b["counts"])]
            s = float(snap["sum"]) - float(b["sum"])
        n = sum(counts)
        if n > 0:
            out[key] = {"sum": s, "count": n, "counts": counts}
    return out


def cold_warm_drill(n_cells: int = 16, n_lat: int = 8, n_lon: int = 16,
                    lanes: int = 2, steps: int = 3, dt: float = 5e-5,
                    engine: Optional[str] = None,
                    spectral_dtype: Optional[str] = None,
                    cache_dir: Optional[str] = None,
                    warm_requests: int = 1, device="cuda",
                    dtype=None) -> dict:
    """The serving benchmark: one scenario family served twice through
    a FRESH router + FRESH executable cache — request 1 pays the cold
    path (bucket build on a miss), request 2 rides warm. Returns
    request-to-first-step latencies plus build counts; the serve
    contract (``python -m ibamr_tpu_torch.tools.serve check`` against
    the port's SERVE_CONTRACT.json) pins ``warm_compiles == 0`` and
    ``warm_new_trace_signatures == 0`` structurally.

    ``warm_requests > 1`` serves extra warm requests AFTER the
    contract-measured one (its build/hit accounting is untouched) so
    the warm-path percentiles (``warm_p50_s``/``warm_p99_s``, from the
    ``serve_first_step_seconds{path="warm"}`` histogram delta) rest on
    a real sample; the full per-key histogram delta rides along under
    ``"histograms"``, and the pool's resident bytes under
    ``"pool_bytes"``. ``device`` / ``dtype`` place the pool (the GPU
    and f32 unless given)."""
    cache = aot_cache.ExecutableCache(directory=cache_dir)
    spec = BucketSpec(n_cells=n_cells, n_lat=n_lat, n_lon=n_lon,
                      lanes=lanes, engine=engine,
                      spectral_dtype=spectral_dtype, dt=dt,
                      chunk_steps=max(1, min(2, steps)))
    router = WarmPoolRouter([spec], cache=cache, allow_dynamic=False,
                            device=device, dtype=dtype)

    def one(tag):
        before = cache.stats()
        res = router.serve([ScenarioRequest(
            tenant=tag, n_cells=n_cells, n_lat=n_lat, n_lon=n_lon,
            steps=steps, dt=dt, engine=engine,
            spectral_dtype=spectral_dtype)])[0]
        after = cache.stats()
        return res, {"compiles": after["misses"] - before["misses"],
                     "hits": after["hits"] - before["hits"]}

    hist_before = _obs.metrics_snapshot()["histograms"]
    cold_res, cold_stats = one("drill-cold")
    pool = router._pools[spec]
    sigs_cold = sum(pool.driver.trace_counts.values())
    warm_res, warm_stats = one("drill-warm")
    sigs_warm = sum(pool.driver.trace_counts.values())
    for k in range(max(0, int(warm_requests) - 1)):
        one(f"drill-warm-{k + 2}")
    hist = _histogram_delta(hist_before,
                            _obs.metrics_snapshot()["histograms"])
    warm_first = hist.get('serve_first_step_seconds{path="warm"}')
    warm_p50, warm_p99 = (
        _obs.quantiles_from_counts(warm_first["counts"], [0.5, 0.99])
        if warm_first else (None, None))
    return {
        "n": n_cells, "lanes": lanes, "steps": steps,
        "engine": pool.engine,
        "family_key": cold_res.family_key,
        "cold_first_step_s": round(cold_res.first_step_s, 4),
        "warm_first_step_s": round(warm_res.first_step_s, 4),
        "warm_over_cold": round(
            warm_res.first_step_s / max(cold_res.first_step_s, 1e-9), 6),
        "cold_compiles": cold_stats["compiles"],
        "warm_compiles": warm_stats["compiles"],
        "warm_hits": warm_stats["hits"],
        "warm_new_trace_signatures": sigs_warm - sigs_cold,
        "cold_ok": bool(cold_res.ok), "warm_ok": bool(warm_res.ok),
        "warm_requests": max(1, int(warm_requests)),
        "warm_p50_s": (None if warm_p50 is None
                       else round(warm_p50, 6)),
        "warm_p99_s": (None if warm_p99 is None
                       else round(warm_p99, 6)),
        "pool_bytes": int(pool.resident_bytes),
        "histograms": hist,
    }
