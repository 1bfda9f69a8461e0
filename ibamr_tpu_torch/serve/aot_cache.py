"""Executable cache: hash-consing warm step callables (port of
``ibamr_tpu/serve/aot_cache.py``).

At service scale the first call of a scenario family is the latency: it
builds the family's kernels, cuFFT plans and packed layouts. This module
keeps one warm callable per scenario family, in two layers:

- **in-memory LRU**: :class:`ExecutableCache`, process-local, keyed on
  the scenario-family digest (:func:`cache_key` of the flight-recorder
  fingerprint: config digest, integrator spec, RESOLVED engine,
  spectral dtype, mesh, platform, device count, torch version and the
  card's name as ``device_kind``, plus the argument signature, so shape
  families can never collide). An entry holds a warm callable
  (:class:`WarmCallable`): the eager function after its warm-up call,
  or, where the caller marks the function capture-safe and the inputs
  live on a CUDA device, the function captured as a CUDA graph
  (``utils/cuda_graph.Graphed``). A capture that fails raises; nothing
  falls back to the eager callable. The entry's ``mode`` says which it
  holds.
- **manifest sidecars**: one digest-protected ``<dir>/<key>.json`` per
  entry, recording the fingerprint, the build seconds and the mode. A
  manifest whose digest does not verify is REFUSED: counted, deleted,
  and the entry rebuilt from scratch.

The reference's third layer, JAX's persistent compilation cache, has no
torch counterpart (:func:`enable_persistent_cache` says so and does
nothing). Every hit/miss/eviction is twinned onto the telemetry bus
(``aot_cache_*_total`` counters) and, with a run ledger attached,
emitted as an ``aot_cache`` ledger record with the build seconds.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ibamr_tpu_torch import obs as _obs
from ibamr_tpu_torch.utils.flight_recorder import canonicalize

MANIFEST_SCHEMA = 1
_DEFAULT_CAPACITY = 16

_HITS = _obs.counter("aot_cache_hits_total")
_MISSES = _obs.counter("aot_cache_misses_total")
_EVICTS = _obs.counter("aot_cache_evictions_total")
_CORRUPT = _obs.counter("aot_cache_corrupt_total")
_WAITS = _obs.counter("aot_cache_inflight_waits_total")
# build-time distribution, split by whether a valid manifest predated
# the build: source="compile" (a family never built here) vs
# "persistent" (a rebuild of a family this cache directory has seen)
_H_BUILD = {s: _obs.histogram("aot_cache_build_seconds", source=s)
            for s in ("compile", "persistent")}
_obs.describe("aot_cache_hits_total",
              "In-process executable-cache hits.")
_obs.describe("aot_cache_misses_total",
              "Executable-cache misses (one AOT build each).")
_obs.describe("aot_cache_build_seconds",
              "Executable build wall time on a miss, by "
              "source=compile|persistent.")
_obs.describe("aot_cache_bytes",
              "Estimated device bytes held by the executable cache's "
              "captured graphs (the brownout watermark input).")
_obs.describe("aot_cache_released_total",
              "Entries explicitly released (elastic pool shrink), "
              "distinct from LRU/bytes-ceiling evictions.")

# fingerprint fields that determine the warm callable: the "scenario
# family". Everything else in the fingerprint (rng keys, injectors,
# numpy version, ...) is run identity, not build identity. The
# reference's JAX fields (x64 mode, jax version) become the torch
# version and the card's name.
KEY_FIELDS = ("config_digest", "integrator", "engine", "spectral_dtype",
              "mesh", "mesh_shape", "platform", "device_count",
              "torch_version", "device_kind")


def cache_key(fingerprint: dict, extra: Optional[dict] = None) -> str:
    """16-hex scenario-family key: sha256 of the canonicalized stable
    subset (:data:`KEY_FIELDS`) of a flight-recorder fingerprint, plus
    any ``extra`` material (argument signatures, chunk length, lane
    count). Canonicalization makes the key insertion-order invariant."""
    material = {k: fingerprint.get(k) for k in KEY_FIELDS}
    if extra:
        material["extra"] = extra
    blob = json.dumps(canonicalize(material), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def arg_signature(args) -> list:
    """(shape, dtype) per leaf of an argument pytree: cache-key material
    guaranteeing a callable is only ever served to the shape family it
    was built for. Dtypes are named as the reference names them
    (``float32``, not ``torch.float32``); a Python scalar is named by its
    type."""
    from ibamr_tpu_torch.utils.tree import leaves

    return [[list(getattr(a, "shape", ())),
             str(getattr(a, "dtype", type(a).__name__)).replace(
                 "torch.", "")]
            for a in leaves(args)]


def step_fingerprint(integ, *, spec: Optional[dict] = None,
                     extra: Optional[dict] = None) -> dict:
    """Flight-recorder fingerprint of an integrator outside any driver
    run: the cache's key source. Carries the RESOLVED engine
    (``ib.engine_name``), spectral dtype, platform, device count and
    torch version exactly as :meth:`FlightRecorder.fingerprint` defines
    them, plus ``device_kind``: the card's name on a CUDA platform, else
    the platform."""
    import torch

    from ibamr_tpu_torch.utils.flight_recorder import FlightRecorder

    rec = FlightRecorder(capacity=1, spec=spec, extra_fingerprint=extra)
    rec.observe(integ=integ)
    fp = rec.fingerprint()
    if "device_kind" not in fp:
        fp["device_kind"] = (torch.cuda.get_device_name()
                             if fp.get("platform") == "cuda"
                             else fp.get("platform"))
    return fp


def enable_persistent_cache(directory: Optional[str] = None,
                            min_compile_secs: float = 2.0) -> None:
    """The reference wires JAX's persistent compilation cache here, the
    cross-process layer that serves a family's XLA compile from disk.
    PyTorch has no counterpart: the port's hand kernels already build
    once per checkout (``ops/kernel_build.py`` caches each library under
    ``csrc/build/`` by the hash of its sources), cuFFT plans and CUDA
    graphs live only in their process, and eager torch code compiles
    nothing. The name is kept so callers of the reference's API run;
    the call does nothing and returns None (the reference's value when
    the layer is unavailable)."""
    return None


def estimate_executable_bytes(executable) -> int:
    """Device bytes an entry holds for the bytes watermark: a captured
    graph's static input and output buffers (``size_bytes`` of a
    :class:`WarmCallable`); 0 for an eager callable, which holds no
    buffer of its own (the watermark then degrades to count-only LRU)."""
    try:
        return int(getattr(executable, "size_bytes", 0) or 0)
    except (TypeError, ValueError):
        return 0


@dataclass
class CacheEntry:
    """One cached executable + its accounting record."""
    key: str
    executable: Any                  # a WarmCallable (opaque here)
    fingerprint: dict = field(default_factory=dict)
    compile_s: float = 0.0
    label: str = ""
    hits: int = 0
    built_at: float = 0.0
    # "compile" = a family never built with this directory; "persistent"
    # = a valid manifest pre-existed (a rebuild of a known family)
    cold_source: str = "compile"
    # device bytes of a captured graph's buffers (the aot_cache_bytes
    # watermark)
    size_bytes: int = 0
    # "graph" (a captured CUDA graph) or "eager" (a warm callable)
    mode: str = "eager"


class _InFlight:
    """Build-once latch for concurrent get-or-compile on one key."""

    __slots__ = ("event", "entry", "error")

    def __init__(self):
        self.event = threading.Event()
        self.entry = None
        self.error = None


class ExecutableCache:
    """Hash-cons LRU of warm callables (the spectral-plan cache pattern,
    generalized). ``get_or_compile`` guarantees at most ONE
    build per key regardless of concurrency: the first caller compiles
    outside the lock, every other caller for that key waits on the
    in-flight latch and shares the published entry."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY,
                 directory: Optional[str] = None,
                 max_bytes: Optional[int] = None):
        if capacity < 1:
            raise ValueError(
                f"ExecutableCache.capacity must be >= 1, got {capacity!r}")
        self.capacity = int(capacity)
        self.directory = directory
        # optional bytes ceiling on ESTIMATED device bytes: evicts
        # LRU-first until under, on top of the count LRU. None (the
        # default) preserves count-only behavior exactly.
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        if directory:
            os.makedirs(directory, exist_ok=True)
        self._entries: "OrderedDict[str, CacheEntry]" = OrderedDict()
        self._inflight: dict = {}
        self._lock = threading.Lock()
        self._stats = {"hits": 0, "misses": 0, "evictions": 0,
                       "corrupt": 0, "inflight_waits": 0,
                       "released": 0, "bytes": 0}

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> list:
        with self._lock:
            return list(self._entries)

    def get(self, key: str) -> Optional[CacheEntry]:
        """Peek an entry WITHOUT touching stats or LRU order."""
        with self._lock:
            return self._entries.get(key)

    def bytes(self) -> int:
        """Estimated device bytes currently held."""
        with self._lock:
            return int(self._stats["bytes"])

    def release(self, keys) -> int:
        """Explicitly drop entries (elastic pool shrink): counted as
        ``released``, not evictions, so the LRU-pressure signal stays
        honest. Returns how many entries were actually held."""
        dropped = 0
        with self._lock:
            for key in ([keys] if isinstance(keys, str) else keys):
                ent = self._entries.pop(key, None)
                if ent is None:
                    continue
                dropped += 1
                self._stats["released"] += 1
                self._stats["bytes"] = max(
                    0, self._stats["bytes"] - ent.size_bytes)
                _obs.counter("aot_cache_released_total").inc()
                _obs.emit("aot_cache", event="release", key=key,
                          label=ent.label)
            self._set_bytes_gauge_locked()
        return dropped

    def set_max_bytes(self, max_bytes: Optional[int]) -> int:
        """Adjust the bytes ceiling at runtime (the memory-pressure
        injector's seam) and evict LRU-first until under it. Returns
        how many entries were evicted by the squeeze."""
        with self._lock:
            self.max_bytes = (None if max_bytes is None
                              else int(max_bytes))
            return self._evict_over_limits_locked()

    def _evict_over_limits_locked(self) -> int:
        evicted = 0
        while self._entries and (
                len(self._entries) > self.capacity
                or (self.max_bytes is not None
                    and self._stats["bytes"] > self.max_bytes)):
            old_key, old = self._entries.popitem(last=False)
            self._stats["evictions"] += 1
            self._stats["bytes"] = max(
                0, self._stats["bytes"] - old.size_bytes)
            evicted += 1
            _EVICTS.inc()
            _obs.emit("aot_cache", event="evict", key=old_key,
                      label=old.label)
        self._set_bytes_gauge_locked()
        return evicted

    def _set_bytes_gauge_locked(self) -> None:
        _obs.gauge("aot_cache_bytes").set(float(self._stats["bytes"]))

    def clear(self) -> None:
        """Drop every entry and zero the stats (tests; manifests on
        disk are left alone — they describe the persistent layer)."""
        with self._lock:
            self._entries.clear()
            self._inflight.clear()
            for k in self._stats:
                self._stats[k] = 0
            self._set_bytes_gauge_locked()

    # -- the hash-cons ------------------------------------------------------

    def get_or_compile(self, fingerprint, build: Callable[[], Any], *,
                       extra: Optional[dict] = None,
                       label: str = "") -> CacheEntry:
        """One executable per scenario family. ``fingerprint`` is a
        flight-recorder fingerprint dict (keyed via :func:`cache_key`
        with ``extra``) or a pre-computed key string. ``build()``
        returns the warm callable (typically :func:`aot_compile`); it
        runs OUTSIDE the cache lock, under a ``serve/compile`` span."""
        key = (fingerprint if isinstance(fingerprint, str)
               else cache_key(fingerprint, extra=extra))
        while True:
            with self._lock:
                ent = self._entries.get(key)
                if ent is not None:
                    self._entries.move_to_end(key)
                    ent.hits += 1
                    self._stats["hits"] += 1
                    _HITS.inc()
                    _obs.emit("aot_cache", event="hit", key=key,
                              label=label or ent.label)
                    return ent
                flight = self._inflight.get(key)
                if flight is None:
                    flight = _InFlight()
                    self._inflight[key] = flight
                    break                       # this caller builds
                self._stats["inflight_waits"] += 1
            # someone else is compiling this key: wait off-lock, then
            # re-enter — the published entry reads as a hit
            _WAITS.inc()
            flight.event.wait()
            if flight.error is not None:
                raise flight.error

        manifest = self._read_manifest(key)
        t0 = time.perf_counter()
        try:
            with _obs.span("serve/compile", key=key, label=label):
                executable = build()
        except Exception as e:
            with self._lock:
                flight.error = e
                self._inflight.pop(key, None)
            flight.event.set()
            raise
        compile_s = time.perf_counter() - t0
        entry = CacheEntry(
            key=key, executable=executable,
            fingerprint=(canonicalize(fingerprint)
                         if isinstance(fingerprint, dict) else {}),
            compile_s=compile_s, label=label, built_at=time.time(),
            cold_source="persistent" if manifest else "compile",
            size_bytes=estimate_executable_bytes(executable),
            mode=str(getattr(executable, "mode", "eager")))
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            self._stats["misses"] += 1
            self._stats["bytes"] += entry.size_bytes
            self._evict_over_limits_locked()
            flight.entry = entry
            self._inflight.pop(key, None)
        _MISSES.inc()
        _H_BUILD[entry.cold_source].observe(compile_s)
        _obs.emit("aot_cache", event="miss", key=key, label=label,
                  compile_s=round(compile_s, 3),
                  cold_source=entry.cold_source,
                  size_bytes=entry.size_bytes, mode=entry.mode)
        self._write_manifest(entry)
        flight.event.set()
        return entry

    # -- manifest sidecars --------------------------------------------------

    def manifest_path(self, key: str) -> Optional[str]:
        if not self.directory:
            return None
        return os.path.join(self.directory, f"{key}.json")

    def _write_manifest(self, entry: CacheEntry) -> None:
        path = self.manifest_path(entry.key)
        if path is None:
            return
        body = {"manifest_schema": MANIFEST_SCHEMA, "key": entry.key,
                "fingerprint": entry.fingerprint,
                "compile_s": round(entry.compile_s, 3),
                "built_at": entry.built_at, "label": entry.label,
                "mode": entry.mode}
        blob = json.dumps(canonicalize(body), sort_keys=True)
        doc = {"digest": hashlib.sha256(blob.encode()).hexdigest(),
               "body": body}
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            # a failed sidecar write costs the next process one
            # cold-source misattribution, never correctness
            try:
                os.remove(tmp)
            except OSError:
                pass

    def _read_manifest(self, key: str) -> Optional[dict]:
        """Digest-verified manifest body, or None (absent OR corrupt).
        A mismatched digest is REFUSED — counted, the file deleted, the
        caller recompiles. Corruption never loads."""
        path = self.manifest_path(key)
        if path is None or not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                doc = json.load(f)
            body = doc["body"]
            blob = json.dumps(canonicalize(body), sort_keys=True)
            if (doc.get("digest")
                    != hashlib.sha256(blob.encode()).hexdigest()):
                raise ValueError("manifest digest mismatch")
            if body.get("key") != key:
                raise ValueError("manifest key mismatch")
            if body.get("manifest_schema") != MANIFEST_SCHEMA:
                raise ValueError("unknown manifest schema")
            return body
        except Exception as e:  # noqa: BLE001 - refusal, not death
            with self._lock:
                self._stats["corrupt"] += 1
            _CORRUPT.inc()
            _obs.emit("aot_cache", event="corrupt", key=key,
                      error=f"{type(e).__name__}: {e}")
            try:
                os.remove(path)
            except OSError:
                pass
            return None

    def published_keys(self) -> list:
        """Keys with a VALID manifest on disk (the persistent layer's
        directory listing; corrupt sidecars are excluded and reaped)."""
        if not self.directory:
            return []
        out = []
        for name in sorted(os.listdir(self.directory)):
            if not name.endswith(".json") or name.count(".") != 1:
                continue
            key = name[:-len(".json")]
            if self._read_manifest(key) is not None:
                out.append(key)
        return out


# -- module-default cache (the spectral-plan module-cache idiom) ------------

_default_cache: Optional[ExecutableCache] = None
_default_lock = threading.Lock()


def get_cache() -> ExecutableCache:
    """The process-default executable cache. Manifest sidecars go to
    ``$IBAMR_AOT_CACHE`` when set (memory-only otherwise)."""
    global _default_cache
    with _default_lock:
        if _default_cache is None:
            _default_cache = ExecutableCache(
                directory=os.environ.get("IBAMR_AOT_CACHE") or None)
        return _default_cache


def executable_cache_stats() -> dict:
    """Hit/miss/eviction counts of the default cache (a caller reports
    per-stage deltas of these as ``cache_hits``/``cache_misses``)."""
    return get_cache().stats()


def clear_executable_cache() -> None:
    """Reset the default cache (tests)."""
    get_cache().clear()


# -- AOT step helpers -------------------------------------------------------

class WarmCallable:
    """A cache entry's callable: ``fn`` after its warm-up call (``mode
    "eager"``), or ``fn`` captured as a CUDA graph (``mode "graph"``),
    whose outputs are copied out of the graph's buffers on every call so
    that they outlive the next replay."""

    def __init__(self, fn, mode: str = "eager", graph=None,
                 size_bytes: int = 0):
        self.fn = fn
        self.mode = mode
        self.graph = graph
        self.size_bytes = int(size_bytes)

    def __call__(self, *args):
        if self.graph is None:
            return self.fn(*args)
        import torch

        from ibamr_tpu_torch.utils.tree import tree_map

        return tree_map(torch.clone, self.graph(tuple(args)))


def _tensor_bytes(tree) -> int:
    import torch

    from ibamr_tpu_torch.utils.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def step_callable(integ, *, donate: bool = True,
                  with_stats: bool = False):
    """The exact python callable the cache builds for an integrator
    step, and the reference's donate_argnums (the port donates nothing:
    eager PyTorch has no buffer donation)."""
    base = integ.step_with_stats if with_stats else integ.step
    return base, ((0,) if donate else ())


def aot_compile(fn, args, donate_argnums=(), *, graph_safe: bool = False):
    """The build every cache entry holds: one warm-up call of
    ``fn(*args)`` (the kernels' build, cuFFT plans, layouts), then a
    :class:`WarmCallable`. With ``graph_safe`` (the caller vouches that
    ``fn`` reads nothing to the host and branches on no device value)
    and tensor arguments on a CUDA device, ``fn`` is captured as a CUDA
    graph after its warm-up (``utils/cuda_graph.Graphed``); a capture
    that fails, or an argument leaf that is not a CUDA tensor, raises.
    On the CPU there is no graph: the entry is the warm eager call.
    ``donate_argnums`` is accepted for the reference's signature and
    ignored."""
    import torch

    from ibamr_tpu_torch.utils.cuda_graph import Graphed
    from ibamr_tpu_torch.utils.timers import block_until_ready
    from ibamr_tpu_torch.utils.tree import leaves

    args = tuple(args)
    ls = leaves(args)
    if graph_safe and any(isinstance(a, torch.Tensor) and a.is_cuda
                          for a in ls):
        if not all(isinstance(a, torch.Tensor) and a.is_cuda for a in ls):
            raise ValueError("aot_compile(graph_safe=True): every argument "
                             "leaf must be a CUDA tensor to be captured")
        graph = Graphed(lambda a: fn(*a), args)
        torch.cuda.synchronize()
        size = _tensor_bytes(graph.static_in) + _tensor_bytes(
            graph.static_out)
        return WarmCallable(fn, mode="graph", graph=graph, size_bytes=size)
    block_until_ready(fn(*args))
    return WarmCallable(fn, mode="eager")


def cached_step(integ, state, dt, *, donate: bool = True,
                with_stats: bool = False, spec: Optional[dict] = None,
                extra: Optional[dict] = None,
                cache: Optional[ExecutableCache] = None,
                label: str = ""):
    """Get-or-build the integrator step for ``state``'s shape family
    through the executable cache. Returns ``(callable, entry)`` where the
    callable has the step's calling convention (``new_state = f(state,
    dt)``, or ``(new_state, stats)`` with ``with_stats``). The step reads
    its packed layout's overflow flags to the host, so it is never
    captured: the entry is a warm eager callable."""
    cache = cache if cache is not None else get_cache()
    fp = step_fingerprint(integ, spec=spec)
    fn, _ = step_callable(integ, donate=donate, with_stats=with_stats)
    key_extra = {"kind": "step", "donate": bool(donate),
                 "with_stats": bool(with_stats),
                 "args": arg_signature((state, dt))}
    if extra:
        key_extra.update(extra)
    entry = cache.get_or_compile(
        fp, lambda: aot_compile(fn, (state, dt)),
        extra=key_extra, label=label or "step")
    return entry.executable, entry
