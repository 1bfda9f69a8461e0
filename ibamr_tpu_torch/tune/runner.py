"""Measured trials: build a candidate, time a warm-up chunk, then time warm
chunks (port of ``ibamr_tpu/tune/runner.py``).

A trial is one :class:`~ibamr_tpu_torch.tune.space.Candidate` built into
a real integrator (the port never degrades to another engine, so a trial
always times the engine it names). As in the reference, each candidate's
``L``-step chunk is built once through the executable cache
(``serve/aot_cache.py``, key material ``kind: "tune_chunk"``, the chunk
length and the argument signature): a chunk is ``L`` eager
``integ.step`` calls, the cache's build is its warm-up call and its
seconds are the trial's ``compile_s`` (the kernels' build and first
launch), and ``cache_hit`` / ``recompiles`` are the cache's hit and miss
deltas over the lookup, so a repeated candidate is a hit. The chunk
reads the state to the host, so its entry is a warm eager callable, never
a captured graph. The timed leg drains one chunk, then runs ``reps``
warm chunks between two ``torch.cuda.synchronize()`` calls (on the
card), so a trial measures steady steps/s, not dispatch or build.

A chunk ends as a chunk of ``utils/hierarchy_driver.py`` ends: with the
finite flag of the whole state read to the host, the driver's one
synchronisation a chunk. So chunk length measures what it costs in a
run: a chunk of ``L`` steps pays that read (the device drains while the
host waits, then refills the queue) once, and longer chunks amortize it.

Every trial lands on the telemetry bus (``ibamr_tpu_torch.obs``) as a
``tune/trial`` span and a ``tune_trial`` ledger record plus the
``tune_{trials,pruned,errors}_total`` counters; a search is a
``tune/search`` span.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Optional, Sequence

import torch

from ibamr_tpu_torch import obs as _obs
from ibamr_tpu_torch.tune.space import (Candidate, DEFAULT_ENGINES,
                                        PROBE_PRUNE, enumerate_space,
                                        make_probe_fn)

_TRIALS = _obs.counter("tune_trials_total")
_PRUNED = _obs.counter("tune_pruned_total")
_ERRORS = _obs.counter("tune_errors_total")


@dataclass
class TrialResult:
    candidate: Candidate
    steps_per_s: float = 0.0
    ms_per_step: float = 0.0
    compile_s: float = 0.0
    cache_hit: bool = False
    recompiles: int = 0
    error: Optional[str] = None

    def row(self) -> dict:
        out = asdict(self.candidate)
        out.update(steps_per_s=round(self.steps_per_s, 4),
                   ms_per_step=round(self.ms_per_step, 4),
                   compile_s=round(self.compile_s, 3),
                   cache_hit=self.cache_hit, error=self.error)
        return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_trial(candidate: Candidate, *, n_cells: int = 16,
              n_lat: int = 8, n_lon: int = 16, dt: float = 5e-5,
              reps: int = 3, mu: float = 0.05, cache=None,
              label: str = "", device="cuda") -> TrialResult:
    """One measured trial on ``device``. A build or step failure is
    reported in ``TrialResult.error`` (and counted), never raised: the
    search finishes its grid even when one candidate dies. ``cache``
    defaults to the process's executable cache."""
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.serve import aot_cache
    from ibamr_tpu_torch.utils.hierarchy_driver import _finite_flag

    cache = cache if cache is not None else aot_cache.get_cache()
    L = int(candidate.chunk_length)
    res = TrialResult(candidate=candidate)
    try:
        integ, state = build_shell_example(
            n_cells=n_cells, n_lat=n_lat, n_lon=n_lon, radius=0.25,
            aspect=1.2, stiffness=1.0, rest_length_factor=0.75,
            mu=mu, use_fast_interaction=candidate.engine,
            spectral_dtype=candidate.spectral_dtype, device=device)

        def chunk(s):
            for _ in range(L):
                s = integ.step(s, dt)
            if not bool(_finite_flag(s)):   # the driver's host read
                raise FloatingPointError(
                    f"{candidate.label()}: the state went non-finite")
            return s

        fp = aot_cache.step_fingerprint(integ)
        before = cache.stats()
        _sync(device)
        entry = cache.get_or_compile(
            fp, lambda: aot_cache.aot_compile(chunk, (state,)),
            extra={"kind": "tune_chunk", "length": L,
                   "args": aot_cache.arg_signature((state, dt))},
            label=label or f"tune:{candidate.label()}")
        after = cache.stats()
        res.compile_s = entry.compile_s
        res.cache_hit = after["hits"] > before["hits"]
        res.recompiles = after["misses"] - before["misses"]
        exe = entry.executable
        with _obs.span("tune/trial", engine=candidate.engine,
                       spectral_dtype=candidate.spectral_dtype,
                       chunk_length=L, n=n_cells):
            state = exe(state)               # drain the warm-up
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(int(reps)):
                state = exe(state)
            _sync(device)
            elapsed = time.perf_counter() - t0
        per_step = elapsed / max(int(reps) * L, 1)
        res.steps_per_s = 1.0 / max(per_step, 1e-12)
        res.ms_per_step = per_step * 1e3
        _TRIALS.inc()
    except Exception as e:  # noqa: BLE001 - the grid must finish
        res.error = f"{type(e).__name__}: {e}"
        _ERRORS.inc()
    _obs.emit("tune_trial", n=n_cells, markers=n_lat * n_lon,
              engine=candidate.engine,
              spectral_dtype=candidate.spectral_dtype, chunk_length=L,
              steps_per_s=round(res.steps_per_s, 4),
              compile_s=round(res.compile_s, 3),
              cache_hit=res.cache_hit, error=res.error)
    return res


@dataclass
class SearchResult:
    config: dict
    trials: list = field(default_factory=list)
    pruned: list = field(default_factory=list)

    def ranking(self) -> list:
        ok = [t for t in self.trials if t.error is None]
        return sorted(ok, key=lambda t: t.steps_per_s, reverse=True)

    def winner(self) -> Optional[TrialResult]:
        r = self.ranking()
        return r[0] if r else None

    def runner_up(self) -> Optional[TrialResult]:
        """The best trial of another engine than the winner's: the margin
        is engine against engine, not chunk length against chunk
        length."""
        r = self.ranking()
        if not r:
            return None
        return next((t for t in r[1:]
                     if t.candidate.engine != r[0].candidate.engine),
                    None)

    def to_dict(self) -> dict:
        w, ru = self.winner(), self.runner_up()
        margin = (round(w.steps_per_s / max(ru.steps_per_s, 1e-12), 4)
                  if w and ru else None)
        return {
            "config": self.config,
            "trials": [t.row() for t in self.trials],
            "pruned": [{**asdict(c), "reason": r}
                       for c, r in self.pruned],
            "winner": w.row() if w else None,
            "runner_up": ru.row() if ru else None,
            "margin": margin,
        }


def search(*, n_cells: int = 16, n_lat: int = 8, n_lon: int = 16,
           engines: Sequence[str] = DEFAULT_ENGINES,
           spectral_dtypes: Sequence[str] = ("f32", "bf16"),
           chunk_lengths: Sequence[int] = (1, 4), reps: int = 3,
           dt: float = 5e-5, probe: bool = True, device="cuda",
           kernel: str = "IB_4") -> SearchResult:
    """Walk the engine x spectral_dtype x chunk-length grid for one
    configuration key on ``device``, measured. Ineligible candidates are
    pruned statically (never timed); the kernel engines are probed on
    ``device`` first when ``probe``."""
    from ibamr_tpu_torch.ops.delta import get_kernel

    support, _ = get_kernel(kernel)
    n = (int(n_cells),) * 3
    n_markers = int(n_lat) * int(n_lon)
    probe_fn = (make_probe_fn(n, n_lat, n_lon, kernel=kernel,
                              device=device) if probe else None)
    with _obs.span("tune/search", n=n_cells, markers=n_markers):
        candidates, pruned = enumerate_space(
            n, n_markers, support, engines=tuple(engines),
            spectral_dtypes=tuple(spectral_dtypes),
            chunk_lengths=tuple(chunk_lengths), probe_fn=probe_fn)
        for _ in pruned:
            _PRUNED.inc()
        result = SearchResult(
            config={"n": list(n), "n_cells": int(n_cells),
                    "n_lat": int(n_lat), "n_lon": int(n_lon),
                    "markers": n_markers, "dt": dt, "reps": int(reps),
                    "engines": list(engines),
                    "spectral_dtypes": [str(s) for s in spectral_dtypes],
                    "chunk_lengths": [int(L) for L in chunk_lengths]},
            pruned=pruned)
        for cand in candidates:
            result.trials.append(run_trial(
                cand, n_cells=n_cells, n_lat=n_lat, n_lon=n_lon,
                dt=dt, reps=reps, device=device))
    return result


def publish_blockers(d: dict) -> list:
    """Why a search (``SearchResult.to_dict()`` or a captured ``search``
    line) must not be published: each candidate its kernel probe pruned
    and each trial that failed. A winner taken from the survivors would
    steer the resolver off an engine that is broken, not slow."""
    out = [f"{p['engine']}/{p['spectral_dtype']}/L{p['chunk_length']}: "
           f"{p['reason']}" for p in d.get("pruned") or []
           if str(p.get("reason", "")).startswith(PROBE_PRUNE)]
    out += [f"{t['engine']}/{t['spectral_dtype']}/L{t['chunk_length']}: "
            f"trial failed ({t['error']})" for t in d.get("trials") or []
            if t.get("error")]
    return out


def entry_from_search_dict(d: dict, *, platform: str, timestamp: str,
                           device_kind=None, torch_version=None,
                           git_rev=None, source=None) -> Optional[dict]:
    """The publication: the winner of a search (``SearchResult.to_dict()``
    or a captured ``search`` output line) as one schema-v1 DB entry whose
    match fields pin the measured configuration (exact grid, factor-2
    marker band, spectral dtype, platform) and whose provenance pins the
    device it was measured on. None when no trial ran."""
    from ibamr_tpu_torch.tune import db as _db

    w, ru = d.get("winner"), d.get("runner_up")
    if not w:
        return None
    cfg = d.get("config") or {}
    markers = int(cfg.get("markers") or 0)
    measured = {"steps_per_s": w["steps_per_s"],
                "chunk_length": w["chunk_length"],
                "reps": cfg.get("reps"),
                "n_lat": cfg.get("n_lat"), "n_lon": cfg.get("n_lon")}
    if ru:
        measured.update(runner_up=ru["engine"],
                        runner_up_steps_per_s=ru["steps_per_s"],
                        runner_up_chunk_length=ru["chunk_length"],
                        margin=d.get("margin"))
    prov = _db.make_provenance(
        platform, timestamp, device_kind=device_kind,
        torch_version=torch_version, git_rev=git_rev, source=source)
    return _db.make_entry(
        w["engine"], n=cfg.get("n"),
        markers_min=max(1, markers // 2) if markers else None,
        markers_max=markers * 2 if markers else None,
        spectral_dtype=w["spectral_dtype"], platform=platform,
        measured=measured, provenance=prov)


def db_entry_from_search(result: SearchResult, *, platform: str,
                         timestamp: str, device_kind=None,
                         torch_version=None, git_rev=None,
                         source=None) -> Optional[dict]:
    """:func:`entry_from_search_dict` of ``result``."""
    return entry_from_search_dict(
        result.to_dict(), platform=platform, timestamp=timestamp,
        device_kind=device_kind, torch_version=torch_version,
        git_rev=git_rev, source=source)
