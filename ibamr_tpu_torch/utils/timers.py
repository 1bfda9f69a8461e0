"""Hierarchical wall-clock timers (port of ``ibamr_tpu/utils/timers.py``).

Named timers bracket significant methods, with a report table at
shutdown (SAMRAI's ``TimerManager``). CUDA runs asynchronously, so a
scope may block on a pytree of tensors before it reads the clock: when
that pytree holds a CUDA tensor the scope calls ``torch.cuda.synchronize``
first. A scope is also a telemetry span (``ibamr_tpu_torch.obs.span``):
it closes into the attached run ledger and names a
``torch.profiler.record_function`` range. :func:`profile_trace` captures
a ``torch.profiler`` trace of a region into a directory.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def block_until_ready(tree) -> None:
    """Wait for the device work behind every CUDA tensor of ``tree``."""
    if any(t.is_cuda for t in _leaves(tree)):
        torch.cuda.synchronize()


class Timer:
    """Re-entrant named timer: nested start/stop pairs with the same name are
    supported (recursive methods bracketed by one timer, as in the reference's
    TimerManager)."""

    __slots__ = ("name", "total", "count", "_starts")

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.count = 0
        self._starts: list = []

    def start(self) -> None:
        self._starts.append(time.perf_counter())

    def stop(self, block_on=None) -> float:
        if not self._starts:
            raise RuntimeError(f"Timer {self.name!r}: stop() without start()")
        if block_on is not None:
            block_until_ready(block_on)
        dt = time.perf_counter() - self._starts.pop()
        # only the outermost frame of a re-entrant timer accumulates, so
        # `total` stays wall-clock (matching SAMRAI's exclusive-timer report)
        if not self._starts:
            self.total += dt
            self.count += 1
        return dt


class TimerManager:
    """Process-wide named-timer registry with a report table."""

    _instance: Optional["TimerManager"] = None

    def __init__(self):
        self.timers: Dict[str, Timer] = {}

    @classmethod
    def instance(cls) -> "TimerManager":
        if cls._instance is None:
            cls._instance = TimerManager()
        return cls._instance

    def get(self, name: str) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer(name)
        return self.timers[name]

    @contextmanager
    def scope(self, name: str, block_on=None):
        # the scope IS a telemetry span: the span blocks on ``block_on``
        # before its clock read and closes into the attached ledger; the
        # Timer accumulates right after it, for report()
        from ibamr_tpu_torch.obs import span as _span

        t = self.get(name)
        t.start()
        try:
            with _span(name, block_on=block_on):
                yield t
        finally:
            t.stop()

    def report(self) -> str:
        if not self.timers:
            return "TimerManager: no timers recorded"
        width = max(len(n) for n in self.timers) + 2
        lines = [f"{'Timer':<{width}}{'Calls':>8}{'Total (s)':>12}{'Mean (ms)':>12}"]
        for name in sorted(self.timers, key=lambda n: -self.timers[n].total):
            t = self.timers[name]
            mean_ms = 1e3 * t.total / max(t.count, 1)
            lines.append(f"{name:<{width}}{t.count:>8}{t.total:>12.4f}{mean_ms:>12.3f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.timers.clear()


@contextmanager
def timer(name: str, block_on=None):
    """Module-level convenience: ``with timer("IB::spreadForce"): ...``"""
    with TimerManager.instance().scope(name, block_on=block_on) as t:
        yield t


@contextmanager
def profile_trace(log_dir: Optional[str], stage: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the enclosed region (CPU
    and, on a GPU, CUDA activity) and export it as a Chrome trace,
    ``<log_dir>/trace.json``, viewable in Perfetto. A no-op when
    ``log_dir`` is falsy, so call sites can thread a ``--profile DIR``
    flag through unconditionally. The capture runs inside an
    ``obs.span("profile_trace", capture_dir=..., stage=...)``, and a
    ``profile`` ledger record naming the trace file lands when it
    closes. The spans and timer scopes inside the region show up as
    ``record_function`` ranges. The block receives the
    ``torch.profiler.profile`` (``None`` when ``log_dir`` is falsy), whose
    ``key_averages()`` are readable once the block has closed."""
    if not log_dir:
        yield
        return
    import os

    from ibamr_tpu_torch import obs

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(str(log_dir), "trace.json")
    with obs.span("profile_trace", capture_dir=str(log_dir), stage=stage):
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(path)
            obs.emit("profile", capture_dir=str(log_dir), stage=stage,
                     trace=path)
