"""Hierarchical wall-clock timers (port of ``ibamr_tpu/utils/timers.py``).

Named timers bracket significant methods, with a report table at
shutdown (SAMRAI's ``TimerManager``). CUDA runs asynchronously, so a
scope may block on a pytree of tensors before it reads the clock: when
that pytree holds a CUDA tensor the scope calls ``torch.cuda.synchronize``
first. The reference's telemetry spans are not ported.
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
        t = self.get(name)
        t.start()
        try:
            yield t
        finally:
            t.stop(block_on=block_on)

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
