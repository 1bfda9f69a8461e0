"""Run watchdog: heartbeat + stalled-chunk detection (port of
``ibamr_tpu/utils/watchdog.py``).

The failure mode the vitals and the solver escalation cannot see is the
run that stops PRODUCING chunks at all: a hung kernel build, a device
that stopped answering, a deadlocked collective. From the outside that run is indistinguishable
from a slow one — no exception, no NaN, no log line — until someone
notices hours later.

:class:`RunWatchdog` makes the silence observable from two directions:

- **outward**: a daemon thread writes ``<dir>/heartbeat.json``
  (``{step, steps_per_s, last_chunk_wall_s, ckpt_queue_depth, time,
  pid}``, plus ``lanes_ok``/``lanes_quarantined``/``lanes_retrying``
  on fleet runs) atomically at
  a fixed cadence, so any EXTERNAL observer — a job scheduler,
  an operator's ``watch cat`` — can distinguish "alive and computing"
  from "process gone/hung" by file staleness alone;
- **inward**: the same thread tracks the wall time since the last
  :meth:`beat` against a rolling expectation of chunk wall time (EMA of
  the driver's measured ``last_chunk_wall_s``) and, once the silence
  exceeds ``stall_factor x`` that expectation (floored at
  ``min_stall_s``), records ONE structured ``stall`` incident (schema
  v2, ``kind: stall``) and invokes the configurable stall callback.
  The detector re-arms on the next beat, so an intermittent stall is
  counted every time it happens, not only once per process.

The watchdog never unwinds the run itself — a stalled chunk usually
cannot be interrupted from Python anyway (the thread is blocked in a device call).
The callback decides the policy: log-and-wait (default), kill a worker
process, or abort the process for the scheduler to
restart.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
import time
from typing import Callable, Optional

HEARTBEAT_NAME = "heartbeat.json"


def write_heartbeat(path: str, payload: dict) -> None:
    """Atomic heartbeat write: temp + ``os.replace`` in the target
    directory, so a reader never sees a torn JSON file (same discipline
    as the checkpoint writes)."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".heartbeat-", suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_heartbeat(path: str) -> Optional[dict]:
    """The parsed heartbeat, or ``None`` when absent/torn (a torn file
    can only be a writer that predates ``write_heartbeat``)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def heartbeat_age(path: str, now: Optional[float] = None) -> Optional[float]:
    """Seconds since the producing RUN last made progress (its last
    ``beat``), or ``None`` when there is no readable heartbeat. THE
    staleness primitive for external observers. Note the ``time`` field
    is deliberately the last-beat time, NOT the last file write: the
    daemon keeps rewriting the file while the main thread hangs in a device call,
    and a heartbeat that stayed fresh through a hung chunk would hide
    exactly the stall this exists to expose."""
    hb = read_heartbeat(path)
    if hb is None or "time" not in hb:
        return None
    return (time.time() if now is None else now) - float(hb["time"])


@dataclasses.dataclass
class RunWatchdog:
    """Heartbeat writer + stalled-chunk detector.

    Parameters
    ----------
    heartbeat_path:
        Where ``heartbeat.json`` lives (``None`` = detector only, no
        file). A directory path is accepted and gets ``heartbeat.json``
        appended.
    interval_s:
        Daemon cadence: heartbeat refresh + stall check period.
    stall_factor:
        A chunk is stalled once the silence since the last beat exceeds
        ``stall_factor x`` the rolling chunk-wall-time expectation.
    min_stall_s:
        Floor on the stall threshold — fast chunks must not turn jitter
        (or the first compile) into false stalls.
    ema_alpha:
        Weight of the newest chunk wall time in the rolling expectation.
    on_stall:
        ``on_stall(record: dict)`` invoked once per detected stall (the
        policy hook: log, kill a subprocess, abort).
    on_incident:
        Structured-record sink (``ResilientDriver`` points this at its
        ``incidents.jsonl`` writer when it owns the watchdog).
    """

    heartbeat_path: Optional[str] = None
    interval_s: float = 1.0
    stall_factor: float = 4.0
    min_stall_s: float = 5.0
    ema_alpha: float = 0.3
    on_stall: Optional[Callable[[dict], None]] = None
    on_incident: Optional[Callable[[dict], None]] = None

    def __post_init__(self):
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if self.stall_factor <= 1.0:
            raise ValueError("stall_factor must be > 1 (a threshold at "
                             "or below the expectation flags every chunk)")
        if self.min_stall_s < 0:
            raise ValueError("min_stall_s must be >= 0")
        if not (0.0 < self.ema_alpha <= 1.0):
            raise ValueError("ema_alpha must be in (0, 1]")
        if (self.heartbeat_path is not None
                and not self.heartbeat_path.endswith(".json")):
            # a directory (existing or not): the file gets the
            # canonical name inside it
            self.heartbeat_path = os.path.join(self.heartbeat_path,
                                               HEARTBEAT_NAME)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # wall-clock of the last beat (creation time before any beat,
        # so a run hung in its FIRST chunk still ages externally)
        self._beat_walltime = time.time()
        self._last_beat: Optional[float] = None
        self._prev_beat: Optional[float] = None
        self._step: Optional[int] = None
        self._prev_step: Optional[int] = None
        self._last_chunk_wall_s: Optional[float] = None
        self._ckpt_queue_depth: Optional[int] = None
        # fleet triage counters: None until the first fleet beat,
        # so solo heartbeats keep their historical schema
        self._lanes_ok: Optional[int] = None
        self._lanes_quarantined: Optional[int] = None
        self._lanes_retrying: Optional[int] = None
        # run-ledger pointer: a stalled run's correlated
        # telemetry stream is one heartbeat read away
        self._ledger_path: Optional[str] = None
        self._ledger_seq: Optional[int] = None
        self._ema_chunk_s: Optional[float] = None
        self._armed = True
        self.stalls: list = []          # one record per detected stall

    # -- producer side ------------------------------------------------------

    def beat(self, step: Optional[int] = None,
             last_chunk_wall_s: Optional[float] = None,
             ckpt_queue_depth: Optional[int] = None,
             lanes_ok: Optional[int] = None,
             lanes_quarantined: Optional[int] = None,
             lanes_retrying: Optional[int] = None,
             ledger_path: Optional[str] = None,
             ledger_seq: Optional[int] = None) -> None:
        """Record liveness (call once per completed chunk). Also
        refreshes the heartbeat file immediately, so the file is never
        staler than the run's real progress; the daemon only keeps it
        warm between long-spaced beats."""
        now = time.monotonic()
        with self._lock:
            self._beat_walltime = time.time()
            self._prev_beat, self._last_beat = self._last_beat, now
            if step is not None:
                self._prev_step, self._step = self._step, int(step)
            if last_chunk_wall_s is not None:
                w = float(last_chunk_wall_s)
                self._last_chunk_wall_s = w
                self._ema_chunk_s = w if self._ema_chunk_s is None else \
                    (1.0 - self.ema_alpha) * self._ema_chunk_s \
                    + self.ema_alpha * w
            if ckpt_queue_depth is not None:
                # async checkpoint backlog: a depth pinned at max means
                # the writer can't keep up with the cadence — an
                # external observer sees I/O pressure building BEFORE
                # saves start dropping or the run starts blocking
                self._ckpt_queue_depth = int(ckpt_queue_depth)
            if lanes_ok is not None:
                self._lanes_ok = int(lanes_ok)
            if lanes_quarantined is not None:
                self._lanes_quarantined = int(lanes_quarantined)
            if lanes_retrying is not None:
                self._lanes_retrying = int(lanes_retrying)
            if ledger_path is not None:
                self._ledger_path = str(ledger_path)
            if ledger_seq is not None:
                self._ledger_seq = int(ledger_seq)
            self._armed = True          # re-arm: the run moved again
            # written under the lock, as the daemon writes: a daemon
            # payload taken before this beat can never land after it
            if self.heartbeat_path is not None:
                write_heartbeat(self.heartbeat_path,
                                self._payload_locked())

    def _payload_locked(self) -> dict:
        sps = None
        if (self._prev_beat is not None and self._step is not None
                and self._prev_step is not None
                and self._last_beat > self._prev_beat
                and self._step > self._prev_step):
            sps = (self._step - self._prev_step) \
                / (self._last_beat - self._prev_beat)
        payload = {"step": self._step, "steps_per_s": sps,
                   "last_chunk_wall_s": self._last_chunk_wall_s,
                   "ckpt_queue_depth": self._ckpt_queue_depth,
                   "time": self._beat_walltime,
                   "written": time.time(), "pid": os.getpid()}
        if self._lanes_ok is not None:
            # fleet run: the external observer sees lane triage in the
            # same file it already watches for staleness
            payload["lanes_ok"] = self._lanes_ok
            payload["lanes_quarantined"] = self._lanes_quarantined
            payload["lanes_retrying"] = self._lanes_retrying
        if self._ledger_path is not None:
            # a stall incident is one pointer away from the correlated
            # telemetry stream (and the seq to start reading at)
            payload["ledger_path"] = self._ledger_path
            payload["ledger_seq"] = self._ledger_seq
        return payload

    # -- detector -----------------------------------------------------------

    def stall_threshold_s(self) -> float:
        with self._lock:
            ema = self._ema_chunk_s
        if ema is None:
            return max(self.min_stall_s, self.stall_factor
                       * self.interval_s)
        return max(self.min_stall_s, self.stall_factor * ema)

    def check(self, now: Optional[float] = None) -> Optional[dict]:
        """One stall check (the daemon calls this every ``interval_s``;
        tests call it directly). Returns the stall record when one
        fires, else ``None``. Fires at most once per beat gap."""
        now = time.monotonic() if now is None else now
        threshold = self.stall_threshold_s()
        with self._lock:
            if self._last_beat is None or not self._armed:
                return None
            age = now - self._last_beat
            if age <= threshold:
                return None
            self._armed = False          # once per silence
            rec = {"event": "stall", "kind": "stall",
                   "step": self._step, "beat_age_s": age,
                   "threshold_s": threshold,
                   "expected_chunk_wall_s": self._ema_chunk_s,
                   "last_chunk_wall_s": self._last_chunk_wall_s}
            self.stalls.append(rec)
        if self.on_incident is not None:
            try:
                self.on_incident(rec)
            except Exception:
                pass                     # the sink must not kill the dog
        if self.on_stall is not None:
            try:
                self.on_stall(rec)
            except Exception:
                pass
        return rec

    # -- daemon -------------------------------------------------------------

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            if self.heartbeat_path is not None:
                with self._lock:
                    try:
                        write_heartbeat(self.heartbeat_path,
                                        self._payload_locked())
                    except OSError:
                        pass             # a full disk must not kill it
            self.check()

    def start(self) -> "RunWatchdog":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="ibamr-watchdog",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0 * self.interval_s)
        self._thread = None

    def __enter__(self) -> "RunWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
