"""Supervised rollback-and-retry run loop, the ResilientDriver (port of
``ibamr_tpu/utils/supervisor.py``).

IBAMR answers a mid-run failure with "restart from the last dump"; this
module makes that loop automatic.
:class:`ResilientDriver` wraps :class:`HierarchyDriver.run` so a run
that loses its numerical footing (``SimulationDiverged``), its
checkpoint write (the async writer's one retry + verified-fallback
restore), or its host (SIGTERM/SIGINT preemption) finishes anyway:

- **divergence** -> roll back to the newest VERIFIED checkpoint (or
  the initial state when none exists), shrink dt by ``dt_backoff``,
  and retry, up to ``max_retries`` times;
- **preemption** -> drain the async writer, write a final synchronous
  checkpoint of the last healthy post-chunk state, and return;
- every recovery appends one structured JSONL record to
  ``incidents.jsonl`` so operators see
  what the run survived, not just that it finished;
- **precision drift** (the f64 shadow audit tripping on a bf16/mixed
  spectral path) -> roll back and retry at the NEXT
  ``PRECISION_FALLBACKS`` level (bf16 -> f32 -> f64) with dt UNCHANGED
  — the cure is precision, not stability — recorded as a
  ``precision_escalation`` incident;
- with a :class:`~ibamr_tpu_torch.utils.flight_recorder.FlightRecorder`
  wired (``recorder=`` here or on the driver), EVERY incident record
  is **schema v3**: it carries a ``replay`` pointer to a dumped
  ``incidents/<step>/replay.npz`` + manifest capsule that
  ``ibamr_tpu_torch/tools/replay.py`` re-executes bitwise offline.

The supervisor owns the checkpoint cadence: it installs an
:class:`AsyncCheckpointWriter`-backed ``checkpoint_fn`` on the wrapped
driver (chaining to any user callback) and tracks the last healthy
state via the driver's per-chunk ``metrics_fn`` hook. Divergence can
never poison the chain — the driver raises BEFORE the cadence callback
sees a non-finite state.
"""

from __future__ import annotations

import json
import os
import signal
import time
from typing import Any, Optional

from ibamr_tpu_torch import obs as _obs
from ibamr_tpu_torch.utils.checkpoint import (AsyncCheckpointWriter,
                                              latest_step,
                                              restore_checkpoint,
                                              restore_lane, save_checkpoint)
from ibamr_tpu_torch.utils.hierarchy_driver import (LaneFault,
                                                    SimulationDiverged)

_RETRIES = _obs.counter("supervisor_retries_total")
_ROLLBACKS = _obs.counter("supervisor_rollbacks_total")
_ESCALATIONS = _obs.counter("supervisor_precision_escalations_total")
_LANE_ROLLBACKS = _obs.counter("supervisor_lane_rollbacks_total")
_LANE_QUARANTINES = _obs.counter("supervisor_lane_quarantines_total")


class PreemptionSignal(BaseException):
    """Raised by the installed SIGTERM/SIGINT handler. BaseException so
    integrator/callback ``except Exception`` blocks cannot swallow the
    shutdown request."""

    def __init__(self, signum: int):
        self.signum = signum
        super().__init__(f"preemption signal {signal.Signals(signum).name}")


class ResilientDriver:
    """Wrap a :class:`HierarchyDriver` with rollback-and-retry.

    Parameters
    ----------
    driver:
        The :class:`HierarchyDriver` to supervise. Its
        ``cfg.restart_interval`` sets the checkpoint cadence (and
        therefore the maximum progress one crash can cost).
    checkpoint_dir:
        Where checkpoints and ``incidents.jsonl`` live.
    max_retries:
        Divergence recoveries allowed before the last
        ``SimulationDiverged`` is re-raised.
    dt_backoff:
        Multiplier applied to ``cfg.dt`` on every divergence recovery
        (0.5 halves the step). With ``cfg.cfl`` set the backed-off dt
        still acts as the cap.
    keep:
        Checkpoints retained on disk (the pruner never deletes the
        last verified one regardless).
    handle_signals:
        Install SIGTERM/SIGINT handlers for the duration of ``run``
        (main thread only; silently skipped elsewhere).
    sharded:
        Write per-shard checkpoints (:mod:`ibamr_tpu_torch.utils.
        checkpoint_sharded`) through an :class:`~ibamr_tpu_torch.utils.
        checkpoint_sharded.AsyncShardedWriter`; rollback restores the
        newest VERIFIED sharded step onto the template's layout (a fleet
        lane rolls back to its initial slice, as the reference's does),
        and the preemption save is sharded too.
    mesh:
        Recorded into sharded manifests and (through ``recorder.extra``)
        into incident capsules, so ``tools/replay.py --sharded`` knows
        the mesh a sharded incident ran on.
    """

    def __init__(self, driver, checkpoint_dir: str, *,
                 max_retries: int = 3, dt_backoff: float = 0.5,
                 keep: int = 3, handle_signals: bool = True,
                 incident_log: Optional[str] = None,
                 watchdog=None, recorder=None,
                 sharded: bool = False, mesh=None,
                 quarantine_threshold: float = 0.5):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if not (0.0 < dt_backoff <= 1.0):
            raise ValueError("dt_backoff must be in (0, 1]")
        if not (0.0 < quarantine_threshold <= 1.0):
            raise ValueError("quarantine_threshold must be in (0, 1]")
        self.driver = driver
        # rollback keeps PRE-chunk state references (the initial-state
        # restore template, the preemption save of the last good state)
        # that buffer donation would invalidate: a supervised driver
        # never donates (the reference's contract; the port's eager
        # chunks donate nothing either way)
        if getattr(driver.cfg, "donate", False):
            driver.cfg.donate = False
            driver._chunks = {}
        self.directory = checkpoint_dir
        self.max_retries = max_retries
        self.dt_backoff = dt_backoff
        self.keep = keep
        self.handle_signals = handle_signals
        self.incident_log = incident_log or os.path.join(
            checkpoint_dir, "incidents.jsonl")
        self.incidents = []           # in-memory mirror of the JSONL
        # optional RunWatchdog (utils/watchdog.py): the supervisor
        # feeds it a beat per chunk and points its incident sink here,
        # so a stalled chunk lands in the same incidents.jsonl
        self.watchdog = watchdog
        if watchdog is not None and watchdog.on_incident is None:
            watchdog.on_incident = self._record
        # optional FlightRecorder: installed onto the driver (pre-chunk
        # snapshots) so every incident record can carry a dumped
        # replay capsule — incident schema v3
        self.recorder = recorder if recorder is not None \
            else getattr(driver, "recorder", None)
        if self.recorder is not None \
                and getattr(driver, "recorder", None) is None:
            driver.recorder = self.recorder
        self.sharded = sharded
        self.mesh = mesh
        if self.recorder is not None and (sharded or mesh is not None):
            # capsule fingerprints carry the mesh spec, so a replay can
            # rebuild the sharded program
            from ibamr_tpu_torch.utils.checkpoint_sharded import _mesh_spec
            self.recorder.extra.setdefault("mesh", _mesh_spec(mesh, 1))
            if mesh is not None:
                self.recorder.extra.setdefault(
                    "mesh_shape", [int(s) for s in mesh.devices.shape])
        self._writer = None           # live cadence writer during run()
        self.preempted = False
        self.preempt_signum: Optional[int] = None
        self._last: Optional[tuple] = None   # (state, step) post-chunk
        # ---- fleet (lane-batched) supervision ------------------------
        # per-lane retry budgets: one bad lane burns only its own
        # retries; quarantine_threshold is the give-up knob — when more
        # than this fraction of lanes is quarantined (or every lane is
        # dead) the fleet run is no longer worth the trace and
        # HealthDegraded surfaces
        self.quarantine_threshold = quarantine_threshold
        self._lane_retries: dict = {}

    # -- incident records ---------------------------------------------------

    def _record(self, rec: dict) -> dict:
        rec = dict(rec)
        rec["time"] = time.time()
        rec.setdefault("schema", 3)
        if "replay" not in rec:
            rec["replay"] = self._dump_replay(rec)
        # cross-reference the run ledger: the incident's slim
        # twin lands there as kind "incident" and the JSONL record
        # carries its ledger seq — one pointer from incidents.jsonl to
        # the correlated span/counter stream and back
        seq = _obs.emit(
            "incident",
            event=rec.get("event"), incident_kind=rec.get("kind"),
            step=rec.get("step"), lane=rec.get("lane"),
            retry=rec.get("retry"), replay=rec.get("replay"))
        if seq is not None:
            rec["ledger_seq"] = seq
        self.incidents.append(rec)
        os.makedirs(os.path.dirname(self.incident_log) or ".",
                    exist_ok=True)
        with open(self.incident_log, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
        return rec

    def _dump_replay(self, rec: dict,
                     lane: Optional[int] = None) -> Optional[str]:
        """Dump (or reuse) the replay capsule for one incident record;
        returns the capsule directory or None (no recorder / empty
        ring / dump failure — a failed dump must never mask the
        incident itself). ``lane`` slices a fleet snapshot down to a
        single-lane capsule."""
        if self.recorder is None:
            return None
        try:
            return self.recorder.dump_incident(
                directory=os.path.join(self.directory, "incidents"),
                kind=rec.get("kind", rec.get("event", "incident")),
                step=rec.get("step"), event=rec.get("event"),
                driver=self.driver, lane=lane)
        except Exception as exc:          # pragma: no cover - defensive
            import warnings
            warnings.warn(f"replay capsule dump failed: {exc!r}")
            return None

    # -- precision escalation -----------------------------------------------

    def _escalate_precision(self, e) -> Optional[tuple]:
        """Walk ``spectral_dtype`` one PRECISION_FALLBACKS link up the
        chain on the wrapped integrator (unwrapping one IB layer).
        Returns ``(before, after)`` level names, or None when the chain
        is exhausted / the integrator has no spectral knob — the caller
        then falls through to the plain dt-backoff recovery."""
        from ibamr_tpu_torch.solvers.escalation import (
            PRECISION_FALLBACKS, precision_level_name)
        from ibamr_tpu_torch.solvers.spectral_plan import \
            canonical_spectral_dtype

        integ = self.driver.integ
        fluid = getattr(integ, "ins", integ)
        if not hasattr(fluid, "spectral_dtype"):
            return None
        cur = precision_level_name(fluid.spectral_dtype)
        nxt = PRECISION_FALLBACKS.get(cur)
        if nxt is None:
            return None
        fluid.spectral_dtype = canonical_spectral_dtype(nxt)
        # drop the driver's cached chunks, as the reference drops its
        # compiled ones, so the retry runs the escalated path
        self.driver._chunks = {}
        return cur, nxt

    def _escalate_inflation(self, e) -> Optional[tuple]:
        """Climb the assimilation cycle's multiplicative-inflation
        ladder one INFLATION_FALLBACKS rung (the precision-escalation
        shape for ``kind == "filter_degraded"``). The exception carries
        the cycle's bound ``escalate`` callable; inflation is a traced
        argument of the analysis executable, so no chunk or cache
        invalidation is needed. Returns ``(before, after)`` rungs, or
        None when the ladder is exhausted — the caller then falls
        through to the plain dt-backoff recovery."""
        esc = getattr(e, "escalate", None)
        if not callable(esc):
            return None
        return esc()

    # -- rollback -----------------------------------------------------------

    def _latest(self):
        if self.sharded:
            from ibamr_tpu_torch.utils.checkpoint_sharded import \
                latest_sharded_step
            return latest_sharded_step(self.directory)
        return latest_step(self.directory)

    def _restore(self, template: Any):
        if self.sharded:
            from ibamr_tpu_torch.utils.checkpoint_sharded import \
                restore_sharded
            return restore_sharded(self.directory, template)
        return restore_checkpoint(self.directory, template)

    def _rollback(self, template: Any, initial: tuple):
        """(state, step) to resume from: newest verified checkpoint,
        else the initial state."""
        step = self._latest()
        if step is None:
            return initial[0], initial[1], None
        state, k, _ = self._restore(template)
        return state, k, k

    # -- fleet (lane-batched) recovery --------------------------------------

    def _lane_beat_fields(self) -> dict:
        """Per-lane fields for the watchdog heartbeat (empty dict for a
        solo run, keeping the beat schema unchanged)."""
        driver = self.driver
        if getattr(driver, "lanes", None) is None:
            return {}
        alive = driver.lane_alive
        quarantined = int((~alive).sum())
        retrying = sum(1 for ln, r in self._lane_retries.items()
                       if r > 0 and alive[ln])
        fields = {"lanes_ok": int(driver.lanes) - quarantined - retrying,
                  "lanes_quarantined": quarantined,
                  "lanes_retrying": retrying}
        for k, v in fields.items():
            _obs.gauge(k).set(v)
        return fields

    def _recover_lanes(self, e: LaneFault, initial: tuple):
        """Per-lane rollback / quarantine for a :class:`LaneFault`.

        ``e.state`` is the post-chunk stacked state: healthy lanes'
        progress SURVIVES — only the failing lanes' rows are rewritten,
        each from the newest checkpoint that vouches for that lane
        (falling back to the lane's initial slice). A lane with retry
        budget left gets its own dt backed off and runs again; an
        exhausted lane is quarantined — restored rows, then frozen
        in-graph by the lane-alive mask, so the fleet keeps its one
        compiled trace. Raises :class:`HealthDegraded` only when every
        lane is dead or more than ``quarantine_threshold`` of the fleet
        is quarantined.

        Returns ``(patched_state, resume_step)``.
        """
        from ibamr_tpu_torch.utils.health import HealthDegraded
        from ibamr_tpu_torch.utils.lanes import lane_slice, set_lane

        driver = self.driver
        B = int(driver.lanes)
        state = e.state
        try:
            self._writer.wait()    # pending intervals land before we
        except Exception:          # decide which checkpoint is newest
            pass
        probe = getattr(driver, "health_probe", None)
        for lane in e.lanes:
            retries = self._lane_retries.get(lane, 0)
            reasons = e.lane_reasons.get(lane, [])
            # capsule FIRST, while the failing lane's rows are still
            # the failing bytes (the restore below rewrites them)
            replay = self._dump_replay(
                {"kind": e.kind, "step": e.step}, lane=lane)
            restored = restore_lane(self.directory, state, lane) \
                if not self.sharded else None
            if restored is not None:
                state, ck = restored
                rollback_step, from_ck = int(ck), True
            else:
                state = set_lane(state, lane,
                                 lane_slice(initial[0], lane))
                rollback_step, from_ck = initial[1], False
            base = {"kind": e.kind, "step": e.step, "lane": lane,
                    "fleet_size": B, "reasons": reasons,
                    "bad_leaves": sorted(
                        e.lane_bad_leaves.get(lane, [])),
                    "rollback_step": rollback_step,
                    "from_checkpoint": from_ck, "replay": replay}
            if retries < self.max_retries:
                self._lane_retries[lane] = retries + 1
                _LANE_ROLLBACKS.inc()
                dt_before = float(driver.lane_dt[lane])
                driver.lane_dt[lane] = dt_before * self.dt_backoff
                if probe is not None:
                    probe.reset_lane(lane)
                self._record(dict(base, **{
                    "event": "lane_rollback",
                    "retry": retries + 1,
                    "max_retries": self.max_retries,
                    "dt_before": dt_before,
                    "dt_after": float(driver.lane_dt[lane])}))
            else:
                driver.lane_alive[lane] = False
                _LANE_QUARANTINES.inc()
                self._record(dict(base, **{
                    "event": "lane_quarantine",
                    "retries": retries,
                    "max_retries": self.max_retries}))
        quarantined = int((~driver.lane_alive).sum())
        if quarantined >= B or \
                quarantined / B > self.quarantine_threshold:
            self._record({
                "event": "fleet_give_up", "kind": e.kind,
                "step": e.step, "fleet_size": B,
                "lanes_quarantined": quarantined,
                "quarantine_threshold": self.quarantine_threshold,
                "replay": None})
            raise HealthDegraded(
                e.step,
                [f"{quarantined}/{B} lanes quarantined "
                 f"(threshold {self.quarantine_threshold})"],
                {"fleet_size": B, "lanes_quarantined": quarantined})
        return state, e.step

    # -- main entry ---------------------------------------------------------

    def run(self, state, start_step: int = 0):
        """Advance to ``cfg.num_steps`` surviving divergence and
        preemption; returns the final state (check ``self.preempted``
        to distinguish a completed run from a preempted one)."""
        driver = self.driver
        initial = (state, start_step)
        self._last = initial
        if self.sharded:
            from ibamr_tpu_torch.utils.checkpoint_sharded import \
                AsyncShardedWriter
            writer = AsyncShardedWriter(self.directory, keep=self.keep,
                                        mesh=self.mesh)
        else:
            writer = AsyncCheckpointWriter(
                self.directory, keep=self.keep,
                lanes=getattr(driver, "lanes", None))
        self._writer = writer

        user_ckpt = driver.checkpoint_fn
        user_metrics = driver.metrics_fn

        def ckpt_fn(s, k):
            writer.save(s, k)
            if user_ckpt is not None:
                user_ckpt(s, k)

        def metrics_fn(s, k):
            # per-chunk hook: remember the last HEALTHY state — the
            # driver raises on divergence before this runs
            self._last = (s, k)
            if self.watchdog is not None:
                led = _obs.current()
                self.watchdog.beat(
                    step=k,
                    last_chunk_wall_s=getattr(driver,
                                              "last_chunk_wall_s", None),
                    ckpt_queue_depth=writer.queue_depth(),
                    # one pointer from a stalled run's heartbeat to its
                    # ledger (and the exact record to start reading at)
                    ledger_path=(led.path if led is not None else None),
                    ledger_seq=(led.last_seq if led is not None
                                else None),
                    **self._lane_beat_fields())
            return user_metrics(s, k) if user_metrics is not None else None

        driver.checkpoint_fn = ckpt_fn
        driver.metrics_fn = metrics_fn

        old_handlers = {}
        if self.handle_signals:
            def _handler(signum, frame):
                raise PreemptionSignal(signum)
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    old_handlers[sig] = signal.signal(sig, _handler)
                except ValueError:     # not the main thread
                    break

        retries = 0
        cur_state, cur_step = state, start_step
        if self.watchdog is not None:
            self.watchdog.start()
        try:
            while True:
                try:
                    out = driver.run(cur_state, start_step=cur_step)
                    writer.wait()      # every interval durably on disk
                    return out
                except LaneFault as e:
                    # fleet mode: one bad lane must not sink the fleet
                    # — recovery is PER LANE (rollback + dt backoff,
                    # then quarantine) and the healthy lanes' post-
                    # chunk progress is kept; the run resumes at the
                    # failing chunk's END, never re-running healthy
                    # lanes. _recover_lanes raises HealthDegraded when
                    # the fleet itself is no longer viable.
                    cur_state, cur_step = self._recover_lanes(e, initial)
                except SimulationDiverged as e:
                    # incident schema v3: ``kind`` discriminates the
                    # failure family (divergence | health_degraded |
                    # solver_breakdown | precision_drift), subclass
                    # payloads ride along, ``replay`` points at the
                    # dumped capsule when a recorder is wired
                    kind = getattr(e, "kind", "divergence")
                    payload = e.incident_payload() \
                        if hasattr(e, "incident_payload") else {}
                    dt_before = driver.cfg.dt
                    # dump the capsule NOW, while the driver's compiled
                    # chunk and spectral_dtype still match the failing
                    # execution (escalation below invalidates both)
                    payload["replay"] = self._dump_replay(
                        {"kind": kind, "step": e.step})
                    if retries >= self.max_retries:
                        self._record(dict(payload, **{
                            "event": "give_up", "kind": kind,
                            "step": e.step,
                            "bad_leaves": list(e.bad_leaves),
                            "retries": retries,
                            "dt": dt_before}))
                        raise
                    retries += 1
                    _RETRIES.inc()
                    try:
                        writer.wait()  # pending intervals land first
                    except Exception:
                        pass           # roll back to what's on disk
                    if kind == "precision_drift":
                        esc = self._escalate_precision(e)
                    elif kind == "filter_degraded":
                        esc = self._escalate_inflation(e)
                    else:
                        esc = None
                    cur_state, cur_step, ck = self._rollback(initial[0],
                                                             initial)
                    _ROLLBACKS.inc()
                    if esc is not None:
                        # precision (or filter tuning), not stability,
                        # is the problem: dt stays put; the retry
                        # reruns the rolled-back chunk at the escalated
                        # spectral_dtype / inflation rung
                        _ESCALATIONS.inc()
                        event = ("inflation_escalation"
                                 if kind == "filter_degraded"
                                 else "precision_escalation")
                        before_key, after_key = (
                            ("inflation_before", "inflation_after")
                            if kind == "filter_degraded"
                            else ("spectral_dtype_before",
                                  "spectral_dtype_after"))
                        self._record(dict(payload, **{
                            "event": event,
                            "kind": kind, "step": e.step,
                            "retry": retries,
                            "max_retries": self.max_retries,
                            "rollback_step": cur_step,
                            "from_checkpoint": ck is not None,
                            before_key: esc[0],
                            after_key: esc[1],
                            "dt": dt_before}))
                        continue
                    driver.cfg.dt = dt_before * self.dt_backoff
                    self._record(dict(payload, **{
                        "event": "divergence", "kind": kind,
                        "step": e.step,
                        "bad_leaves": list(e.bad_leaves),
                        "retry": retries,
                        "max_retries": self.max_retries,
                        "rollback_step": cur_step,
                        "from_checkpoint": ck is not None,
                        "dt_before": dt_before,
                        "dt_after": driver.cfg.dt}))
        except PreemptionSignal as e:
            self.preempted = True
            self.preempt_signum = e.signum
            try:
                writer.wait()          # drain enqueued intervals
            except Exception:
                pass
            st, k = self._last
            if self.sharded:
                from ibamr_tpu_torch.utils.checkpoint_sharded import \
                    save_sharded_checkpoint
                save_sharded_checkpoint(self.directory, st, k,
                                        keep=self.keep, mesh=self.mesh,
                                        metadata={"preempted": True})
            else:
                save_checkpoint(self.directory, st, k, keep=self.keep,
                                metadata={"preempted": True},
                                lanes=getattr(driver, "lanes", None))
            self._record({
                "event": "preemption",
                "signal": signal.Signals(e.signum).name,
                "step": k, "checkpoint_step": k})
            return st
        finally:
            if self.watchdog is not None:
                self.watchdog.stop()
            driver.checkpoint_fn = user_ckpt
            driver.metrics_fn = user_metrics
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
            try:
                writer.close()
            except Exception:
                pass
            self._writer = None
