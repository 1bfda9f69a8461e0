"""The assimilation cycle: observe -> analyze -> advance, supervised
(port of ``ibamr_tpu/assim/cycle.py``).

One :class:`AssimilationCycle` turns the lane fleet into a forecasting
service. The forecast leg is the ordinary fleet driver chunk (each live
lane's slice stepped at its own dt, dead lanes frozen); the analysis leg
rides the driver's regrid hook, the one cadence callback whose return
value REPLACES the state, so every ``steps_per_cycle`` steps the masked
ESRF update (:mod:`ibamr_tpu_torch.assim.enkf`) moves all B lanes
between chunks, inside the same supervised run loop that already owns
checkpointing, rollback and lane quarantine.

Robustness wiring:

- the two analysis pieces are built ONCE through the executable cache
  (:class:`~ibamr_tpu_torch.serve.aot_cache.ExecutableCache`, ``kind:
  "assim_chunk"``) and keyed on shapes only: quarantine flips the (B,)
  alive mask's *values*, QC the (m,) obs mask's values, inflation is a
  tensor scalar, so every later lookup is a hit. ``observe`` (the
  predicted observations' masked mean and variance, gathers and
  reductions only) is captured as a CUDA graph on the card; ``analyze``
  stays a warm eager callable, because ``torch.linalg.eigh`` checks its
  result on the host and cannot be captured, and splitting it around an
  eager eigh would capture only the two ensemble products, which run
  once a cycle;
- filter-health sentinels (ensemble-spread collapse, sustained
  innovation-consistency drift) raise :class:`FilterDegraded`, a
  :class:`SimulationDiverged` with ``kind="filter_degraded"``, so the
  supervisor rolls the whole cycle back to a verified checkpoint and
  retries with the multiplicative inflation escalated one
  :data:`INFLATION_FALLBACKS` rung (dt untouched: the flow is fine, the
  *filter* was mistuned);
- after every analysis the cycle calls ``HealthProbe.rebaseline()``: an
  analysis legitimately moves every lane's functional, volume and budget
  anchors;
- every cycle runs under its own ``trace_id`` (``assim/cycle`` span),
  emits a terminal ``assim_cycle`` ledger record, and publishes
  forecast-error, spread and consistency gauges on the bus, so lost
  cycles are countable from the ledger alone.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ibamr_tpu_torch import obs as _obs
from ibamr_tpu_torch.assim import enkf as _enkf
from ibamr_tpu_torch.assim import qc as _qc
from ibamr_tpu_torch.assim.observe import (ObservationOperator,
                                           stream_from_list)
from ibamr_tpu_torch.utils.hierarchy_driver import (HierarchyDriver,
                                                    RunConfig,
                                                    SimulationDiverged,
                                                    _state_device)

# the ENGINE_FALLBACKS / PRECISION_FALLBACKS chain shape: each rung
# maps to the next-stronger one; the top rung has no successor (the
# supervisor then falls back to its generic dt-backoff retry, which
# for a filter fault effectively gives up gracefully)
INFLATION_FALLBACKS = {
    1.0: 1.05,
    1.05: 1.1,
    1.1: 1.2,
    1.2: 1.4,
    1.4: 1.7,
}

_obs.describe("assim_cycles_total", "completed assimilation cycles")
_obs.describe("assim_cycles_skipped_total",
              "cycles with no usable observations (analysis skipped)")
_obs.describe("assim_inflation_escalations_total",
              "multiplicative-inflation rungs climbed after rollback")
_obs.describe("assim_analysis_wall_seconds",
              "wall time of one masked ESRF analysis (device + host)")
_obs.describe("assim_forecast_error",
              "rms innovation over QC-accepted channels (forecast "
              "error proxy against live sensors)")
_obs.describe("assim_spread", "masked ensemble spread after analysis")
_obs.describe("assim_consistency",
              "innovation chi2 / expected (healthy ~ 1)")


class FilterDegraded(SimulationDiverged):
    """The FILTER (not the flow) went statistically bad: ensemble
    spread collapsed below the floor, or the innovation-consistency
    ratio drifted out of band for ``sustain`` consecutive cycles.
    Subclassing :class:`SimulationDiverged` reuses the whole recovery
    machinery; ``escalate`` (when set by the cycle) lets the
    supervisor climb the inflation ladder instead of backing off dt.
    """

    kind = "filter_degraded"

    def __init__(self, step: int, reasons, diagnostics: dict,
                 escalate: Optional[Callable] = None):
        self.step = step
        self.reasons = list(reasons)
        self.diagnostics = dict(diagnostics)
        self.escalate = escalate
        self.bad_leaves: list = []      # the state itself is finite
        RuntimeError.__init__(
            self,
            f"filter degraded by step {step}: "
            f"{'; '.join(self.reasons)} (diagnostics "
            f"{self.diagnostics}) — rolling back to retry with "
            f"escalated inflation")

    def incident_payload(self) -> dict:
        return {"reasons": self.reasons,
                "diagnostics": self.diagnostics}


@dataclass
class AssimConfig:
    """Cycle cadence + filter tuning + sentinel thresholds."""
    steps_per_cycle: int = 2
    dt: float = 1e-3
    inflation: float = 1.0              # must sit on the ladder
    spread_floor: float = 0.0           # 0 disables the collapse sentinel
    consistency_ceiling: float = 0.0    # 0 disables the drift sentinel
    sustain: int = 3                    # consecutive bad cycles to fire
    qc: _qc.QCConfig = field(default_factory=_qc.QCConfig)


class AssimilationCycle:
    """A recurring forecasting tenant over a B-lane fleet driver."""

    def __init__(self, integ, obs_op: ObservationOperator, lanes: int,
                 cfg: AssimConfig, *, probe=None, cache=None,
                 recorder=None, fleet_step_wrap=None,
                 restart_interval: Optional[int] = None):
        from ibamr_tpu_torch.serve.aot_cache import get_cache

        self.integ = integ
        self.obs_op = obs_op
        self.lanes = int(lanes)
        self.cfg = cfg
        self.inflation = float(cfg.inflation)
        self.cache = cache if cache is not None else get_cache()
        self.probe = probe
        self.obs_source: Optional[Callable] = None
        self._packer = None
        self._drift_streak = 0
        self._skipped = 0
        self.escalations: list = []

        run_cfg = RunConfig(
            dt=cfg.dt, num_steps=cfg.steps_per_cycle,
            health_interval=cfg.steps_per_cycle,
            restart_interval=(restart_interval
                              if restart_interval is not None
                              else cfg.steps_per_cycle),
            regrid_interval=cfg.steps_per_cycle)
        self.driver = HierarchyDriver(
            integ, run_cfg, lanes=self.lanes,
            regrid_fn=self._analysis_hook, health_probe=probe,
            recorder=recorder, fleet_step_wrap=fleet_step_wrap)

    # -- cached pieces (kind: assim_chunk) -----------------------------------

    def _packers(self, fleet_state):
        if self._packer is None:
            from ibamr_tpu_torch.utils.lanes import lane_slice
            self._packer = _enkf.state_packer(lane_slice(fleet_state, 0))
        return self._packer

    def _fingerprint(self, piece: str, args) -> tuple:
        from ibamr_tpu_torch.serve.aot_cache import (arg_signature,
                                                     step_fingerprint)
        fp = step_fingerprint(self.integ, extra={
            "assim": {"channels": list(self.obs_op.channels),
                      "n_meters": self.obs_op.n_meters,
                      "lanes": self.lanes}})
        extra = {"kind": "assim_chunk", "piece": piece,
                 "args": arg_signature(args)}
        return fp, extra

    def _observe_exec(self, fleet_state, alive):
        """(ybar, hph) of the predicted obs ensemble: QC's inputs. Pure
        gathers and reductions, so the card captures it as a CUDA graph
        (``graph_safe``); the CPU runs it eagerly."""
        from ibamr_tpu_torch.serve.aot_cache import aot_compile

        def observe(state, alive_m):
            obs_ens = self.obs_op.fleet(state)
            ybar, zy, neff = _enkf.masked_moments(obs_ens, alive_m)
            hph = torch.sum(zy * zy, dim=0) / torch.clamp(neff - 1.0,
                                                          min=1.0)
            return ybar, hph

        args = (fleet_state, alive)
        fp, extra = self._fingerprint("observe", args)
        ent = self.cache.get_or_compile(
            fp, lambda: aot_compile(observe, args, graph_safe=True),
            extra=extra, label="assim_observe")
        return ent.executable

    def _analyze_exec(self, fleet_state, y, r, obs_mask, alive, infl):
        """The masked ESRF update of the whole fleet: a warm eager
        callable (the ensemble-space eigh reads its status to the
        host)."""
        from ibamr_tpu_torch.serve.aot_cache import aot_compile
        from ibamr_tpu_torch.utils.lanes import (fleet_size, lane_slice,
                                                 stack_lanes)

        pack, unpack, _n = self._packers(fleet_state)

        def analyze(state, y_v, r_v, om, alive_m, lam):
            B = fleet_size(state)
            lanes = [lane_slice(state, i) for i in range(B)]
            ens = torch.stack([pack(s) for s in lanes])
            obs_ens = self.obs_op.fleet(state)
            ana, diag = _enkf.esrf_analysis(
                ens, obs_ens, y_v, r_v, alive_m, om, lam)
            new_state = stack_lanes([unpack(s, ana[i])
                                     for i, s in enumerate(lanes)])
            return new_state, diag

        args = (fleet_state, y, r, obs_mask, alive, infl)
        fp, extra = self._fingerprint("analyze", args)
        ent = self.cache.get_or_compile(
            fp, lambda: aot_compile(analyze, args),
            extra=extra, label="assim_analyze")
        return ent.executable

    # -- inflation ladder ----------------------------------------------------

    def escalate_inflation(self) -> Optional[tuple]:
        """One rung up :data:`INFLATION_FALLBACKS`; returns (before,
        after) or None at the top. Called by the supervisor on a
        ``filter_degraded`` rollback; nothing is rebuilt (inflation is
        a tensor argument), so the retry reruns the same cached
        callables with a stronger filter."""
        cur = self.inflation
        nxt = next((v for k, v in INFLATION_FALLBACKS.items()
                    if abs(k - cur) < 1e-12), None)
        if nxt is None:
            return None
        self.inflation = float(nxt)
        self._drift_streak = 0
        self.escalations.append((cur, nxt))
        _obs.counter("assim_inflation_escalations_total").inc()
        return (cur, nxt)

    # -- the cycle hook (runs at the driver's regrid cadence) ----------------

    def _analysis_hook(self, state, step: int):
        cfg = self.cfg
        cycle = step // cfg.steps_per_cycle - 1
        batch = (self.obs_source(cycle, step)
                 if self.obs_source is not None else None)
        if batch is None:
            self._skipped += 1
            _obs.counter("assim_cycles_skipped_total").inc()
            return state

        tid = _obs.new_trace_id()
        with _obs.trace_scope(tid):
            with _obs.span("assim/cycle", cycle=int(cycle),
                           step=int(step)):
                return self._run_analysis(state, batch, cycle, step)

    def _run_analysis(self, state, batch, cycle: int, step: int):
        cfg = self.cfg
        dev = _state_device(state)
        alive = torch.as_tensor(self.driver.lane_alive, device=dev)
        t0 = time.perf_counter()

        # observe: ensemble-predicted mean/variance per channel
        with _obs.span("assim/observe"):
            obs_exec = self._observe_exec(state, alive)
            ybar, hph = obs_exec(state, alive)
            ybar = ybar.detach().to("cpu", torch.float64).numpy()
            hph = hph.detach().to("cpu", torch.float64).numpy()

        # QC gate (host-side; rejections are structured records)
        with _obs.span("assim/qc"):
            accept, qc_report = _qc.screen(
                batch, ybar, hph, cfg.qc, step=step, cycle=cycle)
        if qc_report["accepted"] < cfg.qc.min_accept:
            self._skipped += 1
            _obs.counter("assim_cycles_skipped_total").inc()
            _obs.emit("assim_cycle", cycle=int(cycle), step=int(step),
                      skipped=True, **qc_report)
            return state

        # analyze: masked ESRF update of every alive lane
        dt0 = state.ins.p.dtype
        y = torch.nan_to_num(torch.as_tensor(
            batch.values, dtype=torch.float64)).to(dev, dt0)
        r = torch.as_tensor(batch.r, dtype=torch.float64).to(dev, dt0)
        om = torch.as_tensor(accept, device=dev)
        infl = torch.tensor(self.inflation, dtype=dt0, device=dev)
        with _obs.span("assim/analyze"):
            ana_exec = self._analyze_exec(state, y, r, om, alive, infl)
            new_state, diag = ana_exec(state, y, r, om, alive, infl)
            diag = _enkf.AnalysisDiag(*(
                float(v) for v in torch.stack(list(diag)).cpu()))
        wall = time.perf_counter() - t0

        # sentinels: the filter's own health
        reasons = []
        if cfg.spread_floor > 0.0 and diag.spread_a < cfg.spread_floor:
            reasons.append(
                f"ensemble spread collapsed: {diag.spread_a:.3e} < "
                f"floor {cfg.spread_floor:.3e}")
        if cfg.consistency_ceiling > 0.0 \
                and diag.consistency > cfg.consistency_ceiling:
            self._drift_streak += 1
            if self._drift_streak >= cfg.sustain:
                reasons.append(
                    f"innovation consistency drifted: "
                    f"{diag.consistency:.2f} > "
                    f"{cfg.consistency_ceiling:.2f} for "
                    f"{self._drift_streak} cycles")
        else:
            self._drift_streak = 0
        if reasons:
            raise FilterDegraded(
                step, reasons,
                {"spread_a": diag.spread_a, "spread_f": diag.spread_f,
                 "consistency": diag.consistency,
                 "inflation": self.inflation,
                 "n_alive": diag.n_alive, "cycle": int(cycle)},
                escalate=self.escalate_inflation)

        # telemetry: gauges + the cycle's terminal ledger record
        _obs.gauge("assim_forecast_error").set(diag.innov_rms)
        _obs.gauge("assim_spread").set(diag.spread_a)
        _obs.gauge("assim_consistency").set(diag.consistency)
        _obs.gauge("assim_inflation").set(self.inflation)
        _obs.histogram("assim_analysis_wall_seconds").observe(wall)
        _obs.counter("assim_cycles_total").inc()
        _obs.emit("assim_cycle", cycle=int(cycle), step=int(step),
                  skipped=False, forecast_error=diag.innov_rms,
                  spread_f=diag.spread_f, spread_a=diag.spread_a,
                  consistency=diag.consistency,
                  inflation=self.inflation,
                  n_alive=int(diag.n_alive), n_obs=int(diag.n_obs),
                  analysis_wall_s=wall, **qc_report)

        # analysis moved every lane: re-anchor the vitals baselines or
        # the next chunk's drift triage false-positives a WARN
        if self.probe is not None:
            self.probe.rebaseline()
        return new_state

    # -- service entry -------------------------------------------------------

    def run(self, state0, batches=None, *, directory: str,
            n_cycles: Optional[int] = None,
            obs_source: Optional[Callable] = None,
            max_retries: int = 3, handle_signals: bool = False,
            recorder=None, **supervisor_kw):
        """Assimilate ``batches`` (one per cycle) into the fleet under
        full supervision; returns the final lane-stacked state. Each
        cycle is forecast (``steps_per_cycle`` driver steps) followed
        by the analysis hook; rollbacks re-fetch the SAME batch for a
        re-run cycle, so retries are deterministic.

        ``obs_source`` overrides the batch list with a callable
        ``(cycle, step) -> ObservationBatch | None`` — the seam the
        fault-injection drills wrap sensor faults around (pass
        ``n_cycles`` alongside, or ``batches`` just for its length)."""
        from ibamr_tpu_torch.utils.supervisor import ResilientDriver

        if batches is not None:
            batches = list(batches)
            if n_cycles is None:
                n_cycles = len(batches)
        if n_cycles is None:
            raise ValueError("run() needs batches or n_cycles")
        self.obs_source = (obs_source if obs_source is not None
                           else stream_from_list(batches or []))
        self.driver.cfg.num_steps = \
            n_cycles * self.cfg.steps_per_cycle
        sup = ResilientDriver(
            self.driver, directory, max_retries=max_retries,
            handle_signals=handle_signals, recorder=recorder,
            **supervisor_kw)
        return sup.run(state0)
