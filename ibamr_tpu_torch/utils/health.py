"""In-flight health vitals: detect degradation BEFORE the NaN (port of
``ibamr_tpu/utils/health.py``).

The supervisor's rollback alone fires only on the *loud* failure — a state
leaf that already went non-finite. The expensive silent failure is the
run that is still finite but already lost: velocity growing
exponentially, CFL creeping past stability, divergence error
compounding. By the time ``_finite_flag`` trips, the newest checkpoints
may already hold garbage-but-finite states and the supervisor pays a
full ``max_retries`` cycle to find a good one.

:class:`HealthProbe` closes that gap. The device side (:meth:`measure`)
reduces the state to a small fixed vector of physics vitals with fused
tensor reductions at the end of the driver's chunk, so the per-chunk
host cost stays exactly one small device-to-host read: the driver reads
the vitals IN PLACE of the finite flag (pinned by the driver's
``host_reads``). The host side
(:meth:`classify` / :meth:`check`) applies thresholds, classifies the
chunk OK / WARN / FATAL, and raises :class:`HealthDegraded` — a
:class:`SimulationDiverged` *precursor* — on FATAL or on a sustained
WARN streak, while the state is still finite and the rollback is cheap.

Vitals vector schema (fixed order, ``VITALS_FIELDS``):

====  ============  =====================================================
idx   field         meaning
====  ============  =====================================================
0     ``finite``    1.0 iff every floating state leaf is all-finite
1     ``max_u``     max |u| over the velocity components (0 if no vel)
2     ``cfl``       realized advective CFL: max_u * dt / min(dx)
3     ``div_norm``  max |div u| (0 when no divergence functional given)
4     ``func``      caller-supplied energy/volume functional (NaN = none)
5     ``vol``       IB enclosed volume/area (``volume_fn``; NaN = none)
6     ``budget``    momentum/KE budget term (``budget_fn``; NaN = none)
====  ============  =====================================================

Slots 5–6 are the physics-invariant sentinels: both are
conserved-to-drift quantities, so their triage is RELATIVE drift over
the run's own first finite value (``vol_drift_warn/fatal``,
``budget_drift_warn/fatal``) — a leaking membrane or a momentum budget
blowing up rolls back while every checkpoint is still healthy. They
ride the SAME fused vitals vector, so the per-chunk cost stays one
small device-to-host read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional

import numpy as np

import torch

from ibamr_tpu_torch.utils.hierarchy_driver import (SimulationDiverged,
                                                    _finite_flag,
                                                    _state_device)

OK = "ok"
WARN = "warn"
FATAL = "fatal"

VITALS_FIELDS = ("finite", "max_u", "cfl", "div_norm", "func",
                 "vol", "budget")
QUARANTINED = "quarantined"


def _np(vitals) -> np.ndarray:
    if isinstance(vitals, torch.Tensor):
        vitals = vitals.detach().cpu().numpy()
    return np.asarray(vitals, dtype=np.float64)


def _new_triage_ctx() -> dict:
    """One triage context: WARN streak + per-run baselines. The solo
    probe owns one; a fleet probe owns one PER LANE so a drifting lane
    cannot poison its neighbours' baselines."""
    return {"warn_streak": 0, "baseline_func": None,
            "baseline_vol": None, "baseline_budget": None}


class HealthDegraded(SimulationDiverged):
    """Precursor divergence: the state is still FINITE but the vitals
    crossed a FATAL threshold or sustained a WARN streak. Subclassing
    :class:`SimulationDiverged` means the whole recovery machinery
    (``ResilientDriver`` rollback + dt backoff + incident record) fires
    unchanged — but with a cheap recovery, because every checkpoint on
    disk still predates any non-finite value."""

    kind = "health_degraded"

    def __init__(self, step: int, reasons, vitals: dict):
        self.step = step
        self.reasons = list(reasons)
        self.vitals = dict(vitals)
        self.bad_leaves: list = []      # nothing is non-finite (yet)
        RuntimeError.__init__(
            self,
            f"health degraded by step {step}: {'; '.join(self.reasons)} "
            f"(vitals {self.vitals}) — rolling back while the state is "
            f"still finite")

    def incident_payload(self) -> dict:
        return {"reasons": self.reasons, "vitals": self.vitals}


@dataclasses.dataclass
class HealthProbe:
    """Fused in-flight vitals probe + host-side triage.

    Device side: :meth:`measure(state, dt)` returns a fixed float32
    vector (``VITALS_FIELDS`` order) built from optional accessors, each
    a tensor function of the state that reads nothing to the host:

    - ``velocity_fn(state) -> tuple/list of arrays`` (default: the
      state's ``u`` attribute when present);
    - ``divergence_fn(state) -> array or scalar`` (max |.| is taken);
    - ``functional_fn(state) -> scalar`` — the caller's conserved-ish
      quantity (kinetic energy, phase volume, ...), the signal the
      growth triage watches.

    Host side: :meth:`check(vitals, step, dt)` classifies the chunk and
    raises :class:`HealthDegraded` on FATAL, or after ``sustain``
    consecutive WARN chunks. ``None`` thresholds are disabled. The
    functional baseline is the first finite functional value observed
    (reset only by :meth:`reset`), so "growth beyond a configured
    factor" means growth over the run's OWN starting value, not an
    absolute scale the caller would have to guess.
    """

    velocity_fn: Optional[Callable[[Any], Any]] = None
    divergence_fn: Optional[Callable[[Any], Any]] = None
    functional_fn: Optional[Callable[[Any], Any]] = None
    min_dx: Optional[float] = None       # needed for the CFL vital
    # thresholds (None = that check disabled)
    max_u_warn: Optional[float] = None
    max_u_fatal: Optional[float] = None
    cfl_warn: Optional[float] = None
    cfl_fatal: Optional[float] = None
    div_warn: Optional[float] = None
    div_fatal: Optional[float] = None
    func_growth_warn: Optional[float] = None    # factor over baseline
    func_growth_fatal: Optional[float] = None
    # invariant sentinels (slots 5-6). Both are conserved-to-drift
    # quantities; thresholds are RELATIVE drift |v - v0| / max(|v0|, eps)
    # over the run's own first finite value.
    volume_fn: Optional[Callable[[Any], Any]] = None
    budget_fn: Optional[Callable[[Any], Any]] = None
    vol_drift_warn: Optional[float] = None
    vol_drift_fatal: Optional[float] = None
    budget_drift_warn: Optional[float] = None
    budget_drift_fatal: Optional[float] = None
    sustain: int = 3                     # WARN chunks before escalation

    VITALS_FIELDS = VITALS_FIELDS        # schema, importable off the class

    def __post_init__(self):
        if self.sustain < 1:
            raise ValueError("sustain must be >= 1 (a WARN streak of "
                             "zero chunks would fire immediately)")
        # triage state lives in per-context dicts so the SAME threshold
        # logic serves the solo run (one context, exposed through the
        # legacy attribute names below) and the fleet (one context per
        # lane: independent baselines and WARN streaks)
        self._solo_ctx = _new_triage_ctx()
        self._lane_ctx: Optional[List[dict]] = None
        self.history: List[dict] = []    # one record per classified chunk
        self.last: Optional[dict] = None
        self.last_lanes: Optional[List[dict]] = None

    # legacy attribute views of the solo triage context (tests and
    # callers poke these directly)
    @property
    def _warn_streak(self):
        return self._solo_ctx["warn_streak"]

    @_warn_streak.setter
    def _warn_streak(self, v):
        self._solo_ctx["warn_streak"] = v

    @property
    def _baseline_func(self):
        return self._solo_ctx["baseline_func"]

    @_baseline_func.setter
    def _baseline_func(self, v):
        self._solo_ctx["baseline_func"] = v

    @property
    def _baseline_vol(self):
        return self._solo_ctx["baseline_vol"]

    @_baseline_vol.setter
    def _baseline_vol(self, v):
        self._solo_ctx["baseline_vol"] = v

    @property
    def _baseline_budget(self):
        return self._solo_ctx["baseline_budget"]

    @_baseline_budget.setter
    def _baseline_budget(self, v):
        self._solo_ctx["baseline_budget"] = v

    # -- construction helpers ----------------------------------------------

    @classmethod
    def for_integrator(cls, integ, **kw) -> "HealthProbe":
        """Probe wired to the framework's integrator conventions: MAC
        velocity at ``state.u``, divergence via the shared stencils,
        kinetic energy as the default functional, a momentum-magnitude
        budget sentinel when a grid is available, and (for 2D IB
        integrators) the enclosed marker polygon area as the volume
        sentinel. Any explicit kwarg wins over the derived default."""
        from ibamr_tpu_torch.ops import stencils

        is_ib = (hasattr(integ, "ins") and hasattr(integ, "ib"))
        ins = getattr(integ, "ins", None) if is_ib else integ
        grid = getattr(ins, "grid", None)

        def uget(s):
            return s.ins.u if is_ib else s.u

        if grid is not None:
            kw.setdefault("min_dx", float(min(grid.dx)))
            dx = grid.dx
            kw.setdefault("velocity_fn", uget)
            kw.setdefault("divergence_fn",
                          lambda s: stencils.divergence(uget(s), dx))
            # momentum/KE budget: cell_vol * rho * |sum_cells u|, exactly
            # conserved by the periodic projected equations, so its
            # drift is pure scheme/precision error
            rho = float(getattr(ins, "rho", 1.0))
            cv = float(getattr(grid, "cell_volume", 1.0))

            def budget(s):
                comps = uget(s)
                mom = [torch.sum(c) for c in comps]
                return cv * rho * torch.sqrt(sum(m * m for m in mom))
            kw.setdefault("budget_fn", budget)
        if hasattr(integ, "kinetic_energy"):
            kw.setdefault("functional_fn", integ.kinetic_energy)
        elif ins is not None and hasattr(ins, "kinetic_energy"):
            kw.setdefault("functional_fn",
                          lambda s: ins.kinetic_energy(s.ins)
                          if is_ib else ins.kinetic_energy(s))
        if is_ib and grid is not None and len(grid.dx) == 2:
            from ibamr_tpu_torch.integrators.ib import polygon_area
            kw.setdefault("volume_fn", lambda s: polygon_area(s.X))
        return cls(**kw)

    # -- device side ---------------------------------------------------------

    def measure(self, state, dt):
        """Fixed-shape vitals vector (float32, ``len(VITALS_FIELDS)``) on
        the state's device, from fused tensor reductions: no host read.
        The driver reads it once per chunk."""
        dev = _state_device(state)

        def f32(x):
            return torch.as_tensor(x, device=dev).to(torch.float32)

        finite = f32(_finite_flag(state))

        vel = (self.velocity_fn(state) if self.velocity_fn is not None
               else getattr(state, "u", None))
        max_u = f32(0.0)
        if vel is not None:
            comps = vel if isinstance(vel, (tuple, list)) else (vel,)
            for c in comps:
                max_u = torch.maximum(max_u, f32(torch.max(torch.abs(c))))

        if self.min_dx is not None:
            cfl = max_u * f32(float(dt)) / f32(self.min_dx)
        else:
            cfl = f32(0.0)

        if self.divergence_fn is not None:
            div = f32(torch.max(torch.abs(
                torch.as_tensor(self.divergence_fn(state)))))
        else:
            div = f32(0.0)

        nan = f32(float("nan"))
        func = (f32(self.functional_fn(state)).reshape(())
                if self.functional_fn is not None else nan)
        vol = (f32(self.volume_fn(state)).reshape(())
               if self.volume_fn is not None else nan)
        budget = (f32(self.budget_fn(state)).reshape(())
                  if self.budget_fn is not None else nan)
        return torch.stack([finite, max_u, cfl, div, func, vol, budget])

    # -- host side -----------------------------------------------------------

    @staticmethod
    def unpack(vitals) -> dict:
        """Vector -> named dict. Tolerates shorter (older-schema)
        vectors: missing trailing slots read as NaN, so a v2 5-float
        vitals record still unpacks. A lane-batched (7, B) matrix
        unpacks to per-field (B,) arrays — one column per lane —
        without disturbing the rank-1 paths."""
        v = _np(vitals)
        if v.ndim == 2:
            B = v.shape[1]
            return {name: (v[i].copy() if i < v.shape[0]
                           else np.full(B, np.nan))
                    for i, name in enumerate(VITALS_FIELDS)}
        v = v.reshape(-1)
        return {name: (float(v[i]) if i < v.size else float("nan"))
                for i, name in enumerate(VITALS_FIELDS)}

    def classify(self, vitals, step: int, dt: float):
        """Host-side triage of one chunk's vitals vector. Returns
        ``(level, reasons, vit_dict)`` with level in {OK, WARN, FATAL}
        and updates the WARN streak / functional baseline / history.
        A non-finite chunk is the caller's business (the driver raises
        plain :class:`SimulationDiverged` for it) and is reported FATAL
        here for completeness."""
        vit = self.unpack(vitals)
        level, reasons = self._triage(vit, self._solo_ctx)
        self._warn_streak = self._warn_streak + 1 if level != OK else 0
        rec = dict(vit, step=int(step), dt=float(dt), level=level,
                   warn_streak=self._warn_streak, reasons=list(reasons))
        self.last = rec
        self.history.append(rec)
        return level, reasons, vit

    def _triage(self, vit: dict, ctx: dict):
        """Threshold logic over one unpacked vitals dict against one
        triage context (baselines mutate in place). Streak accounting
        belongs to the caller — solo and per-lane policies differ."""
        reasons: List[str] = []
        level = OK

        def _flag(lvl, msg):
            nonlocal level
            reasons.append(msg)
            if lvl == FATAL or level == FATAL:
                level = FATAL
            else:
                level = WARN

        if vit["finite"] < 1.0:
            _flag(FATAL, "non-finite state leaves")

        for name, warn, fatal in (
                ("max_u", self.max_u_warn, self.max_u_fatal),
                ("cfl", self.cfl_warn, self.cfl_fatal),
                ("div_norm", self.div_warn, self.div_fatal)):
            val = vit[name]
            if fatal is not None and val > fatal:
                _flag(FATAL, f"{name}={val:.4g} > fatal {fatal:.4g}")
            elif warn is not None and val > warn:
                _flag(WARN, f"{name}={val:.4g} > warn {warn:.4g}")

        func = vit["func"]
        if math.isfinite(func):
            if ctx["baseline_func"] is None:
                ctx["baseline_func"] = func
            base = ctx["baseline_func"]
            scale = abs(base) if base != 0.0 else 1.0
            growth = abs(func) / scale
            vit["func_growth"] = growth
            if (self.func_growth_fatal is not None
                    and growth > self.func_growth_fatal):
                _flag(FATAL, f"functional grew {growth:.3g}x over "
                             f"baseline (fatal {self.func_growth_fatal:g}x)")
            elif (self.func_growth_warn is not None
                    and growth > self.func_growth_warn):
                _flag(WARN, f"functional grew {growth:.3g}x over "
                            f"baseline (warn {self.func_growth_warn:g}x)")
        elif self.functional_fn is not None and vit["finite"] >= 1.0:
            _flag(FATAL, "functional is non-finite")

        # invariant sentinels: relative drift over the run's own first
        # finite value — a secular leak fires long before any NaN
        for name, fn, base_key, warn, fatal in (
                ("vol", self.volume_fn, "baseline_vol",
                 self.vol_drift_warn, self.vol_drift_fatal),
                ("budget", self.budget_fn, "baseline_budget",
                 self.budget_drift_warn, self.budget_drift_fatal)):
            val = vit[name]
            if math.isfinite(val):
                if ctx[base_key] is None:
                    ctx[base_key] = val
                base = ctx[base_key]
                drift = abs(val - base) / max(abs(base), 1e-30)
                vit[f"{name}_drift"] = drift
                if fatal is not None and drift > fatal:
                    _flag(FATAL, f"{name} drifted {drift:.3g} from "
                                 f"baseline {base:.4g} (fatal {fatal:g})")
                elif warn is not None and drift > warn:
                    _flag(WARN, f"{name} drifted {drift:.3g} from "
                                f"baseline {base:.4g} (warn {warn:g})")
            elif fn is not None and vit["finite"] >= 1.0:
                _flag(FATAL, f"{name} sentinel is non-finite")

        return level, reasons

    def check_lanes(self, vitals, step: int, dt, alive=None) -> List[dict]:
        """Per-lane triage of a fleet chunk's (7, B) vitals matrix.

        Unlike :meth:`check` this NEVER raises — returning lane
        verdicts is the whole point of fleet triage (one bad lane must
        not abort B-1 healthy ones). Each live lane is triaged against
        its OWN context (independent baselines + WARN streaks); the
        record's ``fire`` bool is the per-lane equivalent of
        :meth:`check`'s raise (FATAL, or a sustained WARN streak, while
        the lane is still finite). Dead lanes (``alive[b]`` false) are
        skipped with level ``quarantined`` — their frozen rows are the
        last good state, not a new fault. The driver converts fired
        lanes into a :class:`~ibamr_tpu_torch.utils.hierarchy_driver
        .LaneFault` for the supervisor."""
        v = _np(vitals)
        if v.ndim != 2:
            raise ValueError(
                f"check_lanes expects a (len(VITALS_FIELDS), B) vitals "
                f"matrix, got shape {v.shape}")
        B = v.shape[1]
        if self._lane_ctx is None or len(self._lane_ctx) != B:
            self._lane_ctx = [_new_triage_ctx() for _ in range(B)]
        dtv = np.asarray(dt, dtype=np.float64).reshape(-1)
        if dtv.size == 1 and B > 1:
            dtv = np.full(B, float(dtv[0]))
        out: List[dict] = []
        for b in range(B):
            if alive is not None and not bool(alive[b]):
                out.append({"lane": b, "step": int(step),
                            "level": QUARANTINED, "fire": False,
                            "reasons": [], "warn_streak": 0})
                continue
            vit = self.unpack(v[:, b])
            ctx = self._lane_ctx[b]
            level, reasons = self._triage(vit, ctx)
            ctx["warn_streak"] = (ctx["warn_streak"] + 1
                                  if level != OK else 0)
            fire = (level == FATAL
                    or (level == WARN
                        and ctx["warn_streak"] >= self.sustain))
            fire = bool(fire and vit["finite"] >= 1.0)
            if fire:
                # mirror check(): a fired lane restarts its streak so
                # a supervised retry starts from a clean slate
                ctx["warn_streak"] = 0
            out.append(dict(vit, lane=b, step=int(step),
                            dt=float(dtv[b]), level=level,
                            warn_streak=ctx["warn_streak"],
                            reasons=list(reasons), fire=fire))
        self.last_lanes = out
        self.history.append({"step": int(step), "fleet": True,
                             "lanes": [{"lane": r["lane"],
                                        "level": r["level"],
                                        "fire": r.get("fire", False)}
                                       for r in out]})
        return out

    def reset_lane(self, lane: int):
        """Fresh triage context for one lane (after a per-lane rollback
        or quarantine restore): the restored slice re-baselines."""
        if self._lane_ctx is not None and 0 <= lane < len(self._lane_ctx):
            self._lane_ctx[lane] = _new_triage_ctx()

    def check(self, vitals, step: int, dt: float) -> dict:
        """Classify and ESCALATE: raises :class:`HealthDegraded` on a
        FATAL chunk or once ``sustain`` consecutive chunks came back
        WARN. Returns the host-side vitals record otherwise. The WARN
        streak resets on raise, so a supervised retry starts from a
        clean slate (the functional baseline persists — the retry
        resumes the same trajectory)."""
        level, reasons, vit = self.classify(vitals, step, dt)
        fire = level == FATAL or (level == WARN
                                  and self._warn_streak >= self.sustain)
        if fire and vit["finite"] >= 1.0:
            self._warn_streak = 0
            raise HealthDegraded(step, reasons, vit)
        return self.last

    def reset(self):
        """Forget streaks AND every baseline (a new run)."""
        self._solo_ctx = _new_triage_ctx()
        self._lane_ctx = None

    def rebaseline(self):
        """Drop the drift anchors (functional / volume / budget
        baselines) while KEEPING warn streaks — for a legitimate
        discontinuous state move, e.g. an assimilation analysis that
        updates every lane between chunks. The next vitals sample
        re-anchors each baseline; without this the first post-analysis
        chunk reads the innovation jump as func/vol/budget drift and
        false-positives a WARN. Streaks survive on purpose: a lane
        that was already trending bad must not get its strikes wiped
        by every analysis."""
        ctxs = [self._solo_ctx] + list(self._lane_ctx or [])
        for ctx in ctxs:
            ctx["baseline_func"] = None
            ctx["baseline_vol"] = None
            ctx["baseline_budget"] = None
