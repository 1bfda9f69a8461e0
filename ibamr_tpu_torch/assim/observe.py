"""Observation operators for ensemble assimilation (port of
``ibamr_tpu/assim/observe.py``).

The instrument panel IS the observation map: a flow meter or pressure
gauge (:class:`ibamr_tpu_torch.instruments.InstrumentPanel`) is already
a function of the state made of interpolation gathers and reductions on
the device, with no host read, so H(x) here is ``panel.readings``
flattened into a fixed-order vector, and over a lane-stacked fleet the
same map on each lane's slice, stacked. No separate "forward operator"
exists to drift out of sync with what the diagnostics report.

Host-side observation *data* (the y that arrives from real sensors)
rides :class:`ObservationBatch`: plain numpy plus an age stamp, so the
QC gate (:mod:`ibamr_tpu_torch.assim.qc`) can reject dropped, stale or
outlier channels before anything touches the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.instruments import InstrumentPanel

# fixed channel order: every vector obs is the panel's readings dict
# flattened in this sequence (meters vary fastest)
DEFAULT_CHANNELS: Tuple[str, ...] = ("flux", "mean_pressure")


class ObservationOperator:
    """H: state -> (m,) observation vector, derived from an instrument
    panel; ``fleet`` maps it over the lanes (axis 0) of a lane-stacked
    state."""

    def __init__(self, panel: InstrumentPanel,
                 channels: Sequence[str] = DEFAULT_CHANNELS):
        self.panel = panel
        self.channels = tuple(channels)
        self.n_meters = int(panel.meters.idx.shape[0])

    @property
    def n_obs(self) -> int:
        return self.n_meters * len(self.channels)

    def channel_names(self) -> Tuple[str, ...]:
        """One stable name per vector slot, e.g. ``flux[2]``: the
        instrument identity QC rejections are keyed by."""
        return tuple(f"{c}[{i}]" for c in self.channels
                     for i in range(self.n_meters))

    def __call__(self, state) -> torch.Tensor:
        """Unbatched IBState -> (m,) observation vector."""
        r = self.panel.readings(state.ins.u, state.ins.p, state.X)
        return torch.cat([torch.atleast_1d(r[c]) for c in self.channels])

    def fleet(self, fleet_state) -> torch.Tensor:
        """Lane-stacked state -> (B, m) per-member predicted obs: the
        map on each lane's slice, stacked (the reference ``vmap``s it)."""
        from ibamr_tpu_torch.utils.lanes import fleet_size, lane_slice

        return torch.stack([self(lane_slice(fleet_state, i))
                            for i in range(fleet_size(fleet_state))])


@dataclass
class ObservationBatch:
    """One cycle's worth of sensor data, host-side.

    values: (m,) float64, NaN marks a dropped channel;
    r: (m,) observation-error variances;
    age_s: (m,) seconds since each channel's reading was taken (a stale
        feed shows up as a large age, not a missing value);
    cycle: the assimilation cycle index this batch belongs to.
    """
    values: np.ndarray
    r: np.ndarray
    age_s: np.ndarray
    cycle: int = 0
    names: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        self.values = np.atleast_1d(np.asarray(self.values, np.float64))
        m = self.values.shape[0]
        self.r = np.broadcast_to(
            np.asarray(self.r, np.float64), (m,)).copy()
        self.age_s = np.broadcast_to(
            np.asarray(self.age_s, np.float64), (m,)).copy()


def synthesize_batches(op: ObservationOperator, truth_states,
                       sigma, *, seed: int = 0,
                       start_cycle: int = 0) -> list:
    """Noisy observation batches from a truth trajectory (twin
    experiment): H(truth) + N(0, sigma^2), R = sigma^2, age 0.

    ``truth_states`` is a sequence of unbatched states, one per cycle.
    The noise is drawn from numpy's generator at ``seed``, so drills,
    their replays and the reference see the same sensor stream.
    """
    rng = np.random.default_rng(seed)
    m = op.n_obs
    sig = np.broadcast_to(np.asarray(sigma, np.float64), (m,)).copy()
    names = op.channel_names()
    out = []
    for i, st in enumerate(truth_states):
        clean = op(st).detach().to("cpu", torch.float64).numpy()
        out.append(ObservationBatch(
            values=clean + sig * rng.standard_normal(m),
            r=sig ** 2, age_s=np.zeros(m),
            cycle=start_cycle + i, names=names))
    return out


def stream_from_list(batches) -> Callable[[int, int],
                                          Optional[ObservationBatch]]:
    """An ``obs_source(cycle, step)`` over a precomputed batch list: the
    deterministic source drills wrap with injectors. Cycles past the end
    return None (the filter free-runs)."""
    batches = list(batches)

    def source(cycle: int, step: int):
        return batches[cycle] if 0 <= cycle < len(batches) else None

    return source
