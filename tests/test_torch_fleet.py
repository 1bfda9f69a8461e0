"""Port parity of fleet (lane-stacked) execution (``utils/lanes.py``,
the driver's fleet chunk, ``checkpoint.restore_lane`` and the
supervisor's per-lane recovery) against ``ibamr_tpu`` at f64 on the CPU.

Lane k of a B-lane fleet is bitwise its solo run (the reference's
contract, ``tests/test_fleet.py``); the port's fleet lanes agree with
the reference's vmapped fleet within 1e-12 relative; quarantine leaves
the healthy lanes untouched (the reference's fleet drill, at 4 lanes of
the 32^3 shell); ``restore_lane`` falls back past a step whose lane
record fails, and reads the reference's fleet checkpoints."""

import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators.ins import INSStaggeredIntegrator as JINS
from ibamr_tpu.utils import checkpoint as jck
from ibamr_tpu.utils import lanes as jlanes
from ibamr_tpu.utils.hierarchy_driver import HierarchyDriver as JDriver
from ibamr_tpu.utils.hierarchy_driver import RunConfig as JConfig
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.tools import fault_injection as tfi
from ibamr_tpu_torch.utils import checkpoint as tck
from ibamr_tpu_torch.utils import lanes as tlanes
from ibamr_tpu_torch.utils.health import HealthProbe
from ibamr_tpu_torch.utils.hierarchy_driver import (HierarchyDriver,
                                                    LaneFault, RunConfig)
from ibamr_tpu_torch.utils.tree import leaves

B = 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lane_states(integ, st0):
    return [st0._replace(u=tuple(c * (1.0 + 0.01 * i) + 1e-4 * (i + 1)
                                 for c in st0.u)) for i in range(B)]


def test_lane_helpers():
    _, st0 = tfi._tg16_setup(device="cpu", dtype=torch.float64)
    ls = _lane_states(None, st0)
    fleet = tlanes.stack_lanes(ls)
    assert tlanes.fleet_size(fleet) == B
    for i in range(B):
        assert all(torch.equal(a, b) for a, b in zip(
            leaves(tlanes.lane_slice(fleet, i)), leaves(ls[i])))
    patched = tlanes.set_lane(fleet, 1, ls[0])
    assert torch.equal(patched.u[0][1], ls[0].u[0])
    assert torch.equal(patched.u[0][2], fleet.u[0][2])
    assert not torch.equal(fleet.u[0][1], ls[0].u[0])      # a copy
    bc = tlanes.broadcast_lane(ls[2], 4)
    assert bc.u[1].shape == (4, 16, 16) and torch.equal(bc.u[1][3],
                                                        ls[2].u[1])
    padded, alive = tlanes.pad_lanes(ls[:2], 4)
    assert alive.tolist() == [True, True, False, False]
    assert torch.equal(padded.p[3], ls[1].p)
    assert tlanes.lane_mask_shape(alive, padded.u[0]).shape == (4, 1, 1)
    with pytest.raises(ValueError):
        tlanes.pad_lanes(ls, 2)


def test_fleet_lanes_bitwise_solo_and_match_reference():
    integ, st0 = tfi._tg16_setup(device="cpu", dtype=torch.float64)
    ls = _lane_states(integ, st0)
    cfg = RunConfig(dt=1e-3, num_steps=6, health_interval=3)
    drv = HierarchyDriver(integ, cfg, lanes=B,
                          health_probe=HealthProbe.for_integrator(integ))
    drv.lane_dt[2] = 5e-4                       # per-lane dt
    out = drv.run(tlanes.stack_lanes(ls))
    assert drv.host_reads == 2 and drv.trace_counts == {3: 1}
    assert drv.last_vitals[0]["level"] == "ok"
    for i in range(B):
        solo = HierarchyDriver(integ, RunConfig(dt=float(drv.lane_dt[i]),
                                                num_steps=6,
                                                health_interval=3))
        ref = solo.run(ls[i])
        assert all(torch.equal(a, b) for a, b in zip(
            leaves(tlanes.lane_slice(out, i)), leaves(ref)))
    # the reference's vmapped fleet on the same lanes
    g = JGrid(n=(16, 16), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    ji = JINS(g, rho=1.0, mu=0.05, dtype=jnp.float64)
    jls = [ji.initialize(u0_arrays=tuple(c.numpy() for c in s.u))
           for s in ls]
    jd = JDriver(ji, JConfig(dt=1e-3, num_steps=6, health_interval=3),
                 lanes=B)
    jd.lane_dt[2] = 5e-4
    jout = convert.ins_state(jd.run(jlanes.stack_lanes(jls)), device="cpu")
    for a, b in zip(leaves(jout), leaves(out)):
        a, b = a.numpy(), b.numpy()
        assert np.max(np.abs(a - b)) <= 1e-12 * max(np.max(np.abs(a)),
                                                     1e-300)


def test_dead_lane_is_frozen_and_fault_names_lane():
    integ, st0 = tfi._tg16_setup(device="cpu", dtype=torch.float64)
    fleet0 = tlanes.stack_lanes(_lane_states(integ, st0))
    drv = HierarchyDriver(integ, RunConfig(dt=1e-3, num_steps=4,
                                           health_interval=2), lanes=B,
                          fleet_step_wrap=lambda s: tfi.lane_nan_injector(
                              s, at_step=3, lane=1, fleet_size=B,
                              leaf_path="u[0]"))
    drv.lane_alive[2] = False
    with pytest.raises(LaneFault) as ei:
        drv.run(fleet0)
    e = ei.value
    assert e.lanes == [1] and e.step == 4 and e.lane_reasons == {
        1: ["non_finite"]}
    assert e.lane_bad_leaves[1][0] == ".u[0]" and e.fleet_size == B
    assert all(torch.equal(a, b) for a, b in zip(
        leaves(tlanes.lane_slice(e.state, 2)),
        leaves(tlanes.lane_slice(fleet0, 2))))
    assert int(e.state.k[0]) == 4 and bool(torch.isfinite(
        e.state.u[0][0]).all())


def test_fleet_drill_quarantine_leaves_healthy_lanes_untouched(tmp_path):
    got = tfi.run_fleet_smoke(str(tmp_path), fleet_size=4, bad_lane=2,
                              device="cpu")
    assert got["lane_rollbacks"] == 1 and got["lane_quarantines"] == 1
    assert got["replay_verdict"] == "reproduced"
    assert got["trace_counts"] == {"2": 1}
    with open(os.path.join(got["capsule"], "manifest.json")) as f:
        assert json.load(f)["lane"] == {"index": 2, "fleet_size": 4}
    events = [r["event"] for r in got["incidents"]]
    assert events == ["lane_rollback", "lane_quarantine"]


def test_restore_lane_falls_back_and_reads_reference_checkpoints(tmp_path):
    integ, st0 = tfi._tg16_setup(device="cpu", dtype=torch.float64)
    ls = _lane_states(integ, st0)
    fleet = tlanes.stack_lanes(ls)
    d = str(tmp_path / "t")
    tck.save_checkpoint(d, fleet, 2, lanes=B)
    newer = tlanes.set_lane(fleet, 1, ls[0])
    tck.save_checkpoint(d, newer, 4, lanes=B)
    # lane 1's per-lane record of step 4 no longer vouches for its rows
    side = os.path.join(d, "restore.00000004.json")
    meta = json.load(open(side))
    key = next(iter(meta["integrity"]["lanes"]["leaves"]))
    meta["integrity"]["lanes"]["leaves"][key][1] ^= 1
    json.dump(meta, open(side, "w"))
    template = tlanes.broadcast_lane(st0, B)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got1, s1 = tck.restore_lane(d, template, 1)
        got0, s0 = tck.restore_lane(d, template, 0)
        assert tck.restore_lane(d, template, 7) is None
    assert (s1, s0) == (2, 4)
    assert torch.equal(got1.u[0][1], ls[1].u[0])
    assert torch.equal(got0.u[0][0], ls[0].u[0])
    assert torch.equal(got1.u[0][0], template.u[0][0])   # untouched
    # the reference's fleet checkpoint, restored lane by lane
    g = JGrid(n=(16, 16), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    ji = JINS(g, rho=1.0, mu=0.05, dtype=jnp.float64)
    jfleet = jlanes.stack_lanes([ji.initialize(
        u0_arrays=tuple(c.numpy() for c in s.u)) for s in ls])
    jd = str(tmp_path / "j")
    jck.save_checkpoint(jd, jfleet, 6, lanes=B)
    got, s = tck.restore_lane(jd, template, 2)
    assert s == 6 and torch.equal(got.u[1][2], ls[2].u[1])
    jgot, _ = jck.restore_lane(d, jlanes.broadcast_lane(
        jlanes.lane_slice(jfleet, 0), B), 1)
    np.testing.assert_array_equal(np.asarray(jgot.u[0][1]),
                                  ls[1].u[0].numpy())
