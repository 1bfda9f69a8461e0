"""Port parity of ``solvers/escalation.py``: the declared escalation and
precision chains, the stats records, ``escalate_solve``'s walk and its
incident records, and ``SolverBreakdown`` as a ``SimulationDiverged``,
against ibamr_tpu."""

from types import SimpleNamespace as NS

import pytest
import torch

from ibamr_tpu.solvers import escalation as je
from ibamr_tpu_torch.solvers import escalation as te
from ibamr_tpu_torch.utils.hierarchy_driver import SimulationDiverged


def test_chains_match_reference():
    for name in te.ESCALATION_LEVELS:
        assert [dataclass_tuple(x) for x in te.escalation_chain(name)] == \
            [dataclass_tuple(x) for x in je.escalation_chain(name)]
    for name in te.PRECISION_LEVELS:
        assert te.precision_chain(name) == je.precision_chain(name)
    for spec in (None, "f32", "bf16", "BFLOAT16", "f64", "float64"):
        assert te.precision_level_name(spec) == je.precision_level_name(spec)
    assert te.precision_level_name(torch.bfloat16) == "bf16"
    with pytest.raises(KeyError):
        te.escalation_chain("nope")
    with pytest.raises(KeyError):
        te.precision_chain("fp8")


def dataclass_tuple(level):
    return (level.name, level.restarts_scale, level.m_scale,
            level.maxiter_scale, level.inner_scale)


def _result(converged, iters=3, resnorm=1e-3):
    return NS(iters=torch.tensor(iters), resnorm=torch.tensor(resnorm),
              converged=torch.tensor(converged))


@pytest.mark.parametrize("wins_at", [0, 1, 2, None])
def test_escalate_solve_walk_matches_reference(wins_at):
    records = {"port": [], "jax": []}
    outcome = {}
    for key, mod in (("port", te), ("jax", je)):
        def attempt(level, i):
            return _result(i == wins_at, iters=i + 1, resnorm=0.5 ** i)

        try:
            sol = mod.escalate_solve(attempt, context="ctx",
                                     on_incident=records[key].append,
                                     step=7)
            outcome[key] = int(sol.iters)
        except mod.SolverBreakdown as err:
            outcome[key] = (err.step, err.attempts, str(err))
            assert isinstance(err, SimulationDiverged) or key == "jax"
    assert outcome["port"] == outcome["jax"]
    assert records["port"] == records["jax"]


def test_stats_records():
    sink, mirror = NS(), NS()
    te.record_solve_stats(sink, _result(True, 4, 0.25), solver="fgmres",
                          mirrors=(mirror, None))
    assert sink.last_solve_stats == mirror.last_solve_stats == {
        "iters": 4, "resnorm": 0.25, "converged": True, "solver": "fgmres"}
    assert te.solve_stats_dict(_result(False), level="base") == \
        je.solve_stats_dict(_result(False), level="base")
    with pytest.raises(ValueError):
        te.escalate_solve(lambda lv, i: _result(True), chain=[])
