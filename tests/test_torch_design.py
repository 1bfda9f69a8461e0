"""Port parity of the inverse-design package (``ibamr_tpu_torch/design``)
against ibamr_tpu's at f64 on the CPU (one PyTorch thread):

- ``adam_update`` against the reference's within 1e-14 of max|ref|;
- ``DesignLoop`` on the reference's quadratic (``tests/test_grad.py``):
  one build then cache hits, strict descent, the same objectives as the
  reference's loop within 1e-12, and a second loop over the same family
  fully warm;
- the eel gait (16^2, 9 markers, 3 steps) and the cantilever (16^2, 4x2
  quads, 3 steps): objective and gradient against
  ``jax.value_and_grad`` of the reference's objective within 1e-9, each
  leaf against its own magnitude (the cantilever's ``d/dlog_mu`` is ~6e-10
  beside ``d/dlog_thick`` ~1e-5: a tolerance scaled by the largest leaf
  would not see the material gradient);
- the design drill (``run_design_smoke``) on the CPU, its ledger
  rendered by ``tools/obs.py summary``;
- the three microbenchmarks at n = 8 print their keys.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.design import cantilever as jcant
from ibamr_tpu.design import eel_gait as jeel
from ibamr_tpu.design import loop as jloop
from ibamr_tpu.serve.aot_cache import ExecutableCache as JCache
from ibamr_tpu_torch.design import (DesignLoop, adam_init, adam_update,
                                    build_cantilever_problem,
                                    build_eel_gait_problem)
from ibamr_tpu_torch.serve.aot_cache import ExecutableCache
from ibamr_tpu_torch.tools import (fault_injection, microbench_fluid,
                                   microbench_grad, microbench_transfer)
from ibamr_tpu_torch.tools import obs as obs_cli

TOL_LEAF = 1e-9


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(ref, got):
    ref = np.asarray(ref, dtype=np.float64)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    return float(np.max(np.abs(got - ref))
                 / max(np.max(np.abs(ref)), 1e-300))


def test_adam_update_matches_reference():
    rng = np.random.default_rng(0)
    p = {"a": rng.standard_normal(3), "b": rng.standard_normal(())}
    gs = [{"a": rng.standard_normal(3), "b": rng.standard_normal(())}
          for _ in range(3)]
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jo, to = jloop.adam_init(jp), adam_init(tp)
    for g in gs:
        jp, jo = jloop.adam_update(jp, jax.tree_util.tree_map(jnp.asarray, g),
                                   jo, 0.05)
        tp, to = adam_update(tp, {k: torch.tensor(v) for k, v in g.items()},
                             to, 0.05)
    assert int(to.step) == int(jo.step) == 3
    for k in p:
        assert _rel(jp[k], tp[k]) <= 1e-14
        assert _rel(jo.m[k], to.m[k]) <= 1e-14
        assert _rel(jo.v[k], to.v[k]) <= 1e-14


TARGET = [0.3, -0.2, 0.7]


def _quadratic(cache):
    target = torch.tensor(TARGET, dtype=torch.float64)

    def objective(params):
        x = torch.zeros_like(target)
        for _ in range(4):
            x = 0.5 * x + params["x"]
        return torch.sum((x - target) ** 2)

    return DesignLoop(objective, {"x": torch.zeros(3, dtype=torch.float64)},
                      lr=0.05, cache=cache, label="quad")


def test_design_loop_on_the_reference_quadratic():
    cache = ExecutableCache()
    res = _quadratic(cache).run(4)
    objs = [it.objective for it in res.history]
    assert all(b < a for a, b in zip(objs, objs[1:]))
    assert res.history[0].cache_misses == 1
    for it in res.history[1:]:
        assert it.cache_misses == 0 and it.cache_hits == 1

    target = jnp.asarray(TARGET, jnp.float64)

    def jobjective(params):
        x, _ = jax.lax.scan(lambda c, _: (0.5 * c + params["x"], None),
                            jnp.zeros_like(target), None, length=4)
        return jnp.sum((x - target) ** 2)

    jres = jloop.DesignLoop(jobjective, {"x": jnp.zeros(3, jnp.float64)},
                            lr=0.05, cache=JCache(), label="quad").run(4)
    assert _rel([it.objective for it in jres.history], objs) <= 1e-12
    assert _rel(jres.params["x"], res.params["x"]) <= 1e-12

    # a fresh loop over the same family and cache is warm from the start
    res2 = _quadratic(cache).run(2)
    assert [(it.cache_misses, it.cache_hits) for it in res2.history] == \
        [(0, 1), (0, 1)]


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_gradient(remat):
    """``DesignLoop(remat=)`` checkpoints the objective under the named
    policy: the recompute is the same arithmetic, so the same bits."""
    obj, p0 = build_eel_gait_problem(n=16, ns=9, num_steps=2,
                                     dtype=torch.float64, remat=None,
                                     device="cpu")
    v0, g0 = DesignLoop(obj, p0,
                        cache=ExecutableCache()).value_and_grad_fn()(p0)
    v1, g1 = DesignLoop(obj, p0, cache=ExecutableCache(),
                        remat=remat).value_and_grad_fn()(p0)
    assert torch.equal(v0, v1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    with pytest.raises(ValueError, match="remat"):
        DesignLoop(obj, p0, remat="nothing")


PROBLEMS = {
    "eel": (jeel.build_eel_gait_problem, build_eel_gait_problem,
            dict(n=16, ns=9, num_steps=3)),
    "cantilever": (jcant.build_cantilever_problem, build_cantilever_problem,
                   dict(n=16, nx=4, ny=2, num_steps=3)),
}


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_objective_and_gradient_match_reference(name):
    jbuild, tbuild, kw = PROBLEMS[name]
    jobj, jp0 = jbuild(dtype=jnp.float64, remat=None, **kw)
    jv, jg = jax.value_and_grad(jobj)(jp0)
    tobj, tp0 = tbuild(dtype=torch.float64, device="cpu", **kw)
    loop = DesignLoop(tobj, tp0, cache=ExecutableCache(), label=name)
    tv, tg = loop.value_and_grad_fn()(tp0)
    assert _rel(jv, tv) <= TOL_LEAF
    assert sorted(jg) == sorted(tg)
    for k in jg:
        assert float(abs(tg[k])) > 0
        assert _rel(jg[k], tg[k]) <= TOL_LEAF, k


def test_design_drill_on_the_cpu(tmp_path, capsys):
    res = fault_injection.run_design_smoke(str(tmp_path), device="cpu")
    assert res["design_smoke"] == "ok"
    assert res["cold_misses"] == 1 and res["warm_misses"] == 0
    assert res["ledger_records"] == 3 and res["fd_rel_err"] <= 1e-6
    capsys.readouterr()
    assert obs_cli.main(["summary", res["ledger"]]) == 0
    text = capsys.readouterr().out
    assert "design loop" in text and "eel_smoke: 3 iteration(s)" in text
    assert "compiles: 1 total, 0 warm" in text


@pytest.mark.parametrize("tool, argv, keys", [
    (microbench_grad, ["--reps", "1"],
     ["substep_vjp_fft_ops", "spread_vjp_scatter_ops", "step_grad_ratio",
      "interp_vjp_ms"]),
    (microbench_fluid, ["--reps", "1"],
     ["fwd_transform_ms", "kspace_algebra_ms", "chained_substep_ms",
      "ins_step_bf16_ms"]),
    (microbench_transfer, ["--reps", "1", "--n-lat", "8"],
     ["weights_1ch_ms", "packed_refresh_hit", "packed3_interp3_ms",
      "pallas_packed_spread3_ms"]),
])
def test_microbenchmarks_print_their_keys(tool, argv, keys, capsys):
    assert tool.main(["--n", "8", "--device", "cpu", "--json"] + argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["n"] == 8
    for k in keys:
        assert k in out
    if tool is microbench_grad:
        assert out["substep_vjp_fft_ops"] == 2 * out["substep_primal_fft_ops"]
        assert out["spread_vjp_scatter_ops"] == \
            out["spread_primal_scatter_ops"]
