"""Port parity of the traffic layer: admission control, deadlines,
retries and slot reclaim (``ibamr_tpu_torch/serve/router.py``), the
open-loop load generator (``serve/loadgen.py``), the capacity model
(``serve/capacity.py``) and the serving chaos injectors
(``tools/fault_injection.py``) against ``ibamr_tpu/serve`` and
``tools/fault_injection.py`` on the CPU.

``poisson_burst_schedule`` is bitwise the reference's for seeds 0-3,
with a mix shift; ``traffic_summary`` and ``capacity_report`` equal the
reference's on the same results and ledger records (numpy seeds); the
admission controller admits, queues, times out and reclaims as the
reference's on the same scripted sequence. The router's shed paths (a
full queue, a spent deadline, builds that keep failing, a killed build
thread) end in exactly one terminal record per request. The end-to-end
soak drill (all four chaos injectors armed) is ``slow``, as the
reference's is; the card runs it in ``chip_smoke.py``'s ``serve``
phase."""

import threading
import time

import numpy as np
import pytest
import torch

from ibamr_tpu.serve import capacity as jcap
from ibamr_tpu.serve import loadgen as jlg
from ibamr_tpu.serve import router as jrt
from ibamr_tpu_torch import obs as tobs
from ibamr_tpu_torch.serve import capacity as tcap
from ibamr_tpu_torch.serve import loadgen as tlg
from ibamr_tpu_torch.serve import router as trt
from ibamr_tpu_torch.serve.aot_cache import ExecutableCache
from ibamr_tpu_torch.tools import fault_injection as tfi

RNG = np.random.default_rng(20261018)
_N, _N_LAT, _N_LON = 8, 6, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _req(tag, **kw):
    kw.setdefault("steps", 2)
    return trt.ScenarioRequest(tenant=tag, n_cells=_N, n_lat=_N_LAT,
                               n_lon=_N_LON, **kw)


def _router(**kw):
    return trt.WarmPoolRouter(
        [trt.BucketSpec(n_cells=_N, n_lat=_N_LAT, n_lon=_N_LON, lanes=2)],
        cache=ExecutableCache(), allow_dynamic=False, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the load generator and the capacity model against the reference
# ---------------------------------------------------------------------------

def _arrivals_fields(arrs):
    return [(a.t, a.scenario, tuple(sorted(vars(a.request).items())))
            for a in arrs]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_poisson_burst_schedule_bitwise_equals_reference(seed):
    shifted_j = tuple(jlg.replace(s, family=(("n_lon", 12), ("mu", 0.1)))
                      for s in jlg.SCENARIO_MIX)
    shifted_t = tuple(tlg.replace(s, family=(("n_lon", 12), ("mu", 0.1)))
                      for s in tlg.SCENARIO_MIX)
    kw = dict(seed=seed, duration_s=8.0, rate_rps=6.0, burst_factor=4.0,
              tenant_prefix="p-")
    j = jlg.poisson_burst_schedule(
        mix_schedule=[(0.0, jlg.SCENARIO_MIX), (0.5, shifted_j)], **kw)
    t = tlg.poisson_burst_schedule(
        mix_schedule=[(0.0, tlg.SCENARIO_MIX), (0.5, shifted_t)], **kw)
    assert len(t) > 20
    assert _arrivals_fields(t) == _arrivals_fields(j)
    # a single-mix schedule, and the chaos tenant's mix
    assert _arrivals_fields(tlg.poisson_burst_schedule(
        seed=seed, duration_s=5.0, rate_rps=4.0,
        mix=tlg.chaos_mix())) == _arrivals_fields(
        jlg.poisson_burst_schedule(seed=seed, duration_s=5.0,
                                   rate_rps=4.0, mix=jlg.chaos_mix()))


def test_mix_and_policies_equal_reference():
    from dataclasses import asdict

    assert [asdict(s) for s in tlg.SCENARIO_MIX] == \
        [asdict(s) for s in jlg.SCENARIO_MIX]
    assert [asdict(s) for s in tlg.chaos_mix(novel_families=4)] == \
        [asdict(s) for s in jlg.chaos_mix(novel_families=4)]
    assert {k: asdict(v) for k, v in tlg.SOAK_POLICIES.items()} == \
        {k: asdict(v) for k, v in jlg.SOAK_POLICIES.items()}
    assert asdict(trt.DEFAULT_POLICY) == asdict(jrt.DEFAULT_POLICY)


def _results(mod, rng, n=40):
    out = []
    for i in range(n):
        shed = bool(rng.random() < 0.2)
        cls = ("interactive", "batch", "chaos")[int(rng.integers(0, 3))]
        out.append(mod.RequestResult(
            tenant=f"{cls}-{i % 3}", ok=not shed and rng.random() < 0.9,
            quarantined=bool(rng.random() < 0.05), cold=bool(i < 2),
            bucket_lanes=2, lane=int(i % 2), steps_done=int(i % 5),
            first_step_s=float(rng.random()), total_s=float(rng.random()),
            family_key="k", shed=shed,
            shed_reason=("queue_full" if shed else None),
            retries=int(rng.integers(0, 2)),
            queue_wait_s=float(rng.random())))
    return out


def test_traffic_summary_equals_reference():
    for k in range(4):
        seed = 100 + k
        tres = _results(trt, np.random.default_rng(seed))
        jres = _results(jrt, np.random.default_rng(seed))
        assert tlg.traffic_summary(tres, 2.5) == \
            jlg.traffic_summary(jres, 2.5)
    assert tlg.traffic_summary([], 1.0) == jlg.traffic_summary([], 1.0)


def _request_records(rng, n=60):
    recs = []
    for i in range(n):
        recs.append({"kind": "request", "cold": bool(rng.random() < 0.1),
                     "steps": int(rng.integers(0, 9)),
                     "total_s": float(rng.random() * 0.2),
                     "family": f"fam{int(rng.integers(0, 3))}",
                     "bucket_lanes": int(rng.integers(1, 5))})
        if rng.random() < 0.2:
            recs.append({"kind": "request_shed", "family": "fam0"})
    return recs


def test_capacity_report_equals_reference():
    for k in range(4):
        recs = _request_records(np.random.default_rng(200 + k))
        for ceiling in (0.05, 0.5, 2.0):
            assert tcap.capacity_report(recs, ceiling) == \
                jcap.capacity_report(recs, ceiling)
        costs = tcap.family_costs_from_records(recs)
        mix = {f: float(w) for f, w in zip(costs, RNG.random(len(costs)))}
        steps = {f: int(s) for f, s in zip(costs,
                                           RNG.integers(1, 9, len(costs)))}
        assert tcap.sustainable_rps(costs, 1.0, mix=mix,
                                    steps_by_family=steps) == \
            jcap.sustainable_rps(costs, 1.0, mix=mix,
                                 steps_by_family=steps)
    assert tcap.capacity_report([], 2.0) == jcap.capacity_report([], 2.0)


def test_mix_shift_injector_equals_reference():
    import tools.fault_injection as jfi

    ja, jfam = jfi.mix_shift_injector(seed=0, duration_s=5.0,
                                      rate_rps=8.0, shift_frac=0.4)
    ta, tfam = tfi.mix_shift_injector(seed=0, duration_s=5.0,
                                      rate_rps=8.0, shift_frac=0.4)
    assert tfam == jfam == "(8, 6, 12, None, None, 0.05)"
    assert _arrivals_fields(ta) == _arrivals_fields(ja)


# ---------------------------------------------------------------------------
# admission control against the reference
# ---------------------------------------------------------------------------

def _admission_script(mod):
    ac = mod.AdmissionController({
        "a": mod.TenantClassPolicy(max_inflight=2, queue_depth=1,
                                   queue_timeout_s=0.05)})
    out = []
    out.append(ac.admit("a")[::2])
    out.append(ac.admit("a")[::2])
    out.append(ac.admit("a", deadline_left=0.0)[::2])
    # a third caller queues and times out (the queue is bounded)
    ok, wait, reason = ac.admit("a")
    out.append((ok, reason, wait >= 0.04))
    # a deadline shorter than the queue timeout wins
    ok, wait, reason = ac.admit("a", deadline_left=0.01)
    out.append((ok, reason))
    # a waiter is woken by a release
    got = []
    th = threading.Thread(target=lambda: got.append(ac.admit("a")[::2]))
    th.start()
    time.sleep(0.01)
    ac.release("a", reclaimed=True)
    th.join(5.0)
    out.append(got)
    # the queue holds one: a second concurrent waiter is shed queue_full
    ac2 = mod.AdmissionController({"q": mod.TenantClassPolicy(
        max_inflight=1, queue_depth=1, queue_timeout_s=0.5)})
    ac2.admit("q")
    holder = threading.Thread(target=lambda: ac2.admit("q"))
    holder.start()
    time.sleep(0.02)
    out.append(ac2.admit("q")[::2])
    ac2.release("q")
    holder.join(5.0)
    # an unknown class takes the default (permissive) policy
    out.append(ac.admit("other")[::2])
    return out


def test_admission_controller_equals_reference():
    assert _admission_script(trt) == _admission_script(jrt)


def test_backoff_equals_reference():
    for _ in range(12):
        kw = dict(backoff_base_s=float(RNG.random()),
                  backoff_cap_s=float(RNG.random() * 2))
        tid = "".join(RNG.choice(list("0123456789abcdef"), 16))
        attempt = int(RNG.integers(0, 8))
        assert trt.WarmPoolRouter._backoff_s(
            trt.TenantClassPolicy(**kw), attempt, tid) == \
            jrt.WarmPoolRouter._backoff_s(jrt.TenantClassPolicy(**kw),
                                          attempt, tid)


# ---------------------------------------------------------------------------
# the router's shed paths (the port)
# ---------------------------------------------------------------------------

def test_router_sheds_queue_full_and_spent_deadline(tmp_path):
    router = _router(policies={"none": trt.TenantClassPolicy(
        max_inflight=0, queue_depth=0)})
    lp = str(tmp_path / "ledger.jsonl")
    with tobs.ledger(lp):
        res = router.serve([_req("t0", tenant_class="none"),
                            _req("t1", deadline_s=0.0)])
    assert [r.shed_reason for r in res] == ["queue_full",
                                            "deadline_exceeded"]
    assert all(r.shed and not r.ok and r.lane == -1 for r in res)
    recs = tobs.read_ledger(lp)
    admits = [r["trace_id"] for r in recs if r["kind"] == "request_admit"]
    sheds = [r for r in recs if r["kind"] == "request_shed"]
    assert sorted(r["trace_id"] for r in sheds) == sorted(admits)
    assert not router.is_warm(router._specs[0])   # no pool was built


def test_failing_builds_exhaust_retry_budget_and_shed(tmp_path):
    router = _router(policies={"retry": trt.TenantClassPolicy(
        retry_budget=2, backoff_base_s=0.01, backoff_cap_s=0.02)})
    lp = str(tmp_path / "ledger.jsonl")
    with tobs.ledger(lp), tfi.failing_build_injector(n_failures=99):
        res = router.serve([_req("t0", tenant_class="retry")])
    assert res[0].shed and res[0].shed_reason == "build_failed"
    assert res[0].retries == 2 and "injected build failure" in res[0].error
    recs = tobs.read_ledger(lp)
    retries = [r for r in recs if r["kind"] == "request_retry"]
    assert [r["attempt"] for r in retries] == [1, 2]
    assert all(r["reason"] == "build_failed" and r["backoff_s"] > 0
               for r in retries)
    sheds = [r for r in recs if r["kind"] == "request_shed"]
    assert len(sheds) == 1 and sheds[0]["retries"] == 2


def test_shed_slot_is_reclaimed_for_the_next_waiter():
    router = _router(policies={"one": trt.TenantClassPolicy(
        max_inflight=1, queue_depth=4, queue_timeout_s=20.0)})
    before = tobs.metrics_snapshot()["counters"].get(
        "serve_slots_reclaimed_total", 0)
    results, lock = [], threading.Lock()

    def submit():
        out = router.serve([_req("t", tenant_class="one")])
        with lock:
            results.extend(out)

    with tfi.failing_build_injector(n_failures=99):
        threads = [threading.Thread(target=submit) for _ in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60.0)
    assert not any(th.is_alive() for th in threads)
    assert len(results) == 3
    assert all(r.shed and r.shed_reason == "build_failed" for r in results)
    after = tobs.metrics_snapshot()["counters"].get(
        "serve_slots_reclaimed_total", 0)
    assert after - before >= 2


def test_killed_build_thread_fails_over_and_storm_and_straggler(tmp_path):
    """A killed build fails over to a retry (no hang); a build storm
    slows only the build; a straggler's sleep lands on its chunks."""
    router = _router(policies={"r": trt.TenantClassPolicy(
        retry_budget=1, backoff_base_s=0.01, backoff_cap_s=0.02)})
    lp = str(tmp_path / "ledger.jsonl")
    t0 = time.perf_counter()
    with tobs.ledger(lp), tfi.kill_router_thread_injector(1) as kills, \
            tfi.compile_storm_injector(extra_s=0.1):
        res = router.serve([_req("k", tenant_class="r", steps=1)])
    assert kills == [0] and res[0].ok and res[0].retries == 1
    assert res[0].cold and time.perf_counter() - t0 >= 0.1
    retries = [r for r in tobs.read_ledger(lp)
               if r["kind"] == "request_retry"]
    assert [r["reason"] for r in retries] == ["build_failed"]
    with tfi.slow_lane_injector(extra_s=0.05):
        warm = router.serve([_req("s", steps=3)])[0]
    assert warm.ok and not warm.cold and warm.total_s >= 0.1
    with tfi.slow_lane_injector(extra_s=5.0, match=lambda s: False):
        fast = router.serve([_req("f", steps=1)])[0]
    assert fast.ok and fast.total_s < 5.0
    assert router.drain_builds(5.0) == 0


def test_open_loop_counts_results_and_errors():
    class FakeRouter:
        def __init__(self):
            self.n = 0
            self.lock = threading.Lock()

        def serve(self, reqs):
            with self.lock:
                self.n += 1
                k = self.n
            if k == 3:
                raise RuntimeError("boom")
            return [trt.RequestResult(
                tenant=r.tenant, ok=k % 4 != 0, quarantined=False,
                cold=False, bucket_lanes=2, lane=0, steps_done=1,
                first_step_s=0.02, total_s=0.03, family_key="k",
                shed=k % 4 == 0,
                shed_reason="queue_full" if k % 4 == 0 else None,
                queue_wait_s=0.01) for r in reqs]

    arrivals = [tlg.Arrival(t=i * 0.01, scenario="s",
                            request=_req(f"interactive-{i}",
                                         tenant_class="interactive"))
                for i in range(8)]
    run = tlg.run_open_loop(FakeRouter(), arrivals, time_scale=0.1,
                            join_timeout_s=30.0)
    assert run["hung_threads"] == 0
    assert len(run["errors"]) == 1 and "boom" in run["errors"][0]
    assert len(run["results"]) == 7
    summary = tlg.traffic_summary(run["results"], run["wall_s"])
    assert summary["submitted"] == 7
    assert summary["shed"] == summary["shed_by_reason"].get("queue_full", 0)


# ---------------------------------------------------------------------------
# the end-to-end drills (slow, as the reference's)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_soak_smoke_drill_end_to_end(tmp_path):
    res = tfi.run_soak_smoke(str(tmp_path), duration_s=6.0, rate_rps=6.0,
                             device="cpu")
    assert res["soak_smoke"] == "ok" and res["lost"] == 0
    assert res["hung_threads"] == 0 and res["chaos_submitted"] > 0


@pytest.mark.slow
def test_soak_drill_summary(tmp_path):
    lp = str(tmp_path / "soak.jsonl")
    with tobs.ledger(lp):
        out = tlg.soak_drill(seed=0, duration_s=4.0, rate_rps=4.0,
                             time_scale=0.5, device="cpu")
    assert out["hung_threads"] == 0 and out["submitted"] == out["arrivals"]
    assert out["completed"] + out["shed"] == out["submitted"]
