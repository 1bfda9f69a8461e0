"""Port parity of the elastic warm pools (``ibamr_tpu_torch/serve/
autoscale.py``) against ``ibamr_tpu/serve/autoscale.py`` on the CPU.

Both managers are fed the same scripted admit stream on a virtual clock
over one stub router each (the manager-facing slice of
``WarmPoolRouter``, as ``tests/test_autoscale.py`` stubs it), with an
injected ``pressure_fn``: they make the same grow, warmed, shrink,
deferred and mode decisions, with the same mix snapshots, in the same
order. The mix estimator replays the reference's estimate bit for bit;
the serving manifest round-trips with the reference's body and a
manifest whose digest does not verify is refused.

Pool bytes: on the port's real router a pool's entries report its
resident bytes, so a bytes-only squeeze (no backlog, no queue wait)
moves the measured pressure — and the manager — into brownout, and
releasing the squeeze brings it back through the dwell. The restart
drill and the end-to-end elastic drill are ``slow``, as the
reference's are; the card runs the drill in ``chip_smoke.py``'s
``serve`` phase."""

import json

import numpy as np
import pytest
import torch

from ibamr_tpu.serve import autoscale as jas
from ibamr_tpu.serve import router as jrt
from ibamr_tpu_torch import obs as tobs
from ibamr_tpu_torch.serve import autoscale as tas
from ibamr_tpu_torch.serve import router as trt
from ibamr_tpu_torch.serve.aot_cache import ExecutableCache
from ibamr_tpu_torch.tools import fault_injection as tfi

_FAM_A = (8, 6, 8, None, None, 0.05)
_FAM_B = (8, 6, 12, None, None, 0.05)
_FAM_C = (8, 6, 10, None, None, 0.05)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _StubCache:
    max_bytes = None
    directory = None

    def __init__(self):
        self.released = []

    def bytes(self):
        return 0

    def release(self, keys):
        keys = list(keys)
        self.released.extend(keys)
        return len(keys)


class _StubRouter:
    """The manager-facing slice of WarmPoolRouter over ``mod``'s
    BucketSpec: pools are dict entries, builds publish at once."""

    def __init__(self, mod, families=()):
        self.mod = mod
        self.cache = _StubCache()
        self.default_lanes = 2
        self.manager = None
        self.inflight = {}
        self.backlog = 0
        self.admission = type("_A", (), {"_policies": {}})()
        self._pools = {f: self._spec(f) for f in families}

    def _spec(self, family):
        return self.mod.BucketSpec(
            n_cells=family[0], n_lat=family[1], n_lon=family[2],
            engine=family[3], spectral_dtype=family[4], mu=family[5],
            lanes=self.default_lanes)

    def live_families(self):
        return dict(self._pools)

    def live_specs(self):
        return list(self._pools.values())

    def family_inflight(self, family):
        return self.inflight.get(family, 0)

    def build_backlog(self):
        return self.backlog

    def _bucket_for(self, family, count):
        return self._spec(family)

    def _ensure_pool(self, spec, trace_ids=()):
        def wait(timeout=None):
            self._pools[spec.family()] = spec
            return spec
        return wait

    def release_pool(self, spec):
        self._pools.pop(spec.family(), None)
        return self.cache.release([str(spec.family())])

    def drain_builds(self, timeout_s=60.0):
        return 0


def _run_script(mod, amod, families, policy_kw, script):
    """Drive one manager through ``script``; returns its decisions."""
    router = _StubRouter(mod, families)
    pressure = {"queue_p99_s": 0.0, "backlog": 0, "cache_frac": 0.0}
    mgr = amod.ElasticPoolManager(router,
                                  policy=amod.ScalePolicy(**policy_kw),
                                  pressure_fn=lambda: dict(pressure))
    for op in script:
        if op[0] == "admit":
            _, fam, t = op
            mgr.observe_admit(mod.ScenarioRequest(
                tenant="t", n_cells=fam[0], n_lat=fam[1], n_lon=fam[2],
                engine=fam[3], spectral_dtype=fam[4], mu=fam[5]), t=t)
        elif op[0] == "tick":
            mgr.tick(t=op[1])
        elif op[0] == "pressure":
            pressure.update(op[1])
        elif op[0] == "inflight":
            router.inflight[op[1]] = op[2]
        # the grow watcher is a thread: join it after every step so the
        # "warmed" record lands at the same place in both streams
        mgr.drain(timeout_s=5.0)
    events = [{k: v for k, v in e.items() if k != "warm_s"}
              for e in mgr.scale_events]
    return {"events": events, "transitions": mgr.transitions,
            "mode": mgr.mode, "live": sorted(map(str, router._pools)),
            "released": router.cache.released,
            "shed_batch": mgr.should_shed("batch"),
            "cap": mgr.cruise_cap(["batch", "batch"]),
            # the digest covers the grow's wall-clock warm_s
            "manifest": {k: v for k, v in mgr.manifest().items()
                         if k not in ("saved_t", "scale_digest")}}


def _admits(fam, t0, n, dt=0.1):
    return [("admit", fam, t0 + dt * i) for i in range(n)]


_SCRIPTS = {
    "grow_hot_unseen": ((_FAM_A,), {}, _admits(_FAM_B, 0.05, 6)
                        + [("tick", 1.5)]),
    "grow_min_arrivals": ((_FAM_A,), {"grow_min_arrivals": 5},
                          _admits(_FAM_B, 0.0, 3, 0.2) + [("tick", 2.0)]),
    "grow_max_live": ((_FAM_A,), {"max_live_families": 1},
                      _admits(_FAM_B, 0.0, 6) + [("tick", 2.0)]),
    "shrink_after_dwell": ((_FAM_A, _FAM_B), {"shrink_share": 0.3},
                           [("admit", _FAM_A, 0.1)]
                           + _admits(_FAM_B, 0.5, 15)
                           + [("tick", 2.0), ("tick", 2.2)]),
    "never_evict_serving": ((_FAM_A, _FAM_B), {"min_dwell_s": 0.5},
                            [("inflight", _FAM_A, 1)]
                            + _admits(_FAM_B, 0.0, 20)
                            + [("tick", 30.0), ("inflight", _FAM_A, 0),
                               ("tick", 30.5)]),
    "never_to_zero": ((_FAM_A,), {"min_dwell_s": 0.1, "idle_evict_s": 1.0},
                      [("admit", _FAM_A, 0.0), ("tick", 100.0)]),
    "idle_not_regrown": ((_FAM_A, _FAM_B),
                         {"min_dwell_s": 0.5, "idle_evict_s": 2.0},
                         _admits(_FAM_A, 0.0, 2) + _admits(_FAM_B, 0.2, 4)
                         + [("tick", t) for t in (5.0, 5.5, 6.0, 6.5)]),
    "ladder_shed_and_down": ((_FAM_A,), {},
                             [("pressure", {"queue_p99_s": 10.0}),
                              ("tick", 0.1), ("tick", 0.2),
                              ("pressure", {"queue_p99_s": 0.5}),
                              ("tick", 2.0),
                              ("pressure", {"queue_p99_s": 0.0}),
                              ("tick", 2.5), ("tick", 4.0)]),
    "ladder_dead_band": ((_FAM_A,), {},
                         [("pressure", {"queue_p99_s": 2.0}),
                          ("tick", 0.1),
                          ("pressure", {"queue_p99_s": 0.5})]
                         + [("tick", t) for t in (1.5, 3.0, 9.0)]),
    "ladder_bytes_and_backlog": ((_FAM_A,), {"brownout_backlog": 2},
                                 [("pressure", {"backlog": 2}),
                                  ("tick", 0.1),
                                  ("pressure", {"backlog": 0}),
                                  ("tick", 2.0),
                                  ("pressure", {"cache_frac": 0.95}),
                                  ("tick", 2.1),
                                  ("pressure", {"cache_frac": 0.8}),
                                  ("tick", 4.0),
                                  ("pressure", {"cache_frac": 0.5}),
                                  ("tick", 4.5), ("tick", 6.0)]),
    "brownout_defers_then_resumes": (
        (_FAM_A,), {"grow_share": 0.05, "urgent_share": 0.9,
                    "grow_min_arrivals": 1},
        [("pressure", {"queue_p99_s": 2.0}), ("tick", 0.05)]
        + [op for i in range(3) for op in
           (("admit", _FAM_A, 0.1 + 0.1 * i),
            ("admit", _FAM_B, 0.15 + 0.1 * i))]
        + [("pressure", {"queue_p99_s": 0.0}), ("tick", 2.0)]),
}


def _square_wave():
    ops = []
    for i in range(40):
        ops.append(("pressure", {"queue_p99_s": 2.0 if i % 2 == 0
                                 else 0.0}))
        ops.append(("tick", 0.1 * (i + 1)))
    return ((_FAM_A,), {"mode_min_dwell_s": 2.0}, ops)


def _random_stream(seed):
    rng = np.random.default_rng(seed)
    ops, t = [], 0.0
    fams = (_FAM_A, _FAM_B, _FAM_C)
    for _ in range(80):
        t += float(rng.exponential(0.15))
        r = rng.random()
        if r < 0.1:
            ops.append(("pressure", {
                "queue_p99_s": float(rng.choice([0.0, 0.5, 2.0, 5.0])),
                "backlog": int(rng.integers(0, 5)),
                "cache_frac": float(rng.choice([0.0, 0.8, 0.95]))}))
        elif r < 0.2:
            ops.append(("tick", t))
        else:
            p = (0.7, 0.2, 0.1) if t < 6.0 else (0.05, 0.15, 0.8)
            ops.append(("admit", fams[int(rng.choice(3, p=p))], t))
    return ((_FAM_A,), {"min_dwell_s": 1.0, "idle_evict_s": 4.0,
                        "max_live_families": 2}, ops)


_SCRIPTS["square_wave"] = _square_wave()
for _s in range(3):
    _SCRIPTS[f"random_stream_{_s}"] = _random_stream(_s)


@pytest.mark.parametrize("name", sorted(_SCRIPTS))
def test_manager_decisions_equal_reference(name):
    families, policy_kw, script = _SCRIPTS[name]
    policy_kw = dict({"window_s": 0.5, "grow_share": 0.10,
                      "grow_min_arrivals": 2, "min_dwell_s": 2.0,
                      "mode_min_dwell_s": 1.0}, **policy_kw)
    t = _run_script(trt, tas, families, policy_kw, script)
    j = _run_script(jrt, jas, families, policy_kw, script)
    assert t == j
    if name in ("grow_hot_unseen", "shrink_after_dwell",
                "ladder_shed_and_down", "brownout_defers_then_resumes",
                "ladder_bytes_and_backlog"):
        assert t["events"] or t["transitions"]


def test_mix_estimator_equals_reference():
    for seed in range(4):
        rng = np.random.default_rng(seed)
        stream = [(str(int(rng.integers(0, 4))), float(t))
                  for t in np.cumsum(rng.exponential(0.2, 60))]
        te = tas.MixEstimator(window_s=0.5, alpha=0.4)
        je = jas.MixEstimator(window_s=0.5, alpha=0.4)
        for fam, t in stream:
            te.observe(fam, t)
            je.observe(fam, t)
            assert te.mix() == je.mix()
        te.advance(stream[-1][1] + 3.0)
        je.advance(stream[-1][1] + 3.0)
        assert te.mix() == je.mix()
        assert [te.arrivals(str(k)) for k in range(5)] == \
            [je.arrivals(str(k)) for k in range(5)]
    assert tas.MODES == jas.MODES
    from dataclasses import asdict

    assert asdict(tas.ScalePolicy()) == asdict(jas.ScalePolicy())


def test_manifest_round_trip_and_digest_refusal(tmp_path):
    out = {}
    for mod, amod in ((trt, tas), (jrt, jas)):
        router = _StubRouter(mod, (_FAM_A, _FAM_B))
        router.admission._policies = {"interactive": mod.TenantClassPolicy(
            max_inflight=3, deadline_s=2.0)}
        mgr = amod.ElasticPoolManager(router)
        mp = str(tmp_path / f"{amod.__name__}.json")
        mgr.manifest_path = mp
        mgr.save_manifest()
        out[amod] = (mp, amod.read_serving_manifest(mp))
    (tp, tbody), (jp, jbody) = out[tas], out[jas]
    assert tbody == jbody
    # each reads the other's manifest: the same digest discipline
    assert tas.read_serving_manifest(jp) == jbody
    fams = {trt.BucketSpec(**f).family() for f in tbody["families"]}
    assert fams == {_FAM_A, _FAM_B}
    raw = open(tp).read().replace('"mode": "healthy"', '"mode": "healthy "')
    with open(tp, "w") as f:
        f.write(raw)
    with pytest.raises(ValueError, match="digest"):
        tas.read_serving_manifest(tp)
    doc = json.load(open(jp))
    doc["body"]["manifest_schema"] = 99
    import hashlib

    doc["digest"] = hashlib.sha256(json.dumps(
        doc["body"], sort_keys=True).encode()).hexdigest()
    json.dump(doc, open(tp, "w"))
    with pytest.raises(ValueError, match="schema"):
        tas.read_serving_manifest(tp)


# ---------------------------------------------------------------------------
# pool bytes on the port's real router
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def live():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cache = ExecutableCache()
    spec = trt.BucketSpec(n_cells=8, n_lat=6, n_lon=8, lanes=2)
    router = trt.WarmPoolRouter([spec], cache=cache, device="cpu")
    router.warm(spec)
    torch.set_num_threads(n)
    return router, spec


def test_bytes_only_squeeze_drives_brownout_and_back(live, tmp_path):
    router, spec = live
    cache = router.cache
    pool = router._pools[spec]
    assert cache.bytes() == pool.resident_bytes > 0
    pol = tas.ScalePolicy(mode_min_dwell_s=1.0)
    lp = str(tmp_path / "ledger.jsonl")
    with tobs.ledger(lp):
        mgr = tas.ElasticPoolManager(router, policy=pol)
        try:
            mgr.tick(t=0.0)
            assert mgr.mode == "healthy"
            ceiling = int(cache.bytes() / 0.95)
            with tfi.memory_pressure_injector(cache, ceiling) as ev:
                p = mgr.pressure()
                assert ev == [0] and p["backlog"] == 0
                assert p["queue_p99_s"] == 0.0
                assert pol.brownout_cache_frac <= p["cache_frac"] < 1.0
                mgr.tick(t=0.1)
                assert mgr.mode == "brownout"
                assert mgr.cruise_cap(["batch"]) == 1
            assert cache.max_bytes is None
            mgr.tick(t=0.5)                    # inside the dwell: holds
            assert mgr.mode == "brownout"
            mgr.tick(t=1.2)
            assert mgr.mode == "healthy"
        finally:
            router.manager = None
    modes = [r for r in tobs.read_ledger(lp) if r["kind"] == "serve_mode"]
    assert [(r["prev"], r["mode"]) for r in modes] == [
        ("healthy", "brownout"), ("brownout", "healthy")]
    assert modes[0]["backlog"] == 0 and modes[0]["queue_p99_s"] == 0.0
    assert modes[0]["cache_frac"] >= pol.brownout_cache_frac


def test_release_pool_returns_bytes_and_squeeze_evicts_lru(live):
    router, spec = live
    cache = router.cache
    pool = router._pools[spec]
    held = cache.bytes()
    with tfi.memory_pressure_injector(cache, held - 1) as ev:
        assert ev[0] >= 1 and cache.bytes() < held
    assert cache.max_bytes is None
    # the squeeze evicted an entry; the pool rebuilds it on its next use
    router.serve([trt.ScenarioRequest(tenant="x", n_cells=8, n_lat=6,
                                      n_lon=8, steps=3)])
    assert cache.bytes() == held == pool.resident_bytes
    # another lane count: entries of their own (a pool's entries are
    # keyed by lanes and length, so a pool of the same lanes would
    # share the ack entry)
    other = trt.BucketSpec(n_cells=8, n_lat=6, n_lon=8, lanes=3)
    router._specs.append(other)
    router.warm(other)
    both = cache.bytes()
    assert both > held
    assert router.release_pool(other) == 2
    assert cache.bytes() == held


# ---------------------------------------------------------------------------
# the restart and elastic drills (slow, as the reference's)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_restart_drill_zero_fresh_compiles(tmp_path):
    d = str(tmp_path / "cache")
    spec = trt.BucketSpec(n_cells=8, n_lat=6, n_lon=8, lanes=2)
    router = trt.WarmPoolRouter([spec], cache=ExecutableCache(directory=d),
                                device="cpu")
    mgr = tas.ElasticPoolManager(router)
    router.warm(spec)
    mp = mgr.save_manifest(str(tmp_path / "serving_manifest.json"))
    router2, mgr2, stats = tas.restore_serving_manifest(mp, device="cpu")
    assert stats["fresh_compiles"] == 0 and stats["warmed"] == 1
    assert stats["persistent_loads"] == 2 and not stats["errors"]
    res = router2.serve([trt.ScenarioRequest(tenant="r", n_cells=8,
                                             n_lat=6, n_lon=8)])[0]
    assert res.ok and not res.cold
    # a cache directory that never saw the family: every build is fresh
    fresh = tmp_path / "fresh.json"
    body = json.load(open(mp))
    body["body"]["cache_dir"] = str(tmp_path / "empty")
    import hashlib

    body["digest"] = hashlib.sha256(json.dumps(
        body["body"], sort_keys=True).encode()).hexdigest()
    json.dump(body, open(fresh, "w"))
    _, _, st = tas.restore_serving_manifest(str(fresh), device="cpu")
    assert st["fresh_compiles"] == 2


@pytest.mark.slow
def test_run_elastic_smoke_end_to_end(tmp_path):
    res = tfi.run_elastic_smoke(str(tmp_path), device="cpu")
    assert res["elastic_smoke"] == "ok" and res["lost"] == 0
    assert res["restart_fresh_compiles"] == 0
    assert res["squeeze_cache_frac"] >= 0.9
    assert res["squeeze_mode"] in ("brownout", "shed_batch")


def test_grow_on_the_real_router_never_blocks_serving(live):
    """A grow for an unseen family builds on the router's build thread
    (slowed by a build storm) while the warm family keeps serving."""
    router, spec = live
    mgr = tas.ElasticPoolManager(router, policy=tas.ScalePolicy(
        grow_share=0.05, grow_min_arrivals=1))
    try:
        fam = trt.ScenarioRequest(tenant="g", n_cells=8, n_lat=6, n_lon=12)
        with tfi.compile_storm_injector(extra_s=0.5):
            mgr.observe_admit(fam, t=0.0)
            mgr.observe_admit(fam, t=0.1)
            assert router.build_backlog() == 1
            res = router.serve([trt.ScenarioRequest(
                tenant="w", n_cells=8, n_lat=6, n_lon=8, steps=1)])[0]
            assert res.ok and not res.cold
            assert router.build_backlog() == 1   # the grow still building
            assert mgr.drain(timeout_s=30.0) == 0
        assert fam.family() in router.live_families()
        acts = [e["action"] for e in mgr.scale_events]
        assert acts[:2] == ["grow", "warmed"]
        router.release_pool(router.live_families()[fam.family()])
    finally:
        router.manager = None
