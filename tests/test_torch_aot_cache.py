"""Port parity of the executable cache (``ibamr_tpu_torch/serve/
aot_cache.py``) against ``ibamr_tpu/serve/aot_cache.py`` on the CPU.

``cache_key`` hashes the same fingerprint material to the same key as
the reference's (the reference's function run over the port's
``KEY_FIELDS``); ``arg_signature`` names shapes and dtypes as the
reference does. The mechanics are driven through both caches with the
same fake builds and compared: hits, misses and LRU order, the bytes
ceiling, concurrent builds of one key, a failed build, and the refusal
of a corrupt manifest. ``aot_compile`` gives a warm eager entry on the
CPU (CUDA-graph capture is for tensors on the card), ``cached_step``
serves the shell step bitwise, and two identical tuner trials are a
miss, then a hit."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu.serve import aot_cache as jac
from ibamr_tpu_torch import obs as tobs
from ibamr_tpu_torch.serve import aot_cache as tac

RNG = np.random.default_rng(20261018)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fp(tag):
    return {"config_digest": f"cfg-{tag}", "engine": "scatter",
            "spectral_dtype": None, "platform": "cuda",
            "device_count": 1, "torch_version": "2.11.0+cu128",
            "device_kind": "NVIDIA H100 80GB HBM3",
            "integrator": {"kind": "IBExplicitIntegrator",
                           "n": [16, 16, 16], "mu": 0.05},
            "numpy_version": "2.0", "injectors": {}}


def test_cache_key_equals_reference_on_the_same_material(monkeypatch):
    assert set(tac.KEY_FIELDS) == (set(jac.KEY_FIELDS)
                                   - {"x64", "jax_version"}
                                   | {"torch_version", "device_kind"})
    monkeypatch.setattr(jac, "KEY_FIELDS", tac.KEY_FIELDS)
    for i in range(6):
        fp = _fp(i)
        extra = {"kind": "assim_chunk", "piece": "analyze",
                 "lanes": int(RNG.integers(1, 9)),
                 "args": [[[6, 16, 16, 16], "float64"], [[], "float"]]}
        assert tac.cache_key(fp) == jac.cache_key(fp)
        assert tac.cache_key(fp, extra) == jac.cache_key(fp, extra)
        assert tac.cache_key(dict(reversed(list(fp.items()))), extra) == \
            tac.cache_key(fp, extra)
    # run identity outside KEY_FIELDS does not move the key
    fp = _fp("x")
    assert tac.cache_key(fp) == tac.cache_key(dict(fp, injectors={"a": 1}))
    assert tac.cache_key(fp) != tac.cache_key(dict(fp, device_kind="cpu"))
    assert tac.cache_key(fp, {"length": 1}) != tac.cache_key(
        fp, {"length": 2})


def test_arg_signature_names_leaves_as_the_reference():
    x = RNG.standard_normal((3, 4, 5))
    args_j = ((jnp.asarray(x), (jnp.asarray(x[0]), jnp.asarray(x[1]))),
              2.5e-3)
    args_t = ((torch.tensor(x), (torch.tensor(x[0]), torch.tensor(x[1]))),
              2.5e-3)
    assert tac.arg_signature(args_t) == jac.arg_signature(args_j)
    f32 = torch.zeros(2, dtype=torch.float32)
    assert tac.arg_signature((f32,)) == jac.arg_signature(
        (jnp.zeros(2, jnp.float32),))


def _drive(mod, ops, **kw):
    """Run one sequence of (tag, size) lookups through a fresh cache of
    ``mod``; returns the build order, the stats and the keys held."""
    cache = mod.ExecutableCache(**kw)
    builds = []

    class Exe:
        def __init__(self, tag, size):
            self.tag, self.size_bytes = tag, size

        # the reference's estimator reads the HLO text length
        def as_text(self):
            return "x" * self.size_bytes

    for tag, size in ops:
        cache.get_or_compile(
            _fp(tag) | {"integrator": None},
            lambda t=tag, s=size: builds.append(t) or Exe(t, s))
    st = cache.stats()
    return builds, st, [cache.get(k).executable.tag for k in cache.keys()]


def test_lru_and_byte_ceiling_match_reference():
    ops = [("a", 10), ("a", 10), ("b", 10), ("a", 10), ("c", 10),
           ("b", 10), ("c", 10), ("d", 10)]
    assert _drive(tac, ops, capacity=2) == _drive(jac, ops, capacity=2)
    got = _drive(tac, ops, capacity=2)
    assert got[0] == ["a", "b", "c", "b", "d"]
    ops = [(t, int(RNG.integers(50, 400))) for t in "abcdefabcgh"]
    for kw in (dict(capacity=16, max_bytes=700),
               dict(capacity=3, max_bytes=500)):
        assert _drive(tac, ops, **kw) == _drive(jac, ops, **kw)
    cache = tac.ExecutableCache(capacity=16)
    for tag in "abc":
        cache.get_or_compile(_fp(tag), lambda: tac.WarmCallable(
            lambda: 0, size_bytes=300))
    assert cache.bytes() == 900
    assert cache.set_max_bytes(500) == 2 and cache.bytes() == 300
    assert cache.release(cache.keys()) == 1
    assert cache.stats()["released"] == 1 and cache.bytes() == 0


def test_concurrent_builds_of_one_key_build_once():
    cache = tac.ExecutableCache(capacity=4)
    n_builds = [0]
    release = threading.Event()

    def slow_build():
        n_builds[0] += 1
        release.wait(5.0)
        return object()

    got = []
    threads = [threading.Thread(target=lambda: got.append(
        cache.get_or_compile(_fp("k"), slow_build))) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    release.set()
    for t in threads:
        t.join(10.0)
    assert n_builds[0] == 1
    assert len({id(e.executable) for e in got}) == 1
    st = cache.stats()
    assert (st["misses"], st["hits"]) == (1, 3)
    with pytest.raises(RuntimeError, match="boom"):
        cache.get_or_compile(_fp("bad"), lambda: (_ for _ in ()).throw(
            RuntimeError("boom")))
    assert cache.get_or_compile(_fp("bad"), lambda: "ok").executable == "ok"


def test_corrupt_manifest_refused_and_reaped(tmp_path):
    d = str(tmp_path / "aot")
    cache = tac.ExecutableCache(capacity=4, directory=d)
    ent = cache.get_or_compile(_fp("m"), lambda: tac.WarmCallable(
        lambda: 0, mode="graph", size_bytes=8))
    path = cache.manifest_path(ent.key)
    assert cache.published_keys() == [ent.key]
    body = json.load(open(path))["body"]
    assert body["mode"] == "graph" and body["key"] == ent.key
    # the reference reads the port's manifest format (same digest rule)
    assert jac.ExecutableCache(directory=d)._read_manifest(ent.key) == body
    doc = json.load(open(path))
    doc["body"]["label"] = "tampered"
    json.dump(doc, open(path, "w"))
    fresh = tac.ExecutableCache(capacity=4, directory=d)
    assert fresh._read_manifest(ent.key) is None
    assert not os.path.exists(path)
    assert fresh.stats()["corrupt"] == 1
    assert fresh.get_or_compile(_fp("m"), lambda: "x").cold_source == \
        "compile"
    ent2 = cache.get_or_compile(_fp("m2"), lambda: "exe")
    with open(cache.manifest_path(ent2.key), "w") as f:
        f.write("{not json")
    assert fresh._read_manifest(ent2.key) is None
    ent3 = cache.get_or_compile(_fp("m3"), lambda: "exe")
    warm = tac.ExecutableCache(capacity=4, directory=d).get_or_compile(
        _fp("m3"), lambda: "exe")
    assert warm.key == ent3.key and warm.cold_source == "persistent"


def test_cache_records_land_in_the_ledger(tmp_path):
    led = str(tmp_path / "ledger.jsonl")
    cache = tac.ExecutableCache(capacity=1)
    with tobs.ledger(led):
        for tag in ("a", "a", "b"):
            cache.get_or_compile(_fp(tag), lambda: tac.WarmCallable(
                lambda: 0), label="t")
    recs = [r for r in tobs.read_ledger(led) if r["kind"] == "aot_cache"]
    assert [r["event"] for r in recs] == ["miss", "hit", "evict", "miss"]
    assert recs[0]["mode"] == "eager"
    assert tac.enable_persistent_cache(str(tmp_path)) is None


def test_aot_compile_and_cached_step_serve_the_step_bitwise():
    from ibamr_tpu_torch.models.shell3d import build_shell_example

    integ, s0 = build_shell_example(n_cells=16, n_lat=8, n_lon=8,
                                    dtype=torch.float64, device="cpu",
                                    use_fast_interaction="packed")
    calls = []

    def fn(s):
        calls.append(1)
        return integ.step(s, 5e-3)

    warm = tac.aot_compile(fn, (s0,), graph_safe=True)
    assert warm.mode == "eager" and calls == [1]    # CPU: no capture
    ref = integ.step(s0, 5e-3)
    out = warm(s0)
    assert torch.equal(out.X, ref.X) and torch.equal(out.ins.p, ref.ins.p)
    cache = tac.ExecutableCache()
    f1, e1 = tac.cached_step(integ, s0, 5e-3, cache=cache)
    f2, e2 = tac.cached_step(integ, s0, 5e-3, cache=cache)
    assert e1 is e2 and cache.stats()["hits"] == 1
    fp = tac.step_fingerprint(integ)
    assert fp["platform"] == "cpu" and fp["device_kind"] == "cpu"
    assert fp["torch_version"] == torch.__version__
    assert fp["engine"] == "packed"
    s1 = f2(s0, 5e-3)
    assert torch.equal(s1.X, ref.X) and torch.equal(s1.ins.u[0],
                                                    ref.ins.u[0])


def test_a_second_identical_tuner_trial_is_a_hit():
    from ibamr_tpu_torch.tune.runner import run_trial
    from ibamr_tpu_torch.tune.space import Candidate

    cache = tac.ExecutableCache()
    cand = Candidate(engine="scatter", spectral_dtype="f32",
                     chunk_length=2)
    kw = dict(n_cells=8, n_lat=6, n_lon=8, reps=1, cache=cache,
              device="cpu")
    t1 = run_trial(cand, **kw)
    t2 = run_trial(cand, **kw)
    assert t1.error is None and t2.error is None
    assert not t1.cache_hit and t1.recompiles == 1
    assert t2.cache_hit and t2.recompiles == 0
    assert t2.compile_s == t1.compile_s > 0
    t3 = run_trial(Candidate(engine="scatter", spectral_dtype="f32",
                             chunk_length=1), **kw)
    assert not t3.cache_hit and t3.recompiles == 1
    assert cache.stats()["misses"] == 2
