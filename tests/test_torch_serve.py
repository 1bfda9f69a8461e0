"""Port parity of the warm-pool router (``ibamr_tpu_torch/serve/
router.py``) and the serve CLI (``ibamr_tpu_torch/tools/serve.py``)
against ``ibamr_tpu/serve/router.py`` and ``tools/serve.py`` on the CPU.

The reference's router tests serve an 8^3 family (a 6 x 8 shell, the
engine the resolver picks). The same request lists go through the
reference's router (JAX, x64; its pool built at f64 through a wrapper of
its ``build_shell_example``, which defaults to f32) and the port's
(``device="cpu"``, f64):
each request's bucket, lane, padding, ``ok``, ``quarantined`` and
``steps_done`` are equal, and so are the ledger's record kinds and their
non-timing fields (the family keys by structure: the port keys on its
own fingerprint fields). The pool's cruise chunk, on the reference's
stacked template carried over by ``convert.py``, agrees with the
reference's at f64 roundoff, and a healthy lane beside a poisoned one is
bitwise its run beside padding. The contract drill gives the four
structural numbers of the port's ``SERVE_CONTRACT.json`` on the CPU, and
``check`` exits 0/1/2 as the reference's does. A pool's entries carry
its resident bytes, and ``release_pool`` returns them."""

import json
import os

import numpy as np
import pytest
import torch

from ibamr_tpu import obs as jobs
from ibamr_tpu.serve import aot_cache as jac
from ibamr_tpu.serve import router as jrt
from ibamr_tpu_torch import convert
from ibamr_tpu_torch import obs as tobs
from ibamr_tpu_torch.serve import aot_cache as tac
from ibamr_tpu_torch.serve import router as trt
from ibamr_tpu_torch.utils.tree import leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(20261018)

_N, _N_LAT, _N_LON = 8, 6, 8
# per-record fields that carry time, identity or the process's key
_VOLATILE = {"t", "seq", "run_id", "trace_id", "trace_ids", "dur_s",
             "first_step_s", "total_s", "queue_wait_s", "compile_s",
             "t_wall", "proc", "key", "family", "label", "overhead_s",
             "fingerprint", "size_bytes", "mode", "parent", "depth"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def routers():
    """The reference's and the port's router, each with one warm 4-lane
    bucket of the 8^3 family."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jspec = jrt.BucketSpec(n_cells=_N, n_lat=_N_LAT, n_lon=_N_LON, lanes=4)
    tspec = trt.BucketSpec(n_cells=_N, n_lat=_N_LAT, n_lon=_N_LON, lanes=4)
    jr = jrt.WarmPoolRouter([jspec], cache=jac.ExecutableCache(),
                            allow_dynamic=False)
    tr = trt.WarmPoolRouter([tspec], cache=tac.ExecutableCache(),
                            allow_dynamic=False, device="cpu",
                            dtype=torch.float64)
    # the reference's build_shell_example defaults to f32 whatever the x64
    # mode; its pool is built at f64 here through a wrapper, so both
    # routers serve the same f64 family
    import jax.numpy as jnp

    from ibamr_tpu.models import shell3d as jshell

    build = jshell.build_shell_example
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jshell, "build_shell_example",
                   lambda **kw: build(dtype=jnp.float64, **kw))
        jr.warm(jspec)
    tr.warm(tspec)
    torch.set_num_threads(n)
    return (jr, jspec), (tr, tspec)


def _reqs(mod, specs):
    return [mod.ScenarioRequest(tenant=tag, n_cells=_N, n_lat=_N_LAT,
                                n_lon=_N_LON, **kw) for tag, kw in specs]


def _is_key(s) -> bool:
    return (isinstance(s, str) and len(s) == 16
            and all(c in "0123456789abcdef" for c in s))


def _strip(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in _VOLATILE}


def _serve_both(routers, tmp_path, specs, tag):
    (jr, _), (tr, _) = routers
    out = []
    for mod, r, obs in ((jrt, jr, jobs), (trt, tr, tobs)):
        path = str(tmp_path / f"{tag}-{mod.__name__}.jsonl")
        with obs.ledger(path):
            res = r.serve(_reqs(mod, specs))
        out.append((res, obs.read_ledger(path)))
    return out


_BATCHES = {
    "padded": [("t0", {"steps": 2}), ("t1", {"steps": 3}),
               ("t2", {"steps": 1})],
    "split": [(f"s{i}", {"steps": 1 + i % 3}) for i in range(6)],
    "quarantine": [("good", {"steps": 3}),
                   ("bad", {"steps": 3, "perturb": float("nan")}),
                   ("also-good", {"steps": 2, "perturb": 0.5})],
    "poison_inf": [("good", {"steps": 2}),
                   ("bad", {"steps": 2, "perturb": float("inf")})],
}


@pytest.mark.parametrize("name", sorted(_BATCHES))
def test_router_serves_like_the_reference(routers, tmp_path, name):
    (jres, jrecs), (tres, trecs) = _serve_both(routers, tmp_path,
                                               _BATCHES[name], name)
    fields = ("tenant", "ok", "quarantined", "cold", "bucket_lanes",
              "lane", "steps_done", "shed", "shed_reason", "retries")
    assert [[getattr(r, f) for f in fields] for r in tres] == \
        [[getattr(r, f) for f in fields] for r in jres]
    assert all(_is_key(r.family_key) for r in tres)
    assert [r.error for r in tres] == [r.error for r in jres]
    # the ledgers: the same record kinds in the same order, the same
    # non-timing fields, and keys of the same structure
    skip = ("run_start", "run_end")
    jk = [r for r in jrecs if r["kind"] not in skip]
    tk = [r for r in trecs if r["kind"] not in skip]
    assert [r["kind"] for r in tk] == [r["kind"] for r in jk]
    for a, b in zip(tk, jk):
        if a["kind"] == "span":
            assert a.get("path") == b.get("path")
            continue
        assert _strip(a) == _strip(b), a["kind"]
        for f in ("family", "key"):
            if f in b and _is_key(b[f]):
                assert _is_key(a[f])
            elif f in b:
                assert a[f] == b[f]
    # every admitted id reaches exactly one terminal record
    admits = [r["trace_id"] for r in trecs if r["kind"] == "request_admit"]
    done = [r["trace_id"] for r in trecs
            if r["kind"] in ("request", "request_shed")]
    assert sorted(admits) == sorted(done)
    # the padding histogram and counters move as the reference's
    assert sum(r.lane == 0 for r in tres) == sum(r.lane == 0 for r in jres)


def test_unknown_family_without_dynamic_raises_and_sheds(routers,
                                                          tmp_path):
    (_, _), (tr, _) = routers
    path = str(tmp_path / "alien.jsonl")
    with tobs.ledger(path):
        with pytest.raises(KeyError, match="no declared bucket"):
            tr.serve([trt.ScenarioRequest(tenant="alien", n_cells=_N,
                                          n_lat=4, n_lon=4)])
    sheds = [r for r in tobs.read_ledger(path)
             if r["kind"] == "request_shed"]
    assert [r["reason"] for r in sheds] == ["no_bucket"]


def test_cruise_chunk_matches_reference_at_f64_roundoff(routers):
    (jr, jspec), (tr, tspec) = routers
    jpool, tpool = jr._pools[jspec], tr._pools[tspec]
    stacked, dt_vec, alive = jpool._template_args(live=3)
    # distinct lane values: a seeded velocity offset per lane
    offs = RNG.standard_normal((4, 3)) * 1e-3
    u = tuple(c + np.asarray(offs[:, d]).reshape((4,) + (1,) * 3)
              for d, c in enumerate(stacked.ins.u))
    stacked = stacked._replace(ins=stacked.ins._replace(u=u))
    # f64 lane dts: the reference's served chunk takes an f32 dt vector,
    # with which XLA forms some dt coefficients in f32; its jitted chunk
    # is called at f64 here, so only roundoff separates the two
    dts = np.asarray(dt_vec, dtype=np.float64) * np.array([1.0, 0.5, 2.0,
                                                           1.0])
    import jax.numpy as jnp

    jout, jh = jpool.driver._chunk(2)(stacked, jnp.asarray(dts), alive)
    tstate = convert.ib_state(stacked, device="cpu")
    tout, th = tpool.chunk(2)(tstate, dts, np.asarray(alive))
    assert np.array_equal(th.numpy(), np.asarray(jh).astype(np.float32))
    for a, b in zip(leaves(tout), leaves(convert.ib_state(jout,
                                                          device="cpu"))):
        if a.is_floating_point():
            scale = max(float(b.abs().max()), 1e-300)
            assert float((a - b).abs().max()) <= 1e-12 * scale
        else:
            assert torch.equal(a, b)


def test_healthy_lane_bitwise_beside_a_poisoned_lane(routers):
    (_, _), (tr, tspec) = routers
    pool = tr._pools[tspec]
    good = pool.request_state(trt.ScenarioRequest(
        tenant="g", n_cells=_N, n_lat=_N_LAT, n_lon=_N_LON, perturb=0.3))
    bad = pool.request_state(trt.ScenarioRequest(
        tenant="b", n_cells=_N, n_lat=_N_LAT, n_lon=_N_LON,
        perturb=float("inf")))
    from ibamr_tpu_torch.utils.lanes import lane_slice, pad_lanes, stack_lanes

    dt = np.full(4, 5e-5, dtype=np.float32)
    with_bad = stack_lanes([good, bad, good, good])
    mask = np.array([True, True, False, False])
    padded, _ = pad_lanes([good], 4)
    a, ha = pool.chunk(2)(with_bad, dt, mask)
    b, hb = pool.chunk(2)(padded, dt, np.array([True, False, False, False]))
    assert ha.numpy().tolist()[:2] == [1.0, 0.0]
    assert all(torch.equal(x, y) for x, y in
               zip(leaves(lane_slice(a, 0)), leaves(lane_slice(b, 0))))


def test_request_state_never_writes_the_template(routers):
    (_, _), (tr, tspec) = routers
    pool = tr._pools[tspec]
    before = [t.clone() for t in leaves(pool.template)]
    st = pool.request_state(trt.ScenarioRequest(
        tenant="p", n_cells=_N, n_lat=_N_LAT, n_lon=_N_LON, perturb=2.0))
    assert st is not pool.template
    assert st.ins.u[0].data_ptr() != pool.template.ins.u[0].data_ptr()
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 leaves(pool.template)))
    assert float((st.ins.u[2] - pool.template.ins.u[2]).max()) == \
        pytest.approx(2.0 * 1e-3 * 3)
    assert pool.request_state(trt.ScenarioRequest(
        tenant="z", n_cells=_N, n_lat=_N_LAT, n_lon=_N_LON)) \
        is pool.template


def test_pool_entries_carry_resident_bytes_and_release_returns_them():
    cache = tac.ExecutableCache()
    # the packed engine (its plain versions on the CPU) needs 16^3
    spec = trt.BucketSpec(n_cells=16, n_lat=8, n_lon=16, lanes=2,
                          engine="pallas_packed")
    router = trt.WarmPoolRouter([spec], cache=cache, device="cpu",
                                dtype=torch.float64)
    router.warm(spec)
    pool = router._pools[spec]
    tmpl = sum(t.numel() * t.element_size() for t in leaves(pool.template))
    # template + the 2-lane stack + the plan's tables + specs + layout
    assert pool.resident_bytes > 3 * tmpl
    assert cache.bytes() == pool.resident_bytes
    sizes = sorted(cache.get(k).size_bytes for k in pool.entry_keys())
    assert sum(sizes) == pool.resident_bytes and sizes[0] > 0
    assert sorted(cache.keys()) == sorted(pool.entry_keys())
    assert router.release_pool(spec) == 2
    assert cache.bytes() == 0 and len(cache) == 0
    assert not router.is_warm(spec)


def test_contract_drill_and_check_exit_codes(tmp_path, monkeypatch,
                                             capsys):
    """The contract drill on the CPU meets the port's contract (exit 0)
    and holds the reference's four structural numbers; an injected warm
    miss regresses (exit 2); an unbudgeted or improved metric exits 1."""
    from ibamr_tpu_torch.tools import serve as cli

    ref = json.load(open(os.path.join(REPO, "SERVE_CONTRACT.json")))
    port = json.load(open(cli.CONTRACT_PATH))
    assert port["contract"] == ref["contract"]
    assert port["drill"] == ref["drill"]
    assert cli.main(["check", "--device", "cpu", "--json"]) == 0
    measured = json.loads(capsys.readouterr().out)["measured"]
    assert {k: measured[k] for k in cli.CONTRACT_METRICS} == \
        port["contract"]
    assert measured["engine"] == "scatter"
    assert measured["pool_bytes"] > 0

    monkeypatch.setattr(cli, "run_drill",
                        lambda args, device: dict(measured))
    contract = str(tmp_path / "contract.json")
    assert cli.main(["check", "--tighten", "--contract", contract]) == 0
    assert json.load(open(contract))["contract"] == port["contract"]
    assert cli.main(["check", "--contract", contract]) == 0
    for bad in (dict(measured, warm_compiles=1),
                dict(measured, warm_hits=1),
                dict(measured, warm_ok=False)):
        monkeypatch.setattr(cli, "run_drill", lambda args, device, m=bad: m)
        assert cli.main(["check", "--contract", contract]) == 2
    monkeypatch.setattr(cli, "run_drill", lambda args, device: dict(
        measured, cold_compiles=1))
    assert cli.main(["check", "--contract", contract]) == 1
    monkeypatch.setattr(cli, "run_drill",
                        lambda args, device: dict(measured))
    assert cli.main(["check", "--contract",
                     str(tmp_path / "absent.json")]) == 1
    capsys.readouterr()


def test_diff_contract_equals_reference():
    import tools.serve as jcli

    from ibamr_tpu_torch.tools import serve as cli

    base = {"cold_compiles": 2, "warm_compiles": 0, "warm_hits": 2,
            "warm_new_trace_signatures": 0, "cold_ok": True,
            "warm_ok": True}
    contract = dict(base)
    for _ in range(12):
        m = dict(base)
        for k in cli.CONTRACT_METRICS:
            m[k] = int(RNG.integers(0, 4))
        m["warm_ok"] = bool(RNG.integers(0, 2))
        assert cli.diff_contract(m, contract) == \
            jcli.diff_contract(m, contract)
    assert cli.CEILINGS == jcli.CEILINGS and cli.FLOORS == jcli.FLOORS


def test_histogram_delta_equals_reference():
    for _ in range(4):
        keys = ["a", "b", "c"]
        before = {k: {"counts": RNG.integers(0, 5, 6).tolist(),
                      "sum": float(RNG.random())} for k in keys[:2]}
        after = {k: {"counts": (np.asarray(before.get(k, {"counts": [0] * 6})
                                           ["counts"])
                                + RNG.integers(0, 3, 6)).tolist(),
                     "sum": float(RNG.random()) + 1.0} for k in keys}
        assert trt._histogram_delta(before, after) == \
            jrt._histogram_delta(before, after)
