"""Port parity of the sharded checkpoints
(``ibamr_tpu_torch/utils/checkpoint_sharded.py``), the fsck and fleet
CLIs (``ibamr_tpu_torch/tools/{ckpt_fsck,fleet}.py``) and the sharded
drill against the reference's on the CPU.

- A checkpoint written by the reference on its 8 virtual devices
  restores into the port on 4 shards (and one), and one written by the
  port on 8 shards restores into the reference on 4 devices: both
  bitwise, and the two packages' manifests carry the same leaves,
  chunks, CRCs and mesh spec.
- The port's own save never copies the global tensor to the host; a
  block-resident state (``spmd.Blocks`` leaves) saves each shard
  straight from its block, with no whole tensor built, and restores
  bitwise block by block on any mesh, the reference's checkpoint too,
  and through the whole-state files; a step restores bitwise on any
  shard count; every injected damage mode
  fails verification and falls back; the async writer commits in order
  and sheds under ``overflow="drop"``.
- ``ckpt_fsck`` audits and repairs a run directory of both formats (a
  corrupt shard, a torn step), spares a sole damaged candidate, and its
  ``--json`` report agrees with the reference tool's on the same tree.
- The sharded drill (supervised sharded rollback, its capsule replayed
  with ``--sharded``) passes, and the fleet CLI's last line is the JSON
  summary, its lane mesh recorded."""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding as JNamed
from jax.sharding import PartitionSpec as JP

from ibamr_tpu.utils import checkpoint_sharded as jcs
from ibamr_tpu_torch.parallel.mesh import make_mesh
from ibamr_tpu_torch.parallel import spmd
from ibamr_tpu_torch.parallel.spmd import NamedSharding, P, pin, sharding_of
from ibamr_tpu_torch.tools import ckpt_fsck, fleet
from ibamr_tpu_torch.tools.fault_injection import (corrupt_shard, drop_shard,
                                                   run_sharded_smoke,
                                                   stale_manifest_shard,
                                                   tear_manifest)
from ibamr_tpu_torch.utils import checkpoint as ckpt
from ibamr_tpu_torch.utils import checkpoint_sharded as cs


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host_state(seed=0, n=64):
    rng = np.random.default_rng(seed)
    return {"u": rng.standard_normal((n, n)), "v": rng.standard_normal(n),
            "k": np.int64(seed)}


def _place(state, n_shards):
    mesh = make_mesh(n_shards, max_axes=1, device="cpu")
    sh, rep = NamedSharding(mesh, P("x")), NamedSharding(mesh, P())
    return {k: pin(torch.as_tensor(v), sh if np.ndim(v) >= 1 else rep)
            for k, v in state.items()}


def _jplace(state, n):
    mesh = JMesh(np.array(sorted(jax.devices(), key=lambda d: d.id)[:n]),
                 ("x",))
    sh, rep = JNamed(mesh, JP("x")), JNamed(mesh, JP())
    return {k: jax.device_put(jnp.asarray(v), sh if np.ndim(v) >= 1 else rep)
            for k, v in state.items()}, mesh


def _equal(got, want):
    for k in want:
        g = got[k]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert np.array_equal(g, np.asarray(want[k])), k


def test_cross_package_restore_bitwise_both_ways(tmp_path):
    host = _host_state(3)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jstate, jmesh = _jplace(host, 8)
    jcs.save_sharded_checkpoint(jdir, jstate, 5, mesh=jmesh)
    for n in (4, 1):
        got, step, _ = cs.restore_sharded(jdir, _place(_host_state(0), n))
        assert step == 5
        _equal(got, host)
        assert sharding_of(got["u"]).mesh.size == n

    mesh8 = make_mesh(8, max_axes=1, device="cpu")
    cs.save_sharded_checkpoint(tdir, _place(host, 8), 5, mesh=mesh8)
    tmpl, _ = _jplace(_host_state(0), 4)
    got, step, _ = jcs.restore_sharded(tdir, tmpl)
    assert step == 5
    _equal(got, host)
    assert len(got["u"].sharding.device_set) == 4

    jm, tm = jcs.read_manifest(jdir, 5), cs.read_manifest(tdir, 5)
    assert tm["mesh"] == jm["mesh"]
    assert tm["schema"] == jm["schema"]
    assert tm["leaves"] == jm["leaves"]
    assert sorted(tm["shards"]) == sorted(jm["shards"])


def test_save_never_copies_the_global_tensor(tmp_path, monkeypatch):
    fetched = []
    orig = cs._fetch_shard

    def counting(data):
        arr = orig(data)
        fetched.append(arr.nbytes)
        return arr

    monkeypatch.setattr(cs, "_fetch_shard", counting)
    host = _host_state(1)
    cs.save_sharded_checkpoint(str(tmp_path), _place(host, 8), 1)
    assert fetched and max(fetched) < host["u"].nbytes
    assert cs.verify_sharded_checkpoint(str(tmp_path), 1)


def _blocks(state, n_shards, axes=1):
    """The host state with its 2-D leaf as Blocks on an ``n_shards``
    mesh of the CPU, the rest replicated."""
    mesh = make_mesh(n_shards, max_axes=axes, device="cpu")
    spec = P(*mesh.axis_names, *([None] * (2 - len(mesh.axis_names))))
    rep = NamedSharding(mesh, P())
    return {k: spmd.Blocks.cut(mesh, torch.as_tensor(v), spec)
            if np.ndim(v) == 2 else pin(torch.as_tensor(v), rep)
            for k, v in state.items()}


def test_block_resident_save_builds_no_whole_tensor(tmp_path, monkeypatch):
    """Every shard file is written straight from its block: each host
    copy is one block, and no whole tensor is assembled or sliced."""
    fetched = []
    orig = cs._fetch_shard

    def counting(data):
        fetched.append(tuple(data.shape))
        return orig(data)

    def refuse(*a, **k):
        raise AssertionError("a shard write assembled the whole tensor")

    host = _host_state(4)
    state = _blocks(host, 8, axes=2)
    monkeypatch.setattr(cs, "_fetch_shard", counting)
    monkeypatch.setattr(spmd.Blocks, "assemble", refuse)
    monkeypatch.setattr(spmd, "unshard", refuse)
    cs.save_sharded_checkpoint(str(tmp_path), state, 3,
                               mesh=state["u"].mesh)
    assert fetched.count((16, 32)) == 8          # one per (4, 2) block
    assert max(int(np.prod(f)) for f in fetched) < host["u"].size
    assert cs.verify_sharded_checkpoint(str(tmp_path), 3)


@pytest.mark.parametrize("n_src,n_dst", [(8, 8), (8, 2), (4, 8)])
def test_block_resident_state_round_trips_bitwise(tmp_path, n_src, n_dst):
    """A block-resident save restores into Blocks templates of any mesh,
    block by block (and into pinned tensors), bitwise; the reference's
    sharded checkpoint restores into Blocks too; the whole-state files
    assemble at the save and cut at the restore."""
    host = _host_state(n_src + n_dst)
    d = str(tmp_path / "s")
    cs.save_sharded_checkpoint(d, _blocks(host, n_src, axes=2), 4)
    got, step, man = cs.restore_sharded(d, _blocks(_host_state(0), n_dst))
    assert step == 4 and man["mesh"]["n_shards"] == n_src
    assert isinstance(got["u"], spmd.Blocks)
    assert got["u"].mesh.size == n_dst
    _equal(got, host)
    pinned, _, _ = cs.restore_sharded(d, _place(_host_state(0), 2))
    _equal(pinned, host)

    jstate, jmesh = _jplace(host, 8)
    jd = str(tmp_path / "j")
    jcs.save_sharded_checkpoint(jd, jstate, 6, mesh=jmesh)
    got, _, _ = cs.restore_sharded(jd, _blocks(_host_state(0), n_dst))
    _equal(got, host)

    w = str(tmp_path / "w")
    ckpt.save_checkpoint(w, _blocks(host, n_src, axes=2), 2)
    got, _, _ = ckpt.restore_checkpoint(w, _blocks(_host_state(0), n_dst))
    assert isinstance(got["u"], spmd.Blocks)
    _equal(got, host)


@pytest.mark.parametrize("n_src,n_dst", [(8, 8), (8, 1), (1, 8), (8, 4),
                                         (2, 8)])
def test_elastic_restore_matrix(tmp_path, n_src, n_dst):
    host = _host_state(n_src * 10 + n_dst)
    cs.save_sharded_checkpoint(str(tmp_path), _place(host, n_src), 7)
    got, step, man = cs.restore_sharded(str(tmp_path),
                                        _place(_host_state(0), n_dst))
    assert step == 7 and man["mesh"]["n_shards"] == n_src
    _equal(got, host)


@pytest.mark.parametrize("damage", [corrupt_shard, drop_shard, tear_manifest,
                                    stale_manifest_shard])
def test_damage_falls_back_to_previous_verified(tmp_path, damage):
    d = str(tmp_path)
    good = _host_state(1)
    cs.save_sharded_checkpoint(d, _place(good, 8), 5, keep=0)
    cs.save_sharded_checkpoint(d, _place(_host_state(2), 8), 10, keep=0)
    if damage is tear_manifest:
        damage(d, 10)
    else:
        damage(d, 10, shard=7)
    assert not cs.verify_sharded_checkpoint(d, 10)
    assert cs.latest_sharded_step(d) == 5
    with pytest.warns(UserWarning):
        got, step, _ = cs.restore_sharded(d, _place(_host_state(0), 8))
    assert step == 5
    _equal(got, good)
    with pytest.raises(ckpt.CheckpointCorruptError):
        cs.restore_sharded(d, _place(_host_state(0), 8), step=10)


def test_async_writer_commits_in_order_and_sheds(tmp_path):
    d = str(tmp_path / "a")
    w = cs.AsyncShardedWriter(d, keep=10)
    for k in (1, 2, 3):
        w.save(_place(_host_state(k), 4), k)
    w.close()
    assert cs._all_sharded_steps(d) == [1, 2, 3]
    assert all(cs.verify_sharded_checkpoint(d, k) for k in (1, 2, 3))
    got, _, _ = cs.restore_sharded(d, _place(_host_state(0), 2), step=2)
    _equal(got, _host_state(2))

    gate = threading.Event()
    d2 = str(tmp_path / "b")
    w2 = cs.AsyncShardedWriter(d2, max_pending=1, overflow="drop")
    orig = w2._write_step_once

    def slow(*a):
        gate.wait(10)
        return orig(*a)

    w2._write_step_once = slow
    assert w2.save(_place(_host_state(1), 2), 1) is not None
    assert w2.save(_place(_host_state(2), 2), 2) is None
    assert w2.dropped_saves == 1
    gate.set()
    w2.close()
    assert cs._all_sharded_steps(d2) == [1]


def _fsck_tree(d):
    cs.save_sharded_checkpoint(d, _place(_host_state(1), 8), 5)
    cs.save_sharded_checkpoint(d, _place(_host_state(2), 8), 10)
    corrupt_shard(d, 10)
    cs.save_sharded_checkpoint(d, _place(_host_state(3), 8), 12, keep=0)
    tear_manifest(d, 12)
    sub = os.path.join(d, "nested")
    ckpt.save_checkpoint(sub, {"u": torch.arange(8.0)}, 3)
    ckpt.save_checkpoint(sub, {"u": torch.arange(8.0) + 1}, 6)
    from ibamr_tpu_torch.tools.fault_injection import corrupt_checkpoint
    corrupt_checkpoint(sub, 6)
    return sub


def test_fsck_audits_both_formats_and_repairs(tmp_path, capsys):
    from tools import ckpt_fsck as ref_fsck

    d = str(tmp_path)
    sub = _fsck_tree(d)
    rep = ckpt_fsck.audit(d)
    assert not rep["clean"]
    assert rep["counts"]["corrupt"] == 2 and rep["counts"]["torn"] == 1
    assert rep["counts"]["verified"] >= 2
    ref = ref_fsck.audit(d)
    assert rep["counts"] == ref["counts"]
    assert ([[(s["step"], s["status"]) for s in x["steps"]]
             for x in rep["dirs"]]
            == [[(s["step"], s["status"]) for s in x["steps"]]
                for x in ref["dirs"]])
    assert ckpt_fsck.main([d, "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["counts"] == rep["counts"]

    assert ckpt_fsck.main([d, "--repair", "-q"]) == 1
    assert ckpt_fsck.audit(d)["clean"]
    assert ckpt_fsck.main([d, "-q"]) == 0
    assert cs.verify_sharded_checkpoint(d, 5)
    assert ckpt.verify_checkpoint(sub, 3)
    assert os.path.isdir(os.path.join(d, "quarantine", "sharded.00000010"))
    assert os.path.exists(os.path.join(sub, "quarantine",
                                       "restore.00000006.npz"))


def test_fsck_repair_spares_last_candidate(tmp_path):
    d = str(tmp_path)
    cs.save_sharded_checkpoint(d, _place(_host_state(1), 8), 5)
    tear_manifest(d, 5)
    assert ckpt_fsck.main([d, "--repair", "-q"]) == 1
    assert os.path.isdir(cs._step_dir(d, 5))


def test_sharded_drill_end_to_end(tmp_path):
    """The supervised sharded rollback (ResilientDriver(sharded=True,
    mesh=...)), its capsule replayed with ``sharded=True`` bitwise, and
    the rest of the drill."""
    res = run_sharded_smoke(str(tmp_path), device="cpu")
    assert res["sharded_smoke"] == "ok"
    assert res["rollback_step"] == 4
    assert res["replay_verdict"] == "reproduced"
    assert res["max_fetch_bytes"] < res["global_bytes"]


def test_fleet_cli_json_line(tmp_path, capsys):
    rc = fleet.main(["--lanes", "4", "--n", "16", "--n-lat", "6",
                     "--n-lon", "8", "--steps", "4", "--health-interval",
                     "2", "--restart-interval", "2", "--mesh", "2",
                     "--x64", "--device", "cpu", "--dir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["error"] is None
    assert out["mesh_devices"] == 2 and out["lanes_per_device"] == 2
    assert [r["steps"] for r in out["per_lane"]] == [4] * 4
    assert out["lanes_quarantined"] == 0
    assert cs.latest_sharded_step(str(tmp_path)) == 4


def test_sharded_crash_child_resumes_from_its_newest_step(tmp_path, capsys):
    """The kill drill's victim: a run of 10 steps saving every 5, then a
    resumed run to 20 starts at step 10 from the sharded checkpoint, and
    its checkpoints hold the closed-form trajectory bitwise."""
    from ibamr_tpu_torch.tools.fault_injection import (crash_state,
                                                       run_sharded_crash_child)

    d = str(tmp_path)
    run_sharded_crash_child(d, 10, 5, n_devices=4, device="cpu")
    run_sharded_crash_child(d, 20, 5, n_devices=4, device="cpu")
    out = capsys.readouterr().out.split()
    assert out[:2] == ["START", "0"] and "START" in out[2:]
    assert out[out.index("START", 2) + 1] == "10"
    got, step, man = cs.restore_sharded(d, _place(
        {"u": np.zeros(64), "k": np.int64(0)}, 2))
    assert step == 20 and man["mesh"]["n_shards"] == 4
    _equal(got, crash_state(20))
