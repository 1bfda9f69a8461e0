"""Port parity of the engine resolver and the ``packed`` / ``packed_bf16``
engines it names (``ibamr_tpu_torch/models/engine_resolver.py``,
``ibamr_tpu_torch/ops/interaction_packed.PackedInteraction``) against
``ibamr_tpu`` on the CPU.

The resolvers answer the same queries, environments and database files
with the same name (the platform passed explicitly to both); an entry
pinned to the JAX package's ``tpu`` or ``gpu`` never steers the port,
whose platform is its device's type. ``packed`` equals the reference's
``PackedInteraction`` to roundoff at f64 (1e-12 relative: the sum orders
differ); ``packed_bf16`` meets the reference suite's bf16 tolerance
(``tests/test_interaction_packed.py``: 8e-3 of the exact transfer, 2e-2
for adjointness). A build with no ``transfer_engine`` resolves as the
reference does, and the committed ``input3d`` runs unmodified through the
ex4 entry point."""

import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.models import engine_resolver as jres
from ibamr_tpu.models.shell3d import build_shell_example as jbuild
from ibamr_tpu.ops.interaction_packed import PackedInteraction as JPacked
from ibamr_tpu.ops.interaction_packed import suggest_chunks
from ibamr_tpu.utils.input_db import parse_input_file as j_parse_file
from ibamr_tpu.utils.input_db import parse_input_string as j_parse
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.models import engine_resolver as tres
from ibamr_tpu_torch.models.shell3d import build_shell_example as tbuild
from ibamr_tpu_torch.models.shell3d import construct_transfer_engine
from ibamr_tpu_torch.ops.cuda_interaction import PackedKernelInteraction
from ibamr_tpu_torch.ops.interaction_packed import (ENGINE_FALLBACKS,
                                                    fallback_chain)
from ibamr_tpu_torch.ops.interaction_packed import PackedInteraction as TPacked
from ibamr_tpu_torch.utils.input_db import parse_input_file as t_parse_file
from ibamr_tpu_torch.utils.input_db import parse_input_string as t_parse

ROOT = Path(__file__).resolve().parent.parent
SUPPORT = 2                 # IB_4 half-width
RTOL = 1e-12                # f64 transfers, other sum orders
STEP_RTOL = 1e-10           # f64 steps: the FFT backends differ too
BF16_TOL, BF16_ADJ_TOL = 8e-3, 2e-2


@pytest.fixture(autouse=True)
def _no_engine_env(monkeypatch):
    """No operator override or tuning database leaks in or out."""
    monkeypatch.delenv(tres.ENV_ENGINE, raising=False)
    monkeypatch.delenv(tres.ENV_TUNING_DB, raising=False)


def _both(*args, **kw):
    """The two resolvers' answers to one query; equal."""
    ref = jres.resolve_engine(*args, **kw)
    got = tres.resolve_engine(*args, **kw)
    assert got == ref
    return got


def _db(tmp_path, entries, name="tuning.json", **doc):
    path = tmp_path / name
    path.write_text(json.dumps({"schema": 1, "entries": entries, **doc}))
    return {tres.ENV_TUNING_DB: str(path)}


# -- the resolver --------------------------------------------------------------

@pytest.mark.parametrize("n,markers", [
    ((128, 128, 128), 100_000), ((128, 128, 128), 100), ((12, 12, 12),
                                                          100_000),
    ((8, 8, 8), 100_000), ((16, 16, 16), 4096), ((16, 16, 16), 4095),
    ((16, 24, 32), 5000), ((256, 256, 256), 99_856), ((64, 64, 64), 1024)])
def test_default_rule_promotion_band(n, markers):
    assert tres.default_rule(n, markers, SUPPORT) \
        == jres.default_rule(n, markers, SUPPORT)
    assert _both(n, markers, SUPPORT, {}, platform="cpu") \
        == tres.default_rule(n, markers, SUPPORT)
    # the committed inputs: input3d scatter, the north star packed
    assert tres.default_rule((64,) * 3, 32 * 32, SUPPORT) == "scatter"
    assert tres.default_rule((256,) * 3, 316 * 316, SUPPORT) == "packed"


def test_env_override_wins_and_validates():
    for env, want in (({tres.ENV_ENGINE: "packed3"}, "packed3"),
                      ({tres.ENV_ENGINE: " Hybrid_BF16 "}, "hybrid_bf16"),
                      ({tres.ENV_ENGINE: "auto"}, "scatter"),
                      ({tres.ENV_ENGINE: ""}, "scatter")):
        assert _both((8, 8, 8), 10, SUPPORT, env, platform="cpu") == want
    for mod in (jres, tres):
        with pytest.raises(ValueError, match="unknown transfer engine"):
            mod.resolve_engine((8, 8, 8), 10, SUPPORT,
                               env={mod.ENV_ENGINE: "packedd"})
    assert tres.RESOLVED_ENGINES == jres.RESOLVED_ENGINES
    assert "auto" not in tres.RESOLVED_ENGINES
    assert (tres.ENV_ENGINE, tres.ENV_TUNING_DB, tres.DB_DISABLE_VALUES) \
        == (jres.ENV_ENGINE, jres.ENV_TUNING_DB, jres.DB_DISABLE_VALUES)


def test_env_variables_are_read(monkeypatch):
    monkeypatch.setenv(tres.ENV_ENGINE, "pallas")
    assert _both((8, 8, 8), 10, SUPPORT, platform="cpu") == "pallas"


def test_tuning_db_most_specific_wins(tmp_path):
    env = _db(tmp_path, [
        {"engine": "packed3", "n_cells": 256},
        {"engine": "mxu", "markers_min": 50, "markers_max": 500},
        {"engine": "packed3_bf16", "n_cells": 64, "markers_min": 50,
         "markers_max": 500},
        {"engine": "pallas", "n": [32, 32, 64]},
    ])
    for n, markers, want in (((256,) * 3, 10_000, "packed3"),
                             ((64,) * 3, 100, "packed3_bf16"),
                             ((32,) * 3, 100, "mxu"),
                             ((64,) * 3, 10, "scatter"),
                             ((32, 32, 64), 10, "pallas"),
                             ((32, 32, 64), 100, "mxu")):
        assert _both(n, markers, SUPPORT, env, platform="cpu") == want
    env[tres.ENV_ENGINE] = "pallas"
    assert _both((256,) * 3, 10_000, SUPPORT, env, platform="cpu") \
        == "pallas"
    for entry in ({"engine": "a", "n": [1, 2, 3]}, {"engine": "b"},
                  {"engine": "c", "n_cells": 8, "platform": "cpu",
                   "chunk_length": 4}):
        assert tres.entry_specificity(entry) \
            == jres.entry_specificity(entry)


def test_tuning_db_equal_specificity_keeps_file_order(tmp_path):
    env = _db(tmp_path, [
        {"engine": "mxu", "markers_min": 50, "markers_max": 500},
        {"engine": "packed3", "markers_min": 40, "markers_max": 600}])
    assert _both((64,) * 3, 100, SUPPORT, env, platform="cpu") == "mxu"


def test_tuning_db_chunk_length_pins(tmp_path):
    env = _db(tmp_path, [{"engine": "packed_bf16", "chunk_length": 4}])
    assert _both((64,) * 3, 100, SUPPORT, env, platform="cpu") == "scatter"
    assert _both((64,) * 3, 100, SUPPORT, env, platform="cpu",
                 chunk_length=4) == "packed_bf16"
    assert _both((64,) * 3, 100, SUPPORT, env, platform="cpu",
                 chunk_length=8) == "scatter"


@pytest.mark.parametrize("platform", ["cpu", "cuda", "tpu", "gpu"])
def test_tuning_db_platform_and_provenance_gates(tmp_path, platform):
    env = _db(tmp_path, [
        {"engine": "packed3", "platform": "tpu"},
        {"engine": "mxu", "markers_min": 50, "markers_max": 500,
         "provenance": {"platform": "tpu", "timestamp": "2026-08-06"}},
        {"engine": "pallas", "n_cells": 32,
         "provenance": {"platform": "cuda"}},
        {"engine": "packed_bf16", "n_cells": 16, "platform": "gpu"},
    ])
    for n, markers in (((64,) * 3, 100), ((64,) * 3, 10), ((32,) * 3, 10),
                       ((16,) * 3, 10)):
        _both(n, markers, SUPPORT, env, platform=platform)
    got = {n: tres.resolve_engine((n,) * 3, 10, SUPPORT, env,
                                  platform=platform) for n in (64, 32, 16)}
    want = {"cpu": ("scatter", "scatter", "scatter"),
            "cuda": ("scatter", "pallas", "scatter"),
            "tpu": ("packed3", "packed3", "packed3"),
            "gpu": ("scatter", "scatter", "packed_bf16")}[platform]
    assert tuple(got[n] for n in (64, 32, 16)) == want


def test_tpu_and_gpu_entries_never_steer_the_port(tmp_path):
    # the port's platform is its device's type, never the JAX backend
    assert tres.current_platform() == "cuda"
    assert tres.current_platform("cpu") == "cpu"
    assert tres.current_platform(torch.device("cuda", 0)) == "cuda"
    pinned = [{"engine": eng, "platform": p, "provenance": {"platform": p}}
              for p, eng in (("tpu", "packed_bf16"), ("gpu", "hybrid_bf16"))]
    env = _db(tmp_path, pinned + [
        {"engine": "mxu", "provenance": {"platform": "gpu"}},
        {"engine": "packed3", "provenance": {"platform": "tpu"}}])
    for platform in (None, "cuda", "cpu"):
        for n, markers in (((256,) * 3, 99_856), ((64,) * 3, 1024)):
            assert tres.resolve_engine(n, markers, SUPPORT, env,
                                       platform=platform) \
                == tres.default_rule(n, markers, SUPPORT)
    # the committed database: every entry is measured on and pinned to tpu
    committed = {tres.ENV_TUNING_DB: str(ROOT / "TUNING_DB.json")}
    entries = tres.load_tuning_db(committed[tres.ENV_TUNING_DB])
    assert entries and all(e["provenance"]["platform"] == "tpu"
                           for e in entries)
    assert jres.resolve_engine((256,) * 3, 99_856, SUPPORT, committed,
                               platform="tpu") != "packed"
    for platform in (None, "cuda", "cpu"):
        assert tres.resolve_engine((256,) * 3, 99_856, SUPPORT, committed,
                                   platform=platform) == "packed"


def test_port_default_db_is_its_own_file(tmp_path, monkeypatch):
    assert Path(tres.DEFAULT_DB_PATH) == ROOT / "ibamr_tpu_torch" \
        / "TUNING_DB.json"
    assert not os.path.exists(tres.DEFAULT_DB_PATH)
    assert tres.resolve_engine((64,) * 3, 100, SUPPORT) == "scatter"
    path = tmp_path / "TUNING_DB.json"
    path.write_text(json.dumps({"entries": [
        {"engine": "pallas", "provenance": {"platform": "cuda"}}]}))
    monkeypatch.setattr(tres, "DEFAULT_DB_PATH", str(path))
    assert tres.resolve_engine((64,) * 3, 100, SUPPORT) == "pallas"
    assert tres.resolve_engine((64,) * 3, 100, SUPPORT,
                               platform="cpu") == "scatter"
    for off in tres.DB_DISABLE_VALUES + ("OFF",):
        assert tres.resolve_engine((64,) * 3, 100, SUPPORT,
                                   {tres.ENV_TUNING_DB: off}) == "scatter"


@pytest.mark.parametrize("off", ["none", "off", "0", "None"])
def test_tuning_db_disable_and_spectral_dtype_match(tmp_path, off):
    env = _db(tmp_path, [{"engine": "mxu", "markers_min": 50,
                          "markers_max": 500, "spectral_dtype": "bf16"}])
    assert _both((64,) * 3, 100, SUPPORT, env, platform="cpu") == "scatter"
    assert _both((64,) * 3, 100, SUPPORT, env, platform="cpu",
                 spectral_dtype="bf16") == "mxu"
    assert _both((64,) * 3, 100, SUPPORT, env, platform="cpu",
                 spectral_dtype=" BF16") == "mxu"
    assert _both((64,) * 3, 100, SUPPORT, {tres.ENV_TUNING_DB: off},
                 platform="cpu", spectral_dtype="bf16") == "scatter"
    for v in (None, "", "f32", " F32 ", "bf16"):
        assert tres.normalize_spectral_dtype(v) \
            == jres.normalize_spectral_dtype(v)


def test_tuning_db_unknown_schema_rejected(tmp_path):
    path = tmp_path / "tuning.json"
    path.write_text(json.dumps({"schema": 99, "entries": []}))
    for mod in (jres, tres):
        with pytest.raises(ValueError, match="schema"):
            mod.load_tuning_db(str(path))
    legacy = tmp_path / "legacy.json"
    legacy.write_text(json.dumps({"entries": [{"engine": "mxu"}]}))
    assert tres.load_tuning_db(str(legacy)) \
        == jres.load_tuning_db(str(legacy)) == [{"engine": "mxu"}]


def test_malformed_tuning_db_raises(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"winners": []}))
    typo = tmp_path / "typo.json"
    typo.write_text(json.dumps({"entries": [{"engine": "warp9"}]}))
    junk = tmp_path / "junk.json"
    junk.write_text(json.dumps({"entries": ["packed"]}))
    for mod in (jres, tres):
        with pytest.raises(ValueError, match="entries"):
            mod.load_tuning_db(str(bad))
        with pytest.raises(ValueError):
            mod.resolve_engine((64,) * 3, 10, SUPPORT,
                               env={mod.ENV_TUNING_DB: str(bad)})
        with pytest.raises(ValueError, match="unknown transfer engine"):
            mod.resolve_engine((64,) * 3, 10, SUPPORT,
                               env={mod.ENV_TUNING_DB: str(typo)},
                               platform="cpu")
        with pytest.raises(ValueError, match="not an object"):
            mod.resolve_engine((64,) * 3, 10, SUPPORT,
                               env={mod.ENV_TUNING_DB: str(junk)},
                               platform="cpu")


def test_engine_name_helpers_match_reference():
    from ibamr_tpu.ops import interaction_packed as jip
    from ibamr_tpu_torch.ops import interaction_packed as tip

    assert ENGINE_FALLBACKS == jip.ENGINE_FALLBACKS
    for name in (True, False, None, "scatter", "PACKED", "pallas_packed",
                 "hybrid_bf16", "mxu_bf16"):
        assert tip.normalize_engine_name(name) \
            == jip.normalize_engine_name(name)
        assert fallback_chain(name) == jip.fallback_chain(name)
    with pytest.raises(KeyError):
        fallback_chain("warp9")


# -- the packed engines --------------------------------------------------------

def _grids(n):
    box = dict(x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    return JGrid(n=n, **box), TGrid(n=n, **box)


def _engines(n, X, chunk, nchunks=None, **kw):
    jg, tg = _grids(n)
    if nchunks is None:
        nchunks = suggest_chunks(jg, X, tile=8, chunk=chunk)
    return (JPacked(jg, tile=8, chunk=chunk, nchunks=nchunks, **kw),
            TPacked(tg, tile=8, chunk=chunk, nchunks=nchunks, device="cpu",
                    **kw))


def _rel(ref, got):
    ref = np.asarray(ref)
    return float(np.max(np.abs(np.asarray(got) - ref))
                 / max(np.max(np.abs(ref)), 1e-300))


def _check_transfers(je, te, X, F, u, weights=None, rtol=RTOL):
    """Both engines' spread and interp of every component, each at its
    own centering, agree to ``rtol`` of the reference's magnitude."""
    w = None if weights is None else jnp.asarray(weights)
    tw = None if weights is None else torch.tensor(weights)
    jX, tX = jnp.asarray(X), torch.tensor(X)
    jspread = jax.jit(lambda F, X, w: je.spread_vel(F, X, weights=w))
    for a, b in zip(jspread(jnp.asarray(F), jX, w),
                    te.spread_vel(torch.tensor(F), tX, weights=tw)):
        assert b.shape == a.shape and b.dtype == torch.float64
        assert _rel(a, b) < rtol
    jinterp = jax.jit(lambda u, X, w: je.interpolate_vel(u, X, weights=w))
    assert _rel(jinterp(tuple(map(jnp.asarray, u)), jX, w),
                te.interpolate_vel(tuple(map(torch.tensor, u)), tX,
                                   weights=tw)) < rtol


def _random(seed, N, n, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(lo, hi, (N, 3))
    F = rng.standard_normal((N, 3))
    u = [rng.standard_normal(n) for _ in range(3)]
    return X, F, u, rng


@pytest.mark.parametrize("n", [(16, 16, 16), (32, 32, 24), (16, 24, 32)])
def test_packed_matches_reference_random_markers(n):
    X, F, u, rng = _random(0, 300, n)
    mask = (rng.uniform(size=300) > 0.1).astype(np.float64)
    je, te = _engines(n, X, chunk=16)
    _check_transfers(je, te, X, F, u, weights=mask)
    jb = je.buckets(jnp.asarray(X))
    tb = te.buckets(torch.tensor(X))
    assert not tb.any_overflow
    np.testing.assert_array_equal(tb.tile_of_chunk.numpy(),
                                  np.asarray(jb.tile_of_chunk))


def test_packed_hot_tile_takes_many_chunks_no_overflow():
    n = (32, 32, 16)
    X, F, u, _ = _random(2, 400, n)
    X[:, :2] = 0.1 + 0.05 * X[:, :2]          # one (x, y) tile
    je, te = _engines(n, X, chunk=16, nchunks=40)
    b = te.buckets(torch.tensor(X))
    assert not b.any_overflow
    used = (b.wb > 0).sum(1)
    assert int(used.sum()) == 400 and int((used > 0).sum()) == 25
    assert len(set(b.tile_of_chunk[used > 0].tolist())) == 1
    _check_transfers(je, te, X, F, u)


def test_packed_chunk_capacity_overflow_exact():
    from ibamr_tpu_torch.ops import interaction

    n = (32, 32, 16)
    X, F, u, _ = _random(3, 400, n)
    for nchunks, ocap in ((6, None), (6, 64)):
        je, te = _engines(n, X, chunk=8, nchunks=nchunks, overflow_cap=ocap)
        b = te.buckets(torch.tensor(X))
        assert b.any_overflow and b.exceeded == (ocap is not None)
        _check_transfers(je, te, X, F, u)
        # exact against the port's scatter oracle too
        tX, tF = torch.tensor(X), torch.tensor(F)
        for a, c in zip(interaction.spread_vel(tF, te.grid, tX),
                        te.spread_vel(tF, tX)):
            assert _rel(a.numpy(), c) < RTOL


def test_packed_adjointness():
    n = (16, 16, 16)
    X, F, u, _ = _random(4, 150, n)
    _, te = _engines(n, X, chunk=32, nchunks=16)
    tX, tF = torch.tensor(X), torch.tensor(F)
    tu = tuple(map(torch.tensor, u))
    b = te.buckets(tX)
    f = te.spread_vel(tF, tX, b=b)
    U = te.interpolate_vel(tu, tX, b=b)
    h3 = float(np.prod(te.grid.dx))
    lhs = sum(float(torch.sum(a * c)) for a, c in zip(f, tu)) * h3
    rhs = float(torch.sum(tF * U))
    assert abs(lhs - rhs) < 1e-12 * (abs(lhs) + abs(rhs))


def test_packed_refresh_matches_reference():
    n = (32, 32, 16)
    X, F, u, _ = _random(6, 500, n, 0.2, 0.8)
    je, te = _engines(n, X, chunk=32)
    jb, tb = je.buckets(jnp.asarray(X)), te.buckets(torch.tensor(X))
    Xh = X + 1e-3
    jb2, jhit = je.refresh(jb, jnp.asarray(Xh))
    tb2, thit = te.refresh(tb, torch.tensor(Xh))
    assert thit is bool(jhit) is True
    np.testing.assert_array_equal(tb2.Xb.numpy(), np.asarray(jb2.Xb))


def test_packed_bf16_within_reference_tolerance():
    n = (32, 32, 32)
    rng = np.random.default_rng(5)
    N = 3000
    X = (0.15 + 0.7 * rng.random((N, 3))).astype(np.float32)
    F = rng.standard_normal((N, 3)).astype(np.float32)
    u = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    _, tg = _grids(n)
    exact = TPacked(tg, tile=8, chunk=128, nchunks=64, device="cpu")
    comp = TPacked(tg, tile=8, chunk=128, nchunks=64,
                   compute_dtype=torch.bfloat16, device="cpu")
    jg, _ = _grids(n)
    jcomp = JPacked(jg, tile=8, chunk=128, nchunks=64,
                    compute_dtype=jnp.bfloat16)
    tX, tF = torch.tensor(X), torch.tensor(F)
    tu = tuple(map(torch.tensor, u))
    f0, f1 = exact.spread_vel(tF, tX), comp.spread_vel(tF, tX)
    jf = jcomp.spread_vel(jnp.asarray(F), jnp.asarray(X))
    scale = max(float(c.abs().max()) for c in f0)
    assert all(c.dtype == torch.float32 for c in f1)
    assert max(float((a - b).abs().max()) for a, b in zip(f0, f1)) \
        < BF16_TOL * scale
    # the reference's bf16 engine rounds the same operands the same way
    assert max(float(np.max(np.abs(b.numpy() - np.asarray(a))))
               for a, b in zip(jf, f1)) < BF16_TOL * scale
    U0, U1 = exact.interpolate_vel(tu, tX), comp.interpolate_vel(tu, tX)
    uscale = float(U0.abs().max())
    assert float((U0 - U1).abs().max()) < BF16_TOL * uscale
    jU = jcomp.interpolate_vel(tuple(map(jnp.asarray, u)), jnp.asarray(X))
    assert float(np.max(np.abs(U1.numpy() - np.asarray(jU)))) \
        < BF16_TOL * uscale
    lhs = sum(float(torch.sum(a * b)) for a, b in zip(f1, tu))
    rhs = float(torch.sum(tF * U1)) / float(np.prod(tg.dx))
    assert abs(lhs - rhs) < BF16_ADJ_TOL * max(abs(lhs), abs(rhs), 1e-6)


def test_construct_packed_engines_with_reference_sizing():
    from ibamr_tpu.models.shell3d import construct_transfer_engine as jcons
    from ibamr_tpu_torch.models.shell3d import PORTED_ENGINES

    assert {"packed", "packed_bf16"} <= set(PORTED_ENGINES)
    n = (32, 32, 32)
    X, _, _, _ = _random(7, 5000, n, 0.2, 0.8)
    jg, tg = _grids(n)
    for name in ("packed", "packed_bf16"):
        ref = jcons(name, jg, X, "IB_4")
        got = construct_transfer_engine(name, tg, X, "IB_4", device="cpu")
        assert type(got) is TPacked
        assert got.nchunks == ref.nchunks
        assert got.overflow_cap == ref.overflow_cap == 2048
        assert tuple(got.geom) == tuple(ref.geom)
        assert (got.compute_dtype is None) == (ref.compute_dtype is None)
    # a pallas_packed request is never answered by the XLA engine
    got = construct_transfer_engine("pallas_packed", tg, X, "IB_4",
                                    device="cpu")
    assert type(got) is PackedKernelInteraction
    with pytest.raises(NotImplementedError, match="3D"):
        TPacked(TGrid(n=(16, 16), x_lo=(0.0,) * 2, x_up=(1.0,) * 2),
                device="cpu")


# -- auto resolution in the builder -------------------------------------------

SHELL_INPUT = """
CartesianGeometry { n_cells = 32, 32, 32
                    x_lo = 0.0, 0.0, 0.0   x_up = 1.0, 1.0, 1.0 }
INSStaggeredHierarchyIntegrator { rho = 1.0  mu = 0.05 }
IBMethod { delta_fcn = "IB_4"  %s  engine_fallback = FALSE }
Shell { n_lat = 64  n_lon = 64  radius = 0.25  aspect = 1.2
        stiffness = 1.0  rest_length_factor = 0.75 }
"""


@pytest.mark.parametrize("knob", ["", 'transfer_engine = "auto"'])
def test_auto_build_resolves_packed_and_steps_like_reference(knob):
    jinteg, js = jbuild(input_db=j_parse(SHELL_INPUT % knob),
                        dtype=jnp.float64)
    tinteg, _ = tbuild(input_db=t_parse(SHELL_INPUT % knob),
                       dtype=torch.float64, device="cpu")
    assert js.X.shape[0] == 4096
    assert tinteg.ib.engine_name == jinteg.ib.engine_name == "packed"
    assert type(tinteg.ib.fast) is TPacked
    assert tinteg.ib.fast.nchunks == jinteg.ib.fast.nchunks
    ts = convert.ib_state(js, device="cpu")
    jstep = jax.jit(jinteg.step_with_stats, static_argnums=1)
    for _ in range(2):
        js, jstats = jstep(js, 2e-3)
        ts, tstats = tinteg.step_with_stats(ts, 2e-3)
        assert tstats["refresh_hit"] is bool(jstats["refresh_hit"])
    assert _rel(js.X, ts.X) < STEP_RTOL
    for a, b in zip(js.ins.u, ts.ins.u):
        assert _rel(a, b) < STEP_RTOL
    assert _rel(js.ins.p, ts.ins.p) < STEP_RTOL


def test_auto_build_follows_env_and_database(tmp_path, monkeypatch):
    shell = dict(n_cells=16, n_lat=8, n_lon=8, device="cpu")
    integ, _ = tbuild(**shell)
    assert integ.ib.engine_name == "scatter" and integ.ib.fast is None
    monkeypatch.setenv(tres.ENV_ENGINE, "pallas_packed")
    integ, _ = tbuild(**shell)
    assert integ.ib.engine_name == "pallas_packed"
    assert type(integ.ib.fast) is PackedKernelInteraction
    # an explicit engine outranks the override, as in the reference
    integ, _ = tbuild(use_fast_interaction="pallas", **shell)
    assert integ.ib.engine_name == "pallas"
    # engines still unported raise, from the override or from a database
    for name in ("mxu_bf16", "mxu", "packed3"):
        monkeypatch.setenv(tres.ENV_ENGINE, name)
        with pytest.raises(NotImplementedError, match="not ported"):
            tbuild(**shell)
    monkeypatch.delenv(tres.ENV_ENGINE)
    env = _db(tmp_path, [{"engine": "packed3_bf16",
                          "provenance": {"platform": "cpu"}}])
    monkeypatch.setenv(tres.ENV_TUNING_DB, env[tres.ENV_TUNING_DB])
    with pytest.raises(NotImplementedError, match="not ported"):
        tbuild(**shell)
    # a cuda-measured entry does not steer a CPU build
    env = _db(tmp_path, [{"engine": "pallas",
                          "provenance": {"platform": "cuda"}}], "gpu.json")
    monkeypatch.setenv(tres.ENV_TUNING_DB, env[tres.ENV_TUNING_DB])
    integ, _ = tbuild(**shell)
    assert integ.ib.engine_name == "scatter"


def test_committed_input3d_runs_unmodified_on_ex4(tmp_path, monkeypatch):
    """``examples/IB/explicit/ex4/input3d`` (no ``transfer_engine``) cut to
    16^3 and an 8x10 shell, through the port's entry point: it resolves
    ``scatter`` as the reference does and reaches the reference's state
    (f32, 1e-5 relative)."""
    from ibamr_tpu_torch.examples import ib_explicit_ex4

    def cut(parse, out):
        db = parse(str(ROOT / "examples/IB/explicit/ex4/input3d"))
        assert "transfer_engine" not in db.get_database("IBMethod").keys()
        main = db.get_database("Main")
        for key, val in (("log_file", str(out / "metrics.jsonl")),
                         ("viz_dirname", str(out / "viz")),
                         ("restart_dirname", str(out / "restart")),
                         ("viz_dump_interval", 2), ("restart_interval", 3)):
            main.put(key, val)
        db.get_database("CartesianGeometry").put("n_cells", [16, 16, 16])
        ins = db.get_database("INSStaggeredHierarchyIntegrator")
        ins.put("dt", 1e-3)
        ins.put("num_steps", 4)
        db.get_database("Shell").put("n_lat", 8)
        db.get_database("Shell").put("n_lon", 10)
        return db

    built = []
    real_build = ib_explicit_ex4.build_shell_example

    def spy(*args, **kwargs):
        integ, state = real_build(*args, **kwargs)
        built.append(integ)
        return integ, state

    monkeypatch.setattr(ib_explicit_ex4, "build_shell_example", spy)
    ts = ib_explicit_ex4.run(cut(t_parse_file, tmp_path / "port"),
                             device="cpu")
    assert built[0].ib.engine_name == "scatter" and built[0].ib.fast is None
    assert int(ts.ins.k) == 4
    assert [json.loads(ln)["step"] for ln in (
        tmp_path / "port" / "metrics.jsonl").read_text().splitlines()] \
        == [2, 3, 4]
    jinteg, js = jbuild(input_db=cut(j_parse_file, tmp_path / "jax"),
                        dtype=jnp.float32)
    assert jinteg.ib.engine_name == "scatter"
    jstep = jax.jit(lambda s: jinteg.step(s, 1e-3))
    for _ in range(4):
        js = jstep(js)
    assert _rel(js.X, ts.X) < 1e-5
    for a, b in zip(js.ins.u, ts.ins.u):
        assert _rel(a, b) < 1e-5
