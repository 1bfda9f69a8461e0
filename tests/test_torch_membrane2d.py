"""Port parity of the 2D slice: ``build_membrane_example``, midpoint
trajectories of the 2D membrane (centered and upwind convection, beams
on and off, target points), the diagnostics, the initial velocity from
an input file's grid functions, target forces, and the structure-file
reader and writer, in ibamr_tpu_torch against ibamr_tpu at f64 on the
CPU. Inputs come from a numpy seed or the committed ``input2d``. The
FFT backends differ, so after 10 steps X, U, u and p agree to 1e-10
relative; forces and grid functions are the same expressions and agree
to 1e-14 relative; structure tables read back equal."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators import ib as jib
from ibamr_tpu.integrators.ins import INSStaggeredIntegrator as JIns
from ibamr_tpu.io import structures as jstruct
from ibamr_tpu.models import membrane2d as jmem
from ibamr_tpu.ops import forces as jforces
from ibamr_tpu.utils import gridfunctions as jgf
from ibamr_tpu.utils.input_db import parse_input_file as j_parse_file
from ibamr_tpu.utils.input_db import parse_input_string as j_parse
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators import ib as tib
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator as TIns
from ibamr_tpu_torch.io import structures as tstruct
from ibamr_tpu_torch.models import membrane2d as tmem
from ibamr_tpu_torch.ops import forces as tforces
from ibamr_tpu_torch.utils import gridfunctions as tgf
from ibamr_tpu_torch.utils.input_db import parse_input_file as t_parse_file
from ibamr_tpu_torch.utils.input_db import parse_input_string as t_parse

ROOT = Path(__file__).resolve().parent.parent
INPUT2D = str(ROOT / "examples/IB/explicit/ex0/input2d")
RTOL = 1e-10
EXACT_RTOL = 1e-14
STEPS, DT = 10, 2e-3
U0_DB = """
VelocityInitialConditions {
   function_0 = "0.1*sin(2*PI*X_1) + (0.02 if X_0 < 0.5 else -0.01)"
   function_1 = "0.05*cos(2*PI*X_0)^2 - heaviside(X_1 - 0.7)*0.01"
}
"""


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                 1e-300))


def test_build_from_input2d_matches_reference():
    jinteg, js = jmem.build_membrane_example(input_db=j_parse_file(INPUT2D),
                                             dtype=jnp.float64)
    tinteg, ts = tmem.build_membrane_example(input_db=t_parse_file(INPUT2D),
                                             dtype=torch.float64,
                                             device="cpu")
    g, jg = tinteg.ins.grid, jinteg.ins.grid
    assert (g.n, g.x_lo, g.x_up) == (jg.n, jg.x_lo, jg.x_up) == (
        (64, 64), (0.0, 0.0), (1.0, 1.0))
    assert (tinteg.ins.rho, tinteg.ins.mu) == (jinteg.ins.rho,
                                               jinteg.ins.mu) == (1.0, 0.05)
    assert tinteg.ins.convective_op_type == "centered"
    assert tinteg.ib.kernel == jinteg.ib.kernel == "IB_4"
    assert tinteg.ib.fast is None and tinteg.scheme == "midpoint"
    np.testing.assert_array_equal(ts.X.numpy(), np.asarray(js.X))
    assert ts.X.shape == (128, 2) and ts.X.dtype == torch.float64
    for a, b in zip(jinteg.ib.specs.springs, tinteg.ib.specs.springs):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert tinteg.ib.specs.beams is None and tinteg.ib.specs.targets is None
    for a, b in zip((js.U, js.mask, js.ins.p, *js.ins.u),
                    (ts.U, ts.mask, ts.ins.p, *ts.ins.u)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert float(tib.polygon_area(ts.X)) == float(jib.polygon_area(js.X))


def _pair(convective, bend, targets, u0):
    """The same membrane, integrators and initial state in both packages
    (a 32x24 box of 1.0 x 0.75, a 48-marker ellipse)."""
    n, box = (32, 24), dict(x_lo=(0.0, 0.0), x_up=(1.0, 0.75))
    data = dict(num_markers=48, radius=0.2, center=(0.5, 0.375),
                stiffness=5.0, rest_length_factor=0.5, aspect=1.3,
                bend_rigidity=0.02 if bend else 0.0)
    jd = jmem.make_circle_membrane(**data)
    td = tmem.make_circle_membrane(**data)
    if targets:
        # tether two markers (one damped), and pin a third as an anchor
        for d in (jd, td):
            d.targets = np.array([[0, 50.0, 0.5], [24, 30.0, 0.0]])
            d.anchors = np.array([[12.0]])
            d.anchors_to_targets(80.0)
    jins = JIns(JGrid(n=n, **box), rho=1.2, mu=0.03,
                convective_op_type=convective, dtype=jnp.float64)
    tins = TIns(TGrid(n=n, **box), rho=1.2, mu=0.03,
                convective_op_type=convective, dtype=torch.float64,
                device="cpu")
    jinteg = jib.IBExplicitIntegrator(
        jins, jib.IBMethod(jd.force_specs(dtype=jnp.float64)))
    tinteg = tib.IBExplicitIntegrator(
        tins, tib.IBMethod(td.force_specs(dtype=torch.float64,
                                          device="cpu")))
    jfs = tfs = None
    if u0:
        jfs = jinteg.ins.initialize(u0=jgf.function_from_db(
            j_parse(U0_DB).get_database("VelocityInitialConditions"), 2))
        tfs = tinteg.ins.initialize(u0=tgf.function_from_db(
            t_parse(U0_DB).get_database("VelocityInitialConditions"), 2))
    mask = np.ones(48)
    mask[5] = 0.0
    js = jinteg.initialize(jd.vertices, ins_state=jfs, mask=mask)
    ts = tinteg.initialize(td.vertices, ins_state=tfs, mask=mask)
    return jinteg, js, tinteg, ts


@pytest.mark.parametrize("convective,bend,targets,u0", [
    ("centered", False, False, False), ("upwind", True, False, True),
    ("centered", True, True, False), ("upwind", False, True, True),
    ("none", False, False, True)])
def test_midpoint_trajectory_matches_reference(convective, bend, targets,
                                               u0):
    jinteg, js, tinteg, ts = _pair(convective, bend, targets, u0)
    for a, b in zip((js.X, js.mask, *js.ins.u), (ts.X, ts.mask, *ts.ins.u)):
        assert _rel(a, b) <= EXACT_RTOL
    np.testing.assert_allclose(
        tinteg.total_marker_force(ts).numpy(),
        np.asarray(jinteg.total_marker_force(js)), rtol=0,
        atol=EXACT_RTOL * float(np.max(np.abs(np.asarray(
            jinteg.ib.compute_force(js.X, js.U, 0.0))))))
    js = jax.jit(jib.advance_ib, static_argnums=(0, 2, 3))(jinteg, js, DT,
                                                           STEPS)
    ts = tib.advance_ib(tinteg, ts, DT, STEPS)
    assert int(ts.ins.k) == STEPS and abs(float(ts.ins.t) - STEPS * DT) \
        < 1e-15
    for a, b in ((js.X, ts.X), (js.U, ts.U), (js.ins.p, ts.ins.p),
                 *zip(js.ins.u, ts.ins.u)):
        assert _rel(a, b) <= RTOL
    assert abs(float(tib.polygon_area(ts.X)) - float(jib.polygon_area(js.X))) \
        <= RTOL * float(jib.polygon_area(js.X))
    F_ref = np.asarray(jinteg.total_marker_force(js))
    assert np.max(np.abs(tinteg.total_marker_force(ts).numpy() - F_ref)) \
        <= RTOL * float(np.max(np.abs(np.asarray(
            jinteg.ib.compute_force(js.X, js.U, 0.0)))))


def test_polygon_area_and_total_force_on_random_loops():
    rng = np.random.default_rng(4)
    for N in (3, 17, 200):
        X = rng.uniform(-1, 2, (N, 2))
        assert _rel(jib.polygon_area(jnp.asarray(X)),
                    tib.polygon_area(torch.tensor(X))) <= EXACT_RTOL
    theta = 2 * np.pi * np.arange(64) / 64
    circle = np.stack([0.3 * np.cos(theta), 0.3 * np.sin(theta)], axis=1)
    area = tib.polygon_area(torch.tensor(circle))
    assert area.dim() == 0
    assert abs(float(area) - 0.5 * 64 * 0.09 * np.sin(2 * np.pi / 64)) \
        < 1e-15


@pytest.mark.parametrize("how", ["vector", "components", "arrays",
                                 "constant"])
def test_initialize_u0_matches_reference(how):
    n, box = (12, 10), dict(x_lo=(0.0, -0.5), x_up=(1.0, 0.75))
    jins = JIns(JGrid(n=n, **box), dtype=jnp.float64)
    tins = TIns(TGrid(n=n, **box), dtype=torch.float64, device="cpu")
    db = U0_DB
    if how == "constant":
        db = U0_DB.replace('"0.1*sin', '"0.25 + 0*sin').replace(
            'function_1 = "0.05*cos(2*PI*X_0)^2 - heaviside(X_1 - 0.7)*0.01"',
            'function_1 = "sqrt(2)/3"')
    jf = jgf.function_from_db(j_parse(db).get_database(
        "VelocityInitialConditions"), 2)
    tf = tgf.function_from_db(t_parse(db).get_database(
        "VelocityInitialConditions"), 2)
    if how == "components":
        jf = [lambda c, t, d=d, f=jf: f(c, t)[d] for d in range(2)]
        tf = [lambda c, t, d=d, f=tf: f(c, t)[d] for d in range(2)]
    if how == "arrays":
        u = [np.random.default_rng(d).standard_normal(n) for d in range(2)]
        js = jins.initialize(u0_arrays=[jnp.asarray(c) for c in u])
        ts = tins.initialize(u0_arrays=[torch.tensor(c) for c in u])
    else:
        js, ts = jins.initialize(u0=jf), tins.initialize(u0=tf)
    for a, b in zip(js.u, ts.u):
        assert b.shape == n and b.dtype == torch.float64
        assert _rel(a, b) <= EXACT_RTOL
    if how == "constant":       # a 0-dim value broadcast to the grid
        assert bool((ts.u[1] == ts.u[1][0, 0]).all())
        assert abs(float(ts.u[1][0, 0]) - np.sqrt(2) / 3) <= 4e-16
    for a in (*ts.n_prev, ts.p):
        assert not bool(a.any())


def test_grid_function_expressions_match_reference():
    exprs = ("sin(2*PI*X_0)*cos(2*PI*X_1) + t", "X^2 + Y^3 - 1.5",
             "where(X_0 > 0.3, exp(-X_1), log(1 + X_0))",
             "(X_0 if X_0 > 0.5 and X_1 < 0.2 else -X_1) + abs(X_1)",
             "pow(X_0, 3) + max(X_0, X_1) - min(0.1, X_1) + atan2(X_1, 1)",
             "floor(4*X_0) % 3 + ceil(X_1) + sign(X_1 - 0.5)",
             "sqrt(X_0 + 1) * tanh(X_1) + heaviside(X_0 - 0.5)")
    rng = np.random.default_rng(5)
    x, y = rng.uniform(0, 1, (7, 1)), rng.uniform(0, 1, (1, 5))
    for expr in exprs:
        ref = jgf.CartGridFunction(expr, 2)((jnp.asarray(x), jnp.asarray(y)),
                                            t=0.25)
        got = tgf.CartGridFunction(expr, 2)((torch.tensor(x),
                                             torch.tensor(y)), t=0.25)
        assert _rel(ref, got) <= EXACT_RTOL, expr
    for bad in ("__import__('os')", "X_0.real", "lambda: 1", "X_3 + 1",
                "max(X_0, key=1)"):
        with pytest.raises((ValueError, SyntaxError)):
            tgf.CartGridFunction(bad, 2)


def _full_structure(mod):
    rng = np.random.default_rng(6)
    N = 20
    return mod.StructureData(
        name="s", vertices=rng.uniform(0, 1, (N, 3)),
        springs=np.column_stack([np.arange(N), (np.arange(N) + 1) % N,
                                 rng.uniform(1, 2, N), rng.uniform(0, .1, N),
                                 np.zeros(N)]),
        beams=np.column_stack([np.arange(N) % N, (np.arange(N) + 1) % N,
                               (np.arange(N) + 2) % N, rng.uniform(0, 1, N),
                               rng.standard_normal((N, 3)) * 0.01]),
        targets=np.column_stack([[1, 4], [10.0, 20.0], [0.5, 0.0]]),
        rods=np.column_stack([np.arange(5), np.arange(5) + 1,
                              rng.uniform(0, 1, (5, 10))]),
        anchors=np.array([[3.0], [7.0]]),
        masses=np.column_stack([[2, 5], [1.5, 2.5], [100.0, 0.0]]),
        sources=np.array([[0, 0.25]]),
        inst=np.array([[0, 0, 1], [1, 0, 0], [2, 1, 0]]))


TABLES = ("vertices", "springs", "beams", "targets", "rods", "anchors",
          "masses", "sources", "inst")


def test_structure_files_round_trip_between_packages(tmp_path):
    data = _full_structure(tstruct)
    tstruct.write_structure(str(tmp_path / "t"), data)
    jstruct.write_structure(str(tmp_path / "j"), _full_structure(jstruct))
    for ext in ("vertex", "spring", "beam", "target", "rod", "anchor",
                "mass", "source", "inst"):
        assert (tmp_path / f"t.{ext}").read_text() == \
            (tmp_path / f"j.{ext}").read_text()
    ref = jstruct.read_structure(str(tmp_path / "t"))
    got = tstruct.read_structure(str(tmp_path / "j"))
    assert got.name == "j" and got.dim == 3 and got.num_markers == 20
    for attr in TABLES:
        np.testing.assert_array_equal(getattr(got, attr), getattr(ref, attr))
        np.testing.assert_array_equal(getattr(got, attr),
                                      getattr(data, attr))


def test_structure_reader_rejects_what_the_reference_rejects(tmp_path):
    base = str(tmp_path / "s")
    with pytest.raises(FileNotFoundError):
        tstruct.read_structure(base)
    (tmp_path / "s.vertex").write_text("3\n0 0\n1 0  # c\n\n0 1\n")
    (tmp_path / "s.spring").write_text("1\n0 3 1.0 0.5\n")
    for mod in (jstruct, tstruct):
        with pytest.raises(ValueError, match="out of range"):
            mod.read_structure(base)
    (tmp_path / "s.spring").write_text("2\n0 1 1.0 0.5\n")
    for mod in (jstruct, tstruct):
        with pytest.raises(ValueError, match="declared 2"):
            mod.read_structure(base)
    (tmp_path / "s.spring").write_text("1\n0 1 1.0\n")
    for mod in (jstruct, tstruct):
        with pytest.raises(ValueError, match="columns"):
            mod.read_structure(base)


def test_target_forces_and_energy_match_reference():
    jd, td = _full_structure(jstruct), _full_structure(tstruct)
    for d in (jd, td):
        d.anchors_to_targets(500.0)
        d.anchors_to_targets(500.0)      # consumed: adds nothing more
    np.testing.assert_array_equal(td.targets, jd.targets)
    assert td.targets.shape == (4, 3) and td.anchors is None
    rng = np.random.default_rng(7)
    X = jd.vertices + 0.01 * rng.standard_normal(jd.vertices.shape)
    U = rng.standard_normal(X.shape)
    jspecs = jd.force_specs(dtype=jnp.float64)
    ref = jforces.compute_lagrangian_force(jnp.asarray(X), jnp.asarray(U),
                                           jspecs)
    scale = float(np.max(np.abs(np.asarray(ref))))
    for specs in (td.force_specs(dtype=torch.float64, device="cpu"),
                  convert.force_specs(jspecs, 20, device="cpu")):
        got = tforces.compute_lagrangian_force(torch.tensor(X),
                                               torch.tensor(U), specs)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=EXACT_RTOL * scale)
    made = tforces.make_targets([1, 4], [10.0, 20.0], X[[1, 4]],
                                dtype=torch.float64, device="cpu")
    assert not bool(made.damping.any()) and made.idx.dtype == torch.int64
    tspecs = td.force_specs(dtype=torch.float64, device="cpu")
    assert _rel(jforces.spring_energy(jnp.asarray(X), jspecs.springs),
                tforces.spring_energy(torch.tensor(X),
                                      tspecs.springs)) <= EXACT_RTOL
    # an index offset shifts every family, as in the reference
    jd.index_offset = td.index_offset = 5
    jo, to = jd.force_specs(dtype=jnp.float64), td.force_specs(
        dtype=torch.float64, device="cpu")
    for fam in ("springs", "beams", "targets"):
        for a, b in zip(getattr(jo, fam), getattr(to, fam)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert to.gather.shape[0] == 25
