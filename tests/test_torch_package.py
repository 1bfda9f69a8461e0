"""The port package's boundaries: ``ibamr_tpu_torch`` and ``chip_smoke.py``
load neither JAX nor the JAX package (``ibamr_tpu``, whose name is a
prefix of the port's), the entry points default to the GPU and raise
without one instead of carrying on on the CPU, and the kernels refuse
to build without a CUDA compiler."""

import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import ibamr_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "ibamr_tpu_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ibamr_tpu")


def _port_modules():
    """Every module of the port, ``ibamr_tpu_torch.physics`` included (a
    directory without ``__init__.py``, as in the JAX package, which
    ``pkgutil`` does not descend into)."""
    mods = {m.name for m in pkgutil.walk_packages(
        ibamr_tpu_torch.__path__, "ibamr_tpu_torch.")}
    mods |= {m.name for m in pkgutil.iter_modules(
        [str(PKG / "physics")], "ibamr_tpu_torch.physics.")}
    return sorted(mods)


def test_forbidden_name_check_tells_the_prefix_apart():
    assert _forbidden("ibamr_tpu") and _forbidden("ibamr_tpu.ops.delta")
    assert _forbidden("jax.numpy") and _forbidden("jax")
    assert not _forbidden("ibamr_tpu_torch")
    assert not _forbidden("ibamr_tpu_torch.ops.delta")


def test_fresh_import_loads_neither_jax_nor_the_jax_package():
    mods = _port_modules()
    assert "ibamr_tpu_torch.ops.cuda_interaction" in mods
    assert {"ibamr_tpu_torch.amr", "ibamr_tpu_torch.amr_dynamic",
            "ibamr_tpu_torch.amr_ins", "ibamr_tpu_torch.ops.godunov",
            "ibamr_tpu_torch.ops.sources",
            "ibamr_tpu_torch.integrators.adv_diff",
            "ibamr_tpu_torch.examples.adv_diff_ex0",
            "ibamr_tpu_torch.examples.ib_explicit_ex0_amr",
            "ibamr_tpu_torch.examples.ib_explicit_ex4_amr",
            "ibamr_tpu_torch.solvers.fac", "ibamr_tpu_torch.amr_multilevel",
            "ibamr_tpu_torch.amr_ins_multilevel",
            "ibamr_tpu_torch.amr_multibox", "ibamr_tpu_torch.integrators.imp",
            "ibamr_tpu_torch.integrators.ib_implicit",
            "ibamr_tpu_torch.ops.rods", "ibamr_tpu_torch.integrators.gib",
            "ibamr_tpu_torch.integrators.penalty_ib",
            "ibamr_tpu_torch.instruments",
            "ibamr_tpu_torch.physics.level_set",
            "ibamr_tpu_torch.physics.brinkman",
            "ibamr_tpu_torch.physics.waves",
            "ibamr_tpu_torch.physics.turbulence",
            "ibamr_tpu_torch.physics.complex_fluids",
            "ibamr_tpu_torch.integrators.ins_vc",
            "ibamr_tpu_torch.integrators.ins_collocated",
            "ibamr_tpu_torch.ops.stochastic",
            "ibamr_tpu_torch.examples.multiphase_dam_break",
            "ibamr_tpu_torch.examples.multiphase_falling_drop",
            "ibamr_tpu_torch.obs", "ibamr_tpu_torch.obs.bus",
            "ibamr_tpu_torch.obs.export", "ibamr_tpu_torch.obs.merge",
            "ibamr_tpu_torch.utils.lanes", "ibamr_tpu_torch.utils.health",
            "ibamr_tpu_torch.utils.flight_recorder",
            "ibamr_tpu_torch.utils.watchdog",
            "ibamr_tpu_torch.utils.supervisor", "ibamr_tpu_torch.entry",
            "ibamr_tpu_torch.tools.fault_injection",
            "ibamr_tpu_torch.tools.replay"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "ibamr_tpu_torch" in loaded and "chip_smoke" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_sources_import_neither_jax_nor_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        tree = ast.parse(f.read_text(), str(f))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (f, names)


def test_gpu_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    from ibamr_tpu_torch import resolve_device
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator
    from ibamr_tpu_torch.examples import ib_explicit_ex4
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.ops.cuda_interaction import (PackedKernelInteraction,
                                                      TileKernelInteraction)
    from ibamr_tpu_torch.ops.interaction_packed import PackedInteraction
    from ibamr_tpu_torch.utils.input_db import parse_input_file

    from ibamr_tpu_torch.bc import DomainBC
    from ibamr_tpu_torch.examples import (ib_explicit_cylinder2d,
                                          navier_stokes_cavity2d,
                                          navier_stokes_channel2d)
    from ibamr_tpu_torch.integrators.ins_open import INSOpenIntegrator
    from ibamr_tpu_torch.integrators.ins_walls import WallOps
    from ibamr_tpu_torch.solvers.fastdiag import FastDiagSolver
    from ibamr_tpu_torch.solvers.multigrid import PoissonMultigrid
    from ibamr_tpu_torch.solvers.spectral_plan import gaussian_filter_symbol
    from ibamr_tpu_torch.solvers.stokes import (StaggeredStokesSolver,
                                                channel_bc)

    grid = StaggeredGrid(n=(16,) * 3, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    g2 = StaggeredGrid(n=(8, 8), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    db = parse_input_file(str(ROOT / "examples/IB/explicit/ex4/input3d"))
    db.get_database("IBMethod").put("transfer_engine", "pallas")
    drivers = [(m, parse_input_file(str(ROOT / "examples" / ex / "input2d")))
               for m, ex in ((navier_stokes_cavity2d,
                              "navier_stokes/cavity2d"),
                             (navier_stokes_channel2d,
                              "navier_stokes/channel2d"),
                             (ib_explicit_cylinder2d,
                              "IB/explicit/cylinder2d"))]
    new_calls = [
        lambda: INSStaggeredIntegrator(g2, wall_axes=(True, True)),
        lambda: INSStaggeredIntegrator(g2, convective_op_type="ppm"),
        lambda: WallOps(g2, (True, False)),
        lambda: FastDiagSolver(g2, DomainBC.periodic(2), ("cc", "cc")),
        lambda: PoissonMultigrid((8, 8), DomainBC.periodic(2), (0.1, 0.1)),
        lambda: StaggeredStokesSolver((8, 8), (0.1, 0.1), channel_bc(2),
                                      alpha=1.0, mu=0.1),
        lambda: INSOpenIntegrator((8, 8), (0.1, 0.1), channel_bc(2),
                                  mu=0.1, dt=0.01),
        lambda: gaussian_filter_symbol((8, 8), (0.1, 0.1), 0.2),
    ] + [lambda m=m, d=d: m.build(d) for m, d in drivers] \
        + [lambda m=m, d=d: m.run(d) for m, d in drivers]
    new_calls += _structure_calls() + _transport_calls() \
        + _hierarchy_calls() + _structure_model_calls() + _multiphase_calls() \
        + _resilience_calls()
    for call in new_calls + [lambda: resolve_device(),
                 lambda: build_shell_example(n_cells=16, n_lat=8, n_lon=8),
                 lambda: build_shell_example(
                     n_cells=16, n_lat=8, n_lon=8,
                     use_fast_interaction="scatter"),
                 lambda: build_shell_example(input_db=db),
                 lambda: INSStaggeredIntegrator(grid),
                 lambda: PackedKernelInteraction(grid),
                 lambda: TileKernelInteraction(grid),
                 lambda: PackedInteraction(grid),
                 lambda: ib_explicit_ex4.run(db)]:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def _resilience_calls():
    """The entry point and the resilience drills and replay rebuilds,
    each called without ``device``."""
    from ibamr_tpu_torch.entry import entry
    from ibamr_tpu_torch.tools import fault_injection as fi
    from ibamr_tpu_torch.tools.replay import rebuild

    spec = {"kind": "ins", "grid": {"n": [8, 8], "x_lo": [0.0, 0.0],
                                    "x_up": [1.0, 1.0]},
            "rho": 1.0, "mu": 0.05, "convective_op_type": "centered",
            "dtype": "float32", "wall_axes": None, "spectral_dtype": "f32"}
    return [entry, fi.run_smoke, fi.run_silent_smoke, fi.run_replay_smoke,
            fi.run_fleet_smoke, fi._tg16_setup,
            lambda: rebuild({"fingerprint": {"integrator": spec}})]


def _structure_calls():
    """The structure models' entry points (IBFE, CIB, ConstraintIB and
    their drivers), each called without ``device``."""
    import numpy as np

    from ibamr_tpu_torch.examples import (cib_ex0, cib_oscillating_cylinder,
                                          constraint_ib_eel2d,
                                          ib_explicit_filament2d,
                                          ibfe_explicit_beam2d,
                                          ibfe_explicit_ex0)
    from ibamr_tpu_torch.fe import fem, mesh, surface
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators import cib, constraint_ib, ibfe
    from ibamr_tpu_torch.models.fe_disc2d import build_fe_disc_example
    from ibamr_tpu_torch.utils.input_db import parse_input_file

    disc = mesh.disc_mesh(n_rings=2)
    sph = surface.sphere_surface_mesh(n_subdiv=1)
    g2 = StaggeredGrid(n=(8, 8), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    bodies = cib.RigidBodies(body_id=torch.zeros(4, dtype=torch.int64),
                             n_bodies=1)
    W = fem.neo_hookean(1.0, 1.0)
    calls = [
        lambda: fem.build_assembly(disc),
        lambda: fem.build_transfer_assembly(disc, 1),
        lambda: surface.build_surface_assembly(sph),
        lambda: ibfe.IBFEMethod(disc, W),
        lambda: ibfe.IBFESurfaceMethod(sph,
                                       surface.neo_hookean_membrane(1, 1)),
        lambda: build_fe_disc_example(n_cells=8, n_rings=2),
        lambda: cib.CIBMethod(g2, bodies),
        lambda: cib.make_disc((0.5, 0.5), 0.2, 4),
        lambda: cib.make_sphere((0.5,) * 3, 0.2, 2, 2),
        lambda: constraint_ib.fill_disc((0.5, 0.5), 0.1, 0.05),
    ]
    for m in (cib_ex0, cib_oscillating_cylinder, constraint_ib_eel2d,
              ib_explicit_filament2d, ibfe_explicit_beam2d,
              ibfe_explicit_ex0):
        db = parse_input_file(m.DEFAULT_INPUT)
        calls.append(lambda m=m, db=db: m.run(db))
        if hasattr(m, "build"):
            calls.append(lambda m=m, db=db: m.build(db))
    assert np.isfinite(disc.volume())
    return calls


def _transport_calls():
    """The scalar-transport and two-level AMR entry points and their
    drivers, each called without ``device``."""
    from ibamr_tpu_torch import amr, amr_dynamic, amr_ins
    from ibamr_tpu_torch.examples import (adv_diff_ex0, ib_explicit_ex0_amr,
                                          ib_explicit_ex4_amr)
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators.adv_diff import (
        AdvDiffSemiImplicitIntegrator, TransportedQuantity)
    from ibamr_tpu_torch.ops.sources import make_sources
    from ibamr_tpu_torch.utils.input_db import parse_input_file

    g = StaggeredGrid(n=(16, 16), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    box = amr.FineBox(lo=(4, 4), shape=(4, 4))
    calls = [
        lambda: AdvDiffSemiImplicitIntegrator(g, [TransportedQuantity("C")]),
        lambda: make_sources([0], [1.0]),
        lambda: amr.TwoLevelAdvDiff(g, box),
        lambda: amr_dynamic.DynamicTwoLevelAdvDiff(g, (4, 4)),
        lambda: amr_ins.CompositeProjection(g, box),
        lambda: amr_ins.TwoLevelINS(g, box),
    ]
    for m, ex in ((adv_diff_ex0, "adv_diff/ex0/input2d"),
                  (ib_explicit_ex0_amr, "IB/explicit/ex0_amr/input2d"),
                  (ib_explicit_ex4_amr, "IB/explicit/ex4_amr/input3d")):
        db = parse_input_file(str(ROOT / "examples" / ex))
        calls += [lambda m=m, db=db: m.run(db),
                  lambda m=m, db=db: m.build(db)]
    return calls


def _hierarchy_calls():
    """The L-level hierarchy's entry points (FAC, the multilevel and
    multi-box integrators), each called without ``device``."""
    from ibamr_tpu_torch import (amr, amr_ins_multilevel, amr_multibox,
                                 amr_multilevel)
    from ibamr_tpu_torch.bc import DomainBC
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators.ib_implicit import TwoLevelIBImplicit
    from ibamr_tpu_torch.solvers import fac

    g = StaggeredGrid(n=(16, 16), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    boxes = [amr.FineBox(lo=(4, 4), shape=(8, 8)),
             amr.FineBox(lo=(4, 4), shape=(8, 8))]
    levels = amr_multilevel.build_hierarchy(g, boxes)
    return [
        lambda: fac.FACCompositePoisson(g.n, DomainBC.periodic(2), g.dx,
                                        boxes[0]),
        lambda: fac.FACMultilevelPoisson(levels),
        lambda: amr_multilevel.MultiLevelAdvDiff(g, boxes),
        lambda: amr_ins_multilevel.MultiLevelCompositeProjection(levels),
        lambda: amr_ins_multilevel.MultiLevelINS(g, boxes),
        lambda: amr_ins_multilevel.MultiLevelIBINS(g, boxes, None),
        lambda: amr_multibox.MultiBoxDynamicAdvDiff(g, (4, 4), K=2),
        lambda: TwoLevelIBImplicit(g, boxes[0], None),
    ]


def _multiphase_calls():
    """The two-phase family's entry points (the VC and collocated
    integrators, the physics modules, stochastic forcing) and the two
    multiphase drivers, each called without ``device``."""
    from ibamr_tpu_torch.examples import (multiphase_dam_break,
                                          multiphase_falling_drop)
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators.ins_collocated import \
        INSCollocatedIntegrator
    from ibamr_tpu_torch.integrators.ins_vc import (
        INSVCConservativeIntegrator, INSVCStaggeredIntegrator)
    from ibamr_tpu_torch.ops.stochastic import (StochasticFluxForcing,
                                                StochasticStressForcing)
    from ibamr_tpu_torch.physics import complex_fluids, turbulence, waves
    from ibamr_tpu_torch.utils.input_db import parse_input_file

    g = StaggeredGrid(n=(8, 8), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    box = __import__("ibamr_tpu_torch.amr", fromlist=["FineBox"]).FineBox(
        lo=(2, 2), shape=(4, 4))
    calls = [
        lambda: INSVCStaggeredIntegrator(g),
        lambda: INSVCConservativeIntegrator(g),
        lambda: INSVCStaggeredIntegrator(g, wall_axes=(True, True)),
        lambda: INSCollocatedIntegrator(g),
        lambda: complex_fluids.OldroydB(g, 0.1, 0.5),
        lambda: complex_fluids.identity_conformation(g),
        lambda: turbulence.SmagorinskyINS(g, 1e-3),
        lambda: turbulence.TwoLevelSmagorinskyINS(g, box, 1e-3),
        lambda: turbulence.KOmegaINS(g, 1e-3),
        lambda: turbulence.channel_komega(n=8, iters=1),
        lambda: waves.make_zone(g, 0.0, 0.3, "generation", "lo"),
        lambda: waves.still_targets(g, 0.5),
        lambda: waves.cell_coords(g),
        lambda: StochasticStressForcing(g, 0.1, 1.0),
        lambda: StochasticFluxForcing(g, 0.1),
    ]
    for m, inputs in ((multiphase_dam_break, ("dam_break/input2d",)),
                      (multiphase_falling_drop,
                       ("falling_drop/input2d",
                        "falling_drop/input2d.walled"))):
        for ex in inputs:
            db = parse_input_file(str(ROOT / "examples/multiphase" / ex))
            calls += [lambda m=m, db=db: m.run(db),
                      lambda m=m, db=db: m.build(db)]
    return calls


def _structure_model_calls():
    """The implicit, IMP, GIB, penalty and instrument entry points, each
    called without ``device`` (an integrator on an INS integrator built
    without one)."""
    from ibamr_tpu_torch import instruments
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators import gib, imp, penalty_ib
    from ibamr_tpu_torch.integrators.ib_implicit import IBImplicitIntegrator
    from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator
    from ibamr_tpu_torch.ops import rods

    g2 = StaggeredGrid(n=(8, 8), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    g3 = StaggeredGrid(n=(8,) * 3, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    return [
        lambda: IBImplicitIntegrator(INSStaggeredIntegrator(g2), None),
        lambda: imp.IMPMethod([1.0], imp.NeoHookean(1.0, 1.0)),
        lambda: imp.material_disc(g2, (0.5, 0.5), 0.2),
        lambda: gib.GeneralizedIBMethod(INSStaggeredIntegrator(g3), None),
        lambda: rods.make_rods([0], [1], 1.0, 0.0, 1.0, 0.1),
        lambda: rods.straight_rod(4, 0.5),
        lambda: penalty_ib.PenaltyIBIntegrator(INSStaggeredIntegrator(g2),
                                               None, [0.0], 1.0),
        lambda: instruments.InstrumentPanel(
            g2, instruments.make_meters([[0, 1]], closed=False)),
    ]


def test_converters_default_to_the_gpu():
    """Every ``convert`` function places its tensors on the card unless it
    is passed ``device="cpu"``, like every entry point of the port."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    from types import SimpleNamespace as NS

    import numpy as np

    from ibamr_tpu_torch import convert

    z3 = np.zeros((2, 3))
    ins = NS(u=(z3,) * 3, p=z3, n_prev=(z3,) * 3, t=0.0, k=0)
    ib = NS(ins=ins, X=z3, U=z3, mask=np.ones(2))
    fluid = NS(u=(np.zeros((3, 2)), np.zeros((2, 3))), p=np.zeros((2, 2)),
               t=0.0)
    ib_open = NS(fluid=fluid, X=z3, U=z3, mask=np.ones(2),
                 F_net=np.zeros(3))
    specs = NS(targets=None, beams=None, springs=NS(
        idx0=[0], idx1=[1], stiffness=[1.0], rest_length=[0.5],
        enabled=[1.0]))
    b = NS(Xb=np.zeros((4, 2, 3)), wb=np.zeros((4, 2)),
           slot_of_marker=np.array([0, 8]), w_overflow=np.zeros(2),
           o_idx=np.array([1]), o_w=np.zeros(1), any_overflow=True,
           exceeded=False, x0=(np.zeros(4), np.zeros(4)),
           tile_of_chunk=np.zeros(4))
    asm = NS(elems=np.zeros((1, 3), int), shape=np.ones((3, 3)),
             dNdX=np.zeros((1, 3, 3, 2)), wdV=np.ones((1, 3)),
             lumped_mass=np.ones(3), n_nodes=3, dim=2)
    bodies = NS(body_id=np.zeros(2, int), n_bodies=1)
    cib_state = NS(ins=ins, X=z3, U_body=np.zeros((1, 6)))
    ad = NS(Q=(z3,), n_prev=(z3,), t=0.0, k=3)
    amr_s = NS(Qc=np.ones((8, 8)), Qf=np.ones((4, 4)), lo=np.array([2, 3]))
    fluid2 = NS(uc=(z3, z3), uf=(np.zeros((3, 3)), np.zeros((2, 4))),
                t=0.0, k=1)
    ib2 = NS(fluid=fluid2, X=z3, U=z3, mask=np.ones(2))
    ml = NS(us=((z3, z3), (np.zeros((3, 3)), np.zeros((2, 4)))), t=0.0,
            k=2)
    mlib = NS(fluid=ml, X=z3, U=z3, mask=np.ones(2))
    mb = NS(Qc=np.ones((8, 8)), Qf=np.ones((2, 4, 4)),
            lo=np.array([[2, 3], [5, 5]]))
    imp_s = NS(ins=ins, X=z3, F=np.zeros((2, 3, 3)), mask=np.ones(2))
    gib_s = NS(ins=ins, X=z3, D=np.zeros((2, 3, 3)))
    rods_s = NS(idx0=np.array([0]), idx1=np.array([1]), b=z3[:1], kappa=z3[:1],
                s=z3[:1], ds=np.ones(1), enabled=np.ones(1))
    pen = NS(ib=ib, Y=z3, V=z3)
    meters = NS(idx=np.zeros((1, 3), np.int32), valid=np.ones((1, 3)),
                seg=np.ones((1, 3)))
    vc_s = NS(u=(z3,) * 2, p=z3, phi=z3, n_prev=(z3,) * 2, t=0.0,
              k=np.int32(4))
    vcc_s = NS(u=(z3,) * 2, p=z3, phi=z3, rho=z3, t=0.0, k=np.int32(2))
    kw_s = NS(k=z3, omega=z3)
    rb_s = NS(center=np.zeros(2), U=np.zeros(2), theta=0.0, omega=0.0)
    calls = {"tensor": lambda **kw: convert.tensor(z3, **kw),
             "ins_state": lambda **kw: convert.ins_state(ins, **kw),
             "ib_state": lambda **kw: convert.ib_state(ib, **kw),
             "open_ins_state": lambda **kw: convert.open_ins_state(fluid,
                                                                   **kw),
             "ib_open_state": lambda **kw: convert.ib_open_state(ib_open,
                                                                 **kw),
             "force_specs": lambda **kw: convert.force_specs(specs, 2, **kw),
             "buckets": lambda **kw: convert.buckets(b, **kw),
             "packed_buckets": lambda **kw: convert.packed_buckets(b, **kw),
             "fe_assembly": lambda **kw: convert.fe_assembly(asm, **kw),
             "rigid_bodies": lambda **kw: convert.rigid_bodies(bodies, **kw),
             "constraint_ib_state": lambda **kw: convert.constraint_ib_state(
                 cib_state, **kw),
             "adv_diff_state": lambda **kw: convert.adv_diff_state(ad, **kw),
             "amr_state": lambda **kw: convert.amr_state(amr_s, **kw),
             "two_level_ins_state": lambda **kw:
                 convert.two_level_ins_state(fluid2, **kw),
             "two_level_ib_state": lambda **kw: convert.two_level_ib_state(
                 ib2, **kw),
             "multilevel_ins_state": lambda **kw:
                 convert.multilevel_ins_state(ml, **kw),
             "multilevel_ib_state": lambda **kw:
                 convert.multilevel_ib_state(mlib, **kw),
             "multibox_state": lambda **kw: convert.multibox_state(mb, **kw),
             "imp_state": lambda **kw: convert.imp_state(imp_s, **kw),
             "gib_state": lambda **kw: convert.gib_state(gib_s, **kw),
             "rod_specs": lambda **kw: convert.rod_specs(rods_s, **kw),
             "penalty_ib_state": lambda **kw: convert.penalty_ib_state(
                 pen, **kw),
             "meter_specs": lambda **kw: convert.meter_specs(meters, **kw),
             "vc_ins_state": lambda **kw: convert.vc_ins_state(vc_s, **kw),
             "vc_cons_state": lambda **kw: convert.vc_cons_state(vcc_s,
                                                                 **kw),
             "collocated_ins_state": lambda **kw:
                 convert.collocated_ins_state(ins, **kw),
             "komega_state": lambda **kw: convert.komega_state(kw_s, **kw),
             "rigid_body_state": lambda **kw: convert.rigid_body_state(
                 rb_s, **kw),
             "conformation": lambda **kw: convert.conformation(z3, **kw)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        leaves = list(_leaves(call(device="cpu")))
        assert leaves and all(t.device.type == "cpu" for t in leaves), name
    assert convert.buckets(b, device="cpu").counts.tolist() == [1, 0, 0, 0]
    a = convert.amr_state(amr_s, device="cpu")
    assert a.lo.dtype == torch.int32 and a.lo.tolist() == [2, 3]
    assert convert.adv_diff_state(ad, device="cpu").k.dtype == torch.int32
    box = convert.fine_box(NS(lo=np.array([2, 3]), shape=(4, 6), ratio=2))
    assert (box.lo, box.shape, box.fine_n) == ((2, 3), (4, 6), (8, 12))
    mbs = convert.multibox_state(mb, device="cpu")
    assert mbs.lo.dtype == torch.int32 and mbs.lo.tolist() == [[2, 3], [5, 5]]
    assert convert.rod_specs(rods_s, device="cpu").idx0.dtype == torch.int64
    assert convert.meter_specs(meters, device="cpu").idx.dtype == torch.int64
    # the two-phase states keep their step counter as a host int
    assert convert.vc_ins_state(vc_s, device="cpu").k == 4
    assert isinstance(convert.vc_cons_state(vcc_s, device="cpu").k, int)
    g = NS(n=np.array([8, 8]), x_lo=(0.0, 0.0), x_up=(1.0, 2.0))
    levels = convert.level_specs([NS(box=None, grid=g), NS(box=NS(
        lo=(2, 2), shape=(4, 4), ratio=2), grid=g)])
    assert levels[0].box is None and levels[1].box.fine_n == (8, 8)
    assert levels[1].grid.dx == (0.125, 0.25)


def _leaves(obj):
    """The tensors of a tensor or of nested (named) tuples."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, tuple):
        for v in obj:
            yield from _leaves(v)


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    from ibamr_tpu_torch.ops import kernel_build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernel_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel_build.load_all()
    assert not (tmp_path / "build").exists()
