"""The artifact registry and its budgets (port of
``ibamr_tpu/analysis/contracts.py``).

A *contract* pins one named artifact (the solo step, the fused spectral
substep per dtype, each spread/interp engine, the driver's chunk, the
lane-masked fleet chunk, the per-lane capsule fetch, the sharded pieces)
to the budget-comparable slice of its
:func:`~ibamr_tpu_torch.analysis.graph_census.graph_census`. The port's
budgets are its own file, ``ibamr_tpu_torch/GRAPH_BUDGETS.json`` (as
``ibamr_tpu_torch/SLO.json`` is): the reference's counts are of jaxpr
primitives and HLO ops, the port's of the aten ops a call runs, so the
two files cannot share numbers. A refactor that adds a scatter, un-fuses
an FFT, puts a host read into a chunk, widens a dtype or stops launching
a hand kernel fails the gate (``python -m
ibamr_tpu_torch.tools.graph_audit``, exit 2) and the tier-1 pin
(``tests/test_torch_graph_contracts.py``) on the same counting rules.

Every artifact builds the port's counterpart of the reference's at the
reference's miniature (``_N, _N_LAT, _N_LON = 16, 8, 16``, ``_DT =
5e-5``, the same shell), in float32, on the device the caller gives;
the sharded ones on an 8-shard ``spmd`` mesh of that device
(``mesh_devices(8, device)``). :func:`measure_artifact` runs the
artifact once to warm its caches (spectral plans, stencil memos), then
counts one call. The same aten ops run on the CPU and the card: the
hand-kernel launches (``custom_calls``, 0 on the CPU, where the
wrappers run their plain versions) and the device-to-host copies
(``host_copies``, inside ``host_syncs``) are the only differences. A
``.tolist()``, ``.cpu()`` or ``.numpy()`` runs no op on the CPU, so the
copies are pinned by the budgets file's ``card`` section
(:func:`load_card_counts`): per light artifact, and for the flagship
step on each engine the analysis phase runs
(``solo_step_256:<engine>``), the card's ``host_copies`` and
``host_copies_in_chunk``, which ``chip_smoke.py``'s analysis phase
holds exactly.

Not ported, by design: ``donated_step`` and ``donated_chunk`` (eager
PyTorch has no buffer donation; ``jitted_step(donate=True)`` donates
nothing). They stay in the registry, marked, and raise when built.
``krylov_reduce`` runs the same CG on one device: the port's Krylov
layer has no sharded operator (``spmd`` shards the step's seams), so its
pin is the CG's host reads per iteration, not an all-reduce count.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.analysis.graph_census import (
    BUDGET_MAX_METRICS,
    BUDGET_MIN_METRICS,
    budget_metrics,
    graph_census,
)

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET_PATH = os.path.join(PACKAGE_ROOT, "GRAPH_BUDGETS.json")
BUDGET_DOC = (
    "The port's graph-contract budgets (python -m "
    "ibamr_tpu_torch.tools.graph_audit; analysis/contracts.py). Counts "
    "of the aten ops one call runs after one warm-up call, by the "
    "dispatch census of analysis/graph_census.py, measured on the CPU "
    "in float32 on one PyTorch thread (the same aten ops run on the "
    "card, where custom_calls and the host copies in host_syncs may "
    "differ). The heavy solo_step_256 (256^3, 99,856 markers) is not "
    "run on the CPU: its counts are the card's (chip_smoke.py's "
    "analysis phase, NVIDIA H100 80GB HBM3, 700.00 W) with the "
    "device-to-host copies taken out of host_syncs. 'custom_calls' is "
    "a floor (regresses DOWN), every other metric a ceiling (regresses "
    "UP). The 'card' section holds what the CPU cannot count: the "
    "device-to-host copies (host_copies, host_copies_in_chunk) of each "
    "light artifact and of the flagship step on each engine "
    "(solo_step_256:<engine>), from chip_smoke.py's analysis phase on "
    "the card, which holds them exactly.")
# the metrics of the budgets file's card section
CARD_METRICS = ("host_copies", "host_copies_in_chunk")

# the reference's flagship miniature: every structural feature of the
# step exists (buckets, packing, chunks, probe), and the whole registry
# runs in seconds on the CPU
_N, _N_LAT, _N_LON = 16, 8, 16
_DT = 5e-5
_SHARDS = 8


def _shell(device, engine="packed", spectral_dtype=None, n=_N,
           n_lat=_N_LAT, n_lon=_N_LON):
    from ibamr_tpu_torch.models.shell3d import build_shell_example

    return build_shell_example(
        n_cells=n, n_lat=n_lat, n_lon=n_lon, radius=0.25, aspect=1.2,
        stiffness=1.0, rest_length_factor=0.75, mu=0.05,
        use_fast_interaction=engine, spectral_dtype=spectral_dtype,
        dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# artifact builders: each returns (fn, args, chunk); chunk=True counts the
# whole call as a driver chunk's body
# ---------------------------------------------------------------------------

def _build_solo_step(device, spectral_dtype=None, engine="packed"):
    integ, state = _shell(device, engine=engine,
                          spectral_dtype=spectral_dtype)
    return (lambda s: integ.step(s, _DT)), (state,), False


def _build_fused_substep(device, spectral_dtype=None):
    from ibamr_tpu_torch.solvers import fft as _fft

    integ, state = _shell(device, spectral_dtype=spectral_dtype)
    ins = integ.ins
    dx = ins.grid.dx
    alpha, beta = ins.rho / _DT, -0.5 * ins.mu

    def sub(rhs):
        return _fft.helmholtz_project_periodic(
            rhs, dx, alpha=alpha, beta=beta, pinc_coeffs=(alpha, beta),
            spectral_dtype=spectral_dtype)

    return sub, (state.ins.u,), False


def _build_transfer(device, engine, piece):
    integ, state = _shell(device, engine=engine)
    ib = integ.ib
    grid = integ.ins.grid
    X, mask = state.X, state.mask
    if piece == "spread":
        F = torch.zeros_like(X)

        def spread(Xa, Fa, m):
            ctx = ib.prepare(Xa, m)
            return ib.spread_force(Fa, grid, Xa, m, ctx=ctx)

        return spread, (X, F, mask), False

    def interp(ua, Xa, m):
        ctx = ib.prepare(Xa, m)
        return ib.interpolate_velocity(ua, grid, Xa, m, ctx=ctx)

    return interp, (state.ins.u, X, mask), False


def _driver(integ, lanes=None, lane_mesh=None, remat=None):
    from ibamr_tpu_torch.utils.health import HealthProbe
    from ibamr_tpu_torch.utils.hierarchy_driver import (HierarchyDriver,
                                                        RunConfig)

    cfg = RunConfig(dt=_DT, num_steps=4, health_interval=2, remat=remat)
    return HierarchyDriver(integ, cfg, lanes=lanes, lane_mesh=lane_mesh,
                           health_probe=HealthProbe.for_integrator(integ))


def _requires_grad(tree, out: list):
    """``tree`` with every floating tensor leaf a fresh leaf that
    requires grad (appended to ``out``)."""
    from ibamr_tpu_torch.utils.tree import tree_map

    def mark(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            y = x.detach().requires_grad_(True)
            out.append(y)
            return y
        return x

    return tree_map(mark, tree)


def _build_grad_substep(device, spectral_dtype=None):
    # the whole reverse pass of the fused substep: its adjoint rides the
    # same plan, so <= 2x the primal's FFTs (4 against 2) is the pin
    from ibamr_tpu_torch.utils.tree import leaves, tree_map

    sub, (rhs,), _ = _build_fused_substep(device, spectral_dtype)
    with torch.no_grad():
        ct = tree_map(torch.ones_like, sub(rhs))

    def grad_sub(r, c):
        with torch.enable_grad():
            xs: list = []
            out = sub(_requires_grad(r, xs))
            g = torch.autograd.grad(leaves(out), xs, leaves(c))
        return out, g

    return grad_sub, (rhs, ct), False


class _SavedCtx:
    """The saved state an adjoint Function's ``backward`` reads: the
    reverse pass alone, with the buckets held as residuals."""

    def __init__(self, saved, args):
        self.saved_tensors = saved
        self.args = args
        self.needs_input_grad = (True, True)


def _build_grad_transfer(device, piece):
    # the packed transfers' BACKWARD pass in isolation (the adjoint
    # Function's backward, as the reference calls _spread_bwd): grad
    # spread is an interp through the same buckets (zero accumulating
    # scatters); grad interp's field cotangent is the primal spread
    from ibamr_tpu_torch.ops import interaction_packed as ip

    integ, state = _shell(device, engine="packed")
    eng = integ.ib.fast
    X, mask = state.X, state.mask
    b = eng.buckets(X, mask)
    args = (eng.geom, eng.grid, b, 0, eng.kernel, None)
    N = X.shape[0]
    if piece == "spread":
        F = torch.zeros(N, dtype=X.dtype, device=X.device)
        g = torch.zeros(eng.grid.n, dtype=X.dtype, device=X.device)

        def spread_bwd(Fa, Xa, ga):
            return ip._SpreadAdjoint.backward(
                _SavedCtx((Fa, Xa), args), ga)[:2]

        return spread_bwd, (F, X, g), False
    f = torch.zeros(eng.grid.n, dtype=X.dtype, device=X.device)
    ct = torch.zeros(N, dtype=X.dtype, device=X.device)

    def interp_bwd(fa, Xa, ca):
        return ip._InterpAdjoint.backward(
            _SavedCtx((fa, Xa), args), ca)[:2]

    return interp_bwd, (f, X, ct), False


def _build_grad_chunk(device):
    # reverse mode through the driver's checkpointed chunk (remat
    # "dots", health probe in it): the design loop's unit of
    # differentiation; zero host reads in the chunk and zero f64
    # widenings are the pins
    from ibamr_tpu_torch.utils.tree import leaves

    integ, state = _shell(device)
    chunk = _driver(integ, remat="dots")._chunk(4)

    def grad_chunk(st, dt):
        with torch.enable_grad():
            xs: list = []
            out = chunk(_requires_grad(st, xs), dt)
            loss = sum(torch.sum(x) for x in leaves(out)
                       if isinstance(x, torch.Tensor)
                       and x.is_floating_point())
            return torch.autograd.grad(loss, xs, allow_unused=True)

    return grad_chunk, (state, _DT), True


def _build_solo_chunk(device):
    # the driver's chunk with the health probe: the body is where a stray
    # host read costs one sync per step instead of one per chunk
    integ, state = _shell(device)
    return _driver(integ)._chunk(4), (state, _DT), True


def _fleet_args(state, lanes, mesh=None):
    from ibamr_tpu_torch.utils import lanes as _lanes

    stacked = _lanes.stack_lanes([state] * lanes)
    if mesh is not None:
        from ibamr_tpu_torch.parallel.mesh import place_lanes

        stacked = place_lanes(stacked, mesh)
    # dt and the lane mask on the host, as the driver passes them
    return (stacked, np.full((lanes,), _DT, dtype=np.float32),
            np.ones((lanes,), dtype=bool))


def _build_fleet_chunk(device):
    integ, state = _shell(device)
    return (_driver(integ, lanes=2)._chunk(2), _fleet_args(state, 2),
            True)


def _attach_contract_ledger() -> None:
    """Attach a live run ledger for a telemetry-on artifact: it stays
    attached through the census (:func:`measure_artifact` detaches and
    closes it), so the chunk runs exactly as a supervised run's does."""
    from ibamr_tpu_torch import obs

    path = os.path.join(tempfile.mkdtemp(prefix="obs-contract-"),
                        "ledger.jsonl")
    obs.attach(obs.RunLedger(path))


def _build_solo_chunk_telemetry(device):
    # the solo chunk as the instrumented driver runs it: live ledger,
    # the driver's span around the chunk and the per-chunk flush after
    # it, all host-side (same ceilings as solo_chunk)
    from ibamr_tpu_torch import obs

    integ, state = _shell(device)
    chunk = _driver(integ)._chunk(4)
    _attach_contract_ledger()

    def run(st, dt):
        with obs.span("driver/chunk", step=0, length=4):
            out = chunk(st, dt)
        obs.chunk_boundary(step=4)
        return out

    return run, (state, _DT), True


def _build_fleet_chunk_telemetry(device):
    from ibamr_tpu_torch import obs

    integ, state = _shell(device)
    chunk = _driver(integ, lanes=2)._chunk(2)
    _attach_contract_ledger()

    def run(st, dt, al):
        with obs.span("driver/chunk", step=0, length=2):
            out = chunk(st, dt, al)
        obs.chunk_boundary(step=2)
        return out

    return run, _fleet_args(state, 2), True


def _not_ported(name: str, why: str):
    def build(device):
        raise NotImplementedError(f"artifact {name!r} is not ported: {why}")
    return build


_NO_DONATION = ("eager PyTorch has no buffer donation "
                "(jitted_step(donate=True) donates nothing)")


def _build_lane_fetch(device):
    # the per-lane capsule/rollback fetch: a pure slice (zero scatters,
    # zero FFTs, zero host reads)
    from ibamr_tpu_torch.utils import lanes as _lanes

    integ, state = _shell(device)
    stacked = _lanes.stack_lanes([state, state])
    return (lambda st: _lanes.lane_slice(st, 0)), (stacked,), False


def _build_open_channel_step(device):
    # the open-boundary stabilized-PPM step (saddle Stokes + boundary-band
    # upwind blending): the reference's first-wave f64 finding lived here
    from ibamr_tpu_torch.integrators.ins_open import INSOpenIntegrator
    from ibamr_tpu_torch.solvers.stokes import channel_bc

    io = INSOpenIntegrator(
        (_N, _N), (1.0 / _N, 1.0 / _N), channel_bc(2), mu=0.05, dt=_DT,
        bdry={(0, 0, 0): 1.0}, convective_op_type="stabilized_ppm",
        dtype=torch.float32, device=device)
    return (lambda s: io.step(s)), (io.initialize(),), False


def _build_served_chunk(device):
    # the warm pool's first-step ack: a 1-step 2-lane fleet chunk with
    # one live lane and one padding lane
    from ibamr_tpu_torch.serve.aot_cache import ExecutableCache
    from ibamr_tpu_torch.serve.router import BucketSpec, WarmPool

    pool = WarmPool(BucketSpec(n_cells=_N, n_lat=_N_LAT, n_lon=_N_LON,
                               lanes=2, engine="packed"),
                    ExecutableCache(), device=device)
    fn, args, _ = pool.contract_args(length=1, live=1)
    return fn, args, True


def _mesh(device):
    from ibamr_tpu_torch.parallel.mesh import make_mesh
    from ibamr_tpu_torch.parallel.spmd import mesh_devices

    return make_mesh(devices=mesh_devices(_SHARDS, device), max_axes=2)


def _build_sharded_chunk(device):
    # the block-resident sharded coupled IB step (halo stencils,
    # pencil-FFT solves, co-partitioned transfers) over a 2-step chunk on
    # the 8-shard (4, 2) mesh: the collective census is the comm layer's
    # pin, and whole_grid_layouts pins 0 whole-grid shard/unshard calls
    from ibamr_tpu_torch.parallel.mesh import make_sharded_step, place_state

    integ, state0 = _shell(device)
    mesh = _mesh(device)
    step = make_sharded_step(integ, mesh)
    state = place_state(state0, integ.ins.grid, mesh)

    def chunk(st, dt):
        for _ in range(2):
            st = step(st, dt)
        return st

    return chunk, (state, _DT), True


def _build_fftpar_transpose(device):
    # the pencil-FFT Helmholtz solve alone on the (4, 2) mesh over 16^3:
    # its all_to_all transposes are the long-range communication
    from ibamr_tpu_torch.parallel.fftpar import PencilFFT

    integ, state = _shell(device)
    pencil = PencilFFT(integ.ins.grid, _mesh(device))
    return ((lambda r: pencil.helmholtz(r, 200.0, -0.025)),
            (state.ins.u[0],), False)


def _build_lagrangian_exchange(device):
    # the co-partitioned exchange alone: owner bucketing, local spread,
    # ppermute halo accumulate
    from ibamr_tpu_torch.parallel.lagrangian import ShardedInteraction

    integ, state = _shell(device)
    si = ShardedInteraction(integ.ins.grid, _mesh(device),
                            n_markers=state.X.shape[0])

    def exchange(Fa, Xa, m):
        b = si.buckets(Xa, m)
        return si.spread_vel(Fa, Xa, weights=m, b=b)

    return exchange, (torch.zeros_like(state.X), state.X, state.mask), \
        False


def _build_fleet_mesh_chunk(device):
    # the 8-lane fleet chunk over the 8-shard lane mesh: lanes are
    # independent, so no collective moves data
    from ibamr_tpu_torch.parallel.mesh import make_lane_mesh
    from ibamr_tpu_torch.parallel.spmd import mesh_devices

    integ, state = _shell(device)
    mesh = make_lane_mesh(devices=mesh_devices(_SHARDS, device))
    chunk = _driver(integ, lanes=_SHARDS, lane_mesh=mesh)._chunk(2)
    return chunk, _fleet_args(state, _SHARDS, mesh), True


def _build_krylov_reduce(device):
    # the Krylov layer's reductions: CG on the shifted periodic Poisson
    # operator (one device; module docstring)
    from ibamr_tpu_torch.solvers.krylov import cg

    def A(x):
        return (7.0 * x
                - torch.roll(x, 1, 0) - torch.roll(x, -1, 0)
                - torch.roll(x, 1, 1) - torch.roll(x, -1, 1)
                - torch.roll(x, 1, 2) - torch.roll(x, -1, 2))

    b = torch.ones((_N, _N, _N), dtype=torch.float32, device=device)
    return (lambda r: cg(A, r, maxiter=8).x), (b,), False


def _build_solo_step_256(device, engine="packed", n=256, n_lat=316,
                         n_lon=316):
    integ, state = _shell(device, engine=engine, n=n, n_lat=n_lat,
                          n_lon=n_lon)
    return (lambda s: integ.step(s, _DT)), (state,), False


def _build_assim_analysis(device):
    # the masked B-lane ESRF analysis: the panel's observation operator
    # over the lanes, the ensemble-space square-root update and the
    # pack/unpack of the assimilated subset, with one quarantined lane
    # and one rejected channel in the arguments
    from ibamr_tpu_torch.assim import (ObservationOperator, esrf_analysis,
                                       state_packer)
    from ibamr_tpu_torch.instruments import InstrumentPanel, make_meters
    from ibamr_tpu_torch.utils import lanes as _lanes

    integ, state = _shell(device)
    loops = [[2 * _N_LON + j for j in range(_N_LON)],
             [5 * _N_LON + j for j in range(_N_LON)]]
    panel = InstrumentPanel(integ.ins.grid,
                            make_meters(loops, closed=True, device=device))
    op = ObservationOperator(panel)
    B = 4
    stacked = _lanes.broadcast_lane(state, B)
    pack, unpack, _n = state_packer(state)

    def analyze(fleet, y, r, om, alive, lam):
        members = [_lanes.lane_slice(fleet, i) for i in range(B)]
        ens = torch.stack([pack(s) for s in members])
        ana, diag = esrf_analysis(ens, op.fleet(fleet), y, r, alive, om,
                                  lam)
        return _lanes.stack_lanes([unpack(s, ana[i])
                                   for i, s in enumerate(members)]), diag

    m = op.n_obs
    dev = state.X.device
    y = torch.zeros((m,), dtype=torch.float32, device=dev)
    r = torch.full((m,), 1e-4, dtype=torch.float32, device=dev)
    om = torch.tensor([True] * (m - 1) + [False], device=dev)
    alive = torch.tensor([True] * (B - 1) + [False], device=dev)
    lam = torch.tensor(1.0, dtype=torch.float32, device=dev)
    return analyze, (stacked, y, r, om, alive, lam), False


@dataclass(frozen=True)
class Artifact:
    """One named artifact under contract."""
    name: str
    build: Callable[..., Tuple]      # (device) -> (fn, args, chunk)
    heavy: bool = False              # flagship-scale: slow tier / --heavy
    notes: str = ""
    ported: bool = True


ARTIFACTS: Dict[str, Artifact] = {
    a.name: a for a in (
        Artifact("solo_step", _build_solo_step,
                 notes="full coupled IB step, packed engine, f32"),
        Artifact("solo_step_bf16",
                 lambda d: _build_solo_step(d, spectral_dtype="bf16"),
                 notes="full step with bf16 spectral transforms"),
        Artifact("fused_substep", _build_fused_substep,
                 notes="k-space-resident Helmholtz+projection substep "
                       "(<= 2 batched FFTs is the fusion pin)"),
        Artifact("fused_substep_bf16",
                 lambda d: _build_fused_substep(d, spectral_dtype="bf16"),
                 notes="mixed-precision substep; bf16 rounding converts "
                       "are budgeted, widenings are not"),
        Artifact("spread_packed",
                 lambda d: _build_transfer(d, "packed", "spread"),
                 notes="occupancy-packed force spread"),
        Artifact("interp_packed",
                 lambda d: _build_transfer(d, "packed", "interp"),
                 notes="occupancy-packed velocity interp"),
        Artifact("spread_mxu",
                 lambda d: _build_transfer(d, "mxu", "spread"),
                 notes="dense one-hot contraction spread"),
        Artifact("interp_mxu",
                 lambda d: _build_transfer(d, "mxu", "interp"),
                 notes="dense one-hot contraction interp"),
        Artifact("grad_substep", _build_grad_substep,
                 notes="reverse pass of the fused substep on the same "
                       "plan: fft_ops 4 against the primal's 2"),
        Artifact("grad_spread",
                 lambda d: _build_grad_transfer(d, "spread"),
                 notes="packed spread backward: an interp through the "
                       "same buckets, zero accumulating scatters"),
        Artifact("grad_interp",
                 lambda d: _build_grad_transfer(d, "interp"),
                 notes="packed interp backward: d/df is the primal "
                       "spread, d/dX the weight-derivative pullback"),
        Artifact("grad_chunk", _build_grad_chunk,
                 notes="reverse mode through the checkpointed driver "
                       "chunk; zero host reads in the chunk, zero f64 "
                       "widenings"),
        Artifact("solo_chunk", _build_solo_chunk,
                 notes="driver chunk + health probe; host_syncs_in_chunk "
                       "is the pin"),
        Artifact("donated_chunk",
                 _not_ported("donated_chunk", _NO_DONATION),
                 notes="not ported: no buffer donation", ported=False),
        Artifact("fleet_chunk", _build_fleet_chunk,
                 notes="2-lane chunk with the lane-freeze select"),
        Artifact("solo_chunk_telemetry", _build_solo_chunk_telemetry,
                 notes="solo chunk with a live ledger, the driver span "
                       "and the per-chunk flush; telemetry stays "
                       "host-side (same ceilings as solo_chunk)"),
        Artifact("fleet_chunk_telemetry", _build_fleet_chunk_telemetry,
                 notes="fleet chunk telemetry-on; same ceilings as "
                       "fleet_chunk"),
        Artifact("donated_step",
                 _not_ported("donated_step", _NO_DONATION),
                 notes="not ported: no buffer donation", ported=False),
        Artifact("lane_fetch", _build_lane_fetch,
                 notes="per-lane capsule fetch (lane_slice): zero "
                       "scatter/fft/host budget"),
        Artifact("served_chunk", _build_served_chunk,
                 notes="warm-pool 1-step ack chunk, 1 live + 1 padded "
                       "lane: the fleet chunk's ceilings"),
        Artifact("open_channel_step", _build_open_channel_step,
                 notes="open-boundary stabilized-PPM step (saddle "
                       "Stokes), f32: dtype-clean pin"),
        Artifact("solo_step_256", _build_solo_step_256, heavy=True,
                 notes="flagship 256^3 coupled step, 99,856 markers "
                       "(slow tier; graph_audit --heavy)"),
        Artifact("sharded_chunk", _build_sharded_chunk,
                 notes="8-shard block-resident coupled IB chunk (halo "
                       "stencils, pencil FFT, co-partitioned transfers): "
                       "collective census, 0 whole-grid layouts"),
        Artifact("fftpar_transpose", _build_fftpar_transpose,
                 notes="pencil-FFT Helmholtz on the (4,2) mesh: "
                       "all_to_all count/bytes"),
        Artifact("lagrangian_exchange", _build_lagrangian_exchange,
                 notes="owner-bucketed spread with ppermute halo "
                       "accumulate: ppermute count/bytes"),
        Artifact("fleet_mesh_chunk", _build_fleet_mesh_chunk,
                 notes="8-lane fleet chunk on the 8-shard lane mesh: "
                       "zero collective traffic"),
        Artifact("assim_analysis", _build_assim_analysis,
                 notes="masked B-lane ESRF analysis, one quarantined "
                       "lane and one rejected channel"),
        Artifact("krylov_reduce", _build_krylov_reduce,
                 notes="CG reductions on one device: host reads per "
                       "iteration"),
    )
}


def build_artifact(name: str, device="cuda", **opts):
    """``(fn, args, chunk)`` of one artifact on ``device``: the card
    unless the caller asks for the CPU (``opts`` reach builders that
    take them, e.g. ``engine=`` of the steps)."""
    return ARTIFACTS[name].build(device, **opts)


def measure_census(name: str, device="cuda", **opts) -> dict:
    """Build one artifact on ``device``, run it once to warm its caches,
    then take the full :func:`graph_census` of one call. Grad mode is off
    unless the artifact turns it on. A telemetry builder's ledger is
    detached and closed after, and the caller's ledger restored."""
    from ibamr_tpu_torch import obs

    prev = obs.current()
    try:
        with torch.no_grad():
            fn, args, chunk = build_artifact(name, device, **opts)
            fn(*args)
            return graph_census(fn, args, chunk=chunk)
    finally:
        led = obs.current()
        if led is not prev:
            obs.detach()
            try:
                led.close()
            except Exception:
                pass
            if prev is not None:
                obs.attach(prev)


def measure_artifact(name: str, device="cuda", **opts) -> dict:
    """The flat budget-comparable metrics of one artifact
    (:func:`measure_census`)."""
    return budget_metrics(measure_census(name, device, **opts))


# ---------------------------------------------------------------------------
# budget load / diff
# ---------------------------------------------------------------------------

def load_budgets(path: Optional[str] = None) -> dict:
    with open(path or BUDGET_PATH) as f:
        doc = json.load(f)
    return doc.get("artifacts", {})


def load_card_counts(path: Optional[str] = None) -> dict:
    """The budgets file's ``card`` section: ``{key: {metric: count}}``
    over ``CARD_METRICS``, keyed by artifact name, or
    ``solo_step_256:<engine>`` for the flagship step on an engine."""
    with open(path or BUDGET_PATH) as f:
        doc = json.load(f)
    return doc.get("card", {})


@dataclass
class Drift:
    """Per-artifact diff of measured metrics against the budget."""
    name: str
    regressions: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    improvements: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    missing: Tuple[str, ...] = ()     # budgeted metric absent in census

    @property
    def clean(self) -> bool:
        return not (self.regressions or self.improvements or self.missing)


def diff_budget(name: str, measured: dict, budget: dict) -> Drift:
    """Compare one artifact's measured metrics to its budget.

    Max metrics regress UP (measured > budget) and improve DOWN; the
    min metric (``custom_calls``) regresses DOWN: a refactor that stops
    launching a hand kernel is a regression even though every other
    counter stays flat."""
    d = Drift(name)
    missing = []
    for metric, bound in budget.items():
        if metric not in measured:
            missing.append(metric)
            continue
        got = int(measured[metric])
        bound = int(bound)
        if metric in BUDGET_MIN_METRICS:
            if got < bound:
                d.regressions[metric] = (got, bound)
            elif got > bound:
                d.improvements[metric] = (got, bound)
        elif metric in BUDGET_MAX_METRICS:
            if got > bound:
                d.regressions[metric] = (got, bound)
            elif got < bound:
                d.improvements[metric] = (got, bound)
        # unknown metrics in the budget file are a budget-file bug:
        # surface as missing rather than silently passing
        else:
            missing.append(metric)
    d.missing = tuple(missing)
    return d


def report_drift(drifts) -> str:
    """Human-readable drift report (one block per non-clean artifact)."""
    lines = []
    for d in drifts:
        if d.clean:
            continue
        lines.append(f"[{d.name}]")
        for m, (got, bound) in sorted(d.regressions.items()):
            word = ("dropped below floor"
                    if m in BUDGET_MIN_METRICS else "exceeds budget")
            lines.append(f"  REGRESSED  {m}: {got} {word} {bound}")
        for m, (got, bound) in sorted(d.improvements.items()):
            lines.append(
                f"  improved   {m}: {got} (budget {bound}): run "
                f"python -m ibamr_tpu_torch.tools.graph_audit --tighten "
                f"to ratchet")
        for m in d.missing:
            lines.append(f"  MISSING    {m}: not measurable / unknown "
                         f"metric: budget file and census disagree")
    return "\n".join(lines)
