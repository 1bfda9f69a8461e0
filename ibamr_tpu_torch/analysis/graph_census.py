"""Census of one call of a torch function, and of a device trace (port of
``ibamr_tpu/analysis/graph_census.py``).

The reference reads its counts from a traced jaxpr and a compiled HLO
module. Eager PyTorch has neither, so the port counts what a call
*runs*, with two front ends and one set of counting rules:

- **the dispatch front end** (:class:`DispatchCensus`, CPU and GPU
  alike): a ``TorchDispatchMode`` over every aten op a call runs. The
  mode is thread-local state that the autograd engine carries into its
  device threads, so a backward pass on the card is counted too. Per
  op class:

  - ``fft_ops`` / ``fft_bytes`` / ``fft_transforms``: ``_fft_r2c``,
    ``_fft_c2r``, ``_fft_c2c`` with input plus output bytes (the
    reference's ``fft_census``); one ``rfftn`` is one op;
  - ``dot_*``: ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
    ``dot`` (``matmul`` and ``einsum`` as they lower), operand and
    output bytes and ``2·|out|·K`` flops (``dot_census``);
  - ``scatter_ops`` (``index_put`` with ``accumulate``, ``index_add``,
    ``scatter_add``, ``scatter_reduce``) and ``gather_ops`` (``index``,
    ``index_select``, ``gather``, ``take``);
  - ``convert_ops`` (``_to_copy`` or ``copy_`` that changes the
    dtype), ``f64_widenings`` (a narrower float into float64, by a
    convert or by an op whose float64 output promoted a narrower float
    input), ``roundtrip_chains`` (x -> wider -> x, followed by tensor
    identity; ``f32 -> bf16 -> f32`` goes through a NARROWER dtype and
    is not flagged), as ``convert_census``;
  - ``host_syncs``: ``_local_scalar_dense`` (``.item()``, ``float()``,
    ``bool()`` of a tensor), ``is_nonzero``, ``equal``, the
    data-dependent-shape ops (``nonzero``, ``masked_select``,
    ``unique*``, boolean-mask ``index``) and any copy from a CUDA tensor
    to the CPU (also counted alone as ``host_copies``: on the CPU a
    ``.cpu()`` or ``.numpy()`` runs no op, so these are the one place
    the card's census may exceed the CPU's);
  - ``host_syncs_in_chunk``: the same inside a driver chunk's body
    (:func:`chunk_body`, or ``graph_census(..., chunk=True)``), the
    counterpart of ``host_transfers_in_scan``. The driver's one read per
    chunk happens after the body and is not in it;
  - ``bytes_accessed``: each op's tensor operand bytes plus its output
    bytes, views (which move nothing) excepted: the rule of XLA's bytes
    accessed, read by ``tools/hlo_cost_audit.py``.
- **the collective census**: ``parallel/spmd.py``'s block collectives
  report themselves (one record per mesh-level call, the bytes of one
  shard's output block, as the reference counts per-shard avals), under
  the reference's names ``<prim>_prims`` / ``<prim>_bytes`` /
  ``collective_*``;
- **whole-grid layouts** (``whole_grid_layouts``): every cut of a whole
  tensor into ``spmd.Blocks`` and every assembly of one; the
  block-resident sharded step pins it at 0. A multigrid level too coarse
  to cut is gathered to the first shard and its correction scattered
  back: those count as ``coarse_gathers`` / ``coarse_scatters``. They
  never hold the finest grid: a finest level that must be gathered
  (blocks of an odd extent) is assembled and cut, a whole-grid layout;
- **hand-kernel launches** (``custom_calls``): read from
  ``ops/cuda_interaction.LAUNCHES``, because a ``ctypes`` launch
  bypasses the dispatcher. On the CPU the wrappers run their plain
  versions and launch nothing. Likewise ``graph_replays`` (from
  ``utils/cuda_graph.REPLAYS``): a replayed CUDA graph runs its kernels
  without the dispatcher, so on the card a graphed piece's ops are not
  in the dispatch counts (a census there is at most the CPU's);
- **the trace front end** (:func:`trace_census`, the card): the
  counterpart of ``hlo_op_counts`` / ``op_class_counts``. It reads a
  ``torch.profiler`` Chrome trace through
  ``obs.deviceprof.torch_device_events`` and gives, per step, kernels by
  class (the four hand kernels by name, cuFFT, GEMM, elementwise,
  reduction, copy, other), device-to-host memcpys and the host's
  stream/device synchronizations. :func:`profile_census` captures one.

Not ported, by design: ``donation_census`` (torch has no buffer
donation; ``IBExplicitIntegrator.jitted_step(donate=True)`` donates
nothing), and ``overlap_census`` / ``structural_overlap_census`` /
``hidden_fraction`` (``spmd``'s collectives are synchronous block copies
on one stream: nothing is hidden). The budget metrics change with it:
``custom_calls`` is the port's one floor (a path that stops launching its
hand kernels regresses DOWN), every other metric a ceiling.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import threading
import weakref
from typing import List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "DispatchCensus", "chunk_body", "collective_census",
    "grid_layout_census", "graph_census",
    "budget_metrics", "kernel_class", "trace_census", "profile_census",
    "BUDGET_MAX_METRICS", "BUDGET_MIN_METRICS",
]

FFT_OPS = ("_fft_r2c", "_fft_c2r", "_fft_c2c")
DOT_OPS = ("mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv",
           "dot", "vdot")
SCATTER_OPS = ("index_add", "index_add_", "scatter_add", "scatter_add_",
               "scatter_reduce", "scatter_reduce_")
INDEX_PUT_OPS = ("index_put", "index_put_", "_index_put_impl_")
GATHER_OPS = ("index", "index_select", "gather", "take")
SYNC_OPS = ("_local_scalar_dense", "is_nonzero", "equal", "nonzero",
            "masked_select", "unique", "_unique", "_unique2",
            "unique_dim", "unique_consecutive")
# the reference's explicit collectives (pbroadcast has no port
# counterpart: a replicated block is a plain copy)
COLLECTIVE_PRIMS = ("ppermute", "psum", "all_gather", "all_to_all")

_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
_MAX_SITES = 32           # detail records kept per list


def _nbytes(t) -> int:
    return int(t.numel() * t.element_size()) \
        if isinstance(t, torch.Tensor) else 0


def _tree_bytes(x) -> int:
    """Bytes of every tensor in ``x`` (a tensor, or lists and tuples of
    them)."""
    if isinstance(x, (list, tuple)):
        return sum(_tree_bytes(v) for v in x)
    return _nbytes(x)


def _is_float(dtype) -> bool:
    return dtype in _FLOATS


def _width(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# depth of the chunk_body() scopes open now (a plain int, not
# thread-local: a chunk's backward on the autograd thread is in the chunk)
_CHUNK = [0]


@contextlib.contextmanager
def chunk_body():
    """Mark the enclosed ops as a driver chunk's body: their host syncs
    count in ``host_syncs_in_chunk`` as well."""
    _CHUNK[0] += 1
    try:
        yield
    finally:
        _CHUNK[0] -= 1


def _empty_counts() -> dict:
    out = {"fft_ops": 0, "fft_bytes": 0,
           "dot_lhs_bytes": 0, "dot_rhs_bytes": 0, "dot_out_bytes": 0,
           "dot_count": 0, "dot_flops": 0,
           "scatter_ops": 0, "gather_ops": 0,
           "convert_ops": 0, "f64_widenings": 0, "roundtrip_chains": 0,
           "host_syncs": 0, "host_syncs_in_chunk": 0,
           "host_copies": 0, "host_copies_in_chunk": 0,
           "bytes_accessed": 0, "aten_ops": 0}
    return out


class DispatchCensus(TorchDispatchMode):
    """The dispatch front end: counts (module docstring) of every aten
    op run under the mode, on every thread that runs under it.
    ``counts`` holds the flat numbers; ``fft_transforms``,
    ``convert_pairs`` and ``widening_sites`` the detail."""

    def __init__(self):
        super().__init__()
        self.counts = _empty_counts()
        self.fft_transforms: List[dict] = []
        self.convert_pairs: dict = {}
        self.widening_sites: List[dict] = []
        self.threads = set()
        # id(tensor) -> (weakref, source dtype) of each convert's output
        self._produced: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if not (func.is_view or name == "_unsafe_view"):
            self.counts["bytes_accessed"] += (
                _tree_bytes(args) + _tree_bytes(tuple(kwargs.values()))
                + _tree_bytes(out))
        self._count(name, args, kwargs, out)
        return out

    # -- the rules ---------------------------------------------------------
    def _count(self, name, args, kwargs, out) -> None:
        c = self.counts
        c["aten_ops"] += 1
        counted = True
        if name in FFT_OPS:
            ib, ob = _nbytes(args[0]), _nbytes(out)
            c["fft_ops"] += 1
            c["fft_bytes"] += ib + ob
            if len(self.fft_transforms) < _MAX_SITES:
                self.fft_transforms.append({
                    "kind": name.lstrip("_"),
                    "in_shape": list(args[0].shape),
                    "in_bytes": ib, "out_bytes": ob})
        elif name in DOT_OPS:
            self._count_dot(name, args, out)
        elif name in SCATTER_OPS:
            c["scatter_ops"] += 1
        elif name in INDEX_PUT_OPS:
            acc = kwargs.get("accumulate",
                             args[3] if len(args) > 3 else False)
            c["scatter_ops"] += int(bool(acc))
            counted = bool(acc)
        elif name in GATHER_OPS:
            c["gather_ops"] += 1
            if name == "index" and any(
                    isinstance(i, torch.Tensor)
                    and i.dtype in (torch.bool, torch.uint8)
                    for i in (args[1] if len(args) > 1 else ())):
                self._sync(copy=False)       # a mask's data-dependent shape
        elif name in SYNC_OPS:
            self._sync(copy=False)
        elif name in ("_to_copy", "copy_"):
            counted = self._count_copy(name, args, kwargs, out)
        else:
            counted = self._implicit_widening(name, args, out)
        if counted:
            self.threads.add(threading.get_ident())

    def _count_dot(self, name, args, out) -> None:
        c = self.counts
        if name in ("addmm", "baddbmm", "addbmm", "addmv"):
            lhs, rhs = args[1], args[2]
        else:
            lhs, rhs = args[0], args[1]
        k = int(lhs.shape[-1]) if lhs.ndim else 1
        c["dot_lhs_bytes"] += _nbytes(lhs)
        c["dot_rhs_bytes"] += _nbytes(rhs)
        c["dot_out_bytes"] += _nbytes(out)
        c["dot_flops"] += 2 * int(out.numel()) * k
        c["dot_count"] += 1

    def _sync(self, copy: bool) -> None:
        c = self.counts
        c["host_syncs"] += 1
        if copy:
            c["host_copies"] += 1
        if _CHUNK[0]:
            c["host_syncs_in_chunk"] += 1
            if copy:
                c["host_copies_in_chunk"] += 1

    def _count_copy(self, name, args, kwargs, out) -> bool:
        if name == "_to_copy":
            src_t = args[0]
            dst_dtype = kwargs.get("dtype") or src_t.dtype
            dst_dev = kwargs.get("device")
            dst = out
        else:                             # copy_(dst, src)
            dst, src_t = args[0], args[1]
            if not isinstance(src_t, torch.Tensor):
                return False
            dst_dtype, dst_dev = dst.dtype, dst.device
        counted = False
        if (src_t.is_cuda and dst_dev is not None
                and torch.device(dst_dev).type == "cpu"):
            self._sync(copy=True)
            counted = True
        src = src_t.dtype
        if dst_dtype == src:
            return counted
        c = self.counts
        key = f"{str(src).replace('torch.', '')}->" \
              f"{str(dst_dtype).replace('torch.', '')}"
        self.convert_pairs[key] = self.convert_pairs.get(key, 0) + 1
        c["convert_ops"] += 1
        if (_is_float(src) and dst_dtype == torch.float64
                and _width(dst_dtype) > _width(src)):
            self._widening(src, dst_dtype, src_t.shape, "convert")
        got = self._produced.get(id(src_t))
        if (got is not None and got[0]() is src_t and got[1] == dst_dtype
                and _width(src) > _width(dst_dtype)):
            c["roundtrip_chains"] += 1   # x -> wider -> x computed nothing
        if isinstance(dst, torch.Tensor):
            self._produced[id(dst)] = (weakref.ref(dst), src)
        return True

    def _implicit_widening(self, name, args, out) -> bool:
        if not (isinstance(out, torch.Tensor)
                and out.dtype == torch.float64):
            return False
        narrow = [a for a in args if isinstance(a, torch.Tensor)
                  and _is_float(a.dtype) and a.dtype != torch.float64]
        if not narrow:
            return False
        self._widening(narrow[0].dtype, out.dtype, narrow[0].shape,
                       f"promoted by {name}")
        return True

    def _widening(self, src, dst, shape, how) -> None:
        self.counts["f64_widenings"] += 1
        if len(self.widening_sites) < _MAX_SITES:
            self.widening_sites.append({
                "src": str(src).replace("torch.", ""),
                "dst": str(dst).replace("torch.", ""),
                "shape": list(shape), "how": how})


class _CollectiveRecorder:
    """Listener on ``parallel.spmd``'s collectives."""

    def __init__(self):
        self.counts = {"collective_prims": 0, "collective_bytes": 0}
        for p in COLLECTIVE_PRIMS:
            self.counts[f"{p}_prims"] = 0
            self.counts[f"{p}_bytes"] = 0

    def __call__(self, prim: str, block) -> None:
        nbytes = _nbytes(block)
        c = self.counts
        c.setdefault(f"{prim}_prims", 0)
        c.setdefault(f"{prim}_bytes", 0)
        c[f"{prim}_prims"] += 1
        c[f"{prim}_bytes"] += nbytes
        c["collective_prims"] += 1
        c["collective_bytes"] += nbytes


@contextlib.contextmanager
def grid_layout_census():
    """Count the whole-grid layouts in the block: every cut of a whole
    tensor into ``parallel.spmd.Blocks`` and every assembly of one
    (``whole_grid_layouts``; a block-resident step runs none), and the
    coarse multigrid levels' gathers and scatters apart."""
    from ibamr_tpu_torch.parallel import spmd

    counts = {"whole_grid_layouts": 0, "coarse_gathers": 0,
              "coarse_scatters": 0}

    def rec(kind, whole):
        if kind == "coarse_gather":
            counts["coarse_gathers"] += 1
        elif kind == "coarse_scatter":
            counts["coarse_scatters"] += 1
        else:
            counts["whole_grid_layouts"] += 1

    spmd.GRID_LISTENERS.append(rec)
    try:
        yield counts
    finally:
        spmd.GRID_LISTENERS.remove(rec)


@contextlib.contextmanager
def collective_census():
    """Count ``parallel.spmd``'s collectives called in the block; yields
    the dict it fills (the reference's ``collective_census`` keys)."""
    from ibamr_tpu_torch.parallel import spmd

    rec = _CollectiveRecorder()
    spmd.COLLECTIVE_LISTENERS.append(rec)
    try:
        yield rec.counts
    finally:
        spmd.COLLECTIVE_LISTENERS.remove(rec)


def _launches() -> dict:
    from ibamr_tpu_torch.ops import cuda_interaction
    from ibamr_tpu_torch.utils.cuda_graph import REPLAYS

    return dict(cuda_interaction.LAUNCHES, graph_replays=REPLAYS["count"])


def graph_census(fn, args, chunk: bool = False) -> dict:
    """Full census of ONE call ``fn(*args)``: the dispatch counts, the
    collectives, the whole-grid layouts, the hand-kernel launches
    (``custom_calls``, with ``custom_call_kernels`` by name) and the
    detail lists. ``chunk=True``
    counts the whole call as a driver chunk's body. The call runs as
    given (grad mode, device): warm caches first where the steady state
    is wanted (``contracts.measure_artifact`` does)."""
    before = _launches()
    with collective_census() as coll, grid_layout_census() as lay, \
            DispatchCensus() as cen:
        if chunk:
            with chunk_body():
                fn(*args)
        else:
            fn(*args)
    after = _launches()
    kernels = {k: after[k] - before.get(k, 0) for k in after}
    out = dict(cen.counts)
    out.update(coll)
    out.update(lay)
    out["graph_replays"] = kernels.pop("graph_replays")
    out["custom_calls"] = sum(kernels.values())
    out["custom_call_kernels"] = kernels
    out["fft_transforms"] = cen.fft_transforms
    out["convert_pairs"] = dict(cen.convert_pairs)
    out["widening_sites"] = cen.widening_sites
    out["census_threads"] = len(cen.threads)
    return out


# the flat metrics a budget may pin. Ceilings regress UP; the floor
# (custom_calls: a path that stops launching its hand kernels) regresses
# DOWN.
BUDGET_MAX_METRICS = (
    "scatter_ops", "gather_ops", "fft_ops", "dot_count",
    "host_syncs", "host_syncs_in_chunk",
    "convert_ops", "f64_widenings", "roundtrip_chains",
    "collective_prims", "collective_bytes",
    "ppermute_prims", "ppermute_bytes", "psum_prims", "psum_bytes",
    "all_gather_prims", "all_gather_bytes",
    "all_to_all_prims", "all_to_all_bytes", "whole_grid_layouts",
)
BUDGET_MIN_METRICS = ("custom_calls",)


def budget_metrics(census: dict) -> dict:
    """The budget-comparable slice of a :func:`graph_census` result."""
    keys = BUDGET_MAX_METRICS + BUDGET_MIN_METRICS
    return {k: int(census[k]) for k in keys if k in census}


# ---------------------------------------------------------------------------
# the trace front end (the card)
# ---------------------------------------------------------------------------

HAND_KERNELS = ("packed_spread", "packed_interp", "tile_spread",
                "tile_interp")
_KERNEL_CLASSES = (
    ("cufft", re.compile(r"fft|[sd]pRadix\d", re.IGNORECASE)),
    ("gemm", re.compile(r"gemm|gemv|xmma|cutlass|nvjet|splitKreduce",
                        re.IGNORECASE)),
    ("reduction", re.compile(r"reduce|Reduce|scan_kernel|cub::",
                             re.IGNORECASE)),
    ("copy", re.compile(r"copy|Copy|cat_|CatArray|memcpy|Memcpy|memset|"
                        r"Memset|fill", re.IGNORECASE)),
    ("elementwise", re.compile(r"elementwise|Elementwise",
                               re.IGNORECASE)),
)
_SYNC_CALL_RE = re.compile(r"^cuda(Stream|Device|Event)Synchronize$|"
                           r"^cu(Stream|Ctx|Event)Synchronize$")


def kernel_class(name: str) -> str:
    """The class of one device event by name: a hand kernel's own name,
    else ``cufft``, ``gemm``, ``reduction``, ``copy``, ``elementwise``
    or ``other`` (first match in that order)."""
    for k in HAND_KERNELS:
        if f"{k}_kernel" in name:
            return k
    for cls, pat in _KERNEL_CLASSES:
        if pat.search(name):
            return cls
    return "other"


def trace_census(trace: dict, steps: int = 1,
                 harness_syncs: int = 0) -> dict:
    """Per-step census of a ``torch.profiler`` Chrome trace covering
    ``steps`` steps: ``kernels`` (kernel events), ``kernels_by_class``,
    ``d2h_copies`` / ``h2d_copies`` (memcpy events by direction),
    ``syncs`` (the host's stream, event and device synchronizations less
    the ``harness_syncs`` the capture itself added) and ``device_ms``
    (the device events' summed duration). Figures are per step."""
    from ibamr_tpu_torch.obs.deviceprof import torch_device_events

    events, _ = torch_device_events(trace)
    by_class: dict = {}
    kernels = d2h = h2d = 0
    dur_us = 0.0
    for e in events:
        dur_us += float(e.get("dur") or 0.0)
        name = str(e.get("name", ""))
        if e.get("cat") == "gpu_memcpy":
            if "DtoH" in name:
                d2h += 1
            elif "HtoD" in name:
                h2d += 1
            continue
        if e.get("cat") != "kernel":
            continue
        kernels += 1
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0) + 1
    syncs = sum(1 for e in trace.get("traceEvents") or []
                if e.get("ph") == "X"
                and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and _SYNC_CALL_RE.match(str(e.get("name", ""))))
    syncs -= int(harness_syncs)
    s = float(max(int(steps), 1))
    return {"steps": int(steps), "kernels": kernels / s,
            "kernels_by_class": {k: v / s for k, v in
                                 sorted(by_class.items())},
            "d2h_copies": d2h / s, "h2d_copies": h2d / s,
            "syncs": syncs / s, "device_ms": dur_us / 1e3 / s}


def profile_census(fn, steps: int = 1, warmup: int = 1) -> dict:
    """:func:`trace_census` of ``steps`` calls of ``fn()`` on the card,
    after ``warmup`` calls: one ``torch.profiler`` capture of the CUDA
    activity, closed by one ``torch.cuda.synchronize`` (not counted)."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_census reads a CUDA trace: no CUDA "
                           "device is available")
    for _ in range(int(warmup)):
        fn()
    torch.cuda.synchronize()
    # CUDA activity alone: the kernels, memcpys and the runtime calls
    # (launches, synchronizations) are all the census reads
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(int(steps)):
            fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    return trace_census(trace, steps=steps, harness_syncs=1)
