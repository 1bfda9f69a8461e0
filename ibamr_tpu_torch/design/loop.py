"""The design loop: one cached gradient iterate and a hand-rolled Adam
(port of ``ibamr_tpu/design/loop.py``).

One design iteration is one call of a warm callable: the value and
gradient of the rollout objective (``torch.autograd.grad``) fused with
the Adam update, kept in the :class:`~ibamr_tpu_torch.serve.aot_cache.
ExecutableCache` as ``kind: grad_chunk``. Iteration 1 builds the entry (a
cache MISS, whose warm-up call runs one whole iterate, so its wall holds
two iterations); every later iteration is a HIT. Eager PyTorch traces
nothing, so the objective runs anew every iteration; what the cache
counts is builds (misses) and hits, recorded per iteration in each
:class:`DesignIter` and emitted as ``design_iter`` ledger records that
``tools/obs.py summary`` renders.

The iterate is pure: it takes gradients with ``torch.autograd.grad`` and
never accumulates into a leaf's ``.grad``, because the cache's warm-up
call runs it once at build and must leave nothing behind. The reverse
pass runs under PyTorch's deterministic algorithms
(``ops.interaction.deterministic``), so it is run-to-run reproducible.
The gradient goes through the substep's and the packed transfers'
adjoint Functions where the rollout runs them
(``solvers/spectral_plan.py``, ``ops/interaction_packed.py``); the
hand-kernel engines refuse autograd.

The optimizer is a self-contained Adam over a pytree of tensors
(``utils/tree.py``); :meth:`DesignLoop.value_and_grad_fn` serves an
external optimizer or a finite-difference check.
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ibamr_tpu_torch import obs as _obs
from ibamr_tpu_torch.ops.interaction import deterministic
from ibamr_tpu_torch.serve.aot_cache import (ExecutableCache, aot_compile,
                                             arg_signature, get_cache)
from ibamr_tpu_torch.utils.tree import leaves, tree_map

Params = Any  # a pytree of floating tensors


# -- Adam --------------------------------------------------------------------

class AdamState(NamedTuple):
    """Optimizer state, shaped like the params pytree."""
    step: torch.Tensor   # () int32 update count (bias correction)
    m: Params            # first moments
    v: Params            # second moments


def adam_init(params: Params) -> AdamState:
    first = leaves(params)[0]
    return AdamState(step=torch.zeros((), dtype=torch.int32,
                                      device=first.device),
                     m=tree_map(torch.zeros_like, params),
                     v=tree_map(torch.zeros_like, params))


def adam_update(params: Params, grads: Params, opt: AdamState, lr,
                b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> Tuple[Params, AdamState]:
    """One Adam step (Kingma & Ba 2015, bias-corrected)."""
    t = opt.step + 1
    m = tree_map(lambda mm, g: b1 * mm + (1.0 - b1) * g, opt.m, grads)
    v = tree_map(lambda vv, g: b2 * vv + (1.0 - b2) * g * g, opt.v, grads)

    def upd(p, mm, vv):
        tf = t.to(p.dtype)
        mhat = mm / (1.0 - torch.tensor(b1, dtype=p.dtype,
                                        device=p.device) ** tf)
        vhat = vv / (1.0 - torch.tensor(b2, dtype=p.dtype,
                                        device=p.device) ** tf)
        return p - torch.as_tensor(lr, dtype=p.dtype, device=p.device) \
            * mhat / (torch.sqrt(vhat) + eps)

    return tree_map(upd, params, m, v), AdamState(step=t, m=m, v=v)


def global_norm(grads: Params) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf: the logged grad scale."""
    return torch.sqrt(sum(torch.sum(torch.square(g))
                          for g in leaves(grads)))


# -- per-iteration record ----------------------------------------------------

class DesignIter(NamedTuple):
    iteration: int
    objective: float      # f(params) BEFORE this iteration's update
    grad_norm: float
    wall_s: float         # the whole iteration: lookup, call, sync
    cache_hits: int       # executable-cache hits this iteration
    cache_misses: int     # builds this iteration (0 when warm)


class DesignResult(NamedTuple):
    params: Params
    history: Tuple[DesignIter, ...]
    objective: float      # the last recorded objective value


# -- the loop ----------------------------------------------------------------

def _default_fingerprint(label: str, params: Params) -> dict:
    """Cache-key material for an objective with no integrator behind a
    flight recorder: the cache's ``KEY_FIELDS`` with the design label as
    the config digest (two objectives never share an entry), the torch
    version and the card's name, plus the params' dtype and device."""
    first = leaves(params)[0]
    cuda = first.device.type == "cuda"
    return {
        "config_digest": f"design:{label}",
        "integrator": "design_loop",
        "engine": None,
        "spectral_dtype": None,
        "mesh": None,
        "mesh_shape": None,
        "platform": first.device.type,
        "device_count": torch.cuda.device_count() if cuda else 1,
        "torch_version": torch.__version__,
        "device_kind": (torch.cuda.get_device_name(first.device) if cuda
                        else first.device.type),
        "dtype": str(first.dtype).replace("torch.", ""),
        "device": str(first.device),
    }


class DesignLoop:
    """Gradient-based optimization of a differentiable rollout objective.

    ``objective(params) -> scalar tensor`` builds the coupled method
    INSIDE itself so the design parameters flow into the physics (see
    ``design.eel_gait`` / ``design.cantilever``), advances with a Python
    loop over a :func:`~ibamr_tpu_torch.utils.hierarchy_driver.
    checkpointed_step`-wrapped step when the rollout is long, and runs no
    hand-kernel transfer engine (they refuse autograd)."""

    def __init__(self, objective: Callable[[Params], torch.Tensor],
                 params0: Params, *, lr: float = 1e-2,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 remat: Optional[str] = None,
                 cache: Optional[ExecutableCache] = None,
                 label: str = "design",
                 fingerprint: Optional[dict] = None):
        if remat is not None:
            from ibamr_tpu_torch.utils.hierarchy_driver import REMAT_POLICIES
            if remat not in REMAT_POLICIES:
                raise ValueError(
                    f"DesignLoop remat must be one of "
                    f"{sorted(REMAT_POLICIES)} or None, got {remat!r}")
        self.objective = objective
        self.params0 = params0
        self.lr = float(lr)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.remat = remat
        self.cache = cache if cache is not None else get_cache()
        self.label = label
        self._fp = (dict(fingerprint) if fingerprint is not None
                    else _default_fingerprint(label, params0))

    # -- pieces ----------------------------------------------------------
    def value_and_grad_fn(self) -> Callable:
        """``params -> (value, grads)``: the adjoint pass, for external
        optimizers and finite-difference checks. With ``remat`` the whole
        objective runs under ``checkpointed_step`` with that policy."""
        obj = self.objective
        if self.remat is not None:
            from ibamr_tpu_torch.utils.hierarchy_driver import \
                checkpointed_step
            obj = checkpointed_step(obj, self.remat)

        def value_and_grad(params):
            with torch.enable_grad():
                p = tree_map(lambda x: x.detach().requires_grad_(True),
                             params)
                value = obj(p)
                ls = leaves(p)
                with deterministic():
                    gs = torch.autograd.grad(value, ls, allow_unused=True)
            it = iter(g if g is not None else torch.zeros_like(x)
                      for g, x in zip(gs, ls))
            return value.detach(), tree_map(lambda _: next(it), p)

        return value_and_grad

    def iterate_fn(self) -> Callable:
        """``(params, opt, lr) -> (params', opt', value, grad_norm)``: the
        value and gradient and the Adam update in one callable."""
        vg = self.value_and_grad_fn()
        b1, b2, eps = self.b1, self.b2, self.eps

        def iterate(params, opt, lr):
            value, grads = vg(params)
            with torch.no_grad():
                new_params, new_opt = adam_update(params, grads, opt, lr,
                                                  b1=b1, b2=b2, eps=eps)
                return new_params, new_opt, value, global_norm(grads)

        return iterate

    def executable(self, params: Params, opt: AdamState, lr):
        """Get or build the iterate for this argument family through the
        executable cache as ``kind: grad_chunk``; returns ``(callable,
        entry)`` as ``cached_step`` does. The entry is a warm eager
        callable (the rollout reads values to the host)."""
        args = (params, opt, lr)
        extra = {"kind": "grad_chunk", "label": self.label,
                 "args": arg_signature(args)}
        entry = self.cache.get_or_compile(
            self._fp, lambda: aot_compile(self.iterate_fn(), args),
            extra=extra, label=f"design/{self.label}")
        return entry.executable, entry

    # -- run -------------------------------------------------------------
    def run(self, num_iters: int, params: Optional[Params] = None,
            opt: Optional[AdamState] = None) -> DesignResult:
        """``num_iters`` Adam iterations, each one's wall and cache-stat
        deltas recorded in the history and emitted as a ``design_iter``
        ledger record. ``history[i].objective`` is f(params) before
        update i: strict decrease means every update helped."""
        params = self.params0 if params is None else params
        first = leaves(params)[0]
        lr = torch.tensor(self.lr, dtype=first.dtype, device=first.device)
        opt = adam_init(params) if opt is None else opt
        history = []
        for i in range(int(num_iters)):
            s0 = self.cache.stats()
            t0 = time.perf_counter()
            # the lookup is inside the timed region: a warm iteration's
            # wall includes the cache serving it
            exe, _entry = self.executable(params, opt, lr)
            params, opt, value, gnorm = exe(params, opt, lr)
            value, gnorm = float(value), float(gnorm)   # the sync
            wall = time.perf_counter() - t0
            s1 = self.cache.stats()
            it = DesignIter(
                iteration=i, objective=value, grad_norm=gnorm, wall_s=wall,
                cache_hits=int(s1["hits"] - s0["hits"]),
                cache_misses=int(s1["misses"] - s0["misses"]))
            history.append(it)
            _obs.emit("design_iter", label=self.label,
                      iteration=it.iteration, objective=it.objective,
                      grad_norm=it.grad_norm, wall_s=it.wall_s,
                      cache_hits=it.cache_hits,
                      cache_misses=it.cache_misses)
        return DesignResult(params=params, history=tuple(history),
                            objective=history[-1].objective
                            if history else float("nan"))
