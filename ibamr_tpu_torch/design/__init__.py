"""Inverse design: optimization through the solver (port of
``ibamr_tpu/design/``).

The gradient rides the port's adjoint Functions: the fused spectral
substep's (``solvers/spectral_plan.py``: its cotangents take the same
plan) and the packed transfers' (``ops/interaction_packed.py``: the
spread's cotangent is an interp through the same buckets), with
``checkpointed_step`` rematerializing each step and the
``ExecutableCache`` holding the gradient iterate as ``kind: grad_chunk``.
The hand-kernel transfer engines refuse autograd.
"""

from ibamr_tpu_torch.design.loop import (AdamState, DesignIter, DesignLoop,
                                         DesignResult, adam_init,
                                         adam_update, global_norm)
from ibamr_tpu_torch.design.eel_gait import build_eel, build_eel_gait_problem
from ibamr_tpu_torch.design.cantilever import build_cantilever_problem

__all__ = [
    "AdamState", "DesignIter", "DesignLoop", "DesignResult",
    "adam_init", "adam_update", "global_norm",
    "build_eel", "build_eel_gait_problem", "build_cantilever_problem",
]
