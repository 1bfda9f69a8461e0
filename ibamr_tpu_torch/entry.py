"""The port's single-device entry point, mirroring ``__graft_entry__.entry()``
of the JAX package: the flagship model's coupled IB step and example
arguments.

``entry()`` builds the ex4-equivalent 3D elastic shell at a small size
(32^3 grid, a 16 x 16 marker shell, mu = 0.05) on ``device`` (the GPU
unless ``device="cpu"``) and returns ``(fn, (state, dt))`` with
``fn(s, dt) = integ.step(s, dt)``. The reference's ``dryrun_multichip``
(the sharded paths over a device mesh) has its counterpart in
``chip_smoke.py``'s ``parallel`` phase and ``tests/test_torch_parallel.py``
(``ibamr_tpu_torch/parallel``).
"""

from __future__ import annotations

import torch


def entry(device="cuda", dtype=torch.float32):
    """Return ``(fn, example_args)``: one coupled IB step of the
    flagship shell and its arguments ``(state, 1e-3)``."""
    from ibamr_tpu_torch.models.shell3d import build_shell_example

    integ, state = build_shell_example(
        n_cells=32, n_lat=16, n_lon=16, mu=0.05, dtype=dtype, device=device)

    def fn(s, dt):
        return integ.step(s, dt)

    return fn, (state, 1e-3)
