"""Multi-shard parallelism: spatial domain decomposition over a device
mesh (port of ``ibamr_tpu/parallel/``).

The reference lays a ``jax.sharding.Mesh`` over its devices inside one
process. The port's mesh (``spmd.py``) is the same shape: shards of one
process over a list of torch devices, per-shard bodies that see their
own block only, and explicit block-moving collectives. ``mesh.py`` holds
the layouts and the sharded steps, ``fftpar.py`` the pencil FFT,
``lagrangian.py`` the co-partitioned marker transfers and
``workload.py`` the host-side cost model.
"""

from ibamr_tpu_torch.parallel.lagrangian import ShardedInteraction  # noqa: F401
from ibamr_tpu_torch.parallel.mesh import (  # noqa: F401
    factor_devices,
    grid_pspec,
    make_mesh,
    make_sharded_ib_step,
    make_sharded_ins_step,
    make_sharded_step,
    shard_state,
)
