"""Batches of independent simulations (see :mod:`.batch`).

The JAX package's other scaling axis, spatial domain decomposition
(``cfd2_tpu.parallel.spatial``), is not ported yet.
"""

from .batch import batched_initial_state, batched_multi_step, batched_step, shard_batch

__all__ = ["batched_step", "batched_multi_step", "batched_initial_state",
           "shard_batch"]
