"""Batches of independent simulations (see :mod:`.batch`) and spatial domain
decomposition over ``torch.distributed`` ranks (:mod:`.spatial`, started by
:mod:`.launch`).  As in the JAX package, only the batch names are exported
here; the spatial helpers are imported from their module.
"""

from .batch import batched_initial_state, batched_multi_step, batched_step, shard_batch

__all__ = ["batched_step", "batched_multi_step", "batched_initial_state",
           "shard_batch"]
