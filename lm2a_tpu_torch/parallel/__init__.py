"""Parallelism surface (port of ``lm2a_tpu/parallel/__init__.py``).

The mesh and batch layout live in :mod:`lm2a_tpu_torch.core.mesh`, the
process group and the collectives in :mod:`lm2a_tpu_torch.core.distributed`,
the data-parallel train and eval steps in
:mod:`lm2a_tpu_torch.training.train_step`. This package re-exports that
surface under the JAX package's names and holds the collective audit
(``audit.py``).
"""

from lm2a_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "batch_sharding",
    "make_mesh",
    "replicated",
    "shard_batch",
]
