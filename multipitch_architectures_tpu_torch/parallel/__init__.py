"""Parallelism: a device mesh, data- and tensor-parallel training, and
sharded windowed inference, driven by one process.

Counterpart of ``multipitch_architectures_tpu/parallel/``: a
``("data", "model")`` mesh of ``torch.device``s with

- ``data``: the batch splits over the shards; train-mode BatchNorm,
  dropout and cross-batch attention keep the global batch's semantics
  (``spmd``), and the gradients of the placed parameters sum back into
  the model's (autograd of the copies);
- ``model``: Megatron-style tensor parallelism of the transformer
  layers' attention projections and MLPs, the partial sums reduced
  over the axis.

One process drives every shard, in a thread each, and the collectives
are device copies and sums (``collectives``), so a mesh may also repeat
one device: logical shards, with the same arithmetic. Multi-process
training (``torch.distributed``, DDP) and several hosts are out of
scope.
"""

from .mesh import (Mesh, Placement, ShardedTensor, batch_sharding,
                   default_mesh, make_mesh, replicated, shard_params,
                   tensor_parallel_param_specs)
from .spmd import (apply_sharded, gather_rows, reduce_grads, replicate,
                   shard_leaves)

__all__ = [
    "make_mesh",
    "default_mesh",
    "batch_sharding",
    "replicated",
    "tensor_parallel_param_specs",
    "shard_params",
    "Mesh",
    "Placement",
    "ShardedTensor",
    "replicate",
    "apply_sharded",
    "gather_rows",
    "shard_leaves",
    "reduce_grads",
]
