"""Sharding over processes (port of ``absolutetrack_tpu/parallel/``).

The JAX package lays a ('data', 'model') ``jax.sharding.Mesh`` over the
devices of one process (several processes join through
``jax.distributed``). PyTorch's idiom for the same layout is one process
per device, joined in a ``torch.distributed`` process group (NCCL on
cards, gloo on the CPU), so the port's mesh is a grid over the ranks:

  data  : samples, windows and recordings, each rank its contiguous block
          (the analog of the reference's Pool over recordings and of the
          sampler's rank sharding); metric sums and gradients are summed
          over it;
  model : the views of a sample, each rank running the backbone on its
          own views; the features are all-gathered before FTL fusion and
          every model rank runs the rest.

``window_shard`` splits long sequences into windows that fold into the
batch, each starting with a cold memory.
"""

from .distributed import allreduce_metrics, init_distributed, process_shard
from .mesh import Mesh, make_mesh, shard_batch, window_shard

__all__ = [
    "Mesh",
    "allreduce_metrics",
    "init_distributed",
    "make_mesh",
    "process_shard",
    "shard_batch",
    "window_shard",
]
