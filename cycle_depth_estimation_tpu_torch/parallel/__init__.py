"""Data, ZeRO, tensor and spatial parallelism and pipelines of the port
(the JAX package's ``parallel/``): one process per rank, with the
collectives XLA inserts for the JAX package written out in
``collectives``. ``mesh`` starts the process group and lays the ranks out;
``zero`` splits optimizer state (and parameters) over ``data``; ``tensor``
splits the CycleGAN trunk's channels over ``model``; ``spatial`` its
images' height, with halo exchanges; ``pipeline`` runs a trunk as a GPipe
over ``stage``; ``dryrun`` runs every layout on spawned CPU ranks."""

from .mesh import (batch_sharding, host_shard_batch, make_mesh, replicated,
                   shard_batch)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "host_shard_batch",
]
