"""Parallelism over ranks — the port of ``tpgan_tpu/parallel/``: the
(data, model) layout over the ranks of a ``torch.distributed`` process
group (:mod:`.mesh`), the placement of batches and state
(:mod:`.sharding`), the collectives of both axes (:mod:`.collectives`),
the column- and row-parallel layers of the model axis
(:mod:`.tensor_parallel`) and the per-process initialisation
(:mod:`.distributed`).

Where GSPMD derives the collectives from a sharded batch and sharded
kernels, here the steps and the layers call them: each phase's gradient
mean and the metrics are all-reduced over the data group, train-mode
BatchNorm takes the global batch's statistics
(``ops.blocks.BatchNorm2d``, synced over the data group), and a layer
whose weight is sharded over the model axis gathers or sums its output
over the model group."""

from tpgan_tpu_torch.parallel.mesh import Mesh, local_device_count, make_mesh, mesh_shape
from tpgan_tpu_torch.parallel.sharding import (
    Replicated,
    ShardDim,
    batch_shardings,
    infer_param_shardings,
    per_device_bytes,
    place,
    replicated,
    shard_gan_state,
    whole,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_shape",
    "local_device_count",
    "batch_shardings",
    "infer_param_shardings",
    "shard_gan_state",
    "per_device_bytes",
    "place",
    "replicated",
    "Replicated",
    "ShardDim",
    "whole",
]
