"""Parallelism over ranks — the port of ``tpgan_tpu/parallel/``, its data
axis: the (data, model) layout over the ranks of a ``torch.distributed``
process group (:mod:`.mesh`), the placement of batches and state
(:mod:`.sharding`), the collectives a data-parallel step needs
(:mod:`.collectives`) and the per-process initialisation
(:mod:`.distributed`).

Where GSPMD derives the data axis's collectives from a sharded batch,
here the steps call them: each phase's gradient mean and the metrics are
all-reduced, and train-mode BatchNorm takes the global batch's
statistics (``ops.blocks.BatchNorm2d``, synced by the steps on a mesh of
more than one rank). The model axis (tensor parallelism) is ROADMAP
A12b."""

from tpgan_tpu_torch.parallel.mesh import Mesh, local_device_count, make_mesh, mesh_shape
from tpgan_tpu_torch.parallel.sharding import batch_shardings, place, replicated

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_shape",
    "local_device_count",
    "batch_shardings",
    "place",
    "replicated",
]
