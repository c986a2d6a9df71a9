"""The (data, model) layout over the ranks — the port of
``tpgan_tpu/parallel/mesh.py``.

A JAX mesh is an array of devices; here it is an array of ranks, one
process each (``parallel.distributed``), with the process group of its
data axis. Only the data axis runs: a ``model`` axis over more than one
rank (tensor parallelism) is refused until its own slice (ROADMAP A12b).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist

from tpgan_tpu_torch.config import MeshConfig
from tpgan_tpu_torch.parallel.distributed import process_count, process_index


def local_device_count() -> int:
    """The ranks of the world, JAX's ``len(jax.devices())``."""
    return process_count()


def mesh_shape(cfg: MeshConfig, n: int) -> Tuple[int, int]:
    """``(data, model)`` for ``n`` devices, as JAX's ``make_mesh`` lays
    them out: ``data = -1`` takes every device the model axis leaves.
    Raises ``ValueError`` when ``model`` does not divide ``n`` or the
    layout does not cover ``n`` devices."""
    model = max(cfg.model, 1)
    if n % model:
        raise ValueError(f"{n} devices not divisible by model={model}")
    data = cfg.data if cfg.data != -1 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} does not cover {n} devices")
    return data, model


class Mesh:
    """The data axis over the world's ranks: ``shape`` ({data axis: d,
    model axis: 1}, as a JAX mesh's), ``axis_names``, this process's
    ``rank`` on the data axis and the axis's ``size``, and ``group``, the
    data axis's process group (None without one: a single process, where
    every collective is the identity and is skipped). A deep copy of a
    module that keeps the mesh (the synced BatchNorm) shares it."""

    def __init__(self, shape: Dict[str, int], axis_names: Tuple[str, str], group):
        self.shape = dict(shape)
        self.axis_names = axis_names
        self.group = group
        self.size = shape[axis_names[0]]
        self.rank = process_index()

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend(self.group) if self.group is not None else None

    @property
    def data_shard(self) -> Tuple[int, int]:
        """(this rank's index, the number of ranks) on the data axis: the
        slice of every global batch this rank keeps."""
        return self.rank, self.size

    def rows(self, global_rows: int) -> slice:
        """This rank's rows ``[r * b, (r + 1) * b)`` of a global batch of
        ``global_rows``; raises ``ValueError`` when the axis does not
        divide it."""
        if global_rows % self.size:
            raise ValueError(f"global batch {global_rows} not divisible by the data axis's "
                             f"{self.size} ranks")
        b = global_rows // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def __deepcopy__(self, memo) -> "Mesh":
        return self

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, backend={self.backend})"


def data_group(mesh: Optional[Mesh]):
    """(the data axis's process group, this rank's index on it, its
    ranks): (None, 0, 1) without a mesh, or on a mesh with no process
    group, where a step runs no collective."""
    if mesh is None or mesh.group is None:
        return None, 0, 1
    return mesh.group, mesh.rank, mesh.size


def make_mesh(cfg: Optional[MeshConfig] = None, devices: Optional[Sequence[int]] = None) -> Mesh:
    """The (data, model) layout over ``devices``: the ranks, every rank of
    the world by default (a JAX mesh takes every device). Raises JAX's
    ``ValueError`` when the layout does not fit the ranks (one process
    with ``mesh.data=2`` is refused, as JAX's mesh refuses a one-chip
    host), and ``NotImplementedError`` for a model axis over more than one
    rank."""
    cfg = cfg or MeshConfig()
    world = process_count()
    ranks = list(devices) if devices is not None else list(range(world))
    data, model = mesh_shape(cfg, len(ranks))
    if model > 1:
        raise NotImplementedError(
            f"mesh.model={model}: the tensor-parallel model axis is not ported yet (ROADMAP "
            "A12b, column- and row-parallel layers over DTensor); the port shards the data "
            "axis only: use mesh.model=1")
    if ranks != list(range(world)):
        raise ValueError(f"mesh {data}x{model} over ranks {ranks} does not cover the world's "
                         f"{world} ranks")
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh({cfg.data_axis: data, cfg.model_axis: model}, (cfg.data_axis, cfg.model_axis),
                group)
