"""The (data, model) layout over the ranks — the port of
``tpgan_tpu/parallel/mesh.py``.

A JAX mesh is an array of devices; here it is an array of ranks, one
process each (``parallel.distributed``), laid out as JAX's
``reshape(data, model)``: global rank ``d * model + m`` sits at data index
d and model index m. Each axis has its process group: the data group of a
rank is the ranks that share its m (they hold the same shards and average
their gradients), its model group the ranks that share its d (they hold
the shards of one replica and see the same rows).
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
    """A (data, model) layout over ranks: ``shape`` ({data axis: d, model
    axis: m}, as a JAX mesh's) and ``axis_names``.

    The data axis: this process's ``rank`` on it and its ``size``, and
    ``group``, its process group. The model axis: ``model_rank``,
    ``model_size`` and ``model_group``. ``world`` is the group of every
    rank of the mesh. With a model axis of one rank, ``group`` is
    ``world`` and ``model_group`` None; with more, a group is None where
    its axis has one rank; all are None without a process group. A
    collective over a None group is the identity and is skipped. By
    default the indices are those of this
    process's rank in JAX's ``reshape(data, model)`` order. A deep copy of
    a module that keeps the mesh (the synced BatchNorm, a sharded layer)
    shares it."""

    def __init__(self, shape: Dict[str, int], axis_names: Tuple[str, str], group,
                 model_group=None, world=None, index: Optional[int] = None):
        self.shape = dict(shape)
        self.axis_names = axis_names
        self.group = group
        self.model_group = model_group
        self.world = world
        self.size = shape[axis_names[0]]
        self.model_size = shape[axis_names[1]]
        index = process_index() if index is None else index
        self.rank, self.model_rank = divmod(index, self.model_size)

    @property
    def backend(self) -> Optional[str]:
        group = self.world if self.world is not None else self.group
        return dist.get_backend(group) if group is not None else None

    @property
    def is_main(self) -> bool:
        """True on the mesh's first rank (data 0, model 0), the one that
        writes checkpoints."""
        return self.rank == 0 and self.model_rank == 0

    @property
    def data_shard(self) -> Tuple[int, int]:
        """(this rank's index, the number of ranks) on the data axis: the
        slice of every global batch this rank keeps."""
        return self.rank, self.size

    def rows(self, global_rows: int) -> slice:
        """This rank's rows ``[r * b, (r + 1) * b)`` of a global batch of
        ``global_rows`` (r its data index: a model group shares its rows);
        raises ``ValueError`` when the axis does not divide it."""
        if global_rows % self.size:
            raise ValueError(f"global batch {global_rows} not divisible by the data axis's "
                             f"{self.size} ranks")
        b = global_rows // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def __deepcopy__(self, memo) -> "Mesh":
        return self

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, model_rank={self.model_rank}, "
                f"backend={self.backend})")


def data_group(mesh: Optional[Mesh]):
    """(the data axis's process group, this rank's index on it, its
    ranks): (None, 0, 1) without a mesh, or on a mesh with no data group,
    where a step runs no collective on the data axis."""
    if mesh is None or mesh.group is None:
        return None, 0, 1
    return mesh.group, mesh.rank, mesh.size


def model_group(mesh: Optional[Mesh]):
    """(the model axis's process group, this rank's index on it, its
    ranks): (None, 0, 1) without a mesh or a model axis of one rank."""
    if mesh is None or mesh.model_group is None:
        return None, 0, 1
    return mesh.model_group, mesh.model_rank, mesh.model_size


def _new_group(ranks: Sequence[int], local: bool):
    """A process group over ``ranks``: every rank of the world makes the
    call unless ``local`` (a mesh over some of them), where only the
    members do."""
    if local:
        return dist.new_group(list(ranks), use_local_synchronization=True)
    return dist.new_group(list(ranks))


def make_mesh(cfg: Optional[MeshConfig] = None, devices: Optional[Sequence[int]] = None) -> Mesh:
    """The (data, model) layout over ``devices``: ranks, every rank of the
    world by default (a JAX mesh takes every device), laid out as JAX's
    ``reshape(data, model)``. Raises JAX's ``ValueError`` when the layout
    does not fit the ranks (one process with ``mesh.data=2`` or
    ``mesh.model=2`` is refused, as JAX's mesh refuses a one-chip host).

    Every rank of ``devices`` calls it, in the same order as its other
    collectives; over the whole world each rank makes every axis group
    (``torch.distributed.new_group`` asks every rank to), over some of the
    world's ranks only they do, and this rank must be one of them."""
    cfg = cfg or MeshConfig()
    world = process_count()
    ranks = list(devices) if devices is not None else list(range(world))
    data, model = mesh_shape(cfg, len(ranks))
    if not set(ranks) <= set(range(world)) or len(set(ranks)) != len(ranks):
        raise ValueError(f"mesh {data}x{model} over ranks {ranks} does not cover the world's "
                         f"{world} ranks")
    shape = {cfg.data_axis: data, cfg.model_axis: model}
    axes = (cfg.data_axis, cfg.model_axis)
    if not dist.is_initialized():
        return Mesh(shape, axes, None)
    me = process_index()
    if me not in ranks:
        raise ValueError(f"rank {me} is not one of the mesh's ranks {ranks}")
    local = ranks != list(range(world))
    everyone = _new_group(ranks, local) if local else dist.group.WORLD
    if model == 1:  # the data axis alone: the mesh's group is its data group
        return Mesh(shape, axes, everyone, None, everyone, ranks.index(me))
    if data == 1:
        return Mesh(shape, axes, None, everyone, everyone, ranks.index(me))
    d_me, m_me = divmod(ranks.index(me), model)
    axis_groups = [("data", m, [ranks[d * model + m] for d in range(data)]) for m in range(model)]
    axis_groups += [("model", d, ranks[d * model:(d + 1) * model]) for d in range(data)]
    groups = {}
    for axis, at, members in axis_groups:
        if not local or me in members:
            groups[axis, at] = _new_group(members, local)
    return Mesh(shape, axes, groups["data", m_me], groups["model", d_me], everyone,
                ranks.index(me))
