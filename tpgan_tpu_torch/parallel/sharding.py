"""Placement of batches and state over the data axis — the port of the
data-axis half of ``tpgan_tpu/parallel/sharding.py``.

* **Data parallel**: every batch leaf splits its leading (batch) axis over
  the ``data`` ranks; rank r keeps rows ``[r * b, (r + 1) * b)`` of the
  global batch, as ``addressable_shards`` of a JAX array placed with
  ``P("data")`` do. The parameters, BatchNorm statistics, EMA weights and
  optimizer state are replicated: every rank holds rank 0's values. The
  train steps (``train/gan_trainer.py``, ``train/pretrain.py``) then
  all-reduce each phase's gradient mean (``parallel.collectives``), which
  GSPMD derives on its own from the sharded batch.

The tensor-parallel half of the JAX module (``infer_param_shardings``,
``shard_gan_state``, ``per_device_bytes``: weights split over a ``model``
axis) waits for the model axis (ROADMAP A12b); ``parallel.mesh.make_mesh``
refuses a model axis over more than one rank until then.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from tpgan_tpu_torch.parallel.collectives import broadcast_
from tpgan_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A leaf whose leading axis splits over the mesh's data ranks."""

    mesh: Mesh


@dataclasses.dataclass(frozen=True)
class Replicated:
    """State every rank holds whole, with rank 0's values."""

    mesh: Mesh


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def batch_shardings(mesh: Mesh, tree: Mapping[str, Any], data_axis: str = "data"
                    ) -> Dict[str, RowShard]:
    """Leading-axis sharding for every leaf of a batch."""
    if data_axis != mesh.axis_names[0]:
        raise ValueError(f"the mesh's data axis is {mesh.axis_names[0]!r}, not {data_axis!r}")
    return {k: RowShard(mesh) for k in tree}


def shard_rows(rows: Sequence[Any], shard: Tuple[int, int]) -> Sequence[Any]:
    """Rank r of n's rows ``[r * v // n, (r + 1) * v // n)`` of a global
    batch of v rows (a list, array or tensor): ``[r * b, (r + 1) * b)``
    when n divides v, as a JAX array placed on a ``data`` mesh splits it."""
    r, n = shard
    v = len(rows)
    return rows[r * v // n:(r + 1) * v // n]


def state_tensors(obj: Any) -> List[torch.Tensor]:
    """Every tensor of a state, once each: a module's parameters and
    buffers, an optimizer's per-parameter state, and the tensors of
    dataclasses, mappings and sequences that hold them."""
    seen: Dict[int, torch.Tensor] = {}

    def walk(x: Any) -> None:
        if isinstance(x, torch.Tensor):
            seen.setdefault(id(x), x)
        elif isinstance(x, torch.nn.Module):
            for t in (*x.parameters(), *x.buffers()):
                walk(t)
        elif isinstance(x, torch.optim.Optimizer):
            for per_param in x.state.values():
                walk(per_param)
        elif isinstance(x, Mapping):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(obj)
    return list(seen.values())


def place(tree: Any, shardings: Any) -> Any:
    """``tree`` placed by ``shardings``, JAX's ``device_put`` over a
    sharding tree.

    * ``Replicated`` (one for the whole tree): every tensor of the state
      (``state_tensors``) gets rank 0's values, in place (a broadcast per
      dtype); returns ``tree``.
    * A mapping of ``RowShard`` (``batch_shardings``): a new mapping of
      this rank's rows of each leaf (tensors or numpy arrays), sliced
      where the leaf lies (views): the step copies only them to the
      rank's device."""
    if isinstance(shardings, Replicated):
        if shardings.mesh.group is not None:
            broadcast_(state_tensors(tree), shardings.mesh.group)
        return tree
    return {k: v[shardings[k].mesh.rows(int(np.shape(v)[0]))] for k, v in tree.items()}
