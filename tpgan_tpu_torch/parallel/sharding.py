"""Placement of batches and state over the mesh — the port of
``tpgan_tpu/parallel/sharding.py``.

* **Data parallel**: every batch leaf splits its leading (batch) axis over
  the ``data`` ranks; rank r keeps rows ``[r * b, (r + 1) * b)`` of the
  global batch, as ``addressable_shards`` of a JAX array placed with
  ``P("data")`` do. The train steps (``train/gan_trainer.py``,
  ``train/pretrain.py``) all-reduce each phase's gradient mean over the
  data group (``parallel.collectives``), which GSPMD derives on its own
  from the sharded batch.
* **Tensor parallel** (a ``model`` axis of more than one rank):
  :func:`infer_param_shardings` is JAX's shape rule, decided on the JAX
  kernel's axes (-1 out, -2 in) and mapped to the port's layouts
  (``Conv2d`` OIHW, ``ConvTranspose2d`` IOHW, linear (out, in)): a
  column-parallel weight splits its output dim, a row-parallel one its
  input dim, everything else (biases, BatchNorm, narrow layers) is
  replicated. Moments and EMA weights follow their weight. ``place``
  keeps each rank's slice of every sharded leaf and marks the layers
  (``parallel.tensor_parallel``), whose forwards then gather or reduce
  over the model group where GSPMD places the collectives.

Every rank holds the mesh's first rank's values after ``place``;
:func:`whole` gathers a sharded state to whole tensors for a while (a
checkpoint's write or read) and slices it again.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from tpgan_tpu_torch.parallel.collectives import all_reduce_mean_, broadcast_, gather_tensor
from tpgan_tpu_torch.parallel.mesh import Mesh
from tpgan_tpu_torch.parallel.tensor_parallel import (
    COLUMN,
    ROW,
    LayerShard,
    check_groups,
    layer_rule,
    local_slice,
    sharded_layers,
    weight_dims,
)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A leaf whose leading axis splits over the mesh's data ranks."""

    mesh: Mesh


@dataclasses.dataclass(frozen=True)
class Replicated:
    """State every rank holds whole, with rank 0's values."""

    mesh: Mesh


@dataclasses.dataclass(frozen=True)
class ShardDim:
    """A leaf split over the mesh's model ranks along its (port layout)
    dim ``dim``: each rank keeps its slice."""

    mesh: Mesh
    dim: int


Placement = Union[ShardDim, Replicated]


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


@dataclasses.dataclass(frozen=True)
class _Leaf:
    tensor: torch.Tensor
    layer: Optional[nn.Module]  # the conv / linear layer whose weight it is or follows
    is_weight: bool


def _module_leaves(module: nn.Module, prefix: str, out: Dict[str, _Leaf]) -> Dict[int, Any]:
    """The module's parameters and buffers under ``prefix``; returns
    {id(param): (its name, the layer whose weight it is or None)}."""
    owners = {id(layer.weight): layer for _, layer in sharded_layers(module)}
    params = {}
    for name, p in module.named_parameters():
        out[prefix + name] = _Leaf(p, owners.get(id(p)), id(p) in owners)
        params[id(p)] = (name, owners.get(id(p)))
    for name, b in module.named_buffers():
        out[prefix + name] = _Leaf(b, None, False)
    return params


def _optimizer_leaves(opt: torch.optim.Optimizer, params: Dict[int, Any], prefix: str,
                      out: Dict[str, _Leaf]) -> None:
    """The optimizer's per-parameter tensors (moments, step counts) under
    ``prefix.<param name>.<key>``: a moment (the parameter's shape)
    follows its parameter's layer."""
    for p, per_param in opt.state.items():
        name, layer = params[id(p)]
        for k, v in per_param.items():
            if torch.is_tensor(v):
                out[f"{prefix}{name}.{k}"] = _Leaf(
                    v, layer if v.shape == p.shape else None, False)


def _leaves(tree: Any) -> Dict[str, _Leaf]:
    """Every tensor of a module, a ``GANTrainState`` (``gen.*``, ``disc.*``,
    ``g_opt.*``, ``d_opt.*``, ``g_ema_params.*``) or a ``PretrainState``
    (``model.*``, ``optimizer.*``), keyed by name."""
    out: Dict[str, _Leaf] = {}
    if isinstance(tree, nn.Module):
        _module_leaves(tree, "", out)
    elif hasattr(tree, "gen") and hasattr(tree, "g_opt"):  # GANTrainState
        gen = _module_leaves(tree.gen, "gen.", out)
        disc = _module_leaves(tree.disc, "disc.", out)
        _optimizer_leaves(tree.g_opt, gen, "g_opt.", out)
        _optimizer_leaves(tree.d_opt, disc, "d_opt.", out)
        by_name = {name: layer for name, layer in gen.values()}
        for name, t in tree.g_ema_params.items():
            out[f"g_ema_params.{name}"] = _Leaf(t, by_name.get(name), False)
    elif hasattr(tree, "model") and hasattr(tree, "optimizer"):  # PretrainState
        params = _module_leaves(tree.model, "model.", out)
        _optimizer_leaves(tree.optimizer, params, "optimizer.", out)
    else:
        raise TypeError(f"no parameter tree in a {type(tree).__name__}: expected a module, a "
                        "GANTrainState or a PretrainState")
    return out


def infer_param_shardings(mesh: Mesh, params: Any, model_axis: str = "model",
                          min_shard_dim: int = 256) -> Dict[str, Placement]:
    """Per-leaf placement over the tensor-parallel ``model`` axis, JAX's
    ``infer_param_shardings``: {leaf name: ``ShardDim`` or ``Replicated``}
    for a module (its parameters and buffers), a ``GANTrainState`` or a
    ``PretrainState`` (keys as :func:`_leaves` names them).

    The rule is JAX's, on the JAX kernel's shape: a weight whose output
    dim (axis -1) is at least ``min_shard_dim`` and divisible by the
    model axis is column-parallel (``ShardDim`` on the port's output dim),
    else one whose contraction dim (axis -2: input channels per group,
    input features) is, row-parallel (on the port's input dim); every
    other leaf (1-D biases and BatchNorm leaves included) is replicated.
    An optimizer moment or an EMA weight takes its weight's placement, as
    JAX's rule, decided by shape, gives optimizer trees the same one."""
    if model_axis != mesh.axis_names[1]:
        raise ValueError(f"the mesh's model axis is {mesh.axis_names[1]!r}, not {model_axis!r}")
    out: Dict[str, Placement] = {}
    for key, leaf in _leaves(params).items():
        rule = layer_rule(leaf.layer, mesh, min_shard_dim) if leaf.layer is not None else None
        out[key] = ShardDim(mesh, rule.dim) if rule is not None else Replicated(mesh)
    return out


def shard_gan_state(mesh: Mesh, state: Any, min_shard_dim: int = 256) -> Dict[str, Placement]:
    """The placement of a ``GANTrainState``'s leaves: both models'
    weights, the EMA weights and both optimizers' moments get the TP rule;
    biases, BatchNorm statistics and step counts replicate."""
    return infer_param_shardings(mesh, state, min_shard_dim=min_shard_dim)


def per_device_bytes(tree: Any) -> int:
    """Bytes of ``tree`` this rank holds (``state_tensors``: a sharded
    leaf counts its slice), JAX's ``per_device_bytes``."""
    return sum(t.numel() * t.element_size() for t in state_tensors(tree))


def _slice_leaf(leaf: _Leaf, dim: int, mesh: Mesh) -> None:
    """Keep this rank's slice of a whole leaf, in place; a weight's layer
    gets its placement."""
    layer = leaf.layer
    if layer is not None and layer.tp is not None \
            and leaf.tensor.shape[dim] != layer.tp.shape[dim]:
        return  # sliced already
    if leaf.is_weight and layer.tp is None:
        kind = COLUMN if dim == weight_dims(layer)[0] else ROW
        placement = LayerShard(mesh, kind, dim, tuple(leaf.tensor.shape))
        check_groups(layer, placement)
        layer.tp = placement
        leaf.tensor.grad = None
    with torch.no_grad():
        leaf.tensor.data = local_slice(leaf.tensor.data, dim, mesh)


def place(tree: Any, shardings: Any) -> Any:
    """``tree`` placed by ``shardings``, JAX's ``device_put`` over a
    sharding tree.

    * ``Replicated`` (one for the whole tree): every tensor of the state
      (``state_tensors``) gets the mesh's first rank's values, in place
      (a broadcast per dtype); returns ``tree``.
    * A mapping of ``ShardDim`` / ``Replicated`` (``infer_param_shardings``,
      ``shard_gan_state``) over a whole state: the same broadcast, then
      each ``ShardDim`` leaf keeps this model rank's slice, in place (the
      same tensor objects: optimizers still hold them), and each sharded
      weight's layer its placement (``layer.tp``); returns ``tree``.
    * A mapping of ``RowShard`` (``batch_shardings``): a new mapping of
      this rank's rows of each leaf (tensors or numpy arrays), sliced
      where the leaf lies (views): the step copies only them to the
      rank's device."""
    if isinstance(shardings, Replicated):
        _broadcast(tree, shardings.mesh)
        return tree
    if shardings and all(isinstance(s, (ShardDim, Replicated)) for s in shardings.values()):
        _broadcast(tree, next(iter(shardings.values())).mesh)
        leaves = _leaves(tree)
        for key, s in shardings.items():
            if isinstance(s, ShardDim):
                _slice_leaf(leaves[key], s.dim, s.mesh)
        return tree
    return {k: v[shardings[k].mesh.rows(int(np.shape(v)[0]))] for k, v in tree.items()}


def _broadcast(tree: Any, mesh: Mesh) -> None:
    group = mesh.world if mesh.world is not None else mesh.group
    if group is not None:
        broadcast_(state_tensors(tree), group)


def mean_gradients_(module: nn.Module, mesh: Optional[Mesh]) -> None:
    """Replace each gradient of ``module``'s parameters by its mean over
    the ranks that hold the same leaf: a sharded weight's over the data
    group (the ranks of its slice), every other leaf's over the whole
    mesh. Each model rank computes a replicated leaf's gradient on its
    own; two processes' kernels on a card need not agree in the last bit
    (each may choose its own algorithm), and the mean keeps the replicas
    equal. One collective per group (``all_reduce_mean_``); none without a
    process group."""
    if mesh is None:
        return
    sharded = {id(layer.weight) for _, layer in sharded_layers(module) if layer.tp is not None}
    grads = [(id(p) in sharded, p.grad) for p in module.parameters() if p.grad is not None]
    wide = mesh.world if mesh.model_group is not None else mesh.group
    for group, ts in ((mesh.group, [g for s, g in grads if s]),
                      (wide, [g for s, g in grads if not s])):
        if group is not None and ts:
            all_reduce_mean_(ts, group)


def metrics_group(mesh: Optional[Mesh]):
    """The group a step's metrics are averaged over: the data group's
    ranks each hold their rows; with a model axis, the whole mesh (the
    model ranks' replicas of a metric agree but for the last bits)."""
    if mesh is None:
        return None
    return mesh.world if mesh.model_group is not None else mesh.group


def _sharded_leaves(tree: Any) -> List[Tuple[_Leaf, LayerShard]]:
    return [(leaf, leaf.layer.tp) for leaf in _leaves(tree).values()
            if leaf.layer is not None and leaf.layer.tp is not None]


@contextlib.contextmanager
def whole(tree: Any) -> Iterator[Any]:
    """Within the block, every sharded leaf of ``tree`` (a module or a
    state placed by ``place``) holds the whole tensor, gathered over its
    model group, so its ``state_dict`` is a single device's and a
    single device's loads into it; on leaving, each leaf keeps this
    rank's slice again (of what was loaded, if anything was: optimizer
    moments a ``load_state_dict`` made are sliced too). Every rank of
    the model group enters it (the gathers are collectives); a tree with
    no sharded leaf is left as it is. No forward runs inside it."""
    for leaf, tp in _sharded_leaves(tree):
        if leaf.tensor.shape[tp.dim] != tp.shape[tp.dim]:
            with torch.no_grad():
                leaf.tensor.data = gather_tensor(leaf.tensor.data, tp.dim, tp.mesh.model_group)
    try:
        yield tree
    finally:
        for leaf, tp in _sharded_leaves(tree):
            if leaf.tensor.shape[tp.dim] == tp.shape[tp.dim]:
                with torch.no_grad():
                    leaf.tensor.data = local_slice(leaf.tensor.data, tp.dim, tp.mesh)
