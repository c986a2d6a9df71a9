"""Tensor parallelism over the mesh's ``model`` axis: the column- and
row-parallel convolutions, transposed convolutions and linear layers
that JAX's GSPMD derives from a ``model``-sharded kernel
(``tpgan_tpu/parallel/sharding.py``), written out over a process group.

Each sharded layer takes the whole (replicated) input and gives the
whole output, so every other op of a model runs as it does on one
device:

* **column-parallel** — the weight's output channels split over the
  model ranks: every rank computes its channels from the whole input
  (``copy_to_model``: the input's gradient is summed over the ranks),
  the channels are gathered, then the replicated bias is added. A
  grouped conv (the depthwise ones) takes its own groups' input channels
  (``split_to_model``) and runs with ``groups / model`` groups.
* **row-parallel** — the weight's input channels split: every rank takes
  its slice of the input's channels, computes a partial product, the
  partial products are summed over the ranks (``reduce_from_model``),
  then the bias is added once.

The layers of ``ops/blocks.py`` (``Conv2d``, ``ConvTranspose2d``,
``LinearBlock``) hold their placement as ``layer.tp`` (a
:class:`LayerShard`, set by :func:`shard_module`) and their local slice
of the weight; a layer whose ``tp`` is None runs the single-device code.
DTensor has no propagation rule for a convolution whose weight is
sharded by channel (torch registers ``aten.convolution`` with a
replicated weight only), hence these hand-written Functions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpgan_tpu_torch.parallel.collectives import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    split_to_model,
)
from tpgan_tpu_torch.parallel.mesh import Mesh

COLUMN = "column"
ROW = "row"


@dataclasses.dataclass(frozen=True)
class LayerShard:
    """A layer's placement on the model axis: ``kind`` (``column`` or
    ``row``), the port weight's sharded ``dim`` and the whole weight's
    ``shape``."""

    mesh: Mesh
    kind: str
    dim: int
    shape: Tuple[int, ...]


def weight_dims(layer: nn.Module) -> Tuple[int, int]:
    """(output dim, input dim) of a layer's weight in the port's layout:
    ``Conv2d`` OIHW (0, 1), ``ConvTranspose2d`` IOHW (1, 0), linear
    (out, in) (0, 1)."""
    from tpgan_tpu_torch.ops.blocks import ConvTranspose2d

    return (1, 0) if isinstance(layer, ConvTranspose2d) else (0, 1)


def jax_kernel_shape(layer: nn.Module, shape=None) -> Tuple[int, ...]:
    """The shape of the JAX kernel the layer's weight maps to (HWIO, (kh,
    kw, in, out) or (in, out)): JAX's rule reads its axis -1 (out) and -2
    (in / groups)."""
    shape = tuple(layer.weight.shape if shape is None else shape)
    out_dim, in_dim = weight_dims(layer)
    return (*shape[2:], shape[in_dim], shape[out_dim])


def layer_rule(layer: nn.Module, mesh: Mesh, min_shard_dim: int) -> Optional[LayerShard]:
    """JAX's ``infer_param_shardings`` rule for one layer's weight, decided
    on the JAX kernel's axes: column-parallel when its output dim is at
    least ``min_shard_dim`` and divisible by the model axis, else
    row-parallel when its contraction dim (input channels per group) is;
    None (replicated) otherwise or on a model axis of one rank."""
    m = mesh.model_size
    shape = tuple(layer.tp.shape if layer.tp is not None else layer.weight.shape)
    jshape = jax_kernel_shape(layer, shape)
    if m <= 1 or len(jshape) < 2:
        return None
    out_dim, in_dim = weight_dims(layer)
    if jshape[-1] >= min_shard_dim and jshape[-1] % m == 0:
        return LayerShard(mesh, COLUMN, out_dim, shape)
    if jshape[-2] >= min_shard_dim and jshape[-2] % m == 0:
        return LayerShard(mesh, ROW, in_dim, shape)
    return None


def sharded_layers(module: nn.Module):
    """(name, layer) of each conv, transposed conv and linear layer under
    ``module``."""
    from tpgan_tpu_torch.ops.blocks import Conv2d, ConvTranspose2d, LinearBlock

    for name, m in module.named_modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, LinearBlock)):
            yield name, m


def local_slice(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This model rank's slice of a whole tensor along ``dim``, a copy."""
    k = t.shape[dim] // mesh.model_size
    return t.narrow(dim, mesh.model_rank * k, k).clone()


def shard_module(module: nn.Module, mesh: Mesh, min_shard_dim: int = 256
                 ) -> Dict[str, LayerShard]:
    """Shard every conv, transposed-conv and linear weight of ``module``
    that JAX's rule shards (:func:`layer_rule`): ``parallel.place(module,
    infer_param_shardings(mesh, module, min_shard_dim=...))``. Each such
    weight ``Parameter`` keeps this model rank's slice (the same object,
    so an optimizer built over it still holds it) and its layer records
    the placement as ``layer.tp``; biases stay whole. Returns {weight
    name: placement}."""
    from tpgan_tpu_torch.parallel.sharding import infer_param_shardings, place

    place(module, infer_param_shardings(mesh, module, min_shard_dim=min_shard_dim))
    return {f"{name}.weight" if name else "weight": layer.tp
            for name, layer in sharded_layers(module) if layer.tp is not None}


def check_groups(layer: nn.Module, place: LayerShard) -> None:
    """Refuse a placement the grouped conv's forward cannot run."""
    groups = getattr(layer, "groups", 1)
    if groups == 1:
        return
    if place.kind == ROW or groups % place.mesh.model_size:
        raise NotImplementedError(
            f"a {place.kind}-parallel conv with groups={groups} over "
            f"{place.mesh.model_size} model ranks: only column-parallel grouped convs whose "
            "groups the model axis divides are sharded")


def _add_bias(y: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    if b is None:
        return y
    return y + b.view(1, -1, *([1] * (y.dim() - 2)))


def _parallel(place: LayerShard, x: torch.Tensor, local_op, b: Optional[torch.Tensor],
              split_input: bool = False) -> torch.Tensor:
    group = place.mesh.model_group
    if place.kind == COLUMN:
        x = split_to_model(x, 1, group) if split_input else copy_to_model(x, group)
        return _add_bias(gather_from_model(local_op(x), 1, group), b)
    return _add_bias(reduce_from_model(local_op(split_to_model(x, 1, group)), group), b)


def conv2d(place: LayerShard, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           stride, padding, groups: int = 1) -> torch.Tensor:
    """``F.conv2d(x, w_whole, b, stride, padding, groups=groups)`` from this
    rank's slice ``w`` of the weight, on the whole input ``x``."""
    local_groups = groups // place.mesh.model_size if groups > 1 else 1
    return _parallel(place, x, lambda v: F.conv2d(v, w, None, stride, padding,
                                                  groups=local_groups),
                     b, split_input=groups > 1)


def conv_transpose2d(place: LayerShard, x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor], stride, padding, output_padding) -> torch.Tensor:
    """``F.conv_transpose2d(x, w_whole, b, ...)`` from this rank's slice
    ``w`` of the IOHW weight."""
    return _parallel(place, x, lambda v: F.conv_transpose2d(v, w, None, stride, padding,
                                                            output_padding), b)


def linear(place: LayerShard, x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor]) -> torch.Tensor:
    """``F.linear(x, w_whole, b)`` from this rank's slice ``w`` of the
    (out, in) weight."""
    return _parallel(place, x, lambda v: F.linear(v, w), b)


def unsharded_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module`` with every sharded weight whole and no
    placement: the single-device module (every model rank calls it; the
    gathers are collectives)."""
    import copy

    from tpgan_tpu_torch.parallel.collectives import gather_tensor

    out = copy.deepcopy(module)
    for _name, layer in sharded_layers(out):
        place = getattr(layer, "tp", None)
        if place is None:
            continue
        with torch.no_grad():
            layer.weight.data = gather_tensor(layer.weight.data, place.dim,
                                              place.mesh.model_group)
        layer.tp = None
    return out
