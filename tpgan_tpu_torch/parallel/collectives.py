"""The collectives of the mesh's two axes: what GSPMD inserts for JAX's
``data``-sharded step (the gradient mean, the global metrics, the synced
BatchNorm statistics) and for its ``model``-sharded weights (the
column- and row-parallel layers of ``parallel.tensor_parallel``), written
out for ``torch.distributed``.

* :func:`all_reduce_sum` — a sum over the group that autograd
  differentiates, twice and more: its backward is the same sum of the
  cotangents (``torch.distributed.nn.functional.all_reduce`` is
  deprecated, and ``_functional_collectives`` is not autograd-aware). The
  synced BatchNorm (``ops/blocks.py``) takes its statistics through it,
  so the WGAN-GP penalty's double backward through a BatchNorm critic
  crosses the ranks as JAX's gradient of the global batch does.
* :func:`all_reduce_mean_` — the mean over the group, in place, of a list
  of tensors through one flat buffer per dtype: one collective per phase,
  not one per leaf. On the card under NCCL a CUDA graph captures it.
* :func:`broadcast_` — rank 0's values into every rank's tensors, in
  place, bucketed the same way.

The model axis's four, Megatron's "f" and "g" and the channel gather and
split, each an autograd Function whose backward applies another of the
four, so the GP's double backward crosses the ranks too. The ranks of a
model group hold replicas of one loss, not parts of a sum as the data
axis's do: the cotangent of a replicated tensor is the same on each of
them, and a sum over the group belongs where values are partial.

* :func:`copy_to_model` (f) — identity forward; the backward sums the
  ranks' partial cotangents (a replicated input read by sharded weights).
* :func:`reduce_from_model` (g) — the sum of the ranks' partial values;
  the backward passes the replicated cotangent on (a row-parallel
  product).
* :func:`gather_from_model` — each rank's slice along ``dim``
  concatenated in rank order; the backward keeps this rank's slice.
* :func:`split_to_model` — this rank's slice along ``dim``; the backward
  gathers.

Every rank must make the same calls in the same order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the group of x; dL/dx = sum over the group of dL/dy
    (every rank's y is the same sum, so every rank's loss reaches every
    rank's x). The backward calls this Function again, so a double
    backward crosses the ranks too."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, differentiable any number of
    times."""
    return _AllReduceSum.apply(x, group)


class _CopyToModel(torch.autograd.Function):
    """f: y = x; dL/dx = the sum over the group of dL/dy."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _ReduceFromModel.apply(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """g: y = the sum over the group of x; dL/dx = dL/dy."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _CopyToModel.apply(grad, ctx.group), None


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    k = x.shape[dim] // n
    return x.narrow(dim, r * k, k).contiguous()


class _GatherFromModel(torch.autograd.Function):
    """y = the ranks' x concatenated along ``dim``; dL/dx = this rank's
    slice of dL/dy."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.group = dim, group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _SplitToModel.apply(grad, ctx.dim, ctx.group), None, None


class _SplitToModel(torch.autograd.Function):
    """y = this rank's slice of x along ``dim``; dL/dx = the ranks' dL/dy
    concatenated."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _GatherFromModel.apply(grad, ctx.dim, ctx.group), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is, whose gradient is summed over ``group``."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``group``, whose gradient
    is the replicated one."""
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' slices of ``group`` concatenated along ``dim``."""
    return _GatherFromModel.apply(x, dim, group)


def split_to_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (equal slices, in rank
    order)."""
    return _SplitToModel.apply(x, dim, group)


@torch.no_grad()
def gather_tensor(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole of a tensor sharded along ``dim`` over ``group``, outside
    autograd (checkpoints, a state gathered for a test)."""
    flat = _on_backend_device(x.contiguous(), group)
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    return torch.cat(parts, dim).to(x.device)


def _buckets(tensors: Sequence[torch.Tensor]) -> Dict[Tuple[torch.dtype, torch.device],
                                                        List[torch.Tensor]]:
    out: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault((t.dtype, t.device), []).append(t)
    return out


def _unflatten_into(tensors: List[torch.Tensor], flat: torch.Tensor) -> None:
    pieces = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [p.view_as(t) for p, t in zip(pieces, tensors)])


def _on_backend_device(flat: torch.Tensor, group) -> torch.Tensor:
    """``flat`` where the group's backend takes it: NCCL moves only CUDA
    tensors, so a CPU bucket (Adam's step counts) goes through the card."""
    if flat.device.type == "cpu" and dist.get_backend(group) == "nccl":
        return flat.to(torch.device("cuda", torch.cuda.current_device()))
    return flat


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group) -> None:
    """Replace each tensor by its mean over ``group``, in place: one flat
    buffer and one all-reduce per dtype and device. Integer tensors are
    refused (their mean is not one)."""
    n = dist.get_world_size(group)
    for (dtype, _device), ts in _buckets(tensors).items():
        if not dtype.is_floating_point:
            raise TypeError(f"all_reduce_mean_ takes floating tensors, got {dtype}")
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        _unflatten_into(ts, flat.div_(n))


def all_reduce_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """A dict of 0-d metrics as their means over ``group``, each in its own
    dtype: one collective, in float64."""
    values = torch.stack([v.detach().double() for v in metrics.values()])
    all_reduce_mean_([values], group)
    return {k: values[i].to(v.dtype) for i, (k, v) in enumerate(metrics.items())}


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], group, src: int = 0) -> None:
    """Copy the group rank ``src``'s values into every rank's tensors, in
    place: one flat buffer and one broadcast per dtype and device."""
    root = dist.get_global_rank(group, src) if group is not None else src
    for _key, ts in _buckets(tensors).items():
        flat = torch.cat([t.reshape(-1) for t in ts])
        moved = _on_backend_device(flat, group)
        dist.broadcast(moved, src=root, group=group)
        if moved is not flat:
            flat.copy_(moved)
        _unflatten_into(ts, flat)
