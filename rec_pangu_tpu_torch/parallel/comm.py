"""The collectives of the mesh paths, each with the backward it needs stated.

``torch.distributed.nn.functional.all_reduce`` sums the cotangents in its
backward.  That is right over ``data``, where each rank's loss is its own
block's and the objective is their sum (the global BatchNorm's sums), and
wrong over ``model``: there every rank computes the same loss from the
reduced lookup, and a summing backward would hand each shard ``n_model``
times its gradient.  So:

* ``reduce_model``: sum over ``model`` in the forward, identity backward
  (the row-sharded lookup: each shard's rows are zero but for its own ids);
* ``reduce_data``: sum over ``data`` in the forward, sum in the backward
  (BatchNorm's batch sums);
* ``gather_rows``: the ranks' ``[n, ...]`` blocks of a group, concatenated in
  rank order (the fused update's cotangent rows and ids, predictions);
* ``gather_data``: ``gather_rows`` over ``data`` with autograd, for a loss
  term that couples the rows of the global batch (a contrastive loss over
  the batch, CMI's shared negatives, Re4's rolled rows): the backward sums
  the ranks' cotangents of the gathered rows and hands each rank its own
  rows' sum.  Each rank's loss then holds the term of the whole batch, and
  the summed, averaged gradients (``all_reduce_grads``) are the global
  batch's, as for ``reduce_data``;
* ``all_reduce_grads``: each gradient summed over ``data`` and divided by
  the group's size, in place.

None of them catches a failed collective: an error raises on the rank.
A group of one rank passes tensors through untouched.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist


def _size(group) -> int:
    return dist.get_world_size(group)


class _ReduceModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


class _ReduceData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def reduce_model(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group`` (the ``model`` axis); identity backward."""
    if _size(group) == 1:
        return x
    return _ReduceModel.apply(x, group)


def reduce_data(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group`` (the ``data`` axis); summing backward."""
    if _size(group) == 1:
        return x
    return _ReduceData.apply(x, group)


def gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' equal-shaped ``x`` concatenated along ``dim`` in the
    group's rank order (no autograd)."""
    n = _size(group)
    if n == 1:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group, ctx.rows = group, x.shape[0]
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        r = dist.get_group_rank(ctx.group, dist.get_rank())
        return out[r * ctx.rows:(r + 1) * ctx.rows], None


def gather_data(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' equal-shaped ``x`` [n, ...] concatenated on axis 0 in rank
    order; the backward sums the cotangents over ``group`` and takes the
    rank's rows."""
    if _size(group) == 1:
        return x
    return _GatherData.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group`` (no autograd)."""
    if _size(group) == 1:
        return x
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of ``x`` over ``group`` (no autograd)."""
    if _size(group) == 1:
        return x
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def all_reduce_grads(grads: Iterable[Optional[torch.Tensor]], group) -> None:
    """Each gradient summed over ``group`` and divided by its size, in
    place; None gradients are skipped (the same ones on every rank: the
    ranks run one graph)."""
    n = _size(group)
    if n == 1:
        return
    for g in grads:
        if g is None:
            continue
        if g.is_contiguous():
            dist.all_reduce(g, group=group)
        else:  # autograd.grad may hand back a transposed view: reduce a copy
            flat = g.contiguous()
            dist.all_reduce(flat, group=group)
            g.copy_(flat)
        g.div_(n)


def mean_over(value: torch.Tensor, group) -> torch.Tensor:
    """The mean of a scalar over ``group`` (a global loss from the blocks'
    mean losses), detached."""
    n = _size(group)
    if n == 1:
        return value.detach()
    out = value.detach().reshape(1).clone()
    dist.all_reduce(out, group=group)
    return (out / n).reshape(value.shape)
