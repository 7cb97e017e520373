"""The layouts' collectives as differentiable operations on plain tensors,
over an axis of ``core.mesh.CURRENT`` ('data' or 'model').

The kernels take plain local tensors (none is a registered operator, so a
DTensor could not dispatch through them): a layout is written as the
Megatron pairs below around unchanged kernel calls. Each rank holds the
gradient of one global loss with respect to its own tensors; a tensor that
every rank of an axis holds alike (replicated) has the same gradient on
each of them.

* ``copy_to``: the identity forward; the backward sums the ranks' partial
  gradients (a replicated input feeding a sharded computation).
* ``reduce_from``: sums the ranks' partial results; the identity backward.
* ``gather_from``: concatenates the ranks' shards along ``dim``; the
  backward keeps this rank's block.
* ``scatter_to``: keeps this rank's block of a replicated tensor; the
  backward gathers the blocks, so that every rank holds the whole gradient.
* ``gather_weight``: gathers a sharded parameter for use; the backward sums
  the ranks' partial gradients and keeps this rank's block
  (reduce-scatter), as FSDP does.

On an axis of size 1 each is the identity. ``sum_over`` and ``gather_over``
are the same collectives without a gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from mmvqa_tpu_torch.core import distributed, mesh


def axis_info(axis: str) -> Tuple[object, int, int]:
    """(group, size, this rank's coordinate) of ``axis`` in the current
    mesh; (None, 1, 0) without one."""
    spec = mesh.CURRENT
    if spec is None:
        return None, 1, 0
    if axis == mesh.DATA_AXIS:
        return spec.data_group, spec.data_size, spec.data_rank
    if axis == mesh.MODEL_AXIS:
        return spec.model_group, spec.model_size, spec.model_rank
    raise ValueError(f"unknown mesh axis {axis!r}")


def axis_size(axis: str) -> int:
    return axis_info(axis)[1]


def _format(t: torch.Tensor) -> torch.memory_format:
    """channels-last for a map that lies so (the trunk's kernels read maps
    in that layout), else row-major."""
    if t.dim() == 4 and not t.is_contiguous() \
            and t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def block(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Block ``i`` of ``n`` equal blocks of ``t`` along ``dim``, dense (a
    channels-last map stays channels-last)."""
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {n}")
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size).contiguous(memory_format=_format(t))


def _all_gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    fmt = _format(t)
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    distributed.all_gather_into_tensor(out, x, group)
    return out.movedim(0, dim).contiguous(memory_format=fmt)


def _reduce_scatter(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    distributed.reduce_scatter_tensor(out, x, group)
    return out.movedim(0, dim).contiguous()


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    return distributed.all_reduce(t.clone(memory_format=_format(t)), group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        group, _, _ = axis_info(ctx.axis)
        return _all_reduce(g, group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        group, _, _ = axis_info(axis)
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        group, n, _ = axis_info(axis)
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        _, n, i = axis_info(ctx.axis)
        return block(g, ctx.dim, n, i), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        _, n, i = axis_info(axis)
        ctx.axis, ctx.dim = axis, dim
        return block(x, dim, n, i)

    @staticmethod
    def backward(ctx, g):
        group, n, _ = axis_info(ctx.axis)
        return _all_gather(g, ctx.dim, group, n), None, None


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, axis, dim):
        group, n, _ = axis_info(axis)
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(w, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        group, n, _ = axis_info(ctx.axis)
        return _reduce_scatter(g, ctx.dim, group, n), None, None


def copy_to(x: torch.Tensor, axis: str) -> torch.Tensor:
    return x if axis_size(axis) == 1 else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: str) -> torch.Tensor:
    return x if axis_size(axis) == 1 else _ReduceFrom.apply(x, axis)


def gather_from(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    return x if axis_size(axis) == 1 else _GatherFrom.apply(x, axis, dim)


def scatter_to(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    return x if axis_size(axis) == 1 else _ScatterTo.apply(x, axis, dim)


def gather_weight(w: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    return w if axis_size(axis) == 1 else _GatherWeight.apply(w, axis, dim)


@torch.no_grad()
def sum_over(t: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of ``t`` over ``axis`` (a new tensor; ``t`` itself where the
    axis has one rank)."""
    group, n, _ = axis_info(axis)
    return t if n == 1 else _all_reduce(t, group)


@torch.no_grad()
def gather_over(t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """``t`` of every rank of ``axis`` concatenated along ``dim``."""
    group, n, _ = axis_info(axis)
    return t if n == 1 else _all_gather(t, dim, group, n)


def vocab_parallel_embedding(ids: torch.Tensor,
                             weight: torch.Tensor) -> torch.Tensor:
    """Lookup in a table whose rows are sharded over 'model' (Megatron's
    vocab-parallel embedding): each rank looks up the ids in its block of
    rows, zeros the others, and the ranks' results are summed."""
    _, n, i = axis_info(mesh.MODEL_AXIS)
    if n == 1:
        return F.embedding(ids, weight)
    rows = weight.shape[0]
    local = ids - i * rows
    inside = (local >= 0) & (local < rows)
    out = F.embedding(torch.where(inside, local, torch.zeros_like(local)),
                      weight)
    out = out * inside[..., None].to(out.dtype)
    return reduce_from(out, mesh.MODEL_AXIS)
