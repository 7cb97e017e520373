"""The layouts' collectives as differentiable operations on plain tensors,
over an axis of ``core.mesh.CURRENT`` ('data', 'model', 'context' or
'pipe').

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
  (reduce-scatter), as FSDP does; the same pair serves an activation that
  every rank uses in its own way (the token axis gathered over 'context'
  at the entry of an encoder that runs at full length);
* ``keep_block``: its inverse, this rank's block of such a tensor; the
  backward puts the gradient at the block's place and zeros elsewhere;
* ``ring_shift``: each rank sends its tensors to the next rank of the axis
  and takes the previous rank's (``core.distributed.exchange``); the
  backward shifts the gradients the other way.

On an axis of size 1 each is the identity. ``sum_over``, ``gather_over``
and ``shift_over`` are the same collectives without a gradient.
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
    if axis == mesh.CONTEXT_AXIS:
        return spec.context_group, spec.context_size, spec.context_rank
    if axis == mesh.PIPE_AXIS:
        return spec.pipe_group, spec.pipe_size, spec.pipe_rank
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


class _KeepBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        _, n, i = axis_info(axis)
        ctx.axis, ctx.dim, ctx.size = axis, dim, x.shape[dim]
        return block(x, dim, n, i)

    @staticmethod
    def backward(ctx, g):
        _, n, i = axis_info(ctx.axis)
        size = ctx.size // n
        d = ctx.dim % g.dim()
        pad = [0, 0] * (g.dim() - 1 - d) + [i * size, ctx.size - (i + 1) * size]
        return F.pad(g, pad), None, None


def _shift(tensors, axis: str, step: int):
    """Each tensor of this rank to the rank ``step`` places on along
    ``axis`` (cyclically), and the one ``step`` places back into a new
    tensor of its shape."""
    spec = mesh.CURRENT
    group, n, i = axis_info(axis)
    ranks = spec.axis_ranks(axis)
    dst, src = ranks[(i + step) % n], ranks[(i - step) % n]
    outs = [torch.empty_like(t, memory_format=torch.contiguous_format)
            for t in tensors]
    distributed.exchange([(t, dst) for t in tensors],
                         [(o, src) for o in outs], group)
    return outs


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, *tensors):
        ctx.axis = axis
        return tuple(_shift(tensors, axis, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_shift(grads, ctx.axis, -1))


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


def keep_block(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    return x if axis_size(axis) == 1 else _KeepBlock.apply(x, axis, dim)


def ring_shift(*tensors: torch.Tensor, axis: str):
    """The previous rank's ``tensors`` along ``axis``, as a tuple."""
    if axis_size(axis) == 1:
        return tensors
    return _RingShift.apply(axis, *tensors)


@torch.no_grad()
def shift_over(*tensors: torch.Tensor, axis: str, step: int = 1):
    """The tensors of the rank ``step`` places back along ``axis``."""
    if axis_size(axis) == 1:
        return tensors
    return tuple(_shift(tensors, axis, step))


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
