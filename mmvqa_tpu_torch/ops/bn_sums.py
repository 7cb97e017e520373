"""K5: the two per-channel sums of a BatchNorm backward,
``sum dy`` and ``sum dy * xhat`` with ``xhat = (x - mean) * inv_std``.

The port's copy of tools/bn_probe.py (a script that runs on import and so
cannot be imported): the CUDA kernel ``csrc/bn_backward_sums.cu`` takes the
place of its ``pallas_sums``, the plain version here is its ``xla_sums``.

Layout: ``x`` and ``dy`` are channels-last maps, (..., C) with C the
unit-stride axis, as the probe's ``xla_sums`` takes them; the probe's Pallas
kernel wants them transposed to (C, N) first, the CUDA kernel reads them as
they lie. On a CUDA tensor both must be dense and of one dtype: the wrapper
raises otherwise rather than copy. ``mean`` and ``inv_std`` are fp32 (C).

The wrapper routes by where ``x`` lies: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mmvqa_tpu_torch.native import loader
from mmvqa_tpu_torch.ops import tiling

VEC_BYTES = 16     # one load of a thread
BLOCKS_PER_SM = 4  # blocks the launch aims at, per multiprocessor


def bn_backward_sums_reference(
    x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
    inv_std: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version (tools/bn_probe.py::xla_sums): materializes xhat."""
    xhat = (x.float() - mean) * inv_std
    d = dy.float()
    dims = tuple(range(x.dim() - 1))
    return d.sum(dim=dims), (d * xhat).sum(dim=dims)


def _launch(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
            inv_std: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    name = "bn_backward_sums"
    loader.require_cuda(name, x, dy, mean, inv_std)
    if dy.dtype != x.dtype:
        raise ValueError(f"{name}: x is {x.dtype}, dy is {dy.dtype}")
    if mean.dtype != torch.float32 or inv_std.dtype != torch.float32:
        raise ValueError(f"{name}: mean and inv_std must be fp32")
    tiling.require_dense(name, x)
    tiling.require_dense(name, dy)
    C = x.shape[-1]
    rows = x.numel() // C
    vec = tiling.vector_width(C, VEC_BYTES // x.element_size(), x, dy)
    plan = tiling.channel_plan(rows, C, vec,
                               BLOCKS_PER_SM * tiling.sm_count(x))
    mean, inv_std = mean.contiguous(), inv_std.contiguous()
    partial = torch.empty((plan.nrb, 2, C), device=x.device,
                          dtype=torch.float32)
    out = torch.empty((2, C), device=x.device, dtype=torch.float32)
    ptr = loader.ptr
    code = loader.library().bn_backward_sums(
        ptr(x), ptr(dy), loader.DTYPE_CODES[x.dtype], ptr(mean), ptr(inv_std),
        ptr(partial), ptr(out), rows, C, *plan, loader.stream_ptr())
    loader.check(code, "bn_backward_sums")
    return out[0], out[1]


def bn_backward_sums(
    x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
    inv_std: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dy: (..., C) channels-last maps of one shape (dense and of one
    dtype on the card); mean, inv_std: (C) fp32. Returns the fp32 (C) sums
    over every leading axis of dy and of dy * (x - mean) * inv_std: the
    gradients of a BatchNorm's bias and scale."""
    if x.shape != dy.shape or mean.shape != x.shape[-1:] \
            or inv_std.shape != mean.shape:
        raise ValueError(
            f"bn_backward_sums: x {tuple(x.shape)}, dy {tuple(dy.shape)}, "
            f"mean {tuple(mean.shape)}, inv_std {tuple(inv_std.shape)}"
        )
    if x.device.type == "cpu":
        return bn_backward_sums_reference(x, dy, mean, inv_std)
    out = _launch(x, dy, mean, inv_std)
    bn_backward_sums.launches += 1
    return out


bn_backward_sums.launches = 0
