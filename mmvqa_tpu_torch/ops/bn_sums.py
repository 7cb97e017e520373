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

One launch a call: the last block of each channel tile adds the blocks'
partials in block order (its counters, one buffer a stream, wrap back to 0),
and the plan (``ops/tiling.py::channel_plan``) is one wave: BLOCKS_PER_SM
blocks on each SM, checked once per shape against what the card says an SM
holds.

The wrapper routes by where ``x`` lies: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from mmvqa_tpu_torch.native import loader
from mmvqa_tpu_torch.ops import tiling

VEC_BYTES = 16     # one load of a thread
# blocks of a wave on each SM, at most what the card holds: each thread keeps
# eight rows in flight, so more blocks only add partials for the last block
# to add (tools/probe_bn_sums.py: one block an SM 6.273 ms over the 156
# sites, two 6.562, as many as fit (three) 6.781-6.799)
BLOCKS_PER_SM = 1


def bn_backward_sums_reference(
    x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
    inv_std: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version (tools/bn_probe.py::xla_sums): materializes xhat."""
    xhat = (x.float() - mean) * inv_std
    d = dy.float()
    dims = tuple(range(x.dim() - 1))
    return d.sum(dim=dims), (d * xhat).sum(dim=dims)


_PLANS: Dict[tuple, tiling.ChannelPlan] = {}
# the last-block counters, one a channel tile
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _plan(x: torch.Tensor, rows: int, C: int, vec: int) -> tiling.ChannelPlan:
    """The launch plan for this shape: one wave of BLOCKS_PER_SM blocks an
    SM, or of as many as an SM of x's card holds where that is fewer (asked
    once per shape, then kept)."""
    key = (x.device, x.dtype, rows, C, vec)
    plan = _PLANS.get(key)
    if plan is None:
        draft = tiling.channel_plan(rows, C, vec, 1)
        slots = ctypes.c_int(0)
        loader.check(loader.library().bn_backward_sums_occupancy(
            loader.DTYPE_CODES[x.dtype], vec, draft.lanes * draft.row_groups,
            ctypes.byref(slots)), "bn_backward_sums occupancy")
        if slots.value < 1:
            raise RuntimeError("bn_backward_sums: no block fits an SM")
        plan = _PLANS[key] = tiling.channel_plan(
            rows, C, vec, min(slots.value, BLOCKS_PER_SM) * tiling.sm_count(x))
    return plan


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
    plan = _plan(x, rows, C, vec)
    mean, inv_std = mean.contiguous(), inv_std.contiguous()
    partial = torch.empty((plan.nrb, 2, C), device=x.device,
                          dtype=torch.float32)
    out = torch.empty((2, C), device=x.device, dtype=torch.float32)
    stream = tiling.current_stream(x.device)
    counter = tiling.stream_counters(_COUNTERS, x.device, stream, plan.ctiles)
    ptr = loader.ptr
    code = loader.library().bn_backward_sums(
        ptr(x), ptr(dy), loader.DTYPE_CODES[x.dtype], ptr(mean), ptr(inv_std),
        ptr(partial), ptr(out), ptr(counter), rows, C, *plan,
        ctypes.c_void_p(stream))
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
    tiling.refuse_dtensor("bn_backward_sums", x, dy, mean, inv_std)
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
