"""K3: depthwise 3x3 convolution, stride 1, zero border, with its backward.

Counterpart of mmvqa_tpu/ops/pallas_depthwise.py. The CUDA kernels are
``csrc/depthwise3x3.cu`` (forward) and ``csrc/depthwise3x3_bwd.cu`` (dx and
dW in one pass); this module holds their wrappers, the
``torch.autograd.Function`` that joins them, and their plain PyTorch versions.

Layout, as the JAX function: ``x`` is (B, H, W, C), channels last, and ``w``
is (3, 3, C). The trunk's (B, C, H, W) maps lie channels-last in memory, so
their ``permute(0, 2, 3, 1)`` view goes in as it is. On a CUDA tensor the
map must be dense in that layout: the kernels read it as it lies and the
wrappers raise on anything else rather than copy. ``w`` may have any
strides (the convolution's (C, 1, 3, 3) weight goes in as a view).

The wrappers route by where ``x`` lies: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.

Mixed precision: ``w`` may be the fp32 master weight under a bf16 ``x``. The
kernels read the weight as it is and round it to x's dtype as they load it
(the JAX package casts it before the call), so no cast is launched, and the
fp32 dW reaches the master unrounded.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from mmvqa_tpu_torch.native import loader
from mmvqa_tpu_torch.ops import tiling

VEC = 4            # channels per thread where C and the addresses allow it
BLOCKS_PER_SM = 8  # blocks the launch aims at, per multiprocessor


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or tuple(w.shape) != (3, 3, x.shape[3]):
        raise ValueError(
            f"depthwise3x3: x {tuple(x.shape)} and w {tuple(w.shape)} are "
            "not (B, H, W, C) and (3, 3, C)"
        )


def depthwise3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: the library's grouped convolution. x (B, H, W, C), w
    (3, 3, C) cast to x's dtype; returns (B, H, W, C) in x's dtype."""
    C = x.shape[3]
    y = F.conv2d(x.permute(0, 3, 1, 2),
                 w.to(x.dtype).permute(2, 0, 1).reshape(C, 1, 3, 3),
                 padding=1, groups=C)
    return y.permute(0, 2, 3, 1)


def _shifted(a: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """out[b, h, w] = a[b, h + di, w + dj] inside the plane, else 0."""
    B, H, W, C = a.shape
    padded = F.pad(a, (0, 0, 1, 1, 1, 1))
    return padded[:, 1 + di:1 + di + H, 1 + dj:1 + dj + W]


def depthwise3x3_backward_reference(
    x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward, tap by tap as the kernel takes it: one
    shifted dy per tap feeds dx and dW. Returns dx (B, H, W, C) in x's dtype
    and dW (3, 3, C) in fp32."""
    xf, dyf = x.float(), dy.to(x.dtype).float()
    wf = w.to(x.dtype).float()
    dx = torch.zeros_like(xf)
    dw = torch.zeros(3, 3, x.shape[3], dtype=torch.float32, device=x.device)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            ds = _shifted(dyf, -di, -dj)
            dx += ds * wf[di + 1, dj + 1]
            dw[di + 1, dj + 1] = (xf * ds).sum(dim=(0, 1, 2))
    return dx.to(x.dtype), dw


def _plan(x: torch.Tensor, *others: torch.Tensor) -> tiling.ChannelPlan:
    B, H, W, C = x.shape
    vec = tiling.vector_width(C, VEC, x, *others)
    return tiling.channel_plan(B * H * W, C, vec,
                               BLOCKS_PER_SM * tiling.sm_count(x))


def _weight_rows(w: torch.Tensor) -> torch.Tensor:
    """w (3, 3, C) as the kernels' (9, C); a view for a dense w and for the
    convolution's (C, 1, 3, 3) weight permuted."""
    return w.reshape(9, w.shape[2])


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    loader.require_cuda("depthwise3x3", x, w)
    tiling.require_dense("depthwise3x3", x)
    B, H, W, C = x.shape
    w9 = _weight_rows(w)
    y = torch.empty_like(x)
    plan = _plan(x, y)
    ptr = loader.ptr
    code = loader.library().depthwise3x3_fwd(
        ptr(x), loader.DTYPE_CODES[x.dtype], ptr(w9),
        loader.DTYPE_CODES[w9.dtype], *w9.stride(), ptr(y), B, H, W, C,
        *plan, loader.stream_ptr())
    loader.check(code, "depthwise3x3_fwd")
    return y


def _launch_backward(x: torch.Tensor, w: torch.Tensor,
                     dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    name = "depthwise3x3 backward"
    loader.require_cuda(name, x, w, dy)
    tiling.require_dense(name, x)
    tiling.require_dense(name, dy)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} {dy.dtype} against x "
                         f"{tuple(x.shape)} {x.dtype}")
    B, H, W, C = x.shape
    w9 = _weight_rows(w)
    dx = torch.empty_like(x)
    plan = _plan(x, dy, dx)
    dwpart = torch.empty((plan.nrb, 9, C), device=x.device,
                         dtype=torch.float32)
    dw = torch.empty((3, 3, C), device=x.device, dtype=torch.float32)
    ptr = loader.ptr
    code = loader.library().depthwise3x3_bwd(
        ptr(x), loader.DTYPE_CODES[x.dtype], ptr(dy), ptr(w9),
        loader.DTYPE_CODES[w9.dtype], *w9.stride(), ptr(dx), ptr(dwpart),
        ptr(dw), B, H, W, C, *plan, loader.stream_ptr())
    loader.check(code, "depthwise3x3_bwd")
    return dx, dw


def depthwise3x3_backward(x: torch.Tensor, w: torch.Tensor,
                          dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dW (3, 3, C) fp32) for the gradient ``dy`` of
    ``depthwise3x3(x, w)``; all maps (B, H, W, C)."""
    _check_shapes(x, w)
    if x.device.type == "cpu":
        return depthwise3x3_backward_reference(x, w, dy)
    out = _launch_backward(x, w, dy)
    depthwise3x3.backward_launches += 1
    return out


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return depthwise3x3_reference(x, w)
    y = _launch(x, w)
    depthwise3x3.launches += 1
    return y


class _Depthwise3x3(torch.autograd.Function):
    """Saves x and w only, as the JAX package's ``_vjp_fwd``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        if x.device.type != "cpu" and not tiling.laid_out_as(dy, x):
            # autograd promises no layout for a gradient; the kernel reads
            # dy as x lies (dense, or _launch would have refused x)
            dy = dy.contiguous()
            depthwise3x3.gradient_copies += 1
        dx, dw = depthwise3x3_backward(x, w, dy)
        return dx, dw.to(w.dtype)


def depthwise3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 convolution, stride 1, zero border. x: (B, H, W, C),
    channels last (dense on the card); w: (3, 3, C), any strides, in x's
    dtype or the fp32 master of a bf16 x. fp32 accumulation, output in x's
    dtype. Differentiable in x and w through the backward kernel."""
    _check_shapes(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Depthwise3x3.apply(x, w)
    return _forward(x, w)


depthwise3x3.launches = 0
depthwise3x3.backward_launches = 0
depthwise3x3.gradient_copies = 0
