"""K4: a 1x1 convolution that returns the BatchNorm statistics of its output
from the same pass.

Counterpart of mmvqa_tpu/ops/pallas_conv_bn.py. The CUDA kernel is
``csrc/conv1x1_stats.cu``; this module holds its wrapper, the
``torch.autograd.Function`` around it and its plain PyTorch version.

Layout, as the JAX function: ``x`` is (N, K), the channels-last map
flattened to rows, ``w`` is (K, C), ``y`` is (N, C), ``stats`` is fp32 (2, C)
= [sum_n y, sum_n y^2]. On a CUDA tensor ``x`` must be dense (the wrapper
raises otherwise rather than copy); ``w`` may have any strides, so the
convolution's (C, K, 1, 1) weight goes in as its (K, C) view.

Both sums are taken from the unrounded fp32 product, in the kernel and in the
plain version alike (the JAX package's reference sums the rounded ``y``,
which is why its bf16 test allows 2e-2).

The backward is plain tensor code, as in the JAX package, whose
``_vjp_bwd`` is plain ``jnp``: two matrix products, with the statistics'
cotangent folded into dy where there is one. A BatchNorm whose own backward
returns the full gradient hands back none, and then the products run in the
maps' dtype with no fp32 copy of them.

The wrapper routes by where ``x`` lies: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mmvqa_tpu_torch.native import loader
from mmvqa_tpu_torch.ops import tiling

TILE_M = {torch.bfloat16: 128, torch.float32: 64}  # kBM, kFM of the source
BLOCKS_PER_SM = 4  # two resident, two waves


def _tile_n(dtype: torch.dtype, C: int) -> int:
    if dtype == torch.float32:
        return 64
    return 64 if C <= 64 else 128


def launch_plan(N: int, K: int, C: int, dtype: torch.dtype, sms: int) -> int:
    """The number of blocks along the rows. Each walks over every
    ``nrb``-th row tile and writes one (2, C) partial of the sums; there are
    enough of them to fill the card and no more than row tiles."""
    if min(N, K, C) < 1:
        raise ValueError(f"conv1x1_stats: empty shape N={N} K={K} C={C}")
    if max(N, K, C) > 2**31 - 1 - 128:
        raise ValueError(f"conv1x1_stats: N={N} K={K} C={C} beyond int32")
    mtiles = tiling.cdiv(N, TILE_M[dtype])
    ctiles = tiling.cdiv(C, _tile_n(dtype, C))
    nrb = max(1, min(mtiles, tiling.cdiv(BLOCKS_PER_SM * sms, ctiles)))
    if nrb > 65535:
        raise ValueError(f"conv1x1_stats: grid too large for N={N}, C={C}")
    return nrb


def _sums(yf: torch.Tensor) -> torch.Tensor:
    return torch.stack([yf.sum(dim=0), (yf * yf).sum(dim=0)])


def conv1x1_stats_reference(x: torch.Tensor,
                            w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the (N, C) product in fp32, its sums, then y rounded to
    x's dtype."""
    yf = x.float() @ w.float()
    return yf.to(x.dtype), _sums(yf)


def conv1x1_stats_backward(
    x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, dy: Optional[torch.Tensor],
    dstats: Optional[torch.Tensor], need_dx: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(dx, dW) of ``conv1x1_stats`` for the cotangents ``dy`` (N, C) and
    ``dstats`` (2, C), one of which may be None (zero)
    (mmvqa_tpu/ops/pallas_conv_bn.py::_vjp_bwd). d s1 / dy = 1 and
    d s2 / dy = 2 y. ``need_dx=False`` leaves dx out (None), for a map that
    wants no gradient."""
    if dstats is None:
        dy = dy.to(x.dtype)
        return (dy @ w.t() if need_dx else None), x.t() @ dy
    # Only the parity tests against the JAX function reach the rest: the
    # trunk's BatchNorm returns the full gradient itself and hands the sums
    # no cotangent. Written for clarity in fp32, not for speed.
    g = dstats[0][None, :] + 2.0 * y.float() * dstats[1][None, :]
    if dy is not None:
        g = g + dy.float()
    dx = (g @ w.float().t()).to(x.dtype) if need_dx else None
    dw = (x.float().t() @ g).to(w.dtype)
    return dx, dw


def _launch(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    loader.require_cuda("conv1x1_stats", x, w)
    if w.dtype != x.dtype:
        raise ValueError(f"conv1x1_stats: x is {x.dtype}, w is {w.dtype}")
    tiling.require_dense("conv1x1_stats", x)
    N, K = x.shape
    C = w.shape[1]
    nrb = launch_plan(N, K, C, x.dtype, tiling.sm_count(x))
    y = torch.empty((N, C), device=x.device, dtype=x.dtype)
    partial = torch.empty((nrb, 2, C), device=x.device, dtype=torch.float32)
    stats = torch.empty((2, C), device=x.device, dtype=torch.float32)
    ptr = loader.ptr
    code = loader.library().conv1x1_stats(
        ptr(x), loader.DTYPE_CODES[x.dtype], ptr(w), *w.stride(), ptr(y),
        ptr(partial), ptr(stats), N, K, C, nrb, loader.stream_ptr())
    loader.check(code, "conv1x1_stats")
    return y, stats


def _forward(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return conv1x1_stats_reference(x, w)
    out = _launch(x, w)
    conv1x1_stats.launches += 1
    return out


class _Conv1x1Stats(torch.autograd.Function):
    """Saves x, w and y, as the JAX package's ``_vjp_fwd``; y is the tensor
    the BatchNorm behind it saves too, so it costs no memory."""

    @staticmethod
    def forward(ctx, x, w):
        y, stats = _forward(x, w)
        ctx.save_for_backward(x, w, y)
        ctx.set_materialize_grads(False)
        return y, stats

    @staticmethod
    def backward(ctx, dy, dstats):
        x, w, y = ctx.saved_tensors
        dx, dw = conv1x1_stats_backward(x, w, y, dy, dstats,
                                        need_dx=ctx.needs_input_grad[0])
        return dx, dw


def conv1x1_stats(x: torch.Tensor,
                  w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N, K), rows of a channels-last map (dense on the card); w: (K, C)
    in x's dtype, any strides. Returns (y, stats): y = x @ w in x's dtype
    and the fp32 (2, C) sums [sum_n y, sum_n y^2] of the fp32 product.
    Differentiable in x and w, through y and through stats."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(
            f"conv1x1_stats: x {tuple(x.shape)} and w {tuple(w.shape)} are "
            "not (N, K) and (K, C)"
        )
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv1x1Stats.apply(x, w)
    return _forward(x, w)


conv1x1_stats.launches = 0
