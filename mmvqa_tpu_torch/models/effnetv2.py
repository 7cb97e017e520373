"""EfficientNetV2-M trunk with per-stage feature taps.

Counterpart of mmvqa_tpu/models/effnetv2.py; module and parameter names
follow the Flax tree so that ``bridge.py`` maps one onto the other.

Layout. The public input is the JAX layout, NHWC. Inside, every map is a
(B, C, H, W) tensor that lies channels-last in memory: the input arrives as
a permuted view of the NHWC image, the library's convolutions and
elementwise kernels keep that format, and the hand-written kernels read
and write it. Their rows are the JAX package's: a map's
``permute(0, 2, 3, 1)`` view is the (B, H, W, C) that K3 takes, flattened it
is the (N, K) of K4 and the (N, C) of K5, with no copy. On the card a kernel
site raises on a map that is not dense in that layout.

The trunk's three hand-written kernels:

* K3 (``ops/depthwise.py``): every stride-1 3x3 depthwise convolution, in
  training and in inference (the JAX package routes by shape as well).
* K4 (``ops/conv_bn.py``), training only: every 1x1 convolution that feeds
  a BatchNorm (``pw_exp``, ``pw_proj``) returns the sums of its output with
  the output, and the BatchNorm takes its batch statistics from them.
* K5 (``ops/bn_sums.py``), training only: the two sums of every
  BatchNorm's backward.

What the port has to get right:

* TF-SAME padding. For stride 2 on an even map the pad is 0 before and 1
  after (224 -> 112), which a symmetric ``padding=1`` gets wrong, so the
  pads are computed from the input size and applied with ``F.pad``.
* BatchNorm with eps 1e-3 and Flax's training semantics (``BatchNorm2d``
  below): the running variance is updated with the BIASED batch variance.
* Squeeze-excite reduces relative to the block INPUT channels.
* The residual is added only when stride is 1 and in == out channels.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mmvqa_tpu_torch.models.layers import Conv2d
from mmvqa_tpu_torch.ops import tiling
from mmvqa_tpu_torch.ops.bn_sums import bn_backward_sums
from mmvqa_tpu_torch.ops.conv_bn import conv1x1_stats
from mmvqa_tpu_torch.ops.depthwise import depthwise3x3

# (block_type, repeats, kernel, stride, expand, out_ch, se_ratio)
V2_M_ARCH = (
    ("fused", 3, 3, 1, 1, 24, 0.0),
    ("fused", 5, 3, 2, 4, 48, 0.0),
    ("fused", 5, 3, 2, 4, 80, 0.0),
    ("mb", 7, 3, 2, 4, 160, 0.25),
    ("mb", 14, 3, 1, 6, 176, 0.25),
    ("mb", 18, 3, 2, 6, 304, 0.25),
    ("mb", 5, 3, 1, 6, 512, 0.25),
)
V2_M_STEM = 24
FIVE_TAP_STAGES = (0, 1, 2, 4, 6)
# one block per stage: the JAX package's test and dry-run trunk
TINY_EFFNET_ARCH = tuple((b, 1, k, s, e, c, se) for (b, _, k, s, e, c, se) in V2_M_ARCH)

BN_EPS = 1e-3
BN_MOMENTUM = 0.1  # torch's convention; Flax's momentum 0.9


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF/XLA 'SAME' padding of one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(Conv2d):
    """Conv2d with TF-SAME padding worked out per input size."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = False):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0,
                         groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = same_pads(x.shape[2], k, s)
        left, right = same_pads(x.shape[3], k, s)
        weight = self.weight.to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if top == bottom and left == right:
            return F.conv2d(x, weight, bias, s, (top, left),
                            groups=self.groups)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, weight, bias, s, 0, groups=self.groups)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """The (B, H, W, C) view of a (B, C, H, W) map. On the card the map must
    be dense in that layout (the kernels read it as it lies)."""
    v = x.permute(0, 2, 3, 1)
    if x.device.type != "cpu":
        tiling.require_dense("EffNetV2 trunk", v)
    return v


class DepthwiseConv2d(SameConv2d):
    """Depthwise convolution; the stride-1 3x3 sites go through K3, which
    reads the (C, 1, 3, 3) weight, the fp32 master included, as its
    (3, 3, C) view."""

    def __init__(self, ch: int, kernel: int, stride: int):
        super().__init__(ch, ch, kernel, stride, groups=ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_size != (3, 3) or self.stride != (1, 1):
            return super().forward(x)
        w = self.weight[:, 0].permute(1, 2, 0)
        return depthwise3x3(channels_last(x), w).permute(0, 3, 1, 2)


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode BatchNorm over a (B, C, H, W) map with Flax's numerics.

    Forward: mean and variance from the fp32 sums of x and x^2, the variance
    as flax.linen.normalization._compute_stats takes it (mean of squares
    less the squared mean, clipped at 0); the sums come from K4 where a 1x1
    convolution made x (``stats``), else from two library reductions that
    cast to fp32 as they read. Then ``(x - mean) * inv_std * weight + bias``
    in fp32 as one pass ``x * a + b`` per channel, rounded once to x's dtype.

    Backward: K5 gives s1 = sum dy and s2 = sum dy * xhat, which are the
    bias's and the scale's gradients, and
    ``dx = weight * inv_std * (dy - s1 / n - xhat * s2 / n)``, the full
    gradient with the path through the statistics in it, again as per-channel
    coefficients: ``dx = a * dy + p * x + q``. So ``stats`` gets no gradient.

    Saves x, the weight, mean and inv_std."""

    @staticmethod
    def forward(ctx, x, weight, bias, stats, eps):
        C = x.shape[1]
        n = x.numel() // C
        if stats is None:
            s1 = x.sum(dim=(0, 2, 3), dtype=torch.float32)
            s2 = torch.linalg.vector_norm(
                x, dim=(0, 2, 3), dtype=torch.float32).square()
        else:
            s1, s2 = stats[0], stats[1]
        mean = s1 / n
        var = torch.addcmul(s2 / n, mean, mean, value=-1.0).clamp_min_(0.0)
        inv_std = (var + eps).rsqrt_()
        a = inv_std * weight.float()
        b = torch.addcmul(bias.float(), mean, a, value=-1.0)
        out = torch.empty_like(x)
        torch.addcmul(b.view(1, C, 1, 1), x, a.view(1, C, 1, 1), out=out)
        ctx.save_for_backward(x, weight, mean, inv_std)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, inv_std = ctx.saved_tensors
        C = x.shape[1]
        n = x.numel() // C
        dy = dy.to(x.dtype)
        if x.device.type != "cpu" and not tiling.laid_out_as(dy, x):
            # autograd promises no layout for a gradient; K5 reads dy as x
            # lies
            dy = dy.contiguous(memory_format=torch.channels_last)
            BatchNorm2d.gradient_copies += 1
        s1, s2 = bn_backward_sums(channels_last(x), channels_last(dy), mean,
                                  inv_std)
        a = weight.float() * inv_std
        c = a * (-1.0 / n)
        p = torch.mul(c, inv_std).mul_(s2)
        q = torch.addcmul(c * s1, p, mean, value=-1.0)
        shape = (1, C, 1, 1)
        dx = torch.addcmul(q.view(shape), x, p.view(shape))  # fp32
        if dx.dtype == x.dtype:
            dx.addcmul_(dy, a.view(shape))
        else:
            t, dx = dx, torch.empty_like(x)
            torch.addcmul(t, dy, a.view(shape), out=dx)
        return dx, s2.to(weight.dtype), s1.to(weight.dtype), None, None


class BatchNorm2d(nn.Module):
    """BatchNorm with the semantics of the JAX package's Flax BatchNorm
    (mmvqa_tpu/models/effnetv2.py::_bn): eps 1e-3, Flax momentum 0.9.

    Eval mode normalises with the running statistics (the library's call).
    Train mode normalises with the batch statistics, reduced in fp32
    whatever the input's dtype (``_BatchNormTrain``; ``stats`` are K4's sums
    of the input where a 1x1 convolution made it), and updates the running
    statistics in place, the variance with the BIASED batch variance as Flax
    does; ``nn.BatchNorm2d`` would use the unbiased one. Parameters and
    statistics stay fp32."""

    gradient_copies = 0  # gradients that arrived in another layout than x

    def __init__(self, ch: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor,
                stats: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias, stats,
                                             self.eps)
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype),
                                   self.momentum)
        return y


def pointwise_bn(conv: Conv2d, bn: BatchNorm2d,
                 x: torch.Tensor) -> torch.Tensor:
    """``bn(conv(x))`` for a 1x1 convolution without bias. In training K4
    makes the product and the sums the BatchNorm needs in one pass."""
    if not bn.training:
        return bn(conv(x))
    B, K, H, W = x.shape
    C = conv.out_channels
    w = conv.weight.to(x.dtype).view(C, K).t()
    y, stats = conv1x1_stats(channels_last(x).reshape(B * H * W, K), w)
    return bn(y.view(B, H, W, C).permute(0, 3, 1, 2), stats)


class SqueezeExcite(nn.Module):
    def __init__(self, ch: int, reduced_ch: int):
        super().__init__()
        self.reduce = Conv2d(ch, reduced_ch, 1)
        self.expand = Conv2d(reduced_ch, ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 expand: int, se_ratio: float):
        super().__init__()
        mid = in_ch * expand
        self.pw_exp = Conv2d(in_ch, mid, 1, bias=False)
        self.bn1 = BatchNorm2d(mid)
        self.dw = DepthwiseConv2d(mid, kernel, stride)
        self.bn2 = BatchNorm2d(mid)
        self.se = (SqueezeExcite(mid, max(1, int(in_ch * se_ratio)))
                   if se_ratio > 0 else None)
        self.pw_proj = Conv2d(mid, out_ch, 1, bias=False)
        self.bn3 = BatchNorm2d(out_ch)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(pointwise_bn(self.pw_exp, self.bn1, x))
        h = F.silu(self.bn2(self.dw(h)))
        if self.se is not None:
            h = self.se(h)
        h = pointwise_bn(self.pw_proj, self.bn3, h)
        return h + x if self.residual else h


class FusedMBConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 expand: int):
        super().__init__()
        self.expand = expand
        if expand == 1:
            # one conv3x3 -> bn -> silu (timm's FusedMBConv e1 form)
            self.conv = SameConv2d(in_ch, out_ch, kernel, stride)
            self.bn1 = BatchNorm2d(out_ch)
        else:
            mid = in_ch * expand
            self.conv_exp = SameConv2d(in_ch, mid, kernel, stride)
            self.bn1 = BatchNorm2d(mid)
            self.pw_proj = Conv2d(mid, out_ch, 1, bias=False)
            self.bn2 = BatchNorm2d(out_ch)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.expand == 1:
            h = F.silu(self.bn1(self.conv(x)))
        else:
            h = F.silu(self.bn1(self.conv_exp(x)))
            h = pointwise_bn(self.pw_proj, self.bn2, h)
        return h + x if self.residual else h


class EffNetV2Features(nn.Module):
    """Run the trunk once; return all stage outputs, one (B, C, H, W) map
    per stage, channels-last in memory."""

    def __init__(self, arch: Sequence = V2_M_ARCH, stem_ch: int = V2_M_STEM):
        super().__init__()
        self.stem_conv = SameConv2d(3, stem_ch, 3, 2)
        self.stem_bn = BatchNorm2d(stem_ch)
        self.stages: List[List[str]] = []
        in_ch = stem_ch
        for si, (btype, reps, k, s, e, c, se) in enumerate(arch):
            names = []
            for bi in range(reps):
                stride = s if bi == 0 else 1
                if btype == "fused":
                    block = FusedMBConv(in_ch, c, k, stride, e)
                else:
                    block = MBConv(in_ch, c, k, stride, e, se)
                name = f"stage{si}_block{bi}"
                self.add_module(name, block)
                names.append(name)
                in_ch = c
            self.stages.append(names)

    def forward(self, x_nchw: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        # no copy for the permuted view of an NHWC image that MMBert passes
        x_nchw = x_nchw.contiguous(memory_format=torch.channels_last)
        h = F.silu(self.stem_bn(self.stem_conv(x_nchw)))
        taps = []
        for names in self.stages:
            for name in names:
                h = getattr(self, name)(h)
            taps.append(h)
        return tuple(taps)
