"""EfficientNetV2-M trunk with per-stage feature taps.

Counterpart of mmvqa_tpu/models/effnetv2.py; module and parameter names
follow the Flax tree so that ``bridge.py`` maps one onto the other.
Activations are NCHW inside; the public input is the JAX layout, NHWC.

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

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mmvqa_tpu_torch.models.layers import Conv2d

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


class BatchNorm2d(nn.Module):
    """BatchNorm with the semantics of the JAX package's Flax BatchNorm
    (mmvqa_tpu/models/effnetv2.py::_bn): eps 1e-3, Flax momentum 0.9.

    Eval mode normalises with the running statistics. Train mode normalises
    with the batch statistics, reduced in fp32 whatever the input's dtype
    (the library's batch-norm kernel does the normalisation and its
    backward), and updates the running statistics in place, the variance
    with the BIASED batch variance as Flax does; ``nn.BatchNorm2d`` would
    use the unbiased one. Parameters and statistics stay fp32."""

    def __init__(self, ch: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # with momentum 1 the kernel leaves the batch mean and the UNBIASED
        # batch variance in the buffers it is given
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    self.momentum)
            self.running_var.lerp_(
                (var * ((n - 1) / n)).to(self.running_var.dtype),
                self.momentum)
        return y


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
        self.dw = SameConv2d(mid, mid, kernel, stride, groups=mid)
        self.bn2 = BatchNorm2d(mid)
        self.se = (SqueezeExcite(mid, max(1, int(in_ch * se_ratio)))
                   if se_ratio > 0 else None)
        self.pw_proj = Conv2d(mid, out_ch, 1, bias=False)
        self.bn3 = BatchNorm2d(out_ch)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.bn1(self.pw_exp(x)))
        h = F.silu(self.bn2(self.dw(h)))
        if self.se is not None:
            h = self.se(h)
        h = self.bn3(self.pw_proj(h))
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
            h = self.bn2(self.pw_proj(h))
        return h + x if self.residual else h


class EffNetV2Features(nn.Module):
    """Run the trunk once; return all stage outputs (NCHW), one per stage."""

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
        h = F.silu(self.stem_bn(self.stem_conv(x_nchw)))
        taps = []
        for names in self.stages:
            for name in names:
                h = getattr(self, name)(h)
            taps.append(h)
        return tuple(taps)
