"""ResNet-152 trunk with five feature taps (counterpart of
mmvqa_tpu/models/resnet.py), the reference's default ``--cnn_encoder``.

The trunk runs once and returns ``(stem64@112, c256@56, c512@28, c1024@14,
c2048@7)`` at 224 px: the stem before the max-pool and the output of each
of the four stages. Module and parameter names follow the Flax tree
(``conv1``, ``bn1``, ``layer<s>_block<b>/{conv1..3, bn1..3,
downsample_conv, downsample_bn}``), so ``bridge.py`` maps one onto the
other.

Layout and kernels as in ``models/effnetv2.py``: every map is a
(B, C, H, W) tensor that lies channels-last in memory, and in training

* K4 (``pointwise_bn``): every stride-1 1x1 convolution that feeds a
  BatchNorm, ``conv1`` and ``conv3`` of every block and ``layer1``'s
  downsample: 101 sites in ResNet-152;
* K5 (``_BatchNormTrain``): the backward of every BatchNorm, the stem's, three
  a block and four downsamples: 155 sites.

The stem's 7x7, the 3x3s, the max-pool and the stride-2 downsamples are the
library's (cuDNN), as the JAX package computes them outside Pallas.

What differs from EfficientNetV2: padding is explicit and symmetric (7x7
stride 2 pad 3, 3x3 pad 1, max-pool 3 stride 2 pad 1 with -inf); the stride
of a block sits on its 3x3 ``conv2``; block 0 of every stage has a
downsample branch (stride 1 in ``layer1``); BatchNorm eps is 1e-5, with Flax
momentum 0.9 and the biased variance in the running statistics.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mmvqa_tpu_torch.models.effnetv2 import BatchNorm2d, pointwise_bn
from mmvqa_tpu_torch.models.layers import Conv2d

BN_EPS = 1e-5
RESNET152_STAGES = (3, 8, 36, 3)
STAGE_WIDTHS = (64, 128, 256, 512)
EXPANSION = 4
STEM_CH = 64
# the five taps' channels, in the trunk's output order
TAP_CHANNELS = (STEM_CH,) + tuple(w * EXPANSION for w in STAGE_WIDTHS)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, width: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        out_ch = width * EXPANSION
        self.stride = stride
        self.conv1 = Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width, eps=BN_EPS)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1,
                            bias=False)
        self.bn2 = BatchNorm2d(width, eps=BN_EPS)
        self.conv3 = Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = BatchNorm2d(out_ch, eps=BN_EPS)
        self.has_downsample = has_downsample
        if has_downsample:
            self.downsample_conv = Conv2d(in_ch, out_ch, 1, stride=stride,
                                          bias=False)
            self.downsample_bn = BatchNorm2d(out_ch, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(pointwise_bn(self.conv1, self.bn1, x))
        out = F.relu(self.bn2(self.conv2(out)))
        out = pointwise_bn(self.conv3, self.bn3, out)
        identity = x
        if self.has_downsample and self.stride == 1:
            identity = pointwise_bn(self.downsample_conv, self.downsample_bn,
                                    x)
        elif self.has_downsample:
            # stride 2: cuDNN reads the strided map where it lies, and the
            # BatchNorm takes its statistics from the library's reductions,
            # as at the EfficientNetV2 trunk's stride-2 convolutions. K4
            # would need the subsampled rows made dense first, a copy of
            # the quarter map forward and a scatter of its gradient backward.
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class ResNetFeatures(nn.Module):
    """Runs the trunk once; returns the five tapped (B, C, H, W) maps,
    channels-last in memory, shallowest first."""

    fsdp_split = True

    def fsdp_groups(self) -> List[List[str]]:
        """Under FSDP the stem, then each stage, gathers its leaves."""
        return [["conv1", "bn1"]] + self.stages

    def __init__(self, stage_sizes: Sequence[int] = RESNET152_STAGES):
        super().__init__()
        self.conv1 = Conv2d(3, STEM_CH, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(STEM_CH, eps=BN_EPS)
        self.stages = []
        in_ch = STEM_CH
        for si, (n_blocks, width) in enumerate(zip(stage_sizes, STAGE_WIDTHS)):
            names = []
            for bi in range(n_blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                name = f"layer{si + 1}_block{bi}"
                self.add_module(name, Bottleneck(in_ch, width, stride,
                                                 has_downsample=bi == 0))
                names.append(name)
                in_ch = width * EXPANSION
            self.stages.append(names)

    def forward(self, x_nchw: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        # no copy for the permuted view of an NHWC image that MMBert passes
        x_nchw = x_nchw.contiguous(memory_format=torch.channels_last)
        stem = F.relu(self.bn1(self.conv1(x_nchw)))
        h = F.max_pool2d(stem, 3, stride=2, padding=1)
        taps = [stem]
        for names in self.stages:
            for name in names:
                h = getattr(self, name)(h)
            taps.append(h)
        return tuple(taps)
