"""Multi-scale visual tokens: per-stage 1x1 projection -> activation -> GAP.

Counterpart of mmvqa_tpu/models/visual_tokens.py, ResNet-152 and
EfficientNetV2 branches. The trunk runs once; each tapped map goes through
the fused token head (K1, ``ops/token_head.py``), which never materializes
the (B, H*W, hidden) projection. Every tap of either trunk takes K1 on the
card, forward and backward: there is no size routing.

Token order follows the reference's encoders:

* resnet152 (``num_vis=5`` only): deepest-first, ``token_conv_0`` on the
  2048-channel map at 7x7 down to ``token_conv_4`` on the 64-channel stem at
  112x112 (224 px);
* tf_efficientnetv2_m: shallow-first, five taps at stages (0, 1, 2, 4, 6), or
  all seven stages (always SERF) for ``num_vis=7``.

Grad-CAM's tap (``perturb`` of the JAX module): ``features`` adds an NHWC
perturbation to the deepest tapped map (ResNet's 2048-channel map, token 0;
EfficientNetV2's last tap) before that map's token head, and returns the
tapped maps as NHWC views in token order, as the JAX module's
``stage_features``. ``tapped_maps`` and ``tokens_of`` split the trunk from
the heads, so that Grad-CAM runs the trunk once without a graph and
AblationCAM reruns from the tap.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mmvqa_tpu_torch.models.effnetv2 import (
    FIVE_TAP_STAGES,
    TINY_EFFNET_ARCH,
    V2_M_ARCH,
    EffNetV2Features,
)
from mmvqa_tpu_torch.models.resnet import (
    RESNET152_STAGES,
    TAP_CHANNELS,
    ResNetFeatures,
)
from mmvqa_tpu_torch.core.mesh import MODEL_AXIS
from mmvqa_tpu_torch.ops.token_head import fused_token_head
from mmvqa_tpu_torch.parallel.comm import copy_to, gather_from, scatter_to


def tap_positions(feat_nchw: torch.Tensor) -> torch.Tensor:
    """(B, K, H, W) map -> its (B, H*W, K) view, K1's input. The trunk takes
    its NHWC input as a permuted view, so its maps are channels-last in
    memory and this is a view with unit stride on K; a contiguous NCHW map
    gives unit stride on positions. K1 reads either by strides."""
    B, K, H, W = feat_nchw.shape
    return feat_nchw.reshape(B, K, H * W).transpose(1, 2)


class TokenHead(nn.Module):
    """Owns the projection weight (K, C), the K1 operand; the Flax tree
    stores it as ``token_conv_<i>/kernel`` (1, 1, K, C)."""

    def __init__(self, in_ch: int, hidden_size: int, act: str):
        super().__init__()
        self.act = act
        self.weight = nn.Parameter(torch.empty(in_ch, hidden_size))
        self.tp_split = 1

    def prepare_tp(self, tp: int) -> None:
        """Under tensor parallelism K1 runs on this rank's C / tp channels
        of the replicated weight (``fused_token_head_sharded`` of the JAX
        package, where C divides)."""
        self.tp_split = tp if self.weight.shape[1] % tp == 0 else 1

    def forward(self, feat_nchw: torch.Tensor) -> torch.Tensor:
        x = tap_positions(feat_nchw)
        act = self.act
        if act == "serf" and x.dtype == torch.bfloat16:
            act = "serf_fast"  # the bf16 numerics of ops.activations.serf
        # an fp32 master weight goes in as it is: K1 casts it, and its fp32
        # dW comes back unrounded
        if self.tp_split == 1:
            return fused_token_head(x, self.weight, act)
        w = scatter_to(self.weight, MODEL_AXIS, 1)
        tokens = fused_token_head(copy_to(x, MODEL_AXIS), w, act)
        return gather_from(tokens, MODEL_AXIS, 1)


class VisualTokenizer(nn.Module):
    fsdp_split = True

    def fsdp_groups(self):
        """Under FSDP the trunk's units, then the token heads together."""
        return [["trunk"], [f"token_conv_{i}" for i in range(len(self.taps))]]

    def __init__(self, cnn_encoder: str = "tf_efficientnetv2_m",
                 num_vis: int = 5, hidden_size: int = 768,
                 use_relu: bool = False, tiny: bool = False):
        super().__init__()
        if "resnet" in cnn_encoder:
            if num_vis != 5:
                raise ValueError("resnet152 supports num_vis=5 only")
            self.trunk = ResNetFeatures((1, 1, 1, 1) if tiny
                                        else RESNET152_STAGES)
            self.taps = (4, 3, 2, 1, 0)  # deepest first
            channels = TAP_CHANNELS
        elif "efficientnetv2" in cnn_encoder:
            if num_vis not in (5, 7):
                raise ValueError("efficientnetv2 supports num_vis in {5, 7}")
            arch = TINY_EFFNET_ARCH if tiny else V2_M_ARCH
            self.trunk = EffNetV2Features(arch=arch)
            self.taps = FIVE_TAP_STAGES if num_vis == 5 else tuple(range(7))
            channels = tuple(stage[5] for stage in arch)
        else:
            raise NotImplementedError(cnn_encoder)
        act = "relu" if (use_relu and num_vis == 5) else "serf"
        for i, stage in enumerate(self.taps):
            self.add_module(f"token_conv_{i}",
                            TokenHead(channels[stage], hidden_size, act))

    @property
    def deepest(self) -> int:
        """Index of the deepest tapped map in token order: ResNet's first,
        EfficientNetV2's last."""
        return 0 if self.taps[0] > self.taps[-1] else len(self.taps) - 1

    def tapped_maps(self, img_nhwc: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The trunk's tapped maps in token order, (B, K, H, W) views that
        are channels-last in memory."""
        stages = self.trunk(img_nhwc.permute(0, 3, 1, 2))
        return tuple(stages[stage] for stage in self.taps)

    def tokens_of(self, maps: Tuple[torch.Tensor, ...],
                  perturb: Optional[torch.Tensor] = None):
        """(tokens, maps): the token heads over ``maps``, with ``perturb``
        (B, h, w, C) added to the deepest map first."""
        if perturb is not None:
            d = self.deepest
            maps = (maps[:d] + (maps[d] + perturb.permute(0, 3, 1, 2),)
                    + maps[d + 1:])
        return tuple(getattr(self, f"token_conv_{i}")(m)
                     for i, m in enumerate(maps)), maps

    def features(self, img_nhwc: torch.Tensor,
                 perturb: Optional[torch.Tensor] = None):
        """(tokens, stage features): the features are the tapped maps as
        NHWC views (B, h, w, C) in token order, the deepest one with
        ``perturb`` added (the JAX module's ``__call__``)."""
        tokens, maps = self.tokens_of(self.tapped_maps(img_nhwc), perturb)
        return tokens, tuple(m.permute(0, 2, 3, 1) for m in maps)

    def forward(self, img_nhwc: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """img: (B, H, W, 3). Returns one (B, hidden) token per tap."""
        return self.tokens_of(self.tapped_maps(img_nhwc))[0]
