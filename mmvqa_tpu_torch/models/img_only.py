"""Image-only baseline classifier (counterpart of
mmvqa_tpu/models/img_only.py): the reference's ``Model_Keyword``
(vqamed2019/utils.py:306-324) on the port's trunks. The deepest map of the
ResNet-152 or EfficientNetV2 trunk is average-pooled, optionally
concatenated with a learned keyword embedding, and classified by one linear
``head``. No token head and no encoder: on the card the trunk's kernels run
(K4 and K5, and K3 on EfficientNetV2), never K1 or K2.

Module names follow the Flax tree (``trunk``, ``keyword_embed``, ``head``),
so ``bridge.py`` maps one onto the other. As for ``MMBert``: the weights
come from an explicit ``torch.Generator``, the model is built on the card
unless the caller names another device, ``compute_dtype`` casts the image
(and the keyword embedding) to the compute dtype with parameters kept in
``dtype``, and the trunk's BatchNorms follow the module's mode (``train()``
for batch statistics).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from mmvqa_tpu_torch.models.effnetv2 import (
    TINY_EFFNET_ARCH,
    V2_M_ARCH,
    EffNetV2Features,
)
from mmvqa_tpu_torch.models.layers import Linear
from mmvqa_tpu_torch.models.mmbert import default_device, init_weights
from mmvqa_tpu_torch.models.resnet import (
    RESNET152_STAGES,
    TAP_CHANNELS,
    ResNetFeatures,
)


def image_trunk(cnn_encoder: str, tiny: bool) -> Tuple[nn.Module, int]:
    """The trunk the JAX auxiliary models build for ``cnn_encoder`` (ResNet
    where the name says so, else EfficientNetV2; ``tiny``: one block a
    ResNet stage, or ``TINY_EFFNET_ARCH``) and its deepest map's channels."""
    if "resnet" in cnn_encoder:
        stages = (1, 1, 1, 1) if tiny else RESNET152_STAGES
        return ResNetFeatures(stages), TAP_CHANNELS[-1]
    arch = TINY_EFFNET_ARCH if tiny else V2_M_ARCH
    return EffNetV2Features(arch=arch), arch[-1][5]


def pooled_features(trunk: nn.Module, img: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, 3) NHWC -> the deepest map's global average (B, C)."""
    return trunk(img.permute(0, 3, 1, 2))[-1].mean(dim=(2, 3))


class ImageOnlyClassifier(nn.Module):
    def __init__(self, num_classes: int,
                 cnn_encoder: str = "tf_efficientnetv2_m",
                 num_keywords: int = 0, tiny: bool = False, *,
                 device: Union[str, torch.device, None] = None,
                 dtype: torch.dtype = torch.float32,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = default_device() if device is None else torch.device(device)
        self.num_keywords = num_keywords
        self.compute_dtype = compute_dtype
        self.trunk, ch = image_trunk(cnn_encoder, tiny)
        if num_keywords > 0:  # the keyword pathway
            self.keyword_embed = nn.Embedding(num_keywords, ch)
        self.head = Linear(ch * (2 if num_keywords > 0 else 1), num_classes)
        init_weights(self, torch.Generator().manual_seed(0)
                     if generator is None else generator)
        self.to(device=device, dtype=dtype)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    @property
    def dtype(self) -> torch.dtype:
        """The dtype activations are computed in."""
        return self.compute_dtype or self.head.weight.dtype

    def forward(self, img: torch.Tensor,
                keyword: Optional[torch.Tensor] = None) -> torch.Tensor:
        """img (B, S, S, 3) normalized NHWC, keyword (B,) ids where the
        model has the keyword pathway. Returns logits (B, num_classes)."""
        pooled = pooled_features(self.trunk, img.to(self.dtype))
        if self.num_keywords > 0:
            if keyword is None:
                raise ValueError("keyword ids required when num_keywords > 0")
            kemb = self.keyword_embed(keyword.long()).to(pooled.dtype)
            pooled = torch.cat([pooled, kemb], dim=-1)
        return self.head(pooled)
