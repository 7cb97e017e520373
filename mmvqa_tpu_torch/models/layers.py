"""Building blocks shared by the port's models: Flax's ``dtype=`` argument and
its explicit dropout keys, in PyTorch.

Mixed precision is done by explicit casts, not by ``torch.autocast``: every
layer here computes in the dtype of its INPUT and casts its fp32 master
parameters to that dtype on the way in, as a Flax module with
``dtype=bfloat16`` does. ``MMBert`` casts the image and the embedding output
to its compute dtype, and from there every activation keeps it. The casts are
differentiable, so gradients reach the fp32 masters in fp32. With parameters
and input of one dtype (the fp32 model, or the all-bf16 inference model) the
casts are no-ops.

Dropout draws from an explicit ``torch.Generator`` on the input's device
(``DropoutRng``), never from the global generator.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn


def _as(p: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    return None if p is None else p.to(x.dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _as(self.weight, x), _as(self.bias, x))


class LayerNorm(nn.LayerNorm):
    """Statistics in fp32 inside the kernel, output in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, _as(self.weight, x),
                            _as(self.bias, x), self.eps)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _as(self.weight, x), _as(self.bias, x))


class DropoutRng:
    """The model's dropout key: one seeded ``torch.Generator`` per device the
    model has run on, made at first use. Two models seeded alike draw the
    same masks."""

    def __init__(self, seed: int):
        self.manual_seed(seed)

    def manual_seed(self, seed: int) -> None:
        self.seed = seed
        self._generators: Dict[torch.device, torch.Generator] = {}

    def generator(self, device: torch.device) -> torch.Generator:
        if device not in self._generators:
            self._generators[device] = torch.Generator(
                device=device).manual_seed(self.seed)
        return self._generators[device]

    def get_state(self):
        """The seed and each device's generator state, for ``set_state``."""
        return self.seed, {d: g.get_state()
                           for d, g in self._generators.items()}

    def set_state(self, state) -> None:
        self.manual_seed(state[0])
        for device, s in state[1].items():
            self.generator(device).set_state(s)


class Dropout(nn.Module):
    """Inverted dropout at rate ``p`` in train mode, the identity in eval
    mode or at rate 0."""

    def __init__(self, p: float, rng: DropoutRng):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate {p} outside [0, 1)")
        self.p = p
        self.rng = rng

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, device=x.device,
                          generator=self.rng.generator(x.device)) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)
