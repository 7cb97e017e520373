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
    """Under tensor parallelism (``parallel.sharding.Layout`` sets
    ``tp_mode`` on the instances whose parent allows it, ``tp_capable``):

    * 'col': the weight holds this rank's block of output features; the
      replicated input enters through ``comm.copy_to``, the replicated bias
      gives its block, and the output stays sharded unless
      ``gather_output``. With ``gather_weight`` the weight is gathered for
      use instead and the input is taken as it comes (the RealFormer's
      shared k/q/v projection over this rank's heads).
    * 'row': the weight holds this rank's block of input features; the input
      is this rank's block (a sharded activation), the ranks' partial
      products are summed (``comm.reduce_from``), then the bias is added.
    """

    tp_capable = False
    tp_mode: Optional[str] = None
    gather_output = False
    gather_weight = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_mode is None:
            return F.linear(x, _as(self.weight, x), _as(self.bias, x))
        from mmvqa_tpu_torch.core.mesh import MODEL_AXIS
        from mmvqa_tpu_torch.parallel import comm

        if self.tp_mode == "row":
            y = comm.reduce_from(F.linear(x, _as(self.weight, x)), MODEL_AXIS)
            return y if self.bias is None else y + _as(self.bias, x)
        if self.gather_weight:
            w = comm.gather_weight(self.weight, MODEL_AXIS, 0)
            return F.linear(x, _as(w, x),
                            _as(self.bias, x))
        bias = (None if self.bias is None
                else comm.scatter_to(self.bias, MODEL_AXIS, 0))
        y = F.linear(comm.copy_to(x, MODEL_AXIS), _as(self.weight, x),
                     _as(bias, x))
        return comm.gather_from(y, MODEL_AXIS, -1) if self.gather_output else y


class LayerNorm(nn.LayerNorm):
    """Statistics in fp32 inside the kernel, output in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, _as(self.weight, x),
                            _as(self.bias, x), self.eps)


class Conv2d(nn.Conv2d):
    tp_capable = False  # the trunk's blocks split pw_exp and pw_proj
    tp_mode: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _as(self.weight, x), _as(self.bias, x))


class DropoutRng:
    """The model's dropout key: one seeded ``torch.Generator`` per device the
    model has run on, made at first use. Two models seeded alike draw the
    same masks."""

    def __init__(self, seed: int):
        self.manual_seed(seed)

    def fold_rank(self, *coords: int) -> None:
        """Reseed for a rank (``core.distributed.fold_seed``): one stream a
        data rank, shared by the model ranks, whose replicated activations
        must draw the same masks."""
        from mmvqa_tpu_torch.core.distributed import fold_seed

        self.manual_seed(fold_seed(self.seed, *coords))

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
