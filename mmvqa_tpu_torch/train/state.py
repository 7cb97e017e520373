"""Train state and optimizer (counterpart of mmvqa_tpu/train/state.py).

Adam with the reference's settings (b1 0.9, b2 0.999, eps 1e-8, no weight
decay), with an optional clip of the global gradient norm at 1.0 applied
before Adam, as ``optax.clip_by_global_norm``. Parameters and both moments
are fp32 whatever the model's compute dtype. The state is updated in place:
``apply_gradients`` steps the model's own parameters. Gradient accumulation
(``grad_accum``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

CLIP_NORM = 1.0


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    clip: bool = False

    def apply_gradients(self) -> None:
        """One optimizer step from the ``.grad`` of the model's parameters;
        the gradients are dropped afterwards."""
        if self.clip:
            params = [p for p in self.model.parameters() if p.grad is not None]
            # optax's rule: untouched below the limit, g / norm * limit
            # above it (torch.nn.utils.clip_grad_norm_ adds 1e-6 to the norm)
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(p.grad.float()) for p in params]))
            scale = torch.where(norm > CLIP_NORM, CLIP_NORM / norm,
                                torch.ones_like(norm))
            torch._foreach_mul_([p.grad for p in params], scale)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1

    @property
    def lr(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    def with_lr(self, lr: float) -> "TrainState":
        """Change the learning rate in place (the plateau scheduler's hook);
        returns the state itself."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return self


def create_train_state(model: nn.Module, lr: float,
                       clip: bool = False) -> TrainState:
    """Adam over every parameter of ``model``, on the model's device."""
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=0.0)
    return TrainState(step=0, model=model, optimizer=optimizer, clip=clip)
