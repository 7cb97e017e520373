"""Train state and optimizer (counterpart of mmvqa_tpu/train/state.py).

Adam with the reference's settings (b1 0.9, b2 0.999, eps 1e-8, no weight
decay), with an optional clip of the global gradient norm at 1.0 applied
before Adam, as ``optax.clip_by_global_norm``. Parameters and both moments
are fp32 whatever the model's compute dtype. The state is updated in place:
``apply_gradients`` steps the model's own parameters.

Gradient accumulation (``grad_accum`` k > 1) has ``optax.MultiSteps``'
semantics, nested as the JAX state nests it (the clip and Adam inside the
accumulation, the learning rate outside): each call folds the micro-batch's
gradient into a running mean (``acc + (g - acc) / (n + 1)``, optax's
Welford form), and every k-th call clips that mean and takes one Adam step
from it. Adam's count moves only on those real updates; ``step`` counts
micro-steps, as the JAX ``TrainState.step`` does; ``with_lr`` works between
micro-steps. The BatchNorm statistics are no optimizer state: they move in
every forward, so on every micro-step.

Under a layout (``parallel.sharding.Layout``, ``layout=`` of
``create_train_state``) the optimizer steps the layout's tensors (under
FSDP the parameters' 'data' blocks, which the model holds at rest): each
micro-step first reduces the ranks' gradients (``reduce_gradients``, which a
step may call before ``apply_gradients`` to read the reduced gradient; it
runs once a micro-step), the accumulation and the clip work on those. The
clip's norm is the global one: each rank's squares, each value counted once
(``Layout.replication``), summed over the world.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch import nn

CLIP_NORM = 1.0
ADAM_EPS = 1e-8


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    clip: bool = False
    grad_accum: int = 1
    # micro-steps folded into acc_grads since the last update, and their
    # running mean, one fp32 tensor a parameter (None until the first fold)
    mini_step: int = 0
    acc_grads: Optional[Dict[str, torch.Tensor]] = field(default=None,
                                                         repr=False)
    layout: Optional[object] = field(default=None, repr=False)
    # the global gradient norm the last clip measured (None without a clip)
    clip_norm: Optional[torch.Tensor] = field(default=None, repr=False)
    # whether this micro-step's gradients have been reduced
    reduced: bool = field(default=False, repr=False)

    def reduce_gradients(self) -> None:
        """Reduce this micro-step's gradients over the layout's ranks
        (``Layout.reduce_gradients``; nothing without a layout), once: the
        step's ``.grad`` is then the global gradient's part this rank
        holds."""
        if self.layout is not None and not self.reduced:
            self.layout.reduce_gradients()
        self.reduced = True

    def apply_gradients(self) -> None:
        """One micro-step from the ``.grad`` of the model's parameters: an
        optimizer step at once, or every ``grad_accum``-th call from the
        mean of the accumulated gradients. The gradients are dropped
        afterwards."""
        self.step += 1
        self.reduce_gradients()
        self.reduced = False
        targets = dict(self.model.named_parameters())
        if self.grad_accum > 1:
            self._accumulate(targets)
            self.mini_step += 1
            if self.mini_step < self.grad_accum:
                self.optimizer.zero_grad(set_to_none=True)
                return
            self.mini_step = 0
            for name, p in targets.items():
                p.grad = self.acc_grads[name].to(p.dtype)
            self.acc_grads = None
        if self.clip:
            named = [(n, p) for n, p in targets.items() if p.grad is not None]
            # optax's rule: untouched below the limit, g / norm * limit
            # above it (torch.nn.utils.clip_grad_norm_ adds 1e-6 to the norm)
            if self.layout is None:
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(p.grad.float())
                     for _, p in named]))
            else:
                norm = self.layout.global_norm(
                    {n: p.grad for n, p in named})
            self.clip_norm = norm.detach()
            scale = torch.where(norm > CLIP_NORM, CLIP_NORM / norm,
                                torch.ones_like(norm))
            torch._foreach_mul_([p.grad for _, p in named], scale)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def _accumulate(self, targets: Dict[str, torch.Tensor]) -> None:
        """acc += (g - acc) / (n + 1); a parameter without a gradient counts
        as a zero gradient, as in the JAX tree."""
        if self.acc_grads is None:
            self.acc_grads = {name: torch.zeros_like(p, dtype=torch.float32)
                              for name, p in targets.items()}
        n = float(self.mini_step + 1)
        for name, p in targets.items():
            acc = self.acc_grads[name]
            g = torch.zeros_like(acc) if p.grad is None else p.grad.float()
            acc.add_((g - acc) / n)

    @property
    def lr(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    def with_lr(self, lr: float) -> "TrainState":
        """Change the learning rate in place (the plateau scheduler's hook);
        returns the state itself."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return self


def create_train_state(model: nn.Module, lr: float, clip: bool = False,
                       grad_accum: int = 1, layout=None) -> TrainState:
    """Adam over every parameter of ``model``, on the model's device (under
    ``layout``, a ``parallel.sharding.Layout`` of the model, its parameters
    are this rank's blocks)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                                 eps=ADAM_EPS, weight_decay=0.0)
    return TrainState(step=0, model=model, optimizer=optimizer, clip=clip,
                      grad_accum=grad_accum, layout=layout)
