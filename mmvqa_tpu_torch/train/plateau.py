"""Host-side ReduceLROnPlateau and early-stopping counter, copied from
mmvqa_tpu/train/plateau.py (which imports no jax, but whose package
``__init__`` does); tests/test_torch_finetune.py holds the two copies to the
same fields and the same answers.

Matches torch.optim.lr_scheduler.ReduceLROnPlateau semantics as used by the
reference (mode='min', threshold=1e-4 rel, cooldown=0, min_lr=0;
roco_train.py:91, train.py:161): after ``patience`` epochs without the
monitored loss improving past the threshold, lr *= factor. State is a plain
dict so it round-trips through the recorder checkpoint
(mmvqa_tpu_torch.train.checkpoint).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict


@dataclass
class ReduceLROnPlateau:
    lr: float
    patience: int = 10
    factor: float = 0.1
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = float("inf")
    num_bad_epochs: int = 0

    def step(self, metric: float) -> float:
        """Feed one epoch's monitored value; returns the (possibly reduced)
        lr to use next."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> Dict:
        return asdict(self)

    def load_state_dict(self, d: Dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)


@dataclass
class EarlyStopping:
    """Reference counter semantics (train.py:218-296): counter increments on
    epochs where best accuracy did not improve; stop when counter > patience."""

    patience: int = 20
    best: float = -float("inf")
    counter: int = 0

    def update(self, metric: float) -> bool:
        """Returns True when training should STOP."""
        if metric > self.best:
            self.best = metric
            self.counter = 0
            return False
        self.counter += 1
        return self.counter > self.patience
