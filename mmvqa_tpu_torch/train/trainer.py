"""Epoch loops (counterpart of mmvqa_tpu/train/trainer.py): host control flow
around the steps.

Metric aggregation matches the reference: the epoch loss is the mean of the
per-batch means, MLM accuracy is global over all masked tokens. The steps
leave their metrics on the device; they are pulled once, at the end of the
epoch and before the clock stops, so that no step waits for the host.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Mapping, Tuple

import torch

from mmvqa_tpu_torch.train.state import TrainState


def _pull(xs: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([x.detach().double() for x in xs]).cpu()


def mlm_epoch(step_fn: Callable, state: TrainState, loader: Iterable[Mapping],
              train: bool) -> Tuple[TrainState, Dict[str, float]]:
    """Run ``step_fn`` (a train or eval step of ``make_mlm_steps``) over the
    batches of ``loader``. Returns the state and ``loss``, ``acc`` (percent
    of masked tokens predicted), ``items_per_sec`` (real samples over the
    epoch's wall time) and the mean of every ``gnorm/*`` metric."""
    per_step: Dict[str, List[torch.Tensor]] = {}
    n_items = 0
    t0 = time.perf_counter()
    for batch in loader:
        n_items += int(batch["weights"].sum())
        if train:
            state, m = step_fn(state, batch)
        else:
            m = step_fn(state, batch)
        for k, v in m.items():
            per_step.setdefault(k, []).append(v)
    pulled = {k: _pull(v) for k, v in per_step.items()}  # waits for the device
    dt = time.perf_counter() - t0
    if not pulled:
        return state, {"loss": float("nan"), "items_per_sec": 0.0}
    metrics = {"loss": float(pulled["loss"].mean()),
               "items_per_sec": n_items / max(dt, 1e-9)}
    if "correct" in pulled:
        metrics["acc"] = (100.0 * float(pulled["correct"].sum())
                          / max(float(pulled["total"].sum()), 1.0))
    for k, v in pulled.items():
        if k.startswith("gnorm/"):
            metrics[k] = float(v.mean())
    return state, metrics
