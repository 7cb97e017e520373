"""Epoch loops (counterpart of mmvqa_tpu/train/trainer.py): host control flow
around the steps.

Metric aggregation matches the reference: the epoch loss is the mean of the
per-batch means, MLM accuracy is global over all masked tokens, and a VQA
epoch returns its per-sample predictions for host-side per-category metrics.
The steps leave their metrics on the device; they are pulled once, at the
end of the epoch and before the clock stops, so that no step waits for the
host.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
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


def supcon_epoch(step_fn: Callable, state: TrainState,
                 loader: Iterable[Mapping],
                 sim_mask_fn: Optional[Callable] = None
                 ) -> Tuple[TrainState, Dict[str, float]]:
    """Run ``step_fn`` (the train step of ``make_supcon_steps``) over the
    batches of ``loader``. ``caption`` and ``aug_caption`` (lists of
    strings) leave the batch; ``sim_mask_fn(captions, augs)`` builds each
    step's similarity mask where it is given, and None reproduces the
    reference's live path (supcon_utils.py:286-287). Returns the state and
    the means of ``loss``, ``mlm_loss`` and ``supcon_loss`` over the steps,
    ``acc`` (percent of the masked tokens of both views predicted),
    ``items_per_sec`` (two views of each real sample over the epoch's wall
    time) and the mean of every ``gnorm/*`` metric."""
    per_step: Dict[str, List[torch.Tensor]] = {}
    n_items = 0
    t0 = time.perf_counter()
    for batch in loader:
        n_items += 2 * int(batch["weights"].sum())
        batch = dict(batch)
        captions = batch.pop("caption", None)
        augs = batch.pop("aug_caption", None)
        sim_mask = None
        if sim_mask_fn is not None and captions is not None:
            sim_mask = sim_mask_fn(captions, augs)
        state, m = step_fn(state, batch, sim_mask=sim_mask)
        for k, v in m.items():
            per_step.setdefault(k, []).append(v)
    pulled = {k: _pull(v) for k, v in per_step.items()}  # waits for the device
    dt = time.perf_counter() - t0
    nan = float("nan")
    if not pulled:
        return state, {"loss": nan, "mlm_loss": nan, "supcon_loss": nan,
                       "acc": nan, "items_per_sec": 0.0}
    metrics = {k: float(pulled[k].mean())
               for k in ("loss", "mlm_loss", "supcon_loss")}
    metrics["acc"] = (100.0 * float(pulled["correct"].sum())
                      / max(float(pulled["total"].sum()), 1.0))
    metrics["items_per_sec"] = n_items / max(dt, 1e-9)
    for k, v in pulled.items():
        if k.startswith("gnorm/"):
            metrics[k] = float(v.mean())
    return state, metrics


def vqa_epoch(step_fn: Callable, state: TrainState,
              loader: Iterable[Mapping], train: bool,
              collect_logits: bool = False) -> Tuple[TrainState, Dict]:
    """Run ``step_fn`` (a train or eval step of ``make_vqa_steps``) over the
    batches of ``loader``. Returns the state and ``loss`` (the mean of the
    per-batch means), ``preds`` and ``targets`` (numpy, the real samples in
    dataset order; the global batch's, under data parallelism), ``logits`` (eval steps, with ``collect_logits``) and
    ``items_per_sec`` (real samples over the epoch's wall time)."""
    losses, preds, logits, targets, weights, index = [], [], [], [], [], []
    n_items = 0
    t0 = time.perf_counter()
    for batch in loader:
        if train:
            state, m = step_fn(state, batch)
        else:
            m = step_fn(state, batch)
            if collect_logits:
                logits.append(m["logits"].detach())
        # a data-parallel step returns the global batch's rows
        w = np.asarray(m["weights"].cpu() if "weights" in m
                       else batch["weights"])
        n_items += int(w.sum())
        weights.append(w.copy())
        targets.append(np.asarray(m["answer"].cpu() if "answer" in m
                                  else batch["answer"]).copy())
        if "index" in m:
            index.append(m["index"].cpu().numpy())
        losses.append(m["loss"])
        preds.append(m["preds"])
    # one pull for each kind of output (waits for the device), then the clock
    flat_losses = _pull(losses) if losses else torch.tensor([float("nan")])
    host_preds = (torch.cat(preds).cpu().numpy() if preds
                  else np.zeros(0, np.int64))
    host_logits = (torch.cat([x.float() for x in logits]).cpu().numpy()
                   if logits else None)
    dt = time.perf_counter() - t0
    real = np.concatenate(weights) > 0 if weights else np.zeros(0, bool)
    out = {"loss": float(flat_losses.mean()),
           "preds": host_preds[real],
           "targets": (np.concatenate(targets)[real] if targets
                       else np.zeros(0, np.int64)),
           "items_per_sec": n_items / max(dt, 1e-9)}
    if host_logits is not None:
        out["logits"] = host_logits[real]
    if index:  # the shards' rows back in dataset order
        order = np.argsort(np.concatenate(index)[real], kind="stable")
        for k in ("preds", "targets", "logits"):
            if k in out:
                out[k] = out[k][order]
    return state, out
