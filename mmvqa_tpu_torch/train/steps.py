"""Train and eval steps (counterpart of mmvqa_tpu/train/steps.py): the ROCO
MLM pretraining steps (``make_mlm_steps``, :167-220) and the VQA eval step
(the ``eval_step`` of ``make_vqa_steps``, :461-471).

The steps run eagerly and update the train state in place. Metrics come
back as tensors on the model's device, so that a loop can pull them once at
its end.

The VQA eval criterion is the configured loss: ASL under
``--loss ASLSingleLabel``, plain CE otherwise (the category-smoothing table
that would switch ASL off is a training input, not ported yet).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from mmvqa_tpu_torch.core.config import Config
from mmvqa_tpu_torch.data.images import (
    PRETRAIN_AUG,
    AugmentDraws,
    AugmentSpec,
    process_batch,
)
from mmvqa_tpu_torch.ops.losses import (
    asl_per_sample,
    cross_entropy_per_sample,
    mlm_metrics,
    weighted_mean,
    weighted_token_nll,
)
from mmvqa_tpu_torch.train.state import TrainState

BATCH_KEYS = ("image", "tokens", "segment_ids", "input_mask", "answer", "weights")
MLM_BATCH_KEYS = ("image", "tokens", "segment_ids", "input_mask", "labels",
                  "weights")


def _to_device(batch: Mapping, keys, dev: torch.device) -> Dict[str, torch.Tensor]:
    missing = [k for k in keys if k not in batch]
    if missing:
        raise KeyError(f"batch lacks {missing}")
    return {k: torch.as_tensor(batch[k]).to(dev, non_blocking=True)
            for k in keys}


def grad_norms(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """L2 norm of the gradients of each top-level module, as
    ``gnorm/<module>`` (mmvqa_tpu/train/steps.py::_grad_norms)."""
    out = {}
    for name, child in model.named_children():
        grads = [p.grad.float() for p in child.parameters()
                 if p.grad is not None]
        if grads:
            out[f"gnorm/{name}"] = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
    return out


def make_mlm_steps(
    model: torch.nn.Module, cfg: Config, aug: AugmentSpec = PRETRAIN_AUG,
) -> Tuple[Callable, Callable]:
    """Returns ``(train_step, eval_step)`` for ROCO MLM pretraining.

    ``train_step(state, batch, draws=None)`` runs, in the JAX
    step's order: augmentation, forward in train mode (dropout on, the
    trunk's BatchNorms on batch statistics, which they fold into their
    running statistics), the weighted token NLL, backward, the optimizer
    step; it returns ``(state, metrics)`` with ``loss``, ``correct`` and
    ``total`` and, under ``cfg.watch``, the per-module gradient norms. The
    augmentation draws come from ``draws`` if given, else from the step's
    own generator (seeded with ``cfg.seed``, on the model's device); the
    dropout masks come from the model's ``dropout_rng``.
    ``eval_step(state, batch)`` returns the three metrics without
    augmentation, dropout or any update.

    ``batch`` has the JAX loader's keys: ``image`` uint8 (B, S, S, 3),
    ``tokens``, ``segment_ids``, ``input_mask``, ``labels`` (B, T; 0 =
    unmasked) and ``weights`` (B,) (1 real, 0 padding)."""
    own: Dict[torch.device, torch.Generator] = {}

    def own_generator(dev: torch.device) -> torch.Generator:
        if dev not in own:
            own[dev] = torch.Generator(device=dev).manual_seed(cfg.seed)
        return own[dev]

    def train_step(state: TrainState, batch: Mapping,
                   draws: Optional[AugmentDraws] = None):
        if state.model is not model:
            raise ValueError("train_step: the state holds another model")
        dev = model.device
        b = _to_device(batch, MLM_BATCH_KEYS, dev)
        generator = own_generator(dev) if draws is None else None
        with torch.no_grad():
            img = process_batch(b["image"], generator, aug, True, draws)
        model.set_mode(deterministic=False)
        logits = model(img, b["tokens"], b["segment_ids"], b["input_mask"])
        loss = weighted_token_nll(logits, b["labels"], b["weights"])
        loss.backward()
        metrics = {"loss": loss.detach()}
        with torch.no_grad():
            correct, total = mlm_metrics(logits, b["labels"], b["weights"])
            metrics.update(correct=correct, total=total)
            if cfg.watch:
                metrics.update(grad_norms(model))
        state.apply_gradients()
        return state, metrics

    @torch.inference_mode()
    def eval_step(state: TrainState, batch: Mapping):
        b = _to_device(batch, MLM_BATCH_KEYS, model.device)
        model.set_mode(deterministic=True)
        logits = model(process_batch(b["image"]), b["tokens"],
                       b["segment_ids"], b["input_mask"])
        correct, total = mlm_metrics(logits, b["labels"], b["weights"])
        return {"loss": weighted_token_nll(logits, b["labels"], b["weights"]),
                "correct": correct, "total": total}

    return train_step, eval_step


def make_vqa_eval_step(
    model: torch.nn.Module, cfg: Config
) -> Callable[[Mapping], Dict[str, torch.Tensor]]:
    """Returns ``eval_step(batch) -> {"loss", "preds", "logits"}``.

    ``batch`` has the JAX loader's keys: ``image`` uint8 (B, S, S, 3),
    ``tokens``, ``segment_ids``, ``input_mask`` (B, T), ``answer`` (B,) and
    ``weights`` (B,) (1 real, 0 padding), as numpy arrays or tensors; they
    are moved to the model's device."""
    criterion = (asl_per_sample if cfg.loss == "ASLSingleLabel"
                 else cross_entropy_per_sample)

    @torch.inference_mode()
    def eval_step(batch: Mapping) -> Dict[str, torch.Tensor]:
        b = _to_device(batch, BATCH_KEYS, model.device)
        img = process_batch(b["image"])
        logits = model(img, b["tokens"], b["segment_ids"], b["input_mask"])
        loss = weighted_mean(criterion(logits, b["answer"]), b["weights"])
        return {"loss": loss, "preds": torch.argmax(logits, dim=-1),
                "logits": logits}

    return eval_step
