"""Train and eval steps (counterpart of mmvqa_tpu/train/steps.py): the ROCO
MLM pretraining steps (``make_mlm_steps``, :167-220), the distillation
pretraining steps (``make_distill_steps``, :227-288), the joint MLM +
SupCon/SimCLR steps (``make_supcon_steps``, :291-368), the VQA-Med
fine-tuning steps (``make_vqa_steps``, :371-478), the image-only
classifier's steps (``make_img_only_steps``, :487-536) and the
per-parameter histograms (``grad_weight_histograms``, :87-115).

The steps run eagerly and update the train state in place. Metrics come
back as tensors on the model's device, so that a loop can pull them once at
its end.

Under a layout (``core.mesh.CURRENT``, the state's ``parallel.sharding.
Layout``) each rank's batch is its rows of the global batch
(``parallel.sharding.place_batch``), and a step is the single process's on
the global batch: the augmentation draws are the global batch's, from the
step's generator, and each rank keeps its rows; the losses and metric
counters are the global batch's (``ops/losses.py``); SupCon contrasts the
gathered global batch; the VQA steps return the predictions, logits,
answers and weights of the global batch. Under context parallelism each
rank's sequence fields are its block of the token axis (the token losses
and the MLM counts are summed over 'context', ``ops/losses.py``; the VQA
head sees the whole sequence's pooled mean, so its predictions are every
context rank's alike), and under a pipeline every stage computes the heads
and the loss on the broadcast encoder output: either way the per-row
outputs are gathered over 'data' alone. The watch metrics (``--watch``'s
per-module norms, the histograms) are taken after the state's
``reduce_gradients``, of the global batch's gradient, as one process takes
them.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from mmvqa_tpu_torch.bridge import flax_names
from mmvqa_tpu_torch.core.config import Config
from mmvqa_tpu_torch.core.mesh import DATA_AXIS
from mmvqa_tpu_torch.data.images import (
    FINETUNE_AUG,
    PRETRAIN_AUG,
    AugmentDraws,
    AugmentSpec,
    process_batch,
    sample_draws,
)
from mmvqa_tpu_torch.ops.losses import (
    asl_per_sample,
    category_smoothing_per_sample,
    cross_entropy_per_sample,
    distill_per_sample,
    mlm_metrics,
    weighted_mean,
    weighted_token_nll,
)
from mmvqa_tpu_torch.ops.supcon import split_two_views, supcon_loss
from mmvqa_tpu_torch.parallel.comm import axis_info, gather_over
from mmvqa_tpu_torch.train.state import TrainState

BATCH_KEYS = ("image", "tokens", "segment_ids", "input_mask", "answer", "weights")
MLM_BATCH_KEYS = ("image", "tokens", "segment_ids", "input_mask", "labels",
                  "weights")
SUPCON_BATCH_KEYS = MLM_BATCH_KEYS + ("aug_tokens", "aug_labels")
IMG_ONLY_BATCH_KEYS = ("image", "answer", "weights")


def _to_device(batch: Mapping, keys, dev: torch.device) -> Dict[str, torch.Tensor]:
    missing = [k for k in keys if k not in batch]
    if missing:
        raise KeyError(f"batch lacks {missing}")
    return {k: torch.as_tensor(batch[k]).to(dev, non_blocking=True)
            for k in keys}


def grad_norms(model: torch.nn.Module,
               layout=None) -> Dict[str, torch.Tensor]:
    """L2 norm of the gradients of each top-level module, as
    ``gnorm/<module>`` (mmvqa_tpu/train/steps.py::_grad_norms). Under
    ``layout`` (a ``parallel.sharding.Layout``) the norms are of the reduced
    gradient, the global batch's, as one process takes them
    (``Layout.module_norms``, collective): call it after the state's
    ``reduce_gradients``."""
    if layout is not None:
        return {f"gnorm/{name}": v
                for name, v in layout.module_norms().items()}
    out = {}
    for name, child in model.named_children():
        grads = [p.grad.float() for p in child.parameters()
                 if p.grad is not None]
        if grads:
            out[f"gnorm/{name}"] = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
    return out


HIST_BINS = 64


def _histograms(named: Dict[str, torch.Tensor], prefix: str,
                bins: int = HIST_BINS) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """One (counts[bins] int32, lo, hi) triple a tensor, on its device, as
    mmvqa_tpu/train/steps.py::_param_histograms bins it (a transpose moves
    no value between bins, so the counts are the JAX ones)."""
    out = {}
    for name, t in named.items():
        x = t.detach().float().reshape(-1)
        lo, hi = torch.min(x), torch.max(x)
        width = torch.clamp(hi - lo, min=1e-12)
        idx = torch.clamp(((x - lo) / width * bins).to(torch.int32), 0,
                          bins - 1)
        counts = torch.bincount(idx, minlength=bins).to(torch.int32)
        out[f"{prefix}/{name}"] = (counts, lo, hi)
    return out


def grad_weight_histograms(model: torch.nn.Module, layout=None
                           ) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """Histograms of every parameter's gradient (``ghist/<path>``) and value
    (``whist/<path>``), named by the parameter's Flax path through the
    bridge; a parameter without a gradient gives a zero gradient's. Taken
    before the update, at the parameters the gradients were taken at.

    Under ``layout`` (collective; after the state's ``reduce_gradients``)
    each tensor is binned at its full shape (``Layout.full``, one leaf at a
    time), and a pipeline's stacked leaves are gathered over 'pipe' and cut
    into the sequential encoder's layers, each under the single process's
    name: the histograms are the single process's."""
    names = flax_names(model)
    params = dict(model.named_parameters())
    if layout is None:
        grads = {names[k]: (torch.zeros_like(p) if p.grad is None
                            else p.grad) for k, p in params.items()}
        return {**_histograms(grads, "ghist"),
                **_histograms({names[k]: p for k, p in params.items()},
                              "whist")}
    from mmvqa_tpu_torch.parallel.pipeline import (
        STACKED_KEY,
        unstack_encoder_state,
    )

    out = {}
    for k, p in params.items():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        for prefix, t in (("ghist", g), ("whist", p.detach())):
            full = layout.full(k, t)
            if f".{STACKED_KEY}." not in f".{k}":
                out.update(_histograms({names[k]: full}, prefix))
                continue
            leaf = names[k].rpartition("/")[2]
            for key, row in unstack_encoder_state({k: full}).items():
                name = key.rpartition(".")[0].replace(".", "/") + "/" + leaf
                out.update(_histograms({name: row}, prefix))
    return out


def _watched(model: torch.nn.Module, state, norms: bool,
             histograms: bool) -> Dict:
    """The watch metrics of a step's reduced gradient: the per-module norms
    (``norms``, ``cfg.watch``) and the histograms."""
    layout = getattr(state, "layout", None)
    out = grad_norms(model, layout) if norms else {}
    if histograms:
        out.update(grad_weight_histograms(model, layout))
    return out


def _own_generators(cfg: Config) -> Callable[[torch.device], torch.Generator]:
    """A step's own augmentation generator on each device, seeded with
    ``cfg.seed`` at first use."""
    own: Dict[torch.device, torch.Generator] = {}

    def get(dev: torch.device) -> torch.Generator:
        if dev not in own:
            own[dev] = torch.Generator(device=dev).manual_seed(cfg.seed)
        return own[dev]

    return get


def _augment(images: torch.Tensor, generator: Optional[torch.Generator],
             aug: AugmentSpec, draws: Optional[AugmentDraws]) -> torch.Tensor:
    """``process_batch`` with augmentation. The draws (given, or from
    ``generator``) are the global batch's; under data parallelism this rank
    keeps its rows of them."""
    _, dp, d = axis_info(DATA_AXIS)
    b = images.shape[0]
    if draws is None:
        draws = sample_draws(b * dp, images.shape[1], generator, aug)
    if draws.crop.shape[0] != b:
        draws = AugmentDraws(draws.crop[d * b:(d + 1) * b],
                             draws.jitter[d * b:(d + 1) * b])
    return process_batch(images, None, aug, True, draws)


def _layout_rows(b: Mapping, batch: Mapping) -> Dict[str, torch.Tensor]:
    """Under data parallelism the answers, weights and (where the loader
    gives them) dataset indices of the global batch come back with its
    predictions (``trainer.vqa_epoch`` reads them)."""
    if axis_info(DATA_AXIS)[1] == 1:
        return {}
    rows = {"answer": b["answer"], "weights": b["weights"]}
    if "index" in batch:
        rows["index"] = torch.as_tensor(batch["index"]).to(b["answer"].device)
    return rows


def _global_rows(metrics: Dict, **rows: torch.Tensor) -> Dict:
    """Per-row outputs of the global batch: gathered over 'data'."""
    for k, v in rows.items():
        metrics[k] = gather_over(v, DATA_AXIS, 0)
    return metrics


def _mlm_eval_step(model: torch.nn.Module) -> Callable:
    """The MLM eval step: loss, ``correct`` and ``total`` without
    augmentation, dropout or any update (on a SupCon model, of its MLM
    logits)."""

    @torch.inference_mode()
    def eval_step(state: TrainState, batch: Mapping):
        b = _to_device(batch, MLM_BATCH_KEYS, model.device)
        model.set_mode(deterministic=True)
        logits = model(process_batch(b["image"]), b["tokens"],
                       b["segment_ids"], b["input_mask"])
        if isinstance(logits, tuple):
            logits = logits[0]
        correct, total = mlm_metrics(logits, b["labels"], b["weights"])
        return {"loss": weighted_token_nll(logits, b["labels"], b["weights"]),
                "correct": correct, "total": total}

    return eval_step


def make_mlm_steps(
    model: torch.nn.Module, cfg: Config, aug: AugmentSpec = PRETRAIN_AUG,
    histograms: bool = False,
) -> Tuple[Callable, Callable]:
    """Returns ``(train_step, eval_step)`` for ROCO MLM pretraining.

    ``train_step(state, batch, draws=None)`` runs, in the JAX
    step's order: augmentation, forward in train mode (dropout on, the
    trunk's BatchNorms on batch statistics, which they fold into their
    running statistics), the weighted token NLL, backward, the optimizer
    step; it returns ``(state, metrics)`` with ``loss``, ``correct`` and
    ``total``, under ``cfg.watch`` the per-module gradient norms and, with
    ``histograms``, ``grad_weight_histograms`` at the pre-update
    parameters. The augmentation draws come from ``draws`` if given, else
    from the step's own generator (seeded with ``cfg.seed``, on the model's
    device); the dropout masks come from the model's ``dropout_rng``.
    ``eval_step(state, batch)`` returns the three metrics without
    augmentation, dropout or any update.

    ``batch`` has the JAX loader's keys: ``image`` uint8 (B, S, S, 3),
    ``tokens``, ``segment_ids``, ``input_mask``, ``labels`` (B, T; 0 =
    unmasked) and ``weights`` (B,) (1 real, 0 padding)."""
    own_generator = _own_generators(cfg)

    def train_step(state: TrainState, batch: Mapping,
                   draws: Optional[AugmentDraws] = None):
        if state.model is not model:
            raise ValueError("train_step: the state holds another model")
        dev = model.device
        b = _to_device(batch, MLM_BATCH_KEYS, dev)
        generator = own_generator(dev) if draws is None else None
        with torch.no_grad():
            img = _augment(b["image"], generator, aug, draws)
        model.set_mode(deterministic=False)
        logits = model(img, b["tokens"], b["segment_ids"], b["input_mask"])
        loss = weighted_token_nll(logits, b["labels"], b["weights"])
        loss.backward()
        state.reduce_gradients()
        metrics = {"loss": loss.detach()}
        with torch.no_grad():
            correct, total = mlm_metrics(logits, b["labels"], b["weights"])
            metrics.update(correct=correct, total=total)
            metrics.update(_watched(model, state, cfg.watch, histograms))
        state.apply_gradients()
        return state, metrics

    return train_step, _mlm_eval_step(model)


def make_distill_steps(
    model: torch.nn.Module, cfg: Config, aug: AugmentSpec = PRETRAIN_AUG,
    histograms: bool = False,
) -> Tuple[Callable, Callable]:
    """Returns ``(train_step, eval_step)`` for distillation pretraining
    (roco_train.py:94-95) on a model built with ``task="distillation"``,
    whose forward returns the encoder's output ``h`` (B, T, H).

    The loss is each sample's mean over (T, H) of ``(h - labels)^2`` in
    fp32, padded positions included, averaged over the real samples by
    ``weights`` (not ``mse_distillation``, whose mean runs over the whole
    batch). ``train_step(state, batch, draws=None)`` runs augmentation, the
    forward in train mode, that loss, backward and ``apply_gradients``;
    it returns ``(state, metrics)`` with ``loss`` and, with ``histograms``,
    ``grad_weight_histograms`` at the pre-update parameters. Draws and
    dropout as in ``make_mlm_steps``. ``eval_step(state, batch)`` returns
    ``loss`` without augmentation, dropout or any update.

    ``batch`` has the MLM keys, ``labels`` being the teacher's hidden
    states (B, T, H) in fp32 (zero vectors off the caption)."""
    own_generator = _own_generators(cfg)

    def train_step(state: TrainState, batch: Mapping,
                   draws: Optional[AugmentDraws] = None):
        if state.model is not model:
            raise ValueError("train_step: the state holds another model")
        dev = model.device
        b = _to_device(batch, MLM_BATCH_KEYS, dev)
        generator = own_generator(dev) if draws is None else None
        with torch.no_grad():
            img = _augment(b["image"], generator, aug, draws)
        model.set_mode(deterministic=False)
        h = model(img, b["tokens"], b["segment_ids"], b["input_mask"])
        loss = weighted_mean(distill_per_sample(h, b["labels"]),
                             b["weights"])
        loss.backward()
        state.reduce_gradients()
        metrics = {"loss": loss.detach()}
        with torch.no_grad():
            metrics.update(_watched(model, state, False, histograms))
        state.apply_gradients()
        return state, metrics

    @torch.inference_mode()
    def eval_step(state: Optional[TrainState], batch: Mapping):
        b = _to_device(batch, MLM_BATCH_KEYS, model.device)
        model.set_mode(deterministic=True)
        h = model(process_batch(b["image"]), b["tokens"], b["segment_ids"],
                  b["input_mask"])
        return {"loss": weighted_mean(distill_per_sample(h, b["labels"]),
                                      b["weights"])}

    return train_step, eval_step


def make_supcon_steps(
    model: torch.nn.Module, cfg: Config, aug: AugmentSpec = PRETRAIN_AUG,
    histograms: bool = False,
) -> Tuple[Callable, Callable]:
    """Returns ``(train_step, eval_step)`` for joint MLM + SupCon/SimCLR
    pretraining (supcon_utils.py:263-323) on a model built with
    ``cfg.supcon``.

    ``train_step(state, batch, draws=None, sim_mask=None)``: two augmented
    views of each image (TwoCropTransform, supcon_utils.py:26-32) and the
    caption and back-translation token views, concatenated along the batch
    (process_tensors, :253-256), so that the model sees 2B samples; the
    loss is the weighted token NLL plus ``supcon_loss`` of the two views'
    features, with ``sim_mask`` (B, B) as its positives where given (the
    reference's live path passes none, :287). ``draws`` is a pair of
    ``AugmentDraws``, one a view; where None both come from the step's own
    generator (seeded with ``cfg.seed``), the first view's first. Returns
    ``(state, metrics)`` with ``loss``, ``mlm_loss``, ``supcon_loss``,
    ``correct`` and ``total`` (over the masked tokens of both views), under
    ``cfg.watch`` the per-module gradient norms and, with ``histograms``,
    ``grad_weight_histograms`` at the pre-update parameters.

    ``eval_step(state, batch)`` is plain MLM validation on the SupCon model
    (roco_supcon_train.py:174), as ``make_mlm_steps``' eval step.

    ``batch`` has the MLM keys and ``aug_tokens``, ``aug_labels`` (B, T)."""
    own_generator = _own_generators(cfg)

    def train_step(state: TrainState, batch: Mapping,
                   draws: Optional[Tuple[AugmentDraws, AugmentDraws]] = None,
                   sim_mask: Optional[np.ndarray] = None):
        if state.model is not model:
            raise ValueError("train_step: the state holds another model")
        dev = model.device
        b = _to_device(batch, SUPCON_BATCH_KEYS, dev)
        generator = own_generator(dev) if draws is None else None
        d1, d2 = (None, None) if draws is None else draws
        with torch.no_grad():
            img = torch.cat([_augment(b["image"], generator, aug, d1),
                             _augment(b["image"], generator, aug, d2)])
        ids = torch.cat([b["tokens"], b["aug_tokens"]])
        seg = torch.cat([b["segment_ids"]] * 2)
        mask = torch.cat([b["input_mask"]] * 2)
        labels = torch.cat([b["labels"], b["aug_labels"]])
        w = torch.cat([b["weights"]] * 2)
        positives = (None if sim_mask is None else
                     torch.as_tensor(np.asarray(sim_mask, np.float32)).to(dev))
        model.set_mode(deterministic=False)
        logits, feat = model(img, ids, seg, mask)
        nll = weighted_token_nll(logits, labels, w)
        con = supcon_loss(split_two_views(feat), mask=positives,
                          axis_name=(DATA_AXIS if axis_info(DATA_AXIS)[1] > 1
                                     else None))
        loss = nll + con
        loss.backward()
        state.reduce_gradients()
        metrics = {"loss": loss.detach(), "mlm_loss": nll.detach(),
                   "supcon_loss": con.detach()}
        with torch.no_grad():
            correct, total = mlm_metrics(logits, labels, w)
            metrics.update(correct=correct, total=total)
            metrics.update(_watched(model, state, cfg.watch, histograms))
        state.apply_gradients()
        return state, metrics

    return train_step, _mlm_eval_step(model)


def make_vqa_steps(
    model: torch.nn.Module, cfg: Config, aug: AugmentSpec = FINETUNE_AUG,
    category_smoothing_table: Optional[np.ndarray] = None,
    histograms: bool = False,
) -> Tuple[Callable, Callable]:
    """Returns ``(train_step, eval_step)`` for VQA-Med fine-tuning.

    The train criterion (train.py:163-173, smoothing first): the category
    smoothing when ``cfg.smoothing`` is set and a table is given, else ASL
    under ``--loss ASLSingleLabel``, else CE. The eval criterion: ASL under
    ``--loss ASLSingleLabel`` unless the smoothing table is in use, else CE
    (the reference passes val and test logits through the same criterion
    object, whose smoothing branch falls back to CE outside training).

    ``train_step(state, batch, draws=None)`` runs augmentation, the forward
    with dropout on and the trunk's BatchNorms on batch statistics, the
    criterion over the real samples, backward and ``apply_gradients``; it
    returns ``(state, metrics)`` with ``loss`` and ``preds`` and, with
    ``histograms``, ``grad_weight_histograms`` at the pre-update parameters.
    The augmentation draws come from ``draws`` if given, else from the
    step's own generator (seeded with ``cfg.seed``, on the model's device).
    ``eval_step(state, batch)`` returns ``loss``, ``preds`` and ``logits``
    without augmentation, dropout or any update.

    ``batch`` has the JAX loader's keys: ``image`` uint8 (B, S, S, 3),
    ``tokens``, ``segment_ids``, ``input_mask`` (B, T), ``answer`` (B,),
    ``weights`` (B,) (1 real, 0 padding) and, for the smoothing criterion,
    ``category`` (B,) (0 for every sample where absent)."""
    use_smoothing = (cfg.smoothing is not None
                     and category_smoothing_table is not None)
    smoothing = cfg.smoothing if cfg.smoothing else 0.1
    asl = cfg.loss == "ASLSingleLabel"
    tables: Dict[torch.device, torch.Tensor] = {}
    own_generator = _own_generators(cfg)

    def table_on(dev: torch.device) -> torch.Tensor:
        if dev not in tables:
            tables[dev] = torch.as_tensor(
                np.asarray(category_smoothing_table, np.float32)).to(dev)
        return tables[dev]

    def criterion(logits, answers, categories):
        if use_smoothing:
            return category_smoothing_per_sample(
                logits, answers, categories, table_on(logits.device),
                smoothing)
        if asl:
            return asl_per_sample(logits, answers)
        return cross_entropy_per_sample(logits, answers)

    eval_criterion = (asl_per_sample if asl and not use_smoothing
                      else cross_entropy_per_sample)

    def train_step(state: TrainState, batch: Mapping,
                   draws: Optional[AugmentDraws] = None):
        if state.model is not model:
            raise ValueError("train_step: the state holds another model")
        dev = model.device
        b = _to_device(batch, BATCH_KEYS, dev)
        answers = b["answer"]
        categories = (torch.as_tensor(batch["category"]).to(dev)
                      if "category" in batch else torch.zeros_like(answers))
        generator = own_generator(dev) if draws is None else None
        with torch.no_grad():
            img = _augment(b["image"], generator, aug, draws)
        model.set_mode(deterministic=False, train_cnn=True)
        logits = model(img, b["tokens"], b["segment_ids"], b["input_mask"])
        loss = weighted_mean(criterion(logits, answers, categories),
                             b["weights"])
        loss.backward()
        state.reduce_gradients()
        metrics = {"loss": loss.detach()}
        with torch.no_grad():
            _global_rows(metrics, preds=torch.argmax(logits.detach(), dim=-1),
                         **_layout_rows(b, batch))
            metrics.update(_watched(model, state, False, histograms))
        state.apply_gradients()
        return state, metrics

    @torch.inference_mode()
    def eval_step(state: Optional[TrainState], batch: Mapping):
        b = _to_device(batch, BATCH_KEYS, model.device)
        model.eval()
        logits = model(process_batch(b["image"]), b["tokens"],
                       b["segment_ids"], b["input_mask"])
        loss = weighted_mean(eval_criterion(logits, b["answer"]),
                             b["weights"])
        return _global_rows({"loss": loss}, preds=torch.argmax(logits, dim=-1),
                            logits=logits, **_layout_rows(b, batch))

    return train_step, eval_step


def make_vqa_eval_step(
    model: torch.nn.Module, cfg: Config
) -> Callable[[Mapping], Dict[str, torch.Tensor]]:
    """The eval half of ``make_vqa_steps`` as ``eval_step(batch) ->
    {"loss", "preds", "logits"}``: the serving path, which needs no train
    state. ``batch`` as for ``make_vqa_steps``, as numpy arrays or tensors;
    they are moved to the model's device."""
    _, eval_step = make_vqa_steps(model, cfg)
    return lambda batch: eval_step(None, batch)


def make_img_only_steps(
    model: torch.nn.Module, cfg: Config, aug: AugmentSpec = FINETUNE_AUG,
) -> Tuple[Callable, Callable]:
    """Returns ``(train_step, eval_step)`` for ``ImageOnlyClassifier``
    (vqamed2019/utils.py:960-1232): plain fp32 cross entropy over the real
    samples, the keyword pathway fed from ``batch["keyword"]`` where the
    batch has it.

    ``train_step(state, batch, draws=None)`` runs augmentation, the forward
    with the trunk's BatchNorms on batch statistics, the loss, backward and
    ``apply_gradients``; it returns ``(state, metrics)`` with ``loss`` and
    ``preds``. Draws as in ``make_vqa_steps``. ``eval_step(state, batch)``
    returns ``loss``, ``preds`` and ``logits`` without augmentation or any
    update.

    ``batch``: ``image`` uint8 (B, S, S, 3), ``answer`` (B,), ``weights``
    (B,) and optionally ``keyword`` (B,)."""
    own_generator = _own_generators(cfg)

    def keyword_of(batch: Mapping, dev: torch.device):
        if "keyword" not in batch:
            return None
        return torch.as_tensor(batch["keyword"]).to(dev, non_blocking=True)

    def train_step(state: TrainState, batch: Mapping,
                   draws: Optional[AugmentDraws] = None):
        if state.model is not model:
            raise ValueError("train_step: the state holds another model")
        dev = model.device
        b = _to_device(batch, IMG_ONLY_BATCH_KEYS, dev)
        generator = own_generator(dev) if draws is None else None
        with torch.no_grad():
            img = _augment(b["image"], generator, aug, draws)
        model.train()
        logits = model(img, keyword_of(batch, dev))
        loss = weighted_mean(cross_entropy_per_sample(logits, b["answer"]),
                             b["weights"])
        loss.backward()
        metrics = {"loss": loss.detach(),
                   "preds": torch.argmax(logits.detach(), dim=-1)}
        state.apply_gradients()
        return state, metrics

    @torch.inference_mode()
    def eval_step(state: Optional[TrainState], batch: Mapping):
        dev = model.device
        b = _to_device(batch, IMG_ONLY_BATCH_KEYS, dev)
        model.eval()
        logits = model(process_batch(b["image"]), keyword_of(batch, dev))
        loss = weighted_mean(cross_entropy_per_sample(logits, b["answer"]),
                             b["weights"])
        return {"loss": loss, "preds": torch.argmax(logits, dim=-1),
                "logits": logits}

    return train_step, eval_step
