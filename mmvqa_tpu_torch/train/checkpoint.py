"""Checkpoints (counterpart of mmvqa_tpu/train/checkpoint.py), in the port's
own ``torch.save`` layout: the reference writes orbax, which the card's
machine does not have.

The reference's three kinds (SURVEY.md §5.4):
1. the recorder: the full train state (epoch, model, optimizer, step, the
   gradient accumulator, the scheduler) -> ``<save_dir>/recorder_2.pt``
   (roco_train.py:164-171);
2. the best-metric weights: the model's ``state_dict`` (parameters and
   BatchNorm running statistics), the reference's
   ``torch.save(model.state_dict())`` (train.py:265-283);
3. the cross-stage transfer: fine-tuning loads pretrained weights and keeps
   each tensor whose key and shape the new model shares
   (``filtered_restore``, train.py:125-137): the classifier's output layer
   and a position table of another length stay as the new model drew them.

A file written from a model on the card loads on the CPU and the other way
round: every load maps the tensors to the device of the model they go into.
A recorder written by the JAX package comes across through
``mmvqa_tpu_torch.bridge.from_flax_recorder``.

Under a layout (``TrainState.layout``) every rank calls the savers, which
gather the full tensors (parameters, Adam's moments, the accumulator), and
rank 0 alone writes: the file is the one a single process writes, and it
loads into a single process or into any layout, where each rank keeps its
blocks. A pipelined encoder's stacked layers are gathered over 'pipe' as
FSDP shards are over 'data', so the file is the one a single process with
that ``--pp_size`` writes. ``adapt_encoder_layout`` converts a checkpoint
between the sequential and the pipeline-stacked encoder layouts, exactly,
in either direction.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Tuple

import torch

from mmvqa_tpu_torch.core import distributed
from mmvqa_tpu_torch.train.state import TrainState

RECORDER = "recorder_2.pt"


def recorder_tree(epoch: int, state: TrainState,
                  scheduler_state: Mapping) -> Dict:
    """The recorder's contents, tensors copied to the CPU."""

    def cpu(tree):
        if torch.is_tensor(tree):
            return tree.detach().to("cpu", copy=True)
        if isinstance(tree, Mapping):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cpu(v) for v in tree)
        return tree

    layout = state.layout
    model_state = state.model.state_dict()
    optimizer = state.optimizer.state_dict()
    acc = state.acc_grads
    if layout is not None:  # the full tensors, as one process holds them
        names = [n for n, _ in state.model.named_parameters()]
        model_state = layout.full_state_dict()
        optimizer = dict(optimizer, state={
            i: {k: (layout.full(names[i], v) if k != "step" else v)
                for k, v in st.items()}
            for i, st in optimizer["state"].items()})
        acc = (None if acc is None else
               {n: layout.full(n, v) for n, v in acc.items()})
    return {
        "epoch": int(epoch),
        "model": cpu(model_state),
        "optimizer": cpu(optimizer),
        "step": int(state.step),
        "grad_accum": int(state.grad_accum),
        "mini_step": int(state.mini_step),
        "acc_grads": cpu(acc),
        "scheduler": dict(scheduler_state),
    }


def _writes() -> bool:
    """Rank 0 writes (every rank where no world is initialised)."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def load_recorder_tree(tree: Mapping, state: TrainState
                       ) -> Tuple[TrainState, Dict, int]:
    """Put a recorder's contents into ``state`` (its model and optimizer, in
    place, on the model's device). Returns (state, scheduler_state, epoch)."""
    if int(tree["grad_accum"]) != state.grad_accum:
        raise ValueError(
            f"the recorder accumulates over {tree['grad_accum']} micro-steps, "
            f"the state over {state.grad_accum}: resume with the original "
            "--grad_accum")
    model = state.model
    layout = state.layout
    optimizer, acc = tree["optimizer"], tree["acc_grads"]
    if layout is None:
        check_compatible(model.state_dict(), tree["model"], what="recorder")
        model.load_state_dict(tree["model"], strict=True)
    else:  # each rank keeps its blocks of the full tensors
        layout.load_full_state_dict(tree["model"])
        names = [n for n, _ in model.named_parameters()]
        optimizer = dict(optimizer, state={
            i: {k: (layout.local(names[int(i)], v) if k != "step" else v)
                for k, v in st.items()}
            for i, st in optimizer["state"].items()})
        acc = (None if acc is None else
               {n: layout.local(n, v) for n, v in acc.items()})
    # Adam's moments go to their parameter's device (its load_state_dict
    # casts them); the step counts stay on the CPU, as torch keeps them
    state.optimizer.load_state_dict(optimizer)
    dev = next(model.parameters()).device
    state.step = int(tree["step"])
    state.mini_step = int(tree["mini_step"])
    state.acc_grads = (None if acc is None else
                       {k: v.to(dev, torch.float32, copy=True)
                        for k, v in acc.items()})
    return state, dict(tree["scheduler"]), int(tree["epoch"])


def save_recorder(save_dir: str, epoch: int, state: TrainState,
                  scheduler_state: Mapping) -> None:
    """Full-state recorder (epoch, model, optimizer, step, accumulator,
    scheduler): ``<save_dir>/recorder_2.pt``."""
    tree = recorder_tree(epoch, state, scheduler_state)
    if _writes():
        os.makedirs(save_dir, exist_ok=True)
        torch.save(tree, os.path.join(save_dir, RECORDER))
    distributed.barrier()  # no rank reads the file before it is written


def restore_recorder(save_dir: str, state: TrainState
                     ) -> Tuple[TrainState, Dict, int]:
    """Returns (state, scheduler_state, epoch); ``state`` is restored in
    place."""
    # to the CPU first: load_recorder_tree moves each tensor where its
    # parameter lives, and Adam's step counts stay on the CPU
    tree = torch.load(os.path.join(save_dir, RECORDER), map_location="cpu",
                      weights_only=True)
    return load_recorder_tree(tree, state)


def save_weights(path: str, state: TrainState) -> None:
    """Model-only checkpoint: parameters and BatchNorm running statistics
    (under a layout the full ones, written by rank 0)."""
    tensors = (state.model.state_dict() if state.layout is None
               else state.layout.full_state_dict())
    tensors = {k: v.detach().cpu() for k, v in tensors.items()}
    if _writes():
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        torch.save(tensors, path)
    distributed.barrier()


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """The tensors on the CPU, wherever they were saved from:
    ``filtered_restore`` or ``load_state_dict`` moves them to the model."""
    return torch.load(path, map_location="cpu", weights_only=True)


def adapt_encoder_layout(model_state: Mapping[str, torch.Tensor],
                         loaded: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Convert a weights checkpoint between the sequential and the
    pipeline-stacked encoder layouts (``parallel/pipeline.py``) to the
    layout of ``model_state`` (the model's state dict, or any mapping with
    its keys), as ``mmvqa_tpu/train/checkpoint.py::adapt_encoder_layout``
    does: ``--pp_size`` above 1 stacks the encoder's layers under
    ``encoder.pp_layers``. The conversion is exact (stacking and unstacking
    copy the tensors bit for bit); a checkpoint whose layout agrees comes
    back as it is."""
    from mmvqa_tpu_torch.parallel.pipeline import (
        STACKED_KEY,
        stack_encoder_state,
        unstack_encoder_state,
    )

    def stacked(keys) -> bool:
        return any(k.startswith(f"encoder.{STACKED_KEY}.") for k in keys)

    want, have = stacked(model_state), stacked(loaded)
    if want == have or not any(k.startswith("encoder.") for k in loaded):
        return loaded
    return (stack_encoder_state(loaded) if want
            else unstack_encoder_state(loaded))


def filtered_restore(model_state: Mapping[str, torch.Tensor],
                     loaded: Mapping[str, torch.Tensor]
                     ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Cross-stage weight transfer with key filtering (train.py:128-137):
    keep every loaded tensor whose key exists in the target with the same
    shape, on the target's device and in its dtype; every other entry keeps
    the target's tensor. Returns (merged, n_loaded, n_total)."""
    merged, n_loaded = {}, 0
    for key, want in model_state.items():
        src = loaded.get(key)
        if src is not None and tuple(src.shape) == tuple(want.shape):
            merged[key] = src.to(want.device, want.dtype, copy=True)
            n_loaded += 1
        else:
            merged[key] = want
    return merged, n_loaded, len(model_state)


def check_compatible(model_state: Mapping[str, torch.Tensor],
                     loaded: Mapping[str, torch.Tensor],
                     what: str = "") -> None:
    """Fail fast with a readable message when a checkpoint's tensors do not
    match the constructed model (otherwise the mismatch surfaces inside
    ``load_state_dict`` or the first forward). Typical causes: a different
    --cnn_encoder / --transformer_model / --hidden_size than the checkpoint
    was trained with, or a vocab file of a different size."""
    problems = []
    for key in sorted(set(model_state) | set(loaded)):
        a, b = model_state.get(key), loaded.get(key)
        if a is None:
            problems.append(f"  extra in checkpoint: {key}")
        elif b is None:
            problems.append(f"  missing from checkpoint: {key}")
        elif tuple(a.shape) != tuple(b.shape):
            problems.append(f"  {key}: model {tuple(a.shape)} vs checkpoint "
                            f"{tuple(b.shape)}")
    if problems:
        head = "\n".join(problems[:12])
        more = (f"\n  ... and {len(problems) - 12} more"
                if len(problems) > 12 else "")
        raise ValueError(
            f"checkpoint{' ' + what if what else ''} is incompatible with "
            f"the constructed model ({len(problems)} mismatches):\n{head}"
            f"{more}\nCheck --cnn_encoder/--transformer_model/--hidden_size/"
            "--vocab_file against the values the checkpoint was trained with.")
