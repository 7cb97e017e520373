"""Flax -> torch weight bridge for the ported models (and back): MMBert with
any of its encoders (the feedback encoder's ``nn.scan`` parameters under
``encoder/segment``, one set for every window), ``ImageOnlyClassifier``
and ``SupConEncoder``.

Input: a JAX variables tree ``{"params": ..., "batch_stats": ...}`` as nested
dicts of numpy arrays (``jax.device_get`` of an ``MMBert.init`` or of a
restored checkpoint). Output: the port's ``state_dict``.

The port names its modules after the Flax tree, so every entry of the
port's state_dict names its Flax leaf: the module path with '.' for '/',
and a leaf name and layout fixed by the module type:

* conv kernels HWIO -> ``weight`` OIHW (depthwise (k, k, 1, C) -> (C, 1, k, k));
* Dense kernels (in, out) -> ``weight`` (out, in);
* Embed ``embedding`` -> ``weight``;
* LayerNorm / BatchNorm ``scale`` -> ``weight``;
* BatchNorm statistics ``batch_stats/.../mean|var`` -> ``running_mean|var``;
* ``token_conv_<i>/kernel`` (1, 1, K, C) -> the K1 weight (K, C);
* ``bias`` and raw params (``position_embeddings``, the feedback
  encoder's ``layer_weight``) as they are;
* a pipelined encoder's stacked layers (``encoder.pp_layers.*``, the JAX
  package's ``encoder/pp_layers`` tree): each leaf's rule applied to every
  row of its leading layer axis (``Stacked``).

``to_flax`` is the way back, for parameters and running statistics after a
train step; ``grads_to_flax`` carries the parameters' gradients the same way.
``from_flax_recorder`` carries a whole JAX recorder across (parameters,
statistics, Adam's moments, the accumulator of ``grad_accum``, step, epoch,
scheduler) into the port's recorder layout (``train.checkpoint``); each
moment and the accumulator take their parameter's transform.

The bridge raises on a Flax leaf that no entry takes, on one that two
entries take, on a missing leaf and on a shape that does not fit.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mmvqa_tpu_torch.models.effnetv2 import BatchNorm2d
from mmvqa_tpu_torch.models.visual_tokens import TokenHead

Array = np.ndarray


class Entry(NamedTuple):
    key: str                      # port state_dict key
    path: Tuple[str, ...]         # (collection, *flax path)
    to_torch: Callable[[Array], Array]
    to_flax: Callable[[Array], Array]


def _same(a: Array) -> Array:
    return a


def _hwio_to_oihw(a: Array) -> Array:
    return np.transpose(a, (3, 2, 0, 1))


def _oihw_to_hwio(a: Array) -> Array:
    return np.transpose(a, (2, 3, 1, 0))


def _t(a: Array) -> Array:
    return np.transpose(a)


def _token_kernel(a: Array) -> Array:
    return a[0, 0]


def _token_weight(a: Array) -> Array:
    return a[None, None]


class Stacked:
    """A transform applied to each row of a stacked leaf's leading layer
    axis; ``base`` is the one-layer transform."""

    def __init__(self, base: Callable[[Array], Array]):
        self.base = base

    def __call__(self, a: Array) -> Array:
        return np.stack([self.base(x) for x in a])


def _entry(key: str, module: nn.Module) -> Entry:
    e = _entry_of(key, module)
    if "pp_layers" in key.split("."):
        return Entry(e.key, e.path, Stacked(e.to_torch), Stacked(e.to_flax))
    return e


def _entry_of(key: str, module: nn.Module) -> Entry:
    mod_path, leaf = key.rsplit(".", 1) if "." in key else ("", key)
    flax = tuple(mod_path.split(".")) if mod_path else ()
    if leaf in ("running_mean", "running_var"):
        name = "mean" if leaf == "running_mean" else "var"
        return Entry(key, ("batch_stats", *flax, name), _same, _same)
    if leaf == "weight":
        if isinstance(module, nn.Conv2d):
            return Entry(key, ("params", *flax, "kernel"),
                         _hwio_to_oihw, _oihw_to_hwio)
        if isinstance(module, nn.Linear):
            return Entry(key, ("params", *flax, "kernel"), _t, _t)
        if isinstance(module, nn.Embedding):
            return Entry(key, ("params", *flax, "embedding"), _same, _same)
        if isinstance(module, (nn.LayerNorm, BatchNorm2d)):
            return Entry(key, ("params", *flax, "scale"), _same, _same)
        if isinstance(module, TokenHead):
            return Entry(key, ("params", *flax, "kernel"),
                         _token_kernel, _token_weight)
        raise TypeError(f"bridge: no rule for {key} ({type(module).__name__})")
    return Entry(key, ("params", *flax, leaf), _same, _same)


def mapping(model: nn.Module) -> List[Entry]:
    """One entry per state_dict key of ``model``."""
    out = []
    for key in model.state_dict():
        mod_path = key.rsplit(".", 1)[0] if "." in key else ""
        out.append(_entry(key, model.get_submodule(mod_path)))
    return out


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Array]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (str(k),)))
        else:
            flat[prefix + (str(k),)] = np.asarray(v)
    return flat


def to_state_dict(variables: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Flax variables -> a state_dict that ``model.load_state_dict`` takes
    with ``strict=True``."""
    return _convert(variables, model, mapping(model))


def _convert(variables: Mapping, model: nn.Module,
             entries: List[Entry]) -> Dict[str, torch.Tensor]:
    leaves = _flatten({c: variables.get(c, {}) for c in ("params", "batch_stats")})
    target = model.state_dict()
    used: Dict[Tuple[str, ...], str] = {}
    out = {}
    for e in entries:
        if e.path not in leaves:
            raise KeyError(f"bridge: Flax leaf {'/'.join(e.path)} (for {e.key}) is missing")
        if e.path in used:
            raise ValueError(
                f"bridge: Flax leaf {'/'.join(e.path)} mapped twice "
                f"({used[e.path]}, {e.key})"
            )
        used[e.path] = e.key
        arr = e.to_torch(leaves[e.path])
        want = tuple(target[e.key].shape)
        if arr.shape != want:
            raise ValueError(
                f"bridge: {'/'.join(e.path)} gives {arr.shape} for {e.key}, "
                f"which is {want}"
            )
        out[e.key] = torch.tensor(arr, dtype=target[e.key].dtype)
    unmapped = sorted("/".join(p) for p in leaves if p not in used)
    if unmapped:
        raise ValueError(f"bridge: Flax leaves left unmapped: {unmapped}")
    return out


def to_flax(state_dict: Mapping[str, torch.Tensor], model: nn.Module) -> Dict:
    """The inverse: a state_dict of ``model`` -> Flax variables of numpy
    arrays (fp32)."""
    return _to_tree(state_dict, mapping(model))


def _to_tree(tensors: Mapping[str, torch.Tensor], entries: List[Entry]) -> Dict:
    tree: Dict = {}
    for e in entries:
        arr = e.to_flax(tensors[e.key].detach().float().cpu().numpy())
        node = tree
        for part in e.path[:-1]:
            node = node.setdefault(part, {})
        node[e.path[-1]] = np.array(arr)  # a copy: the tensors live on
    return tree


def grads_to_flax(model: nn.Module) -> Dict:
    """The ``.grad`` of every parameter of ``model`` as a Flax ``params``
    tree of numpy arrays (fp32), laid out as ``jax.grad`` of the JAX model's
    loss gives it; a parameter without a gradient gives zeros."""
    grads = {name: (torch.zeros_like(p) if p.grad is None else p.grad)
             for name, p in model.named_parameters()}
    entries = [e for e in mapping(model) if e.path[0] == "params"]
    return _to_tree({e.key: grads[e.key] for e in entries}, entries)["params"]


def flax_names(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> its Flax path under ``params`` ('a/b/kernel'), the
    names the JAX package gives a parameter's histograms."""
    return {e.key: "/".join(e.path[1:]) for e in mapping(model)
            if e.path[0] == "params"}


def _params_to_torch(tree: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """A params-shaped Flax tree (parameters, a moment, an accumulator) ->
    one tensor a parameter name, through the parameter's transform."""
    entries = [e for e in mapping(model) if e.path[0] == "params"]
    return _convert({"params": tree}, model, entries)


def from_flax_recorder(state, *, params: Mapping, batch_stats: Mapping,
                       mu: Mapping, nu: Mapping, count: int, step: int,
                       epoch: int, scheduler: Mapping,
                       lr: Optional[float] = None,
                       acc_grads: Optional[Mapping] = None,
                       mini_step: int = 0) -> Dict:
    """A JAX recorder, as plain nested dicts of numpy arrays, -> the port's
    recorder tree for ``state`` (a ``train.state.TrainState``: its model
    gives the layout, its optimizer the settings), which
    ``train.checkpoint.load_recorder_tree`` puts into a state.

    ``mu``, ``nu`` and ``count`` are Adam's (inside ``MultiSteps`` where the
    run accumulates: there ``count`` counts real updates); ``acc_grads`` and
    ``mini_step`` are ``MultiSteps``' accumulator and micro-step; ``lr`` the
    injected learning rate (the state's own where None)."""
    model = state.model
    mus, nus = _params_to_torch(mu, model), _params_to_torch(nu, model)
    names = [name for name, _ in model.named_parameters()]
    adam = {}
    if int(count) > 0:  # torch keeps no state before the first update
        adam = {i: {"step": torch.tensor(float(count)),
                    "exp_avg": mus[name], "exp_avg_sq": nus[name]}
                for i, name in enumerate(names)}
    groups = state.optimizer.state_dict()["param_groups"]
    if len(groups) != 1 or groups[0]["params"] != list(range(len(names))):
        raise ValueError("bridge: the optimizer must hold the model's "
                         "parameters in one group, in their order")
    group = dict(groups[0])
    if lr is not None:
        group["lr"] = float(lr)
    if int(mini_step) and state.grad_accum == 1:
        raise ValueError("bridge: the recorder is mid-accumulation but the "
                         "state does not accumulate")
    return {
        "epoch": int(epoch),
        "model": to_state_dict({"params": params,
                                "batch_stats": batch_stats}, model),
        "optimizer": {"state": adam, "param_groups": [group]},
        "step": int(step),
        "grad_accum": state.grad_accum,
        "mini_step": int(mini_step),
        "acc_grads": (_params_to_torch(acc_grads, model)
                      if int(mini_step) else None),
        # plain Python numbers, which a weights-only load takes
        "scheduler": {k: v.item() if hasattr(v, "item") else v
                      for k, v in scheduler.items()},
    }

