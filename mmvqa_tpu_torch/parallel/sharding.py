"""Parameter and batch placement over the ('data', 'model', 'context',
'pipe') mesh (counterpart of mmvqa_tpu/parallel/sharding.py).

The rule is the JAX package's, copied, and read on the Flax tree: each of
the port's parameters names its Flax leaf through the bridge
(``bridge.mapping``), so ``flax_spec`` sees the path and the shape that
``infer_param_shardings`` sees, and ``param_placements`` turns the Flax
dimension it picks into the dimension of the port's tensor.

Tensor parallelism (Megatron's column and row split, where the dimension
divides by the 'model' size):
* ``COLUMN_PARALLEL`` kernels shard their output features, ``ROW_PARALLEL``
  ones their input features, ``VOCAB_PARALLEL`` tables their rows;
* everything else, 1-D leaves included, is replicated.

FSDP (``--fsdp``): a leaf of at least ``FSDP_MIN_SIZE`` elements and two or
more dimensions also shards its largest still-free dimension over 'data';
embedding tables on their row dimension only, the token heads' kernels on
their output channels only (``_with_fsdp`` and the cases of
``infer_param_shardings``, :89-175).

Pipeline parallelism: a leaf of the stacked layers (``pp_layers``, a
pipelined encoder's) shards its leading layer axis over 'pipe' where the
layer count divides, before and instead of any other rule
(``sharding.py:120-131``). Nothing is sharded over 'context': context
parallelism splits the batch's token axis (``place_batch``).

``Layout`` applies the rule to a model on a rank: the model keeps the
'model' blocks of its tensor-parallel leaves as its parameters (its modules
learn how they are split: ``tp_mode`` 'col', 'row' or 'vocab'), and under
FSDP only this rank's 'data' block of each FSDP leaf, at rest and in the
optimizer (ZeRO-3's memory, the JAX package's ``--fsdp``). A unit of the
model (``fsdp_units``: a trunk block, an encoder layer or the whole
feedback encoder, the embeddings, a token head, a classifier head) gathers
its blocks over 'data' in one all-gather when its forward starts, puts the
full tensors where its modules read their parameters for that forward, and
frees them when it ends (however many times the forward used them); its
backward gathers them once more and frees them when it ends (``_Unit``).
The gather's backward reduce-scatters the full gradients over 'data' into
the blocks' ``.grad`` (``_GatherShards``). Adam's moments are made for what the
optimizer steps, so they follow their parameter's placement (``place_state``
of the JAX package). Running statistics are replicated.

Its gradient reduction (``reduce_gradients``) sums each replicated
parameter's gradient over the axes that replicate it (an FSDP block's over
'data' is summed by its unit's gather), with one exception.
Over 'data' every rank holds its rows' part of the loss, so the ranks'
gradients are parts of the whole and are summed. Over 'context' and 'pipe'
most parameters are the same: a rank's token block, or stage 0's trunk and
embeddings, gives its part. But the heads on values that the axis
replicates (``MMBert.replicated_heads``: every head under 'pipe', which each
stage computes on the broadcast encoder output; the pooled heads under
'context') are computed whole by every rank from the same loss, which
counts once: their gradients are averaged over the axis, which keeps one
copy. A single sum over the group would count those cp or pp times.
Over 'model' a replicated parameter is computed alike on every rank.

``shard_state`` and ``gather_state`` turn a full state dict into a rank's
shards and back without a process group; ``Layout.full_state_dict`` and
``Layout.load_full_state_dict`` do the same on a live world, and
``Layout.full`` gives any one tensor at its full shape. ``module_norms``
takes the per-module norms of the reduced gradient (``--watch``), each value
counted once, in one all-reduce over the world.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.core import distributed
from mmvqa_tpu_torch.core.mesh import (
    CONTEXT_AXIS,
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    MeshSpec,
    coords_of,
)
from mmvqa_tpu_torch.parallel.comm import block

FSDP_MIN_SIZE = 2 ** 15

COLUMN_PARALLEL = (
    "fc1", "ff1", "w_in", "pw_exp", "proj_q", "proj_k", "proj_v", "kqv",
    "to_q", "shared_kv", "classifier_2", "head_2",
)
ROW_PARALLEL = ("fc2", "ff2", "w_out", "proj", "pw_proj", "to_out")
VOCAB_PARALLEL = ("word_embeddings",)


def _spec_for(names: Sequence[str], shape: Tuple[int, ...], tp: int) -> tuple:
    """The 'model' part of a Flax leaf's spec (sharding.py:57-87)."""
    if len(shape) < 2 or tp <= 1:
        return ()
    if names[-1] not in ("kernel", "embedding"):
        return ()
    module = names[-2] if len(names) >= 2 else ""
    head, _, tail = module.rpartition("_")
    base = head if head and tail.isdigit() else module

    def col():
        if shape[-1] % tp == 0:
            return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
        return ()

    def row():
        if shape[-2] % tp == 0:
            return (None,) * (len(shape) - 2) + (MODEL_AXIS, None)
        return ()

    if names[-1] == "embedding" and any(v in names for v in VOCAB_PARALLEL):
        return (MODEL_AXIS,) if shape[0] % tp == 0 else ()
    if base in COLUMN_PARALLEL or module in COLUMN_PARALLEL:
        return col()
    if base in ROW_PARALLEL or module in ROW_PARALLEL:
        return row()
    return ()


def _with_fsdp(spec: tuple, shape: Tuple[int, ...], dp: int,
               dims: Optional[Sequence[int]] = None) -> tuple:
    """'data' on the largest still-free dimension divisible by ``dp``
    (sharding.py:89-110); ``spec`` unchanged where none is."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    candidates = range(len(shape)) if dims is None else dims
    free = [d for d in candidates
            if entries[d] is None and shape[d] % dp == 0]
    if not free:
        return tuple(spec)
    d = max(free, key=lambda i: shape[i])
    entries[d] = DATA_AXIS
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


STACKED_KEY = "pp_layers"


def flax_spec(names: Sequence[str], shape: Tuple[int, ...], dp: int, tp: int,
              fsdp: bool, pp: int = 1) -> tuple:
    """The spec ``infer_param_shardings`` gives the Flax leaf ``names`` of
    ``shape`` on a (dp, tp, cp, pp) mesh, as a tuple of axis names or
    None."""
    if pp > 1 and STACKED_KEY in names and len(shape) >= 1 \
            and shape[0] % pp == 0:
        return (PIPE_AXIS,)
    spec = _spec_for(names, shape, tp)
    if fsdp and dp > 1 and int(np.prod(shape)) >= FSDP_MIN_SIZE \
            and len(shape) >= 2:
        if names[-1] == "embedding":
            if spec == () and shape[0] % dp == 0:
                spec = (DATA_AXIS,)
        elif names[-1] == "kernel" and len(shape) >= 3 and len(names) >= 2 \
                and str(names[-2]).startswith("token_conv"):
            spec = _with_fsdp(spec, shape, dp, dims=(len(shape) - 1,))
        else:
            spec = _with_fsdp(spec, shape, dp)
    return spec


# the Flax dimension -> the port's dimension, for each of the bridge's
# transforms
_TORCH_DIM = {
    bridge._same: lambda d, n: d,
    bridge._t: lambda d, n: n - 1 - d,
    bridge._hwio_to_oihw: lambda d, n: (2, 3, 1, 0)[d],
    bridge._token_kernel: lambda d, n: d - 2,
}


def _torch_dim(to_torch, d: int, n: int) -> int:
    """The port's dimension of Flax dimension ``d`` of an n-dimensional
    leaf, through the bridge's transform (a stacked leaf's layer axis is
    dimension 0 in both)."""
    if isinstance(to_torch, bridge.Stacked):
        return 0 if d == 0 else 1 + _TORCH_DIM[to_torch.base](d - 1, n - 1)
    return _TORCH_DIM[to_torch](d, n)


class Placement(NamedTuple):
    """Where a parameter of the port lies: its Flax path and spec, and the
    port's dimensions split over 'model', over 'data' and over 'pipe'
    (None: whole)."""

    flax_path: str
    spec: tuple
    tp_dim: Optional[int]
    fsdp_dim: Optional[int]
    pipe_dim: Optional[int] = None


def param_placements(model: nn.Module, dp: int, tp: int,
                     fsdp: bool = False, pp: int = 1) -> Dict[str, Placement]:
    """One ``Placement`` a parameter of ``model`` (full shapes), by the JAX
    rule on the Flax tree."""
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    out = {}
    for e in bridge.mapping(model):
        if e.path[0] != "params" or e.key not in shapes:
            continue
        flax_shape = np.shape(e.to_flax(np.broadcast_to(
            np.float32(0), shapes[e.key])))
        spec = flax_spec(e.path[1:], flax_shape, dp, tp, fsdp, pp)
        dims = {axis: _torch_dim(e.to_torch, d, len(flax_shape))
                for d, axis in enumerate(spec) if axis is not None}
        out[e.key] = Placement("/".join(e.path[1:]), spec,
                               dims.get(MODEL_AXIS), dims.get(DATA_AXIS),
                               dims.get(PIPE_AXIS))
    return out


def local_block(t: torch.Tensor, pl: Placement, dp: int, tp: int,
                data_rank: int, model_rank: int,
                fsdp: bool = True, pp: int = 1,
                pipe_rank: int = 0) -> torch.Tensor:
    """A rank's block of the full tensor ``t``: its 'pipe' block, its
    'model' block, then (with ``fsdp``) its 'data' block of that."""
    if pl.pipe_dim is not None and pp > 1:
        t = block(t, pl.pipe_dim, pp, pipe_rank)
    if pl.tp_dim is not None and tp > 1:
        t = block(t, pl.tp_dim, tp, model_rank)
    if fsdp and pl.fsdp_dim is not None and dp > 1:
        t = block(t, pl.fsdp_dim, dp, data_rank)
    return t


def shard_state(state: Mapping[str, torch.Tensor],
                placements: Mapping[str, Placement], dp: int, tp: int,
                rank: int, cp: int = 1,
                pp: int = 1) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s shards of a full state dict (the mesh's rank order,
    ``((d * tp + m) * cp + c) * pp + p``); entries without a placement
    (running statistics) stay whole."""
    d, m, _, p = coords_of(rank, (dp, tp, cp, pp))
    return {k: (local_block(v, placements[k], dp, tp, d, m, pp=pp,
                            pipe_rank=p)
                if k in placements else v.clone())
            for k, v in state.items()}


def gather_state(shards: Sequence[Mapping[str, torch.Tensor]],
                 placements: Mapping[str, Placement], dp: int,
                 tp: int, cp: int = 1,
                 pp: int = 1) -> Dict[str, torch.Tensor]:
    """The full state dict from every rank's shards, in rank order."""
    from mmvqa_tpu_torch.core.mesh import rank_of

    out = {}
    for k, v0 in shards[0].items():
        pl = placements.get(k)
        if pl is None:
            out[k] = v0.clone()
            continue
        per_pipe = []
        for p in range(pp):
            per_model = []
            for m in range(tp):
                parts = [shards[rank_of((d, m, 0, p), (dp, tp, cp, pp))][k]
                         for d in range(dp)]
                per_model.append(torch.cat(parts, pl.fsdp_dim)
                                 if pl.fsdp_dim is not None and dp > 1
                                 else parts[0])
            per_pipe.append(torch.cat(per_model, pl.tp_dim)
                            if pl.tp_dim is not None and tp > 1
                            else per_model[0])
        out[k] = (torch.cat(per_pipe, pl.pipe_dim)
                  if pl.pipe_dim is not None and pp > 1 else per_pipe[0])
    return out


# the batch fields with a token axis (B, T, ...), split over 'context'
# (the JAX package's SEQUENCE_KEYS)
SEQUENCE_KEYS = frozenset(
    ("tokens", "aug_tokens", "segment_ids", "input_mask", "labels",
     "aug_labels"))


def context_block(batch: Mapping, spec: MeshSpec) -> Dict:
    """This rank's block of the token axis of each sequence field (every
    other field as it is): the context coordinate's T / cp positions."""
    cp, c = spec.context_size, spec.context_rank
    if cp == 1:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        if k not in SEQUENCE_KEYS or isinstance(v, str):
            out[k] = v
            continue
        T = v.shape[1]
        if T % cp:
            raise ValueError(f"batch field {k!r} has {T} positions, not "
                             f"divisible by cp_size {cp}")
        t = T // cp
        out[k] = v[:, c * t:(c + 1) * t]
    return out


def place_batch(batch: Mapping, spec: MeshSpec) -> Dict:
    """This rank's part of a global batch (``place_batch`` of the JAX
    package): its data coordinate's contiguous rows, and of the sequence
    fields its context coordinate's block of the token axis; the model and
    pipe ranks of a group get the same."""
    dp, d = spec.data_size, spec.data_rank
    out = {}
    for k, v in batch.items():
        if isinstance(v, str):
            out[k] = v
            continue
        n = len(v)
        if n % dp:
            raise ValueError(f"batch field {k!r} has {n} rows, not "
                             f"divisible by dp_size {dp}")
        b = n // dp
        out[k] = v[d * b:(d + 1) * b]
    return context_block(out, spec)


def _tp_mode(pl: Placement, module: nn.Module) -> str:
    """'vocab' for a table, else 'col' or 'row': a Linear's weight is (out,
    in), a Conv2d's (out, in, kh, kw)."""
    if isinstance(module, nn.Embedding):
        return "vocab"
    return "col" if pl.tp_dim == 0 else "row"


def _own(t: torch.Tensor) -> torch.Tensor:
    """``t`` in storage of its own size (a block of dim 0 is a view of the
    whole tensor, which would stay allocated)."""
    if t.untyped_storage().nbytes() == t.numel() * t.element_size():
        return t
    return t.clone()


def fsdp_units(model: nn.Module) -> List[List[Tuple[str, nn.Module]]]:
    """The units that gather their FSDP blocks together, each a list of
    (name, module) that a forward calls in that order. A module's
    ``fsdp_groups()`` names its children's units (``MMBert``: the
    embeddings, the heads; a trunk: its stem and each stage; the visual
    tokenizer: its token heads; the BERT encoder: each layer), else each
    child is one; a unit of one module marked ``fsdp_split`` (the trunks,
    the visual tokenizer, the layer-by-layer encoders) is replaced by its
    own units. A unit runs once in a forward, however often it uses its
    parameters inside (the feedback encoder's windows)."""
    out = []

    def walk(prefix: str, mod: nn.Module) -> None:
        groups = (mod.fsdp_groups() if hasattr(mod, "fsdp_groups")
                  else [[name] for name, _ in mod.named_children()])
        for names in groups:
            members = [(f"{prefix}{n}", getattr(mod, n)) for n in names
                       if hasattr(mod, n)]
            if len(members) == 1 and getattr(members[0][1], "fsdp_split",
                                             False):
                walk(members[0][0] + ".", members[0][1])
            elif members:
                out.append(members)

    walk("", model)
    return out


class _GatherShards(torch.autograd.Function):
    """A unit's FSDP blocks gathered over 'data' in one all-gather (each
    block moved to its 'data' dimension first); the backward reduce-scatters
    the full tensors' gradients, a missing one as zeros, into the blocks'
    gradients, and drops the unit's gathered tensors (``_Unit``)."""

    @staticmethod
    def forward(ctx, unit, dims, group, dp, *shards):
        ctx.unit, ctx.dims, ctx.group, ctx.dp = unit, dims, group, dp
        ctx.shapes = [s.shape for s in shards]
        ctx.like = shards[0].new_empty(())
        return _gather_shards(shards, dims, group, dp)

    @staticmethod
    def backward(ctx, *grads):
        dp = ctx.dp
        rows = []
        for g, shape, d in zip(grads, ctx.shapes, ctx.dims):
            full = list(shape)
            full[d] *= dp
            if g is None:
                g = ctx.like.new_zeros(full)
            rows.append(g.movedim(d, 0).reshape(dp, -1))
        local = torch.empty(sum(r.shape[1] for r in rows),
                            dtype=rows[0].dtype, device=rows[0].device)
        distributed.reduce_scatter_tensor(
            local, torch.cat(rows, dim=1).reshape(-1), ctx.group)
        out = []
        for piece, shape, d in zip(local.split([r.shape[1] for r in rows]),
                                   ctx.shapes, ctx.dims):
            moved = (shape[d],) + tuple(s for i, s in enumerate(shape)
                                        if i != d)
            out.append(piece.view(moved).movedim(0, d).contiguous())
        ctx.unit.again = None  # the unit's backward has ended
        return (None, None, None, None, *out)


def _gather_shards(shards, dims, group, dp) -> Tuple[torch.Tensor, ...]:
    flats = [s.detach().movedim(d, 0).reshape(-1)
             for s, d in zip(shards, dims)]
    local = torch.cat(flats)
    out = local.new_empty(dp * local.numel())
    distributed.all_gather_into_tensor(out, local, group)
    rows = out.view(dp, -1).split([f.numel() for f in flats], dim=1)
    fulls = []
    for s, d, r in zip(shards, dims, rows):
        moved = s.movedim(d, 0)
        shape = (dp * moved.shape[0],) + tuple(moved.shape[1:])
        fulls.append(r.reshape(shape).movedim(0, d).contiguous())
    return tuple(fulls)


class _Saved:
    """A tensor that autograd saved in a unit's forward as a view of one of
    its gathered tensors: which one, and the view."""

    __slots__ = ("i", "size", "stride", "offset")

    def __init__(self, i, t):
        self.i, self.size = i, t.size()
        self.stride, self.offset = t.stride(), t.storage_offset()


class _Unit:
    """One unit's FSDP leaves: (owner module, attribute, parameter, 'data'
    dimension) each, gathered at the unit's forward (``gather``) and put in
    the owners' instance dictionaries, where attribute lookup finds them
    before the module's parameters; ``release`` takes them out.

    With autograd on, what the forward saves of the gathered tensors is
    saved as a ``_Saved`` view description (a saved-tensor hook), so the
    gathered tensors are freed when the forward ends; the first saved view
    the backward asks for gathers them again, once (``again``), and the
    gather's backward drops them. A unit whose forward uses its parameters
    many times (the feedback encoder's windows) thus gathers twice a step,
    however many windows it runs."""

    def __init__(self, leaves, group, dp):
        self.leaves, self.group, self.dp = leaves, group, dp
        self.storages: Dict[int, int] = {}
        self.again: Optional[Tuple[torch.Tensor, ...]] = None
        self._hooks = None

    def _gather(self) -> Tuple[torch.Tensor, ...]:
        with torch.no_grad():
            return _gather_shards([p for _, _, p, _ in self.leaves],
                                  [d for _, _, _, d in self.leaves],
                                  self.group, self.dp)

    def gather(self, module, args) -> None:
        if self._hooks is not None:  # a forward that raised inside the unit
            self.release(module, args, None)
        shards = [p for _, _, p, _ in self.leaves]
        dims = [d for _, _, _, d in self.leaves]
        self.again = None  # never a tensor gathered before this forward
        if torch.is_grad_enabled() and any(p.requires_grad for p in shards):
            fulls = _GatherShards.apply(self, dims, self.group, self.dp,
                                        *shards)
            self.storages = {f.untyped_storage().data_ptr(): i
                             for i, f in enumerate(fulls)}
            self._hooks = torch.autograd.graph.saved_tensors_hooks(
                self._pack, self._unpack)
            self._hooks.__enter__()
        else:
            fulls = self._gather()
        for (owner, attr, _, _), full in zip(self.leaves, fulls):
            owner.__dict__[attr] = full

    def release(self, module, args, out) -> None:
        for owner, attr, _, _ in self.leaves:
            owner.__dict__.pop(attr, None)
        if self._hooks is not None:
            self._hooks.__exit__(None, None, None)
            self._hooks = None
        self.storages = {}

    def _pack(self, t: torch.Tensor):
        i = (self.storages.get(t.untyped_storage().data_ptr())
             if t.numel() else None)
        return t if i is None else _Saved(i, t)

    def _unpack(self, packed):
        if not isinstance(packed, _Saved):
            return packed
        if self.again is None:
            self.again = self._gather()
        return self.again[packed.i].as_strided(packed.size, packed.stride,
                                               packed.offset)


class Layout:
    """A model placed on this rank of ``spec``: tensor-parallel blocks as the
    model's parameters, and under FSDP the 'data' blocks of the FSDP leaves,
    gathered by their units at use. Build it on every rank from the same
    full model; see the module docstring."""

    def __init__(self, model: nn.Module, spec: MeshSpec, fsdp: bool = False):
        self.spec = spec
        self.fsdp = fsdp and spec.data_size > 1
        dp, tp, pp = spec.data_size, spec.model_size, spec.pipe_size
        self.placements = param_placements(model, dp, tp, self.fsdp, pp)
        self.model = model
        # the full shapes, for checking a checkpoint against
        self.full_shapes = {k: torch.empty(v.shape, device="meta")
                            for k, v in model.state_dict().items()}
        if tp > 1 or spec.context_size > 1 or pp > 1:
            # The model ranks hold the same rows, and the collectives give
            # every rank the same sums, so a replicated parameter's gradient
            # is computed from the same values on each of them; cuDNN's
            # deterministic algorithms make it the same bits too (its
            # default weight gradients may add in another order each call),
            # so the replicas stay equal with no collective of their own.
            # The context and pipe ranks run the trunk on the same images:
            # the same algorithms keep their running statistics equal.
            torch.backends.cudnn.deterministic = True
        self._mark(model)
        rng = getattr(model, "dropout_rng", None)
        if rng is not None:  # one dropout stream a data rank and token block
            rng.fold_rank(spec.data_rank * spec.context_size
                          + spec.context_rank)
        heads = getattr(model, "replicated_heads", lambda axis: ())
        # the parameters whose gradient each rank of an axis holds whole
        self.whole = {axis: {name for name in self.placements
                             if name.split(".")[0] in heads(axis)}
                      for axis in (CONTEXT_AXIS, PIPE_AXIS)}
        with torch.no_grad():
            for name, p in model.named_parameters():
                before = p.data
                p.data = self.local(name, p.data)
                if p.data is not before:
                    p.data = _own(p.data)
        self._hooks = []
        if self.fsdp:
            self._units(model)

    def fsdp_dim(self, name: str) -> Optional[int]:
        return self.placements[name].fsdp_dim if self.fsdp else None

    def _units(self, model: nn.Module) -> None:
        """Hook every FSDP unit (``fsdp_units``); refuse a model with an
        FSDP leaf outside every unit."""
        params = dict(model.named_parameters())
        left = {n for n in params if self.fsdp_dim(n) is not None}
        for members in fsdp_units(model):
            leaves = []
            for prefix, member in members:
                for name, _ in member.named_parameters(prefix=prefix):
                    if name not in left:
                        continue
                    left.discard(name)
                    owner_name, _, attr = name.rpartition(".")
                    leaves.append((model.get_submodule(owner_name), attr,
                                   params[name], self.fsdp_dim(name)))
            if not leaves:
                continue
            # gathered when its first module starts, freed when its last
            # one ends
            u = _Unit(leaves, self.spec.data_group, self.spec.data_size)
            self._hooks += [
                members[0][1].register_forward_pre_hook(u.gather),
                members[-1][1].register_forward_hook(u.release,
                                                     always_call=True)]
        if left:
            raise NotImplementedError(
                f"FSDP: {sorted(left)[:3]} lie in no unit of "
                f"{type(model).__name__} (parallel.sharding.fsdp_units)")

    def _mark(self, model: nn.Module) -> None:
        """Tell each split module how it is split, and refuse a model whose
        forward does not know a split the rule asks for."""
        if self.spec.model_size == 1:
            return
        modules = dict(model.named_modules())
        for name, pl in self.placements.items():
            if pl.tp_dim is None:
                continue
            mod_name = name.rpartition(".")[0]
            mod = modules[mod_name]
            # a parent that splits this module's computation says so
            if not getattr(mod, "tp_capable", False):
                raise NotImplementedError(
                    f"tensor parallelism over {mod_name} "
                    f"({type(mod).__name__}) is not written in "
                    "mmvqa_tpu_torch: its model must run with --tp_size 1")
            mod.tp_mode = _tp_mode(pl, mod)
        for mod in model.modules():
            prepare = getattr(mod, "prepare_tp", None)
            if prepare is not None:
                prepare(self.spec.model_size)

    # the optimizer's view ------------------------------------------------

    def replication(self, name: str) -> int:
        """How many ranks hold the same values of ``name``'s optimizer
        tensor (a global norm counts each value once)."""
        pl = self.placements[name]
        r = self.spec.context_size
        if pl.tp_dim is None:
            r *= self.spec.model_size
        if self.fsdp_dim(name) is None:
            r *= self.spec.data_size
        if pl.pipe_dim is None:
            r *= self.spec.pipe_size
        return r

    @torch.no_grad()
    def _sums_of_squares(self, groups: Sequence[Sequence[Tuple[
            str, torch.Tensor]]]) -> torch.Tensor:
        """One sum a group of (name, gradient) over the whole gradient,
        each value counted once, in one all-reduce over the world."""
        import torch.distributed as dist

        total = torch.stack([torch.stack([
            g.float().square().sum() / self.replication(n)
            for n, g in grads]).sum() for grads in groups])
        if self.spec.world_size > 1:
            distributed.all_reduce(total, dist.group.WORLD)
        return total

    def global_norm(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The L2 norm of the whole gradient from every rank's
        ``grads`` (of the model's parameters), each value counted once."""
        return self._sums_of_squares([list(grads.items())])[0].sqrt()

    def module_norms(self) -> Dict[str, torch.Tensor]:
        """The L2 norm of the reduced gradient of each of the model's
        top-level modules (the single process's children: a pipeline
        stage's stacked layers belong to ``encoder``), as one process's
        gradient gives it (collective)."""
        children: Dict[str, list] = {}
        for name, p in self.model.named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            children.setdefault(name.split(".")[0], []).append((name, g))
        order = [n for n, _ in self.model.named_children() if n in children]
        sums = self._sums_of_squares([children[n] for n in order])
        return dict(zip(order, sums.sqrt().unbind()))

    @torch.no_grad()
    def _reduce_over(self, axis: str, n: int, group) -> None:
        """Sum over ``axis`` the gradients of the parameters it replicates,
        the mean for those each rank holds whole (the module docstring); one
        bucket."""
        whole = self.whole[axis]
        named = [(name, p) for name, p in self.model.named_parameters()
                 if axis != PIPE_AXIS
                 or self.placements[name].pipe_dim is None]
        grads = [(torch.zeros_like(p) if p.grad is None else p.grad)
                 * (1.0 / n if name in whole else 1.0) for name, p in named]
        flat = torch.cat([g.reshape(-1) for g in grads])
        distributed.all_reduce(flat, group)
        for (_, p), piece in zip(named, flat.split(
                [g.numel() for g in grads])):
            p.grad = piece.view_as(p)

    @torch.no_grad()
    def reduce_gradients(self) -> None:
        """Reduce the ranks' gradients over 'context' and 'pipe' (the module
        docstring), then sum the ranks' partial gradients over 'data': one
        all-reduce of the replicated parameters' ``.grad``; an FSDP block's
        was summed by its unit's gather. A missing gradient counts as
        zeros. A parameter replicated over 'model' needs nothing more: every
        model rank computes its gradient from the same values in the same
        way (``__init__``)."""
        spec = self.spec
        if spec.context_size > 1:
            self._reduce_over(CONTEXT_AXIS, spec.context_size,
                              spec.context_group)
        if spec.pipe_size > 1:
            self._reduce_over(PIPE_AXIS, spec.pipe_size, spec.pipe_group)
        plain: List[torch.Tensor] = []
        for name, p in self.model.named_parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if self.fsdp_dim(name) is None:
                plain.append(p)
        if plain and spec.data_size > 1:
            flat = torch.cat([p.grad.reshape(-1) for p in plain])
            distributed.all_reduce(flat, spec.data_group)
            for p, piece in zip(plain, flat.split([p.numel()
                                                   for p in plain])):
                p.grad = piece.view_as(p)

    def rest_problems(self) -> List[str]:
        """What is wrong with the placed model at rest (between steps): an
        FSDP leaf that is more than its block, a block whose storage holds
        more than itself, a gathered tensor left in a module."""
        out = []
        for name, p in self.model.named_parameters():
            want = tuple(self.local(name, self.full_shapes[name]).shape)
            if tuple(p.shape) != want:
                out.append(f"{name}: holds {tuple(p.shape)}, its block is "
                           f"{want}")
            if p.untyped_storage().nbytes() != p.numel() * p.element_size():
                out.append(f"{name}: its storage holds "
                           f"{p.untyped_storage().nbytes()} bytes")
            owner_name, _, attr = name.rpartition(".")
            if attr in self.model.get_submodule(owner_name).__dict__:
                out.append(f"{name}: a gathered tensor stays in its module")
        return out

    # full tensors <-> this rank's --------------------------------------------

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full tensor placed like ``name``."""
        return local_block(full, self.placements[name], self.spec.data_size,
                           self.spec.model_size, self.spec.data_rank,
                           self.spec.model_rank, self.fsdp,
                           self.spec.pipe_size, self.spec.pipe_rank)

    @torch.no_grad()
    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block ``t`` (collective: every
        rank calls it, in the same order)."""
        from mmvqa_tpu_torch.parallel import comm

        pl = self.placements[name]
        if self.fsdp_dim(name) is not None:
            t = comm.gather_over(t, DATA_AXIS, pl.fsdp_dim)
        if pl.tp_dim is not None:
            t = comm.gather_over(t, MODEL_AXIS, pl.tp_dim)
        if pl.pipe_dim is not None:
            t = comm.gather_over(t, PIPE_AXIS, pl.pipe_dim)
        return t

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's full state dict, as one process holds it
        (collective)."""
        return {k: (self.full(k, v) if k in self.placements
                    else v.detach())
                for k, v in self.model.state_dict().items()}

    @torch.no_grad()
    def load_full_state_dict(self, state: Mapping[str, torch.Tensor]) -> None:
        """Load a full state dict into the placed model."""
        own = self.model.state_dict()
        self.model.load_state_dict(
            {k: (self.local(k, v) if k in self.placements else v)
             for k, v in state.items() if k in own}, strict=True)
