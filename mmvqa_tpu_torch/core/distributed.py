"""One process per rank (counterpart of mmvqa_tpu/core/distributed.py).

``init_from_env`` joins the ``torch.distributed`` world that ``torchrun``
describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``) or that the caller names, on a device it
states: the card ``LOCAL_RANK`` modulo the cards present, or the CPU where
there is none or the caller asks for it. A rank given a card never runs on
the CPU. The backend rule, printed at start: NCCL where every rank of the
host has a card of its own, gloo where ranks share a card (NCCL refuses two
ranks on one device) or run on the CPU.

The layouts use three collectives and one point-to-point exchange, and no
others: ``all_reduce`` (sum), ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` (sum), each along dim 0 over a given group, and
``exchange``, which sends tensors to some ranks and receives tensors from
others in one step (the ring's shift between context neighbours, the
pipeline's hop between stages): every receive and every send is posted at
once (``batch_isend_irecv``) and all of them are waited on, so a ring in
which each rank sends and receives cannot deadlock. Where a step calls
them: the Megatron pairs' all-reduces and gathers over 'model'
(``parallel/comm.py``); under FSDP each unit's all-gather over 'data' in
its forward and again in its backward, and the reduce-scatter of its
gradients (``parallel/sharding.py``); the gradient reduction's all-reduces
over 'context', 'pipe' and 'data'; the global norms' one all-reduce over
the world (the clip's, and ``--watch``'s per-module norms); the
``--watch_histograms`` pass's gathers of each split tensor to its full
shape. Under gloo, PyTorch's
documentation gives CUDA tensors broadcast and all_reduce only; for the
other ops a CUDA buffer is staged through pinned host memory and back. The
choice is made from the group's backend and the tensor's device, never by
catching an error; ``STAGED`` counts the calls and the bytes copied each
way. NCCL never stages.

``process_shard`` and ``all_hosts_mean`` are the JAX module's input
sharding and host-metric helpers, over the data ranks of the mesh.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

# ops that gloo runs on CUDA tensors (the backend table of the
# torch.distributed documentation); every other op on a CUDA tensor under
# gloo is staged through pinned host memory
GLOO_CUDA_OPS = frozenset({"all_reduce"})

STAGED = {"calls": 0, "bytes": 0}

# the groups this process has made an exchange on (``exchange``)
_EXCHANGED: set = set()


@dataclass(frozen=True)
class Runtime:
    """What ``init_from_env`` set up: the rank, the world, the device and
    the backend (None for a single process)."""

    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    backend: Optional[str]


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """NCCL where each of the host's ranks has a card of its own, else
    gloo."""
    if device.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(local_rank: int) -> torch.device:
    """The card ``local_rank`` modulo the cards present, or the CPU where
    there is none."""
    if torch.cuda.is_available():
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device("cpu")


def init_from_env(device: Union[str, torch.device, None] = None,
                  init_method: Optional[str] = None,
                  rank: Optional[int] = None,
                  world_size: Optional[int] = None,
                  local_world_size: Optional[int] = None,
                  backend: Optional[str] = None) -> Runtime:
    """Join the world (arguments first, then torchrun's variables); one
    process without either, unless ``backend`` asks for a group anyway.
    Returns the ``Runtime``."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    local_rank = int(env.get("LOCAL_RANK", rank))
    if local_world_size is None:
        local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    dev = rank_device(local_rank) if device is None else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world_size == 1 and backend is None:
        return Runtime(rank, 1, local_rank, dev, None)
    if backend is None:
        backend = choose_backend(dev, local_world_size)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world_size,
            **({"device_id": dev} if backend == "nccl" else {}))
    if rank == 0:
        print(f"[mmvqa] {world_size} ranks, backend {backend} "
              f"({local_world_size} ranks on this host, "
              f"{torch.cuda.device_count()} cards), rank 0 on {dev}")
    return Runtime(rank, world_size, local_rank, dev, backend)


def fold_seed(seed: int, *coords: int) -> int:
    """A rank's seed from the run's seed and its mesh coordinates (the JAX
    package folds each coordinate into the key, ops/ring_attention.py:53-58);
    coordinate 0 keeps the seed."""
    for c in coords:
        seed = (seed * 0x9E3779B1 + c) % (2 ** 63) if c else seed
    return seed


def _staged(op: str, t: torch.Tensor, group) -> bool:
    return (t.is_cuda and dist.get_backend(group) == "gloo"
            and op not in GLOO_CUDA_OPS)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    STAGED["bytes"] += t.numel() * t.element_size()
    return h


def _from_host(out: torch.Tensor, h: torch.Tensor) -> None:
    out.copy_(h)
    STAGED["bytes"] += h.numel() * h.element_size()


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns it."""
    if _staged("all_reduce", t, group):
        STAGED["calls"] += 1
        h = _to_host(t)
        dist.all_reduce(h, group=group)
        _from_host(t, h)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather_into_tensor(out: torch.Tensor, t: torch.Tensor,
                           group) -> torch.Tensor:
    """``out`` (n * t.shape[0], ...) = the group's ``t`` in rank order."""
    if _staged("all_gather_into_tensor", t, group):
        STAGED["calls"] += 1
        h_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.all_gather_into_tensor(h_out, _to_host(t), group=group)
        _from_host(out, h_out)
    else:
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def reduce_scatter_tensor(out: torch.Tensor, t: torch.Tensor,
                          group) -> torch.Tensor:
    """``out`` = this rank's block (rows) of the group's sum of ``t``."""
    if _staged("reduce_scatter_tensor", t, group):
        STAGED["calls"] += 1
        h_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.reduce_scatter_tensor(h_out, _to_host(t), group=group)
        _from_host(out, h_out)
    else:
        dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    return out


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]], group) -> None:
    """Send each ``(tensor, rank)`` of ``sends`` and receive into each
    ``(buffer, rank)`` of ``recvs`` (global ranks of ``group``), all posted
    together and all waited on. The i-th tensor one rank sends to another
    arrives in the i-th buffer that rank posts for it (each pair's messages
    carry their position as tag). The first exchange on a group, which every
    rank of the group makes, all-reduces over the group before it: NCCL
    leaves ``batch_isend_irecv`` undefined where its first call on a group
    involves only some of the group's ranks, as a pipeline's first tick does
    from pp = 3 on."""
    if (group not in _EXCHANGED and dist.is_available()
            and dist.is_initialized()):
        _EXCHANGED.add(group)
        barrier(group)
    if not sends and not recvs:
        return
    staged = any(_staged("exchange", t, group)
                 for t, _ in list(sends) + list(recvs))
    if staged:
        STAGED["calls"] += 1
    ops, back = [], []
    tags: Dict[Tuple[str, int], int] = {}

    def tag(kind: str, peer: int) -> int:
        n = tags.get((kind, peer), 0)
        tags[(kind, peer)] = n + 1
        return n

    for t, peer in sends:
        h = _to_host(t) if staged else t.contiguous()
        ops.append(dist.P2POp(dist.isend, h, peer, group, tag("s", peer)))
    for buf, peer in recvs:
        h = (torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
             if staged else buf)
        back.append((buf, h))
        ops.append(dist.P2POp(dist.irecv, h, peer, group, tag("r", peer)))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        for buf, h in back:
            _from_host(buf, h)


def barrier(group=None) -> None:
    """Every rank of ``group`` (the world by default) waits for the others
    (an all-reduce of one number on the backend's device; no-op without a
    world)."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    all_reduce(torch.zeros(1, device=dev), group or dist.group.WORLD)


def process_shard() -> Tuple[int, int]:
    """(shard index, shard count) for a rank's input: its data coordinate
    and the data size of the current mesh, else the world's rank and size."""
    from mmvqa_tpu_torch.core import mesh

    spec = mesh.CURRENT
    if spec is not None:
        return spec.data_rank, spec.data_size
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def all_hosts_mean(value: float) -> float:
    """Mean of a host-side scalar over every rank (epoch metrics)."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return float(value)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    all_reduce(t, dist.group.WORLD)
    return float(t.item()) / dist.get_world_size()
