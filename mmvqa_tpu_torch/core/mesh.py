"""The ('data', 'model', 'context', 'pipe') mesh over the ranks of a
``torch.distributed`` world (counterpart of mmvqa_tpu/core/mesh.py).

``make_mesh`` has the JAX function's arithmetic and errors: ``dp_size=-1``
takes every rank that tensor, context and pipeline parallelism leave, and the
four sizes must multiply to the world size. The ranks are laid out as the
JAX mesh lays out its devices, ``reshape(dp, tp, cp, pp)``: rank
``d * tp + m`` holds data coordinate d and model coordinate m. The mesh
builds one process group for each data coordinate (its model group, the ranks
``d * tp .. d * tp + tp - 1``) and one for each model coordinate (its data
group, the ranks ``m, m + tp, ...``); every rank makes every group, in the
same order, as ``torch.distributed.new_group`` requires.

Context parallelism (ring attention) and pipeline parallelism are not ported:
``cp_size`` and ``pp_size`` above 1 raise (ROADMAP.md Queue 1, item 10).

``CURRENT`` is the process-wide mesh, as in the JAX module: the layouts'
modules (``parallel/``, the trunk's BatchNorm, the losses) read it, and None
means a single process.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional

DATA_AXIS = "data"
MODEL_AXIS = "model"

CURRENT: "Optional[MeshSpec]" = None


def set_current(spec: "Optional[MeshSpec]") -> None:
    global CURRENT
    CURRENT = spec


@contextlib.contextmanager
def using(spec: "Optional[MeshSpec]") -> Iterator[None]:
    """``CURRENT = spec`` inside the block, the previous mesh after it."""
    saved = CURRENT
    set_current(spec)
    try:
        yield
    finally:
        set_current(saved)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mmvqa_tpu_torch yet (ROADMAP.md Queue 1, "
        "item 10)")


@dataclass(frozen=True)
class MeshSpec:
    """A rank's view of the mesh: the sizes, its coordinates and the two
    groups it belongs to (None where the world is one process)."""

    data_size: int
    model_size: int
    rank: int = 0
    data_group: Any = field(default=None, compare=False, repr=False)
    model_group: Any = field(default=None, compare=False, repr=False)

    @property
    def world_size(self) -> int:
        return self.data_size * self.model_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    def data_ranks(self) -> List[int]:
        """The ranks of this rank's data group, in data order."""
        return [d * self.model_size + self.model_rank
                for d in range(self.data_size)]

    def model_ranks(self) -> List[int]:
        """The ranks of this rank's model group, in model order."""
        return [self.data_rank * self.model_size + m
                for m in range(self.model_size)]


def mesh_sizes(n: int, dp_size: int = -1, tp_size: int = 1, cp_size: int = 1,
               pp_size: int = 1):
    """(dp, tp, cp, pp) for ``n`` ranks, as the JAX ``make_mesh`` works them
    out, with its errors."""
    tp_size = max(tp_size, 1)
    cp_size = max(cp_size, 1)
    pp_size = max(pp_size, 1)
    if dp_size == -1:
        if n % (tp_size * cp_size * pp_size) != 0:
            raise ValueError(
                f"{n} devices not divisible by tp_size*cp_size*pp_size="
                f"{tp_size * cp_size * pp_size}"
            )
        dp_size = n // (tp_size * cp_size * pp_size)
    if dp_size * tp_size * cp_size * pp_size != n:
        raise ValueError(
            f"dp_size*tp_size*cp_size*pp_size = "
            f"{dp_size * tp_size * cp_size * pp_size} != device count {n}"
        )
    return dp_size, tp_size, cp_size, pp_size


def make_mesh(dp_size: int = -1, tp_size: int = 1, cp_size: int = 1,
              pp_size: int = 1, world_size: Optional[int] = None,
              rank: Optional[int] = None) -> MeshSpec:
    """The mesh over the initialised ``torch.distributed`` world (or one
    process where none is initialised; ``world_size`` and ``rank`` override
    both, for the layout rules' tests, which make no groups)."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if live else 1
    if rank is None:
        rank = dist.get_rank() if live else 0
    dp, tp, cp, pp = mesh_sizes(world_size, dp_size, tp_size, cp_size,
                                pp_size)
    if cp > 1:
        raise _not_ported("context parallelism (ring attention, --cp_size)")
    if pp > 1:
        raise _not_ported("pipeline parallelism (--pp_size)")
    data_group = model_group = None
    if live and world_size > 1:
        for m in range(tp):
            g = dist.new_group([d * tp + m for d in range(dp)])
            if rank % tp == m:
                data_group = g
        for d in range(dp):
            g = dist.new_group([d * tp + m for m in range(tp)])
            if rank // tp == d:
                model_group = g
    return MeshSpec(data_size=dp, model_size=tp, rank=rank,
                    data_group=data_group, model_group=model_group)
