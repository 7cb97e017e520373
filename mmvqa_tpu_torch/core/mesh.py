"""The ('data', 'model', 'context', 'pipe') mesh over the ranks of a
``torch.distributed`` world (counterpart of mmvqa_tpu/core/mesh.py).

``make_mesh`` has the JAX function's arithmetic and errors: ``dp_size=-1``
takes every rank that tensor, context and pipeline parallelism leave, and the
four sizes must multiply to the world size. The ranks are laid out as the
JAX mesh lays out its devices, ``reshape(dp, tp, cp, pp)``: rank
``((d * tp + m) * cp + c) * pp + p`` holds data coordinate d, model
coordinate m, context coordinate c and pipe coordinate p (at cp = pp = 1,
``d * tp + m``). For each axis the mesh builds one process group for every
coordinate of the other three axes: the ranks that differ along that axis
alone. Every rank makes every group, in the same order, as
``torch.distributed.new_group`` requires; the context and pipe groups exist
only where their axis has more than one rank.

``CURRENT`` is the process-wide mesh, as in the JAX module: the layouts'
modules (``parallel/``, the trunk's BatchNorm, the losses, the ring and the
pipeline) read it, and None means a single process.
"""

from __future__ import annotations

import contextlib
import itertools
from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional

DATA_AXIS = "data"
MODEL_AXIS = "model"
CONTEXT_AXIS = "context"
PIPE_AXIS = "pipe"
AXES = (DATA_AXIS, MODEL_AXIS, CONTEXT_AXIS, PIPE_AXIS)

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


@dataclass(frozen=True)
class MeshSpec:
    """A rank's view of the mesh: the sizes, its coordinates and the groups
    it belongs to (None where the world is one process or the axis has one
    rank)."""

    data_size: int
    model_size: int
    rank: int = 0
    data_group: Any = field(default=None, compare=False, repr=False)
    model_group: Any = field(default=None, compare=False, repr=False)
    context_size: int = 1
    pipe_size: int = 1
    context_group: Any = field(default=None, compare=False, repr=False)
    pipe_group: Any = field(default=None, compare=False, repr=False)

    @property
    def sizes(self) -> tuple:
        return (self.data_size, self.model_size, self.context_size,
                self.pipe_size)

    @property
    def world_size(self) -> int:
        return (self.data_size * self.model_size * self.context_size
                * self.pipe_size)

    @property
    def coords(self) -> tuple:
        """(data, model, context, pipe) coordinates of this rank."""
        return coords_of(self.rank, self.sizes)

    @property
    def data_rank(self) -> int:
        return self.coords[0]

    @property
    def model_rank(self) -> int:
        return self.coords[1]

    @property
    def context_rank(self) -> int:
        return self.coords[2]

    @property
    def pipe_rank(self) -> int:
        return self.coords[3]

    def axis_ranks(self, axis: str) -> List[int]:
        """The ranks of this rank's group of ``axis``, in axis order."""
        i = AXES.index(axis)
        out = []
        for a in range(self.sizes[i]):
            c = list(self.coords)
            c[i] = a
            out.append(rank_of(c, self.sizes))
        return out

    def data_ranks(self) -> List[int]:
        """The ranks of this rank's data group, in data order."""
        return self.axis_ranks(DATA_AXIS)

    def model_ranks(self) -> List[int]:
        """The ranks of this rank's model group, in model order."""
        return self.axis_ranks(MODEL_AXIS)


def rank_of(coords, sizes) -> int:
    """The rank at ``coords`` (data, model, context, pipe) of a mesh of
    ``sizes``: ``reshape(dp, tp, cp, pp)``'s row-major order."""
    r = 0
    for c, n in zip(coords, sizes):
        r = r * n + c
    return r


def coords_of(rank: int, sizes) -> tuple:
    out = []
    for n in reversed(sizes):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


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
    sizes = mesh_sizes(world_size, dp_size, tp_size, cp_size, pp_size)
    groups = [None] * 4
    if live and world_size > 1:
        mine = coords_of(rank, sizes)
        for i, axis in enumerate(AXES):
            if i >= 2 and sizes[i] == 1:
                continue  # the context and pipe groups where they split
            others = [range(n) if j != i else [0]
                      for j, n in enumerate(sizes)]
            for base in itertools.product(*others):
                ranks = []
                for a in range(sizes[i]):
                    c = list(base)
                    c[i] = a
                    ranks.append(rank_of(c, sizes))
                g = dist.new_group(ranks)
                if all(base[j] == mine[j] for j in range(4) if j != i):
                    groups[i] = g
    dp, tp, cp, pp = sizes
    return MeshSpec(data_size=dp, model_size=tp, rank=rank,
                    data_group=groups[0], model_group=groups[1],
                    context_size=cp, pipe_size=pp, context_group=groups[2],
                    pipe_group=groups[3])
