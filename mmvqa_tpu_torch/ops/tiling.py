"""Launch plans of the kernels that walk a channels-last map, (rows, C) with
C the unit-stride axis: the depthwise 3x3 (``csrc/depthwise3x3*.cu``) and the
BatchNorm-backward sums (``csrc/bn_backward_sums.cu``).

A thread owns ``vec`` neighbouring channels and walks down rows. A block is
``lanes`` x ``row_groups`` threads: ``lanes * vec`` channels wide, so that a
narrow map fills its block with row groups instead of idle lanes. Channels
are cut into ``ctiles`` tiles of equal width, rows into ``nrb`` blocks of
``rows_per_block``. Pure arithmetic, tested on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_THREADS = 256   # kMaxThreads of the three sources
MAX_LANES = 32


class ChannelPlan(NamedTuple):
    vec: int             # channels per thread
    lanes: int           # blockDim.x
    ctiles: int          # gridDim.x
    row_groups: int      # blockDim.y
    rows_per_block: int
    nrb: int             # gridDim.y


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def vector_width(C: int, max_vec: int, *tensors: torch.Tensor) -> int:
    """``max_vec`` where every row of every tensor starts on a multiple of
    ``max_vec`` elements, else 1."""
    if C % max_vec:
        return 1
    for t in tensors:
        if t.data_ptr() % (max_vec * t.element_size()):
            return 1
    return max_vec


def channel_plan(rows: int, C: int, vec: int, blocks: int) -> ChannelPlan:
    """Cut a (rows, C) map for about ``blocks`` blocks in all; raises for
    shapes the grid cannot take. No block is left without rows."""
    if rows < 1 or C < 1:
        raise ValueError(f"empty map: rows={rows} C={C}")
    nvec = cdiv(C, vec)
    ctiles = cdiv(nvec, MAX_LANES)
    lanes = cdiv(nvec, ctiles)
    row_groups = max(1, min(MAX_THREADS // lanes, rows))
    nrb = max(1, min(cdiv(blocks, ctiles), cdiv(rows, row_groups)))
    rows_per_block = cdiv(cdiv(rows, nrb), row_groups) * row_groups
    nrb = cdiv(rows, rows_per_block)
    if nrb > 65535 or rows_per_block > 2**31 - 1 or ctiles > 2**31 - 1:
        raise ValueError(f"grid too large for rows={rows}, C={C}")
    return ChannelPlan(vec, lanes, ctiles, row_groups, rows_per_block, nrb)


def require_dense(name: str, t: torch.Tensor) -> None:
    """The kernels read a map as it lies; a strided one is refused, not
    copied."""
    if not t.is_contiguous():
        raise ValueError(
            f"{name}: a channels-last map must be dense, got shape "
            f"{tuple(t.shape)} with strides {t.stride()}"
        )


def laid_out_as(t: torch.Tensor, x: torch.Tensor) -> bool:
    """Whether ``t`` lies in memory as ``x`` does: the same shape and the
    same stride on every axis longer than 1. The one test a backward makes
    before it hands a gradient to a kernel that reads it beside ``x``."""
    return t.shape == x.shape and all(
        st == sx for n, st, sx in zip(x.shape, t.stride(), x.stride())
        if n > 1)


def sm_count(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count
