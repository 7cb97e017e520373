"""Launch plans of the kernels that walk a channels-last map, C the
unit-stride axis. Pure arithmetic, tested on the CPU.

``channel_plan``, the BatchNorm-backward sums (``csrc/bn_backward_sums.cu``):
the map as (rows, C). A thread owns ``vec`` neighbouring channels and walks
down rows. A block is ``lanes`` x ``row_groups`` threads: ``lanes * vec``
channels wide, so that a narrow map fills its block with row groups instead
of idle lanes. Channels are cut into ``ctiles`` tiles of equal width, rows
into ``nrb`` blocks of ``rows_per_block``, as many as one wave of the card
holds.

``depthwise_plan``, the depthwise 3x3 forward and backward
(``csrc/depthwise3x3*.cu``, ``csrc/depthwise3x3_tile.cuh``): the map as
(B, H, W, C), cut into halo tiles that a block stages in shared memory.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

MAX_THREADS = 256   # kMaxThreads of csrc/bn_backward_sums.cu
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


def sixteen_byte_rows(C: int, *tensors: torch.Tensor) -> bool:
    """Whether every position of (..., C) maps, each starting at its
    tensor's base, begins on a 16-byte boundary: what TMA and 16-byte
    copies need."""
    return all((C * t.element_size()) % 16 == 0 and t.data_ptr() % 16 == 0
               for t in tensors)


def channel_plan(rows: int, C: int, vec: int, wave: int) -> ChannelPlan:
    """Cut a (rows, C) map into at most ``wave`` blocks in all (the blocks
    of the kernel the card holds at once), one channel tile's row blocks
    never fewer than one; raises for shapes the grid cannot take. No block
    is left without rows. The block's shape does not depend on ``wave``, so
    a caller may plan with any wave, ask the card how many such blocks an SM
    holds, and plan again."""
    if rows < 1 or C < 1:
        raise ValueError(f"empty map: rows={rows} C={C}")
    nvec = cdiv(C, vec)
    ctiles = cdiv(nvec, MAX_LANES)
    lanes = cdiv(nvec, ctiles)
    row_groups = max(1, min(MAX_THREADS // lanes, rows))
    nrb = max(1, min(wave // ctiles, cdiv(rows, row_groups)))
    rows_per_block = cdiv(cdiv(rows, nrb), row_groups) * row_groups
    nrb = cdiv(rows, rows_per_block)
    if nrb > 65535 or rows_per_block > 2**31 - 1 or ctiles > 2**31 - 1:
        raise ValueError(f"grid too large for rows={rows}, C={C}")
    return ChannelPlan(vec, lanes, ctiles, row_groups, rows_per_block, nrb)


COPY_TMA, COPY_ELEMENTS = 0, 1  # dw3::Copy
DW_MAX_THREADS = 128    # a block's threads (dw3::kMaxThreads)
VEC = 4                 # channels a thread owns (dw3::kVec)
TILE_LANES = 8          # threads across a channel tile: 32 channels
STAGE_BYTES = 32 << 10  # one stage's boxes, at most
SMEM_LIMIT = 232448     # a block's shared memory on an H100 (227 KB)
MAX_BOX = 256           # the Tensor Memory Accelerator's longest box side
MIN_BLOCKS_PER_SM = 2   # below this, images per stage and then strips are cut


class DepthwisePlan(NamedTuple):
    """The launch of one depthwise 3x3 kernel; the fields in the order of
    the C entry points' plan arguments. Block (x, y, z) of the grid
    (``ctiles``, ``ncol * nstrip``, ``groups``) owns channels
    [x * ct, + ct), rows [(y // ncol) * s, + s), columns
    [(y % ncol) * tw, + tw) and images [z * steps * p, + steps * p), one
    stage of ``p`` images after the other. Its thread t owns channels
    (t % lanes) * vec.. of the tile, column (t // lanes) % tw and image
    t // (lanes * tw) of each stage, lanes = ct // vec."""
    copy: int       # COPY_TMA or COPY_ELEMENTS
    vec: int        # channels a thread owns
    ct: int         # channels of a tile: a multiple of 16 bytes
    tw: int         # columns of a tile
    s: int          # rows of a strip
    p: int          # images of a stage
    steps: int      # stages of a block
    ncol: int       # column tiles
    nstrip: int     # strips
    groups: int     # image groups (gridDim.z)
    threads: int    # blockDim.x = ct // vec * tw * p
    smem: int       # dynamic shared memory, bytes


def depthwise_grid(plan: DepthwisePlan, C: int) -> tuple:
    return cdiv(C, plan.ct), plan.ncol * plan.nstrip, plan.groups


def depthwise_partials(plan: DepthwisePlan) -> int:
    """(9, C) dW partials the backward writes: one a block of a channel
    tile."""
    return plan.ncol * plan.nstrip * plan.groups


def depthwise_plan(B: int, H: int, W: int, C: int, itemsize: int, sms: int,
                   backward: bool = False, aligned: bool = True,
                   slots: int = MIN_BLOCKS_PER_SM) -> DepthwisePlan:
    """Cut a (B, H, W, C) map of ``itemsize``-byte elements into halo tiles
    for a card of ``sms`` multiprocessors that hold ``slots`` blocks each.
    ``aligned``: C * itemsize and every base address are multiples of 16
    bytes, so that stages arrive by TMA and threads store vectors; else by
    element copies.

    The whole plane if its halo tile fits a stage, else strips; images per
    stage and then strips are cut until there are ``MIN_BLOCKS_PER_SM``
    blocks a multiprocessor. Then each block walks as many stages as fill
    one wave of ``slots`` blocks a multiprocessor (the fewer waves times
    stages of the two nearest counts): every block starts at once, and a
    block's next stage loads while it computes the last. The
    threads and shared memory do not depend on ``slots``, so a caller may
    plan with the default, ask the card how many such blocks fit, and plan
    again. Raises on what the kernels cannot take."""
    if min(B, H, W, C) < 1:
        raise ValueError(f"empty map: {(B, H, W, C)}")
    copy = COPY_TMA if aligned else COPY_ELEMENTS
    tile_vec = 16 // itemsize
    ct = min(TILE_LANES * VEC, cdiv(C, tile_vec) * tile_vec)
    lanes = ct // VEC
    ncol = cdiv(W, min(MAX_BOX - 2, DW_MAX_THREADS // lanes))
    tw = cdiv(W, ncol)
    pos = ct * itemsize

    def stage_bytes(s: int, p: int) -> int:
        """The halo box and, backward, the centre box of x (128-aligned)."""
        halo = cdiv(p * (s + 2) * (tw + 2) * pos, 128) * 128
        return halo + (cdiv(p * s * tw * pos, 128) * 128 if backward else 0)

    s = min(H, MAX_BOX - 2)
    while s > 1 and stage_bytes(s, 1) > STAGE_BYTES:
        s -= 1
    nstrip = cdiv(H, s)
    s = cdiv(H, nstrip)
    p = max(1, min(B, DW_MAX_THREADS // (lanes * tw),
                   STAGE_BYTES // stage_bytes(s, 1)))
    ctiles = cdiv(C, ct)
    while (ctiles * nstrip * ncol * cdiv(B, p) < MIN_BLOCKS_PER_SM * sms
           and (p > 1 or s > 1)):
        if p > 1:
            p = max(1, p // 2)
        else:
            nstrip = cdiv(H, cdiv(s, 2))
            s = cdiv(H, nstrip)
    per = cdiv(B, p)  # stages of a tile
    tiles = ctiles * nstrip * ncol
    want = max(1, min(per, slots * sms // tiles))  # groups for one wave

    def time(steps: int) -> int:  # waves x stages a wave
        return cdiv(tiles * cdiv(per, steps), slots * sms) * steps

    steps = min((max(1, per // want), cdiv(per, want)),
                key=lambda st: (time(st), st))
    while steps > 1 and tiles * cdiv(per, steps) < MIN_BLOCKS_PER_SM * sms:
        steps -= 1
    groups = cdiv(per, steps)
    threads = lanes * tw * p
    red = cdiv(threads * VEC * 4, 128) * 128 if backward else 0
    smem = max(2 * stage_bytes(s, p), red) + 9 * ct * 4 + 32
    if (smem > SMEM_LIMIT or ncol * nstrip > 65535 or groups > 65535
            or ctiles > 2**31 - 1 or B * H * W * C >= 2**62):
        raise ValueError(f"depthwise3x3: cannot tile a {(B, H, W, C)} map")
    return DepthwisePlan(copy, VEC, ct, tw, s, p, steps, ncol, nstrip, groups,
                         threads, smem)


def refuse_dtensor(name: str, *tensors) -> None:
    """The kernels take plain local tensors: a DTensor (which no kernel is
    registered to dispatch) raises instead of reaching the plain version or
    a launch with its global shape."""
    for t in tensors:
        if t is not None and any(c.__name__ == "DTensor"
                                 for c in type(t).__mro__):
            raise TypeError(
                f"{name}: got a DTensor; the layouts hand the kernels plain "
                "local tensors (mmvqa_tpu_torch/parallel/)")


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


def current_stream(device: torch.device) -> int:
    """The handle of the current stream on ``device``, asked once a call: the
    kernels launch on it and keep their counters by it."""
    return torch.cuda.current_stream(device).cuda_stream


def stream_counters(store: Dict[Tuple[torch.device, int], torch.Tensor],
                    device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters for ``stream`` on ``device``, kept in
    ``store``: zero between calls (the kernel that counts in them sets each
    back to 0 before it ends), so they are made once and grown where a call
    needs more. One buffer a stream: calls in one stream run one after the
    other, calls on two streams could run at once and must not count into
    one buffer."""
    key = (device, stream)
    buf = store.get(key)
    if buf is None or buf.numel() < n:
        buf = store[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                       device=device)
    return buf
