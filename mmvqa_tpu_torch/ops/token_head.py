"""K1: the fused visual-token head, ``mean_p act(x @ W)``.

Counterpart of mmvqa_tpu/ops/pallas_token_head.py. The CUDA kernels are
``csrc/token_head.cu`` (forward) and ``csrc/token_head_bwd.cu`` (backward),
both in bf16 on the tensor cores and in fp32 as split-TF32 products on the
tensor cores, with fp32 accuracy (``csrc/tf32x3.cuh``), with the bf16 tile
machinery of both in ``csrc/token_head_tile.cuh``; this module holds their
launch plans, their wrappers, the ``torch.autograd.Function`` that joins
them, and their plain PyTorch versions.

The wrappers route by where the input lies: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. There is no other
fallback.

Mixed precision: ``w`` may be the fp32 master weight while ``x`` is bf16. The
forward then takes the bf16 cast of ``w`` and the backward hands the kernel's
fp32 dW to the master unrounded. ``gact = act'(s) g / P`` is taken in fp32
and rounded to x's dtype before the two gradient products, as the TPU kernel
does (mmvqa_tpu/ops/pallas_token_head.py, ``GACT_MM = "input"``); the
products sum in fp32. In fp32 the rounding changes nothing.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import torch

from mmvqa_tpu_torch.native import loader
from mmvqa_tpu_torch.ops import tiling
from mmvqa_tpu_torch.ops.activations import (
    SERF_CLAMP,
    SERF_P5,
    serf_exact,
    serf_fast,
)

ACTS = {"serf": 0, "serf_fast": 1, "relu": 2}

# the bf16 forward (k1::fwd in csrc/token_head.cu)
FWD_TILE_C = 256          # kTileC: channels of a block
FWD_RESIDENT_K = 96       # kResidentK: W resident in shared memory up to K
FWD_STAGES = 4            # kStages: the ring
FWD_WLD = FWD_TILE_C + 8  # kWld: row stride of staged W
FWD_STREAM_ROWS = 32      # kStreamRows: rows of a tile where W streams
# k1::fwd::Mode: W streamed with x through the ring; resident in shared
# memory; resident and its fragments held in registers (K <= 32)
FWD_STREAMED, FWD_W_SHARED, FWD_W_REGISTERS = 0, 1, 2
# the fp32 forward (k1::fwd32 in csrc/token_head.cu): W streamed with x
# through the ring in 32-k chunks, or resident in shared memory (K in 32s
# up to FP32_FWD_RESIDENT_K); row tiles of FP32_FWD_RESIDENT_TP where W is
# resident (up to four blocks an SM), else of FP32_FWD_STREAM_TP (two blocks
# an SM); where the row tiles give the SMs fewer than FP32_FWD_DEEP_BLOCKS
# blocks each and K is at least FP32_FWD_SPLIT_K (the deep taps: few rows,
# wide K), K is cut into slices, one block each
FP32_FWD_TILE_C = 128     # kTileC: channels of a block
FP32_FWD_RESIDENT_K = 96  # kResidentK
FP32_FWD_STAGES = 4       # kStages: the ring
FP32_FWD_RESIDENT_TP = 16
FP32_FWD_STREAM_TP = 64
FP32_FWD_DEEP_BLOCKS = 3
FP32_FWD_SPLIT_K = 512
FP32_FWD_WARPS = 4        # kConsumers: the per-warp counters
FP32_FWD_STREAMED, FP32_FWD_RESIDENT = 0, 1  # k1::fwd32::Mode
SMEM_LIMIT = 232448       # shared memory one block can have on an H100
SMEM_PER_SM = 233472      # an SM's, of which each block reserves 1 KB
# (rows of a tile, W resident) of the bf16 backward, the first that fits:
# W resident beside gact with 64 or 32 rows (the narrow taps; faster there on
# the card, PERF.md), else the widest tile with W streamed
BWD_TILES = ((64, 1), (32, 1), (64, 0), (32, 0), (16, 0))
BARRIER_WORDS = 4         # the backward's two barriers' arrival and
                          # departure counters (fp32's tiles mode: two)
# the fp32 backward (k1::bwd::f32 in csrc/token_head_bwd.cu): the rows mode
# for K up to FP32_ROWS_MAX_K (row tiles, each walked once a 128-channel
# tile, a (K, C) partial a block), the tiles mode beyond (gact
# through device memory, 64 x 64 output tiles, dW's rows cut into segments
# only where its tiles are too few)
FP32_ROWS, FP32_TILES = 0, 1
FP32_ROWS_MAX_K = 96      # kRowsMaxK
# the rows mode's row tile: 64 where K <= 32 (stage 0: the taps with the
# most rows, whose fixed costs a tile halves), else 32 (read on the card,
# PERF.md §6)
FP32_ROWS_TP = {32: 64, 64: 32, 96: 32}
FP32_CT = 128             # kCT: the rows mode's channel tile
FP32_TILE = 64            # kTile: the tiles mode's output tile
FP32_STAGES = 4           # kStages: the tiles mode's ring
FP32_SEGMENT_ROWS = 1024  # the tiles mode cuts dW's rows no finer


class FwdPlan(NamedTuple):
    """The bf16 forward launch; the fields in the order of the C entry
    point's plan arguments."""
    tp: int         # rows (of the B * P positions) a tile
    per_block: int  # consecutive tiles a block walks
    nblocks: int    # blocks along the rows (times ceil(C / 256) channel tiles)
    mode: int       # how W reaches the products: FWD_STREAMED,
                    # FWD_W_SHARED or FWD_W_REGISTERS
    slots: int      # images a block's partial holds: the most it can span
    smem: int       # dynamic shared memory, bytes


class Fp32FwdPlan(NamedTuple):
    """The fp32 forward launch; the fields in the order of the C entry
    point's plan arguments."""
    tp: int         # rows (of the B * P positions) a tile
    per_block: int  # consecutive tiles a block walks
    nblocks: int    # blocks along the rows (times ceil(C / 128) channel
                    # tiles, times ks)
    mode: int       # FP32_FWD_STREAMED or FP32_FWD_RESIDENT
    slots: int      # images a block's partial holds: the most it can span
    smem: int       # dynamic shared memory, bytes
    ks: int         # slices of K's 32-k chunks, a block each (1: none)


class BwdPlan(NamedTuple):
    """The backward launch; the fields in the order of the C entry point's
    plan arguments."""
    tp: int        # rows (of the B * P positions) a tile
    per_block: int  # consecutive tiles a block walks
    nblocks: int   # blocks, all resident at once; none is left empty
    mode: int      # bf16: W resident in shared memory (1) or streamed (0);
                   # fp32: FP32_ROWS or FP32_TILES
    smem: int      # dynamic shared memory, bytes
    rsplit: int = 1  # fp32 tiles mode: segments of dW's rows


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def resident_k(K: int) -> int:
    """resident_k in csrc/token_head_tile.cuh: K in 32s."""
    return _cdiv(K, 32) * 32


def fwd_smem_bytes(K: int, resident: bool) -> int:
    """k1::fwd::smem_bytes in csrc/token_head.cu: W (resident: K in 32s x
    264 channels), the ring's four stages (resident: a 64-row x tile, all K
    and 8 more; streamed: a 32 x 32 x chunk in rows of 40 and a 32 x 256 W
    chunk in rows of 264), the full and empty mbarriers, the last-block
    flag."""
    if resident:
        w, stage = resident_k(K) * FWD_WLD, 64 * (resident_k(K) + 8)
    else:
        w, stage = 0, FWD_STREAM_ROWS * 40 + 32 * FWD_WLD
    return 2 * (w + FWD_STAGES * stage) + 2 * FWD_STAGES * 8 + 16


def forward_tile(K: int) -> Tuple[int, int, int]:
    """(rows a tile, mode, dynamic shared memory) of the bf16 forward: W
    stays in shared memory for the narrow taps (K up to 96), its fragments
    in registers too where K <= 32, and a tile is 64 rows; else W streams
    with x through the ring, 32 rows a tile."""
    kr = resident_k(K)
    mode = (FWD_STREAMED if kr > FWD_RESIDENT_K
            else FWD_W_REGISTERS if kr == 32 else FWD_W_SHARED)
    resident = mode != FWD_STREAMED
    return ((64 if resident else FWD_STREAM_ROWS), mode,
            fwd_smem_bytes(K, resident))


def forward_plan(B: int, P: int, K: int, C: int, sms: int,
                 slots: int) -> FwdPlan:
    """How the bf16 forward shares the ``ceil(B * P / tp)`` row tiles among
    ``nblocks`` blocks of ``per_block`` consecutive tiles for each of the
    ``ceil(C / 256)`` channel tiles: one wave on a card of ``sms``
    multiprocessors that hold ``slots`` such blocks each (the wrapper asks
    the card). A block's rows may span several images; ``slots`` of the
    plan is the most it can span, the images of its partial."""
    if min(B, P, K, C) < 1:
        raise ValueError(f"token head: empty shape B={B} P={P} K={K} C={C}")
    if slots < 1:
        raise ValueError(f"token head forward: {slots} blocks an SM")
    tp, mode, smem = forward_tile(K)
    items = _cdiv(B * P, tp)
    per_block = _cdiv(items, max(1, slots * sms // _cdiv(C, FWD_TILE_C)))
    nblocks = _cdiv(items, per_block)
    if B * P >= 2**31 or nblocks > 65535:
        raise ValueError(f"token head: grid too large for B={B}, P={P}")
    images = min(B, (per_block * tp - 1) // P + 2)
    return FwdPlan(tp, per_block, nblocks, mode, images, smem)


def fp32_forward_smem_bytes(tp: int, K: int, resident: bool) -> int:
    """k1::fwd32::smem_bytes in csrc/token_head.cu: W (resident: K in 32s x
    128 channels), the ring's four stages (a tp x 32 chunk of x, and where W
    streams a 32 x 128 chunk of W), the full and empty mbarriers; fp32."""
    w = resident_k(K) * FP32_FWD_TILE_C if resident else 0
    stage = tp * 32 + (0 if resident else 32 * FP32_FWD_TILE_C)
    return 4 * (w + FP32_FWD_STAGES * stage) + 2 * FP32_FWD_STAGES * 8


def fp32_forward_tile(K: int) -> Tuple[int, int, int]:
    """(rows a tile, mode, dynamic shared memory) of the fp32 forward: W
    resident for K up to 96 (the taps with the most rows) and 16-row
    tiles, up to four blocks an SM; else W streams and a tile is 64 rows,
    two blocks an SM."""
    if resident_k(K) <= FP32_FWD_RESIDENT_K:
        tp = FP32_FWD_RESIDENT_TP
        return tp, FP32_FWD_RESIDENT, fp32_forward_smem_bytes(tp, K, True)
    tp = FP32_FWD_STREAM_TP
    return tp, FP32_FWD_STREAMED, fp32_forward_smem_bytes(tp, K, False)


def fp32_forward_plan(B: int, P: int, K: int, C: int, sms: int,
                      slots: int) -> Fp32FwdPlan:
    """How the fp32 forward shares its work on a card of ``sms``
    multiprocessors that hold ``slots`` such blocks each (the wrapper asks
    the card); the tile is ``fp32_forward_tile``'s.

    The ``ceil(B * P / tp)`` row tiles go to ``nblocks`` blocks of
    ``per_block`` consecutive tiles for each of the ``ceil(C / 128)``
    channel tiles: one wave, unless one wave would leave SMs without a
    block: then a tile a block. Where K is at least FP32_FWD_SPLIT_K and the
    row tiles times the channel tiles are fewer than FP32_FWD_DEEP_BLOCKS
    blocks an SM (the deep taps: ResNet's layer4 at B=16 has 784 rows, 13
    tiles of 64 x 6 channel tiles against 132 SMs), a tile is a block and
    K's 32-k chunks are cut into ``ks`` slices, a block each, as many as
    make up the difference (no slice empty). Read on the card
    (tools/time_token_head.py --slices, counts of 1 to 16 at the taps of
    both models at B=8, 16 and 128): within 9% of the best count at the
    deep taps of the CLIs' B=16, 16% at B=8's layer4 and stage 6; at the
    flagship's stage 4 (K = 176, six chunks) any cut was slower. A block's
    rows may span several images; ``slots`` of the plan is the most it can
    span."""
    if min(B, P, K, C) < 1:
        raise ValueError(f"token head: empty shape B={B} P={P} K={K} C={C}")
    if slots < 1:
        raise ValueError(f"token head forward: {slots} blocks an SM")
    tp, mode, smem = fp32_forward_tile(K)
    items = _cdiv(B * P, tp)
    ctiles = _cdiv(C, FP32_FWD_TILE_C)
    ks = 1
    want = FP32_FWD_DEEP_BLOCKS * sms
    if K >= FP32_FWD_SPLIT_K and items * ctiles < want:
        ks = min(_cdiv(want, items * ctiles), _cdiv(K, 32))
    if ks > 1:
        per_block = 1
    else:
        per_block = _cdiv(items, max(1, slots * sms // ctiles))
        if _cdiv(items, per_block) * ctiles < sms:
            per_block = 1
    nblocks = _cdiv(items, per_block)
    if B * P >= 2**31 or nblocks > 65535:
        raise ValueError(f"token head: grid too large for B={B}, P={P}")
    images = min(B, (per_block * tp - 1) // P + 2)
    return Fp32FwdPlan(tp, per_block, nblocks, mode, images, smem, ks)


def fp32_forward_scratch(plan: Fp32FwdPlan, B: int,
                         C: int) -> Tuple[Tuple[int, ...], int, int]:
    """The fp32 forward's scratch: its per-image partials (nblocks, slots,
    ceil(C / 128) * 128); the floats of the K slices' s (none where K is not
    cut); the counters, an image's and, where K is cut, a tile's, for each
    (channel tile, warp)."""
    ctiles = _cdiv(C, FP32_FWD_TILE_C)
    part = (plan.nblocks, plan.slots, ctiles * FP32_FWD_TILE_C)
    spart = (plan.nblocks * ctiles * plan.ks * plan.tp * FP32_FWD_TILE_C
             if plan.ks > 1 else 0)
    counters = (B + (plan.nblocks if plan.ks > 1 else 0)) * ctiles * \
        FP32_FWD_WARPS
    return part, spart, counters


def mma_smem_bytes(tp: int, K: int, C: int, resident: bool) -> int:
    """mma_smem_bytes in csrc/token_head_bwd.cu: the bf16 gact of a tile for
    every channel (rows padded to 128 channels and 16 bytes more); then W
    whole (K in 32s, rows as gact's) and two x tiles (K in 32s and 16 bytes)
    where W is resident, else six stages of an x chunk (tp x 32) and a W
    chunk (32 x 128), rows padded by 16 bytes; then each row's dx offset and
    image, and g / P of the two images a tile spans."""
    row = _cdiv(C, 128) * 128 + 8
    kr = _cdiv(K, 32) * 32
    ring = (kr * row + 2 * tp * (kr + 8) if resident
            else 6 * (tp * 40 + 32 * 136))
    return 2 * (tp * row + ring) + tp * 12 + _g_cache_bytes(C)


def _g_cache_bytes(C: int) -> int:
    """g_cache_floats in csrc/token_head_bwd.cu, in bytes."""
    return 4 * 2 * _cdiv(C, 4) * 4


def fp32_rows_smem_bytes(tp: int, K: int) -> int:
    """f32::rows_smem_bytes in csrc/token_head_bwd.cu: W's K x 128 channel
    tile, two x tiles of tp x K and gact's tp x 128 tile, K in 32s, fp32."""
    kp = _cdiv(K, 32) * 32
    return 4 * (kp * FP32_CT + 2 * tp * kp + tp * FP32_CT)


def fp32_tiles_smem_bytes() -> int:
    """f32::tiles_smem_bytes: the ring's stages of two 64 x 32 chunks."""
    return 4 * FP32_STAGES * 2 * FP32_TILE * 32


def backward_tile(K: int, C: int, itemsize: int) -> Tuple[int, int, int]:
    """(rows a tile, mode, dynamic shared memory) of the backward kernel.

    bf16 (``itemsize`` 2) parks a tile's gact for all C channels in shared
    memory, with the first (rows, W resident) of BWD_TILES that fits; the
    streamed tiles take any K. Raises for a C that not even 16 rows fit.
    fp32 takes the rows mode, FP32_ROWS_TP rows a tile, up to K =
    FP32_ROWS_MAX_K and the tiles mode beyond; neither limits C."""
    if itemsize == 2:
        fits = [(tp, mode) for tp, mode in BWD_TILES
                if mma_smem_bytes(tp, K, C, bool(mode)) <= SMEM_LIMIT]
        if not fits:
            raise ValueError(
                f"token head backward: C={C} needs "
                f"{mma_smem_bytes(16, K, C, False)} bytes of shared memory "
                f"for 16 rows of gact, a block has {SMEM_LIMIT}")
        tp, mode = fits[0]
        return tp, mode, mma_smem_bytes(tp, K, C, bool(mode))
    if K > FP32_ROWS_MAX_K:
        return FP32_TILE, FP32_TILES, fp32_tiles_smem_bytes()
    tp = FP32_ROWS_TP[_cdiv(K, 32) * 32]
    return tp, FP32_ROWS, fp32_rows_smem_bytes(tp, K)


def fp32_tiles_items(N: int, K: int, C: int,
                     rsplit: int = 1) -> Tuple[int, int]:
    """The tiles mode's (phase A, phase B) output tiles of 64 x 64: gact
    (rows x channels); dW (k's x channels, each ``rsplit`` times) and dx
    (rows x k's)."""
    nr, nk, nc = (_cdiv(n, FP32_TILE) for n in (N, K, C))
    return nr * nc, nk * nc * rsplit + nr * nk


def fp32_tiles_rsplit(N: int, C: int) -> int:
    """Segments of dW's rows in the tiles mode: about as many rows a
    segment as a dx tile sums channels (C), so that the blocks' shares of
    phase B come out even, and no segment under FP32_SEGMENT_ROWS rows (so
    stage 6 at B=16, 784 rows, has one: no partial)."""
    return max(1, min(_cdiv(N, FP32_SEGMENT_ROWS), N // C))


def backward_plan(B: int, P: int, K: int, C: int, itemsize: int, sms: int,
                  slots: int) -> BwdPlan:
    """How the backward launch shares its work among ``nblocks`` blocks on
    a card of ``sms`` multiprocessors that hold ``slots`` such blocks each
    (the wrapper asks the card). The launch is cooperative, so there are no
    more blocks than fit at once. The tile is ``backward_tile``'s.

    bf16 hands each block ``per_block`` consecutive row tiles of the
    ``ceil(B * P / tp)``. fp32's rows mode deals the row tiles out evenly,
    block j the tiles [j * n // nblocks, (j + 1) * n // nblocks), to as many
    blocks as there are tiles or slots; the tiles mode deals each phase's
    output tiles out in turn, to as many blocks as the larger phase has
    tiles or the card has slots; ``per_block`` is then the most a block
    takes."""
    if min(B, P, K, C) < 1:
        raise ValueError(f"token head: empty shape B={B} P={P} K={K} C={C}")
    if slots < 1:
        raise ValueError(f"token head backward: {slots} blocks an SM")
    N = B * P
    if N > 2**31 - 1 or K * C >= 2**31:
        raise ValueError(f"token head: grid too large for B={B}, P={P}")
    tp, mode, smem = backward_tile(K, C, itemsize)
    if itemsize == 4 and mode == FP32_TILES:
        rsplit = fp32_tiles_rsplit(N, C)
        items = max(fp32_tiles_items(N, K, C, rsplit))
        nblocks = min(items, slots * sms)
        return BwdPlan(tp, _cdiv(items, nblocks), nblocks, mode, smem, rsplit)
    items = _cdiv(N, tp)
    if itemsize == 4:
        nblocks = min(items, slots * sms)
        return BwdPlan(tp, _cdiv(items, nblocks), nblocks, mode, smem)
    per_block = _cdiv(items, slots * sms)
    nblocks = _cdiv(items, per_block)
    return BwdPlan(tp, per_block, nblocks, mode, smem)


def backward_scratch(plan: BwdPlan, itemsize: int, B: int, P: int, K: int,
                     C: int) -> Tuple[int, ...]:
    """The fp32 scratch of a backward launch: a (K, C) partial of dW a
    block, which the blocks add after a grid barrier; or, in fp32's tiles
    mode, gact itself, (B * P, C), with no partial, and after it the dW of
    each segment of the rows where there are several."""
    if itemsize == 4 and plan.mode == FP32_TILES:
        return (B * P * C + (plan.rsplit * K * C if plan.rsplit > 1 else 0),)
    return (plan.nblocks, K, C)


def _activate(s: torch.Tensor, act: str) -> torch.Tensor:
    if act == "serf":
        return serf_exact(s)
    if act == "serf_fast":
        return serf_fast(s)
    return torch.relu(s)


def token_head_reference(x: torch.Tensor, w: torch.Tensor,
                         act: str = "serf") -> torch.Tensor:
    """Plain version: materializes the (B, P, C) projection in fp32."""
    s = torch.einsum("bpk,kc->bpc", x.float(), w.float())
    return _activate(s, act).mean(dim=1).to(x.dtype)


def _act_grad(s: torch.Tensor, act: str) -> torch.Tensor:
    """act'(s) in fp32 (mmvqa_tpu/ops/pallas_token_head.py::_act_grad)."""
    if act == "serf":
        y = torch.log1p(torch.exp(torch.clamp(s, max=SERF_CLAMP)))
        return (torch.erf(y) + s * (2.0 / math.sqrt(math.pi))
                * torch.exp(-y * y) * torch.sigmoid(s))
    if act == "serf_fast":
        n = len(SERF_P5) - 1
        q = torch.full_like(s, SERF_P5[0])
        dq = torch.full_like(s, n * SERF_P5[0])
        for i, c in enumerate(SERF_P5[1:], start=1):
            q = q * s + c
            if i < n:
                dq = dq * s + (n - i) * c
        gate = torch.sigmoid(q)
        return gate + s * gate * (1.0 - gate) * dq
    return (s > 0).to(s.dtype)


def token_head_backward_reference(
    x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, act: str = "serf",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward: x (B, P, K), w (K, C), g (B, C) the
    gradient of the output. Returns dx (B, P, K) in x's dtype and dW (K, C)
    in fp32. Materializes the (B, P, C) map; gact is rounded to x's dtype
    before both products, which sum in fp32."""
    xf, wf = x.float(), w.float()
    s = torch.einsum("bpk,kc->bpc", xf, wf)
    gact = _act_grad(s, act) * (g.float() / x.shape[1])[:, None, :]
    gact = gact.to(x.dtype).float()  # the products' operand in x's dtype
    dx = torch.einsum("bpc,kc->bpk", gact, wf).to(x.dtype)
    dw = torch.einsum("bpk,bpc->kc", xf, gact)
    return dx, dw


def _check_launch(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    loader.require_cuda(name, x, w)
    if w.dtype != x.dtype:
        raise ValueError(f"{name}: x is {x.dtype}, w is {w.dtype}")


def _sms(x: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count


_FWD_PLANS: Dict[tuple, FwdPlan] = {}
# the forward's last-block counters, one an (image, channel tile), bf16 and
# fp32 alike
_FWD_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _forward_plan(x: torch.Tensor, K: int, C: int, act: str) -> FwdPlan:
    """The plan with the blocks an SM of this card holds (asked of the
    card), made once per device, act and shape: a call's host time counts
    where the card finishes a small call sooner than the host issues it."""
    B, P = x.shape[0], x.shape[1]
    key = (x.device, act, B, P, K, C)
    plan = _FWD_PLANS.get(key)
    if plan is None:
        _, mode, smem = forward_tile(K)
        n = ctypes.c_int(0)
        loader.check(loader.library().token_head_fwd_occupancy(
            ACTS[act], mode, smem, ctypes.byref(n)),
            "token_head_fwd occupancy")
        if n.value < 1:
            raise RuntimeError(f"token head forward: no block with {smem} "
                               "bytes of shared memory fits an SM")
        plan = _FWD_PLANS[key] = forward_plan(B, P, K, C, _sms(x), n.value)
    return plan


def _launch_mma(x: torch.Tensor, w: torch.Tensor, act: str) -> torch.Tensor:
    """The bf16 forward: one kernel, its sums across blocks inside it."""
    B, P, K = x.shape
    C = w.shape[1]
    plan = _forward_plan(x, K, C, act)
    w = w.contiguous()
    ctiles = _cdiv(C, FWD_TILE_C)
    part = torch.empty((plan.nblocks, plan.slots, ctiles * FWD_TILE_C),
                       device=x.device, dtype=torch.float32)
    out = torch.empty((B, C), device=x.device, dtype=x.dtype)
    stream = tiling.current_stream(x.device)
    counter = tiling.stream_counters(_FWD_COUNTERS, x.device, stream,
                                     B * ctiles)
    ptr = loader.ptr
    code = loader.library().token_head_fwd_mma(
        ptr(x), *x.stride(), ptr(w), ptr(part), ptr(out), ptr(counter),
        B, P, K, C, ACTS[act], *plan, ctypes.c_void_p(stream))
    loader.check(code, "token_head_fwd_mma")
    return out


_FP32_FWD_SLOTS: Dict[tuple, int] = {}


def _fp32_forward_plan(x: torch.Tensor, K: int, C: int,
                       act: str) -> Fp32FwdPlan:
    """The fp32 plan with the blocks an SM of this card holds, asked once
    per kernel variant and shared memory size."""
    B, P = x.shape[0], x.shape[1]
    tp, mode, smem = fp32_forward_tile(K)
    key = (x.device, act, tp, mode, smem)
    slots = _FP32_FWD_SLOTS.get(key)
    if slots is None:
        n = ctypes.c_int(0)
        loader.check(loader.library().token_head_fwd_tf32x3_occupancy(
            ACTS[act], tp, mode, smem, ctypes.byref(n)),
            "token_head_fwd_tf32x3 occupancy")
        if n.value < 1:
            raise RuntimeError(f"token head forward: no block with {smem} "
                               "bytes of shared memory fits an SM")
        slots = _FP32_FWD_SLOTS[key] = n.value
    return fp32_forward_plan(B, P, K, C, _sms(x), slots)


def _launch_tf32x3(x: torch.Tensor, w: torch.Tensor,
                   act: str) -> torch.Tensor:
    """The fp32 forward: one kernel of split-TF32 products, its sums across
    K's slices and across blocks inside it."""
    B, P, K = x.shape
    C = w.shape[1]
    plan = _fp32_forward_plan(x, K, C, act)
    w = w.contiguous()
    part_shape, spart_n, n_counters = fp32_forward_scratch(plan, B, C)
    part = torch.empty(part_shape, device=x.device, dtype=torch.float32)
    spart = (torch.empty(spart_n, device=x.device, dtype=torch.float32)
             if spart_n else None)
    out = torch.empty((B, C), device=x.device, dtype=x.dtype)
    stream = tiling.current_stream(x.device)
    counter = tiling.stream_counters(_FWD_COUNTERS, x.device, stream,
                                     n_counters)
    ptr = loader.ptr
    code = loader.library().token_head_fwd_tf32x3(
        ptr(x), *x.stride(), ptr(w), ptr(part), ptr(out), ptr(counter),
        ctypes.c_void_p(None if spart is None else spart.data_ptr()),
        B, P, K, C, ACTS[act], *plan, ctypes.c_void_p(stream))
    loader.check(code, "token_head_fwd_tf32x3")
    return out


def _launch(x: torch.Tensor, w: torch.Tensor, act: str) -> torch.Tensor:
    _check_launch("fused_token_head", x, w)
    if x.dtype == torch.bfloat16:
        return _launch_mma(x, w, act)
    return _launch_tf32x3(x, w, act)


_BWD_SLOTS: Dict[tuple, int] = {}
# the backward's barrier: arrivals and departures (the first two counters)
_BARRIERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _backward_plan(x: torch.Tensor, K: int, C: int, act: str) -> BwdPlan:
    """The plan with the blocks an SM of this card holds, asked once per
    kernel and shared memory size."""
    B, P = x.shape[0], x.shape[1]
    tp, mode, smem = backward_tile(K, C, x.element_size())
    # the fp32 rows kernel's accumulators are sized by K in 32s
    key = (x.device, x.dtype, act, tp, mode, smem, _cdiv(K, 32))
    slots = _BWD_SLOTS.get(key)
    if slots is None:
        n = ctypes.c_int(0)
        loader.check(loader.library().token_head_bwd_occupancy(
            loader.DTYPE_CODES[x.dtype], ACTS[act], tp, mode, K, smem,
            ctypes.byref(n)), "token_head_bwd occupancy")
        if n.value < 1:
            raise RuntimeError(f"token head backward: no block with "
                               f"{smem} bytes of shared memory fits an SM")
        slots = _BWD_SLOTS[key] = n.value
    return backward_plan(B, P, K, C, x.element_size(), _sms(x), slots)


def _launch_backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                     act: str) -> Tuple[torch.Tensor, torch.Tensor]:
    B, P, K = x.shape
    C = w.shape[1]
    _check_launch("fused_token_head backward", x, w)
    loader.require_cuda("fused_token_head backward", g)
    plan = _backward_plan(x, K, C, act)
    w = w.contiguous()
    g = g.to(torch.float32).contiguous()
    # x's own layout where it is dense, so that the gradient goes back
    # through the views that made x (models/visual_tokens.py::tap_positions)
    # without a copy
    dx = torch.empty_like(x)
    part = torch.empty(backward_scratch(plan, x.element_size(), B, P, K, C),
                       device=x.device, dtype=torch.float32)
    dw = torch.empty((K, C), device=x.device, dtype=torch.float32)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    stream = tiling.current_stream(x.device)
    code = loader.library().token_head_bwd(
        ptr(x), loader.DTYPE_CODES[x.dtype], *x.stride(), ptr(w), ptr(g),
        ptr(dx), *dx.stride(), ptr(part), ptr(dw),
        ptr(tiling.stream_counters(_BARRIERS, x.device, stream,
                                   BARRIER_WORDS)),
        B, P, K, C, ACTS[act], *plan, ctypes.c_void_p(stream),
    )
    loader.check(code, "token_head_bwd")
    return dx, dw


def token_head_backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                        act: str = "serf") -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype and layout, dW (K, C) fp32) for the gradient ``g``
    (B, C) of ``fused_token_head(x, w, act)``; ``w`` in x's dtype."""
    if x.device.type == "cpu":
        return token_head_backward_reference(x, w, g, act)
    out = _launch_backward(x, w, g, act)
    fused_token_head.backward_launches += 1
    if x.dtype == torch.float32:
        fused_token_head.backward_tf32x3_launches += 1
    return out


def _forward(x: torch.Tensor, w: torch.Tensor, act: str) -> torch.Tensor:
    if x.device.type == "cpu":
        return token_head_reference(x, w, act)
    out = _launch(x, w, act)
    fused_token_head.launches += 1
    if x.dtype == torch.float32:
        fused_token_head.tf32x3_launches += 1
    return out


def _compute_weight(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The fp32 master weight cast to a bf16 x's dtype; any other pair as it
    is (the launch refuses a mismatch)."""
    if w.dtype == torch.float32 and x.dtype == torch.bfloat16:
        return w.to(x.dtype)
    return w


class _TokenHead(torch.autograd.Function):
    """Saves x and the weight only, as the JAX package's ``_vjp_fwd``."""

    @staticmethod
    def forward(ctx, x, w, act):
        wc = _compute_weight(x, w)
        ctx.save_for_backward(x, wc)
        ctx.act = act
        ctx.w_dtype = w.dtype
        return _forward(x, wc, act)

    @staticmethod
    def backward(ctx, g):
        x, wc = ctx.saved_tensors
        dx, dw = token_head_backward(x, wc, g, ctx.act)
        return dx, dw.to(ctx.w_dtype), None


def fused_token_head(x: torch.Tensor, w: torch.Tensor,
                     act: str = "serf") -> torch.Tensor:
    """x: (B, P, K), any strides; w: (K, C), in x's dtype or the fp32 master
    of a bf16 x. Returns mean_p act(x @ w) as (B, C) in x's dtype,
    accumulated in fp32. ``act`` is 'serf', 'serf_fast' (the bf16
    polynomial) or 'relu'. Differentiable in x and w through the backward
    kernel."""
    tiling.refuse_dtensor("fused_token_head", x, w)
    if act not in ACTS:
        raise ValueError(f"fused_token_head: unknown act {act!r}")
    if x.dim() != 3 or w.dim() != 2 or x.shape[2] != w.shape[0]:
        raise ValueError(
            f"fused_token_head: x {tuple(x.shape)} and w {tuple(w.shape)} "
            "are not (B, P, K) and (K, C)"
        )
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _TokenHead.apply(x, w, act)
    return _forward(x, _compute_weight(x, w), act)


fused_token_head.launches = 0                  # every forward launch
fused_token_head.tf32x3_launches = 0           # those in fp32
fused_token_head.backward_launches = 0         # every backward launch
fused_token_head.backward_tf32x3_launches = 0  # those in fp32
