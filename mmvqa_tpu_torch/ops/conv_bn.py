"""K4: a 1x1 convolution that returns the BatchNorm statistics of its output
from the same pass.

Counterpart of mmvqa_tpu/ops/pallas_conv_bn.py. The CUDA kernels are in
``csrc/conv1x1_stats.cu``: in bf16 a TMA-fed ``wgmma`` kernel for the shapes
its tensor maps take (every site of the trunk; ``takes_tma``) and an
``mma.sync`` kernel for the rest; in fp32 one kernel for every shape, its
products split into three TF32 products on the tensor cores to keep fp32
accuracy (``csrc/tf32x3.cuh``). This module holds their launch plans, the
wrapper, the ``torch.autograd.Function`` around it and the plain PyTorch
version.

Layout, as the JAX function: ``x`` is (N, K), the channels-last map
flattened to rows, ``w`` is (K, C), ``y`` is (N, C), ``stats`` is fp32 (2, C)
= [sum_n y, sum_n y^2]. On a CUDA tensor ``x`` must be dense (the wrapper
raises otherwise rather than copy); ``w`` may have any strides, so the
convolution's (C, K, 1, 1) weight goes in as its (K, C) view.

Both sums are taken from the unrounded fp32 product, in the kernel and in the
plain version alike (the JAX package's reference sums the rounded ``y``,
which is why its bf16 test allows 2e-2).

The backward is plain tensor code, as in the JAX package, whose
``_vjp_bwd`` is plain ``jnp``: two matrix products, with the statistics'
cotangent folded into dy where there is one. A BatchNorm whose own backward
returns the full gradient hands back none, and then the products run in the
maps' dtype with no fp32 copy of them.

The wrapper routes by where ``x`` lies: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from mmvqa_tpu_torch.native import loader
from mmvqa_tpu_torch.ops import tiling

TILE_M = 128       # kBM of the bf16 mma.sync kernel
BLOCKS_PER_SM = 4  # two resident, two waves

# the fp32 kernel (k4::f32 in the source): (rows, columns) of a tile and
# its time a tile's area relative to 128 x 128's (read on the card at the
# trunk's shapes: PERF.md §6); two blocks an SM hold any of them
TF32_TILES = ((128, 128, 1.0), (128, 64, 1.14), (64, 128, 1.02),
              (64, 64, 1.37))
TF32_BLOCKS_PER_SM = 2
TF32_STAGES = 3            # kStages: the ring

# the TMA path (k4::tma in the source)
TMA_TILE_N = (64, 128, 192)  # column tiles a kernel is built for
TMA_TILE_M = 192             # kBM: rows of a tile, three warpgroups of 64
TMA_WARPS = 12               # kConsumerWarps
TMA_STAGES = (6, 5, 4)       # the ring, the deepest that fits
SMEM_LIMIT = 232448          # shared memory one block can have


class TmaPlan(NamedTuple):
    """The TMA launch; the fields in the order of the C entry point's plan
    arguments."""
    bn: int      # channels of a column tile
    stages: int  # of the ring
    nrb: int     # blocks along the rows, each walking every nrb-th row tile
    smem: int    # dynamic shared memory, bytes


def _check_shape(N: int, K: int, C: int) -> None:
    if min(N, K, C) < 1:
        raise ValueError(f"conv1x1_stats: empty shape N={N} K={K} C={C}")
    if max(N, K, C) > 2**31 - 1 - 192:
        raise ValueError(f"conv1x1_stats: N={N} K={K} C={C} beyond int32")


def launch_plan(N: int, K: int, C: int, sms: int) -> int:
    """The bf16 mma.sync kernel's blocks along the rows. Each walks over
    every ``nrb``-th row tile and writes one (2, C) partial of the sums;
    there are enough of them to fill the card and no more than row tiles."""
    _check_shape(N, K, C)
    mtiles = tiling.cdiv(N, TILE_M)
    ctiles = tiling.cdiv(C, 64 if C <= 64 else 128)
    return max(1, min(mtiles, tiling.cdiv(BLOCKS_PER_SM * sms, ctiles),
                      65535))


class Tf32Plan(NamedTuple):
    """The fp32 launch; the fields in the order of the C entry point's plan
    arguments."""
    bm: int    # rows of a tile
    bn: int    # columns (channels) of a tile
    nrb: int   # blocks along the rows, each walking every nrb-th row tile
    ks: int    # slices of K, each a block's (1: none; else nrb = row tiles)
    smem: int  # dynamic shared memory, bytes


def tf32_smem_bytes(bm: int, bn: int) -> int:
    """k4::f32::smem_bytes: the ring's stages of a bm x 32 x chunk and a
    bn x 32 W chunk, fp32."""
    return 4 * TF32_STAGES * (bm + bn) * 32


TF32_KSPLIT = (1, 2, 4)     # slices of K a plan may take
TF32_KSPLIT_MIN_K = 1024    # the depth below which K is not sliced
TF32_KSPLIT_COST = 0.25     # each slice past the first: its sums written,
                            # read back and added, relative to the tile
TF32_LONE_BLOCK = 0.7       # an SM's rate with one block, relative to two


def tf32_plan(N: int, K: int, C: int, sms: int) -> Tf32Plan:
    """The fp32 kernel's tile, its blocks along the rows and its slices of
    K, by a model of the busiest SM's time read off the card (PERF.md §6).
    Unsliced, the blocks along the rows are as many as fill the card's
    slots once with every column tile, no more than the row tiles, each
    walking every nrb-th row tile; where K is deep (TF32_KSPLIT_MIN_K) it
    may be cut into ks slices, one a block, every row tile a block of its
    own, in as many full waves as that takes. The time: waves of the slots,
    times a block's row tiles, times a tile's cost over ks and
    TF32_KSPLIT_COST a slice past the first, slower by TF32_LONE_BLOCK
    where an SM gets one block. Of the plans whose grid gives every SM a
    block (or, where none does, as many blocks as the most any gives), the
    fastest. So at N = 6272, C = 304 the 147 tiles of 128 x 128 would leave
    15 SMs two blocks each and 128 x 64 is taken, and at N = 784, K = 1824,
    C = 304 (B=16, 7x7) 64 x 64 in four slices of K."""
    _check_shape(N, K, C)
    slots = TF32_BLOCKS_PER_SM * sms

    def plan(tile, ks):  # (blocks along the rows, grid, time), None: no
        bm, bn, rel = tile
        mtiles, ctiles = tiling.cdiv(N, bm), tiling.cdiv(C, bn)
        if ks > 1 and (K < TF32_KSPLIT_MIN_K or mtiles > 65535):
            return None
        nrb = (mtiles if ks > 1
               else max(1, min(mtiles, slots // ctiles, 65535)))
        grid = ctiles * nrb * ks
        time = (tiling.cdiv(grid, slots) * tiling.cdiv(mtiles, nrb)
                * bm * bn * rel / ks * (1 + TF32_KSPLIT_COST * (ks - 1))
                / (TF32_LONE_BLOCK if grid <= sms else 1.0))
        return nrb, grid, time

    plans = {(t, ks): p for t in TF32_TILES for ks in TF32_KSPLIT
             if (p := plan(t, ks)) is not None}
    need = min(sms, max(p[1] for p in plans.values()))
    (tile, ks), (nrb, _, _) = min(
        ((key, p) for key, p in plans.items() if p[1] >= need),
        key=lambda kp: kp[1][2])
    return Tf32Plan(tile[0], tile[1], nrb, ks,
                    tf32_smem_bytes(tile[0], tile[1]))


def tma_smem_bytes(bn: int, stages: int) -> int:
    """k4::tma::smem_bytes: 1024 bytes to reach a 1024-byte boundary, the
    ring's stages (a 192 x 64 x box and a bn x 64 W box, bf16), a 16 x 64 y
    box for each of the 12 consumer warps, two mbarriers a stage, the
    last-block flag."""
    return (1024 + stages * (TMA_TILE_M * 64 * 2 + bn * 64 * 2)
            + TMA_WARPS * 16 * 64 * 2 + 2 * stages * 8 + 16)


def tma_tile_n(C: int) -> int:
    """The column tile for C: the least padded width weighed by how often x
    is staged again (a tile of bn columns stages a row tile's x once for
    every bn of them, 64 more bytes of products a column at bn = 64), the
    wider tile on a tie: one tile wherever C <= 192."""
    def cost(bn):  # tiles * bn * (1 + 64 / bn), then the fewer tiles
        tiles = tiling.cdiv(C, bn)
        return tiles * (bn + 64), tiles
    return min(TMA_TILE_N, key=cost)


def tma_plan(N: int, K: int, C: int, sms: int) -> TmaPlan:
    """One persistent block an SM (each takes more than half an SM's shared
    memory): the column tiles share the SMs, and the blocks of a column
    tile walk its row tiles in turn. Where ``tma_tile_n``'s tiles would leave
    more than a quarter of the SMs idle (few row tiles: N = 6272, C = 304),
    narrower ones that fill more of them are taken."""
    _check_shape(N, K, C)
    mtiles = tiling.cdiv(N, TMA_TILE_M)

    def nrb(bn):  # blocks along the rows
        return max(1, min(mtiles, sms // tiling.cdiv(C, bn), 65535))

    def blocks(bn):
        return tiling.cdiv(C, bn) * nrb(bn)

    bn = tma_tile_n(C)
    while bn > TMA_TILE_N[0] and 4 * blocks(bn) < 3 * sms:
        narrower = TMA_TILE_N[TMA_TILE_N.index(bn) - 1]
        if blocks(narrower) <= blocks(bn):
            break
        bn = narrower
    stages = next(s for s in TMA_STAGES if tma_smem_bytes(bn, s) <= SMEM_LIMIT)
    return TmaPlan(bn, stages, nrb(bn), tma_smem_bytes(bn, stages))


def takes_tma(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether a bf16 call takes the TMA path, by shape and alignment alone:
    x dense with K a multiple of 8, w (K, C) K-major (unit stride on K) with
    its columns a multiple of 8 elements apart, C a multiple of 8, both
    bases on 16 bytes. Everything else takes the mma.sync kernel."""
    K, C = w.shape
    return (x.dtype == torch.bfloat16 and x.is_contiguous()
            and K % 8 == 0 and C % 8 == 0
            and w.stride(0) == 1 and w.stride(1) % 8 == 0
            and w.stride(1) >= K
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def _sums(yf: torch.Tensor) -> torch.Tensor:
    return torch.stack([yf.sum(dim=0), (yf * yf).sum(dim=0)])


def conv1x1_stats_reference(x: torch.Tensor,
                            w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the (N, C) product in fp32, its sums, then y rounded to
    x's dtype."""
    yf = x.float() @ w.float()
    return yf.to(x.dtype), _sums(yf)


def conv1x1_stats_backward(
    x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, dy: Optional[torch.Tensor],
    dstats: Optional[torch.Tensor], need_dx: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(dx, dW) of ``conv1x1_stats`` for the cotangents ``dy`` (N, C) and
    ``dstats`` (2, C), one of which may be None (zero)
    (mmvqa_tpu/ops/pallas_conv_bn.py::_vjp_bwd). d s1 / dy = 1 and
    d s2 / dy = 2 y. ``need_dx=False`` leaves dx out (None), for a map that
    wants no gradient."""
    if dstats is None:
        dy = dy.to(x.dtype)
        return (dy @ w.t() if need_dx else None), x.t() @ dy
    # Only the parity tests against the JAX function reach the rest: the
    # trunk's BatchNorm returns the full gradient itself and hands the sums
    # no cotangent. Written for clarity in fp32, not for speed.
    g = dstats[0][None, :] + 2.0 * y.float() * dstats[1][None, :]
    if dy is not None:
        g = g + dy.float()
    dx = (g @ w.float().t()).to(x.dtype) if need_dx else None
    dw = (x.float().t() @ g).to(w.dtype)
    return dx, dw


# the TMA and fp32 kernels' last-block counters, one a column tile
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_TMA_PLANS: Dict[tuple, TmaPlan] = {}
_TF32_PLANS: Dict[tuple, Tf32Plan] = {}


def _launch_tma(x: torch.Tensor, w: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    N, K = x.shape
    C = w.shape[1]
    key = (x.device, N, K, C)  # made once a shape: a call's host time counts
    plan = _TMA_PLANS.get(key)
    if plan is None:
        plan = _TMA_PLANS[key] = tma_plan(N, K, C, tiling.sm_count(x))
    ctiles = tiling.cdiv(C, plan.bn)
    y = torch.empty((N, C), device=x.device, dtype=x.dtype)
    part = torch.empty((plan.nrb, 2, ctiles * plan.bn), device=x.device,
                       dtype=torch.float32)
    stats = torch.empty((2, C), device=x.device, dtype=torch.float32)
    ptr = loader.ptr
    stream = tiling.current_stream(x.device)
    code = loader.library().conv1x1_stats_tma(
        ptr(x), ptr(w), w.stride(1), ptr(y), ptr(part), ptr(stats),
        ptr(tiling.stream_counters(_COUNTERS, x.device, stream, ctiles)),
        N, K, C, *plan, ctypes.c_void_p(stream))
    loader.check(code, "conv1x1_stats_tma")
    return y, stats


def _launch_tf32x3(x: torch.Tensor, w: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    N, K = x.shape
    C = w.shape[1]
    key = (x.device, N, K, C)
    plan = _TF32_PLANS.get(key)
    if plan is None:
        plan = _TF32_PLANS[key] = tf32_plan(N, K, C, tiling.sm_count(x))
    ctiles = tiling.cdiv(C, plan.bn)
    y = torch.empty((N, C), device=x.device, dtype=x.dtype)
    part = torch.empty((plan.nrb, 2, ctiles * plan.bn), device=x.device,
                       dtype=torch.float32)
    stats = torch.empty((2, C), device=x.device, dtype=torch.float32)
    ypart = (torch.empty((plan.ks, N, C), device=x.device,
                         dtype=torch.float32) if plan.ks > 1 else None)
    ptr = loader.ptr
    stream = tiling.current_stream(x.device)
    # a column tile's counter, then a (row tile, column tile)'s where K is
    # sliced
    counters = tiling.stream_counters(
        _COUNTERS, x.device, stream,
        ctiles * (1 + (tiling.cdiv(N, plan.bm) if plan.ks > 1 else 0)))
    code = loader.library().conv1x1_stats_tf32x3(
        ptr(x), ptr(w), *w.stride(), ptr(y), ptr(part), ptr(stats),
        ptr(counters), ctypes.c_void_p(None if ypart is None
                                       else ypart.data_ptr()),
        N, K, C, *plan, ctypes.c_void_p(stream))
    loader.check(code, "conv1x1_stats_tf32x3")
    return y, stats


def _launch(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    loader.require_cuda("conv1x1_stats", x, w)
    if w.dtype != x.dtype:
        raise ValueError(f"conv1x1_stats: x is {x.dtype}, w is {w.dtype}")
    tiling.require_dense("conv1x1_stats", x)
    if x.dtype == torch.float32:
        out = _launch_tf32x3(x, w)
        conv1x1_stats.tf32x3_launches += 1
        return out
    if takes_tma(x, w):
        out = _launch_tma(x, w)
        conv1x1_stats.tma_launches += 1
        return out
    N, K = x.shape
    C = w.shape[1]
    nrb = launch_plan(N, K, C, tiling.sm_count(x))
    y = torch.empty((N, C), device=x.device, dtype=x.dtype)
    partial = torch.empty((nrb, 2, C), device=x.device, dtype=torch.float32)
    stats = torch.empty((2, C), device=x.device, dtype=torch.float32)
    ptr = loader.ptr
    code = loader.library().conv1x1_stats(
        ptr(x), loader.DTYPE_CODES[x.dtype], ptr(w), *w.stride(), ptr(y),
        ptr(partial), ptr(stats), N, K, C, nrb, loader.stream_ptr())
    loader.check(code, "conv1x1_stats")
    return y, stats


def _forward(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return conv1x1_stats_reference(x, w)
    out = _launch(x, w)
    conv1x1_stats.launches += 1
    return out


class _Conv1x1Stats(torch.autograd.Function):
    """Saves x, w and y, as the JAX package's ``_vjp_fwd``; y is the tensor
    the BatchNorm behind it saves too, so it costs no memory."""

    @staticmethod
    def forward(ctx, x, w):
        y, stats = _forward(x, w)
        ctx.save_for_backward(x, w, y)
        ctx.set_materialize_grads(False)
        return y, stats

    @staticmethod
    def backward(ctx, dy, dstats):
        x, w, y = ctx.saved_tensors
        dx, dw = conv1x1_stats_backward(x, w, y, dy, dstats,
                                        need_dx=ctx.needs_input_grad[0])
        return dx, dw


def conv1x1_stats(x: torch.Tensor,
                  w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N, K), rows of a channels-last map (dense on the card); w: (K, C)
    in x's dtype, any strides. Returns (y, stats): y = x @ w in x's dtype
    and the fp32 (2, C) sums [sum_n y, sum_n y^2] of the fp32 product.
    Differentiable in x and w, through y and through stats."""
    tiling.refuse_dtensor("conv1x1_stats", x, w)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(
            f"conv1x1_stats: x {tuple(x.shape)} and w {tuple(w.shape)} are "
            "not (N, K) and (K, C)"
        )
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv1x1Stats.apply(x, w)
    return _forward(x, w)


conv1x1_stats.launches = 0         # every launch, of any path
conv1x1_stats.tma_launches = 0     # those of the bf16 TMA path
conv1x1_stats.tf32x3_launches = 0  # those of the fp32 path
