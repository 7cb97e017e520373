"""K1: the fused visual-token head, ``mean_p act(x @ W)``.

Counterpart of mmvqa_tpu/ops/pallas_token_head.py. The CUDA kernels are
``csrc/token_head.cu`` (forward) and ``csrc/token_head_bwd.cu`` (backward);
this module holds their launch plans, their wrappers, the
``torch.autograd.Function`` that joins them, and their plain PyTorch versions.

The wrappers route by where the input lies: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. There is no other
fallback.

Mixed precision: ``w`` may be the fp32 master weight while ``x`` is bf16. The
forward then takes the bf16 cast of ``w`` and the backward hands the kernel's
fp32 dW to the master unrounded. ``gact = act'(s) g / P`` stays fp32 inside
the backward kernel (the TPU kernel rounds it to the input dtype before the
two gradient products), so in bf16 only dx, rounded once on the way out,
differs from the fp32 result.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

from mmvqa_tpu_torch.native import loader
from mmvqa_tpu_torch.ops.activations import (
    SERF_CLAMP,
    SERF_P5,
    serf_exact,
    serf_fast,
)

ACTS = {"serf": 0, "serf_fast": 1, "relu": 2}

TILE_P = 64               # kTileP in csrc/token_head.cu: positions per tile
TILE_C = 128              # kTileC: output channels per block
BLOCKS_PER_SM = 3         # kMinBlocks: the register cap fits three per SM
WAVES = 4                 # blocks in flight per SM slot; one wave measured
                          # slower (PERF.md)
BWD_BLOCKS_PER_SM = 2     # __launch_bounds__ of csrc/token_head_bwd.cu
BWD_WAVES = 2
SMEM_PER_SM = 227 * 1024  # shared memory the blocks of one SM can use


class Plan(NamedTuple):
    chunk: int     # positions per block, a multiple of TILE_P
    nchunks: int   # blocks along P


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(B: int, P: int, K: int, C: int, sms: int) -> Plan:
    """How the launch cuts P on a card with ``sms`` multiprocessors; raises
    for shapes the grid cannot take.

    A block owns one batch row, TILE_C channels and one chunk of positions;
    P is cut into enough chunks to fill every SM's BLOCKS_PER_SM slots
    WAVES times over, and no more chunks than there are position tiles. K is
    staged through shared memory in steps, so any K fits."""
    if min(B, P, K, C) < 1:
        raise ValueError(f"token head: empty shape B={B} P={P} K={K} C={C}")
    c_tiles = _cdiv(C, TILE_C)
    target = WAVES * BLOCKS_PER_SM * sms
    nchunks = min(max(1, _cdiv(target, B * c_tiles)), _cdiv(P, TILE_P))
    chunk = _cdiv(_cdiv(P, nchunks), TILE_P) * TILE_P
    nchunks = _cdiv(P, chunk)
    if B > 2**31 - 1 or c_tiles > 65535 or nchunks > 65535:
        raise ValueError(f"token head: grid too large for B={B}, P={P}, C={C}")
    return Plan(chunk, nchunks)


def backward_plan(B: int, P: int, K: int, C: int, sms: int) -> Plan:
    """How the backward launch shares the ``B * ceil(P / TILE_P)`` (batch
    row, position tile) work items among blocks: ``chunk`` items a block,
    ``nchunks`` blocks, none left empty. A block needs ``bwd_smem_bytes(K)``
    of shared memory and keeps a (K, C) fp32 partial of dW, so there are no
    more blocks than fill the card BWD_WAVES times."""
    if min(B, P, K, C) < 1:
        raise ValueError(f"token head: empty shape B={B} P={P} K={K} C={C}")
    if bwd_smem_bytes(K) > SMEM_PER_SM:
        raise ValueError(
            f"token head backward: K={K} needs {bwd_smem_bytes(K)} bytes of "
            f"shared memory for its dx tile, a block has {SMEM_PER_SM}"
        )
    items = B * _cdiv(P, TILE_P)
    per_sm = min(BWD_BLOCKS_PER_SM, SMEM_PER_SM // bwd_smem_bytes(K))
    per_block = _cdiv(items, BWD_WAVES * per_sm * sms)
    nblocks = _cdiv(items, per_block)
    if nblocks > 2**31 - 1:
        raise ValueError(f"token head: grid too large for B={B}, P={P}")
    return Plan(per_block, nblocks)


def bwd_smem_bytes(K: int) -> int:
    """smem_floats in csrc/token_head_bwd.cu, in bytes."""
    chunk_k, row_c = 32, TILE_C + 4
    return 4 * (chunk_k * TILE_P + chunk_k * row_c + TILE_P * row_c + TILE_C
                + TILE_P * (K + 1))


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
    in fp32. Materializes the (B, P, C) map."""
    xf, wf = x.float(), w.float()
    s = torch.einsum("bpk,kc->bpc", xf, wf)
    gact = _act_grad(s, act) * (g.float() / x.shape[1])[:, None, :]
    dx = torch.einsum("bpc,kc->bpk", gact, wf).to(x.dtype)
    dw = torch.einsum("bpk,bpc->kc", xf, gact)
    return dx, dw


def _check_launch(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    loader.require_cuda(name, x, w)
    if w.dtype != x.dtype:
        raise ValueError(f"{name}: x is {x.dtype}, w is {w.dtype}")


def _sms(x: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def _launch(x: torch.Tensor, w: torch.Tensor, act: str) -> torch.Tensor:
    B, P, K = x.shape
    C = w.shape[1]
    _check_launch("fused_token_head", x, w)
    plan = launch_plan(B, P, K, C, _sms(x))
    w = w.contiguous()
    partial = torch.empty((B, plan.nchunks, C), device=x.device,
                          dtype=torch.float32)
    out = torch.empty((B, C), device=x.device, dtype=x.dtype)
    lib = loader.library()
    sb, sp, sk = x.stride()
    code = lib.token_head_fwd(
        ctypes.c_void_p(x.data_ptr()), loader.DTYPE_CODES[x.dtype],
        sb, sp, sk,
        ctypes.c_void_p(w.data_ptr()), ctypes.c_void_p(partial.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        B, P, K, C, ACTS[act], plan.chunk, plan.nchunks,
        loader.stream_ptr(),
    )
    loader.check(code, "token_head_fwd")
    return out


def _launch_backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                     act: str) -> Tuple[torch.Tensor, torch.Tensor]:
    B, P, K = x.shape
    C = w.shape[1]
    _check_launch("fused_token_head backward", x, w)
    loader.require_cuda("fused_token_head backward", g)
    plan = backward_plan(B, P, K, C, _sms(x))
    w = w.contiguous()
    g = g.to(torch.float32).contiguous()
    # x's own layout where it is dense, so that the gradient goes back
    # through the views that made x (models/visual_tokens.py::tap_positions)
    # without a copy
    dx = torch.empty_like(x)
    dwpart = torch.empty((plan.nchunks, K, C), device=x.device,
                         dtype=torch.float32)
    dw = torch.empty((K, C), device=x.device, dtype=torch.float32)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    code = loader.library().token_head_bwd(
        ptr(x), loader.DTYPE_CODES[x.dtype], *x.stride(), ptr(w), ptr(g),
        ptr(dx), *dx.stride(), ptr(dwpart), ptr(dw),
        B, P, K, C, ACTS[act], plan.chunk, plan.nchunks, loader.stream_ptr(),
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
    return out


def _forward(x: torch.Tensor, w: torch.Tensor, act: str) -> torch.Tensor:
    if x.device.type == "cpu":
        return token_head_reference(x, w, act)
    out = _launch(x, w, act)
    fused_token_head.launches += 1
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


fused_token_head.launches = 0
fused_token_head.backward_launches = 0
