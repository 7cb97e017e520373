"""K2: the RealFormer residual-attention core.

Counterpart of mmvqa_tpu/ops/attention.py::realformer_attention and
mmvqa_tpu/ops/pallas_attention.py. The CUDA kernels are
``csrc/realformer_attention.cu`` (forward) and
``csrc/realformer_attention_bwd.cu`` (backward); this module holds their
wrappers, the ``torch.autograd.Function`` that joins them, and their plain
PyTorch versions.

Semantics are the XLA path's (mmvqa_tpu/ops/attention.py:131-142): the
carried scores are ``q k^T / sqrt(E) (+ prev) - 10000 (1 - mask_q)`` and the
softmax is taken over those stored scores. The carry is fp32 and head-major,
(B, H, T, T), as in the Pallas kernel; the XLA path's carry is (B, T, T, H).

The backward recomputes the softmax from the stored carry, which with these
semantics is exactly the forward's softmax input. The mask gets no gradient.

Each direction has a kernel that holds a head's tiles in one block's shared
memory (the flagship T=75 and T=28), and tiled kernels for any longer T,
chosen by T and E alone (``fits_one_block``). In bf16 and in fp32 each
direction takes a tensor-core kernel wherever a head fits it
(``forward_path``, ``backward_path``), the train path's T=75 and the eval
path's T=28 among them: bf16 products on ``mma.sync``, or in fp32 three TF32
products a product (split TF32), which keep fp32's accuracy. At E=96 the
fp32 forward takes T up to 128, the fp32 backward T up to 96.

A CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises.

The vanilla BERT encoder's core (``vanilla_attention``, counterpart of
mmvqa_tpu/ops/attention.py::vanilla_attention) is here too: the JAX package
computes it with XLA's own products, so its port is plain tensor operations,
no kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional, Tuple

import torch

from mmvqa_tpu_torch.native import loader
from mmvqa_tpu_torch.ops import tiling

NEG_BIG = 10000.0
SMEM_LIMIT = 232448  # shared memory one block can have on an H100 (227 KB)
TILE = 32            # query rows or keys a block of the tiled kernels owns
MMA_MAX_T = 128      # k2tc::kMaxTiles x 16: the tensor-core kernels' rows
MMA_PAD = 8          # k2tc::kPad: bf16 elements past each of their staged rows


def _tiles16(T: int) -> int:
    """T padded to Tp, a multiple of 16: the tensor-core kernels' rows."""
    return -(-T // 16) * 16


def _ld32(n: int) -> int:
    """k2tc::ld32: fp32 values a staged row holds, n rounded up to 32."""
    return -(-n // 32) * 32


def _flat_bytes(T: int) -> int:
    """k2tc::flat_floats in bytes: a staged flat (T, T) fp32 block."""
    return 4 * ((T * T + 6) // 4 * 4)


def _one_block_bytes(T: int, E: int, backward: bool) -> int:
    """Shared memory of the one-block kernels: attn_smem_bytes in
    csrc/realformer_attention.cu, smem_bytes in
    csrc/realformer_attention_bwd.cu."""
    if backward:
        return 4 * (3 * T * E + T * (E + 1) + 2 * T * T)
    return 4 * (T * E + T * (E + 1) + T * E + T * T + T)


def _tiled_bytes(E: int, backward: bool) -> int:
    """The largest shared memory of the tiled kernels: the forward's, or the
    backward's two (rows_smem_bytes, cols_smem_bytes)."""
    tile = TILE * (TILE + 1)
    if backward:
        return 4 * max(2 * TILE * E + TILE * (E + 1) + 2 * tile + 3 * TILE,
                       4 * TILE * E + 2 * tile)
    return 4 * (2 * TILE * E + TILE * (E + 1) + tile + 3 * TILE)


def fits_one_block(T: int, E: int, backward: bool) -> bool:
    """Whether a head's tiles fit one block's shared memory, so that the
    one-block kernel runs; else the tiled kernels do. Raises where neither
    can: a head too wide for the tiled kernels' 32-row tiles."""
    if _one_block_bytes(T, E, backward) <= SMEM_LIMIT:
        return True
    if _tiled_bytes(E, backward) > SMEM_LIMIT:
        raise ValueError(
            f"realformer_attention: a head of E={E} needs "
            f"{_tiled_bytes(E, backward)} bytes of shared memory for its "
            f"{TILE}-row tiles, a block has {SMEM_LIMIT}")
    return False


def mma_smem_bytes(T: int, E: int) -> int:
    """Shared memory of the tensor-core backward, tc::smem_bytes in
    csrc/realformer_attention_bwd.cu: q, k, dctx in bf16 rows of E + 8; then
    v's rows and the flat fp32 carry and dcarry blocks, or, in their place
    once ds is taken, the four bf16 (Tp, Tp + 8) tiles of p and ds (hi and
    lo terms), whichever is larger; T padded to Tp, a multiple of 16."""
    Tp = _tiles16(T)
    rows = 2 * Tp * (E + MMA_PAD)
    return 3 * rows + max(rows + 2 * _flat_bytes(T), 8 * Tp * (Tp + MMA_PAD))


def forward_mma_smem_bytes(T: int, E: int) -> int:
    """Shared memory of the tensor-core forward, tc::stage_bytes in
    csrc/realformer_attention.cu: q, k, v in bf16 rows of E + 8, then the
    flat fp32 (T, T) block of prev and s; T padded to Tp, a multiple of
    16."""
    return 3 * 2 * _tiles16(T) * (E + MMA_PAD) + _flat_bytes(T)


def tf32x3_smem_bytes(T: int, E: int) -> int:
    """Shared memory of the fp32 tensor-core backward, tc32::smem_bytes in
    csrc/realformer_attention_bwd.cu: q, k, dctx as fp32 rows of E rounded
    up to 32 (unpadded, swizzled); then v's rows and the flat carry and
    dcarry blocks, or, in their place once ds is taken, the fp32 p and ds
    tiles (Tp query rows of Tp rounded up to 32 keys), whichever is
    larger."""
    Tp = _tiles16(T)
    rows = 4 * Tp * _ld32(E)
    return 3 * rows + max(rows + 2 * _flat_bytes(T), 2 * 4 * Tp * _ld32(Tp))


def forward_tf32x3_smem_bytes(T: int, E: int) -> int:
    """Shared memory of the fp32 tensor-core forward, tc32::stage_bytes in
    csrc/realformer_attention.cu: q, k, v as fp32 rows of E rounded up to
    32, then the flat fp32 (T, T) block of prev and s."""
    return 3 * 4 * _tiles16(T) * _ld32(E) + _flat_bytes(T)


def _mma_shape(dtype: torch.dtype, T: int, E: int) -> bool:
    return (dtype in (torch.bfloat16, torch.float32) and E % 16 == 0
            and 16 <= E <= 128 and T <= MMA_MAX_T)


def forward_path(dtype: torch.dtype, T: int, E: int) -> str:
    """The forward kernel for a head of (T, E) in ``dtype``: ``"mma"``, the
    dtype's tensor-core kernel (bf16, or fp32 as split TF32), where E is a
    multiple of 16 up to 128, T at most 128 and the head fits one block's
    shared memory (bf16: every such head, the largest 166 KB; fp32: T up to
    128 at E=96, up to 112 at E=128); else ``"one_block"`` or ``"tiled"``
    as ``fits_one_block`` says."""
    smem = (forward_tf32x3_smem_bytes if dtype == torch.float32
            else forward_mma_smem_bytes)
    if _mma_shape(dtype, T, E) and smem(T, E) <= SMEM_LIMIT:
        return "mma"
    return "one_block" if fits_one_block(T, E, backward=False) else "tiled"


def backward_path(dtype: torch.dtype, T: int, E: int) -> str:
    """The backward kernel for a head of (T, E) in ``dtype``: ``"mma"``, the
    dtype's tensor-core kernel, where E is a multiple of 16 up to 128, T at
    most 128 and a head fits one block's shared memory (at E=96: T up to
    125 in bf16, up to 96 in fp32); else ``"one_block"`` or ``"tiled"`` as
    ``fits_one_block`` says."""
    smem = (tf32x3_smem_bytes if dtype == torch.float32 else mma_smem_bytes)
    if _mma_shape(dtype, T, E) and smem(T, E) <= SMEM_LIMIT:
        return "mma"
    return "one_block" if fits_one_block(T, E, backward=True) else "tiled"


# realformer_attn_fwd's and realformer_attn_bwd's path codes
PATH_CODES = {"one_block": 0, "tiled": 1, "mma": 2}


def mma_occupancy(T: int, E: int, backward: bool,
                  dtype: torch.dtype = torch.bfloat16) -> int:
    """Blocks of the tensor-core backward (or forward) of ``dtype`` for
    (T, E) that an SM of the current card holds at once."""
    name = f"realformer_attn_{'bwd' if backward else 'fwd'}_mma"
    blocks = ctypes.c_int(0)
    loader.check(getattr(loader.library(), name + "_occupancy")(
        loader.DTYPE_CODES[dtype], T, E, ctypes.byref(blocks)),
        name + " occupancy")
    return blocks.value


def _require_memory(name: str, t: torch.Tensor, nbytes: int) -> None:
    """A ValueError, not an allocator failure, for buffers the card cannot
    hold at all."""
    total = torch.cuda.get_device_properties(t.device).total_memory
    if nbytes > total:
        raise ValueError(f"{name}: needs {nbytes} bytes of (B, H, T, T) "
                         f"buffers, the card has {total}")


def _neg(query_mask: torch.Tensor) -> torch.Tensor:
    return NEG_BIG * (1.0 - query_mask.float())


def realformer_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    prev: Optional[torch.Tensor], query_mask: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version. q, k, v: (B, T, H, E); prev: (B, H, T, T) fp32 or None;
    query_mask: (B, T) (1 real, 0 pad) or None. Returns ctx (B, T, H, E) in
    q's dtype and the fp32 carry (B, H, T, T)."""
    E = q.shape[-1]
    qh, kh, vh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(E)
    if prev is not None:
        s = s + prev
    if query_mask is not None:
        s = s - _neg(query_mask)[:, None, :, None]
    p = torch.softmax(s, dim=-1)
    ctx = torch.matmul(p, vh).permute(0, 2, 1, 3).to(q.dtype)
    return ctx, s


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _launch(q, k, v, prev, query_mask):
    B, T, H, E = q.shape
    loader.require_cuda("realformer_attention", q, k, v)
    path = forward_path(q.dtype, T, E)
    _require_memory("realformer_attention", q,
                    4 * B * H * T * T * (2 if prev is not None else 1))
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("realformer_attention: q, k, v dtypes differ")
    if prev is not None:
        if prev.shape != (B, H, T, T) or prev.dtype != torch.float32:
            raise ValueError("realformer_attention: prev must be fp32 (B, H, T, T)")
        loader.require_cuda("realformer_attention", prev)
        prev = prev.contiguous()
    mask = None
    if query_mask is not None:
        mask = query_mask.to(device=q.device, dtype=torch.float32).contiguous()
        if mask.shape != (B, T):
            raise ValueError("realformer_attention: query_mask must be (B, T)")
    scores = torch.empty((B, H, T, T), device=q.device, dtype=torch.float32)
    ctx = torch.empty((B, T, H, E), device=q.device, dtype=q.dtype)
    strides = (ctypes.c_longlong * 16)(
        *q.stride(), *k.stride(), *v.stride(), *ctx.stride()
    )

    code = loader.library().realformer_attn_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(prev), _ptr(mask), _ptr(scores),
        _ptr(ctx),
        strides, loader.DTYPE_CODES[q.dtype], B, H, T, E, PATH_CODES[path],
        loader.stream_ptr(),
    )
    loader.check(code, "realformer_attn_fwd")
    if path == "mma" and q.dtype == torch.float32:
        realformer_attention.tf32x3_launches += 1
    elif path == "mma":
        realformer_attention.mma_launches += 1
    return ctx, scores


def realformer_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, carry: torch.Tensor,
    dctx: Optional[torch.Tensor], dcarry: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward. q, k, v: (B, T, H, E); carry: the
    forward's fp32 (B, H, T, T) scores; dctx (B, T, H, E) and dcarry
    (B, H, T, T): the gradients of the forward's outputs, None for zero.
    Returns dq, dk, dv (B, T, H, E) in q's dtype and ds (B, H, T, T) fp32,
    the gradient of ``prev`` where the layer had one."""
    E = q.shape[-1]
    qh, kh, vh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    p = torch.softmax(carry, dim=-1)
    if dctx is None:
        dch = torch.zeros_like(qh)
    else:
        dch = dctx.float().permute(0, 2, 1, 3)
    dp = torch.matmul(dch, vh.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    if dcarry is not None:
        ds = ds + dcarry
    scale = 1.0 / math.sqrt(E)
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    dv = torch.matmul(p.transpose(-1, -2), dch)
    dq, dk, dv = (t.permute(0, 2, 1, 3).to(q.dtype) for t in (dq, dk, dv))
    return dq, dk, dv, ds


def _launch_backward(kqv, carry, dctx, dcarry, want_dprev):
    B, T, H, E3 = kqv.shape
    E = E3 // 3
    k, q, v = kqv.split(E, dim=-1)
    loader.require_cuda("realformer_attention backward", kqv, carry)
    path = backward_path(kqv.dtype, T, E)
    tiled = path == "tiled"
    _require_memory("realformer_attention backward", kqv,
                    4 * B * H * T * T * (4 if tiled else 3))
    dkqv = torch.empty((B, T, H, E3), device=kqv.device, dtype=kqv.dtype)
    dk, dq, dv = dkqv.split(E, dim=-1)
    dprev = torch.empty_like(carry) if want_dprev else None
    ds_scratch = stats = None
    if tiled:
        # the tiled kernels keep ds in device memory: in dprev where it is
        # wanted, else in a scratch of its shape
        if dprev is None:
            ds_scratch = torch.empty_like(carry)
        stats = torch.empty((B, H, T, 2), device=kqv.device,
                            dtype=torch.float32)
    if dctx is not None:
        loader.require_cuda("realformer_attention backward", dctx)
        if dctx.dtype != kqv.dtype:
            dctx = dctx.to(kqv.dtype)
    if dcarry is not None:
        loader.require_cuda("realformer_attention backward", dcarry)
        dcarry = dcarry.to(torch.float32).contiguous()
    dctx_strides = dctx.stride() if dctx is not None else (0, 0, 0, 0)
    strides = (ctypes.c_longlong * 28)(
        *q.stride(), *k.stride(), *v.stride(), *dctx_strides,
        *dq.stride(), *dk.stride(), *dv.stride()
    )
    code = loader.library().realformer_attn_bwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(carry), _ptr(dctx), _ptr(dcarry),
        _ptr(dq), _ptr(dk), _ptr(dv), _ptr(dprev), _ptr(ds_scratch),
        _ptr(stats), strides, loader.DTYPE_CODES[kqv.dtype], B, H, T, E,
        PATH_CODES[path], loader.stream_ptr(),
    )
    loader.check(code, "realformer_attn_bwd")
    if path == "mma" and kqv.dtype == torch.float32:
        realformer_attention.backward_tf32x3_launches += 1
    elif path == "mma":
        realformer_attention.backward_mma_launches += 1
    return dkqv, dprev


def realformer_attention_backward(kqv, carry, dctx, dcarry, want_dprev):
    """Gradient of ``realformer_attention_packed``: (dkqv (B, T, H, 3E) in
    (k, q, v) order, dprev (B, H, T, T) fp32 or None)."""
    if kqv.device.type == "cpu":
        E = kqv.shape[-1] // 3
        k, q, v = kqv.split(E, dim=-1)
        dq, dk, dv, ds = realformer_attention_backward_reference(
            q, k, v, carry, dctx, dcarry)
        return torch.cat([dk, dq, dv], dim=-1), (ds if want_dprev else None)
    out = _launch_backward(kqv, carry, dctx, dcarry, want_dprev)
    realformer_attention.backward_launches += 1
    return out


def _forward(q, k, v, prev, query_mask):
    if q.device.type == "cpu":
        return realformer_attention_reference(q, k, v, prev, query_mask)
    out = _launch(q, k, v, prev, query_mask)
    realformer_attention.launches += 1
    return out


class _PackedAttention(torch.autograd.Function):
    """Saves the packed projection and the carry; the probabilities are
    recomputed. A missing output gradient (the last layer's carry has no
    consumer) arrives as None and costs nothing."""

    @staticmethod
    def forward(ctx, kqv, prev, query_mask):
        E = kqv.shape[-1] // 3
        k, q, v = kqv.split(E, dim=-1)
        out, carry = _forward(q, k, v, prev, query_mask)
        ctx.save_for_backward(kqv, carry)
        ctx.had_prev = prev is not None
        ctx.set_materialize_grads(False)
        return out, carry

    @staticmethod
    def backward(ctx, dctx, dcarry):
        kqv, carry = ctx.saved_tensors
        want_dprev = ctx.had_prev and ctx.needs_input_grad[1]
        dkqv, dprev = realformer_attention_backward(
            kqv, carry, dctx, dcarry, want_dprev)
        return dkqv, dprev, None


def _check_packed(kqv: torch.Tensor) -> None:
    tiling.refuse_dtensor("realformer_attention", kqv)
    if kqv.dim() != 4 or kqv.shape[-1] % 3:
        raise ValueError(
            f"realformer_attention: kqv {tuple(kqv.shape)} is not "
            "(B, T, H, 3E)"
        )


def realformer_attention_packed(
    kqv: torch.Tensor, prev: Optional[torch.Tensor],
    query_mask: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The core on the shared projection's output as it stands: kqv
    (B, T, H, 3E) in (k, q, v) order. Its gradient comes back as one tensor
    of that shape, so no concatenation follows the backward kernel."""
    _check_packed(kqv)
    needs_grad = kqv.requires_grad or (prev is not None and prev.requires_grad)
    if torch.is_grad_enabled() and needs_grad:
        return _PackedAttention.apply(kqv, prev, query_mask)
    k, q, v = kqv.split(kqv.shape[-1] // 3, dim=-1)
    return _forward(q, k, v, prev, query_mask)


def realformer_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    prev: Optional[torch.Tensor], query_mask: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v: (B, T, H, E), any strides. Returns (ctx (B, T, H, E), carry
    (B, H, T, T) fp32) with the semantics in the module docstring. Where a
    gradient is wanted, q, k and v are packed (one copy) and go through
    ``realformer_attention_packed``."""
    tiling.refuse_dtensor("realformer_attention", q, k, v, prev)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"realformer_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} are not all (B, T, H, E)"
        )
    needs_grad = any(t is not None and t.requires_grad
                     for t in (q, k, v, prev))
    if torch.is_grad_enabled() and needs_grad:
        return _PackedAttention.apply(torch.cat([k, q, v], dim=-1), prev,
                                      query_mask)
    return _forward(q, k, v, prev, query_mask)


realformer_attention.launches = 0
# of each direction's launches, those on the tensor cores: bf16 (mma) and
# fp32 (tf32x3, split TF32)
realformer_attention.mma_launches = 0
realformer_attention.tf32x3_launches = 0
realformer_attention.backward_launches = 0
realformer_attention.backward_mma_launches = 0
realformer_attention.backward_tf32x3_launches = 0


def ring_size() -> int:
    """The context group's size in ``core.mesh.CURRENT`` (1 without one):
    where it is above 1, ``impl='ring'`` runs the ring."""
    from mmvqa_tpu_torch.core.mesh import CONTEXT_AXIS
    from mmvqa_tpu_torch.parallel.comm import axis_size

    return axis_size(CONTEXT_AXIS)


def vanilla_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_mask: Optional[torch.Tensor], *,
    dropout: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """The BERT encoder's attention core, the JAX package's 'xla' path:
    q, k, v (B, H, T, D), key_mask (B, T) (1 real, 0 pad) or None ->
    (B, H, T, D) in q's dtype.

    ``scores = q kT / sqrt(D) - 10000 (1 - mask)`` over the KEYS, product,
    scale and mask in q's dtype (sqrt(D) rounded to it); the softmax in fp32,
    cast back; ``dropout`` (the layer's ``models.layers.Dropout``, which
    draws from the model's generator) on the probabilities; then ``p v``.
    The JAX package computes this outside any Pallas kernel, so these are
    plain tensor operations on every device. ``impl='ring'`` takes
    ``ops.ring_attention.ring_vanilla_attention`` over the context group of
    ``core.mesh.CURRENT`` where it has more than one rank: q, k, v and the
    mask are then this rank's token block, and the dropout masks come from a
    seed drawn from ``dropout``'s generator. With one context rank the ring
    is the whole sequence and this path computes it. 'xla' and 'pallas'
    name this path too, as in the JAX package."""
    if impl not in ("auto", "xla", "pallas", "ring"):
        raise ValueError(f"vanilla_attention: unknown impl {impl!r}")
    if impl == "ring" and ring_size() > 1:
        from mmvqa_tpu_torch.ops.ring_attention import ring_vanilla_attention

        active = dropout is not None and dropout.training and dropout.p > 0
        return ring_vanilla_attention(
            q, k, v, key_mask,
            dropout_rng=dropout.rng.generator(q.device) if active else None,
            dropout_rate=dropout.p if active else 0.0,
            deterministic=not active)
    scale = float(torch.tensor(float(q.shape[-1])).sqrt().to(q.dtype))
    scores = torch.matmul(q, k.to(q.dtype).transpose(-1, -2)) / scale
    if key_mask is not None:
        neg = NEG_BIG * (1.0 - key_mask.to(scores.dtype))
        scores = scores - neg[:, None, None, :]
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if dropout is not None:
        probs = dropout(probs)
    return torch.matmul(probs, v)
