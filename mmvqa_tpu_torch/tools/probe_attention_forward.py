#!/usr/bin/env python3
"""Where the attention forward's tensor-core kernel (K2-fwd, bf16) spends
its time.

    python3 mmvqa_tpu_torch/tools/probe_attention_forward.py

Builds copies of ``csrc/realformer_attention.cu`` with one part of the
tensor-core kernel cut out or changed
(``probe_token_head_backward.build_copies``) and times each copy (CUDA
events, median of 10, each call queued behind a sleeping device with the L2
cache overwritten first) at one train layer (B=128, T=75, 8 heads of 96,
prev and padded queries) and at the eval path's T=28 (B=16 and B=128). The
cut copies compute wrong results: their times only say what the cut part
costs when the rest stays. The copies:

    base          the kernel as it is
    two_stages    a persistent grid of as many blocks as the card holds at
                  once, each walking the heads with two stage buffers, the
                  next head's copies in flight behind the current head's
                  work (the kernel's body, its shared memory and its grid
                  replaced)
    single_term   p as one bf16 term (no lo products)
    no_prev       prev not staged (s adds what the buffer holds)
    no_carry      the carry not stored
    no_products   no mma.sync at all (the ldmatrix loads stay)
    no_softmax    p is s itself: no exp, no row max or sum
    loads_only    no products and no softmax: staging, the carry and ctx
                  stores
"""

from __future__ import annotations

import ctypes
import os
import sys

H, E = 8, 96
CASES = ((128, 75), (16, 28), (128, 28))
ONE_HEAD = """\
  const Stage s = stage_at(smem_raw, 16 * NT, a.E);
  load<NT>(a, blockIdx.x, s, threadIdx.x);
  compute<NT>(a, blockIdx.x, s, threadIdx.x);
"""
TWO_STAGES = """\
  const int tid = threadIdx.x;
  const size_t bytes = stage_bytes(a.T, 16 * NT, a.E);
  int bh = blockIdx.x;
  load<NT>(a, bh, stage_at(smem_raw, 16 * NT, a.E), tid);
  for (int it = 0; bh < a.heads; bh += gridDim.x, ++it) {
    const int next = bh + gridDim.x;
    if (next < a.heads) {
      load<NT>(a, next, stage_at(smem_raw + ((it + 1) & 1) * bytes, 16 * NT,
                                 a.E), tid);
    } else {  // empty groups keep the count of those behind this head
      commit();
      commit();
      commit();
    }
    compute<NT>(a, bh, stage_at(smem_raw + (it & 1) * bytes, 16 * NT, a.E),
                tid);
    __syncthreads();  // the stage is free for the head after next
  }
"""
GRID = """\
  return launch_with_smem(realformer_attn_fwd_mma_kernel<NT>, a.heads,
                          32 * warps_for(NT),
                          (int)stage_bytes(a.T, 16 * NT, a.E), a, stream);
"""
PERSISTENT_GRID = """\
  const int smem = (int)(2 * stage_bytes(a.T, 16 * NT, a.E));
  int dev, sms, blocks;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = occupancy_of(realformer_attn_fwd_mma_kernel<NT>,
                          32 * warps_for(NT), smem, &blocks)) != cudaSuccess)
    return err;
  return launch_with_smem(realformer_attn_fwd_mma_kernel<NT>,
                          sms * blocks < a.heads ? sms * blocks : a.heads,
                          32 * warps_for(NT), smem, a, stream);
"""
CUTS = {
    "base": [],
    # compute() waits with the next head's three groups behind its own
    "two_stages": [
        ("inline size_t stage_bytes(", "__host__ __device__ inline size_t "
         "stage_bytes("),
        ("wait_groups<2>();", "wait_groups<5>();"),
        ("wait_groups<1>();", "wait_groups<4>();"),
        ("wait_groups<0>();", "wait_groups<3>();"),
        (ONE_HEAD, TWO_STAGES),
        (GRID, PERSISTENT_GRID),
    ],
    "single_term": [("        mma(acc[0][1], lo[j2], bf[j2][0], bf[j2][1]);\n"
                     "        mma(acc[1][1], lo[j2], bf[j2][2], bf[j2][3]);\n",
                     "")],
    "no_prev": [("  if (a.prev) {\n    const long long head",
                 "  if (false) {\n    const long long head")],
    "no_carry": [("  store_flat(s.flat, T * T, a.carry + head, tid, NTH);\n",
                  "")],
    "no_products": [
        ("        mma(p[2 * j2], af, bf[j2][0], bf[j2][1]);\n"
         "        mma(p[2 * j2 + 1], af, bf[j2][2], bf[j2][3]);\n", ""),
        ("        mma(acc[0][0], hi[j2], bf[j2][0], bf[j2][1]);\n"
         "        mma(acc[1][0], hi[j2], bf[j2][2], bf[j2][3]);\n"
         "        mma(acc[0][1], lo[j2], bf[j2][0], bf[j2][1]);\n"
         "        mma(acc[1][1], lo[j2], bf[j2][2], bf[j2][3]);\n", ""),
    ],
    "no_softmax": [("    softmax_rows<NT>(p);\n", "")],
}
CUTS["loads_only"] = CUTS["no_products"] + CUTS["no_softmax"]


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.abspath(os.path.join(here, "..", "..")))
    import torch

    from mmvqa_tpu_torch.native import loader
    from mmvqa_tpu_torch.ops import attention
    from mmvqa_tpu_torch.tools.probe_token_head_backward import (
        build_copies,
        in_namespace,
        card_line,
    )
    from mmvqa_tpu_torch.tools.time_conv_bn import time_ms

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = card_line()
    print(card)

    def bind(lib):
        lib.realformer_attn_fwd.restype = ctypes.c_int
        lib.realformer_attn_fwd.argtypes = (
            loader.library().realformer_attn_fwd.argtypes)

    libs, _ = build_copies("realformer_attention.cu",
                           in_namespace("realformer_attention.cu", "tc", CUTS),
                           bind)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    ptr = attention._ptr
    for B, T in CASES:
        kqv = torch.randn(B, T, H, 3 * E, device=dev,
                          generator=gen).bfloat16()
        k, q, v = kqv.split(E, dim=-1)
        prev = torch.randn(B, H, T, T, device=dev, generator=gen)
        lengths = torch.randint(T // 2, T + 1, (B,), device=dev,
                                generator=gen)
        mask = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()
        carry = torch.empty_like(prev)
        ctx = torch.empty(B, T, H, E, device=dev, dtype=kqv.dtype)
        strides = (ctypes.c_longlong * 16)(
            *q.stride(), *k.stride(), *v.stride(), *ctx.stride())
        line = []
        for name, lib in libs.items():
            def call():
                loader.check(lib.realformer_attn_fwd(
                    ptr(q), ptr(k), ptr(v), ptr(prev), ptr(mask), ptr(carry),
                    ptr(ctx), strides, loader.DTYPE_CODES[kqv.dtype], B, H,
                    T, E, attention.PATH_CODES["mma"], loader.stream_ptr()),
                    name)

            ms = time_ms(torch, call, flush)
            line.append(f"{name} {ms:.4f}")
        print(f"B={B} T={T} ms: " + "; ".join(line), flush=True)
    print(card)


if __name__ == "__main__":
    main()
