#!/usr/bin/env python3
"""Where the token head's backward kernel (K1-bwd, bf16) spends its time.

    python3 mmvqa_tpu_torch/tools/probe_token_head_backward.py

Builds copies of ``csrc/token_head_bwd.cu`` with one part of the bf16
kernel cut out, each into its own library under ``mmvqa_tpu_torch/_build/``
(all ``nvcc`` processes started together), and times each copy (CUDA events,
median of 10, each call queued behind a sleeping device) at three flagship
taps at B=128: stage 0 (K=24) and stage 1 (K=48), where W is resident in
shared memory, and stage 6 (K=512), where W streams through the ring; with
SERF's bf16 polynomial and with ReLU. The cut copies compute wrong
gradients: their times only say what the cut part costs when the rest
stays. ``build_copies`` and ``time_ms`` serve the forward's and conv1x1 +
statistics' probes too. The copies:

    base         the kernel as it is
    no_act       s's epilogue without act'(s): gact = s g / P
    no_g         s's epilogue without g / P: gact = act'(s) / P
    no_epilogue  s's epilogue cut whole: nothing is parked (the s products
                 stay; the compiler drops act', g / P, rounding and stores)
    no_s         no s products (the epilogue takes act' of zeros)
    no_dx        no dx products (dx written from zeros)
    no_dw        no dW products (the partial's loads and stores stay)
    no_tail      no grid barrier and no sum of the partials
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

TAPS = (("stage0", 112, 24), ("stage1", 56, 48), ("stage6", 7, 512))
B, HIDDEN = 128, 768

# only the kernels the three taps launch: bf16, 64-row tiles (W resident
# or streamed), SERF's polynomial and ReLU
TRIM = [
    ("""    if (dtype == kFloat32) {
      if (mode == f32::kTiles)
        return tp == f32::kTile ? f(f32::token_head_bwd_tiles_kernel<A>)
                                : cudaErrorInvalidValue;
      // the row tile the plan gives each K in 32s
      // (ops/token_head.py::FP32_ROWS_TP)
      switch (tp * 1000 + kp) {
        case 64032: return f(f32::token_head_bwd_rows_kernel<64, 32, A>);
        case 32064: return f(f32::token_head_bwd_rows_kernel<32, 64, A>);
        case 32096: return f(f32::token_head_bwd_rows_kernel<32, 96, A>);
      }
      return cudaErrorInvalidValue;
    }""", "    if (dtype == kFloat32) return cudaErrorInvalidValue;"),
    ("      case 64: return f(token_head_bwd_mma_kernel<32, A, false>);\n"
     "      case 65: return f(token_head_bwd_mma_kernel<32, A, true>);\n"
     "      case 32: return f(token_head_bwd_mma_kernel<16, A, false>);\n", ""),
    ("    case kSerf: return pick(std::integral_constant<int, kSerf>());\n",
     ""),
]
CUTS = {
    "base": [],
    "no_act": [
        ("act_grad<ACT>(acc[nt][2 * h]) * g0", "acc[nt][2 * h] * g0"),
        ("act_grad<ACT>(acc[nt][2 * h + 1]) * g1", "acc[nt][2 * h + 1] * g1"),
    ],
    "no_g": [
        ("        float g0 = 0.0f, g1 = 0.0f;\n"
         "        if (gcached) {\n"
         "          if (in && c < a.C) g0 = gsm[c];\n"
         "          if (in && c + 1 < a.C) g1 = gsm[c + 1];\n"
         "        } else {\n"
         "          if (in && c < a.C) g0 = __ldg(ggl + c) * inv_p;\n"
         "          if (in && c + 1 < a.C) g1 = __ldg(ggl + c + 1) * inv_p;\n"
         "        }\n",
         "        const float g0 = inv_p, g1 = inv_p;\n"),
    ],
    "no_epilogue": [
        ("        *reinterpret_cast<__nv_bfloat162*>(gs + r * ldg + c) =\n"
         "            __floats2bfloat162_rn(v0, v1);\n", ""),
    ],
    "no_s": [
        ("                   const __nv_bfloat16* ws, int wld, int wk, int wc,"
         " int k0) {\n    if (wm >= L::SWM) return;",
         "                   const __nv_bfloat16* ws, int wld, int wk, int wc,"
         " int k0) {\n    return;"),
    ],
    "no_dx": [
        ("    if (dwm >= L::DWM || kd * kChunkK + dwn * 8 >= a.K) return;",
         "    return;"),
    ],
    "no_dw": [
        ("      if (cw < a.C) {\n#pragma unroll\n        for (int ps = 0;",
         "      if (false) {\n#pragma unroll\n        for (int ps = 0;"),
    ],
    "no_tail": [
        ("  grid_barrier(a.bar, gridDim.x);\n"
         "  sum_partials(a.part, a.dw, (long long)a.K * a.C, gridDim.x);\n"
         "}\n\n// ------------------------------------------------------ fp32",
         "}\n\n// ------------------------------------------------------ fp32"),
    ],
}


def cut(src: str, name: str, edits) -> str:
    """``src`` with each (old, new) of ``edits`` applied; each ``old`` must
    occur exactly once."""
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    return src


def in_namespace(source: str, namespace: str, variants):
    """``variants`` ({name: edits}) with each variant's edits applied to the
    block of ``namespace`` in ``csrc/<source>`` alone, as one edit of the
    file: lines that the source also holds in another namespace (the
    attention's bf16 kernels, tc, beside their fp32 ones, tc32) stay
    unambiguous."""
    from mmvqa_tpu_torch.native import loader

    with open(os.path.join(loader.CSRC_DIR, source)) as f:
        src = f.read()
    start = src.index(f"namespace {namespace} {{")
    end = src.index(f"}}  // namespace {namespace}\n", start)
    block = src[start:end]
    return {name: [(block, cut(block, name, edits))] if edits else []
            for name, edits in variants.items()}


def build_copies(source: str, variants, bind):
    """Copies of ``csrc/<source>`` edited by each variant's (old, new) pairs
    ({name: edits}), built into libraries of their own beside a copy of the
    headers (all nvcc processes started together) under
    ``mmvqa_tpu_torch/_build/``; returns ({name: library, bound by
    ``bind``}, the work directory)."""
    from mmvqa_tpu_torch.native import loader

    with open(os.path.join(loader.CSRC_DIR, source)) as f:
        src = f.read()
    os.makedirs(loader.BUILD_ROOT, exist_ok=True)
    work = tempfile.mkdtemp(prefix="probe_", dir=loader.BUILD_ROOT)
    for header in os.listdir(loader.CSRC_DIR):
        if header.endswith(".cuh"):
            shutil.copy(os.path.join(loader.CSRC_DIR, header), work)
    nvcc = loader.find_nvcc()

    def build(name):
        cu = os.path.join(work, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(cut(src, name, variants[name]))
        so = os.path.join(work, f"{name}.so")
        proc = subprocess.run([nvcc, *loader.NVCC_FLAGS, "-shared", "-o", so,
                               cu], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
        lib = ctypes.CDLL(so)
        bind(lib)
        return name, lib

    with ThreadPoolExecutor(len(variants)) as ex:
        return dict(ex.map(build, variants)), work


def time_ms(torch, fn, reps=10):
    """Median of ``reps`` CUDA-event times of ``fn`` after three warm-ups,
    each call queued behind a sleeping device, so that the time is the
    card's and not the host's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(200_000)  # about 0.1 ms: longer than a launch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.abspath(os.path.join(here, "..", "..")))
    import torch

    from mmvqa_tpu_torch.native import loader
    from mmvqa_tpu_torch.ops import token_head as th

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = card_line()
    print(card)

    def bind(lib):
        lib.token_head_bwd.restype = ctypes.c_int
        lib.token_head_bwd.argtypes = loader.BWD_ARGTYPES
        lib.token_head_bwd_occupancy.restype = ctypes.c_int
        lib.token_head_bwd_occupancy.argtypes = loader.BWD_OCCUPANCY_ARGTYPES

    libs, work = build_copies(
        "token_head_bwd.cu", {name: TRIM + edits for name, edits in CUTS.items()},
        bind)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bar = torch.zeros(th.BARRIER_WORDS, dtype=torch.int32, device=dev)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    for tap, side, K in TAPS:
        P = side * side
        x = torch.randn(B, P, K, device=dev, generator=gen).bfloat16()
        w = (torch.randn(K, HIDDEN, device=dev, generator=gen)
             * K ** -0.5).bfloat16()
        g = torch.randn(B, HIDDEN, device=dev, generator=gen)
        dx = torch.empty_like(x)
        dw = torch.empty(K, HIDDEN, device=dev)
        tp, mode, smem = th.backward_tile(K, HIDDEN, 2)
        for act in ("serf_fast", "relu"):
            line = []
            for name, lib in libs.items():
                n = ctypes.c_int(0)
                loader.check(lib.token_head_bwd_occupancy(
                    1, th.ACTS[act], tp, mode, K, smem, ctypes.byref(n)),
                    f"{name} occupancy")
                plan = th.backward_plan(B, P, K, HIDDEN, 2, sms, n.value)
                part = torch.empty(plan.nblocks, K, HIDDEN, device=dev)

                def call():
                    loader.check(lib.token_head_bwd(
                        ptr(x), 1, *x.stride(), ptr(w), ptr(g), ptr(dx),
                        *dx.stride(), ptr(part), ptr(dw), ptr(bar), B, P, K,
                        HIDDEN, th.ACTS[act], *plan, loader.stream_ptr()),
                        name)

                line.append(f"{name} {time_ms(torch, call):.4f}")
                del part
            print(f"{tap} B={B} P={P} K={K} {act} ms: " + "; ".join(line),
                  flush=True)
    shutil.rmtree(work, ignore_errors=True)
    print(card)


if __name__ == "__main__":
    main()
