"""Build-on-first-use ctypes loader for the hand-written CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` (one compiler process per source, all
started together) and links them into one shared library with a plain C
interface, for Hopper (``sm_90a``), into ``mmvqa_tpu_torch/_build/<hash>/``,
where the hash covers the sources and the flags; the library is loaded with
ctypes. Unlike ``mmvqa_tpu/native/loader.py`` there is no fallback: a
missing compiler, a failed build or a failed load raises, because the
kernels' callers have no other path on the card.

The C entry points return ``cudaGetLastError()``; ``check`` raises on any
code other than 0.

The host libraries (``native/*.cpp``: the WordPiece fast path and the JPEG
decoder) are built the same way with the host's C++ compiler, one library a
source, into ``_build/host-<hash>/``, and raise the same way if they do not
build (``wordpiece_library``, ``jpeg_library``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(PKG_DIR, "_build")
LIB_NAME = "libmmvqa_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()

_p = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*")))


def source_hash() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels of mmvqa_tpu_torch cannot be built"
        )
    return found


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=900)


def _require(proc: subprocess.CompletedProcess) -> None:
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(proc.args)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )


def build() -> str:
    """Compile the kernels if this source hash has no library yet; return
    the library's path. Every source is compiled by its own nvcc process,
    all at once; concurrent builds each work in a temporary directory and
    rename the library into place."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    out = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(out):
        return out
    nvcc = find_nvcc()
    os.makedirs(out_dir, exist_ok=True)
    cu = [p for p in sources() if p.endswith(".cu")]
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, os.path.basename(p)[:-3] + ".o") for p in cu]
        with ThreadPoolExecutor(max_workers=len(cu)) as pool:
            procs = list(pool.map(
                lambda po: _run([nvcc, *NVCC_FLAGS, "-c", "-o", po[1], po[0]]),
                zip(cu, objs)))
        for proc in procs:
            _require(proc)
        lib = os.path.join(tmp, LIB_NAME)
        _require(_run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]))
        os.replace(lib, out)
    return out


BWD_ARGTYPES = [
    _p, _i, _ll, _ll, _ll,      # x, dtype, strides (b, p, k)
    _p, _p,                     # w, g
    _p, _ll, _ll, _ll,          # dx, strides (b, p, k)
    _p, _p, _p,                 # partials, dw, barrier counters
    _i, _i, _i, _i, _i,         # B, P, K, C, act
    _i, _i, _i, _i, _i, _i,     # ops/token_head.py::BwdPlan
    _p,                         # stream
]
FWD_ARGTYPES = [
    _p, _ll, _ll, _ll,          # x, strides (b, p, k)
    _p, _p, _p, _p,             # w, partials, out, counters
    _i, _i, _i, _i, _i,         # B, P, K, C, act
    _i, _i, _i, _i, _i, _i,     # ops/token_head.py::FwdPlan
    _p,                         # stream
]
FWD_OCCUPANCY_ARGTYPES = [
    _i, _i, _i,                 # act, mode, smem
    ctypes.POINTER(_i),         # blocks an SM holds
]
TMA_ARGTYPES = [
    _p, _p, _ll,                # x, w, w's column stride
    _p, _p, _p, _p,             # y, partial, stats, tile counters
    _i, _i, _i,                 # N, K, C
    _i, _i, _i, _i,             # ops/conv_bn.py::TmaPlan
    _p,                         # stream
]
BN_SUMS_ARGTYPES = [
    _p, _p, _i,                 # x, dy, dtype
    _p, _p,                     # mean, inv_std
    _p, _p, _p,                 # partial, out, tile counters
    _ll, _i,                    # rows, C
    _i, _i, _i, _i, _i, _i,     # ops/tiling.py::ChannelPlan
    _p,                         # stream
]
BWD_OCCUPANCY_ARGTYPES = [
    _i, _i, _i, _i, _i, _i,     # dtype, act, tile rows, mode, K, smem
    ctypes.POINTER(_i),         # blocks an SM holds
]


def _bind(lib: ctypes.CDLL) -> None:
    lib.mmvqa_error_string.restype = ctypes.c_char_p
    lib.mmvqa_error_string.argtypes = [_i]
    lib.token_head_fwd_mma.restype = _i
    lib.token_head_fwd_mma.argtypes = FWD_ARGTYPES
    lib.token_head_fwd_occupancy.restype = _i
    lib.token_head_fwd_occupancy.argtypes = FWD_OCCUPANCY_ARGTYPES
    lib.token_head_fwd_tf32x3.restype = _i
    lib.token_head_fwd_tf32x3.argtypes = [
        _p, _ll, _ll, _ll,          # x, strides (b, p, k)
        _p, _p, _p, _p, _p,         # w, partials, out, counters, K slices' s
        _i, _i, _i, _i, _i,         # B, P, K, C, act
        _i, _i, _i, _i, _i, _i, _i,  # ops/token_head.py::Fp32FwdPlan
        _p,                         # stream
    ]
    lib.token_head_fwd_tf32x3_occupancy.restype = _i
    lib.token_head_fwd_tf32x3_occupancy.argtypes = [
        _i, _i, _i, _i,             # act, tile rows, mode, smem
        ctypes.POINTER(_i),         # blocks an SM holds
    ]
    lib.token_head_bwd.restype = _i
    lib.token_head_bwd.argtypes = BWD_ARGTYPES
    lib.token_head_bwd_occupancy.restype = _i
    lib.token_head_bwd_occupancy.argtypes = BWD_OCCUPANCY_ARGTYPES
    lib.realformer_attn_fwd.restype = _i
    lib.realformer_attn_fwd.argtypes = [
        _p, _p, _p, _p, _p,         # q, k, v, prev, mask
        _p, _p,                     # scores, ctx
        ctypes.POINTER(_ll),        # 16 strides
        _i, _i, _i, _i, _i, _i,     # dtype, B, H, T, E, path
        _p,                         # stream
    ]
    lib.realformer_attn_fwd_mma_occupancy.restype = _i
    lib.realformer_attn_fwd_mma_occupancy.argtypes = [
        _i, _i, _i, ctypes.POINTER(_i)]  # dtype, T, E, blocks an SM holds
    lib.realformer_attn_bwd.restype = _i
    lib.realformer_attn_bwd.argtypes = [
        _p, _p, _p, _p, _p, _p,     # q, k, v, carry, dctx, dcarry
        _p, _p, _p, _p,             # dq, dk, dv, dprev
        _p, _p,                     # ds scratch, row statistics
        ctypes.POINTER(_ll),        # 28 strides
        _i, _i, _i, _i, _i, _i,     # dtype, B, H, T, E, path
        _p,                         # stream
    ]
    lib.realformer_attn_bwd_mma_occupancy.restype = _i
    lib.realformer_attn_bwd_mma_occupancy.argtypes = [
        _i, _i, _i, ctypes.POINTER(_i)]  # dtype, T, E, blocks an SM holds
    # ops/tiling.py::DepthwisePlan: copy, vec, ct, tw, s, p, steps, ncol,
    # nstrip, groups, threads, smem
    dw_plan = [_i] * 12
    lib.depthwise3x3_fwd.restype = _i
    lib.depthwise3x3_fwd.argtypes = [
        _p, _i,                     # x, dtype
        _p, _i, _ll, _ll,           # w (9, C), dtype, strides (tap, channel)
        _p,                         # y
        _i, _i, _i, _i,             # B, H, W, C
        *dw_plan,
        _p,                         # stream
    ]
    lib.depthwise3x3_bwd.restype = _i
    lib.depthwise3x3_bwd.argtypes = [
        _p, _i, _p,                 # x, dtype, dy
        _p, _i, _ll, _ll,           # w (9, C), dtype, strides (tap, channel)
        _p, _p, _p, _p,             # dx, partials, dw, tile counters
        _i, _i, _i, _i,             # B, H, W, C
        *dw_plan,
        _p,                         # stream
    ]
    for fn in (lib.depthwise3x3_fwd_occupancy, lib.depthwise3x3_bwd_occupancy):
        fn.restype = _i
        fn.argtypes = [_i, _i, _i, _i,    # dtype, copy, threads, smem
                       ctypes.POINTER(_i)]  # blocks an SM holds
    lib.conv1x1_stats.restype = _i
    lib.conv1x1_stats.argtypes = [
        _p, _i,                     # x, dtype
        _p, _ll, _ll,               # w, strides (k, c)
        _p, _p, _p,                 # y, partial, stats
        _i, _i, _i, _i,             # N, K, C, nrb
        _p,                         # stream
    ]
    lib.conv1x1_stats_tma.restype = _i
    lib.conv1x1_stats_tma.argtypes = TMA_ARGTYPES
    lib.conv1x1_stats_tf32x3.restype = _i
    lib.conv1x1_stats_tf32x3.argtypes = [
        _p, _p, _ll, _ll,           # x, w, w's strides (k, c)
        _p, _p, _p, _p, _p,         # y, partial, stats, counters, K slices
        _i, _i, _i,                 # N, K, C
        _i, _i, _i, _i, _i,         # ops/conv_bn.py::Tf32Plan
        _p,                         # stream
    ]
    lib.bn_backward_sums.restype = _i
    lib.bn_backward_sums.argtypes = BN_SUMS_ARGTYPES
    lib.bn_backward_sums_occupancy.restype = _i
    lib.bn_backward_sums_occupancy.argtypes = [
        _i, _i, _i,                 # dtype, vec, threads
        ctypes.POINTER(_i),         # blocks an SM holds
    ]


HOST_DIR = os.path.join(PKG_DIR, "native")
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
_HOST_LIBS: dict = {}


def find_cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError(
            "no C++ compiler ($CXX, g++ or c++): the host libraries of "
            "mmvqa_tpu_torch cannot be built")
    return cxx


def build_host(name: str) -> str:
    """Compile ``native/<name>.cpp`` into ``lib<name>.so`` if this source has
    no library yet; return the library's path. Concurrent builds each work
    in a temporary directory and rename the library into place."""
    src = os.path.join(HOST_DIR, f"{name}.cpp")
    h = hashlib.sha1(" ".join(HOST_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    out_dir = os.path.join(BUILD_ROOT, f"host-{h.hexdigest()[:16]}")
    out = os.path.join(out_dir, f"lib{name}.so")
    if os.path.exists(out):
        return out
    cxx = find_cxx()
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        lib = os.path.join(tmp, os.path.basename(out))
        proc = subprocess.run([cxx, *HOST_FLAGS, src, "-o", lib],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cxx} failed ({proc.returncode}): {' '.join(proc.args)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(lib, out)
    return out


def _bind_wordpiece(lib: ctypes.CDLL) -> None:
    lib.wp_load.restype = _p
    lib.wp_load.argtypes = [ctypes.c_char_p]
    lib.wp_free.restype = None
    lib.wp_free.argtypes = [_p]
    lib.wp_tokenize.restype = ctypes.c_int32
    lib.wp_tokenize.argtypes = [
        _p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]


def _bind_jpeg(lib: ctypes.CDLL) -> None:
    size_t, ip = ctypes.c_size_t, ctypes.POINTER(_i)
    lib.jpeg_probe.restype = _i
    lib.jpeg_probe.argtypes = [ctypes.c_char_p, size_t, ip, ip, ip,
                               ctypes.c_char_p, _i]
    lib.jpeg_decode_rgb.restype = _i
    lib.jpeg_decode_rgb.argtypes = [ctypes.c_char_p, size_t, _p, _i, _i,
                                    ctypes.c_char_p, _i]


def host_library(name: str, bind) -> ctypes.CDLL:
    """The loaded host library ``native/<name>.cpp``, built on first use.
    Raises on failure."""
    with _LOCK:
        if name not in _HOST_LIBS:
            lib = ctypes.CDLL(build_host(name))
            bind(lib)
            _HOST_LIBS[name] = lib
        return _HOST_LIBS[name]


def wordpiece_library() -> ctypes.CDLL:
    return host_library("wordpiece", _bind_wordpiece)


def jpeg_library() -> ctypes.CDLL:
    return host_library("jpeg_decode", _bind_jpeg)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use. Raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            _bind(lib)
            _LIB = lib
        return _LIB


def check(code: int, what: str) -> None:
    if code != 0:
        msg = library().mmvqa_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on the current CUDA device in a dtype
    the kernels take."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, not on a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensor on {t.device}, kernel runs on {dev}")
        if t.dtype not in DTYPE_CODES:
            raise ValueError(f"{name}: dtype {t.dtype} not supported")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
