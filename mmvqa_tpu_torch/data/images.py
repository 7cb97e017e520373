"""Image preparation (counterpart of mmvqa_tpu/data/images.py).

Host side (numpy, in the loader's threads):
- ``load_image`` (:42-59): decode (``data/jpeg.py``, PIL's bits), resize the
  shorter side to ``size`` as PIL's BILINEAR resize computes it on uint8,
  centre-crop to ``size`` x ``size``;
- ``random_rotate_host`` (:267-280): PIL's ``rotate(angle, NEAREST)`` about
  the centre, filled with 0, the angle from ``rng.uniform(-deg, deg)``;
- ``RamImageCache`` and ``DecodedImageCache`` (:62-237): the decode half
  cached in RAM or in a uint8 memmap on disk.

Device side: uint8 NHWC -> augmented, normalized float32 NHWC,
``(u8 / 255 - 0.5) / 0.5`` (:243-385).

Augmentation is RandomResizedCrop (a bilinear crop + resize done as two
interpolation-matrix products) and a colour jitter in the fixed order
brightness, contrast, saturation, hue. The random draws are split from the
arithmetic: ``sample_draws`` makes them from a ``torch.Generator`` and
``apply_augment`` applies them, so that a test can hand the same draws to
this package and to the JAX one (whose random bits cannot be reproduced).
"""

from __future__ import annotations

import atexit
import contextlib
import fcntl
import json
import math
import os
import threading
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mmvqa_tpu_torch.data.jpeg import read_rgb

# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2  # PIL's Resample.c, 8 bits a channel


def _resample_coeffs(in_size: int, out_size: int):
    """PIL's precompute_coeffs + normalize_coeffs_8bpc for its bilinear
    filter over the whole axis: (xmin (out,), taps (out, ksize) int64 fixed
    point, zero past each output's own count). Double precision in PIL's
    order of operations, the taps summed one after another."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = 0.0 + (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(
        np.int64) - xmin
    x = np.arange(ksize)[None, :]
    d = np.abs((x + xmin[:, None] - center[:, None] + 0.5) * ss)
    w = np.where((x < xmax[:, None]) & (d < 1.0), 1.0 - d, 0.0)
    ww = np.zeros(out_size)
    for t in range(ksize):
        ww = ww + w[:, t]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    taps = np.trunc(0.5 + w * (1 << _PRECISION_BITS)).astype(np.int64)
    return xmin, taps


def _resample_rows(img: np.ndarray, out_size: int) -> np.ndarray:
    """One of PIL's two passes (ImagingResampleVertical_8bpc; the
    horizontal one on the transposed image) over the rows of a uint8
    (H, W, C) image. The sums fit int32: the taps are non-negative and add
    up to about 2**22."""
    xmin, taps = _resample_coeffs(img.shape[0], out_size)
    last = img.shape[0] - 1
    flat = np.ascontiguousarray(img).reshape(img.shape[0], -1)
    acc = np.full((out_size, flat.shape[1]), 1 << (_PRECISION_BITS - 1),
                  np.int32)
    for t in range(taps.shape[1]):
        acc += flat[np.minimum(xmin + t, last)] * taps[:, t:t + 1].astype(
            np.int32)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return out.reshape((out_size,) + img.shape[1:])


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.resize((width, height), Image.BILINEAR)`` of a uint8 (H, W, 3)
    image, bit for bit: PIL's fixed-point coefficients (22 fraction bits),
    the support widened by the downscale factor, the horizontal pass first,
    rounding and a clip after each pass; a pass whose size does not change
    is skipped, as PIL skips it."""
    if img.shape[1] != width:
        img = _resample_rows(img.transpose(1, 0, 2), width).transpose(1, 0, 2)
    if img.shape[0] != height:
        img = _resample_rows(img, height)
    return img


def load_image(path: str, size: int = 224) -> np.ndarray:
    """Decode -> resize shorter side -> center crop: uint8 (size, size, 3).

    Matches Resize(size) + CenterCrop(size) (roco_train.py:110-114), and the
    JAX package's PIL path bit for bit."""
    img = read_rgb(path)
    h, w = img.shape[:2]
    if w <= h:
        nw, nh = size, max(size, int(round(h * size / w)))
    else:
        nh, nw = size, max(size, int(round(w * size / h)))
    img = resize_bilinear(img, nw, nh)
    left = (nw - size) // 2
    top = (nh - size) // 2
    return np.ascontiguousarray(img[top:top + size, left:left + size])


def rotate_nearest(img: np.ndarray, angle: float) -> np.ndarray:
    """``Image.fromarray(img).rotate(angle, resample=NEAREST)``: about the
    centre, same size, 0 outside the source. PIL's fast paths for 0, 180
    and (square) 90 and 270 degrees; otherwise its matrix (entries rounded
    to 15 digits) and its 16.16 fixed-point walk (affine_fixed in
    Geometry.c)."""
    h, w = img.shape[:2]
    angle = angle % 360.0
    if angle == 0:
        return img.copy()
    if angle == 180:
        return img[::-1, ::-1].copy()
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else -1))
    cx, cy = w / 2, h / 2
    a = -math.radians(angle)
    m = [round(math.cos(a), 15), round(math.sin(a), 15), 0.0,
         round(-math.sin(a), 15), round(math.cos(a), 15), 0.0]
    m[2], m[5] = (m[0] * -cx + m[1] * -cy + m[2],
                  m[3] * -cx + m[4] * -cy + m[5])
    m[2] += cx
    m[5] += cy

    def fix(v: float) -> int:
        return math.floor(v * 65536.0 + 0.5)

    a0, a1, a3, a4 = fix(m[0]), fix(m[1]), fix(m[3]), fix(m[4])
    a2 = fix(m[2] + m[1] * 0.5 + m[0] * 0.5)
    a5 = fix(m[5] + m[4] * 0.5 + m[3] * 0.5)
    y = np.arange(h, dtype=np.int64)[:, None]
    x = np.arange(w, dtype=np.int64)[None, :]
    xin = (a2 + y * a1 + x * a0) >> 16
    yin = (a5 + y * a4 + x * a3) >> 16
    inside = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out = np.zeros_like(img)
    out[inside] = img[yin[inside], xin[inside]]
    return out


def random_rotate_host(img_u8: np.ndarray, deg: float, rng) -> np.ndarray:
    """Host-side RandomRotation (PIL, NEAREST like torchvision's default);
    the angle is ``rng.uniform(-deg, deg)``."""
    if deg <= 0:
        return img_u8
    return rotate_nearest(img_u8, rng.uniform(-deg, deg))


class RamImageCache:
    """In-RAM decoded-image cache (decode only: random transforms stay
    per-epoch). ``backing``: an optional second level (a
    ``DecodedImageCache``) that misses fall through to."""

    def __init__(self, backing=None) -> None:
        self._store: dict = {}
        self._lock = threading.Lock()
        self._backing = backing

    def load(self, path: str, size: int) -> np.ndarray:
        key = (path, size)
        img = self._store.get(key)
        if img is None:
            img = (self._backing.load(path, size) if self._backing
                   is not None else load_image(path, size))
            with self._lock:
                self._store[key] = img
        return img


class DecodedImageCache:
    """Persistent disk-backed decoded-image cache: decoded images append to
    one uint8 memmap (``decoded_<size>.bin``, one fixed-size slot an image)
    with a JSON index keyed by (absolute path -> slot, mtime).

    Thread-safe within a process (the BatchLoader decodes from a thread
    pool) and safe under concurrent processes sharing one cache dir:
    appends happen under an ``flock`` on the bin file with the slot number
    derived from the locked file size, and index flushes merge with the
    on-disk index instead of overwriting it. Reads take no lock: the map and
    its slot count are one tuple, replaced as a whole, so a reader always
    indexes a map at least as long as the count it checked (the JAX
    package's copy swaps the two separately and can index past the map).
    A source image whose mtime changes is a miss and is appended again."""

    INDEX_FLUSH_EVERY = 512

    def __init__(self, cache_dir: str, size: int) -> None:
        self.size = int(size)
        os.makedirs(cache_dir, exist_ok=True)
        self._bin_path = os.path.join(cache_dir, f"decoded_{size}.bin")
        self._idx_path = os.path.join(cache_dir, f"decoded_{size}.idx.json")
        self._slot_bytes = self.size * self.size * 3
        self._lock = threading.Lock()
        self._index: dict = {}
        self._view: Tuple[Optional[np.memmap], int] = (None, 0)
        self._puts_since_flush = 0

        self._writer = open(self._bin_path, "ab")
        with self._flocked():
            # align the file to whole slots (a crash may have left a partial
            # record); size-derived, so another process's complete slots are
            # never cut off
            n_bytes = os.path.getsize(self._bin_path)
            n_slots = n_bytes // self._slot_bytes
            if n_bytes != n_slots * self._slot_bytes:
                self._writer.truncate(n_slots * self._slot_bytes)
            self._index = self._read_disk_index(n_slots)
        atexit.register(self.flush)

    def _read_disk_index(self, n_slots: int) -> dict:
        if not os.path.exists(self._idx_path):
            return {}
        try:
            with open(self._idx_path) as f:
                idx = json.load(f)
            if idx.get("size") != self.size:
                return {}
            return {k: tuple(v) for k, v in idx["entries"].items()
                    if v[0] < n_slots}  # drop entries past a truncated bin
        except (json.JSONDecodeError, KeyError, OSError):
            return {}  # corrupt index: rebuild from scratch

    @contextlib.contextmanager
    def _flocked(self):
        """Exclusive cross-process lock on the bin file (within the process
        ``self._lock`` excludes: flock is per open file, not per thread)."""
        fcntl.flock(self._writer.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(self._writer.fileno(), fcntl.LOCK_UN)

    def __len__(self) -> int:
        return len(self._index)

    def _read_slot(self, slot: int) -> np.ndarray:
        mm, n = self._view
        if mm is None or slot >= n:
            n = os.path.getsize(self._bin_path) // self._slot_bytes
            mm = np.memmap(self._bin_path, dtype=np.uint8, mode="r",
                           shape=(n, self.size, self.size, 3))
            self._view = (mm, n)
        return np.array(mm[slot])  # copy out of the map

    def load(self, path: str, size: int) -> np.ndarray:
        if size != self.size:
            return load_image(path, size)
        key = os.path.abspath(path)
        entry = self._index.get(key)
        if entry is not None:
            slot, mtime = entry
            try:
                if os.path.getmtime(path) == mtime:
                    return self._read_slot(slot)
            except OSError:
                pass
        img = load_image(path, size)
        with self._lock, self._flocked():
            # the slot comes from the locked file size: concurrent processes
            # interleave appends without clobbering each other's slots
            slot = os.path.getsize(self._bin_path) // self._slot_bytes
            self._writer.write(img.tobytes())
            self._writer.flush()  # readers remap by the file's size
            self._index[key] = (slot, os.path.getmtime(path))
            self._puts_since_flush += 1
            if self._puts_since_flush >= self.INDEX_FLUSH_EVERY:
                self._flush_locked()
        return img

    def _flush_locked(self) -> None:
        """Write the index merged with the one on disk, so that processes
        flushing their own entries keep each other's. The caller holds
        ``self._lock`` and the flock."""
        self._writer.flush()
        n_slots = os.path.getsize(self._bin_path) // self._slot_bytes
        merged = dict(self._read_disk_index(n_slots))
        merged.update(self._index)
        self._index = merged
        tmp = self._idx_path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"size": self.size,
                       "entries": {k: list(v) for k, v in merged.items()}}, f)
        os.replace(tmp, self._idx_path)
        self._puts_since_flush = 0

    def flush(self) -> None:
        with self._lock:
            if self._puts_since_flush and not self._writer.closed:
                with self._flocked():
                    self._flush_locked()


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AugmentSpec:
    """Random-augmentation strengths: pretrain crop 0.95-1.05, rot 5, jitter
    0.05; fine-tune crop 0.75-1.25, rot 10, jitter 0.4."""

    crop_scale: Tuple[float, float] = (0.95, 1.05)
    crop_ratio: Tuple[float, float] = (0.95, 1.05)
    rotation_deg: float = 5.0
    brightness: float = 0.05
    contrast: float = 0.05
    saturation: float = 0.05
    hue: float = 0.05


PRETRAIN_AUG = AugmentSpec()
FINETUNE_AUG = AugmentSpec(
    crop_scale=(0.75, 1.25), crop_ratio=(0.75, 1.25), rotation_deg=10.0,
    brightness=0.4, contrast=0.4, saturation=0.4, hue=0.4,
)


class AugmentDraws(NamedTuple):
    """One row per image. ``crop``: (B, 4) the box ``y0, x0, h, w`` in source
    pixels; ``jitter``: (B, 4) the brightness, contrast and saturation
    factors and the hue shift (a fraction of a turn)."""

    crop: torch.Tensor
    jitter: torch.Tensor


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=gen.device)


def sample_draws(n: int, size: int, generator: torch.Generator,
                 spec: AugmentSpec = PRETRAIN_AUG) -> AugmentDraws:
    """Draw crop boxes and jitter factors for ``n`` images of ``size`` px,
    on the generator's device (``_sample_crop`` and the draws of
    ``_color_jitter`` in the JAX package)."""
    g = generator
    scale = _uniform(g, n, *spec.crop_scale)
    ratio = torch.exp(_uniform(g, n, math.log(spec.crop_ratio[0]),
                               math.log(spec.crop_ratio[1])))
    area = size * size * scale
    w = torch.clamp(torch.sqrt(area * ratio), max=size)
    h = torch.clamp(torch.sqrt(area / ratio), max=size)
    x0 = torch.rand(n, generator=g, device=g.device) * (size - w)
    y0 = torch.rand(n, generator=g, device=g.device) * (size - h)
    jitter = torch.stack([
        _uniform(g, n, 1 - spec.brightness, 1 + spec.brightness),
        _uniform(g, n, 1 - spec.contrast, 1 + spec.contrast),
        _uniform(g, n, 1 - spec.saturation, 1 + spec.saturation),
        _uniform(g, n, -spec.hue, spec.hue),
    ], dim=1)
    return AugmentDraws(torch.stack([y0, x0, h, w], dim=1), jitter)


def _interp_matrix(start: torch.Tensor, extent: torch.Tensor,
                   size: int) -> torch.Tensor:
    """(B, out, in) bilinear sampling matrices of a 1-D crop + resize: output
    u samples source coordinate ``start + (u + 0.5) * extent / size - 0.5``
    with hat-function weights; rows renormalised to sum to 1 at the edges."""
    u = torch.arange(size, dtype=torch.float32, device=start.device)
    src = start[:, None] + (u[None] + 0.5) * (extent[:, None] / size) - 0.5
    d = (src[:, :, None] - u[None, None, :]).abs()
    w = torch.clamp(1.0 - d, min=0.0)
    return w / torch.clamp(w.sum(dim=2, keepdim=True), min=1e-6)


def _gray(x: torch.Tensor) -> torch.Tensor:
    return (0.2989 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]


def _per_image(f: torch.Tensor) -> torch.Tensor:
    return f[:, None, None, None]


def apply_augment(x: torch.Tensor, draws: AugmentDraws,
                  spec: AugmentSpec = PRETRAIN_AUG) -> torch.Tensor:
    """x: (B, S, S, 3) float32 in [0, 1]. Crop + resize, then the jitter
    stages whose strength in ``spec`` is above 0."""
    size = x.shape[1]
    crop = draws.crop.to(x.device, torch.float32)
    jit = draws.jitter.to(x.device, torch.float32)
    wy = _interp_matrix(crop[:, 0], crop[:, 2], size)
    wx = _interp_matrix(crop[:, 1], crop[:, 3], size)
    x = torch.einsum("boy,byxc->boxc", wy, x)
    x = torch.einsum("box,byxc->byoc", wx, x)
    if spec.brightness > 0:
        x = torch.clamp(x * _per_image(jit[:, 0]), 0.0, 1.0)
    if spec.contrast > 0:
        mean = _gray(x).mean(dim=(1, 2, 3), keepdim=True)
        x = torch.clamp((x - mean) * _per_image(jit[:, 1]) + mean, 0.0, 1.0)
    if spec.saturation > 0:
        g = _gray(x)
        x = torch.clamp((x - g) * _per_image(jit[:, 2]) + g, 0.0, 1.0)
    if spec.hue > 0:
        # hue as a rotation of the chroma in YIQ space
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        y = _gray(x)[..., 0]
        i = 0.596 * r - 0.274 * g - 0.322 * b
        q = 0.211 * r - 0.523 * g + 0.312 * b
        ang = jit[:, 3, None, None] * (2.0 * math.pi)
        ci, cq = torch.cos(ang), torch.sin(ang)
        i2 = ci * i - cq * q
        q2 = cq * i + ci * q
        x = torch.clamp(torch.stack([
            y + 0.956 * i2 + 0.621 * q2,
            y - 0.272 * i2 - 0.647 * q2,
            y - 1.106 * i2 + 1.703 * q2,
        ], dim=-1), 0.0, 1.0)
    return x


def process_batch(images_u8: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  spec: AugmentSpec = PRETRAIN_AUG, augment: bool = False,
                  draws: Optional[AugmentDraws] = None) -> torch.Tensor:
    """(B, S, S, 3) uint8 -> normalized float32 (B, S, S, 3) in [-1, 1],
    augmented first where ``augment`` is set: with ``draws`` if they are
    given, else with draws from ``generator`` (which must lie on the images'
    device)."""
    x = images_u8.to(torch.float32) / 255.0
    if augment:
        if draws is None:
            if generator is None:
                raise ValueError("process_batch: augment needs a generator "
                                 "or draws")
            draws = sample_draws(x.shape[0], x.shape[1], generator, spec)
        x = apply_augment(x, draws, spec)
    return (x - 0.5) / 0.5
