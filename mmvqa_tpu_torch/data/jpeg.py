"""JPEG on the host without PIL: the decoder of ``native/jpeg_decode.cpp``
(baseline sequential and progressive Huffman-coded files, libjpeg's integer
arithmetic, so that a decode equals PIL's
``Image.open(path).convert("RGB")`` bit for bit) and a small baseline
encoder in numpy for the fixtures.

The decoder is called through ctypes, which releases the interpreter lock
for the call: the loader's threads decode in parallel. It raises
``ValueError`` naming the file for what it does not read (arithmetic-coded,
lossless, hierarchical, 12-bit, CMYK, and a progressive file whose low AC
coefficients stop short of their last bit, which libjpeg would smooth).

The encoder writes what PIL writes by default: JFIF, the standard tables of
the JPEG specification (Annex K) scaled to quality 75, YCbCr with 4:2:0
sampling. Its DCT and colour conversion are floating point, in elementwise
operations only, so that a seed gives the same bytes on any machine; only
the decoder has to match libjpeg.
"""

from __future__ import annotations

import ctypes

import numpy as np

from mmvqa_tpu_torch.native.loader import jpeg_library

_ERR_LEN = 256


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The image in ``data`` as uint8 RGB (H, W, 3)."""
    lib = jpeg_library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_probe(data, len(data), ctypes.byref(w), ctypes.byref(h),
                      ctypes.byref(c), err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.jpeg_decode_rgb(data, len(data), out.ctypes.data, w.value, h.value,
                           err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def read_rgb(path: str) -> np.ndarray:
    """Decode the JPEG file at ``path``: uint8 RGB (H, W, 3)."""
    with open(path, "rb") as f:
        data = f.read()
    return decode(data, path)


# ----------------------------------------------------------------- encoder --

# zigzag position -> natural (row-major) index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K.1, natural order
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    *([99] * 32)])

# Annex K.3: (code counts by length 1..16, symbols)
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling and jpeg_add_quant_table (baseline)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _codes(table):
    """(code, length) arrays indexed by symbol, the canonical Huffman code."""
    counts, symbols = table
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)[:, None]
    m = np.cos((2 * np.arange(8)[None, :] + 1) * k * np.pi / 16) * 0.5
    m[0] *= 2 ** -0.5
    return m


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _dct_1d(x: np.ndarray, axis: int) -> np.ndarray:
    """The 8-point DCT-II along ``axis`` (of size 8), as eight elementwise
    products summed in a fixed order: the same bits on any machine (a BLAS
    product may sum in another order)."""
    m = _dct_matrix()
    x = np.moveaxis(x, axis, -1)
    out = np.empty_like(x)
    for u in range(8):
        acc = x[..., 0] * m[u, 0]
        for k in range(1, 8):
            acc = acc + x[..., k] * m[u, k]
        out[..., u] = acc
    return np.moveaxis(out, -1, axis)


def _size(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (the JPEG size category)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _entropy_code(coefs: np.ndarray, comp: np.ndarray) -> bytes:
    """Huffman-code blocks (N, 64) (zigzag order, in scan order; ``comp``
    their component, 0 luma with the luma tables, else chroma) with the
    standard tables; DC differences are taken within each component.
    Returns the entropy-coded segment, bytes stuffed and the last byte
    padded with ones."""
    n = len(coefs)
    diff = np.empty(n, np.int64)
    for c in np.unique(comp):
        g = np.nonzero(comp == c)[0]
        diff[g] = np.diff(coefs[g, 0], prepend=0)
    comp = np.minimum(comp, 1)
    tables = [(_codes(DC_LUMA), _codes(AC_LUMA)),
              (_codes(DC_CHROMA), _codes(AC_CHROMA))]
    keys, vals, lens = [], [], []

    def emit(key, val, length):
        keep = length > 0
        keys.append(key[keep])
        vals.append(val[keep])
        lens.append(length[keep])

    # DC: the size's code, then the size's bits of the difference
    s = _size(diff)
    base = np.arange(n, dtype=np.int64) * 1024
    dcode = np.where(comp == 0, tables[0][0][0][s], tables[1][0][0][s])
    dlen = np.where(comp == 0, tables[0][0][1][s], tables[1][0][1][s])
    emit(base, dcode, dlen)
    emit(base + 1, np.where(diff < 0, diff + (1 << s) - 1, diff), s)

    # AC: zero runs of 16 (0xF0), then (run, size) and the bits of the value
    blk, k = np.nonzero(coefs[:, 1:])
    k = k + 1
    v = coefs[blk, k]
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    s = _size(v)
    c = comp[blk]

    def ac_code(sym, c):
        return (np.where(c == 0, tables[0][1][0][sym], tables[1][1][0][sym]),
                np.where(c == 0, tables[0][1][1][sym], tables[1][1][1][sym]))

    zrl = run // 16
    rep = np.repeat(np.arange(len(blk)), zrl)
    j = np.arange(len(rep)) - np.repeat(np.cumsum(zrl) - zrl, zrl)
    zc, zl = ac_code(np.full(len(rep), 0xF0), c[rep])
    emit(blk[rep] * 1024 + k[rep] * 8 + j, zc, zl)
    code, length = ac_code((run % 16) * 16 + s, c)
    emit(blk * 1024 + k * 8 + 4, code, length)
    emit(blk * 1024 + k * 8 + 5, np.where(v < 0, v + (1 << s) - 1, v), s)
    # end of block where the last coefficient is zero
    last = np.full(n, 0)
    last[blk] = k  # k rises within a block: the last write is the largest
    eob = np.nonzero(last < 63)[0]
    ec, el = ac_code(np.zeros(len(eob), np.int64), comp[eob])
    emit(eob * 1024 + 1000, ec, el)

    key = np.concatenate(keys)
    order = np.argsort(key, kind="stable")
    val = np.concatenate(vals)[order].astype(np.int64)
    length = np.concatenate(lens)[order].astype(np.int64)
    total = int(length.sum())
    tok = np.repeat(np.arange(len(length)), length)
    pos = np.arange(total) - np.repeat(np.cumsum(length) - length, length)
    bits = (val[tok] >> (length[tok] - 1 - pos)) & 1
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    out = np.packbits(bits)
    out = np.insert(out, np.nonzero(out == 0xFF)[0] + 1, 0)
    return out.tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def _dht(tc: int, th: int, table) -> bytes:
    counts, symbols = table
    return bytes([tc << 4 | th, *counts, *symbols])


def encode(rgb: np.ndarray, quality: int = 75) -> bytes:
    """Baseline JPEG of a uint8 RGB image (H, W, 3): JFIF, YCbCr 4:2:0, the
    standard tables at ``quality``."""
    rgb = np.asarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    # pad to whole MCUs (16 x 16) by repeating the last row and column
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    x = np.pad(rgb, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    x = x.astype(np.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128

    def sub(p):  # 2 x 2 means
        return (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
                + p[1::2, 1::2]) * 0.25

    qy, qc = quant_table(LUMA_Q, quality), quant_table(CHROMA_Q, quality)

    def coefficients(plane, q):
        blocks = _blocks(np.clip(np.rint(plane), 0, 255) - 128)
        d = _dct_1d(_dct_1d(blocks, 2), 3)
        return np.rint(d / q.reshape(8, 8)).astype(np.int64)

    cy = coefficients(y, qy)             # (hp/8, wp/8, 8, 8)
    ccb = coefficients(sub(cb), qc)      # (hp/16, wp/16, 8, 8)
    ccr = coefficients(sub(cr), qc)
    my, mx = hp // 16, wp // 16
    # scan order: per MCU the four luma blocks in raster order, Cb, Cr
    luma = cy.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4)
    mcus = np.concatenate([luma.reshape(my, mx, 4, 64),
                           ccb.reshape(my, mx, 1, 64),
                           ccr.reshape(my, mx, 1, 64)], axis=2)
    flat = mcus.reshape(-1, 64)[:, ZIGZAG]
    data = _entropy_code(flat, np.tile([0, 0, 0, 0, 1, 2], my * mx))

    out = bytearray(b"\xff\xd8")
    out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _segment(0xDB, bytes([0, *qy[ZIGZAG]]) + bytes([1, *qc[ZIGZAG]]))
    out += _segment(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                    + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    out += _segment(0xC4, _dht(0, 0, DC_LUMA) + _dht(1, 0, AC_LUMA)
                    + _dht(0, 1, DC_CHROMA) + _dht(1, 1, AC_CHROMA))
    out += _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    out += data
    out += b"\xff\xd9"
    return bytes(out)
