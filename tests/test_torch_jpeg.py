"""The port's image half of the host data layer against PIL and the JAX
package: the JPEG decoder (``native/jpeg_decode.cpp`` through
``data/jpeg.py``), baseline and progressive, bit for bit against
``Image.open(p).convert("RGB")``, the
numpy JPEG encoder read back by PIL, ``load_image`` and
``random_rotate_host`` bit for bit against the JAX functions (which call
PIL), and the decoded-image caches under threads.
"""

import io
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

from mmvqa_tpu.data import images as jax_images
from mmvqa_tpu.data.fixtures import make_roco_fixture as jax_make_roco

from mmvqa_tpu_torch.data import images, jpeg
from mmvqa_tpu_torch.data.fixtures import make_roco_fixture

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

# (height, width): not multiples of 8 or 16, one sample wide or high, 2 wide
SHAPES = [(1, 1), (3, 17), (37, 53), (101, 67), (64, 64), (131, 250),
          (16, 2), (9, 40)]
SUBSAMPLING = {"4:2:0": 2, "4:2:2": 1, "4:4:4": 0}


def _image(rng, h, w, channels=3):
    """A gradient with noise: smooth areas and sharp ones."""
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 255 // max(w - 1, 1) + y * 128 // max(h - 1, 1))[..., None]
    noise = rng.integers(-60, 60, (h, w, channels))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _pil_bytes(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def test_decoder_reads_the_jax_fixture_as_pil(tmp_path):
    root = jax_make_roco(str(tmp_path), n_train=4, n_val=2, image_size=48)
    n = 0
    for split in ("train", "validation"):
        d = os.path.join(root, split, "radiology", "images")
        for name in sorted(os.listdir(d)):
            p = os.path.join(d, name)
            np.testing.assert_array_equal(
                jpeg.read_rgb(p), np.asarray(Image.open(p).convert("RGB")),
                err_msg=p)
            n += 1
    assert n == 6


@pytest.mark.parametrize("restart", [{}, {"restart_marker_blocks": 3},
                                     {"restart_marker_rows": 1}],
                         ids=["no-restart", "restart-3-blocks", "restart-1-row"])
@pytest.mark.parametrize("sampling", sorted(SUBSAMPLING) + ["gray"])
def test_decoder_equals_pil(rng, sampling, restart):
    """Bit for bit at every shape: libjpeg's ISLOW IDCT, its fancy
    upsampling (edges included) and its YCbCr tables."""
    for h, w in SHAPES:
        if sampling == "gray":
            arr = _image(rng, h, w, 1)[..., 0]
            data = _pil_bytes(arr, **restart)
        else:
            arr = _image(rng, h, w)
            data = _pil_bytes(arr, subsampling=SUBSAMPLING[sampling],
                              **restart)
        if restart:
            assert b"\xff\xdd" in data
        np.testing.assert_array_equal(jpeg.decode(data), _pil_decode(data),
                                      err_msg=f"{sampling} {h}x{w}")


@pytest.mark.parametrize("kw", [dict(quality=30), dict(quality=95),
                                dict(optimize=True),
                                dict(quality=100, subsampling=0)],
                         ids=["q30", "q95", "optimized-tables", "q100-444"])
def test_decoder_equals_pil_at_other_tables(rng, kw):
    for h, w in SHAPES[2:6]:
        data = _pil_bytes(_image(rng, h, w), **kw)
        np.testing.assert_array_equal(jpeg.decode(data), _pil_decode(data))


def test_decoder_refuses_what_it_does_not_read_naming_the_file(rng, tmp_path):
    arr = _image(rng, 20, 30)
    cases = {
        "cmyk": (dict(), np.concatenate([arr, arr[..., :1]], -1), "CMYK"),
    }
    for name, (kw, a, what) in cases.items():
        p = str(tmp_path / f"{name}.jpg")
        mode = "CMYK" if a.shape[-1] == 4 else "RGB"
        Image.fromarray(a, mode).save(p, format="JPEG", **kw)
        with pytest.raises(ValueError, match=f"{name}.jpg: .*{what}"):
            jpeg.read_rgb(p)
    # PIL writes none of these: its files with the frame header's marker
    # or sample precision changed
    for name, kw, old, new, what in (
            ("arithmetic", dict(progressive=True), b"\xff\xc2", b"\xff\xca",
             "arithmetic-coded"),
            ("arithmetic-seq", dict(), b"\xff\xc0", b"\xff\xc9",
             "arithmetic-coded"),
            ("lossless", dict(), b"\xff\xc0", b"\xff\xc3", "lossless"),
            ("hierarchical", dict(progressive=True), b"\xff\xc2",
             b"\xff\xc6", "hierarchical"),
            ("12-bit", dict(), b"\xff\xc0\x00\x11\x08",
             b"\xff\xc0\x00\x11\x0c", "12-bit")):
        data = _pil_bytes(arr, **kw)
        assert data.count(old) == 1
        p = str(tmp_path / f"{name}.jpg")
        with open(p, "wb") as f:
            f.write(data.replace(old, new))
        with pytest.raises(ValueError, match=f"{name}.jpg: .*{what}"):
            jpeg.read_rgb(p)
    png = str(tmp_path / "x.png")
    Image.fromarray(arr).save(png)
    with pytest.raises(ValueError, match="x.png: not a JPEG"):
        images.load_image(png, 16)
    data = _pil_bytes(_image(rng, 120, 160))
    for cut in (len(data) // 2, 300, 1):
        with pytest.raises(ValueError, match="<bytes>: "):
            jpeg.decode(data[:cut])
    with pytest.raises(ValueError, match="end of data in a scan"):
        jpeg.decode(data[:len(data) // 2])


@pytest.mark.parametrize("restart", [{}, {"restart_marker_blocks": 3},
                                     {"restart_marker_rows": 1}],
                         ids=["no-restart", "restart-3-blocks", "restart-1-row"])
@pytest.mark.parametrize("sampling", sorted(SUBSAMPLING) + ["gray"])
def test_progressive_decoder_equals_pil(rng, sampling, restart):
    """Progressive files (PIL's scan script: DC first and refinement, AC
    bands first and refinement with end-of-band runs, optimised tables
    before the scans) bit for bit at every shape, with and without restart
    intervals."""
    for h, w in SHAPES:
        if sampling == "gray":
            data = _pil_bytes(_image(rng, h, w, 1)[..., 0], progressive=True,
                              **restart)
        else:
            data = _pil_bytes(_image(rng, h, w), progressive=True,
                              subsampling=SUBSAMPLING[sampling], **restart)
        assert b"\xff\xc2" in data and data.count(b"\xff\xda") > 1
        if restart:
            assert b"\xff\xdd" in data
        np.testing.assert_array_equal(jpeg.decode(data), _pil_decode(data),
                                      err_msg=f"{sampling} {h}x{w}")


# (PIL's progressive writer runs out of buffer at quality 100 on noise)
@pytest.mark.parametrize("kw", [dict(quality=30), dict(quality=95),
                                dict(quality=92, subsampling=0)],
                         ids=["q30", "q95", "q92-444"])
def test_progressive_decoder_equals_pil_at_other_tables(rng, kw):
    for h, w in SHAPES[2:6]:
        data = _pil_bytes(_image(rng, h, w), progressive=True, **kw)
        np.testing.assert_array_equal(jpeg.decode(data), _pil_decode(data))


def test_progressive_file_without_its_last_scan_is_refused(rng, tmp_path):
    """Cut before one of its last two scans (refinements of AC bands to
    their last bit), a progressive file's low AC coefficients are
    incomplete: libjpeg would smooth its blocks (jdcoefct.c), and the
    decoder refuses it, naming the file."""
    data = _pil_bytes(_image(rng, 40, 56), progressive=True)
    starts = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    for k, name in ((-1, "cut1"), (-2, "cut2")):
        p = str(tmp_path / f"{name}.jpg")
        with open(p, "wb") as f:
            f.write(data[:starts[k]] + b"\xff\xd9")
        with pytest.raises(ValueError, match=f"{name}.jpg: .*block smoothing"):
            jpeg.read_rgb(p)


def test_committed_progressive_file_gives_the_smokes_digest():
    """``tests/data/progressive.jpg`` (PIL, 4:2:0, restart every 5 MCUs,
    61x45): the digest chip_smoke.py checks on the card's machine, which
    has no PIL; here the same pixels are PIL's, and ``load_image`` of it is
    the JAX ``load_image``."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "progressive.jpg")
    with open(path, "rb") as f:
        data = f.read()
    assert b"\xff\xc2" in data and b"\xff\xdd" in data
    assert chip_smoke.progressive_digest(path) == chip_smoke.PROGRESSIVE_DIGEST
    np.testing.assert_array_equal(jpeg.read_rgb(path), _pil_decode(data))
    for size in (224, 32):
        np.testing.assert_array_equal(images.load_image(path, size),
                                      jax_images.load_image(path, size))


def test_load_image_of_progressive_files_equals_jax(rng, tmp_path):
    for h, w in ((300, 200), (416, 512), (100, 60)):
        p = str(tmp_path / f"{h}x{w}.jpg")
        Image.fromarray(_image(rng, h, w)).save(p, progressive=True)
        np.testing.assert_array_equal(images.load_image(p, 224),
                                      jax_images.load_image(p, 224))


def test_port_written_jpegs_open_in_pil_and_decode_as_pil(rng):
    for h, w in SHAPES + [(416, 512)]:
        arr = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        data = jpeg.encode(arr)
        im = Image.open(io.BytesIO(data))
        assert (im.format, im.mode, im.size) == ("JPEG", "RGB", (w, h))
        pil = _pil_decode(data)
        np.testing.assert_array_equal(jpeg.decode(data), pil)
        # a lossy copy of the pixels, not noise of its own: at quality 75
        # random pixels come back within about 48 levels on average
        assert np.abs(pil.astype(int) - arr).mean() < 60
    smooth = _image(rng, 64, 96)
    back = _pil_decode(jpeg.encode(smooth)).astype(int)
    assert np.abs(back - smooth).mean() < 40


def test_decode_digest_is_the_smokes(tmp_path):
    """The pinned digest chip_smoke.py checks on the card's machine; here the
    same files also decode as PIL decodes them."""
    root = make_roco_fixture(str(tmp_path), 3, 0, chip_smoke.SEED,
                             chip_smoke.CLI_IMAGE_SIZE)
    assert chip_smoke.decode_digest(root) == chip_smoke.DECODE_DIGEST
    p = os.path.join(root, "train/radiology/images/ROCO_train_0001.jpg")
    np.testing.assert_array_equal(jpeg.read_rgb(p),
                                  np.asarray(Image.open(p).convert("RGB")))
    assert Image.open(p).size == chip_smoke.CLI_IMAGE_SIZE


# (height, width) of the source: upscales, downscales, both ways, exact
LOAD_SHAPES = [(64, 64), (100, 60), (60, 100), (300, 200), (200, 300),
               (230, 500), (224, 224), (500, 223), (416, 512), (225, 224),
               (1000, 230)]


def test_load_image_equals_jax(rng, tmp_path):
    """Decode, PIL's BILINEAR resize of the shorter side (the support
    widened when it shrinks), centre crop: bit for bit at 224 px."""
    for h, w in LOAD_SHAPES:
        p = str(tmp_path / f"{h}x{w}.jpg")
        Image.fromarray(_image(rng, h, w)).save(p)
        for size in (224, 64):
            got = images.load_image(p, size)
            want = jax_images.load_image(p, size)
            assert got.shape == want.shape == (size, size, 3)
            assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
            np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} {size}")


def test_resize_bilinear_equals_pil(rng):
    for (h, w), (nw, nh) in [((37, 53), (224, 161)), ((5, 3), (224, 373)),
                             ((300, 301), (224, 223)),
                             ((1024, 700), (224, 327))]:
        arr = _image(rng, h, w)
        want = np.asarray(Image.fromarray(arr).resize((nw, nh),
                                                      Image.BILINEAR))
        np.testing.assert_array_equal(images.resize_bilinear(arr, nw, nh),
                                      want)


@pytest.mark.parametrize("deg", [5.0, 10.0])
def test_random_rotate_host_equals_jax(rng, deg):
    """The same rng gives the same angle, and PIL's nearest-neighbour walk
    gives the same pixels, border included."""
    for i in range(24):
        size = (224, 224) if i % 3 else (37, 53)
        img = rng.integers(0, 255, size + (3,), dtype=np.uint8)
        a, b = np.random.default_rng(i), np.random.default_rng(i)
        got = images.random_rotate_host(img, deg, a)
        want = jax_images.random_rotate_host(img, deg, b)
        np.testing.assert_array_equal(got, want)
        assert a.random() == b.random()  # one draw each
    assert images.random_rotate_host(img, 0.0, None) is img


def test_rotate_nearest_equals_pil_at_its_fast_paths_and_large_angles(rng):
    for shape in ((32, 32), (20, 31)):
        img = rng.integers(0, 255, shape + (3,), dtype=np.uint8)
        for angle in (0.0, 90.0, 180.0, 270.0, -90.0, 360.0, 45.0, 123.4,
                      -179.9, 1e-9):
            want = np.asarray(Image.fromarray(img).rotate(
                angle, resample=Image.NEAREST))
            np.testing.assert_array_equal(images.rotate_nearest(img, angle),
                                          want, err_msg=f"{shape} {angle}")


@pytest.fixture()
def tree(tmp_path, rng):
    paths = []
    for i in range(12):
        p = str(tmp_path / f"img_{i}.jpg")
        Image.fromarray(_image(rng, 40 + i, 44)).save(p)
        paths.append(p)
    return paths, str(tmp_path / "cache")


def test_ram_cache_over_the_disk_cache(tree):
    paths, cdir = tree
    disk = images.DecodedImageCache(cdir, 32)
    ram = images.RamImageCache(backing=disk)
    for p in paths[:3]:
        a = ram.load(p, 32)
        np.testing.assert_array_equal(a, images.load_image(p, 32))
        assert ram.load(p, 32) is a
    assert len(disk) == 3
    disk.flush()
    again = images.DecodedImageCache(cdir, 32)
    assert len(again) == 3
    np.testing.assert_array_equal(again.load(paths[1], 32),
                                  images.load_image(paths[1], 32))
    assert again.load(paths[0], 16).shape == (16, 16, 3) and len(again) == 3


def test_decoded_cache_mtime_and_corrupt_index(tree):
    paths, cdir = tree
    c = images.DecodedImageCache(cdir, 32)
    c.load(paths[0], 32)
    c.flush()
    os.utime(paths[0], (1, 1))
    assert len(c) == 1
    np.testing.assert_array_equal(c.load(paths[0], 32),
                                  images.load_image(paths[0], 32))
    c.flush()
    with open(c._idx_path, "w") as f:
        f.write("{ not json")
    assert len(images.DecodedImageCache(cdir, 32)) == 0


def test_decoded_cache_threaded_writers_and_readers(tree):
    """20 rounds of eight threads (more than the cores a worker has) that
    read cached slots while others append, with a short switch interval:
    every load is the decoder's image and no read indexes past its map
    (the JAX copy's race, where the map and its count change apart)."""
    paths, cdir = tree
    want = {p: images.load_image(p, 32) for p in paths}
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for r in range(20):
            c = images.DecodedImageCache(os.path.join(cdir, str(r)), 32)
            c.INDEX_FLUSH_EVERY = 3
            order = list(np.random.default_rng(r).permutation(paths * 4))
            barrier = threading.Barrier(8)

            def work(k):
                barrier.wait(timeout=30)
                for p in order[k::8]:
                    out = c.load(p, 32)
                    if not np.array_equal(out, want[p]):
                        errors.append((r, p))

            with ThreadPoolExecutor(8) as pool:
                for f in [pool.submit(work, k) for k in range(8)]:
                    f.result(timeout=60)
            assert len(c) == len(paths)
            c.flush()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:5]
