"""The port's image files and resize (``tpgan_tpu_torch/data/imageio.py``)
against PIL, which the JAX package reads, writes and resizes with:

* ``read_png`` decodes PIL-written RGB, RGBA, grey and grey+alpha PNGs
  (PIL's adaptive filtering puts filters 0/1/2/4 on their rows) and a
  file whose rows carry each of the five filters by construction (PIL
  never picked Average on these images), pixel for pixel;
* ``write_png`` output reads back through PIL unchanged;
* ``resize_lanczos_u8`` equals ``Image.resize(size, Image.LANCZOS)`` to
  the bit at the pyramid shapes of the data path, a non-square source and
  an upsample;
* malformed files raise.
"""

import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from tpgan_tpu_torch.data.imageio import (
    PNG_SIGNATURE,
    read_png,
    read_rgb,
    resize_lanczos_u8,
    write_png,
)

torch.set_num_threads(1)


def _images():
    rng = np.random.RandomState(0)
    ramp = np.add.outer(np.arange(96), np.arange(80))
    return {
        "noise": rng.randint(0, 256, (128, 128, 3), np.uint8),
        "ramp_noise": np.clip(ramp[:, :, None] + rng.randint(0, 8, (96, 80, 3)), 0, 255)
        .astype(np.uint8),
        "walk": np.clip(np.cumsum(rng.randint(-3, 4, (64, 72, 3)), axis=1) + 128, 0, 255)
        .astype(np.uint8),
    }


def _row_filters(path):
    data = open(path, "rb").read()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, _, color, *_ = header
    c = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * c + 1)
    return set(raw[:, 0].tolist())


def test_read_png_decodes_pil_rgb_files_with_adaptive_filters(tmp_path):
    seen = set()
    for name, img in _images().items():
        path = str(tmp_path / f"{name}.png")
        Image.fromarray(img).save(path)
        seen |= _row_filters(path)
        got = read_png(path)
        assert got.dtype == np.uint8 and np.array_equal(got, img), name
    assert {1, 2, 4} <= seen, seen  # Sub, Up and Paeth rows among them


@pytest.mark.parametrize("mode,shape", [("L", (37, 53)), ("LA", (29, 31, 2)),
                                        ("RGBA", (41, 23, 4))])
def test_read_png_grey_and_alpha(tmp_path, mode, shape):
    img = np.random.RandomState(len(shape)).randint(0, 256, shape, np.uint8)
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(img, mode).save(path)
    got = read_png(path)
    assert np.array_equal(got.reshape(img.shape), img)
    with Image.open(path) as im:
        assert np.array_equal(read_rgb(path), np.asarray(im.convert("RGB")))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode_with_filters(img, kinds):
    """A PNG whose row y is filtered with kinds[y], per the PNG spec."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        pred = [0, left, up, (left + up) // 2, _paeth(left, up, upleft)][kinds[y]]
        out.append(np.concatenate([[kinds[y]], (x - pred) % 256]).astype(np.uint8))
    chunk = lambda k, d: (struct.pack(">I", len(d)) + k + d
                          + struct.pack(">I", zlib.crc32(k + d) & 0xFFFFFFFF))
    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
            + chunk(b"IEND", b""))


def test_read_png_every_row_filter(tmp_path):
    img = _images()["walk"]
    kinds = [y % 5 for y in range(img.shape[0])]
    path = tmp_path / "filters.png"
    path.write_bytes(_encode_with_filters(img, kinds))
    assert _row_filters(str(path)) == {0, 1, 2, 3, 4}
    with Image.open(path) as im:
        assert np.array_equal(np.asarray(im), img)  # the file is valid
    assert np.array_equal(read_png(str(path)), img)


def test_write_png_reads_back_through_pil(tmp_path):
    img = _images()["ramp_noise"]
    path = str(tmp_path / "out.png")
    write_png(path, img)
    with Image.open(path) as im:
        assert im.mode == "RGB" and np.array_equal(np.asarray(im), img)
    assert _row_filters(path) == {0}
    assert np.array_equal(read_png(path), img)


def test_malformed_pngs_raise(tmp_path):
    img = _images()["walk"]
    good = tmp_path / "good.png"
    write_png(str(good), img)
    data = bytearray(good.read_bytes())
    bad_crc = tmp_path / "crc.png"
    data[45] ^= 0xFF  # inside the IDAT data
    bad_crc.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(str(bad_crc))
    not_png = tmp_path / "x.png"
    not_png.write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(not_png))
    palette = tmp_path / "p.png"
    Image.fromarray(img).convert("P").save(palette)
    with pytest.raises(ValueError, match="colour type 3"):
        read_png(str(palette))
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "grey.png"), img[:, :, 0])


# (source H, W) -> (out W, H): the pyramid 144 -> 128 -> 64 -> 32, a
# non-square source, an upsample, and a non-square output
LANCZOS_CASES = [((144, 144), (128, 128)), ((128, 128), (64, 64)), ((64, 64), (32, 32)),
                 ((180, 250), (128, 128)), ((100, 60), (128, 128)),
                 ((128, 128), (70, 100))]


@pytest.mark.parametrize("src,size", LANCZOS_CASES, ids=lambda v: "x".join(map(str, v)))
def test_resize_lanczos_u8_equals_pil(src, size):
    rng = np.random.RandomState(src[0] + size[0])
    img = rng.randint(0, 256, src + (3,), np.uint8)
    want = np.asarray(Image.fromarray(img).resize(size, Image.LANCZOS))
    got = resize_lanczos_u8(img, size)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_resize_lanczos_u8_grey_and_bad_input():
    img = np.random.RandomState(5).randint(0, 256, (90, 70), np.uint8)
    want = np.asarray(Image.fromarray(img).resize((32, 48), Image.LANCZOS))
    assert np.array_equal(resize_lanczos_u8(img, (32, 48)), want)
    assert np.array_equal(resize_lanczos_u8(img, (70, 90)), img)  # no pass runs
    with pytest.raises(ValueError):
        resize_lanczos_u8(img.astype(np.float32), (32, 32))
    with pytest.raises(ValueError):
        resize_lanczos_u8(np.zeros((8, 8, 4), np.uint8), (4, 4))
