"""The port's JPEG codec and bilinear resize (``tpgan_tpu_torch/data/
imageio.py``, the Huffman stage in ``data/native.py`` and the host
library) against PIL (libjpeg-turbo), which the JAX package reads and
writes its CelebA corpus with:

* ``read_jpeg`` decodes PIL-written files to PIL's own pixels, to the
  bit: qualities 50/75/92/100, 4:2:0, 4:4:4 and grey, noise and smooth
  images, sizes that are not multiples of 16 (and 1x1, 2x3, whose 4:2:0
  chroma is too narrow for fancy upsampling), and restart markers;
* ``write_jpeg``'s files decode, through PIL, to the pixels of PIL's
  own file from the same array (RGB 4:2:0 and grey), and hold the same
  quantized coefficients;
* the host library's Huffman decode and encode equal their plain
  Python ``*_reference``, bytes and coefficients;
* progressive, arithmetic-coded, 12-bit and truncated files raise;
* ``resize_bilinear_u8`` equals ``Image.resize(size, Image.BILINEAR)``
  up and down.
"""

import io

import numpy as np
import pytest
from PIL import Image

from tpgan_tpu_torch.data import imageio, native
from tpgan_tpu_torch.data.imageio import (
    read_jpeg,
    read_rgb,
    resize_bilinear_u8,
    write_jpeg,
)

QUALITIES = (50, 75, 92, 100)
SIZES = ((1, 1), (2, 3), (7, 5), (17, 23), (37, 53), (64, 64), (100, 61))


def _image(h, w, kind, seed=0):
    rng = np.random.RandomState(seed + h * 31 + w)
    if kind == "noise":
        return rng.randint(0, 256, (h, w, 3), np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 127 // max(w + h - 2, 1)], -1)
    return np.clip(base + rng.randint(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)


def _pil_bytes(arr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _write(tmp_path, name, data: bytes) -> str:
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("layout", ["4:2:0", "4:4:4", "grey"])
def test_read_jpeg_equals_pil(tmp_path, quality, layout):
    for (h, w) in SIZES:
        for kind in ("noise", "smooth"):
            arr = _image(h, w, kind)
            if layout == "grey":
                data = _pil_bytes(arr[:, :, 0], quality=quality)
            else:
                data = _pil_bytes(arr, quality=quality, subsampling=2 if layout == "4:2:0" else 0)
            path = _write(tmp_path, "x.jpg", data)
            want = np.asarray(Image.open(path))
            got = read_jpeg(path)
            if layout == "grey":
                assert got.shape == (h, w, 1)
                np.testing.assert_array_equal(got[:, :, 0], want, err_msg=f"{h}x{w} {kind}")
                np.testing.assert_array_equal(read_rgb(path),
                                              np.asarray(Image.open(path).convert("RGB")))
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} {kind}")


def test_read_jpeg_with_restart_markers(tmp_path):
    arr = _image(90, 130, "smooth")
    for blocks in (1, 5):
        path = _write(tmp_path, "r.jpg", _pil_bytes(arr, quality=92, restart_marker_blocks=blocks))
        assert b"\xff\xdd" in open(path, "rb").read()
        want = np.asarray(Image.open(path))
        np.testing.assert_array_equal(read_jpeg(path), want)
        np.testing.assert_array_equal(
            read_jpeg(path, entropy=native.jpeg_huff_decode_reference), want)


@pytest.mark.parametrize("quality", QUALITIES)
def test_write_jpeg_decodes_as_pils_own_file(tmp_path, quality):
    for (h, w) in SIZES + ((161, 320),):
        for kind in ("noise", "smooth"):
            arr = _image(h, w, kind, seed=1)
            for src in (arr, arr[:, :, 1].copy()):
                ours = str(tmp_path / "ours.jpg")
                write_jpeg(ours, src, quality)
                pil = _write(tmp_path, "pil.jpg", _pil_bytes(src, quality=quality))
                np.testing.assert_array_equal(np.asarray(Image.open(ours)),
                                              np.asarray(Image.open(pil)),
                                              err_msg=f"{src.shape} {kind}")
                # the same tables and quantized coefficients
                assert Image.open(ours).quantization == Image.open(pil).quantization


def test_write_jpeg_coefficients_equal_libjpegs(tmp_path):
    arr = _image(37, 53, "noise", seed=2)
    tables, comps, coefs, block_comp = imageio.jpeg_coefficients(arr, 92)
    path = _write(tmp_path, "pil.jpg", _pil_bytes(arr, quality=92))
    got = []

    def capture(data_, start, scan_tables, n_mcus, restart):
        out = native.jpeg_huff_decode(data_, start, scan_tables, n_mcus, restart)
        got.append(out[0])
        return out

    read_jpeg(path, entropy=capture)
    assert len(got) == 1 and got[0].shape == coefs.shape == (12, 6, 64)
    np.testing.assert_array_equal(got[0], coefs)
    assert list(block_comp) == [0, 0, 0, 0, 1, 2] and [c[:4] for c in comps] == [
        (1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    assert sorted(tables) == [0, 1]


def test_host_entropy_coding_equals_the_reference(tmp_path):
    for (h, w), q in (((161, 320), 92), ((37, 53), 100), ((64, 64), 50)):
        arr = _image(h, w, "noise", seed=3)
        tables, comps, coefs, block_comp = imageio.jpeg_coefficients(arr, q)
        huff = [(*imageio.STD_HUFFMAN["dc_luma" if c[4] == 0 else "dc_chroma"],
                 *imageio.STD_HUFFMAN["ac_luma" if c[5] == 0 else "ac_chroma"]) for c in comps]
        host = native.jpeg_huff_encode(coefs, block_comp, huff)
        assert host == native.jpeg_huff_encode_reference(coefs, block_comp, huff)
        path = str(tmp_path / "h.jpg")
        write_jpeg(path, arr, q)
        np.testing.assert_array_equal(read_jpeg(path),
                                      read_jpeg(path, entropy=native.jpeg_huff_decode_reference))
        write_jpeg(str(tmp_path / "r.jpg"), arr, q, entropy=native.jpeg_huff_encode_reference)
        assert open(path, "rb").read() == open(tmp_path / "r.jpg", "rb").read()


def _patched(data: bytes, old: bytes, new: bytes) -> bytes:
    i = data.index(old)
    return data[:i] + new + data[i + len(old):]


def test_unsupported_and_corrupt_files_raise(tmp_path):
    arr = _image(40, 48, "smooth")
    base = _pil_bytes(arr, quality=75)
    cases = {
        "progressive": (_pil_bytes(arr, quality=75, progressive=True), "SOF2"),
        "arithmetic": (_patched(base, b"\xff\xc0", b"\xff\xc9"), "SOF9"),
        "12-bit": (_patched(base, b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x11\x0c"), "12-bit"),
        "truncated": (base[:len(base) // 2], "corrupt|ends"),
        "not a jpeg": (b"GIF89a" + base, "not a JPEG"),
    }
    for name, (data, match) in cases.items():
        path = _write(tmp_path, f"{name}.jpg", data)
        with pytest.raises(ValueError, match=match):
            read_jpeg(path)
    with pytest.raises(ValueError, match="uint8"):
        write_jpeg(str(tmp_path / "f.jpg"), arr.astype(np.float32))


@pytest.mark.parametrize("shape", [(37, 53, 3), (320, 200, 3), (5, 300, 3), (64, 64)])
@pytest.mark.parametrize("size", [(256, 256), (17, 9), (100, 160), (1, 1), (513, 300)])
def test_resize_bilinear_u8_equals_pil(shape, size):
    arr = np.random.RandomState(shape[0] + size[0]).randint(0, 256, shape, np.uint8)
    want = np.asarray(Image.fromarray(arr).resize(size, Image.BILINEAR))
    np.testing.assert_array_equal(resize_bilinear_u8(arr, size), want)
