"""Image files and resizing without an imaging package.

The JAX package reads, writes and resizes images through PIL
(``tpgan_tpu/data/multipie.py:67-71,165-177``, ``prepare.py:44-72``,
``synthetic_faces.py:272``). The port does the same work with the
standard library's ``zlib`` and numpy alone:

* :func:`read_png` decodes 8-bit, non-interlaced PNGs (grey, grey+alpha,
  RGB, RGBA) with all five row filters, so files written by PIL's
  adaptive-filter encoder read back pixel for pixel;
* :func:`write_png` writes 8-bit RGB with filter 0 on every row, which
  :func:`read_png` decodes on its vectorised path;
* :func:`read_jpeg` decodes baseline sequential Huffman JPEGs (grey,
  YCbCr 4:4:4 and 4:2:0) as libjpeg-turbo does when PIL calls it: the
  islow integer IDCT, fancy (triangle) upsampling of 4:2:0 chroma and
  the fixed-point YCbCr->RGB, so its pixels equal PIL's to the bit;
* :func:`write_jpeg` encodes as PIL's ``save(quality=q)`` does: libjpeg's
  quality scaling of the standard tables, 4:2:0 by libjpeg's h2v2
  downsampling, the islow FDCT, libjpeg-turbo's reciprocal quantization
  and the standard Huffman tables, behind a JFIF header;
* :func:`resize_lanczos_u8` and :func:`resize_bilinear_u8` reproduce
  PIL's 8-bit ``Image.resize(size, Image.LANCZOS)`` and ``Image.BILINEAR``
  (``ImagingResample`` in Pillow's ``Resample.c``) to the bit.

The bit-serial part of the JPEG codec, the Huffman entropy decode and
encode, runs in the host library (:mod:`tpgan_tpu_torch.data.native`);
the marker syntax, the transforms and the colour conversion are numpy.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import List, Tuple

import numpy as np

from tpgan_tpu_torch.data import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for bit depth 8
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    # each scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def _chunks(data: bytes, path: str):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: PNG chunk {kind!r} is truncated or fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends before IEND")


def _unfilter_slow(kind: int, line: bytearray, prev: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) rows in place: each byte depends on the
    reconstructed byte ``bpp`` to its left."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            line[i] = (line[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line[i] = (line[i] + pred) & 0xFF


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG to a uint8 (H, W, C) array, C
    = 1 (grey), 2 (grey + alpha), 3 (RGB) or 4 (RGBA). Other PNGs
    (palette, 16-bit, interlaced) raise ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {color}, "
                         f"interlace {interlace}); 8-bit non-interlaced grey/RGB(A) only")
    c = _CHANNELS[color]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: PNG image data holds {raw.size} bytes, expected "
                         f"{h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    kinds = raw[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{path}: PNG row filter {int(kinds.max())} is not 0-4")
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        line, kind = raw[y, 1:], int(kinds[y])
        if kind == 0:
            out[y] = line
        elif kind == 1:  # Sub: a running sum mod 256 along each channel
            out[y] = np.cumsum(line.reshape(w, c), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y] = line + prev
        else:
            buf = bytearray(line.tobytes())
            _unfilter_slow(kind, buf, prev.tobytes(), c)
            out[y] = np.frombuffer(buf, np.uint8)
        prev = out[y]
    return out.reshape(h, w, c)


def read_rgb(path: str) -> np.ndarray:
    """A PNG (:func:`read_png`) or a JPEG (:func:`read_jpeg`), told apart
    by their signatures, as (H, W, 3) RGB, as PIL's ``convert("RGB")``
    gives it: grey is repeated, alpha is dropped."""
    with open(path, "rb") as f:
        head = f.read(8)
    img = read_jpeg(path) if head[:2] == JPEG_SOI else read_png(path)
    if img.shape[2] <= 2:
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


# ---- baseline JPEG, as libjpeg-turbo codes it -------------------------

JPEG_SOI = b"\xff\xd8"


def _zigzag() -> np.ndarray:
    """jpeg_natural_order: the natural (row-major) index of each zigzag
    position. Odd anti-diagonals run down-left, even ones up-right."""
    order = []
    for s in range(15):
        rows = range(max(0, s - 7), min(s, 7) + 1)
        for i in (rows if s % 2 else reversed(rows)):
            order.append(i * 8 + (s - i))
    return np.asarray(order, np.int64)


ZIGZAG = _zigzag()

# libjpeg's jcparam.c tables, in natural order
STD_LUMINANCE_QUANT = np.asarray([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
STD_CHROMINANCE_QUANT = np.asarray(
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)

# the standard Huffman tables (JPEG Annex K.3): (16 code-length counts, values)
_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "24336272820 90a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa".replace(" ", ""))
_AC_CHROMA_VALS = bytes.fromhex(
    "0001020311040521310612415107617113223281081442 91a1b1c109233352f0"
    "1562 72d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa".replace(" ", ""))
STD_HUFFMAN = {
    "dc_luma": (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    "dc_chroma": (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    "ac_luma": (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), _AC_LUMA_VALS),
    "ac_chroma": (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), _AC_CHROMA_VALS),
}

# islow (jidctint.c / jfdctint.c): 13-bit constants, 2 extra bits in pass 1
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _odd_part(x1, x3, x5, x7):
    """The shared odd half of the islow IDCT and FDCT (LL&M figure 8):
    inputs in the order (i3, i2, i1, i0) = (y1, y3, y5, y7) of the IDCT;
    returns (tmp0, tmp1, tmp2, tmp3) for outputs (3/4, 2/5, 1/6, 0/7)."""
    z1, z2, z3, z4 = x7 + x1, x5 + x3, x7 + x3, x5 + x1
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = x7 * _F0298, x5 * _F2053, x3 * _F3072, x1 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    return t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4


def _idct_1d(x, shift: int):
    """One islow IDCT pass over the 8 int64 arrays ``x`` (pass 1: the
    dequantized coefficients, pass 2: the work array), its outputs
    DESCALEd by ``shift``."""
    z1 = (x[2] + x[6]) * _F0541
    tmp2, tmp3 = z1 + x[6] * -_F1847, z1 + x[2] * _F0765
    tmp0, tmp1 = (x[0] + x[4]) << _CONST_BITS, (x[0] - x[4]) << _CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = _odd_part(x[1], x[3], x[5], x[7])
    return [_descale(v, shift) for v in (
        t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3)]


def _idct_range_limit(v: np.ndarray) -> np.ndarray:
    """``IDCT_range_limit[v & RANGE_MASK]``: v + 128 clamped to [0, 255]
    for |v| < 384 (and libjpeg's wrap-around table beyond)."""
    m = v & 1023
    return np.where(m < 128, m + 128, np.where(m < 512, 255, np.where(m < 896, 0, m - 896)))


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """``jpeg_idct_islow`` on (n, 64) natural-order coefficients with the
    (64,) natural-order quantization table: (n, 8, 8) uint8 samples."""
    c = coefs.reshape(-1, 8, 8).astype(np.int64) * quant.reshape(8, 8).astype(np.int64)
    # pass 1: columns (down axis 1), scaled by 2**PASS1_BITS
    ws = _idct_1d([c[:, k, :] for k in range(8)], _CONST_BITS - _PASS1_BITS)
    ws = np.stack(ws, axis=1)
    # pass 2: rows (along axis 2), descaled by 8 and PASS1_BITS
    out = _idct_1d([ws[:, :, k] for k in range(8)], _CONST_BITS + _PASS1_BITS + 3)
    return _idct_range_limit(np.stack(out, axis=2)).astype(np.uint8)


def _fdct_1d(x, first: bool):
    """One islow FDCT pass (jfdctint.c) over the 8 int64 arrays ``x``."""
    tmp0, tmp7, tmp1, tmp6 = x[0] + x[7], x[0] - x[7], x[1] + x[6], x[1] - x[6]
    tmp2, tmp5, tmp3, tmp4 = x[2] + x[5], x[2] - x[5], x[3] + x[4], x[3] - x[4]
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if first:
        out[0], out[4] = (t10 + t11) << _PASS1_BITS, (t10 - t11) << _PASS1_BITS
        shift = _CONST_BITS - _PASS1_BITS
    else:
        out[0], out[4] = _descale(t10 + t11, _PASS1_BITS), _descale(t10 - t11, _PASS1_BITS)
        shift = _CONST_BITS + _PASS1_BITS
    z1 = (t12 + t13) * _F0541
    out[2], out[6] = _descale(z1 + t13 * _F0765, shift), _descale(z1 + t12 * -_F1847, shift)
    o7, o5, o3, o1 = _odd_part(tmp7, tmp6, tmp5, tmp4)
    out[7], out[5], out[3], out[1] = (_descale(v, shift) for v in (o7, o5, o3, o1))
    return out


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """``jpeg_fdct_islow`` on (n, 8, 8) samples (0-255): (n, 8, 8) int64
    coefficients, scaled up by 8 as libjpeg leaves them."""
    d = blocks.astype(np.int64) - 128
    d = np.stack(_fdct_1d([d[:, :, k] for k in range(8)], True), axis=2)  # rows
    return np.stack(_fdct_1d([d[:, k, :] for k in range(8)], False), axis=1)  # columns


def _quant_divisors(quant: np.ndarray):
    """libjpeg-turbo's ``compute_reciprocal`` for the islow divisors
    (quantval << 3), with the 16-bit DCTELEM of its SIMD builds:
    (reciprocal, correction, shift) per coefficient."""
    recip, corr, shift = [], [], []
    for q in quant.tolist():
        d = int(q) << 3
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:  # a power of two
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return (np.asarray(recip, np.int64), np.asarray(corr, np.int64), np.asarray(shift, np.int64))


def quantize(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's reciprocal quantization of (n, 64) natural-order
    FDCT output by the (64,) natural-order table: |x| + correction times
    the reciprocal, shifted, with x's sign back."""
    recip, corr, shift = _quant_divisors(quant)
    a = np.abs(coefs)
    q = ((a + corr) * recip) >> shift
    return np.where(coefs < 0, -q, q)


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """``jpeg_set_quality(q, force_baseline=TRUE)``: libjpeg's quality
    scaling of a standard table, clamped to [1, 255]."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - q * 2
    return np.clip((base * scale + 50) // 100, 1, 255)


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``ycc_rgb_convert`` (jdcolor.c), 16-bit fixed point."""
    y, cb, cr = (a.astype(np.int64) for a in (y, cb, cr))
    cb, cr = cb - 128, cr - 128
    half = 1 << 15
    r = y + ((_fix(1.40200) * cr + half) >> 16)
    g = y + ((-_fix(0.34414) * cb + half - _fix(0.71414) * cr) >> 16)
    b = y + ((_fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _rgb_to_ycc(rgb: np.ndarray):
    """``rgb_ycc_convert`` (jccolor.c): Cb and Cr round with 0.5 - 2**-16,
    so they never reach 256."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + offset + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + offset + half - 1) >> 16
    return y, cb, cr


def _upsample_h2v2_fancy(p: np.ndarray) -> np.ndarray:
    """``h2v2_fancy_upsample`` (jdsample.c): a triangle filter, 3/4 of the
    nearer and 1/4 of the farther sample in each direction, edges
    replicated (the context rows libjpeg's main controller provides)."""
    p = p.astype(np.int64)
    up = np.concatenate([p[:1], p[:-1]], axis=0)
    down = np.concatenate([p[1:], p[-1:]], axis=0)
    rows = np.empty((2 * p.shape[0], p.shape[1]), np.int64)
    rows[0::2], rows[1::2] = 3 * p + up, 3 * p + down
    left = np.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
    right = np.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
    out = np.empty((rows.shape[0], 2 * rows.shape[1]), np.int64)
    out[:, 0::2] = (3 * rows + left + 8) >> 4
    out[:, 1::2] = (3 * rows + right + 7) >> 4
    return out


def _be16(data: bytes, pos: int) -> int:
    return (data[pos] << 8) | data[pos + 1]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def read_jpeg(path: str, entropy=None) -> np.ndarray:
    """Decode a baseline sequential Huffman JPEG to a uint8 (H, W, C)
    array, C = 1 (grey) or 3 (RGB from YCbCr, sampled 4:4:4 or 4:2:0).
    Its pixels are those of PIL's ``Image.open(path)`` (libjpeg-turbo:
    islow IDCT, fancy upsampling, fixed-point colour conversion).
    Progressive, arithmetic-coded, lossless, 12-bit, CMYK, RGB-coded and
    other sampling layouts raise ``ValueError``. ``entropy``: the
    Huffman scan decoder, ``native.jpeg_huff_decode`` (the host
    library) unless another with its signature is given."""
    entropy = entropy or native.jpeg_huff_decode
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != JPEG_SOI:
        raise ValueError(f"{path}: not a JPEG file")
    qt: dict = {}
    huff: dict = {}
    frame = None
    grids: dict = {}
    restart = 0
    adobe_transform = None
    pos = 2
    while True:
        if pos >= len(data) or data[pos] != 0xFF:
            raise ValueError(f"{path}: JPEG marker expected at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError(f"{path}: JPEG ends before EOI")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # a stray RSTn or TEM
            continue
        if pos + 2 > len(data):
            raise ValueError(f"{path}: JPEG segment truncated")
        length = _be16(data, pos)
        seg = data[pos + 2:pos + length]
        if len(seg) != length - 2:
            raise ValueError(f"{path}: JPEG segment truncated")
        pos += length
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                precision, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if precision else 64
                vals = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if precision else np.uint8)
                table = np.empty(64, np.int64)
                table[ZIGZAG] = vals
                qt[tq] = table
                i += 1 + n
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc_th = seg[i]
                bits = bytes(seg[i + 1:i + 17])
                n = sum(bits)
                huff[(tc_th >> 4, tc_th & 15)] = (bits, bytes(seg[i + 17:i + 17 + n]))
                i += 17 + n
        elif marker in (0xC0, 0xC1):  # SOF0 baseline, SOF1 extended sequential
            precision, height, width, ncomp = seg[0], _be16(seg, 1), _be16(seg, 3), seg[5]
            if precision != 8:
                raise ValueError(f"{path}: {precision}-bit JPEG; 8-bit only")
            if height == 0 or width == 0:
                raise ValueError(f"{path}: JPEG with a zero (or DNL-defined) size")
            comps = [(seg[6 + 3 * k], seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15, seg[8 + 3 * k])
                     for k in range(ncomp)]
            frame = (height, width, comps)
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"{path}: unsupported JPEG process (SOF{marker - 0xC0}): "
                             "baseline sequential Huffman only")
        elif marker == 0xDD:  # DRI
            restart = _be16(seg, 0)
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame header")
            pos = _decode_scan(path, data, pos, seg, frame, qt, huff, grids, restart, entropy)
    if frame is None:
        raise ValueError(f"{path}: JPEG has no frame header")
    return _reconstruct(path, frame, grids, adobe_transform)


def _decode_scan(path, data, pos, seg, frame, qt, huff, grids, restart, entropy) -> int:
    height, width, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    ns = seg[0]
    ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    if (ss, se, ahal) != (0, 63, 0):
        raise ValueError(f"{path}: progressive JPEG scan; baseline sequential only")
    by_id = {c[0]: k for k, c in enumerate(comps)}
    scan = []
    for j in range(ns):
        cid, tables = seg[1 + 2 * j], seg[2 + 2 * j]
        if cid not in by_id:
            raise ValueError(f"{path}: JPEG scan names component {cid}, not in the frame")
        k = by_id[cid]
        try:
            dc, ac = huff[(0, tables >> 4)], huff[(1, tables & 15)]
        except KeyError:
            raise ValueError(f"{path}: JPEG scan uses an undefined Huffman table") from None
        scan.append((k, dc, ac))
    mcux, mcuy = _ceil_div(width, 8 * hmax), _ceil_div(height, 8 * vmax)
    for k, _, _ in scan:
        _cid, h, v, tq = comps[k]
        if k not in grids:
            if tq not in qt:
                raise ValueError(f"{path}: JPEG component uses an undefined quantization table")
            # the table is latched at the component's first scan, as libjpeg does
            grids[k] = (np.zeros((mcuy * v, mcux * h, 64), np.int32), qt[tq].copy())
    if ns == 1:  # non-interleaved: one block per MCU over the component's own blocks
        k = scan[0][0]
        _cid, h, v, _tq = comps[k]
        bw = _ceil_div(_ceil_div(width * h, hmax), 8)
        bh = _ceil_div(_ceil_div(height * v, vmax), 8)
        layout = [(1, 1)]
        n_mcus = bw * bh
    else:
        layout = [(comps[k][1], comps[k][2]) for k, _, _ in scan]
        n_mcus = mcux * mcuy
    tables = [(dc[0], dc[1], ac[0], ac[1], h * v) for (_k, dc, ac), (h, v) in zip(scan, layout)]
    coefs, end = entropy(data, pos, tables, n_mcus, restart)
    if ns == 1:
        grid = grids[scan[0][0]][0]
        grid[:bh, :bw] = coefs.reshape(bh, bw, 64)
    else:
        col = 0
        for (k, _, _), (h, v) in zip(scan, layout):
            blocks = coefs[:, col:col + h * v].reshape(mcuy, mcux, v, h, 64)
            grids[k][0][:] = blocks.transpose(0, 2, 1, 3, 4).reshape(mcuy * v, mcux * h, 64)
            col += h * v
    return end


def _reconstruct(path, frame, grids, adobe_transform) -> np.ndarray:
    height, width, comps = frame
    if len(grids) != len(comps):
        raise ValueError(f"{path}: JPEG scans cover {len(grids)} of {len(comps)} components")
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    planes = []
    for k, (_cid, h, v, _tq) in enumerate(comps):
        grid, table = grids[k]
        rows, cols = grid.shape[:2]
        natural = np.empty_like(grid.reshape(-1, 64))
        natural[:, ZIGZAG] = grid.reshape(-1, 64)
        samples = idct_islow(natural, table).reshape(rows, cols, 8, 8)
        plane = samples.transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)
        planes.append(plane[:_ceil_div(height * v, vmax), :_ceil_div(width * h, hmax)])
    if len(comps) == 1:
        return np.ascontiguousarray(planes[0][:height, :width, None])
    if len(comps) != 3 or adobe_transform == 0:
        raise ValueError(f"{path}: unsupported JPEG colour space ({len(comps)} components"
                         f"{', RGB-coded' if adobe_transform == 0 else ''}); grey or YCbCr only")
    samp = [(c[1], c[2]) for c in comps]
    if samp == [(1, 1)] * 3:
        y, cb, cr = planes
    elif samp == [(2, 2), (1, 1), (1, 1)]:
        y = planes[0]
        # jinit_upsampler: fancy only where the downsampled width exceeds 2
        if planes[1].shape[1] > 2:
            cb, cr = (_upsample_h2v2_fancy(p) for p in planes[1:])
        else:
            cb, cr = (np.repeat(np.repeat(p, 2, axis=0), 2, axis=1) for p in planes[1:])
    else:
        raise ValueError(f"{path}: unsupported JPEG sampling {samp}; 4:4:4 or 4:2:0 only")
    return _ycc_to_rgb(y[:height, :width], cb[:height, :width], cr[:height, :width])


def _jfif_segments(tables, comps, height, width) -> bytes:
    """SOI, the JFIF APP0, DQT, SOF0 and DHT segments of a baseline file.
    ``tables``: {id: natural-order quantization table}; ``comps``: (id, h,
    v, quant id, dc id, ac id) per component."""
    def segment(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    out = [JPEG_SOI, segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tq, table in tables.items():
        out.append(segment(0xDB, bytes([tq]) + bytes(table[ZIGZAG].astype(np.uint8))))
    out.append(segment(0xC0, struct.pack(">BHHB", 8, height, width, len(comps)) + b"".join(
        bytes([cid, (h << 4) | v, tq]) for cid, h, v, tq, _, _ in comps)))
    sent = set()
    for *_, td, ta in comps:
        for key, tc, th in (("dc_luma" if td == 0 else "dc_chroma", 0, td),
                            ("ac_luma" if ta == 0 else "ac_chroma", 1, ta)):
            if (tc, th) not in sent:
                bits, vals = STD_HUFFMAN[key]
                out.append(segment(0xC4, bytes([(tc << 4) | th]) + bits + vals))
                sent.add((tc, th))
    out.append(segment(0xDA, bytes([len(comps)]) + b"".join(
        bytes([cid, (td << 4) | ta]) for cid, _, _, _, td, ta in comps) + b"\x00\x3f\x00"))
    return b"".join(out)


def _edge_pad(p: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(p, ((0, rows - p.shape[0]), (0, cols - p.shape[1])), mode="edge")


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8r, 8c) plane -> (r, c, 8, 8) blocks."""
    r, c = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(r, 8, c, 8).transpose(0, 2, 1, 3)


def _coded(plane: np.ndarray, table: np.ndarray) -> np.ndarray:
    """FDCT and quantization of every block of a padded plane:
    (r, c, 64) zigzag-order coefficients."""
    b = _blocks(plane)
    r, c = b.shape[:2]
    q = quantize(fdct_islow(b.reshape(-1, 8, 8)).reshape(-1, 64), table)
    return q[:, ZIGZAG].reshape(r, c, 64).astype(np.int32)


def jpeg_coefficients(img: np.ndarray, quality: int = 75):
    """What libjpeg (as PIL's ``save(quality=q)`` drives it) codes for an
    (H, W) grey or (H, W, 3) RGB uint8 image: (the quantization tables,
    the component layout for :func:`_jfif_segments`, the (n_mcus,
    blocks_per_mcu, 64) zigzag coefficients in MCU order, and each
    block's component index)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_jpeg takes (H, W) or (H, W, 3) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"JPEG sizes are 1-65535, got {w}x{h}")
    luma = quality_table(STD_LUMINANCE_QUANT, quality)
    if img.ndim == 2:
        bw, bh = _ceil_div(w, 8), _ceil_div(h, 8)
        coefs = _coded(_edge_pad(img, 8 * bh, 8 * bw), luma)
        return {0: luma}, [(1, 1, 1, 0, 0, 0)], coefs.reshape(-1, 1, 64), np.zeros(1, np.int32)
    chroma = quality_table(STD_CHROMINANCE_QUANT, quality)
    y, cb, cr = _rgb_to_ycc(img)
    mx, my = _ceil_div(w, 16), _ceil_div(h, 16)
    # Y: edge-replicated to whole blocks (fullsize_downsample, the prep
    # controller's bottom padding); blocks past ceil(W/8) x ceil(H/8) are
    # the coefficient controller's dummies
    bw, bh = _ceil_div(w, 8), _ceil_div(h, 8)
    yq = np.zeros((2 * my, 2 * mx, 64), np.int32)
    yq[:bh, :bw] = _coded(_edge_pad(y, 8 * bh, 8 * bw), luma)
    # dummy blocks: zero AC, the DC of the block before them in the MCU
    # (compress_data): right-edge ones copy their left neighbour, a
    # bottom row copies the MCU's last block of the row above
    if bw % 2:
        yq[:, bw, 0] = yq[:, bw - 1, 0]
    if bh % 2:
        yq[bh, :, 0] = yq[bh - 1, 1::2, 0].repeat(2)
    # chroma: the full-size plane edge-replicated to an even height and
    # to 16 * MCU columns, h2v2_downsample with the 1, 2, 1, 2 bias, its
    # rows then replicated to whole blocks
    chroma_coefs = []
    for p in (cb, cr):
        p = _edge_pad(p, h + h % 2, 16 * mx)
        s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        bias = np.tile(np.asarray([1, 2], np.int64), s.shape[1] // 2)
        chroma_coefs.append(_coded(_edge_pad((s + bias) >> 2, 8 * my, 8 * mx), chroma))
    mcus = np.concatenate([
        yq.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, 4, 64),
        chroma_coefs[0].reshape(my * mx, 1, 64), chroma_coefs[1].reshape(my * mx, 1, 64),
    ], axis=1)
    comps = [(1, 2, 2, 0, 0, 0), (2, 1, 1, 1, 1, 1), (3, 1, 1, 1, 1, 1)]
    return ({0: luma, 1: chroma}, comps, np.ascontiguousarray(mcus),
            np.asarray([0, 0, 0, 0, 1, 2], np.int32))


def write_jpeg(path: str, img: np.ndarray, quality: int = 75, entropy=None) -> None:
    """Write an (H, W, 3) RGB (or (H, W) grey) uint8 array as a baseline
    JFIF JPEG coded as PIL's ``Image.fromarray(img).save(path,
    quality=quality)`` codes it, so PIL decodes both files to the same
    pixels. ``entropy``: the Huffman scan encoder,
    ``native.jpeg_huff_encode`` unless another with its signature is
    given."""
    entropy = entropy or native.jpeg_huff_encode
    tables, comps, coefs, block_comp = jpeg_coefficients(img, quality)
    huff = [(*STD_HUFFMAN["dc_luma" if td == 0 else "dc_chroma"],
             *STD_HUFFMAN["ac_luma" if ta == 0 else "ac_chroma"]) for *_, td, ta in comps]
    body = entropy(coefs, block_comp, huff)
    h, w = np.asarray(img).shape[:2]
    with open(path, "wb") as f:
        f.write(_jfif_segments(tables, comps, h, w) + body + b"\xff\xd9")


# ---- PIL's 8-bit resampling (Lanczos, bilinear) ------------------------

_PRECISION_BITS = 32 - 8 - 2  # Resample.c: 22 fractional bits


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


# Resample.c's filters: (function, support)
LANCZOS = (_lanczos, 3.0)
BILINEAR = (_bilinear, 1.0)


def _coeffs(in_size: int, out_size: int, filt) -> Tuple[np.ndarray, np.ndarray]:
    """Per output pixel: the first input index and the fixed-point weights
    of its window ((out, ksize) int64, zero past the window), as
    ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` make them for the
    filter ``filt`` = (function, support). The Lanczos weights use
    ``math.sin`` (C's libm, as Pillow does): numpy's SIMD sine may differ
    in the last ulp, which the 22-bit rounding can expose."""
    fn, filter_support = filt
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    one = float(1 << _PRECISION_BITS)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k: List[float] = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        # rounded half away from zero, as the C casts in
        # normalize_coeffs_8bpc truncate toward zero
        weights[xx, :xmax] = [int(w * one - 0.5) if w < 0 else int(w * one + 0.5) for w in k]
        starts[xx] = xmin
    return starts, weights


def _resample_axis(img: np.ndarray, axis: int, out_size: int, filt) -> np.ndarray:
    """One pass of ``ImagingResampleHorizontal/Vertical_8bpc`` along
    ``axis`` (1 = width, 0 = height) of an (H, W, C) uint8 image."""
    in_size = img.shape[axis]
    starts, weights = _coeffs(in_size, out_size, filt)
    idx = np.minimum(starts[:, None] + np.arange(weights.shape[1]), in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # (in, other, C)
    acc = np.einsum("ok,okjc->ojc", weights, src[idx])
    acc += 1 << (_PRECISION_BITS - 1)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def _resize_u8(arr: np.ndarray, size: Tuple[int, int], filt, name: str) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (arr.ndim == 3 and arr.shape[2] != 3):
        raise ValueError(f"{name} takes (H, W) or (H, W, 3) uint8, got "
                         f"{arr.shape} {arr.dtype}")
    w, h = size
    img = arr[:, :, None] if arr.ndim == 2 else arr
    if w != img.shape[1]:
        img = _resample_axis(img, 1, w, filt)
    if h != img.shape[0]:
        img = _resample_axis(img, 0, h, filt)
    return img[:, :, 0] if arr.ndim == 2 else np.ascontiguousarray(img)


def resize_lanczos_u8(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's ``Image.fromarray(arr).resize(size, Image.LANCZOS)`` for an
    (H, W) grey or (H, W, 3) RGB uint8 array; ``size`` is (width,
    height), as PIL takes it. The horizontal pass runs first and the
    vertical pass reads its uint8 result; a pass whose size is unchanged
    is skipped."""
    return _resize_u8(arr, size, LANCZOS, "resize_lanczos_u8")


def resize_bilinear_u8(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's ``Image.fromarray(arr).resize(size, Image.BILINEAR)``: the
    triangle filter of support 1 x the downscale factor, through the same
    two passes as :func:`resize_lanczos_u8`."""
    return _resize_u8(arr, size, BILINEAR, "resize_bilinear_u8")
