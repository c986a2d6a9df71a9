// tpgan_host — host-side data-pipeline kernels of the PyTorch port, its
// own copy of the JAX package's native/tpgan_host.cpp (the port reads no
// file of the JAX side and shares no build with it).
//
// uint8 -> [-1, 1] and [0, 1] float conversion, the landmark-centred
// patch crop (the reference's `process` geometry, DataAndDataset.py:
// 10-56), bilinear letterboxing, and the Huffman entropy decode and
// encode of baseline JPEG scans (the bit-serial part of the port's JPEG
// codec, data/imageio.py), as a plain C ABI for ctypes.
// Built at first use by tpgan_tpu_torch/ops/_build.py::build_host:
//   g++ -O3 -shared -fPIC tpgan_host.cpp -o libtpgan_host-<hash>.so

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

// uint8 HWC -> float32 in [-1, 1] (the reference's ToTensor * 2 - 1,
// DataAndDataset.py:218-220), n = H*W*C elements.
void u8_to_pm1(const uint8_t* src, float* dst, int64_t n) {
    // (2v - 255) / 255: integer-exact numerator, so 0 -> -1.0 and
    // 255 -> 1.0 exactly (v * (2/255) - 1 overshoots to 1.0000001)
    for (int64_t i = 0; i < n; ++i) {
        dst[i] = (2.0f * static_cast<float>(src[i]) - 255.0f) / 255.0f;
    }
}

// uint8 HWC -> float32 in [0, 1] (ToTensor; pretrain path).
void u8_to_unit(const uint8_t* src, float* dst, int64_t n) {
    constexpr float k = 1.0f / 255.0f;
    for (int64_t i = 0; i < n; ++i) {
        dst[i] = static_cast<float>(src[i]) * k;
    }
}

// Landmark-centred crop with zero padding outside the image.
// Box: [x - w/2 + 1, x + w/2 + 1) x [y - h/2 + 1, y + h/2 + 1) with
// (x, y) = floor(center) — DataAndDataset.py:46-54.
// img: (ih, iw, c) float32; out: (ph, pw, c) float32.
void crop_patch_f32(const float* img, int ih, int iw, int c,
                    float cx, float cy, int pw, int ph, float* out) {
    const int x = static_cast<int>(std::floor(cx));
    const int y = static_cast<int>(std::floor(cy));
    const int left = x - pw / 2 + 1;
    const int top = y - ph / 2 + 1;
    std::memset(out, 0, sizeof(float) * pw * ph * c);
    const int src_t = std::max(top, 0);
    const int src_b = std::min(top + ph, ih);
    const int src_l = std::max(left, 0);
    const int src_r = std::min(left + pw, iw);
    if (src_b <= src_t || src_r <= src_l) return;
    const int row_elems = (src_r - src_l) * c;
    for (int row = src_t; row < src_b; ++row) {
        const float* s = img + (static_cast<int64_t>(row) * iw + src_l) * c;
        float* d = out + (static_cast<int64_t>(row - top) * pw + (src_l - left)) * c;
        std::memcpy(d, s, sizeof(float) * row_elems);
    }
}

// Bilinear resize uint8 HWC -> float32 [0,1] HWC letterboxed into a
// (size, size) zero square, aspect preserved, centred. Returns the
// scale and offsets through out-params so callers can transform labels.
void letterbox_u8(const uint8_t* src, int ih, int iw, int c, int size,
                  float* dst, float* scale_out, int* pad_left_out,
                  int* pad_top_out) {
    const float scale =
        static_cast<float>(size) / static_cast<float>(std::max(ih, iw));
    int nh = std::max(static_cast<int>(std::lround(ih * scale)), 1);
    int nw = std::max(static_cast<int>(std::lround(iw * scale)), 1);
    nh = std::min(nh, size);
    nw = std::min(nw, size);
    const int pad_top = (size - nh) / 2;
    const int pad_left = (size - nw) / 2;
    std::memset(dst, 0, sizeof(float) * size * size * c);
    constexpr float ku = 1.0f / 255.0f;
    // exact per-axis ratios (torch F.interpolate semantics): the rounded
    // target sizes make ih/nh differ slightly from 1/scale
    const float ry = static_cast<float>(ih) / static_cast<float>(nh);
    const float rx = static_cast<float>(iw) / static_cast<float>(nw);
    for (int oy = 0; oy < nh; ++oy) {
        // align_corners=False source coordinate
        float sy = (oy + 0.5f) * ry - 0.5f;
        sy = std::min(std::max(sy, 0.0f), static_cast<float>(ih - 1));
        const int y0 = static_cast<int>(sy);
        const int y1 = std::min(y0 + 1, ih - 1);
        const float fy = sy - y0;
        float* drow = dst + (static_cast<int64_t>(oy + pad_top) * size + pad_left) * c;
        for (int ox = 0; ox < nw; ++ox) {
            float sx = (ox + 0.5f) * rx - 0.5f;
            sx = std::min(std::max(sx, 0.0f), static_cast<float>(iw - 1));
            const int x0 = static_cast<int>(sx);
            const int x1 = std::min(x0 + 1, iw - 1);
            const float fx = sx - x0;
            const uint8_t* p00 = src + (static_cast<int64_t>(y0) * iw + x0) * c;
            const uint8_t* p01 = src + (static_cast<int64_t>(y0) * iw + x1) * c;
            const uint8_t* p10 = src + (static_cast<int64_t>(y1) * iw + x0) * c;
            const uint8_t* p11 = src + (static_cast<int64_t>(y1) * iw + x1) * c;
            for (int ch = 0; ch < c; ++ch) {
                const float top =
                    p00[ch] * (1.0f - fx) + p01[ch] * fx;
                const float bot =
                    p10[ch] * (1.0f - fx) + p11[ch] * fx;
                drow[ox * c + ch] = (top * (1.0f - fy) + bot * fy) * ku;
            }
        }
    }
    *scale_out = scale;
    *pad_left_out = pad_left;
    *pad_top_out = pad_top;
}

// ---- JPEG Huffman entropy coding (baseline, 8-bit) -------------------
//
// Tables come per scan component as DHT segments give them: 16
// code-length counts and up to 256 symbol values, (2, ncomp, 16) and
// (2, ncomp, 256) arrays, DC first. Coefficients are (n_mcus,
// blocks_per_mcu, 64) int32 in zigzag order.

namespace {

struct HuffDecodeTable {
    int32_t maxcode[18];   // largest code of each length, -1 if none
    int32_t valoffset[18]; // symbol index of a code: code + valoffset[len]
    uint8_t vals[256];
};

bool build_decode_table(const uint8_t* bits, const uint8_t* vals, HuffDecodeTable* t) {
    int32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
        const int n = bits[len - 1];
        t->valoffset[len] = k - code;
        k += n;
        code += n;
        if (k > 256 || code > (1 << len)) return false;
        t->maxcode[len] = n ? code - 1 : -1;
        code <<= 1;
    }
    t->maxcode[17] = 0x7fffffff;
    std::memcpy(t->vals, vals, 256);
    return true;
}

struct BitReader {
    const uint8_t* data;
    int64_t len, pos;
    uint32_t acc = 0;
    int n = 0;
    bool ended = false;

    int bit() {
        if (n == 0) {
            if (pos >= len || (data[pos] == 0xFF && (pos + 1 >= len || data[pos + 1] != 0x00))) {
                ended = true;
                return 0;
            }
            acc = data[pos];
            pos += data[pos] == 0xFF ? 2 : 1;
            n = 8;
        }
        --n;
        return (acc >> n) & 1;
    }

    int bits(int count) {
        int v = 0;
        for (int i = 0; i < count; ++i) v = (v << 1) | bit();
        return v;
    }
};

// the symbol, or -1 for a code of no table
int decode_symbol(BitReader& r, const HuffDecodeTable& t) {
    int32_t code = 0;
    for (int len = 1; len <= 16; ++len) {
        code = (code << 1) | r.bit();
        if (t.maxcode[len] >= 0 && code <= t.maxcode[len]) {
            return t.vals[code + t.valoffset[len]];
        }
    }
    return -1;
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct HuffEncodeTable {
    uint32_t code[256];
    uint8_t size[256];  // 0: no code
};

void build_encode_table(const uint8_t* bits, const uint8_t* vals, HuffEncodeTable* t) {
    std::memset(t->size, 0, sizeof(t->size));
    uint32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
        for (int i = 0; i < bits[len - 1]; ++i, ++k) {
            t->code[vals[k]] = code++;
            t->size[vals[k]] = static_cast<uint8_t>(len);
        }
        code <<= 1;
    }
}

struct BitWriter {
    uint8_t* out;
    int64_t cap, pos = 0;
    uint64_t acc = 0;
    int n = 0;
    bool overflow = false;

    void put(uint32_t value, int length) {
        acc = (acc << length) | (value & ((1u << length) - 1u));
        n += length;
        while (n >= 8) {
            const uint8_t byte = static_cast<uint8_t>(acc >> (n - 8));
            if (pos + 2 > cap) { overflow = true; return; }
            out[pos++] = byte;
            if (byte == 0xFF) out[pos++] = 0;
            n -= 8;
        }
        acc &= (1ull << n) - 1ull;
    }
};

}  // namespace

// Decodes one scan from data[start:]. Returns the offset of the marker
// that ends the scan's data, or a negative error: -1 a code of no table,
// -2 a run past the block's end, -3 data ends before the last MCU, -4 a
// missing restart marker, -5 a table whose counts overflow.
int64_t jpeg_huff_decode(const uint8_t* data, int64_t len, int64_t start, int ncomp,
                         const int32_t* blocks_per_comp, const uint8_t* bits,
                         const uint8_t* vals, int64_t n_mcus, int restart_interval,
                         int32_t* out) {
    HuffDecodeTable dc[4], ac[4];
    if (ncomp < 1 || ncomp > 4) return -5;
    int nblocks = 0;
    for (int k = 0; k < ncomp; ++k) {
        if (!build_decode_table(bits + k * 16, vals + k * 256, &dc[k]) ||
            !build_decode_table(bits + (ncomp + k) * 16, vals + (ncomp + k) * 256, &ac[k])) {
            return -5;
        }
        nblocks += blocks_per_comp[k];
    }
    BitReader r{data, len, start};
    int pred[4] = {0, 0, 0, 0};
    for (int64_t m = 0; m < n_mcus; ++m) {
        if (restart_interval && m && m % restart_interval == 0) {
            r.n = 0;
            if (!(r.pos + 1 < len && data[r.pos] == 0xFF && data[r.pos + 1] >= 0xD0 &&
                  data[r.pos + 1] <= 0xD7)) {
                return -4;
            }
            r.pos += 2;
            pred[0] = pred[1] = pred[2] = pred[3] = 0;
        }
        int32_t* blk = out + m * nblocks * 64;
        for (int k = 0; k < ncomp; ++k) {
            for (int b = 0; b < blocks_per_comp[k]; ++b, blk += 64) {
                int s = decode_symbol(r, dc[k]);
                if (s < 0) return r.ended ? -3 : -1;
                if (s) pred[k] += extend(r.bits(s), s);
                blk[0] = pred[k];
                for (int i = 1; i < 64;) {
                    const int rs = decode_symbol(r, ac[k]);
                    if (rs < 0) return r.ended ? -3 : -1;
                    const int run = rs >> 4;
                    s = rs & 15;
                    if (s) {
                        i += run;
                        if (i > 63) return -2;
                        blk[i++] = extend(r.bits(s), s);
                    } else if (run == 15) {
                        i += 16;
                    } else {
                        break;
                    }
                }
                if (r.ended) return -3;
            }
        }
    }
    int64_t pos = r.pos;
    while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0x00)) ++pos;
    return pos;
}

// Huffman-codes the coefficients, block b of each MCU with the tables of
// component block_comp[b] and its DC prediction; pads the last byte with
// 1 bits. Returns the bytes written, or -1 if `cap` was too small or a
// coefficient is out of 8-bit JPEG's range.
int64_t jpeg_huff_encode(const int32_t* coefs, int64_t n_mcus, int nblocks,
                         const int32_t* block_comp, int ncomp, const uint8_t* bits,
                         const uint8_t* vals, uint8_t* out, int64_t cap) {
    HuffEncodeTable dc[4], ac[4];
    if (ncomp < 1 || ncomp > 4) return -1;
    for (int k = 0; k < ncomp; ++k) {
        build_encode_table(bits + k * 16, vals + k * 256, &dc[k]);
        build_encode_table(bits + (ncomp + k) * 16, vals + (ncomp + k) * 256, &ac[k]);
    }
    BitWriter w{out, cap};
    int pred[4] = {0, 0, 0, 0};
    for (int64_t m = 0; m < n_mcus; ++m) {
        for (int b = 0; b < nblocks; ++b) {
            const int32_t* blk = coefs + (m * nblocks + b) * 64;
            const int k = block_comp[b];
            const int diff = blk[0] - pred[k];
            pred[k] = blk[0];
            int size = 0;
            for (int a = std::abs(diff); a; a >>= 1) ++size;
            if (size > 11 || !dc[k].size[size]) return -1;
            w.put(dc[k].code[size], dc[k].size[size]);
            if (size) w.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), size);
            int run = 0;
            for (int i = 1; i < 64; ++i) {
                const int v = blk[i];
                if (v == 0) { ++run; continue; }
                while (run > 15) {
                    w.put(ac[k].code[0xF0], ac[k].size[0xF0]);
                    run -= 16;
                }
                size = 0;
                for (int a = std::abs(v); a; a >>= 1) ++size;
                const int sym = (run << 4) | size;
                if (size > 10 || !ac[k].size[sym]) return -1;
                w.put(ac[k].code[sym], ac[k].size[sym]);
                w.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), size);
                run = 0;
            }
            if (run) w.put(ac[k].code[0x00], ac[k].size[0x00]);
            if (w.overflow) return -1;
        }
    }
    if (w.n) w.put((1u << (8 - w.n)) - 1u, 8 - w.n);
    return w.overflow ? -1 : w.pos;
}

}  // extern "C"
