// tpgan_host — host-side data-pipeline kernels of the PyTorch port, its
// own copy of the JAX package's native/tpgan_host.cpp (the port reads no
// file of the JAX side and shares no build with it).
//
// uint8 -> [-1, 1] and [0, 1] float conversion, the landmark-centred
// patch crop (the reference's `process` geometry, DataAndDataset.py:
// 10-56) and bilinear letterboxing, as a plain C ABI for ctypes.
// Built at first use by tpgan_tpu_torch/ops/_build.py::build_host:
//   g++ -O3 -shared -fPIC tpgan_host.cpp -o libtpgan_host-<hash>.so

#include <algorithm>
#include <cstdint>
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

}  // extern "C"
