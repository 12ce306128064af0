// Native host-side image pipeline (the port's own copy).
//
// The reference's host image path is PIL (open/crop/resize/normalize everywhere:
// demo.py:131-140, SFT.py:158-169, customized_funcs.py:76-85). On our single-core host
// that path is ~45% of episode wall time, so the hot ops are implemented here and
// bound via ctypes (no pybind11 in this image):
//
//   - resize_bicubic_u8: separable Catmull-Rom (a = -0.5) resampling with PIL-style
//     antialias support scaling on downscale (support = 2 * scale). Float accumulation;
//     numerically equivalent to PIL BICUBIC within rounding (PIL uses 8-bit fixed
//     point), NOT byte-identical — eval parity paths keep PIL, serving/bench use this.
//   - normalize_patchify: fused uint8 HWC -> normalized conv-patch layout
//     (C * temporal * patch * patch flattened per patch, merge-block-major), exactly
//     matching image/preprocess.py::patchify (same float math, same order).
//   - crop_u8: plain byte crop (cut_image's window is computed in Python).
//
// Build: g++ -O3 -march=native -shared -fPIC image_ops.cpp -o libimage_ops.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Catmull-Rom cubic kernel (PIL's BICUBIC filter, a = -0.5), support 2.
static inline double cubic_filter(double x) {
    const double a = -0.5;
    x = std::fabs(x);
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

// Precompute sampling bounds + normalized weights for one axis (PIL-compatible:
// support scales with the reduction factor => antialiasing on downscale).
static void precompute_coeffs(int in_size, int out_size,
                              std::vector<int>& bounds_lo, std::vector<int>& bounds_n,
                              std::vector<double>& weights, int& ksize) {
    double scale = (double)in_size / out_size;
    double filterscale = std::max(scale, 1.0);
    double support = 2.0 * filterscale;
    ksize = (int)std::ceil(support) * 2 + 1;
    bounds_lo.resize(out_size);
    bounds_n.resize(out_size);
    weights.assign((size_t)out_size * ksize, 0.0);
    for (int xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        int lo = (int)std::max(center - support + 0.5, 0.0);
        int hi = (int)std::min(center + support + 0.5, (double)in_size);
        int n = hi - lo;
        bounds_lo[xx] = lo;
        bounds_n[xx] = n;
        double* w = &weights[(size_t)xx * ksize];
        double ss = 0.0;
        for (int i = 0; i < n; i++) {
            double wv = cubic_filter((lo + i - center + 0.5) / filterscale);
            w[i] = wv;
            ss += wv;
        }
        if (ss != 0.0)
            for (int i = 0; i < n; i++) w[i] /= ss;
    }
}

// uint8 HWC (h, w, 3) -> uint8 HWC (oh, ow, 3), bicubic with antialias.
void resize_bicubic_u8(const uint8_t* src, int h, int w,
                       uint8_t* dst, int oh, int ow) {
    const int C = 3;
    std::vector<int> xlo, xn, ylo, yn;
    std::vector<double> xw, yw;
    int xk, yk;
    precompute_coeffs(w, ow, xlo, xn, xw, xk);
    precompute_coeffs(h, oh, ylo, yn, yw, yk);

    // horizontal pass: (h, w, 3) -> (h, ow, 3) in float
    std::vector<float> tmp((size_t)h * ow * C);
    for (int y = 0; y < h; y++) {
        const uint8_t* row = src + (size_t)y * w * C;
        float* trow = &tmp[(size_t)y * ow * C];
        for (int x = 0; x < ow; x++) {
            const double* wgt = &xw[(size_t)x * xk];
            int lo = xlo[x], n = xn[x];
            double acc[3] = {0, 0, 0};
            for (int i = 0; i < n; i++) {
                const uint8_t* px = row + (size_t)(lo + i) * C;
                double wv = wgt[i];
                acc[0] += wv * px[0];
                acc[1] += wv * px[1];
                acc[2] += wv * px[2];
            }
            trow[(size_t)x * C + 0] = (float)acc[0];
            trow[(size_t)x * C + 1] = (float)acc[1];
            trow[(size_t)x * C + 2] = (float)acc[2];
        }
    }
    // vertical pass: (h, ow, 3) -> (oh, ow, 3) uint8
    for (int y = 0; y < oh; y++) {
        const double* wgt = &yw[(size_t)y * yk];
        int lo = ylo[y], n = yn[y];
        uint8_t* drow = dst + (size_t)y * ow * C;
        for (int x = 0; x < ow; x++) {
            double acc[3] = {0, 0, 0};
            for (int i = 0; i < n; i++) {
                const float* px = &tmp[((size_t)(lo + i) * ow + x) * C];
                double wv = wgt[i];
                acc[0] += wv * px[0];
                acc[1] += wv * px[1];
                acc[2] += wv * px[2];
            }
            for (int c = 0; c < C; c++) {
                double v = acc[c];
                drow[(size_t)x * C + c] =
                    (uint8_t)std::min(255.0, std::max(0.0, std::round(v)));
            }
        }
    }
}

// uint8 HWC crop: src (h, w, 3) -> dst (y2-y1, x2-x1, 3).
void crop_u8(const uint8_t* src, int h, int w,
             int x1, int y1, int x2, int y2, uint8_t* dst) {
    const int C = 3;
    int cw = x2 - x1;
    for (int y = y1; y < y2; y++) {
        std::memcpy(dst + (size_t)(y - y1) * cw * C,
                    src + ((size_t)y * w + x1) * C, (size_t)cw * C);
    }
}

// Fused normalize + conv-patchify.
// src: uint8 HWC (h, w, 3); out: float32 (grid_h*grid_w, 3*temporal*patch*patch)
// in the exact layout of image/preprocess.py::patchify (t=1, merge-block-major,
// per-patch flatten order = (c, temporal, ph, pw)).
void normalize_patchify(const uint8_t* src, int h, int w,
                        const float* mean, const float* stdv,
                        int patch, int temporal, int merge,
                        float* out) {
    const int C = 3;
    int grid_h = h / patch, grid_w = w / patch;
    int hb = grid_h / merge, wb = grid_w / merge;
    size_t patch_dim = (size_t)C * temporal * patch * patch;
    float inv_std[3], nmean[3];
    for (int c = 0; c < C; c++) {
        inv_std[c] = 1.0f / (255.0f * stdv[c]);
        nmean[c] = mean[c] / stdv[c];
    }
    // emission order: (hb, wb, mh, mw) — patch index p enumerates that order
    size_t p_idx = 0;
    for (int bh = 0; bh < hb; bh++)
        for (int bw = 0; bw < wb; bw++)
            for (int mh = 0; mh < merge; mh++)
                for (int mw = 0; mw < merge; mw++, p_idx++) {
                    int gy = bh * merge + mh, gx = bw * merge + mw;
                    float* dst = out + p_idx * patch_dim;
                    for (int c = 0; c < C; c++) {
                        for (int t = 0; t < temporal; t++) {
                            // single image repeated along temporal axis
                            float* d = dst + ((size_t)c * temporal + t) * patch * patch;
                            for (int py = 0; py < patch; py++) {
                                const uint8_t* srow =
                                    src + (((size_t)(gy * patch + py) * w) + gx * patch) * C + c;
                                for (int px = 0; px < patch; px++) {
                                    d[py * patch + px] =
                                        (float)srow[(size_t)px * C] * inv_std[c] - nmean[c];
                                }
                            }
                        }
                    }
                }
}

// Byte-only conv-patchify (no normalization): uint8 HWC -> uint8 patches in the
// same layout as normalize_patchify. Pixel normalization moves onto the device
// (folded into the ViT patch-embed input), so the host ships 4x fewer bytes over
// the host->HBM link and does no float math at all.
void patchify_u8(const uint8_t* src, int h, int w,
                 int patch, int temporal, int merge,
                 uint8_t* out) {
    const int C = 3;
    int grid_h = h / patch, grid_w = w / patch;
    int hb = grid_h / merge, wb = grid_w / merge;
    size_t patch_dim = (size_t)C * temporal * patch * patch;
    size_t p_idx = 0;
    for (int bh = 0; bh < hb; bh++)
        for (int bw = 0; bw < wb; bw++)
            for (int mh = 0; mh < merge; mh++)
                for (int mw = 0; mw < merge; mw++, p_idx++) {
                    int gy = bh * merge + mh, gx = bw * merge + mw;
                    uint8_t* dst = out + p_idx * patch_dim;
                    for (int c = 0; c < C; c++) {
                        uint8_t* d0 = dst + (size_t)c * temporal * patch * patch;
                        for (int py = 0; py < patch; py++) {
                            const uint8_t* srow =
                                src + (((size_t)(gy * patch + py) * w) + gx * patch) * C + c;
                            uint8_t* d = d0 + py * patch;
                            for (int px = 0; px < patch; px++) {
                                d[px] = srow[(size_t)px * C];
                            }
                        }
                        // temporal repeat: identical frames, plain byte copy
                        for (int t = 1; t < temporal; t++) {
                            std::memcpy(d0 + (size_t)t * patch * patch, d0,
                                        (size_t)patch * patch);
                        }
                    }
                }
}

}  // extern "C"
