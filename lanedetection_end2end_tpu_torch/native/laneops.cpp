// Native preprocessing kernels for the input pipeline.
//
// The reference preprocesses every sample with PIL on Python threads
// (crop + bilinear resize + ToTensor — Load_Data_new.py:127-131,184). At
// TPU-scale batch rates the host pipeline must keep thousands of images/sec
// per host, so the resize/normalize hot path is implemented here in C++:
//
//  - resample_to_f32: PIL-equivalent separable triangle-filter ("bilinear")
//    resampling of a uint8 HWC image straight into normalized float32
//    (fuses ToTensor's /255), with optional horizontal flip.
//  - resize_nearest_u8: PIL-NEAREST resize for the segmentation masks.
//
// Build: g++ -O3 -fPIC -shared (see data/native.py). Called via ctypes from
// worker threads — these functions hold no Python state and release the GIL
// for the duration of the call.

#include <cstdint>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

struct Taps {
    std::vector<int> first;      // first source index per output pixel
    std::vector<int> count;      // number of taps
    std::vector<float> weights;  // ksize weights per output pixel
    int ksize;
};

// PIL's precompute_coeffs for the triangle (BILINEAR) filter
// (Pillow src/libImaging/Resample.c), float weights instead of PIL's
// fixed-point int16 — agrees with Pillow to ~1/255.
Taps triangle_taps(int in_size, int out_size) {
    double scale = (double)in_size / out_size;
    double filterscale = std::max(scale, 1.0);
    double support = 1.0 * filterscale;  // triangle filter support = 1
    int ksize = (int)std::ceil(support) * 2 + 1;

    Taps t;
    t.ksize = ksize;
    t.first.resize(out_size);
    t.count.resize(out_size);
    t.weights.assign((size_t)out_size * ksize, 0.0f);
    for (int xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        int xmin = (int)std::max(0.0, std::floor(center - support));
        int xmax = (int)std::min((double)in_size, std::ceil(center + support));
        double sum = 0.0;
        std::vector<double> w(xmax - xmin);
        for (int x = xmin; x < xmax; x++) {
            double arg = (x - center + 0.5) / filterscale;
            double v = (std::abs(arg) < 1.0) ? 1.0 - std::abs(arg) : 0.0;
            w[x - xmin] = v;
            sum += v;
        }
        t.first[xx] = xmin;
        t.count[xx] = xmax - xmin;
        for (int i = 0; i < xmax - xmin; i++)
            t.weights[(size_t)xx * ksize + i] = (float)(sum > 0 ? w[i] / sum : 0.0);
    }
    return t;
}

}  // namespace

extern "C" {

// uint8 HWC (sh, sw, ch) -> float32 HWC (dh, dw, ch) in [0, 1].
// flip != 0 mirrors horizontally (after resize, like F.hflip on the PIL
// image — equivalent because the filter is symmetric).
void resample_to_f32(const uint8_t* src, int sh, int sw, int ch,
                     float* dst, int dh, int dw, int flip) {
    Taps hx = triangle_taps(sw, dw);
    Taps vy = triangle_taps(sh, dh);

    // horizontal pass: (sh, sw, ch) u8 -> (sh, dw, ch) f32
    std::vector<float> tmp((size_t)sh * dw * ch);
    #pragma omp parallel for schedule(static)
    for (int y = 0; y < sh; y++) {
        const uint8_t* row = src + (size_t)y * sw * ch;
        float* orow = tmp.data() + (size_t)y * dw * ch;
        if (ch == 3) {
            for (int xx = 0; xx < dw; xx++) {
                const float* w = &hx.weights[(size_t)xx * hx.ksize];
                int x0 = hx.first[xx], n = hx.count[xx];
                float a0 = 0.f, a1 = 0.f, a2 = 0.f;
                const uint8_t* p = row + (size_t)x0 * 3;
                for (int i = 0; i < n; i++, p += 3) {
                    float wi = w[i];
                    a0 += wi * p[0]; a1 += wi * p[1]; a2 += wi * p[2];
                }
                orow[(size_t)xx * 3] = a0;
                orow[(size_t)xx * 3 + 1] = a1;
                orow[(size_t)xx * 3 + 2] = a2;
            }
        } else {
            for (int xx = 0; xx < dw; xx++) {
                const float* w = &hx.weights[(size_t)xx * hx.ksize];
                int x0 = hx.first[xx], n = hx.count[xx];
                for (int c = 0; c < ch; c++) {
                    float acc = 0.f;
                    for (int i = 0; i < n; i++)
                        acc += w[i] * row[(size_t)(x0 + i) * ch + c];
                    orow[(size_t)xx * ch + c] = acc;
                }
            }
        }
    }
    // vertical pass + normalize + optional flip; vectorizes over the
    // contiguous dw*ch minor dimension
    const float inv255 = 1.0f / 255.0f;
    const int rowlen = dw * ch;
    #pragma omp parallel for schedule(static)
    for (int yy = 0; yy < dh; yy++) {
        const float* w = &vy.weights[(size_t)yy * vy.ksize];
        int y0 = vy.first[yy], n = vy.count[yy];
        float* orow = dst + (size_t)yy * rowlen;
        std::vector<float> acc(rowlen, 0.f);
        for (int i = 0; i < n; i++) {
            const float wi = w[i];
            const float* trow = tmp.data() + (size_t)(y0 + i) * rowlen;
            for (int k = 0; k < rowlen; k++) acc[k] += wi * trow[k];
        }
        if (flip) {
            for (int xx = 0; xx < dw; xx++)
                for (int c = 0; c < ch; c++)
                    orow[(size_t)(dw - 1 - xx) * ch + c] = std::min(
                        std::max(acc[(size_t)xx * ch + c] * inv255, 0.0f), 1.0f);
        } else {
            for (int k = 0; k < rowlen; k++)
                orow[k] = std::min(std::max(acc[k] * inv255, 0.0f), 1.0f);
        }
    }
}

// uint8 HWC -> float32 HWC in [0, 1], optional horizontal mirror.
// The serving path of the in-RAM resized-image cache (LaneDataset
// cache_images): steady-state epochs skip decode+resample entirely and only
// pay this normalize, so one host core feeds hundreds of images/sec.
void u8_to_unit_f32(const uint8_t* src, int h, int w, int ch,
                    float* dst, int flip) {
    const float inv255 = 1.0f / 255.0f;
    const int rowlen = w * ch;
    #pragma omp parallel for schedule(static)
    for (int y = 0; y < h; y++) {
        const uint8_t* row = src + (size_t)y * rowlen;
        float* orow = dst + (size_t)y * rowlen;
        if (flip) {
            for (int x = 0; x < w; x++) {
                const uint8_t* p = row + (size_t)x * ch;
                float* o = orow + (size_t)(w - 1 - x) * ch;
                for (int c = 0; c < ch; c++) o[c] = p[c] * inv255;
            }
        } else {
            for (int k = 0; k < rowlen; k++) orow[k] = row[k] * inv255;
        }
    }
}

// PIL-NEAREST resize of a single-channel uint8 mask.
void resize_nearest_u8(const uint8_t* src, int sh, int sw,
                       uint8_t* dst, int dh, int dw, int flip) {
    double sx = (double)sw / dw, sy = (double)sh / dh;
    std::vector<int> xmap(dw);
    for (int xx = 0; xx < dw; xx++) {
        int x = (int)(xx * sx + 1e-9 * 0 + 0.5 * sx);  // PIL center rule
        xmap[xx] = std::min(x, sw - 1);
    }
    for (int yy = 0; yy < dh; yy++) {
        int y = std::min((int)(yy * sy + 0.5 * sy), sh - 1);
        const uint8_t* row = src + (size_t)y * sw;
        uint8_t* orow = dst + (size_t)yy * dw;
        for (int xx = 0; xx < dw; xx++) {
            int ox = flip ? (dw - 1 - xx) : xx;
            orow[ox] = row[xmap[xx]];
        }
    }
}

}  // extern "C"
