// motionkit: native host-side helpers for the video input pipeline — the
// port's copy of the JAX package's native/motionkit.cpp (host code, not a GPU
// kernel).
//
// The moved-area mask (frame differencing + dilation + connected-component
// bounding boxes), the HSV motion score and a bilinear uint8 resize, per
// sample on the data path, over a C ABI (ctypes), no external dependencies,
// with the numerics of the numpy versions in metrics/motion.py (which stay
// the route where this cannot be built).
//
// Built at first use by data/native.py with the host compiler into
// build/motionkit/ of the checkout.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// moved_area_mask: frames (f, h, w, 3) uint8 → mask (h, w) uint8 {0,255}
//
// Pipeline (parity with metrics/motion.get_moved_area_mask):
//   gray = mean(rgb); moved = |cur-first|>th || |cur-prev|>th, accumulated;
//   2 iterations of 3x3 binary dilation; bounding box of every connected
//   component with area > area_th painted 255.
// ---------------------------------------------------------------------------
void moved_area_mask(const uint8_t* frames, int64_t f, int64_t h, int64_t w,
                     float move_th, int64_t area_th, uint8_t* out_mask) {
    const int64_t hw = h * w;
    std::vector<float> first(hw), prev(hw), cur(hw);
    std::vector<uint8_t> acc(hw, 0);

    auto grayify = [&](const uint8_t* src, float* dst) {
        for (int64_t i = 0; i < hw; ++i) {
            const uint8_t* p = src + i * 3;
            dst[i] = (float(p[0]) + float(p[1]) + float(p[2])) / 3.0f;
        }
    };
    grayify(frames, first.data());
    prev = first;
    for (int64_t t = 1; t < f; ++t) {
        grayify(frames + t * hw * 3, cur.data());
        for (int64_t i = 0; i < hw; ++i) {
            float a = std::fabs(cur[i] - first[i]);
            float b = std::fabs(cur[i] - prev[i]);
            if (a > move_th || b > move_th) acc[i] = 1;
        }
        std::swap(prev, cur);
    }

    // 2x 3x3 binary dilation
    std::vector<uint8_t> tmp(hw);
    for (int iter = 0; iter < 2; ++iter) {
        std::memcpy(tmp.data(), acc.data(), hw);
        for (int64_t y = 0; y < h; ++y) {
            const int64_t y0 = std::max<int64_t>(0, y - 1), y1 = std::min(h - 1, y + 1);
            for (int64_t x = 0; x < w; ++x) {
                if (tmp[y * w + x]) { acc[y * w + x] = 1; continue; }
                const int64_t x0 = std::max<int64_t>(0, x - 1), x1 = std::min(w - 1, x + 1);
                uint8_t v = 0;
                for (int64_t yy = y0; yy <= y1 && !v; ++yy)
                    for (int64_t xx = x0; xx <= x1; ++xx)
                        if (tmp[yy * w + xx]) { v = 1; break; }
                acc[y * w + x] = v;
            }
        }
    }

    // connected components (4-connectivity BFS) → bounding boxes
    std::memset(out_mask, 0, hw);
    std::vector<int32_t> label(hw, 0);
    std::vector<int64_t> stack;
    int32_t next_label = 0;
    for (int64_t i = 0; i < hw; ++i) {
        if (!acc[i] || label[i]) continue;
        ++next_label;
        int64_t min_y = h, max_y = -1, min_x = w, max_x = -1;
        stack.clear();
        stack.push_back(i);
        label[i] = next_label;
        while (!stack.empty()) {
            int64_t p = stack.back(); stack.pop_back();
            int64_t y = p / w, x = p % w;
            min_y = std::min(min_y, y); max_y = std::max(max_y, y);
            min_x = std::min(min_x, x); max_x = std::max(max_x, x);
            const int64_t nb[4] = {p - w, p + w, p - 1, p + 1};
            const bool ok[4] = {y > 0, y < h - 1, x > 0, x < w - 1};
            for (int k = 0; k < 4; ++k) {
                if (ok[k] && acc[nb[k]] && !label[nb[k]]) {
                    label[nb[k]] = next_label;
                    stack.push_back(nb[k]);
                }
            }
        }
        const int64_t bh = max_y - min_y + 1, bw = max_x - min_x + 1;
        if (bh * bw <= area_th) continue;
        for (int64_t y = min_y; y <= max_y; ++y)
            std::memset(out_mask + y * w + min_x, 255, bw);
    }
}

// ---------------------------------------------------------------------------
// motion_score: frames (f, h, w, 3) uint8 → round(10 × mean HSV pixel dist)
// cv2 HSV convention: H in [0,180], S,V in [0,255]; parity with
// metrics/motion.calculate_motion_score.
// ---------------------------------------------------------------------------
static inline void rgb_to_hsv_cv2(uint8_t r8, uint8_t g8, uint8_t b8,
                                  float* hh, float* ss, float* vv) {
    const float r = r8 / 255.0f, g = g8 / 255.0f, b = b8 / 255.0f;
    const float v = std::max({r, g, b});
    const float c = v - std::min({r, g, b});
    const float s = v > 0.0f ? c / std::max(v, 1e-12f) : 0.0f;
    float hdeg;
    if (c == 0.0f) hdeg = 0.0f;
    else if (v == r) hdeg = 60.0f * (g - b) / std::max(c, 1e-12f);
    else if (v == g) hdeg = 120.0f + 60.0f * (b - r) / std::max(c, 1e-12f);
    else hdeg = 240.0f + 60.0f * (r - g) / std::max(c, 1e-12f);
    hdeg = std::fmod(hdeg, 360.0f);
    if (hdeg < 0) hdeg += 360.0f;
    *hh = hdeg / 2.0f;
    *ss = s * 255.0f;
    *vv = v * 255.0f;
}

int64_t motion_score(const uint8_t* frames, int64_t f, int64_t h, int64_t w) {
    if (f < 2) return 0;
    const int64_t hw = h * w;
    std::vector<float> ph(hw), ps(hw), pv(hw), chh(hw), cs(hw), cv(hw);
    double score = 0.0;
    for (int64_t t = 0; t < f; ++t) {
        const uint8_t* src = frames + t * hw * 3;
        for (int64_t i = 0; i < hw; ++i)
            rgb_to_hsv_cv2(src[i * 3], src[i * 3 + 1], src[i * 3 + 2],
                           &chh[i], &cs[i], &cv[i]);
        if (t > 0) {
            double dh = 0, ds = 0, dv = 0;
            for (int64_t i = 0; i < hw; ++i) {
                dh += std::fabs(chh[i] - ph[i]);
                ds += std::fabs(cs[i] - ps[i]);
                dv += std::fabs(cv[i] - pv[i]);
            }
            score += (dh + ds + dv) / (3.0 * hw);
        }
        ph.swap(chh); ps.swap(cs); pv.swap(cv);
    }
    return (int64_t) std::llround(score / double(f - 1) * 10.0);
}

// resize_bilinear_u8: simple frame resize for the prefetch path
// src (h, w, 3) → dst (oh, ow, 3)
void resize_bilinear_u8(const uint8_t* src, int64_t h, int64_t w,
                        uint8_t* dst, int64_t oh, int64_t ow) {
    const float sy = float(h) / float(oh), sx = float(w) / float(ow);
    for (int64_t y = 0; y < oh; ++y) {
        const float fy = (y + 0.5f) * sy - 0.5f;
        const int64_t y0 = std::clamp<int64_t>((int64_t)std::floor(fy), 0, h - 1);
        const int64_t y1 = std::min(y0 + 1, h - 1);
        const float wy = fy - std::floor(fy);
        for (int64_t x = 0; x < ow; ++x) {
            const float fx = (x + 0.5f) * sx - 0.5f;
            const int64_t x0 = std::clamp<int64_t>((int64_t)std::floor(fx), 0, w - 1);
            const int64_t x1 = std::min(x0 + 1, w - 1);
            const float wx = fx - std::floor(fx);
            for (int c = 0; c < 3; ++c) {
                const float a = src[(y0 * w + x0) * 3 + c] * (1 - wx) + src[(y0 * w + x1) * 3 + c] * wx;
                const float b = src[(y1 * w + x0) * 3 + c] * (1 - wx) + src[(y1 * w + x1) * 3 + c] * wx;
                dst[(y * ow + x) * 3 + c] = (uint8_t)std::clamp(a * (1 - wy) + b * wy + 0.5f, 0.0f, 255.0f);
            }
        }
    }
}

}  // extern "C"
