// Host-side kernels of the input pipeline: the port's own copy of
// native/host_ops.cpp, the counterpart of the reference's CPU extension
// (lib/utils/roipool3d/src/roipool3d.cpp:82-196). The data loader's
// geometric tests (point-in-rotated-box masks for the gt-paste
// augmentation, RoI pooling of the offline RCNN samples) run in C++ in the
// loader's worker processes. Plain C interface, loaded with ctypes.
//
// Built at first use by epnet_tpu_torch/data/native.py with native/Makefile's
// flags (g++ -O3 -march=native -fPIC -shared -std=c++17; ISO C++ keeps
// floating-point contraction off, so both libraries compute the same bits).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// pts: (N, 3) rect coords; boxes: (M, 7) [x, y, z, h, w, l, ry]
// out: (M, N) uint8 membership mask
void pts_in_boxes3d_cpu(const float* pts, int64_t n,
                        const float* boxes, int64_t m,
                        uint8_t* out) {
    for (int64_t b = 0; b < m; ++b) {
        const float cx = boxes[b * 7 + 0];
        const float by = boxes[b * 7 + 1];
        const float cz = boxes[b * 7 + 2];
        const float h = boxes[b * 7 + 3];
        const float w = boxes[b * 7 + 4];
        const float l = boxes[b * 7 + 5];
        const float ry = boxes[b * 7 + 6];
        const float c = std::cos(ry), s = std::sin(ry);
        uint8_t* row = out + b * n;
        for (int64_t i = 0; i < n; ++i) {
            const float px = pts[i * 3 + 0] - cx;
            const float py = pts[i * 3 + 1] - by;
            const float pz = pts[i * 3 + 2] - cz;
            if (std::fabs(py + h * 0.5f) > h * 0.5f) { row[i] = 0; continue; }
            const float xr = px * c - pz * s;
            const float zr = px * s + pz * c;
            row[i] = (std::fabs(xr) <= l * 0.5f) && (std::fabs(zr) <= w * 0.5f);
        }
    }
}

// RoI pooling on host for the offline RCNN flow
// (roipool3d.cpp:133-196): gathers the first `spn` in-box points per box
// (cyclic repeat when fewer), writing (M, spn, 3 + c) features and an
// empty flag per box.
void roipool3d_cpu(const float* pts, const float* feats, int64_t n, int64_t c,
                   const float* boxes, int64_t m, int64_t spn,
                   float* out, int32_t* empty_flag) {
    for (int64_t b = 0; b < m; ++b) {
        const float cx = boxes[b * 7 + 0];
        const float by = boxes[b * 7 + 1];
        const float cz = boxes[b * 7 + 2];
        const float h = boxes[b * 7 + 3];
        const float w = boxes[b * 7 + 4];
        const float l = boxes[b * 7 + 5];
        const float ry = boxes[b * 7 + 6];
        const float co = std::cos(ry), si = std::sin(ry);
        float* dst = out + b * spn * (3 + c);
        int64_t cnt = 0;
        for (int64_t i = 0; i < n && cnt < spn; ++i) {
            const float px = pts[i * 3 + 0] - cx;
            const float py = pts[i * 3 + 1] - by;
            const float pz = pts[i * 3 + 2] - cz;
            if (std::fabs(py + h * 0.5f) > h * 0.5f) continue;
            const float xr = px * co - pz * si;
            const float zr = px * si + pz * co;
            if (std::fabs(xr) > l * 0.5f || std::fabs(zr) > w * 0.5f) continue;
            float* slot = dst + cnt * (3 + c);
            std::memcpy(slot, pts + i * 3, 3 * sizeof(float));
            std::memcpy(slot + 3, feats + i * c, c * sizeof(float));
            ++cnt;
        }
        empty_flag[b] = (cnt == 0);
        if (cnt > 0) {
            for (int64_t k = cnt; k < spn; ++k) {
                std::memcpy(dst + k * (3 + c), dst + (k % cnt) * (3 + c),
                            (3 + c) * sizeof(float));
            }
        } else {
            std::memset(dst, 0, spn * (3 + c) * sizeof(float));
        }
    }
}

}  // extern "C"
