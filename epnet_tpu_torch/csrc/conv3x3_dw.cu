// Weight gradient of the image tower's 3x3 SAME convolutions on Hopper
// (sm_90a), f32; plain C interface. Two kernels, one template:
//
//   D (stride 2, even H and W; SAME pads (0, 1)):
//     dw[d, e, c, f] = sum_{b,h,w} x[b, 2h + d, 2w + e, c] * dy[b, h, w, f]
//   E (stride 1; SAME pads (1, 1)):
//     dw[d, e, c, f] = sum_{b,h,w} x[b, h + d - 1, w + e - 1, c] * dy[b, h, w, f]
//
// with x read as 0 outside the image. x is (B, H, W, C), dy (B, Ho, Wo, F)
// with Ho = H / stride, dw (3, 3, C, F), all f32 and contiguous.
//
// D replaces the Pallas TPU kernels epnet_tpu/ops/conv2d.py::_dw_kernel
// (pallas_call at :346, reached with EPNET_PALLAS_DW=1) and
// tools/conv_dw_pallas_attic.py::_dw_s2_kernel (:363) and
// ::_dw_s2_stack_kernel (:220), which compute the same function. E replaces
// tools/conv_dw_pallas_attic.py::_dw_s1_kernel (:306) and
// ::_dw_s1_stack_kernel (:113); on the train path it stands where the JAX
// package runs its 9-shift weight gradient (conv2d.py::_dw_shift_s1,
// EPNET_S1_SHIFT_DW=1). The plain versions are
// epnet_tpu_torch/ops/conv2d.py::dw3x3_s2_plain and ::dw3x3_s1_plain.
//
// What bounds it on the H100: arithmetic. It is a GEMM with a small output,
// M = 9C rows (tap d, e and channel c) by N = F columns, over a long
// reduction, K = B * Ho * Wo output pixels: 491,520 at the tower's first
// block (batch 4, 384 x 1280). At the train shapes every one of the four
// stride-2 convs is 2 * 9 * C * F * K = 36.2 GFLOP and every stride-1 conv
// 72.5 GFLOP, against 0.2-0.6 GB of x and dy: about 0.54 and 1.08 ms at the
// 67 TFLOP/s f32 peak, three times the time the bytes need.
//
// Design. The TPU kernels walked row tiles in a sequential grid and kept all
// nine (C, F) slots resident in VMEM from one step to the next; Hopper blocks
// run unordered, so nothing is carried between them. Instead K is split:
// block (tile, split) owns a 128 x TN tile of the (9C, F) output (TN = 128,
// or 64 when F <= 64) and a contiguous run of K, and accumulates its tile in
// registers (16 x 16 threads, 8 x 8 or 8 x 4 values each, f32 FFMA). Per
// step of 16 pixels it stages the A tile (the 128 rows' x values: row m =
// (d * 3 + e) * C + c reads pixel (b, S*h + d - P, S*w + e - P), channel c,
// so a row's 4-channel group is one float4) and the B tile (dy rows, float4)
// in shared memory, double buffered, with the next step's global loads in
// flight while it computes. Tiles of one split are neighbours in the grid,
// so the blocks in flight read the same pixels and x and dy come from L2
// more than once but from device memory about once. Each block writes its
// tile to its own slice of a (splits, 9C, F) buffer; a second kernel sums
// the slices in split order, so dw is bitwise reproducible (no atomics).
// No TF32, no mma: tensor cores are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 128;  // output rows (tap, channel) per block
constexpr int kKc = 16;   // pixels staged per step

// Pixel k = (b * ho + h) * wo + w, stepped forward by `step` pixels.
__device__ __forceinline__ void advance(int& b, int& h, int& w, int step, int ho, int wo) {
  w += step;
  while (w >= wo) {
    w -= wo;
    if (++h == ho) {
      h = 0;
      ++b;
    }
  }
}

template <int S, int TN>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ part, int h_in, int w_in, int c, int f, int ho, int wo,
                  long long k_total, int m_tiles, int tiles, int splits) {
  constexpr int P = S == 1 ? 1 : 0;  // SAME pad before the first row / column
  constexpr int kJ = TN / 64;        // float4 column groups of a thread: 2 or 1
  constexpr int kBCols = TN / 4;     // float4 groups in a B row
  constexpr int kBRows = kThreads / kBCols;  // B rows loaded in one pass: 8 or 16
  constexpr int kBLoads = kKc / kBRows;      // 2 or 1
  __shared__ __align__(16) float as[2][kKc][kTM];
  __shared__ __align__(16) float bs[2][kKc][TN];

  const int tid = threadIdx.x;
  const int tile = blockIdx.x % tiles;
  const int split = blockIdx.x / tiles;
  const int m0 = (tile % m_tiles) * kTM;
  const int n0 = (tile / m_tiles) * TN;
  const int m_total = 9 * c;
  const long long kb = k_total * split / splits;
  const long long ke = k_total * (split + 1) / splits;

  // A loads: rows a_m .. a_m + 3 (one tap, 4 channels) at pixels
  // kb + a_kk and kb + a_kk + 8, then 16 further each step
  const int a_m = m0 + 4 * (tid & 31);
  const bool a_ok = a_m < m_total;
  const int tap = a_ok ? a_m / c : 0;
  const int a_c = a_m - tap * c;
  const int a_dh = tap / 3 - P;
  const int a_dw = tap % 3 - P;
  const int a_kk = tid >> 5;
  int pb[2], ph[2], pw[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const long long k = kb + a_kk + 8 * q;
    pw[q] = static_cast<int>(k % wo);
    const long long t = k / wo;
    ph[q] = static_cast<int>(t % ho);
    pb[q] = static_cast<int>(t / ho);
  }
  // B loads: columns b_n .. b_n + 3 of dy rows kb + b_kk + kBRows * q
  const int b_n = n0 + 4 * (tid % kBCols);
  const bool b_ok = b_n < f;
  const int b_kk = tid / kBCols;

  float4 ra[2];
  float4 rb[kBLoads];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto load = [&](long long k0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float4 v = zero;
      if (a_ok && k0 + a_kk + 8 * q < ke) {
        const int hh = S * ph[q] + a_dh;
        const int ww = S * pw[q] + a_dw;
        if (hh >= 0 && hh < h_in && ww >= 0 && ww < w_in)
          v = __ldg(reinterpret_cast<const float4*>(
              x + ((static_cast<size_t>(pb[q]) * h_in + hh) * w_in + ww) * c + a_c));
      }
      ra[q] = v;
      advance(pb[q], ph[q], pw[q], kKc, ho, wo);
    }
#pragma unroll
    for (int q = 0; q < kBLoads; ++q) {
      const long long k = k0 + b_kk + kBRows * q;
      rb[q] = (b_ok && k < ke)
                  ? __ldg(reinterpret_cast<const float4*>(dy + static_cast<size_t>(k) * f + b_n))
                  : zero;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
      *reinterpret_cast<float4*>(&as[buf][a_kk + 8 * q][4 * (tid & 31)]) = ra[q];
#pragma unroll
    for (int q = 0; q < kBLoads; ++q)
      *reinterpret_cast<float4*>(&bs[buf][b_kk + kBRows * q][4 * (tid % kBCols)]) = rb[q];
  };

  // thread (ty, tx) owns rows 4ty + i and 64 + 4ty + i, columns
  // 4tx + j (and 64 + 4tx + j when TN = 128)
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[8][4 * kJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kJ; ++j) acc[i][j] = 0.0f;

  const long long steps = (ke - kb + kKc - 1) / kKc;
  if (steps > 0) {
    load(kb);
    store(0);
    __syncthreads();
  }
  for (long long s = 0; s < steps; ++s) {
    const int buf = static_cast<int>(s & 1);
    if (s + 1 < steps) load(kb + (s + 1) * kKc);  // in flight while this step computes
#pragma unroll
    for (int kk = 0; kk < kKc; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[buf][kk][64 + 4 * ty]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int jg = 0; jg < kJ; ++jg) {
        const float4 b = *reinterpret_cast<const float4*>(&bs[buf][kk][64 * jg + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][4 * jg] = fmaf(a[i], b.x, acc[i][4 * jg]);
          acc[i][4 * jg + 1] = fmaf(a[i], b.y, acc[i][4 * jg + 1]);
          acc[i][4 * jg + 2] = fmaf(a[i], b.z, acc[i][4 * jg + 2]);
          acc[i][4 * jg + 3] = fmaf(a[i], b.w, acc[i][4 * jg + 3]);
        }
      }
    }
    if (s + 1 < steps) store(buf ^ 1);  // the other buffer was last read one step ago
    __syncthreads();
  }

  float* out = part + static_cast<size_t>(split) * m_total * f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= m_total) continue;
#pragma unroll
    for (int jg = 0; jg < kJ; ++jg) {
      const int n = n0 + 64 * jg + 4 * tx;
      if (n < f)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(m) * f + n) =
            make_float4(acc[i][4 * jg], acc[i][4 * jg + 1], acc[i][4 * jg + 2],
                        acc[i][4 * jg + 3]);
    }
  }
}

// dw[e] = sum over splits s, in order, of part[s][e].
__global__ void conv3x3_dw_reduce(const float* __restrict__ part, int splits, long long size,
                                  float* __restrict__ dw) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += part[static_cast<size_t>(s) * size + e];
  dw[e] = acc;
}

inline int tile_n(int f) { return f <= 64 ? 64 : 128; }

template <int S, int TN>
cudaError_t launch(const float* x, const float* dy, float* part, int h, int w, int c, int f,
                   int ho, int wo, long long k, int m_tiles, int tiles, int splits,
                   cudaStream_t st) {
  conv3x3_dw_kernel<S, TN><<<static_cast<unsigned>(tiles) * splits, kThreads, 0, st>>>(
      x, dy, part, h, w, c, f, ho, wo, k, m_tiles, tiles, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Output tiles of the (9c, f) weight gradient; the launch has tiles * splits
// blocks.
long long epnet_conv3x3_dw_tiles(int c, int f) {
  const long long m_tiles = (9LL * c + kTM - 1) / kTM;
  const long long n_tiles = (f + tile_n(f) - 1) / tile_n(f);
  return m_tiles * n_tiles;
}

// x (b, h, w, c), dy (b, h / stride, w / stride, f), part (splits, 9c, f)
// scratch, dw (3, 3, c, f); all float32, contiguous, 16-byte aligned.
// Needs stride 1 or 2, c and f multiples of 4, even h and w at stride 2,
// splits >= 1. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
int epnet_conv3x3_dw_launch(const void* x, const void* dy, void* part, void* dw, int b, int h,
                            int w, int c, int f, int stride, int splits, void* stream) {
  if (b < 0 || h <= 0 || w <= 0 || c <= 0 || f <= 0 || c % 4 || f % 4 || splits < 1)
    return cudaErrorInvalidValue;
  if (stride != 1 && (stride != 2 || h % 2 || w % 2)) return cudaErrorInvalidValue;
  const int ho = h / stride;
  const int wo = w / stride;
  const long long k = static_cast<long long>(b) * ho * wo;
  const int m_tiles = (9 * c + kTM - 1) / kTM;
  const long long tiles = epnet_conv3x3_dw_tiles(c, f);
  if (tiles * splits > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* dyf = static_cast<const float*>(dy);
  float* pf = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(tiles);
  cudaError_t err;
  if (stride == 2)
    err = tile_n(f) == 64 ? launch<2, 64>(xf, dyf, pf, h, w, c, f, ho, wo, k, m_tiles, t, splits, st)
                          : launch<2, 128>(xf, dyf, pf, h, w, c, f, ho, wo, k, m_tiles, t, splits, st);
  else
    err = tile_n(f) == 64 ? launch<1, 64>(xf, dyf, pf, h, w, c, f, ho, wo, k, m_tiles, t, splits, st)
                          : launch<1, 128>(xf, dyf, pf, h, w, c, f, ho, wo, k, m_tiles, t, splits, st);
  if (err != cudaSuccess) return err;
  const long long size = 9LL * c * f;
  const int threads = 256;
  conv3x3_dw_reduce<<<static_cast<unsigned>((size + threads - 1) / threads), threads, 0, st>>>(
      pf, splits, size, static_cast<float*>(dw));
  return cudaGetLastError();
}

const char* epnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
