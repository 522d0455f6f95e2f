// Forward of the image tower's 3x3 SAME stride-2 convolution on Hopper
// (sm_90a), f32; plain C interface. Kernel F:
//
//   y[b, h, w, f] = sum_{d, e in 0..2, c} x[b, 2h + d, 2w + e, c] * K[d, e, c, f]
//
// with x read as 0 past row H - 1 or column W - 1 (XLA's SAME pads (0, 1) for
// even H and W). x is (B, H, W, C), K (3, 3, C, F), y (B, H / 2, W / 2, F),
// all f32 and contiguous; C and F multiples of 4.
//
// Replaces the Pallas TPU kernel tools/conv_fwd_attic.py::_fwd_s2_kernel
// (pallas_call at :154), which stacks the nine stride-2 phase views of a row
// tile into one (tm * W/2, 9C) x (9C, F) MXU dot. The plain version is
// epnet_tpu_torch/ops/conv2d.py::conv3x3_s2_fwd_plain.
//
// What bounds it on the H100: arithmetic. It is an implicit GEMM, M = B * H/2
// * W/2 output pixels by N = F channels over K = 9C. Each of the tower's four
// stride-2 convs is 2 * M * 9C * F = 9.06 GFLOP an image against 0.04-0.16 GB
// of x and y: 0.135 ms at the 67 TFLOP/s f32 peak by the direct count, about
// three times what the bytes need.
//
// Design. The TPU kernel built the stacked (tm * W/2, 9C) operand in VMEM;
// here nothing is stacked. A block owns a tile of 128 output pixels by TN
// output channels (TN = 128, or 64 when F <= 64) and accumulates it in
// registers (16 x 16 threads, 8 x 8 or 8 x 4 values each, f32 FFMA). It walks
// K in a fixed order, tap (d, e) then 16-channel chunk. Per step it stages the
// A tile (each pixel's 16 channels of tap (d, e), read as float4s at
// (b, 2h + d, 2w + e); the SAME pad is a bounds test) transposed into shared
// memory, and the B tile (16 rows of K, float4 along F), double buffered with
// the next step's global loads in flight while it computes. When the pixel
// tiles alone cannot fill the card (the deep convs at batch 1: blk3 has 60
// tiles), the wrapper splits K: each split writes its own slice of a
// (splits, M, F) buffer and a second kernel sums the slices in split order.
// No atomics: y is bitwise reproducible. No TF32, no mma: tensor cores, TMA
// and Winograd are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 128;  // output pixels per block
constexpr int kKc = 16;   // channels of one tap staged per step

template <int TN>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_s2_fwd_kernel(const float* __restrict__ x, const float* __restrict__ k,
                      float* __restrict__ out, int h_in, int w_in, int c, int f, int m_total,
                      int m_tiles, int tiles, int splits, int c_chunks) {
  constexpr int kJ = TN / 64;                // float4 column groups of a thread: 2 or 1
  constexpr int kBCols = TN / 4;             // float4 groups in a B row
  constexpr int kBRows = kThreads / kBCols;  // B rows loaded in one pass: 8 or 16
  constexpr int kBLoads = kKc / kBRows;      // 2 or 1
  __shared__ __align__(16) float as[2][kKc][kTM];
  __shared__ __align__(16) float bs[2][kKc][TN];

  const int tid = threadIdx.x;
  const int tile = blockIdx.x % tiles;
  const int split = blockIdx.x / tiles;
  const int m0 = (tile % m_tiles) * kTM;
  const int n0 = (tile / m_tiles) * TN;
  const int steps_total = 9 * c_chunks;
  const int sb = static_cast<int>(static_cast<long long>(steps_total) * split / splits);
  const int se = static_cast<int>(static_cast<long long>(steps_total) * (split + 1) / splits);
  const int ho = h_in / 2;
  const int wo = w_in / 2;

  // A loads: this thread's pixel a_m (fixed over K), channel groups a_g and
  // a_g + 2 of the step's four float4 groups
  const int a_row = tid & (kTM - 1);
  const int a_m = m0 + a_row;
  const bool a_ok = a_m < m_total;
  const int a_g = tid >> 7;
  int pb = 0, ph = 0, pw = 0;
  if (a_ok) {
    pw = a_m % wo;
    const int t = a_m / wo;
    ph = t % ho;
    pb = t / ho;
  }
  const float* a_base = x + ((static_cast<size_t>(pb) * h_in + 2 * ph) * w_in + 2 * pw) * c;
  const bool row2_ok = 2 * ph + 2 < h_in;  // tap d = 2 of the last output row reads the pad
  const bool col2_ok = 2 * pw + 2 < w_in;
  // B loads: columns b_n .. b_n + 3 of K rows (tap, c0 + b_kk + kBRows * q)
  const int b_n = n0 + 4 * (tid % kBCols);
  const bool b_ok = b_n < f;
  const int b_kk = tid / kBCols;

  float4 ra[2];
  float4 rb[kBLoads];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto load = [&](int s) {
    const int tap = s / c_chunks;
    const int c0 = (s - tap * c_chunks) * kKc;
    const int d = tap / 3;
    const int e = tap - 3 * d;
    const bool in = a_ok && (d < 2 || row2_ok) && (e < 2 || col2_ok);
    const float* src = a_base + (static_cast<size_t>(d) * w_in + e) * c;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int ch = c0 + 4 * (a_g + 2 * q);
      ra[q] = (in && ch < c) ? __ldg(reinterpret_cast<const float4*>(src + ch)) : zero;
    }
#pragma unroll
    for (int q = 0; q < kBLoads; ++q) {
      const int ch = c0 + b_kk + kBRows * q;
      rb[q] = (b_ok && ch < c)
                  ? __ldg(reinterpret_cast<const float4*>(
                        k + (static_cast<size_t>(tap) * c + ch) * f + b_n))
                  : zero;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int kk = 4 * (a_g + 2 * q);
      as[buf][kk][a_row] = ra[q].x;
      as[buf][kk + 1][a_row] = ra[q].y;
      as[buf][kk + 2][a_row] = ra[q].z;
      as[buf][kk + 3][a_row] = ra[q].w;
    }
#pragma unroll
    for (int q = 0; q < kBLoads; ++q)
      *reinterpret_cast<float4*>(&bs[buf][b_kk + kBRows * q][4 * (tid % kBCols)]) = rb[q];
  };

  // thread (ty, tx) owns pixels 4ty + i and 64 + 4ty + i, channels 4tx + j
  // (and 64 + 4tx + j when TN = 128)
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[8][4 * kJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kJ; ++j) acc[i][j] = 0.0f;

  if (sb < se) {
    load(sb);
    store(0);
    __syncthreads();
  }
  for (int s = sb; s < se; ++s) {
    const int buf = (s - sb) & 1;
    if (s + 1 < se) load(s + 1);  // in flight while this step computes
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
    if (s + 1 < se) store(buf ^ 1);  // the other buffer was last read one step ago
    __syncthreads();
  }

  float* dst = out + static_cast<size_t>(split) * m_total * f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= m_total) continue;
#pragma unroll
    for (int jg = 0; jg < kJ; ++jg) {
      const int n = n0 + 64 * jg + 4 * tx;
      if (n < f)
        *reinterpret_cast<float4*>(dst + static_cast<size_t>(m) * f + n) =
            make_float4(acc[i][4 * jg], acc[i][4 * jg + 1], acc[i][4 * jg + 2],
                        acc[i][4 * jg + 3]);
    }
  }
}

// y[e] = sum over splits s, in order, of part[s][e].
__global__ void conv3x3_s2_fwd_reduce(const float* __restrict__ part, int splits,
                                      long long size, float* __restrict__ y) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += part[static_cast<size_t>(s) * size + e];
  y[e] = acc;
}

inline int tile_n(int f) { return f <= 64 ? 64 : 128; }

template <int TN>
cudaError_t launch(const float* x, const float* k, float* out, int h, int w, int c, int f,
                   int m_total, int m_tiles, int tiles, int splits, int c_chunks,
                   cudaStream_t st) {
  conv3x3_s2_fwd_kernel<TN><<<static_cast<unsigned>(tiles) * splits, kThreads, 0, st>>>(
      x, k, out, h, w, c, f, m_total, m_tiles, tiles, splits, c_chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Output tiles of the (b * h/2 * w/2, f) result; the launch has tiles *
// splits blocks.
long long epnet_conv3x3_s2_fwd_tiles(int b, int h, int w, int f) {
  const long long m = static_cast<long long>(b) * (h / 2) * (w / 2);
  return ((m + kTM - 1) / kTM) * ((f + tile_n(f) - 1) / tile_n(f));
}

// Steps of K (tap, 16-channel chunk) that the splits share.
int epnet_conv3x3_s2_fwd_steps(int c) { return 9 * ((c + kKc - 1) / kKc); }

// x (b, h, w, c), k (3, 3, c, f), y (b, h / 2, w / 2, f); with splits > 1,
// part (splits, b * h/2 * w/2, f) scratch (unused, may be null, when splits
// is 1). All float32, contiguous, 16-byte aligned. Needs b >= 1, even h and
// w, c and f multiples of 4, 1 <= splits <= the steps of K. Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
int epnet_conv3x3_s2_fwd_launch(const void* x, const void* k, void* part, void* y, int b, int h,
                                int w, int c, int f, int splits, void* stream) {
  if (b < 1 || h < 2 || w < 2 || h % 2 || w % 2 || c <= 0 || f <= 0 || c % 4 || f % 4)
    return cudaErrorInvalidValue;
  const int c_chunks = (c + kKc - 1) / kKc;
  if (splits < 1 || splits > 9 * c_chunks || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const long long m = static_cast<long long>(b) * (h / 2) * (w / 2);
  const long long tiles = epnet_conv3x3_s2_fwd_tiles(b, h, w, f);
  if (m > 0x7fffffffLL || tiles * splits > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int m_tiles = static_cast<int>((m + kTM - 1) / kTM);
  const float* xf = static_cast<const float*>(x);
  const float* kf = static_cast<const float*>(k);
  float* out = static_cast<float*>(splits > 1 ? part : y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(tiles);
  const int mi = static_cast<int>(m);
  cudaError_t err =
      tile_n(f) == 64 ? launch<64>(xf, kf, out, h, w, c, f, mi, m_tiles, t, splits, c_chunks, st)
                      : launch<128>(xf, kf, out, h, w, c, f, mi, m_tiles, t, splits, c_chunks, st);
  if (err != cudaSuccess || splits == 1) return err;
  const long long size = m * f;
  const int threads = 256;
  conv3x3_s2_fwd_reduce<<<static_cast<unsigned>((size + threads - 1) / threads), threads, 0,
                          st>>>(static_cast<const float*>(part), splits, size,
                                static_cast<float*>(y));
  return cudaGetLastError();
}

const char* epnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
