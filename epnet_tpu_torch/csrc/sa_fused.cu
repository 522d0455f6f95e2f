// Fused set-abstraction interior on Hopper (sm_90a), forward only; plain C
// interface. Two kernels, one template, each in f32 and in bf16:
//
//   B replaces the Pallas TPU kernel epnet_tpu/ops/sa_fused.py::_fwd_kernel
//     (pallas_call at :156, reached through fused_point_mlp_max);
//   G replaces its windowed twin ::_fwd_kernel_win (pallas_call at :404,
//     reached through fused_point_mlp_max_win, the block-local RCNN sa0).
//
// Both compute
//
//   out[t, m] = max_s relu(relu(relu(Y[t, row(t,m,s)] - O[t,m]) W2 + b2) W3 + b3)
//
// with Y = [xyz, feats] W1 + b1 over each table and O = new_xyz W1[:3]
// computed outside (torch.matmul), as on the TPU. B reads row(t,m,s) =
// idx[t,m,s]; G reads row(t,m,s) = starts[t, m / TM] + idx_rel[t,m,s], where
// tile j = m / TM of TM = M / NB consecutive centroids shares one window of
// W rows of Y starting at starts[t, j]. The plain versions are
// epnet_tpu_torch/ops/sa_fused.py::fused_point_mlp_max_plain and
// ::fused_point_mlp_max_win_plain.
//
// The bf16 instances (B-bf16, G-bf16) take Y, O, W2, W3 in bf16 and b2, b3 in
// f32 and write a bf16 output: the n_splits == 1 branch of the same two
// Pallas kernels (sa_fused.py:91-93, 108-116), which the JAX package's
// MIXED_PRECISION forward reaches, and the two profiler kernels with the
// same function, tools/profile_fused_onehot.py::kern (pallas_call at :103)
// and tools/profile_fps_variants.py::kernel (:143, called with W3 = W2 and
// b3 = b2). Operands are widened to f32 as they are staged and every product
// accumulates in f32 (a product of two bf16 values is exact in f32). h1 and
// h2 are rounded to bf16 before the next product, where the Pallas kernel
// casts them (h.astype(w.dtype)); the running max stays f32 and is rounded
// once on the way out (rounding is monotone, so that equals the max of the
// rounded values). The one-hot compares of the TPU kernels, in int32, int16
// or uint16, were a TPU layout of the gather and are not part of the
// function; here rows are gathered by index.
//
// What bounds it on the H100: arithmetic. At the RCNN shapes (T=100 RoI
// tables, M*S = 8192 or 2048 rows a table, 128-256 wide layers) the two
// dense layers are 54 + 20 GFLOP a forward while the kernel reads only Y, O,
// idx and the weights; the unfused composition would also write and re-read
// three (T, M*S, C) intermediates (~420 MB each at sa0). So the work is kept
// on chip and the FFMA pipes are the limit. In bf16 the bound is the tensor
// cores' (989 TFLOP/s), which these FFMA instances do not use: tensor cores
// (mma.sync or wgmma on the bf16 operands) are a later change.
//
// Design: one block per (table t, TM = max(1, 64 / S) centroids). Rows
// (centroid, sample) are processed 64 at a time: the block gathers its rows
// of Y straight from global memory/L2 (no one-hot: that was a device of the
// TPU's matrix unit), subtracts O and applies ReLU into shared memory; layer
// 2 and layer 3 run as register-tiled f32 FFMA (each of 256 threads owns a
// 4-row x 8-column tile of a 128-column pass) against 32-row tiles of
// W2/W3 staged in shared memory; the layer-3 pass is folded into a running
// max per (centroid, channel) kept in shared memory. ReLU outputs are >= 0,
// so the max starts at 0. Shared memory at the widest RCNN stage (sa1:
// 128/128/256) is 83 KB, above the 48 KB default, hence the
// MaxDynamicSharedMemorySize attribute; the bf16 instances stage the same
// f32 tiles. No TF32 and no mma: full f32 keeps the f32 result within f32
// roundoff of the plain version.
//
// G is B with the window's row index (the template parameter kWin). On the
// TPU the window cut the one-hot matmul from N to W columns; here there is
// no one-hot, a row gather costs the same from any row of the table (a
// 512 x 128 f32 table is 256 KB, resident in L2), and the FFMA work is the
// same, so a design that stages each 256-row window in shared memory (128
// KB a block, one block an SM) would save no work; G keeps B's blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kRows = 64;       // (centroid, sample) rows per chunk
constexpr int kThreads = 256;   // 16 x 16: 4 rows x 8 columns each
constexpr int kColPass = 128;   // output columns per pass
constexpr int kKTile = 32;      // weight rows staged per step
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// v as the operand type T holds it (rounded to nearest even for bf16), in f32
template <typename T>
__device__ __forceinline__ float operand(float v);
template <>
__device__ __forceinline__ float operand<float>(float v) { return v; }
template <>
__device__ __forceinline__ float operand<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__host__ __device__ inline int row_stride_a(int c1) { return (c1 > kColPass ? c1 : kColPass) + 1; }
__host__ __device__ inline int row_stride_b(int c2) { return c2 + 1; }
inline int centroids_per_block(int s) { return s >= kRows ? 1 : kRows / s; }

inline size_t smem_bytes(int s, int c1, int c2, int c3) {
  const size_t floats = static_cast<size_t>(kRows) * (row_stride_a(c1) + row_stride_b(c2)) +
                        static_cast<size_t>(kKTile) * kColPass +
                        static_cast<size_t>(centroids_per_block(s)) * c3;
  return floats * sizeof(float);
}

// hout[r][out_col0 + c - c0] = relu(sum_k hin[r][k] w[k][c] + bias[c]) for the
// 128 columns c of the pass starting at c0 and all kRows rows, rounded to the
// operand type R (the next layer's operand). w is of type T, widened to f32
// as it is staged. Starts with a barrier, so the caller's writes to `hin` are
// visible.
template <typename T, typename R>
__device__ void dense_relu_pass(const float* hin, int ldin, int cin,
                                const T* __restrict__ w,
                                const float* __restrict__ bias, int cout, int c0,
                                float* hout, int ldout, int out_col0, float* wt) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < cin; k0 += kKTile) {
    __syncthreads();
    for (int e = tid; e < kKTile * kColPass; e += kThreads) {
      const int k = k0 + e / kColPass;
      const int c = c0 + e % kColPass;
      wt[e] = (k < cin && c < cout) ? widen(w[static_cast<size_t>(k) * cout + c]) : 0.0f;
    }
    __syncthreads();
    const int kn = min(kKTile, cin - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float a[4];
      float b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = hin[(ty * 4 + i) * ldin + k0 + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = wt[kk * kColPass + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c0 + tx + 16 * j;
    if (c < cout) {
      const float bc = __ldg(bias + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hout[(ty * 4 + i) * ldout + out_col0 + tx + 16 * j] =
            operand<R>(fmaxf(acc[i][j] + bc, 0.0f));
    }
  }
}

// kWin: idx holds window-relative rows, offset by starts (t, nb) of tiles
// of m / nb centroids, each window `window` rows long (kernel G). T: the type
// of y, o, w2, w3 and out (float or bf16); b2 and b3 are f32.
template <bool kWin, typename T>
__global__ void __launch_bounds__(kThreads)
sa_fused_fwd_kernel(const T* __restrict__ y, const T* __restrict__ o,
                    const int64_t* __restrict__ idx, const int64_t* __restrict__ starts,
                    const T* __restrict__ w2, const float* __restrict__ b2,
                    const T* __restrict__ w3, const float* __restrict__ b3,
                    T* __restrict__ out, int n, int m, int s, int c1, int c2, int c3,
                    int tm, int nb, int window) {
  extern __shared__ float smem[];
  __shared__ int64_t row_point[kRows];  // table row gathered by each chunk row
  __shared__ int row_centroid[kRows];   // its centroid, -1 for padding rows
  const int lda = row_stride_a(c1);
  const int ldb = row_stride_b(c2);
  float* ha = smem;                 // layer-1 rows, then a layer-3 pass
  float* hb = ha + kRows * lda;     // layer-2 rows
  float* wt = hb + kRows * ldb;     // staged weight tile
  float* omax = wt + kKTile * kColPass;  // running max, tm x c3

  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  const int m0 = blockIdx.y * tm;
  const T* yt = y + static_cast<size_t>(t) * n * c1;
  const T* ot = o + static_cast<size_t>(t) * m * c1;
  const int64_t* it = idx + static_cast<size_t>(t) * m * s;
  const int rows = tm * s;

  for (int e = tid; e < tm * c3; e += kThreads) omax[e] = 0.0f;

  for (int row0 = 0; row0 < rows; row0 += kRows) {
    __syncthreads();  // the previous chunk is done with ha and the row tables
    if (tid < kRows) {
      const int row = row0 + tid;
      const int mm = m0 + row / s;
      if (row < rows && mm < m) {
        int64_t p = it[static_cast<size_t>(mm) * s + row % s];
        if (kWin) {
          p = p < 0 ? 0 : (p >= window ? window - 1 : p);  // inside the window
          p += starts[static_cast<size_t>(t) * nb + mm / (m / nb)];
        }
        p = p < 0 ? 0 : (p >= n ? n - 1 : p);  // keep a bad index inside the table
        row_point[tid] = p;
        row_centroid[tid] = mm;
      } else {
        row_point[tid] = 0;
        row_centroid[tid] = -1;
      }
    }
    __syncthreads();
    for (int e = tid; e < kRows * c1; e += kThreads) {
      const int r = e / c1;
      const int c = e % c1;
      const int mm = row_centroid[r];
      ha[r * lda + c] = mm >= 0
          ? operand<T>(fmaxf(widen(yt[row_point[r] * c1 + c]) -
                                 widen(ot[static_cast<size_t>(mm) * c1 + c]),
                             0.0f))
          : 0.0f;
    }

    for (int c0 = 0; c0 < c2; c0 += kColPass)
      dense_relu_pass<T, T>(ha, lda, c1, w2, b2, c2, c0, hb, ldb, c0, wt);

    const int lm_lo = row0 / s;
    const int lm_hi = min((row0 + kRows - 1) / s, tm - 1);
    const int chunk_rows = min(kRows, rows - row0);
    for (int c0 = 0; c0 < c3; c0 += kColPass) {
      dense_relu_pass<T, float>(hb, ldb, c2, w3, b3, c3, c0, ha, lda, 0, wt);
      __syncthreads();
      for (int e = tid; e < (lm_hi - lm_lo + 1) * kColPass; e += kThreads) {
        const int lm = lm_lo + e / kColPass;
        const int cc = e % kColPass;
        const int c = c0 + cc;
        if (c >= c3 || m0 + lm >= m) continue;
        const int r_begin = max(lm * s - row0, 0);
        const int r_end = min((lm + 1) * s - row0, chunk_rows);
        float v = omax[lm * c3 + c];
        for (int r = r_begin; r < r_end; ++r) v = fmaxf(v, ha[r * lda + cc]);
        omax[lm * c3 + c] = v;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < tm * c3; e += kThreads) {
    const int mm = m0 + e / c3;
    if (mm < m) put(out + (static_cast<size_t>(t) * m + mm) * c3 + e % c3, omax[e]);
  }
}

template <bool kWin, typename T>
int launch(const void* y, const void* o, const void* idx, const void* starts, const void* w2,
           const void* b2, const void* w3, const void* b3, void* out, int t, int n, int m,
           int s, int c1, int c2, int c3, int nb, int window, void* stream) {
  if (t == 0 || m == 0) return 0;
  if (n <= 0 || s <= 0 || c1 <= 0 || c2 <= 0 || c3 <= 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(s, c1, c2, c3);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const int tm = centroids_per_block(s);
  const int blocks_m = (m + tm - 1) / tm;
  if (blocks_m > 65535) return cudaErrorInvalidValue;
  auto kernel = &sa_fused_fwd_kernel<kWin, T>;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), kMaxSmem, smem_set, true);
  if (err != cudaSuccess) return err;
  const dim3 grid(t, blocks_m);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(o),
      static_cast<const int64_t*>(idx), static_cast<const int64_t*>(starts),
      static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<const T*>(w3), static_cast<const float*>(b3), static_cast<T*>(out), n,
      m, s, c1, c2, c3, tm, nb, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs; above 232448 bytes the launch is refused.
long long epnet_sa_fused_smem_bytes(int s, int c1, int c2, int c3) {
  return static_cast<long long>(smem_bytes(s, c1, c2, c3));
}

// y (t, n, c1), o (t, m, c1), idx (t, m, s) int64, w2 (c1, c2), b2 (c2),
// w3 (c2, c3), b3 (c3), out (t, m, c3); all float32 except idx, contiguous.
// Launches kernel B on `stream`, allocates nothing, returns
// cudaGetLastError().
int epnet_sa_fused_fwd_launch(const void* y, const void* o, const void* idx,
                              const void* w2, const void* b2, const void* w3,
                              const void* b3, void* out, int t, int n, int m,
                              int s, int c1, int c2, int c3, void* stream) {
  return launch<false, float>(y, o, idx, nullptr, w2, b2, w3, b3, out, t, n, m, s, c1, c2, c3,
                              1, 0, stream);
}

// B-bf16: as above with y, o, w2, w3 and out bf16; b2, b3 float32.
int epnet_sa_fused_fwd_bf16_launch(const void* y, const void* o, const void* idx,
                                   const void* w2, const void* b2, const void* w3,
                                   const void* b3, void* out, int t, int n, int m,
                                   int s, int c1, int c2, int c3, void* stream) {
  return launch<false, __nv_bfloat16>(y, o, idx, nullptr, w2, b2, w3, b3, out, t, n, m, s, c1,
                                      c2, c3, 1, 0, stream);
}

// Kernel G: as above with idx (t, m, s) int64 window-relative rows in
// [0, window) and starts (t, nb) int64, the first table row of the window
// of each tile of m / nb centroids; nb must divide m, window <= n.
int epnet_sa_fused_win_fwd_launch(const void* y, const void* o, const void* idx,
                                  const void* starts, const void* w2, const void* b2,
                                  const void* w3, const void* b3, void* out, int t, int n,
                                  int m, int s, int c1, int c2, int c3, int nb, int window,
                                  void* stream) {
  if (nb <= 0 || m % nb != 0 || window <= 0 || window > n) return cudaErrorInvalidValue;
  return launch<true, float>(y, o, idx, starts, w2, b2, w3, b3, out, t, n, m, s, c1, c2, c3, nb,
                             window, stream);
}

// G-bf16: kernel G with y, o, w2, w3 and out bf16; b2, b3 float32.
int epnet_sa_fused_win_fwd_bf16_launch(const void* y, const void* o, const void* idx,
                                       const void* starts, const void* w2, const void* b2,
                                       const void* w3, const void* b3, void* out, int t, int n,
                                       int m, int s, int c1, int c2, int c3, int nb, int window,
                                       void* stream) {
  if (nb <= 0 || m % nb != 0 || window <= 0 || window > n) return cudaErrorInvalidValue;
  return launch<true, __nv_bfloat16>(y, o, idx, starts, w2, b2, w3, b3, out, t, n, m, s, c1, c2,
                                     c3, nb, window, stream);
}

const char* epnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
