// Backward of the fused set-abstraction interior on Hopper (sm_90a), f32;
// plain C interface. Two kernels, one template:
//
//   C replaces the Pallas TPU kernel epnet_tpu/ops/sa_fused.py::_bwd_kernel
//     (pallas_call at :285, reached through the custom VJP of
//     fused_point_mlp_max);
//   H replaces its windowed twin ::_bwd_kernel_win (pallas_call at :528,
//     the custom VJP of fused_point_mlp_max_win).
//
// For the forward
//
//   out[t, m] = max_s relu(relu(relu(Y[t, row] - O[t,m]) W2 + b2) W3 + b3)
//
// with row = idx[t,m,s] (C) or starts[t, m / TM] + idx_rel[t,m,s] (H: TM =
// M / NB consecutive centroids share a window of Y, see csrc/sa_fused.cu),
// it recomputes each row (g1 = Y[row] - O, h1, p2, h2, p3, h3) and pushes
// gout back:
//
//   dh3 = [h3 == max_s h3] gout / count of tied rows   (split evenly)
//   dp3 = [p3 > 0] dh3;  dW3 += h2^T dp3;  db3 += sum dp3;  dh2 = dp3 W3^T
//   dp2 = [p2 > 0] dh2;  dW2 += h1^T dp2;  db2 += sum dp2;  dh1 = dp2 W2^T
//   dp1 = [g1 > 0] dh1;  dY[t, row] += dp1 (scatter-add);  dO[t, m] = -sum_s dp1
//
// The plain versions are
// epnet_tpu_torch/ops/sa_fused.py::fused_point_mlp_max_bwd_plain and
// ::fused_point_mlp_max_win_bwd_plain.
//
// What bounds it on the H100: arithmetic. At the train shapes (T = 256 RoI
// tables; sa0 M*S = 8192 rows a table at 128/128/128, sa1 2048 rows at
// 128/128/256) the recompute and the four products are ~410 + ~155 GFLOP a
// step, while the plain composition writes and re-reads several (T, M*S, C)
// tensors of ~1 GB each at sa0. Everything per row stays in shared memory
// and registers; the FFMA pipes are the limit.
//
// Design: a block owns a contiguous run of units; a unit is TM = 64 / S
// whole centroids (S <= 64), so the max, its tie count and dO of a
// centroid are complete inside one chunk of <= 64 rows. Per chunk the block
// gathers its rows of Y from global memory/L2, recomputes layers 2-3 with
// the register-tiled f32 FFMA of csrc/sa_fused.cu (16 x 16 threads, 4 rows
// x 8 columns each, 32-row weight tiles staged in shared memory), turns h3
// into dp3 in place, and runs the three backward products the same way
// (the transposed weights are staged transposed). dW/db do not fit in
// shared memory beside the row tiles (48K floats at sa1), so each block
// accumulates them in its own slice of a global buffer (read-modify-write
// per chunk, each element owned by one thread: no atomics); a second kernel
// sums the slices in block order, so dW/db are bitwise deterministic. dY
// is an atomicAdd into a zeroed (T, N, C1) and is deterministic only up to
// the order of the f32 additions. dO is written directly. No TF32, no mma.
//
// H is C with the window's row index (template parameter kWin). The windows
// of consecutive tiles of one RoI overlap, and the TPU kernel added each
// tile's (W, C1) contribution into the RoI's dY in grid order; here every
// row's contribution is an atomicAdd into the RoI's whole (N, C1) table,
// so overlapping windows add up and nothing is overwritten.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 64;       // (centroid, sample) rows per chunk
constexpr int kThreads = 256;   // 16 x 16
constexpr int kColPass = 128;   // output columns per pass
constexpr int kKTile = 32;      // weight rows staged per step
constexpr int kWtLd = kColPass + 1;
constexpr int kStaticSmem = kRows * (sizeof(int64_t) + sizeof(int));
constexpr int kMaxSmem = 232448;

inline size_t smem_bytes(int c1, int c2, int c3) {
  const size_t floats = static_cast<size_t>(kRows) * ((c1 + 1) + (c2 + 1) + (c3 + 1)) +
                        static_cast<size_t>(kKTile) * kWtLd;
  return floats * sizeof(float);
}

__host__ __device__ inline long long partial_floats(int c1, int c2, int c3) {
  return static_cast<long long>(c1) * c2 + c2 + static_cast<long long>(c2) * c3 + c3;
}

// acc[i][j] = sum_k hin[(ty*4 + i) * ldin + k] * B(k, c0 + tx + 16 j) over
// k < cin, with B(k, c) = w[k * cout + c] or, kTrans, w[c * cin + k] (the
// transpose of a (cout, cin) weight). Starts with a barrier, so the
// caller's writes to `hin` are visible and `wt` is free.
template <bool kTrans>
__device__ __forceinline__ void dense_pass(const float* hin, int ldin, int cin,
                                           const float* __restrict__ w, int cout, int c0,
                                           float* wt, float (&acc)[4][8]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < cin; k0 += kKTile) {
    __syncthreads();
    for (int e = tid; e < kKTile * kColPass; e += kThreads) {
      // consecutive threads read consecutive global addresses either way
      const int k = kTrans ? e % kKTile : e / kColPass;
      const int c = kTrans ? e / kKTile : e % kColPass;
      const int gk = k0 + k;
      const int gc = c0 + c;
      float v = 0.0f;
      if (gk < cin && gc < cout)
        v = kTrans ? __ldg(w + static_cast<size_t>(gc) * cin + gk)
                   : __ldg(w + static_cast<size_t>(gk) * cout + gc);
      wt[k * kWtLd + c] = v;
    }
    __syncthreads();
    const int kn = min(kKTile, cin - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float a[4];
      float b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = hin[(ty * 4 + i) * ldin + k0 + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = wt[kk * kWtLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// part[a][b] += sum_r A[r][a] * B[r][b] over the kRows rows, for the
// 128 x 128 tile at (a0, b0) of the (ca, cb) weight gradient. Thread
// (ty, tx) owns a = a0 + ty + 16 i, b = b0 + tx + 16 j; no other thread of
// any block touches those elements of this block's slice.
__device__ __forceinline__ void wgrad_tile(const float* A, int lda, int ca, int a0,
                                           const float* B, int ldb, int cb, int b0,
                                           float* __restrict__ part) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[8][8];
  bool ok_a[8];
  bool ok_b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ok_a[i] = a0 + ty + 16 * i < ca;
    ok_b[i] = b0 + tx + 16 * i < cb;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  for (int r = 0; r < kRows; ++r) {
    float a[8];
    float b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = ok_a[i] ? A[r * lda + a0 + ty + 16 * i] : 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = ok_b[j] ? B[r * ldb + b0 + tx + 16 * j] : 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (ok_a[i] && ok_b[j])
        part[static_cast<size_t>(a0 + ty + 16 * i) * cb + b0 + tx + 16 * j] += acc[i][j];
}

// one block a multiprocessor (shared memory allows no more), so the full
// register file is there for it. kWin: idx holds window-relative rows,
// offset by starts (t, nb) of tiles of m / nb centroids (kernel H)
template <bool kWin>
__global__ void __launch_bounds__(kThreads, 1)
sa_fused_bwd_kernel(const float* __restrict__ y, const float* __restrict__ o,
                    const int64_t* __restrict__ idx, const int64_t* __restrict__ starts,
                    const float* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ w3,
                    const float* __restrict__ b3, const float* __restrict__ gout,
                    float* __restrict__ dy, float* __restrict__ dout_o,
                    float* __restrict__ part, int n, int m, int s, int c1, int c2, int c3,
                    int tm, int blocks_m, long long units, int nb, int window) {
  extern __shared__ float smem[];
  __shared__ int64_t row_point[kRows];  // table row gathered by each chunk row
  __shared__ int row_centroid[kRows];   // its centroid, -1 for padding rows
  const int lda = c1 + 1;
  const int ldb = c2 + 1;
  const int ldc = c3 + 1;
  float* ha = smem;                // h1, then dp1
  float* hb = ha + kRows * lda;    // h2, then dp2
  float* hc = hb + kRows * ldb;    // h3, then dp3
  float* wt = hc + kRows * ldc;    // staged weight tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float* pw2 = part + static_cast<size_t>(blockIdx.x) * partial_floats(c1, c2, c3);
  float* pb2 = pw2 + static_cast<size_t>(c1) * c2;
  float* pw3 = pb2 + c2;
  float* pb3 = pw3 + static_cast<size_t>(c2) * c3;
  for (long long e = tid; e < partial_floats(c1, c2, c3); e += kThreads) pw2[e] = 0.0f;

  const long long u_begin = units * blockIdx.x / gridDim.x;
  const long long u_end = units * (blockIdx.x + 1) / gridDim.x;
  float acc[4][8];
  for (long long u = u_begin; u < u_end; ++u) {
    const int t = static_cast<int>(u / blocks_m);
    const int m0 = static_cast<int>(u % blocks_m) * tm;
    const float* yt = y + static_cast<size_t>(t) * n * c1;
    const float* ot = o + static_cast<size_t>(t) * m * c1;
    const int64_t* it = idx + static_cast<size_t>(t) * m * s;
    const float* gt = gout + static_cast<size_t>(t) * m * c3;
    float* dyt = dy + static_cast<size_t>(t) * n * c1;
    float* dot = dout_o + static_cast<size_t>(t) * m * c1;

    __syncthreads();  // the previous unit is done with every buffer (and the zeroing)
    if (tid < kRows) {
      const int mm = m0 + tid / s;
      if (tid < tm * s && mm < m) {
        int64_t p = it[static_cast<size_t>(mm) * s + tid % s];
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
          ? fmaxf(yt[row_point[r] * c1 + c] - ot[static_cast<size_t>(mm) * c1 + c], 0.0f)
          : 0.0f;
    }

    // recompute h2 = relu(h1 W2 + b2) and h3 = relu(h2 W3 + b3)
    for (int c0 = 0; c0 < c2; c0 += kColPass) {
      dense_pass<false>(ha, lda, c1, w2, c2, c0, wt, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c < c2) {
          const float bc = __ldg(b2 + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) hb[(ty * 4 + i) * ldb + c] = fmaxf(acc[i][j] + bc, 0.0f);
        }
      }
    }
    for (int c0 = 0; c0 < c3; c0 += kColPass) {
      dense_pass<false>(hb, ldb, c2, w3, c3, c0, wt, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c < c3) {
          const float bc = __ldg(b3 + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) hc[(ty * 4 + i) * ldc + c] = fmaxf(acc[i][j] + bc, 0.0f);
        }
      }
    }
    __syncthreads();

    // max backward: dp3 = [p3 > 0][h3 == max] gout / ties, in place; db3
    for (int c = tid; c < c3; c += kThreads) {
      float db = 0.0f;
      for (int lm = 0; lm < tm; ++lm) {
        const int mm = m0 + lm;
        const int r0 = lm * s;
        if (mm >= m) {
          for (int r = r0; r < r0 + s; ++r) hc[r * ldc + c] = 0.0f;
          continue;
        }
        float mx = hc[r0 * ldc + c];
        for (int r = r0 + 1; r < r0 + s; ++r) mx = fmaxf(mx, hc[r * ldc + c]);
        float cnt = 0.0f;
        for (int r = r0; r < r0 + s; ++r) cnt += hc[r * ldc + c] == mx ? 1.0f : 0.0f;
        const float g = gt[static_cast<size_t>(mm) * c3 + c] / cnt;
        for (int r = r0; r < r0 + s; ++r) {
          const float v = hc[r * ldc + c];
          const float d = (v > 0.0f && v == mx) ? g : 0.0f;
          hc[r * ldc + c] = d;
          db += d;
        }
      }
      for (int r = tm * s; r < kRows; ++r) hc[r * ldc + c] = 0.0f;
      pb3[c] += db;
    }
    __syncthreads();

    // dW3 += h2^T dp3
    for (int a0 = 0; a0 < c2; a0 += kColPass)
      for (int b0 = 0; b0 < c3; b0 += kColPass) wgrad_tile(hb, ldb, c2, a0, hc, ldc, c3, b0, pw3);

    // dp2 = [p2 > 0] (dp3 W3^T), in place of h2
    for (int c0 = 0; c0 < c2; c0 += kColPass) {
      dense_pass<true>(hc, ldc, c3, w3, c2, c0, wt, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c < c2) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* h = hb + (ty * 4 + i) * ldb + c;
            *h = *h > 0.0f ? acc[i][j] : 0.0f;
          }
        }
      }
    }
    __syncthreads();
    for (int c = tid; c < c2; c += kThreads) {
      float db = 0.0f;
      for (int r = 0; r < kRows; ++r) db += hb[r * ldb + c];
      pb2[c] += db;
    }

    // dW2 += h1^T dp2
    for (int a0 = 0; a0 < c1; a0 += kColPass)
      for (int b0 = 0; b0 < c2; b0 += kColPass) wgrad_tile(ha, lda, c1, a0, hb, ldb, c2, b0, pw2);

    // dp1 = [g1 > 0] (dp2 W2^T), in place of h1, scattered into dY
    for (int c0 = 0; c0 < c1; c0 += kColPass) {
      dense_pass<true>(hb, ldb, c2, w2, c1, c0, wt, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c < c1) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = ty * 4 + i;
            float* h = ha + r * lda + c;
            const float d = *h > 0.0f ? acc[i][j] : 0.0f;
            *h = d;
            if (d != 0.0f) atomicAdd(dyt + row_point[r] * c1 + c, d);
          }
        }
      }
    }
    __syncthreads();

    // dO = -sum_s dp1
    for (int e = tid; e < tm * c1; e += kThreads) {
      const int lm = e / c1;
      const int c = e % c1;
      const int mm = m0 + lm;
      if (mm >= m) continue;
      float sum = 0.0f;
      for (int r = lm * s; r < (lm + 1) * s; ++r) sum += ha[r * lda + c];
      dot[static_cast<size_t>(mm) * c1 + c] = -sum;
    }
  }
}

// out[e] = sum over blocks b, in order, of part[b][e].
__global__ void sa_fused_bwd_reduce(const float* __restrict__ part, int blocks, long long size,
                                    float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float acc = 0.0f;
  for (int b = 0; b < blocks; ++b) acc += part[static_cast<size_t>(b) * size + e];
  out[e] = acc;
}

template <bool kWin>
int launch(const void* y, const void* o, const void* idx, const void* starts, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* gout, void* dy, void* d_o,
           void* part, void* grads, int t, int n, int m, int s, int c1, int c2, int c3,
           int blocks, int nb, int window, void* stream) {
  if (n <= 0 || s <= 0 || s > kRows || c1 <= 0 || c2 <= 0 || c3 <= 0 || t < 0 || m < 0)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(c1, c2, c3);
  if (smem + kStaticSmem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const int tm = kRows / s;
  const int blocks_m = (m + tm - 1) / tm;
  const long long units = static_cast<long long>(t) * blocks_m;
  const long long size = partial_floats(c1, c2, c3);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (units > 0) {
    if (blocks < 1 || blocks > units) return cudaErrorInvalidValue;
    auto kernel = &sa_fused_bwd_kernel<kWin>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, smem, st>>>(
        static_cast<const float*>(y), static_cast<const float*>(o),
        static_cast<const int64_t*>(idx), static_cast<const int64_t*>(starts),
        static_cast<const float*>(w2), static_cast<const float*>(b2),
        static_cast<const float*>(w3), static_cast<const float*>(b3),
        static_cast<const float*>(gout), static_cast<float*>(dy), static_cast<float*>(d_o),
        static_cast<float*>(part), n, m, s, c1, c2, c3, tm, blocks_m, units, nb, window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  } else {
    blocks = 0;  // no rows: the gradients of the weights are zero
  }
  const int threads = 256;
  const long long grid = (size + threads - 1) / threads;
  sa_fused_bwd_reduce<<<static_cast<unsigned>(grid), threads, 0, st>>>(
      static_cast<const float*>(part), blocks, size, static_cast<float*>(grads));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs (dynamic part); above the limit the launch
// is refused.
long long epnet_sa_fused_bwd_smem_bytes(int c1, int c2, int c3) {
  return static_cast<long long>(smem_bytes(c1, c2, c3));
}

// Floats of one block's dW2 | db2 | dW3 | db3 slice.
long long epnet_sa_fused_bwd_partial_floats(int c1, int c2, int c3) {
  return partial_floats(c1, c2, c3);
}

// y (t, n, c1), o (t, m, c1), idx (t, m, s) int64, w2 (c1, c2), b2 (c2),
// w3 (c2, c3), b3 (c3), gout (t, m, c3); dy (t, n, c1) ZEROED by the
// caller, d_o (t, m, c1); part (blocks, partial_floats) scratch; grads
// (partial_floats) receives dW2 | db2 | dW3 | db3. All float32 except idx,
// contiguous. Needs s <= 64 and 1 <= blocks <= t * ceil(m / (64 / s)).
// Launches kernel C on `stream`, allocates nothing, returns
// cudaGetLastError().
int epnet_sa_fused_bwd_launch(const void* y, const void* o, const void* idx, const void* w2,
                              const void* b2, const void* w3, const void* b3,
                              const void* gout, void* dy, void* d_o, void* part, void* grads,
                              int t, int n, int m, int s, int c1, int c2, int c3, int blocks,
                              void* stream) {
  return launch<false>(y, o, idx, nullptr, w2, b2, w3, b3, gout, dy, d_o, part, grads, t, n, m,
                       s, c1, c2, c3, blocks, 1, 0, stream);
}

// Kernel H: as above with idx (t, m, s) int64 window-relative rows in
// [0, window) and starts (t, nb) int64, the first table row of the window
// of each tile of m / nb centroids; nb must divide m, window <= n.
int epnet_sa_fused_win_bwd_launch(const void* y, const void* o, const void* idx,
                                  const void* starts, const void* w2, const void* b2,
                                  const void* w3, const void* b3, const void* gout, void* dy,
                                  void* d_o, void* part, void* grads, int t, int n, int m, int s,
                                  int c1, int c2, int c3, int nb, int window, int blocks,
                                  void* stream) {
  if (nb <= 0 || m % nb != 0 || window <= 0 || window > n) return cudaErrorInvalidValue;
  return launch<true>(y, o, idx, starts, w2, b2, w3, b3, gout, dy, d_o, part, grads, t, n, m, s,
                      c1, c2, c3, blocks, nb, window, stream);
}

const char* epnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
