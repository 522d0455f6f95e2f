// Fused set-abstraction interior on Hopper (sm_90a), forward only; plain C
// interface. Two kernels:
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
// What bounds them on the H100: arithmetic. At the RCNN shapes (T=100 RoI
// tables, M*S = 8192 or 2048 rows a table, 128-256 wide layers) the two
// dense layers are 54 + 20 GFLOP a forward over every sample (fewer over
// the distinct rows) while the kernel reads only Y, O, idx and the weights;
// the unfused composition would also write and re-read three (T, M*S, C)
// intermediates (~420 MB each at sa0). So the work is kept on chip.
//
// B, f32 (sa_fused_fwd_rows_kernel), cuts the work and moves it to the
// tensor cores:
//  - each distinct row once: a ball repeats rows (short balls are padded
//    with their first hit, pooled RoIs repeat points; ~34% of RCNN sa0's
//    samples are distinct on real tables), a repeated row gives the same
//    values, and a duplicate cannot change a max, so no multiplicity is
//    needed. The warp bitonic dedupe of kernels C and H
//    (csrc/sa_common.cuh) lists each ball's distinct rows;
//  - blocks split by cost: a prefix sum of distinct rows plus a fixed cost
//    a centroid and a binary search give each block a contiguous run of
//    centroids with an even share of the rows (balls differ ~60-fold); two
//    blocks of 8 warps an SM (~100 KB of shared memory each), as many
//    blocks as fit the card at once;
//  - a tile is up to 64 distinct rows of whole centroids (at most 32),
//    packed greedily by one warp's prefix sum of the counts. h1 =
//    relu(Y[row] - O) is gathered in f32 (float4 rows from L2) into shared
//    memory; layers 2 and 3 run on the TF32 tensor cores, mma.sync m16n8k8
//    in three passes (lo*hi + hi*lo + hi*hi, about as accurate as f32:
//    tests/test_torch_sa_fused_fwd_design.py), each warp 32 rows x 32
//    columns of a 128-column pass, against 32-row K-tiles of W2 and W3
//    streamed from L2 through a double-buffered cp.async ring and split as
//    they are loaded (W2 and W3, 192 KB at sa1, do not fit beside two
//    tiles, split or not). The split (split_tf32 in csrc/sa_common.cuh,
//    C and H's too) rounds hi and lo to nearest in integer operations: the
//    bits of cvt.rna without the conversion's low throughput. With cvt.rna
//    and C and H's 16-row, 3-slot ring, B took ~18% longer on the H100
//    (PERF.md, runs AK and AN). Cutting lo toward zero instead, as the
//    tensor cores read an unrounded register, was faster still but moved a
//    max downstream of B in the tiny block-local train step (chip_smoke.py
//    phase 16) past its bound: B's output feeds later maxes, although
//    kernel C's own selections recompute the forward in cuBLAS's order and
//    do not ride on B's rounding. Each product starts from 0 and its bias
//    is added after, in f32 (the tensor cores' accumulation truncates; over
//    K = 128 that stays ~1e-6 of a value);
//  - layer 3's bias and ReLU go into shared memory a 128-column pass at a
//    time, and each (centroid, channel) takes the max over the centroid's
//    rows (from 0: ReLU outputs are >= 0), written straight to the output,
//    since a centroid lies in one tile.
// The wrapper zero-pads C1 and C2 to 128 and W3's columns to a multiple of
// 128 (a zero column adds 0 to every sum); S <= 64 (one warp's sort).
//
// G and the bf16 instances (sa_fused_fwd_kernel, one template) gather every
// (centroid, sample) row and run layers 2 and 3 as register-tiled f32 FFMA:
// one block per (table t, TM = max(1, 64 / S) centroids). Rows (centroid,
// sample) are processed 64 at a time: the block gathers its rows of Y
// straight from global memory/L2 (no one-hot: that was a device of the
// TPU's matrix unit), subtracts O and applies ReLU into shared memory; layer
// 2 and layer 3 run as register-tiled f32 FFMA (each of 256 threads owns a
// 4-row x 8-column tile of a 128-column pass) against 32-row tiles of
// W2/W3 staged in shared memory; the layer-3 pass is folded into a running
// max per (centroid, channel) kept in shared memory. ReLU outputs are >= 0,
// so the max starts at 0. Shared memory at the widest RCNN stage (sa1:
// 128/128/256) is 83 KB, above the 48 KB default, hence the
// MaxDynamicSharedMemorySize attribute; the bf16 instances stage the same
// f32 tiles. Full f32 keeps the result within f32 roundoff of the plain
// version.
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
// function; here rows are gathered by index. In bf16 the bound is the
// tensor cores' (989 TFLOP/s), which these FFMA instances do not use.
//
// G is the template with the window's row index (kWin). On the TPU the
// window cut the one-hot matmul from N to W columns; here there is no
// one-hot, a row gather costs the same from any row of the table (a 512 x
// 128 f32 table is 256 KB, resident in L2), and the FFMA work is the same,
// so a design that stages each 256-row window in shared memory (128 KB a
// block, one block an SM) would save no work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "sa_common.cuh"

namespace {

// The template (G, B-bf16, G-bf16): kRows (centroid, sample) rows a chunk,
// kThreads = 16 x 16 threads of 4 rows x 8 columns each (sa_common.cuh)
constexpr int kColPass = 128;   // output columns per pass
constexpr int kKTile = 32;      // weight rows staged per step

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

// ---------------------------------------------------------------------------
// Kernel B (f32): each distinct row once, layers 2 and 3 in three TF32 passes.
// ---------------------------------------------------------------------------

// A centroid's fixed cost in distinct rows when the blocks split the work:
// its share of the max and its output row (not tuned).
constexpr int kFwdCentroidRows = 4;
constexpr int kFK = 32;              // weight rows a K-tile: 4 k8 steps a barrier
constexpr int kFSlot = kFK * kW2Ld;  // floats a ring slot; two slots
constexpr int kRowsSmem = 4 * (2 * kRows * kLd + 2 * kFSlot) +
                          4 * (2 * kRows + 2 * kMaxCent + 3);

// buf[row][c] = relu(acc + bias[c]) for this warp's accumulators: rows
// ra/rb of m-tiles mt < active, columns n0 + 8 nt + 2 t4 (+ 1).
__device__ __forceinline__ void store_relu(const float (&acc)[2][4][4],
                                           const float* __restrict__ bias, float* buf,
                                           const int (&ra)[2], const int (&rb)[2], int n0,
                                           int active) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt >= active) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = n0 + 8 * nt + 2 * t4;
      const float b0 = __ldg(bias + c);
      const float b1 = __ldg(bias + c + 1);
      float* pa = buf + ra[mt] * kLd + c;
      float* pb = buf + rb[mt] * kLd + c;
      pa[0] = fmaxf(acc[mt][nt][0] + b0, 0.0f);
      pa[1] = fmaxf(acc[mt][nt][1] + b1, 0.0f);
      pb[0] = fmaxf(acc[mt][nt][2] + b0, 0.0f);
      pb[1] = fmaxf(acc[mt][nt][3] + b1, 0.0f);
    }
  }
}

// out[cent, c] = max over the centroid's distinct rows of relu(h2 W3 + b3)[c],
// h2 = relu(h1 W2 + b2), h1 = relu(Y[row] - O[cent]), for c < c3; drows and
// counts from sa_dedupe_kernel, counts + cents the prefix of their cost.
__global__ void __launch_bounds__(kThreads, 2)
sa_fused_fwd_rows_kernel(const float* __restrict__ y, const float* __restrict__ o,
                         const int* __restrict__ drows, const int* __restrict__ counts,
                         const float* __restrict__ w2, const float* __restrict__ b2,
                         const float* __restrict__ w3, const float* __restrict__ b3,
                         float* __restrict__ out, int n, int m, int cents, int c3, int c3p) {
  extern __shared__ __align__(16) float smem[];
  float* buf_a = smem;                 // h1, then a pass's h3
  float* buf_b = buf_a + kRows * kLd;  // h2
  float* ring = buf_b + kRows * kLd;   // weight K-tiles
  int* row_tab = reinterpret_cast<int*>(ring + 2 * kFSlot);  // t * n + table row
  int* row_slot = row_tab + kRows;  // the row's centroid in the tile
  int* cent_id = row_slot + kRows;
  int* cent_rs = cent_id + kMaxCent;       // first row of each centroid, + end
  int* tile_info = cent_rs + kMaxCent + 1;  // n_cent, n_rows

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int wm = warp >> 2;        // this warp's rows 32 wm .. 32 wm + 31
  const int n0 = 32 * (warp & 3);  // and columns n0 .. n0 + 31 of a pass
  const int ra[2] = {32 * wm + g, 32 * wm + 16 + g};
  const int rb[2] = {32 * wm + 8 + g, 32 * wm + 24 + g};

  // this block's centroids: those whose cost starts in its share of the total
  const int* prefix = counts + cents;
  const long long total = prefix[cents];
  const int c_end = lower_bound(prefix, cents, total * (blockIdx.x + 1) / gridDim.x);
  int cursor = lower_bound(prefix, cents, total * blockIdx.x / gridDim.x);
  while (cursor < c_end) {
    __syncthreads();  // the previous tile is done with every buffer
    if (warp == 0) {  // pack whole centroids while their distinct rows fit
      const int c = cursor + lane;
      const int cnt = c < c_end ? counts[c] : kRows + 1;
      int incl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const int nc = __popc(__ballot_sync(0xffffffffu, incl <= kRows));
      if (lane < nc) {
        cent_id[lane] = c;
        cent_rs[lane] = incl - cnt;
      }
      if (lane == nc - 1) {
        cent_rs[nc] = incl;
        tile_info[1] = incl;
      }
      if (lane == 0) tile_info[0] = nc;
    }
    __syncthreads();
    const int n_cent = tile_info[0];
    const int n_rows = tile_info[1];
    for (int j = warp; j < n_cent; j += kThreads / 32) {
      const int cent = cent_id[j];
      const int base = cent_rs[j];
      const int tn = (cent / m) * n;
      for (int q = lane; q < cent_rs[j + 1] - base; q += 32) {
        row_tab[base + q] = tn + (drows[static_cast<size_t>(cent) * kRows + q] >> 7);
        row_slot[base + q] = j;
      }
    }
    __syncthreads();
    gather_h1(buf_a, y, o, row_tab, row_slot, cent_id, n_rows);  // ring_product's barrier
    const int active = min(2, max(0, (((n_rows + 15) & ~15) - 32 * wm) / 16));

    {  // h2 = relu(h1 W2 + b2)
      float acc[2][4][4] = {};
      ring_product<2, kFSlot>(
          kC / kFK, ring, [&](int i, float* slot) { load_w128<kFK>(w2, i, slot); },
          [&](int i, const float* slot) {
            slot_steps<2, 4>(acc, buf_a, kLd, ra, rb, kFK * i, slot, kW2Ld, kFK / 8, n0,
                             active);
          });
      store_relu(acc, b2, buf_b, ra, rb, n0, active);
    }
    for (int c0 = 0; c0 < c3p; c0 += kC) {
      {  // h3 = relu(h2 W3 + b3) for columns c0 .. c0 + 127, over h1 in buf_a
        float acc[2][4][4] = {};
        ring_product<2, kFSlot>(
            kC / kFK, ring, [&](int i, float* slot) { load_w128<kFK>(w3 + c0, i, slot, c3p); },
            [&](int i, const float* slot) {
              slot_steps<2, 4>(acc, buf_b, kLd, ra, rb, kFK * i, slot, kW2Ld, kFK / 8, n0,
                               active);
            });
        store_relu(acc, b3 + c0, buf_a, ra, rb, n0, active);
      }
      __syncthreads();
      // the max over each centroid's rows: a warp takes 32 neighbouring
      // columns of one centroid
      for (int e = tid; e < n_cent * kC; e += kThreads) {
        const int j = e / kC;
        const int c = e % kC;
        if (c0 + c >= c3) continue;
        float mx = 0.0f;
        for (int r = cent_rs[j]; r < cent_rs[j + 1]; ++r) mx = fmaxf(mx, buf_a[r * kLd + c]);
        out[static_cast<size_t>(cent_id[j]) * c3 + c0 + c] = mx;
      }
    }
    cursor += n_cent;
  }
}

int launch_rows(const void* y, const void* o, const void* idx, const void* w2, const void* b2,
                const void* w3, const void* b3, void* out, void* rows, void* counts, int t,
                int n, int m, int s, int c3, int c3p, void* stream) {
  if (n <= 0 || n >= (1 << 24) || s <= 0 || s > kRows || c3 <= 0 || c3p < c3 || c3p % kC ||
      t < 0 || m < 0 || static_cast<long long>(t) * m > INT_MAX ||
      static_cast<long long>(t) * n > INT_MAX)
    return cudaErrorInvalidValue;
  const int cents = t * m;
  if (cents == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per = kThreads / 32;
  sa_dedupe_kernel<false><<<(cents + per - 1) / per, kThreads, 0, st>>>(
      static_cast<const int64_t*>(idx), nullptr, static_cast<int*>(rows),
      static_cast<int*>(counts), cents, n, m, s, 1, 0);
  sa_scan_kernel<kFwdCentroidRows><<<1, 1024, 0, st>>>(static_cast<const int*>(counts),
                                                       static_cast<int*>(counts) + cents, cents);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto kernel = sa_fused_fwd_rows_kernel;
  static std::atomic<uint64_t> smem_set{0};
  err = allow_smem(reinterpret_cast<const void*>(kernel), kRowsSmem, smem_set);
  if (err != cudaSuccess) return err;
  static std::atomic<int> resident[64];  // blocks that fit the card at once, by device
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int blocks = resident[dev & 63].load(std::memory_order_relaxed);
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kRowsSmem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;  // does not fit an SM
    blocks = sms * per_sm;
    resident[dev & 63].store(blocks, std::memory_order_relaxed);
  }
  const int grid = blocks < cents ? blocks : cents;
  kernel<<<grid, kThreads, kRowsSmem, st>>>(
      static_cast<const float*>(y), static_cast<const float*>(o), static_cast<const int*>(rows),
      static_cast<const int*>(counts), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(out), n, m, cents, c3, c3p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs; above 232448 bytes the launch is refused.
long long epnet_sa_fused_smem_bytes(int s, int c1, int c2, int c3) {
  return static_cast<long long>(smem_bytes(s, c1, c2, c3));
}

// y (t, n, 128), o (t, m, 128), idx (t, m, s) int64, w2 (128, 128), b2
// (128), w3 (128, c3p), b3 (c3p), out (t, m, c3); rows (t * m * 64) and
// counts (2 t m + 1) int32 scratch. All float32 but the indices,
// contiguous, 16-byte aligned; c3p a multiple of 128, c3 <= c3p, the
// weights' padding zero. Needs 1 <= s <= 64, n < 2^24 and t * n < 2^31.
// Launches kernel B (dedupe, scan, main) on `stream`, allocates nothing,
// returns cudaGetLastError().
int epnet_sa_fused_fwd_launch(const void* y, const void* o, const void* idx, const void* w2,
                              const void* b2, const void* w3, const void* b3, void* out,
                              void* rows, void* counts, int t, int n, int m, int s, int c3,
                              int c3p, void* stream) {
  return launch_rows(y, o, idx, w2, b2, w3, b3, out, rows, counts, t, n, m, s, c3, c3p, stream);
}

// B-bf16: y (t, n, c1), o (t, m, c1), idx (t, m, s) int64, w2 (c1, c2), b2
// (c2), w3 (c2, c3), b3 (c3), out (t, m, c3); y, o, w2, w3 and out bf16, b2
// and b3 float32, contiguous. Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
int epnet_sa_fused_fwd_bf16_launch(const void* y, const void* o, const void* idx,
                                   const void* w2, const void* b2, const void* w3,
                                   const void* b3, void* out, int t, int n, int m,
                                   int s, int c1, int c2, int c3, void* stream) {
  return launch<false, __nv_bfloat16>(y, o, idx, nullptr, w2, b2, w3, b3, out, t, n, m, s, c1,
                                      c2, c3, 1, 0, stream);
}

// Kernel G: B-bf16's arguments in float32, with idx (t, m, s) int64
// window-relative rows in [0, window) and starts (t, nb) int64, the first
// table row of the window of each tile of m / nb centroids; nb must divide
// m, window <= n.
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
