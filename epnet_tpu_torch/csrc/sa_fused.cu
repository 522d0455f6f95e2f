// Fused set-abstraction interior on Hopper (sm_90a), forward only; plain C
// interface. Kernels:
//
//   B replaces the Pallas TPU kernel epnet_tpu/ops/sa_fused.py::_fwd_kernel
//     (pallas_call at :156, reached through fused_point_mlp_max);
//   G replaces its windowed twin ::_fwd_kernel_win (pallas_call at :404,
//     reached through fused_point_mlp_max_win, the block-local RCNN sa0);
//   B-bf16 and G-bf16 replace the same two Pallas kernels' bf16 branch
//     (n_splits == 1, sa_fused.py:91-93, 108-116), which the JAX package's
//     MIXED_PRECISION forward reaches, and the two profiler kernels of the
//     same function, tools/profile_fused_onehot.py::kern (pallas_call at
//     :103) and tools/profile_fps_variants.py::kernel (:143, called with W3
//     = W2 and b3 = b2).
//
// All compute
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
// B-bf16 and G-bf16 (sa_fused_fwd_bf16_kernel, one body) take Y, O, W2, W3
// in bf16 and b2, b3 in f32 and write a bf16 output. Their function is the
// Pallas kernel's bf16 one: h1 = relu(Y[row] - O) in f32, rounded to bf16;
// each layer's bf16 products summed in f32 from 0 (a product of two bf16
// values is exact in f32), the f32 bias added after; h2 rounded to bf16
// before layer 3; the max in f32, the output rounded once. Their bound is
// the bf16 tensor cores' (989 TFLOP/s) over the distinct rows. The design
// starts from B's and keeps what the bf16 types allow:
//  - B's dedupe, cost split and tile packing (csrc/sa_common.cuh); G-bf16
//    is the same body after sa_dedupe_kernel<true> with the window starts,
//    since the window decides only which table rows form a ball;
//  - W2 and W3 stay in shared memory for the block's life (32 + 64 KB at
//    C3 = 256, bf16), copied once by cp.async into the 128-byte swizzled
//    N-major layout that wgmma reads: a persistent block walks dozens of
//    tiles or more, and f32 B re-streams both weights from L2 for every
//    tile. So C3 <= 256 (C3p 128 or 256);
//  - the products on bf16 wgmma m64n128k16 with f32 accumulators: a 64-row
//    tile is one wgmma M. bf16 wgmma reads B N-major, so W's (K, N)
//    row-major layout needs no transpose (TF32 would: F's prologue, csrc/
//    conv3x3_s2_fwd.cu). h1 is gathered as 16-byte bf16 rows from L2 into
//    the K-major swizzled A tile; layer 2's accumulators, with bias, ReLU
//    and bf16 rounding, become layer 3's A fragments in registers (an
//    accumulator's layout is an A fragment's), so h2 never touches shared
//    memory;
//  - layer 3, a 128-column pass at a time: bias, ReLU and bf16 rounding
//    into a staging tile over h1 (dead once layer 2's wgmmas are done),
//    then each (centroid, channel pair) takes the max over the centroid's
//    rows in bf16, two lanes a pair, each half the rows, and writes it.
//    Rounding is monotone, so rounding before the max gives the output
//    that rounding after does (tests/test_torch_sa_fused_bf16_design.py),
//    and the staging is half f32 B's;
//  - four warpgroups a block share the weights (one block an SM: ~171 KB
//    of shared memory, 128 registers a thread), each on its own share of
//    the cost split with its own tiles and named barrier: while one waits
//    for its gather from L2 or runs its epilogue on the CUDA cores,
//    another's wgmmas run. Column halves of one tile would give each
//    warpgroup half the products and the whole gather and max to share in
//    lockstep; independent tiles overlap them without a producer/consumer
//    protocol. Four ran faster than three on the H100 (PERF.md, section 6).
// What bounds them now is latency, not the tensor cores: a tile's chain of
// dependent steps (its counts, its rows' table indices, their Y rows from
// L2, then the epilogues on the CUDA cores) takes several times its
// wgmmas, and four warpgroups an SM overlap only four such chains.
//
// G (f32) keeps the first design, sa_fused_fwd_win_kernel: it gathers every
// (centroid, sample) row and runs layers 2 and 3 as register-tiled f32
// FFMA, one block per (table t, TM = max(1, 64 / S) centroids). Rows are
// processed 64 at a time: the block gathers its rows of Y straight from
// global memory/L2 (no one-hot: that was a device of the TPU's matrix
// unit), subtracts O and applies ReLU into shared memory; layer 2 and
// layer 3 run as register-tiled f32 FFMA (each of 256 threads owns a 4-row
// x 8-column tile of a 128-column pass) against 32-row tiles of W2/W3
// staged in shared memory; the layer-3 pass is folded into a running max
// per (centroid, channel) kept in shared memory. ReLU outputs are >= 0, so
// the max starts at 0. Shared memory at the widest RCNN stage (sa1:
// 128/128/256) is 83 KB, above the 48 KB default, hence the
// MaxDynamicSharedMemorySize attribute. On the TPU the window cut the
// one-hot matmul from N to W columns; here there is no one-hot, and a row
// gather costs the same from any row of the table (a 512 x 128 f32 table
// is 256 KB, resident in L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "sa_common.cuh"

namespace {

// Blocks of `kernel` (`threads` and `smem` bytes a block) that fit the card
// at once, worked out once a device into `cache` (by device).
cudaError_t resident_blocks(const void* kernel, int threads, int smem,
                            std::atomic<int> (&cache)[64], int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  *blocks = cache[dev & 63].load(std::memory_order_relaxed);
  if (*blocks > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;  // does not fit an SM
  *blocks = sms * per_sm;
  cache[dev & 63].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Kernel G (f32): every (centroid, sample) row, f32 FFMA.
// ---------------------------------------------------------------------------

// kRows (centroid, sample) rows a chunk, kThreads = 16 x 16 threads of 4
// rows x 8 columns each (sa_common.cuh)
constexpr int kColPass = 128;   // output columns per pass
constexpr int kKTile = 32;      // weight rows staged per step

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
// 128 columns c of the pass starting at c0 and all kRows rows. Starts with a
// barrier, so the caller's writes to `hin` are visible.
__device__ void dense_relu_pass(const float* hin, int ldin, int cin, const float* __restrict__ w,
                                const float* __restrict__ bias, int cout, int c0, float* hout,
                                int ldout, int out_col0, float* wt) {
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
      wt[e] = (k < cin && c < cout) ? w[static_cast<size_t>(k) * cout + c] : 0.0f;
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
        hout[(ty * 4 + i) * ldout + out_col0 + tx + 16 * j] = fmaxf(acc[i][j] + bc, 0.0f);
    }
  }
}

// idx holds window-relative rows, offset by starts (t, nb) of tiles of m / nb
// centroids, each window `window` rows long.
__global__ void __launch_bounds__(kThreads)
sa_fused_fwd_win_kernel(const float* __restrict__ y, const float* __restrict__ o,
                        const int64_t* __restrict__ idx, const int64_t* __restrict__ starts,
                        const float* __restrict__ w2, const float* __restrict__ b2,
                        const float* __restrict__ w3, const float* __restrict__ b3,
                        float* __restrict__ out, int n, int m, int s, int c1, int c2, int c3,
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
  const float* yt = y + static_cast<size_t>(t) * n * c1;
  const float* ot = o + static_cast<size_t>(t) * m * c1;
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
        p = p < 0 ? 0 : (p >= window ? window - 1 : p);  // inside the window
        p += starts[static_cast<size_t>(t) * nb + mm / (m / nb)];
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
      ha[r * lda + c] =
          mm >= 0 ? fmaxf(yt[row_point[r] * c1 + c] - ot[static_cast<size_t>(mm) * c1 + c], 0.0f)
                  : 0.0f;
    }

    for (int c0 = 0; c0 < c2; c0 += kColPass)
      dense_relu_pass(ha, lda, c1, w2, b2, c2, c0, hb, ldb, c0, wt);

    const int lm_lo = row0 / s;
    const int lm_hi = min((row0 + kRows - 1) / s, tm - 1);
    const int chunk_rows = min(kRows, rows - row0);
    for (int c0 = 0; c0 < c3; c0 += kColPass) {
      dense_relu_pass(hb, ldb, c2, w3, b3, c3, c0, ha, lda, 0, wt);
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
    if (mm < m) out[(static_cast<size_t>(t) * m + mm) * c3 + e % c3] = omax[e];
  }
}

int launch_win(const void* y, const void* o, const void* idx, const void* starts, const void* w2,
               const void* b2, const void* w3, const void* b3, void* out, int t, int n, int m,
               int s, int c1, int c2, int c3, int nb, int window, void* stream) {
  if (t == 0 || m == 0) return 0;
  if (n <= 0 || s <= 0 || c1 <= 0 || c2 <= 0 || c3 <= 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(s, c1, c2, c3);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const int tm = centroids_per_block(s);
  const int blocks_m = (m + tm - 1) / tm;
  if (blocks_m > 65535) return cudaErrorInvalidValue;
  const auto kernel = sa_fused_fwd_win_kernel;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), kMaxSmem, smem_set, true);
  if (err != cudaSuccess) return err;
  const dim3 grid(t, blocks_m);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(o),
      static_cast<const int64_t*>(idx), static_cast<const int64_t*>(starts),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(w3), static_cast<const float*>(b3), static_cast<float*>(out), n,
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

// The dedupe and the cost scan of kernels B, B-bf16 and G-bf16 on `st`.
template <bool kWin>
cudaError_t dedupe_and_scan(const void* idx, const void* starts, void* rows, void* counts,
                            int cents, int n, int m, int s, int nb, int window,
                            cudaStream_t st) {
  const int per = kThreads / 32;
  sa_dedupe_kernel<kWin><<<(cents + per - 1) / per, kThreads, 0, st>>>(
      static_cast<const int64_t*>(idx), static_cast<const int64_t*>(starts),
      static_cast<int*>(rows), static_cast<int*>(counts), cents, n, m, s, nb, window);
  sa_scan_kernel<kFwdCentroidRows><<<1, 1024, 0, st>>>(static_cast<const int*>(counts),
                                                       static_cast<int*>(counts) + cents, cents);
  return cudaGetLastError();
}

// A tile of the centroids from `cursor` on (one warp: `lane` 0..31, whose
// `cnt` is the distinct rows of centroid cursor + lane, kRows + 1 past the
// part's end): whole centroids packed while their distinct rows fit in
// kRows, at most kMaxCent. cent_id[j] and cent_rs[j] are centroid j's id and
// first row, cent_rs[n_cent] the tile's rows; tile_info = (n_cent, n_rows).
// Returns n_cent.
__device__ __forceinline__ int pack_tile(int cnt, int cursor, int lane, int* cent_id,
                                         int* cent_rs, int* tile_info) {
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const int nc = __popc(__ballot_sync(0xffffffffu, incl <= kRows));
  if (lane < nc) {
    cent_id[lane] = cursor + lane;
    cent_rs[lane] = incl - cnt;
  }
  if (lane == nc - 1) {
    cent_rs[nc] = incl;
    tile_info[1] = incl;
  }
  if (lane == 0) tile_info[0] = nc;
  return nc;
}

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
    if (warp == 0)
      pack_tile(cursor + lane < c_end ? counts[cursor + lane] : kRows + 1, cursor, lane,
                cent_id, cent_rs, tile_info);
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

// The shapes kernels B, B-bf16 and G-bf16 take (the wrappers check them
// first: ops/sa_fused.py::check_rows_takes).
bool rows_take(int t, int n, int m, int s, int c3, int c3p) {
  return n > 0 && n < (1 << 24) && s > 0 && s <= kRows && c3 > 0 && c3p >= c3 && c3p % kC == 0 &&
         t >= 0 && m >= 0 && static_cast<long long>(t) * m <= INT_MAX &&
         static_cast<long long>(t) * n <= INT_MAX;
}

int launch_rows(const void* y, const void* o, const void* idx, const void* w2, const void* b2,
                const void* w3, const void* b3, void* out, void* rows, void* counts, int t,
                int n, int m, int s, int c3, int c3p, void* stream) {
  if (!rows_take(t, n, m, s, c3, c3p)) return cudaErrorInvalidValue;
  const int cents = t * m;
  if (cents == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dedupe_and_scan<false>(idx, nullptr, rows, counts, cents, n, m, s, 1, 0, st);
  if (err != cudaSuccess) return err;
  const auto kernel = sa_fused_fwd_rows_kernel;
  static std::atomic<uint64_t> smem_set{0};
  err = allow_smem(reinterpret_cast<const void*>(kernel), kRowsSmem, smem_set);
  if (err != cudaSuccess) return err;
  static std::atomic<int> resident[64];
  int blocks = 0;
  err = resident_blocks(reinterpret_cast<const void*>(kernel), kThreads, kRowsSmem, resident,
                        &blocks);
  if (err != cudaSuccess) return err;
  const int grid = blocks < cents ? blocks : cents;
  kernel<<<grid, kThreads, kRowsSmem, st>>>(
      static_cast<const float*>(y), static_cast<const float*>(o), static_cast<const int*>(rows),
      static_cast<const int*>(counts), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(out), n, m, cents, c3, c3p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B-bf16 and G-bf16: each distinct row once, bf16 wgmma, W2 and W3 resident.
// ---------------------------------------------------------------------------

constexpr int kHGroups = 4;                  // warpgroups a block, each on its own tiles
constexpr int kHThreads = 128 * kHGroups;
constexpr int kHMaxC3 = 2 * kC;              // W3's columns that stay in shared memory
constexpr int kAtom = 1024;                  // a 128-byte swizzled atom: 8 rows of 128 bytes
constexpr int kWPanel = kC / 8 * kAtom;      // 64 columns of a weight's 128 rows: 16 KB
constexpr int kH1Panel = kRows / 8 * kAtom;  // 64 columns of h1's 64 rows: 8 KB
constexpr int kH3Ld = kC + 8;                // bf16 row stride of a layer-3 pass's staging
// a warpgroup's own: h1 (two panels), then a layer-3 pass over it; the
// tile's tables
constexpr int kGroupBytes = kRows * kH3Ld * 2 + kAtom;
static_assert(kRows * kH3Ld * 2 >= 2 * kH1Panel && kGroupBytes % kAtom == 0, "h1 and h3");
static_assert((2 * kRows + 2 * kMaxCent + 3) * 4 <= kAtom, "a warpgroup's tables");

// Bytes of dynamic shared memory at c3p (+ 1 KB to align the atoms):
// W2, W3, the warpgroups' own, b2 and b3.
constexpr int bf16_smem(int c3p) {
  return kAtom + (2 + c3p / 64) * kWPanel + kHGroups * kGroupBytes + 4 * (kC + c3p);
}
static_assert(bf16_smem(kHMaxC3) <= kMaxSmem, "B-bf16's shared memory");

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(group + 1) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A row-major bf16 weight (kC rows, `cols` columns) into N-major 128-byte
// swizzled panels of 64 columns by cp.async (the block's threads): element
// (k, n) at (n / 64) kWPanel + (k / 8) 1024 + (k % 8) 128 + ((n % 64 / 8) ^
// (k % 8)) 16 + (n % 8) 2.
__device__ __forceinline__ void load_w_panels(unsigned char* dst,
                                              const __nv_bfloat16* __restrict__ w, int cols) {
  const int per_row = cols / 8;
  for (int e = threadIdx.x; e < kC * per_row; e += blockDim.x) {
    const int k = e / per_row;
    const int n8 = e % per_row;
    cp_async<16>(smem_addr(dst + (n8 / 8) * kWPanel + (k / 8) * kAtom + (k % 8) * 128 +
                           (((n8 % 8) ^ (k % 8)) * 16)),
                 w + static_cast<size_t>(k) * cols + 8 * n8, true);
  }
}

// h1 = bf16(relu(Y[row] - O[centroid])) for the tile's rows, 0 past them
// (the warpgroup's 128 threads, `gtid`), into K-major 128-byte swizzled
// panels of 64 columns: element (r, k) at (k / 64) kH1Panel + (r / 8) 1024 +
// (r % 8) 128 + ((k % 64 / 8) ^ (r % 8)) 16 + (k % 8) 2. Each thread's
// loads from L2 are all issued before the first is used.
__device__ __forceinline__ void gather_h1_bf16(unsigned char* h1,
                                               const __nv_bfloat16* __restrict__ y,
                                               const __nv_bfloat16* __restrict__ o,
                                               const int* row_tab, const int* row_slot,
                                               const int* cent_id, int n_rows, int gtid) {
  constexpr int kPer = kRows * (kC / 8) / 128;  // 16-byte chunks a thread
  const int k8 = gtid & 15;                     // its chunk of each of its rows
  uint4 a[kPer], b[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = (gtid >> 4) + 8 * i;
    a[i] = b[i] = make_uint4(0u, 0u, 0u, 0u);  // relu(0 - 0): the rows past the tile's
    if (r < n_rows) {
      a[i] = __ldg(reinterpret_cast<const uint4*>(y + static_cast<size_t>(row_tab[r]) * kC +
                                                  8 * k8));
      b[i] = __ldg(reinterpret_cast<const uint4*>(
          o + static_cast<size_t>(cent_id[row_slot[r]]) * kC + 8 * k8));
    }
  }
  // a bf16 pair's low half is its first element; bf16 -> f32 is a shift
  auto h = [](uint32_t ya, uint32_t ob) {
    return pack_bf16(fmaxf(__uint_as_float(ya << 16) - __uint_as_float(ob << 16), 0.0f),
                     fmaxf(__uint_as_float(ya & 0xFFFF0000u) - __uint_as_float(ob & 0xFFFF0000u),
                           0.0f));
  };
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = (gtid >> 4) + 8 * i;
    *reinterpret_cast<uint4*>(h1 + (k8 >> 3) * kH1Panel + (r >> 3) * kAtom + (r & 7) * 128 +
                              (((k8 & 7) ^ (r & 7)) * 16)) =
        make_uint4(h(a[i].x, b[i].x), h(a[i].y, b[i].y), h(a[i].z, b[i].z), h(a[i].w, b[i].w));
  }
}

// B-bf16's output (G-bf16's after the windowed dedupe): out[cent, c] = max
// over the centroid's distinct rows of bf16(relu(h2 W3 + b3))[c], h2 =
// bf16(relu(h1 W2 + b2)), h1 = bf16(relu(Y[row] - O[cent])), for c < c3;
// drows and counts from sa_dedupe_kernel, counts + cents the prefix of
// their cost. w2 (128, 128), w3 (128, c3p), b2 (128), b3 (c3p), c3p <= 256.
__global__ void __launch_bounds__(kHThreads, 1)
sa_fused_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ y,
                         const __nv_bfloat16* __restrict__ o, const int* __restrict__ drows,
                         const int* __restrict__ counts, const __nv_bfloat16* __restrict__ w2,
                         const float* __restrict__ b2, const __nv_bfloat16* __restrict__ w3,
                         const float* __restrict__ b3, __nv_bfloat16* __restrict__ out, int n,
                         int m, int cents, int c3, int c3p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* w2s = smem_raw + ((kAtom - (smem_addr(smem_raw) & (kAtom - 1))) & (kAtom - 1));
  unsigned char* w3s = w2s + 2 * kWPanel;
  unsigned char* groups = w3s + c3p / 64 * kWPanel;
  float* b2s = reinterpret_cast<float*>(groups + kHGroups * kGroupBytes);
  float* b3s = b2s + kC;

  const int tid = threadIdx.x;
  load_w_panels(w2s, w2, kC);
  load_w_panels(w3s, w3, c3p);
  cp_async_commit();
  for (int e = tid; e < kC + c3p; e += kHThreads) b2s[e] = e < kC ? b2[e] : b3[e - kC];
  cp_async_wait<0>();
  fence_async_shared();  // the weights' copies -> wgmma
  __syncthreads();

  const int group = tid >> 7;
  const int gtid = tid & 127;
  const int lane = tid & 31;
  const int warp = gtid >> 5;  // rows 16 warp .. 16 warp + 15 of the tile's accumulators
  const int t2 = 2 * (lane & 3);
  const int r0 = 16 * warp + (lane >> 2);
  unsigned char* h1 = groups + group * kGroupBytes;
  // h3's staging over h1: layer 2's wgmmas, the last to read h1, are done
  // once any warp has waited for layer 3's (all four warps issue each)
  __nv_bfloat16* h3 = reinterpret_cast<__nv_bfloat16*>(h1);
  int* row_tab = reinterpret_cast<int*>(h1 + kRows * kH3Ld * 2);
  int* row_slot = row_tab + kRows;  // the row's centroid in the tile
  int* cent_id = row_slot + kRows;
  int* cent_rs = cent_id + kMaxCent;        // first row of each centroid, + end
  int* tile_info = cent_rs + kMaxCent + 1;  // n_cent, n_rows

  // this warpgroup's centroids: those whose cost starts in its share
  const int part = blockIdx.x * kHGroups + group;
  const long long parts = static_cast<long long>(gridDim.x) * kHGroups;
  const int* prefix = counts + cents;
  const long long total = prefix[cents];
  const int c_end = lower_bound(prefix, cents, total * (part + 1) / parts);
  int cursor = lower_bound(prefix, cents, total * part / parts);
  // warp 0's lanes hold the counts of the next tile's candidates, loaded while
  // the current tile runs
  int cnt = warp == 0 && cursor + lane < c_end ? counts[cursor + lane] : kRows + 1;
  while (cursor < c_end) {
    group_sync(group);  // the previous tile is done with the tables and h3
    if (warp == 0) {
      const int next = cursor + pack_tile(cnt, cursor, lane, cent_id, cent_rs, tile_info);
      cnt = next + lane < c_end ? counts[next + lane] : kRows + 1;
    }
    group_sync(group);
    const int n_cent = tile_info[0];
    const int n_rows = tile_info[1];
    for (int j = warp; j < n_cent; j += 4) {
      const int cent = cent_id[j];
      const int base = cent_rs[j];
      const int tn = (cent / m) * n;
      for (int q = lane; q < cent_rs[j + 1] - base; q += 32) {
        row_tab[base + q] = tn + (drows[static_cast<size_t>(cent) * kRows + q] >> 7);
        row_slot[base + q] = j;
      }
    }
    group_sync(group);
    gather_h1_bf16(h1, y, o, row_tab, row_slot, cent_id, n_rows, gtid);
    fence_async_shared();  // h1's stores -> wgmma
    group_sync(group);

    // layer 2; accumulator i: row r0 (+ 8 when i % 4 >= 2), column 8 (i / 4)
    // + t2 + i % 2
    uint32_t a2[kC / 16][4];  // h2 as layer 3's A: k-slice i / 8, register i % 8 / 2
    {
      float acc[kC / 2];  // set by the first wgmma (scale-d 0)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk)
        wgmma_bf16<kC>(acc,
                       smem_desc<kSwizzle128>(h1 + (kk >> 2) * kH1Panel + 32 * (kk & 3), 16,
                                              kAtom),
                       smem_desc<kSwizzle128>(w2s + 2 * kAtom * kk, kWPanel, kAtom), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kC / 2; i += 2) {
        const float2 b = *reinterpret_cast<const float2*>(b2s + 8 * (i >> 2) + t2);
        a2[i >> 3][(i & 7) >> 1] =
            pack_bf16(fmaxf(acc[i] + b.x, 0.0f), fmaxf(acc[i + 1] + b.y, 0.0f));
      }
    }
    for (int c0 = 0; c0 < c3p; c0 += kC) {
      {  // h3 = bf16(relu(h2 W3 + b3)) for columns c0 .. c0 + 127, staged
        float acc[kC / 2];
        wgmma_fence();  // a2's registers -> wgmma
#pragma unroll
        for (int kk = 0; kk < kC / 16; ++kk)
          wgmma_bf16_rs_128(
              acc, a2[kk],
              smem_desc<kSwizzle128>(w3s + (c0 / 64) * kWPanel + 2 * kAtom * kk, kWPanel, kAtom),
              kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < kC / 2; i += 2) {
          const int c = 8 * (i >> 2) + t2;
          const float2 b = *reinterpret_cast<const float2*>(b3s + c0 + c);
          *reinterpret_cast<uint32_t*>(h3 + (r0 + (i & 2) * 4) * kH3Ld + c) =
              pack_bf16(fmaxf(acc[i] + b.x, 0.0f), fmaxf(acc[i + 1] + b.y, 0.0f));
        }
      }
      group_sync(group);
      // the max over each centroid's rows: a thread takes two neighbouring
      // columns and half the rows (four chains of maxima), its neighbour
      // lane the other half
      for (int e = gtid; e < n_cent * kC; e += 128) {  // every lane of a warp, as often
        const int j = e / kC;
        const int c = 2 * ((e % kC) >> 1);
        const int mid = (cent_rs[j] + cent_rs[j + 1] + 1) >> 1;
        const int end = e & 1 ? cent_rs[j + 1] : mid;
        const __nv_bfloat16* col = h3 + c;
        __nv_bfloat162 mx[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) mx[q] = __float2bfloat162_rn(0.0f);
        int r = e & 1 ? mid : cent_rs[j];
        for (; r + 3 < end; r += 4)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mx[q] = __hmax2(mx[q],
                            *reinterpret_cast<const __nv_bfloat162*>(col + (r + q) * kH3Ld));
        for (; r < end; ++r)
          mx[0] = __hmax2(mx[0], *reinterpret_cast<const __nv_bfloat162*>(col + r * kH3Ld));
        mx[0] = __hmax2(__hmax2(mx[0], mx[1]), __hmax2(mx[2], mx[3]));
        const uint32_t mine = *reinterpret_cast<const uint32_t*>(&mx[0]);
        const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
        mx[0] = __hmax2(mx[0], *reinterpret_cast<const __nv_bfloat162*>(&other));
        if (!(e & 1) && c0 + c < c3) {
          __nv_bfloat16* dst = out + static_cast<size_t>(cent_id[j]) * c3 + c0 + c;
          dst[0] = mx[0].x;
          if (c0 + c + 1 < c3) dst[1] = mx[0].y;
        }
      }
      if (c0 + kC < c3p) group_sync(group);  // the next pass's staging
    }
    cursor += n_cent;
  }
}

template <bool kWin>
int launch_bf16(const void* y, const void* o, const void* idx, const void* starts, const void* w2,
                const void* b2, const void* w3, const void* b3, void* out, void* rows,
                void* counts, int t, int n, int m, int s, int c3, int c3p, int nb, int window,
                void* stream) {
  if (!rows_take(t, n, m, s, c3, c3p) || c3p > kHMaxC3) return cudaErrorInvalidValue;
  const int cents = t * m;
  if (cents == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dedupe_and_scan<kWin>(idx, starts, rows, counts, cents, n, m, s, nb, window, st);
  if (err != cudaSuccess) return err;
  const auto kernel = sa_fused_fwd_bf16_kernel;
  constexpr int kMost = bf16_smem(kHMaxC3);
  static std::atomic<uint64_t> smem_set{0};
  err = allow_smem(reinterpret_cast<const void*>(kernel), kMost, smem_set);
  if (err != cudaSuccess) return err;
  static std::atomic<int> resident[64];
  int blocks = 0;
  err = resident_blocks(reinterpret_cast<const void*>(kernel), kHThreads, kMost, resident,
                        &blocks);
  if (err != cudaSuccess) return err;
  const int grid = blocks < cents ? blocks : cents;
  kernel<<<grid, kHThreads, bf16_smem(c3p), st>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(o),
      static_cast<const int*>(rows), static_cast<const int*>(counts),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<const __nv_bfloat16*>(w3), static_cast<const float*>(b3),
      static_cast<__nv_bfloat16*>(out), n, m, cents, c3, c3p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block of kernel G needs; above 232448 bytes the launch
// is refused.
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

// B-bf16: kernel B's arguments with y, o, w2, w3 and out bf16 (b2, b3
// float32) and c3p 128 or 256. Launches the dedupe, the scan and
// sa_fused_fwd_bf16_kernel on `stream`, allocates nothing, returns
// cudaGetLastError().
int epnet_sa_fused_fwd_bf16_launch(const void* y, const void* o, const void* idx,
                                   const void* w2, const void* b2, const void* w3,
                                   const void* b3, void* out, void* rows, void* counts, int t,
                                   int n, int m, int s, int c3, int c3p, void* stream) {
  return launch_bf16<false>(y, o, idx, nullptr, w2, b2, w3, b3, out, rows, counts, t, n, m, s,
                            c3, c3p, 1, 0, stream);
}

// G-bf16: B-bf16 with idx (t, m, s) int64 window-relative rows in [0,
// window) and starts (t, nb) int64, the first table row of the window of
// each tile of m / nb centroids; nb must divide m, window <= n.
int epnet_sa_fused_win_fwd_bf16_launch(const void* y, const void* o, const void* idx,
                                       const void* starts, const void* w2, const void* b2,
                                       const void* w3, const void* b3, void* out, void* rows,
                                       void* counts, int t, int n, int m, int s, int c3, int c3p,
                                       int nb, int window, void* stream) {
  if (nb <= 0 || m % nb != 0 || window <= 0 || window > n) return cudaErrorInvalidValue;
  return launch_bf16<true>(y, o, idx, starts, w2, b2, w3, b3, out, rows, counts, t, n, m, s, c3,
                           c3p, nb, window, stream);
}

// What B-bf16 and G-bf16 run, for the logs.
const char* epnet_sa_fused_bf16_design() {
  return "distinct rows; bf16 wgmma m64n128k16, layer 3's A from registers; W2, W3 resident "
         "in shared memory; 4 warpgroups a block on their own tiles, 1 block an SM";
}

// Kernel G: y (t, n, c1), o (t, m, c1), idx (t, m, s) int64 window-relative
// rows in [0, window), starts (t, nb) int64, the first table row of the
// window of each tile of m / nb centroids, w2 (c1, c2), b2 (c2), w3 (c2,
// c3), b3 (c3), out (t, m, c3); all float32 but the indices, contiguous. nb
// must divide m, window <= n. Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
int epnet_sa_fused_win_fwd_launch(const void* y, const void* o, const void* idx,
                                  const void* starts, const void* w2, const void* b2,
                                  const void* w3, const void* b3, void* out, int t, int n,
                                  int m, int s, int c1, int c2, int c3, int nb, int window,
                                  void* stream) {
  if (nb <= 0 || m % nb != 0 || window <= 0 || window > n) return cudaErrorInvalidValue;
  return launch_win(y, o, idx, starts, w2, b2, w3, b3, out, t, n, m, s, c1, c2, c3, nb, window,
                    stream);
}

const char* epnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
