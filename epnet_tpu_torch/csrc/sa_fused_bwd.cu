// Backward of the fused set-abstraction interior on Hopper (sm_90a), f32;
// plain C interface. Two kernels, one design:
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
// it recomputes the rows (g1 = Y[row] - O, h1, p2, h2, p3, h3) and pushes
// gout back:
//
//   dh3 = [h3 == max_s h3] gout / count of tied samples   (split evenly)
//   dp3 = [p3 > 0] dh3;  dW3 += h2^T dp3;  db3 += sum dp3;  dh2 = dp3 W3^T
//   dp2 = [p2 > 0] dh2;  dW2 += h1^T dp2;  db2 += sum dp2;  dh1 = dp2 W2^T
//   dp1 = [g1 > 0] dh1;  dY[t, row] += dp1 (scatter-add);  dO[t, m] = -sum_s dp1
//
// The plain versions are
// epnet_tpu_torch/ops/sa_fused.py::fused_point_mlp_max_bwd_plain and
// ::fused_point_mlp_max_win_bwd_plain.
//
// The work this function needs is much less than its dense form:
//  - a ball repeats rows (short balls are padded with their first hit,
//    pooled RoIs repeat points): on the real block-local windows only ~22%
//    of the S = 64 rows of a ball are distinct. A row with multiplicity k
//    gives k equal samples, so the recompute needs each distinct row once,
//    and its k samples' gradients add up to k times one;
//  - dp3 has one nonzero a (centroid, channel), ties aside, so layer 3's
//    two backward products are 2 * C2 multiply-adds a nonzero, not dense
//    products over the rows;
//  - layer 2's backward reaches only the live rows: those that hold the
//    max of at least one channel.
// What is left are four dense products over the distinct rows at 128 x 128
// (x 256) widths: the recompute (p2, p3) and, over the live rows, layer 2's
// backward (dW2, dh1); ~200 GFLOP at the train shapes of RCNN sa0, against
// ~0.1 GB of inputs and outputs: operations bound it (chip_smoke.py prints
// the f32 count and this design's, with layer 2's backward on the TF32
// tensor cores).
//
// Design, in three kernels and a fixed-order reduction:
//
// 1. sa_dedupe_kernel (csrc/sa_common.cuh), a warp a centroid: bitonic sort of its S <= 64
//    table rows (for H the global rows starts + idx_rel, clamped as the
//    forward clamps them) in registers and shuffles; each distinct row once,
//    packed as row * 128 + k with its multiplicity k, and the count.
//    Equal rows at different indices stay apart; they tie exactly below,
//    since nothing in a row's arithmetic depends on its slot in a tile.
//
// 2. sa_fused_bwd_kernel, one block an SM (~158 KB of shared memory at
//    C3 = 128, ~225 KB at 256), each block a contiguous run of centroids
//    holding an even share of the work (distinct rows plus a fixed cost a
//    centroid; a prefix sum, sa_scan_kernel, and a binary search: balls
//    differ ~60-fold in distinct rows).
//    Widths are C1 = C2 = 128 and C3 = 128 or 256 (the RCNN stages); the
//    wrapper zero-pads narrower ones, which leaves every gradient unchanged.
//    A tile is up to 64 distinct rows of whole centroids (at most 32 of
//    them), packed greedily from the counts by one warp's prefix sum. Per
//    tile:
//    - gather h1 = relu(Y[row] - O) (float4 rows from L2);
//    - the recompute p2 = h1 W2 + b2 and p3 = h2 W3 + b3 in f32 FFMA (4 x 8
//      outputs a thread, float4 operands), each sum one fmaf after another
//      in k order from 0 and the bias added after: cuBLAS's order, so p2
//      and p3 are bitwise the plain version's. They decide the ReLU masks
//      and the maxima, and a product rounded otherwise (3xTF32 on the
//      tensor cores was tried) puts a few of them on the other side at the
//      train shapes, each moving a whole gradient share past the 1e-4 check.
//      The weights stream from L2 in K-tiles through a 3-slot cp.async ring
//      (W2 and W3 at C3 = 256 are 192 KB and do not fit beside the tiles);
//      p3 goes 64 columns at a time;
//    - for each 64-column chunk: the max over the centroid's distinct rows
//      (four threads a column, combined by shuffles), cnt = sum of k over
//      the tied rows, and dp3 = k * gout / cnt on the tied rows with p3 > 0,
//      in place; a 64-bit row mask a column. dW3 and db3 as gathers over
//      those nonzeros, 2 * C2 multiply-adds each: warp w owns dW3's columns
//      8w.. (dW3[:, c] += d * h2[r]), one writer an element, no atomics.
//      dh2 = dp3 W3^T accumulates in registers as a dense product on the
//      tensor cores (three TF32 passes, as below; W3^T streamed as W2 is):
//      as gathers it was a chain of shared-memory read-modify-writes, one a
//      nonzero, and balls of one or two distinct rows (pooled background
//      RoIs) make nearly every (row, channel) of a tile a nonzero;
//    - dp2 = [h2 > 0] dh2 and db2; the live rows listed (padded to 16 with a
//      dead row, whose dp2 is 0); dW2 += h1^T dp2 (K = the live rows) and
//      dh1 = dp2 W2^T (M = the live rows; W2^T streamed as W2 is) on the
//      TF32 tensor cores, mma.sync m16n8k8, in three passes: each operand
//      split as hi = cvt.rna.tf32(a), lo = cvt.rna.tf32(a - hi), and lo*hi
//      + hi*lo + hi*hi accumulated in f32 (one pass, 10 mantissa bits, is
//      another function: tests/test_torch_sa_fused_bwd_design.py). These
//      products and dh2 decide nothing, so rounding other than cuBLAS's is
//      harmless;
//      dW2's tile sum starts from 0 and is added to the block's in f32
//      (the tensor cores' accumulation truncates). mma.sync, not wgmma:
//      h1^T dp2 reduces over the rows, so both its operands are M/N-major,
//      and TF32 wgmma takes K-major operands only; the live-row products
//      gather their rows through an index list, and the tiles are ragged.
//      mma.sync reads its fragments from any layout, split as loaded;
//    - dp1 = [h1 > 0] dh1 in place of the regathered h1; dO = -sum of dp1
//      over the centroid's live rows, written directly; dY: one atomicAdd a
//      nonzero element of dp1 a distinct live row.
//    dW2 stays in registers (64 a thread), dW3, db2 and db3 in shared
//    memory, for the block's whole run; each block writes its slice once.
//    One block of 8 warps an SM leaves little to hide latency with: the
//    FFMA recompute and the tensor-core products each run well below their
//    pipes' peaks (PERF.md has the split).
//
// 3. sa_fused_bwd_reduce sums the slices in block order, so dW/db are
//    bitwise equal between two launches. dY is deterministic only up to the
//    order of the f32 atomic additions; dO is written once.
//
// H is C with the window's row index; it differs only in the dedupe (its
// main kernel is the same body, tagged kWin so that a trace tells the two
// apart). The windows of consecutive tiles of one RoI overlap, and dY adds
// every tile's rows into the RoI's whole (N, C1) table, so nothing is
// overwritten.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "sa_common.cuh"

namespace {

constexpr int kChunk = 64;     // p3 columns a pass
constexpr int kPcLd = kChunk + 4;
constexpr int kW3Rows = 32;    // W3 rows a ring slot, kChunk columns
constexpr int kW3Ld = kChunk + 8;
static_assert(kSlot >= kW3Rows * kW3Ld, "ring slot");
static_assert(kStages * kSlot >= kRows * kPcLd, "the p3 chunk lives in the ring");

// Floats, then ints, of the dynamic shared memory.
template <int kC3>
struct Smem {
  static constexpr int kTile = kRows * kLd;
  static constexpr int kFloats = 2 * kTile + kStages * kSlot + kC3 * kC + kC + kC3;
  static constexpr int kInts = 5 * kRows + 2 * kMaxCent + 2 + 8;
  static constexpr int kBytes = 4 * (kFloats + kInts) + 8 * (kChunk + 1) + 8;  // + alignment
};
static_assert(Smem<256>::kBytes <= kMaxSmem, "shared memory");

__host__ __device__ inline long long partial_floats(int c3) {
  return static_cast<long long>(kC) * kC + kC + static_cast<long long>(kC) * c3 + c3;
}

// A centroid's cost in distinct rows: its max and its C3 nonzeros' dW3
// gathers weigh about as much as 16 rows' products (timed on the H100 at
// RCNN sa0).
constexpr int kCentroidRows = 16;

// Column of accumulator j of thread tx in an FFMA tile: four neighbours,
// then the next 64.
__device__ __forceinline__ int ffma_col(int tx, int j) { return 4 * tx + (j & 3) + 64 * (j >> 2); }

// acc[i][j] += sum over the slot's `rows` K rows of a[4 ty + i][a_k0 + k] *
// slot[k][ffma_col(tx, j)], one fmaf after another in k order from acc = 0:
// the order of a cuBLAS f32 product, so the recompute is bitwise the plain
// version's (the masks and maxima it decides must not move). float4 loads:
// 12 for every 128 (kJ = 8) or 64 FMAs.
template <int kJ>
__device__ __forceinline__ void ffma_steps(float (&acc)[4][kJ], const float* a, int a_k0,
                                           const float* slot, int slot_ld, int rows) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int k = 0; k < rows; k += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (4 * ty + i) * kLd + a_k0 + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float bv[kJ];
#pragma unroll
      for (int jh = 0; jh < kJ / 4; ++jh) {
        const float4 b = *reinterpret_cast<const float4*>(slot + (k + kk) * slot_ld + 4 * tx +
                                                          64 * jh);
        bv[4 * jh] = b.x;
        bv[4 * jh + 1] = b.y;
        bv[4 * jh + 2] = b.z;
        bv[4 * jh + 3] = b.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < kJ; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
      }
    }
  }
}

// kWin tags H's instance (the dedupe already turned its window rows into
// table rows, so the body does not read it): C and H stay apart in a trace.
template <bool kWin, int kC3>
__global__ void __launch_bounds__(kThreads, 1)
sa_fused_bwd_kernel(const float* __restrict__ y, const float* __restrict__ o,
                    const int* __restrict__ drows, const int* __restrict__ counts,
                    const float* __restrict__ w2, const float* __restrict__ w2t,
                    const float* __restrict__ b2, const float* __restrict__ w3,
                    const float* __restrict__ w3t, const float* __restrict__ b3,
                    const float* __restrict__ gout, float* __restrict__ dy,
                    float* __restrict__ dout_o, float* __restrict__ part,
                    int* __restrict__ sel, int n, int m, int cents) {
  using L = Smem<kC3>;
  extern __shared__ __align__(16) float smem[];
  float* buf_a = smem;                  // h1, then a chunk's p3 -> dp3, then dp2
  float* buf_b = buf_a + L::kTile;      // h2, then h1 again -> dp1
  float* ring = buf_b + L::kTile;       // weight K-tiles; the p3 chunk between products
  float* dw3t = ring + kStages * kSlot;  // dW3 transposed, (C3, C2)
  float* db2s = dw3t + kC3 * kC;
  float* db3s = db2s + kC;
  int* row_tab = reinterpret_cast<int*>(db3s + kC3);  // t * n + table row
  int* row_mult = row_tab + kRows;
  int* row_slot = row_mult + kRows;                   // the row's centroid in the tile
  int* lrow = row_slot + kRows;                       // live rows, then padding
  int* cent_id = lrow + 2 * kRows;
  int* cent_rs = cent_id + kMaxCent;                  // first row of each centroid, + end
  int* tile_info = cent_rs + kMaxCent + 2;            // n_cent, n_rows, n_live
  uint64_t* colmask = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uintptr_t>(tile_info + 8 + 1) & ~uintptr_t{7});  // 8-byte aligned
  uint64_t* live_mask = colmask + kChunk;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  for (int e = tid; e < kC3 * kC + kC + kC3; e += kThreads) dw3t[e] = 0.0f;
  float dw2[4][4][4];  // rows 64 (warp >> 2) + 16 mt, columns 32 (warp & 3) + 8 nt
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) dw2[i][j][q] = 0.0f;

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
      if (lane == 0) {
        tile_info[0] = nc;
        *live_mask = 0;
      }
    }
    __syncthreads();
    const int n_cent = tile_info[0];
    const int n_rows = tile_info[1];
    for (int j = warp; j < n_cent; j += kThreads / 32) {
      const int cent = cent_id[j];
      const int base = cent_rs[j];
      const int tn = (cent / m) * n;
      for (int q = lane; q < cent_rs[j + 1] - base; q += 32) {
        const int pk = drows[static_cast<size_t>(cent) * kRows + q];
        row_tab[base + q] = tn + (pk >> 7);
        row_mult[base + q] = pk & 127;
        row_slot[base + q] = j;
      }
    }
    __syncthreads();
    gather_h1(buf_a, y, o, row_tab, row_slot, cent_id, n_rows);

    // p2 = h1 W2 + b2 -> h2 = relu(p2) in buf_b, in f32 FFMA: thread (ty, tx)
    // takes rows 4 ty + i, columns ffma_col(tx, j)
    const int tx = tid & 15;
    const int ty = tid >> 4;
    {
      float acc[4][kC / 16] = {};
      ring_product(
          kC / kW2Rows, ring, [&](int i, float* slot) { load_w128(w2, i, slot); },
          [&](int i, const float* slot) {
            ffma_steps(acc, buf_a, kW2Rows * i, slot, kW2Ld, kW2Rows);
          });
#pragma unroll
      for (int j = 0; j < kC / 16; ++j) {
        const int c = ffma_col(tx, j);
        const float bc = __ldg(b2 + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) buf_b[(4 * ty + i) * kLd + c] = fmaxf(acc[i][j] + bc, 0.0f);
      }
    }
    // layer 3, kChunk columns at a time; dh2 = dp3 W3^T accumulates in
    // registers (warp: rows 32 (warp >> 2), columns 32 (warp & 3))
    float dh2[2][4][4] = {};
    const int wm = warp >> 2;
    const int ra2[2] = {32 * wm + g, 32 * wm + 16 + g};
    const int rb2[2] = {32 * wm + 8 + g, 32 * wm + 24 + g};
    const int n_rows16 = (n_rows + 15) & ~15;
    const int active2 = min(2, max(0, (n_rows16 - 32 * wm) / 16));
    float* pc = buf_a;  // p3, then dp3, of a chunk
    for (int c0 = 0; c0 < kC3; c0 += kChunk) {
      {
        // p3 = h2 W3 + b3, f32 FFMA as p2
        float acc[4][kChunk / 16] = {};
        ring_product(
            kC / kW3Rows, ring,
            [&](int i, float* slot) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = (tid >> 4) + 16 * h;
                const int c4 = 4 * (tid & 15);
                cp_async<16>(smem_addr(slot + r * kW3Ld + c4),
                             w3 + static_cast<size_t>(kW3Rows * i + r) * kC3 + c0 + c4, true);
              }
            },
            [&](int i, const float* slot) {
              ffma_steps(acc, buf_b, kW3Rows * i, slot, kW3Ld, kW3Rows);
            });
#pragma unroll
        for (int j = 0; j < kChunk / 16; ++j) {
          const int c = ffma_col(tx, j);
          const float bc = __ldg(b3 + c0 + c);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pc[(4 * ty + i) * kPcLd + c] = 4 * ty + i < n_rows ? acc[i][j] + bc : 0.0f;
        }
      }
      __syncthreads();
      // the max: dp3 = k gout / cnt on the tied rows with p3 > 0, in place.
      // Four threads a column: with fewer than four centroids they split
      // each centroid's rows (r = q mod 4) and combine by shuffles, else
      // each takes whole centroids (j = q mod 4). The same results either
      // way: cnt is a whole number, exact in any order.
      {
        const int c = tid >> 2;
        const int q = tid & 3;
        const bool split = n_cent < 4;
        uint64_t cbits = 0;
        float gpre[kMaxCent / 4];  // this thread's centroids' gout, all loads in flight
#pragma unroll
        for (int jj = 0; jj < kMaxCent / 4; ++jj) {
          const int j = split ? jj : q + 4 * jj;
          gpre[jj] = j < n_cent ? __ldg(gout + static_cast<size_t>(cent_id[j]) * kC3 + c0 + c)
                                : 0.0f;
        }
#pragma unroll
        for (int jj = 0; jj < kMaxCent / 4; ++jj) {
          const int j = split ? jj : q + 4 * jj;
          if (j >= n_cent) break;
          const int rs = cent_rs[j] + (split ? q : 0);
          const int re = cent_rs[j + 1];
          const int step = split ? 4 : 1;
          const float gj = gpre[jj];
          float mx = 0.0f;   // max of h3 = relu(p3) >= 0
          float cnt = 0.0f;  // samples at it
          int first = kRows;
#pragma unroll 4
          for (int r = rs; r < re; r += step) {
            const float v = fmaxf(pc[r * kPcLd + c], 0.0f);
            if (v > mx) {
              mx = v;
              cnt = 0.0f;
              first = r;
            }
            if (v == mx) cnt += static_cast<float>(row_mult[r]);
          }
          if (split) {
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
              const float omx = __shfl_xor_sync(0xffffffffu, mx, off);
              const float ocnt = __shfl_xor_sync(0xffffffffu, cnt, off);
              const int ofirst = __shfl_xor_sync(0xffffffffu, first, off);
              if (omx > mx) {
                mx = omx;
                cnt = ocnt;
                first = ofirst;
              } else if (omx == mx) {
                cnt += ocnt;
                first = min(first, ofirst);
              }
            }
          }
          const float g = gj / cnt;
          if (sel && (!split || q == 0))  // first tied row * 128 + tied samples, or -1
            sel[static_cast<size_t>(cent_id[j]) * kC3 + c0 + c] =
                mx > 0.0f ? (row_tab[first] - cent_id[j] / m * n) * 128 + static_cast<int>(cnt)
                          : -1;
#pragma unroll 4
          for (int r = rs; r < re; r += step) {
            const float p = pc[r * kPcLd + c];
            const float d = (p > 0.0f && p == mx) ? static_cast<float>(row_mult[r]) * g : 0.0f;
            pc[r * kPcLd + c] = d;
            if (d != 0.0f) cbits |= uint64_t{1} << r;
          }
        }
        auto all = static_cast<unsigned long long>(cbits);
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) all |= __shfl_xor_sync(0xffffffffu, all, off);
        if (q == 0) colmask[c] = all;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) all |= __shfl_xor_sync(0xffffffffu, all, off);
        if (lane == 0 && all) atomicOr(reinterpret_cast<unsigned long long*>(live_mask), all);
      }
      __syncthreads();
      // dW3[:, c] += d h2[r] and db3[c] over the column's nonzeros, in row
      // order, two at a time: warp w has columns 8 w .. 8 w + 7, lanes k
      for (int ci = 0; ci < kChunk / 8; ++ci) {
        const int c = (kChunk / 8) * warp + ci;
        uint64_t nz = colmask[c];
        float* col = dw3t + (c0 + c) * kC;
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = col[lane + 32 * i];
        float sum = 0.0f;
        while (nz) {
          const int r0 = __ffsll(static_cast<long long>(nz)) - 1;
          nz &= nz - 1;
          const int r1 = nz ? __ffsll(static_cast<long long>(nz)) - 1 : r0;
          const float d0 = pc[r0 * kPcLd + c];
          const float d1 = nz ? pc[r1 * kPcLd + c] : 0.0f;
          float h0[4], h1[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            h0[i] = buf_b[r0 * kLd + lane + 32 * i];
            h1[i] = buf_b[r1 * kLd + lane + 32 * i];
          }
          sum += d0;
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = fmaf(d0, h0[i], a[i]);
          if (nz) {
            nz &= nz - 1;
            sum += d1;
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = fmaf(d1, h1[i], a[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) col[lane + 32 * i] = a[i];
        if (lane == 0) db3s[c0 + c] += sum;
      }
      // dh2 += dp3 W3^T over the chunk's columns, on the tensor cores: dp3 is
      // sparse, but as gathers dh2 was a chain of shared-memory read-modify-
      // writes, one a nonzero, and balls of one or two distinct rows make
      // every (row, channel) of a tile a nonzero. W3^T's rows stream as W2's.
      ring_product(
          kChunk / kW2Rows, ring,
          [&](int i, float* slot) { load_w128(w3t + static_cast<size_t>(c0) * kC, i, slot); },
          [&](int i, const float* slot) {
            slot_steps<2, 4>(dh2, pc, kPcLd, ra2, rb2, kW2Rows * i, slot, kW2Ld, kW2Rows / 8,
                             32 * (warp & 3), active2);
          });
    }

    // dp2 = [h2 > 0] dh2 into buf_a (the last chunk is read: ring_product's
    // barrier), every row (0 where the warp had no rows)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = 32 * (warp & 3) + 8 * nt + 2 * t4;
        const int ia = ra2[mt] * kLd + c;
        const int ib = rb2[mt] * kLd + c;
        buf_a[ia] = buf_b[ia] > 0.0f ? dh2[mt][nt][0] : 0.0f;
        buf_a[ia + 1] = buf_b[ia + 1] > 0.0f ? dh2[mt][nt][1] : 0.0f;
        buf_a[ib] = buf_b[ib] > 0.0f ? dh2[mt][nt][2] : 0.0f;
        buf_a[ib + 1] = buf_b[ib + 1] > 0.0f ? dh2[mt][nt][3] : 0.0f;
      }
    __syncthreads();
    const uint64_t live = *live_mask;
    const int n_live = __popcll(live);
    const int n_live16 = (n_live + 15) & ~15;
    if (tid < kC) {  // db2, rows in order
      float sum = 0.0f;
      for (int r = 0; r < n_rows; ++r) sum += buf_a[r * kLd + tid];
      db2s[tid] += sum;
    }
    if (warp == 4) {  // the live rows, padded to 16 with a dead row (dp2 = 0 there)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = 32 * j + lane;
        if ((live >> r) & 1) lrow[__popcll(live & ((uint64_t{1} << r) - 1))] = r;
      }
      if (lane < n_live16 - n_live) lrow[n_live + lane] = __ffsll(static_cast<long long>(~live)) - 1;
    }
    gather_h1(buf_b, y, o, row_tab, row_slot, cent_id, n_rows);
    __syncthreads();

    // dW2 += h1^T dp2 over the live rows; warp: rows 64 (warp >> 2), columns 32
    // (warp & 3), 16 at a time. The tile's sum starts from 0 on the tensor
    // cores and is added to dw2 in f32: their f32 accumulation truncates,
    // which over a block's whole run of rows would bias dW2 by ~1e-4.
    {
      const int m0 = 64 * (warp >> 2);
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        const int n0 = 32 * (warp & 3) + 16 * nh;
        float acc[4][2][4] = {};
        for (int k0 = 0; k0 < n_live16; k0 += 8) {
          const int r0 = lrow[k0 + t4];
          const int r1 = lrow[k0 + t4 + 4];
          FragA fa[4];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const int c = m0 + 16 * mt + g;
            fa[mt].set(buf_b[r0 * kLd + c], buf_b[r0 * kLd + c + 8], buf_b[r1 * kLd + c],
                       buf_b[r1 * kLd + c + 8]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            FragB fb;
            const int c = n0 + 8 * nt + g;
            fb.set(buf_a[r0 * kLd + c], buf_a[r1 * kLd + c]);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) mma3(acc[mt][nt], fa[mt], fb);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) dw2[mt][2 * nh + nt][q] += acc[mt][nt][q];
      }
    }
    __syncthreads();  // h1 is read; dp1 replaces it below

    // dh1 = dp2 W2^T over the live rows -> dp1 = [h1 > 0] dh1 in place of h1
    {
      const int i0 = 32 * (warp >> 2);
      const int n0 = 32 * (warp & 3);
      const int active = min(2, max(0, (n_live16 - i0) / 16));
      float acc[2][4][4] = {};
      int ra[2], rb[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ra[mt] = mt < active ? lrow[i0 + 16 * mt + g] : 0;
        rb[mt] = mt < active ? lrow[i0 + 16 * mt + 8 + g] : 0;
      }
      ring_product(
          kC / kW2Rows, ring, [&](int i, float* slot) { load_w128(w2t, i, slot); },
          [&](int i, const float* slot) {
            slot_steps<2, 4>(acc, buf_a, kLd, ra, rb, kW2Rows * i, slot, kW2Ld, kW2Rows / 8, n0,
                             active);
          });
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt >= active) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = n0 + 8 * nt + 2 * t4;
          float* pa = buf_b + ra[mt] * kLd + c;
          float* pb = buf_b + rb[mt] * kLd + c;
          pa[0] = pa[0] > 0.0f ? acc[mt][nt][0] : 0.0f;
          pa[1] = pa[1] > 0.0f ? acc[mt][nt][1] : 0.0f;
          pb[0] = pb[0] > 0.0f ? acc[mt][nt][2] : 0.0f;
          pb[1] = pb[1] > 0.0f ? acc[mt][nt][3] : 0.0f;
        }
      }
    }
    __syncthreads();

    // dO = -sum of dp1 over the centroid's live rows; dY += dp1 (distinct live rows)
    for (int e = tid; e < n_cent * kC; e += kThreads) {
      const int j = e >> 7;
      const int c = e & (kC - 1);
      float sum = 0.0f;
      for (int r = cent_rs[j]; r < cent_rs[j + 1]; ++r)
        if ((live >> r) & 1) sum += buf_b[r * kLd + c];
      dout_o[static_cast<size_t>(cent_id[j]) * kC + c] = -sum;
    }
    for (int e = tid; e < n_live * kC; e += kThreads) {
      const int r = lrow[e >> 7];
      const int c = e & (kC - 1);
      const float v = buf_b[r * kLd + c];
      if (v != 0.0f) atomicAdd(dy + static_cast<size_t>(row_tab[r]) * kC + c, v);
    }
    cursor += n_cent;
  }
  __syncthreads();

  // this block's slice: dW2 | db2 | dW3 | db3, written once
  float* out = part + static_cast<size_t>(blockIdx.x) * partial_floats(kC3);
  {
    const int m0 = 64 * (warp >> 2);
    const int n0 = 32 * (warp & 3);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int r = m0 + 16 * mt + g;
        const int c = n0 + 8 * nt + 2 * t4;
        *reinterpret_cast<float2*>(out + r * kC + c) = make_float2(dw2[mt][nt][0], dw2[mt][nt][1]);
        *reinterpret_cast<float2*>(out + (r + 8) * kC + c) =
            make_float2(dw2[mt][nt][2], dw2[mt][nt][3]);
      }
  }
  float* out_w3 = out + kC * kC + kC;
  for (int e = tid; e < kC; e += kThreads) out[kC * kC + e] = db2s[e];
  for (int e = tid; e < kC * kC3; e += kThreads) {
    const int k = e / kC3;
    const int c = e % kC3;
    out_w3[e] = dw3t[c * kC + k];
  }
  for (int e = tid; e < kC3; e += kThreads) out_w3[kC * kC3 + e] = db3s[e];
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

template <bool kWin, int kC3>
cudaError_t launch_main(int blocks, cudaStream_t st, const float* y, const float* o,
                        const int* rows, const int* counts, const float* w2, const float* w2t,
                        const float* b2, const float* w3, const float* w3t, const float* b3,
                        const float* gout, float* dy, float* d_o, float* part, int* sel, int n,
                        int m, int cents) {
  static std::atomic<uint64_t> smem_set{0};
  const auto kernel = sa_fused_bwd_kernel<kWin, kC3>;
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), Smem<kC3>::kBytes, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, Smem<kC3>::kBytes, st>>>(y, o, rows, counts, w2, w2t, b2, w3, w3t,
                                                      b3, gout, dy, d_o, part, sel, n, m, cents);
  return cudaGetLastError();
}

template <bool kWin>
int launch(const void* y, const void* o, const void* idx, const void* starts, const void* w2,
           const void* w2t, const void* b2, const void* w3, const void* w3t, const void* b3,
           const void* gout, void* dy, void* d_o, void* rows, void* counts, void* part,
           void* grads, void* sel, int t, int n, int m, int s, int c3, int blocks, int nb,
           int window, void* stream) {
  if (n <= 0 || n >= (1 << 24) || s <= 0 || s > kRows || (c3 != 128 && c3 != 256) || t < 0 ||
      m < 0 || static_cast<long long>(t) * m > INT_MAX ||
      static_cast<long long>(t) * n > INT_MAX)
    return cudaErrorInvalidValue;
  const int cents = t * m;
  const long long size = partial_floats(c3);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cents > 0) {
    if (blocks < 1 || blocks > cents) return cudaErrorInvalidValue;
    const int per = kThreads / 32;
    sa_dedupe_kernel<kWin><<<(cents + per - 1) / per, kThreads, 0, st>>>(
        static_cast<const int64_t*>(idx), static_cast<const int64_t*>(starts),
        static_cast<int*>(rows), static_cast<int*>(counts), cents, n, m, s, nb, window);
    sa_scan_kernel<kCentroidRows><<<1, 1024, 0, st>>>(static_cast<const int*>(counts),
                                           static_cast<int*>(counts) + cents, cents);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    auto args = [&](auto fn) {
      return fn(blocks, st, static_cast<const float*>(y), static_cast<const float*>(o),
                static_cast<const int*>(rows), static_cast<const int*>(counts),
                static_cast<const float*>(w2), static_cast<const float*>(w2t),
                static_cast<const float*>(b2), static_cast<const float*>(w3),
                static_cast<const float*>(w3t), static_cast<const float*>(b3),
                static_cast<const float*>(gout), static_cast<float*>(dy),
                static_cast<float*>(d_o), static_cast<float*>(part), static_cast<int*>(sel), n,
                m, cents);
    };
    err = c3 == 128 ? args(launch_main<kWin, 128>) : args(launch_main<kWin, 256>);
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

// Floats of one block's dW2 | db2 | dW3 | db3 slice at C1 = C2 = 128.
long long epnet_sa_fused_bwd_partial_floats(int c3) { return partial_floats(c3); }

// y (t, n, 128), o (t, m, 128), idx (t, m, s) int64, w2 (128, 128), w2t its
// transpose, b2 (128), w3 (128, c3), w3t (c3, 128) its transpose, b3 (c3),
// gout (t, m, c3) with c3 = 128 or 256; dy (t, n, 128) ZEROED by the
// caller, d_o (t, m, 128); rows (t * m * 64) and counts (2 t m + 1) int32
// scratch; part (blocks, partial_floats(c3)) scratch; grads
// (partial_floats(c3)) receives dW2 | db2 | dW3 | db3; sel, when not null,
// (t, m, c3) int32 receives each max selection: the first tied table row *
// 128 + the tied samples, or -1 where p3 <= 0 on every row. All float32 but
// the indices, contiguous, 16-byte aligned. Needs 1 <= s <= 64, n < 2^24,
// t * n < 2^31 and 1 <= blocks <= t * m. Launches kernel C (dedupe, main, reduction) on
// `stream`, allocates nothing, returns cudaGetLastError().
int epnet_sa_fused_bwd_launch(const void* y, const void* o, const void* idx, const void* w2,
                              const void* w2t, const void* b2, const void* w3, const void* w3t,
                              const void* b3, const void* gout, void* dy, void* d_o, void* rows,
                              void* counts, void* part, void* grads, void* sel, int t, int n,
                              int m, int s, int c3, int blocks, void* stream) {
  return launch<false>(y, o, idx, nullptr, w2, w2t, b2, w3, w3t, b3, gout, dy, d_o, rows, counts,
                       part, grads, sel, t, n, m, s, c3, blocks, 1, 0, stream);
}

// Kernel H: as above with idx (t, m, s) int64 window-relative rows in
// [0, window) and starts (t, nb) int64, the first table row of the window
// of each tile of m / nb centroids; nb must divide m, window <= n.
int epnet_sa_fused_win_bwd_launch(const void* y, const void* o, const void* idx,
                                  const void* starts, const void* w2, const void* w2t,
                                  const void* b2, const void* w3, const void* w3t,
                                  const void* b3, const void* gout, void* dy, void* d_o,
                                  void* rows, void* counts, void* part, void* grads, void* sel,
                                  int t, int n, int m, int s, int c3, int nb, int window,
                                  int blocks, void* stream) {
  if (nb <= 0 || m % nb != 0 || window <= 0 || window > n) return cudaErrorInvalidValue;
  return launch<true>(y, o, idx, starts, w2, w2t, b2, w3, w3t, b3, gout, dy, d_o, rows, counts,
                      part, grads, sel, t, n, m, s, c3, blocks, nb, window, stream);
}

const char* epnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
