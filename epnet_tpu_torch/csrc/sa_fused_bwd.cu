// Backward of the fused set-abstraction interior on Hopper (sm_90a), f32
// and bf16; plain C interface. Four kernels, two designs:
//
//   C replaces the Pallas TPU kernel epnet_tpu/ops/sa_fused.py::_bwd_kernel
//     (pallas_call at :285, reached through the custom VJP of
//     fused_point_mlp_max);
//   H replaces its windowed twin ::_bwd_kernel_win (pallas_call at :528,
//     the custom VJP of fused_point_mlp_max_win);
//   C-bf16 and H-bf16 replace the same two kernels on bf16 Y, O, W2 and W3
//     (their n_splits == 1 branch, sa_fused.py:194-196, :240-242, :438-440,
//     :479), the backward of the MIXED_PRECISION train step (see "C-bf16
//     and H-bf16" below).
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
// C-bf16 and H-bf16 (sa_fused_bwd_bf16_kernel<kWin, kC3>, after the same
// dedupe and scan). The Pallas kernel's bf16 function works sample by
// sample and rounds to bf16 at five places: h1 and h2 before each product,
// dp3 and dp2 before the products that take them (dW3, dh2; dW2, dh1), and
// dp1 before the scatter into dY; db, dO and every product's sum stay f32.
// Rounding is not linear, so a distinct row's k equal samples cannot be
// folded into one before it: one sample's gradient sits on every distinct
// row (dp3 = gout / cnt on a tied row) and k multiplies where samples add:
// dW3 gathers k * bf16(dp3) (exact in f32: 8 + 7 significant bits), db3 and
// db2 sum k * dp, dO sums k * dp1 and dY adds k * bf16(dp1); dW2 = sum_r
// h1_r^T k_r bf16(dp2_r), k bf16(dp2) split exactly into two bf16 pieces
// (hi = bf16(k d), lo = k d - hi; the lo pass only where some row needs it).
// In bf16 every product a_k w_k is exact in f32, so what the kernel must
// match is only the order of the sums that decide: h2 = bf16(relu(p2)), the
// masks [p2 > 0], [p3 > 0] and each (centroid, channel)'s tied rows and cnt.
// The design, one block of two warpgroups an SM on one 64-row tile at a time:
//  - W2, |W2| and W3 resident in shared memory in bf16 for the block's run
//    (128-byte swizzled N-major panels, copied once by cp.async). The
//    forward products read them N-major (p2 = h1 W2, S = h1 |W2|, p3 = h2
//    W3: wgmma's B transposed), the backward ones as the K-major B of W^T
//    (dh2 = bf16(dp3) W3^T, dh1 = bf16(dp2) W2^T): the same bytes through
//    another descriptor, no transposed copy, no ring;
//  - the blocks split the tiles evenly, not the centroids' cost (a tile's
//    time hardly depends on its rows: on real tables the cost split left
//    the busiest block 1.6x the mean's tiles): after the dedupe,
//    sa_pack_tiles_kernel packs each chunk of 32 centroids into tiles and
//    writes a record a tile; a tile's tables are filled, and its rows'
//    table indices fetched, while the tile before it runs (two sets of
//    tables); h1 gathered once a tile (16-byte bf16 rows from L2) into a
//    K-major swizzled tile, which also serves dW2 as its M-major A;
//  - the recompute on bf16 wgmma m64n64k16 (a warpgroup 64 columns), each
//    k16 step summed from 0 on the tensor cores and added to an f32 sum on
//    the CUDA cores, the bias after; its decisions certified. The plain
//    version sums in f32 one fmaf after another in k order (cuBLAS's
//    order), within gamma_seq S of the exact sum, S = sum_k |a_k w_k|,
//    gamma_seq = K 2^-24 for any order of K = 128 terms. The tensor cores
//    add a block of b products (and their accumulator) aligned to the
//    largest magnitude among them, cut (truncated) to f32's 24 bits: less
//    than one unit of 2^-23 of that magnitude a term, plus the
//    accumulator's and the result's, (b + 2) units a block. Within a k16
//    step summed from 0 every magnitude is at most the step's S_step, so a
//    step errs by at most (16 / b)(b + 2) 2^-23 S_step <= 1.5 * 16 2^-23
//    S_step for any b >= 4, and the K / 16 f32 additions of the step sums
//    by K / 16 2^-24 S: gamma_tc = 1.5 * 16 2^-23 + K / 16 2^-24, ~7x
//    below a running sum kept on the tensor cores (whose every block may
//    carry the whole sum's magnitude). chip_smoke.py's phase 21 probes it
//    against f64 sums (random tiles, magnitudes spread over 2^-20 .. 2^1,
//    and large products cancelling beside small ones) and fails beyond it.
//    With the two bias roundings, |p_tc - p_plain| <= E = gamma (S' + |b|)
//    + 2^-22 |p|, gamma = (gamma_tc + gamma_seq)(1 + 2^-10). For p2, S' is
//    S itself (h1 >= 0: h1 |W2| on the tensor cores, whose sum of terms >= 0
//    falls short of S by at most 1.5 K 2^-23 S, lifted by 2^-15); for p3 the
//    Cauchy-Schwarz bound ||h2|| ||W3[:, c]|| (h2's row norms taken from
//    the certificate's upper ends in p2's epilogue; the maxima are flagged
//    rarely, and |W3| would not fit). An h2 element is certified when
//    bf16(relu(p - E)) == bf16(relu(p + E)) (this fixes h2 and the sign of
//    p2); a (centroid, channel) when its top row's p3 - E exceeds every
//    other distinct row's p3 + E and is > 0 (the plain version's unique
//    max), or every distinct row's p3 + E is <= 0 (no gradient: E differs
//    by row, with ||h2[r]||, so the top's p3 + E <= 0 alone leaves a row
//    below it whose wider interval reaches 0). A flagged h2 element is
//    summed again exactly, the plain version's fmaf chain from the
//    resident tiles, before p3's product reads h2 (the flags in row words,
//    a warp's lanes on neighbouring flags of one 64-column panel); a
//    flagged column takes the exact p3 of every row whose interval reaches
//    the top's, and its max, ties and cnt from those (the others lie below
//    it in the plain version too). Equal table rows at different indices
//    give equal sums in both arithmetics, so they still tie exactly.
//    PERF.md has the flagged shares on phase 21's tables;
//  - layer 3's max: the staged p3 of a 128-column pass, two threads a
//    column, one pass for the top and the others' bounds; bf16(dp3) of the
//    tied rows into dh2's K-major A (zeroed first), dh2 accumulating over
//    the passes in registers. At C3 = 128 the max also writes k bf16(dp3)'s
//    two exact bf16 pieces, and dW3's tile sum runs on the tensor cores
//    beside dh2 ((k bf16(dp3))^T h2: A M-major, B N-major), then goes into
//    the block's own slice of `part` (L2) by f32 reductions, each element
//    one thread's once a tile, so the slice is the same every launch; db3
//    from the max's own sums. At C3 = 256 (no room for the pieces) dW3 and
//    db3 are gathered over dp3's nonzeros while dh2's products run, one
//    lane four elements of a column in row order, by f32 reductions (k
//    bf16(dp3) h2 is exact in f32: each addition rounds as an fmaf would);
//  - layer 2's backward on wgmma over the whole tile (a dead row's dp2 is
//    0): dp2 = [h2 > 0] dh2 in registers, bf16(dp2) as dh1's K-major A and
//    k bf16(dp2)'s pieces as dW2's N-major B written by each element's
//    owner, db2 by shuffles and a fixed-order sum of the four warps; dh1 =
//    bf16(dp2) W2^T, and dW2's tile sum (h1^T, M-major, against the pieces,
//    N-major), from 0 on the tensor cores and added to the block's f32 dW2
//    in registers on the CUDA cores (the tensor cores' accumulation
//    truncates toward 0), so two launches are bitwise equal; dp1 =
//    [h1 > 0] dh1 staged, dO written once (two lanes a channel, even and odd
//    rows), dY by four-wide f32 atomics.
// Shared memory (bytes): W2 and |W2| 32 K each, W3 32 K / 64 K (C3 = 128 /
// 256), the h1 and h2 tiles 16 K each (h2's later holds dW2's pieces),
// bf16 dp3 / dp2 16 K, the f32 staging of S / p3 / dp1 33 K, at C3 = 128
// dW3's two bf16 pieces 32 K, tables ~5 K: ~217 K at C3 = 128, ~219 K at
// 256. dW2's f32 sums take 64 registers a thread for the block's run (255
// in all, a few spilled) and dW3's sit in the block's slice in L2: f32 dW3
// and dW2 (64 + 64 K or more) do not fit beside the resident weights.
// What bounds it: not the tensor cores (a tile's dense products take ~8 K
// cycles at their peak) but the tile's chain of dependent steps in
// lockstep on two warpgroups, each phase latency-bound on the CUDA cores
// (the certificates, the exact sums of the flagged elements, the max, the
// gathers) with one barrier between phases; PERF.md has the split.
//
// H (H-bf16) is C (C-bf16) with the window's row index; it differs only in
// the dedupe (its main kernel is the same body, tagged kWin so that a trace
// tells the two apart). The windows of consecutive tiles of one RoI overlap, and dY adds
// every tile's rows into the RoI's whole (N, C1) table, so nothing is
// overwritten.

#include <cuda_bf16.h>
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
        for (int i = 0; i < 4; ++i) {
          const float h2 = fmaxf(acc[i][j] + bc, 0.0f);
          buf_b[(4 * ty + i) * kLd + c] = h2;
        }
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
                const float* src = w3 + static_cast<size_t>(kW3Rows * i + r) * kC3 + c0 + c4;
                cp_async<16>(smem_addr(slot + r * kW3Ld + c4), src, true);
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
      for (int r = 0; r < n_rows; ++r)
        sum += buf_a[r * kLd + tid];
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

    // dO = -sum of dp1 over the centroid's live rows; dY += dp1 (distinct live
    // rows)
    for (int e = tid; e < n_cent * kC; e += kThreads) {
      const int j = e >> 7;
      const int c = e & (kC - 1);
      float sum = 0.0f;
      for (int r = cent_rs[j]; r < cent_rs[j + 1]; ++r)
        if ((live >> r) & 1)
          sum += buf_b[r * kLd + c];
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

// ---------------------------------------------------------------------------
// C-bf16 and H-bf16: the recompute on bf16 wgmma with certified decisions,
// weights resident in shared memory, layer 2's backward on wgmma.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kBfThreads = 256;  // two warpgroups, in lockstep on one tile
constexpr int kStLd = kC + 4;    // floats a row of the f32 staging tile
// E = kGamma (||a|| ||w|| + |b|) + kBiasRound |p| bounds |p_tc - p_plain|
// (the header's "certificate"): gamma_tc (each k16 step summed from 0 on
// the tensor cores, 1.5 * 16 units of 2^-23 of its magnitudes, the K / 16
// step sums added in f32) + gamma_seq (K units of 2^-24) at K = 128, a 2^-10
// margin on top for the f32 arithmetic of E itself.
constexpr float kGammaTc = 1.5f * 16 * 0x1p-23f + kC / 16 * 0x1p-24f;
constexpr float kGamma = (kGammaTc + kC * 0x1p-24f) * (1.0f + 0x1p-10f);
constexpr float kBiasRound = 0x1p-22f;  // the bias additions' two roundings
constexpr float kNormUp = 1.0f + 0x1p-15f;  // an f32 norm of 128 bf16 values, rounded up
constexpr float kSUp = 1.0f + 0x1p-15f;     // S from the tensor cores, >= 1.5 K 2^-23 up

// The bf16 kernels split the tiles, not the centroids' cost, evenly among
// the blocks (a tile's time is nearly the same whatever its rows): each chunk
// of 32 consecutive centroids is packed into tiles as pack_tile packs them,
// and each tile gets a record of kTileRec ints, in tile order: words 0 ..
// nc the first row of each of its nc centroids and the end, 33 its first
// centroid, 34 nc. They follow the counts in the counts scratch: the tiles
// of each chunk, their prefix, the records.
constexpr int kTileRec = 36;
__host__ __device__ inline int tile_chunks(int cents) { return (cents + 31) / 32; }
__host__ __device__ inline long long counts_ints_bf16(int cents) {
  return cents + 2LL * tile_chunks(cents) + 1 + static_cast<long long>(kTileRec) * cents;
}

// kWrite false: the tiles of each chunk into ntiles; true: each tile's record
// at its place (prefix: the chunks' tile prefix). A warp a chunk.
template <bool kWrite>
__global__ void __launch_bounds__(kThreads)
sa_pack_tiles_kernel(const int* __restrict__ counts, int* __restrict__ ntiles,
                     const int* __restrict__ prefix, int* __restrict__ recs, int cents) {
  const int k = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (k >= tile_chunks(cents)) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int c0 = 32 * k;
  const int n_c = min(32, cents - c0);
  const int cnt = lane < n_c ? counts[c0 + lane] : kRows + 1;
  int* rec = kWrite ? recs + static_cast<size_t>(prefix[k]) * kTileRec : nullptr;
  int start = 0, nt = 0;
  while (start < n_c) {
    int v = __shfl_down_sync(0xffffffffu, cnt, start);  // centroid start + lane
    if (lane + start >= 32) v = kRows + 1;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    const int nc = __popc(__ballot_sync(0xffffffffu, incl <= kRows));
    if (kWrite) {
      int* r = rec + nt * kTileRec;
      if (lane < nc) r[lane + 1] = incl;
      if (lane == 0) {
        r[0] = 0;
        r[33] = c0 + start;
        r[34] = nc;
      }
    }
    start += nc;
    ++nt;
  }
  if (!kWrite && lane == 0) ntiles[k] = nt;
}

// Bytes of the dynamic shared memory (offsets from a 1024-byte aligned base).
template <int kC3>
struct BfSmem {
  static constexpr int kW2Abs = 2 * kWPanel;       // W2 from 0: N-major panels; |W2|
  static constexpr int kW3 = kW2Abs + 2 * kWPanel;
  static constexpr int kH1 = kW3 + kC3 / 64 * kWPanel;
  static constexpr int kH2 = kH1 + 2 * kH1Panel;   // h2; then dW2's B pieces
  static constexpr int kD = kH2 + 2 * kH1Panel;    // bf16 dp3 of a pass; then bf16 dp2
  static constexpr int kSt = kD + 2 * kH1Panel;    // f32: p3 -> dp3 of a pass; dp2; dp1
  // C3 = 128: dW3's tile sums on the tensor cores from k bf16(dp3)'s two
  // pieces (two tiles); C3 = 256 has not the room and gathers dW3 instead
  static constexpr bool kDw3Tc = kC3 == kC;
  static constexpr int kDp = kSt + kRows * kStLd * 4;
  static constexpr int kF = kDp + (kDw3Tc ? 4 * kH1Panel : 0);
  static constexpr int kNF = 2 * kC + 3 * kC3 + kRows;  // b2 b3 wn3 db2 db3 ||h2||
  static constexpr int kColmask = kF + 4 * kNF;    // a 64-bit row mask a column of a pass
  static constexpr int kI = kColmask + 8 * kC;
  // two sets of a tile's tables (row_tab, row_mult, row_slot, cent_id,
  // cent_rs, n_cent and n_rows), tile_info, the flag words, their prefix
  static constexpr int kTab = 3 * kRows + 2 * kMaxCent + 4;
  static constexpr int kNI = 2 * kTab + 8 + 4 * kRows + 2 * kRows + 4;
  static constexpr int kBytes = kAtom + kI + 4 * kNI;  // + the base's alignment
};
static_assert(BfSmem<128>::kBytes <= kMaxSmem && BfSmem<256>::kBytes <= kMaxSmem,
              "C-bf16's shared memory");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
// v rounded to bf16, to nearest even, held in f32, by integer operations
// (finite v; the conversion instruction runs at a fraction of their rate)
__device__ __forceinline__ float rne_bf16(float v) {
  const uint32_t b = __float_as_uint(v);
  return __uint_as_float((b + 0x7FFFu + ((b >> 16) & 1u)) & 0xFFFF0000u);
}
__device__ __forceinline__ float bf16_at(const unsigned char* p) {
  return __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(p)) << 16);
}

// The plain version's sums of two rows of the bf16 tile `a` (h1 or h2)
// against columns of the resident weight w, (ra, ca) and (rb, cb): each one
// fmaf after another in k order from 0, cuBLAS's f32 order (every product of
// two bf16 values is exact in f32), the two chains side by side.
__device__ __forceinline__ float2 exact_dot2(const unsigned char* a, const unsigned char* w,
                                             int ra, int ca, int rb, int cb) {
  const unsigned char* ara = a + (ra >> 3) * kAtom + (ra & 7) * 128;
  const unsigned char* arb = a + (rb >> 3) * kAtom + (rb & 7) * 128;
  const unsigned char* wca = w + (ca >> 6) * kWPanel + ((ca & 7) << 1);
  const unsigned char* wcb = w + (cb >> 6) * kWPanel + ((cb & 7) << 1);
  float acc_a = 0.0f, acc_b = 0.0f;
#pragma unroll
  for (int k8 = 0; k8 < kC / 8; ++k8) {
    const int j = k8 & 7;
    const uint4 va = *reinterpret_cast<const uint4*>(ara + (k8 >> 3) * kH1Panel +
                                                     ((j ^ (ra & 7)) << 4));
    const uint4 vb = *reinterpret_cast<const uint4*>(arb + (k8 >> 3) * kH1Panel +
                                                     ((j ^ (rb & 7)) << 4));
    const uint32_t xa[4] = {va.x, va.y, va.z, va.w};
    const uint32_t xb[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float wa = bf16_at(wca + k8 * kAtom + i * 128 + ((((ca & 63) >> 3) ^ i) << 4));
      const float wb = bf16_at(wcb + k8 * kAtom + i * 128 + ((((cb & 63) >> 3) ^ i) << 4));
      acc_a = fmaf(__uint_as_float(i & 1 ? xa[i >> 1] & 0xFFFF0000u : xa[i >> 1] << 16), wa, acc_a);
      acc_b = fmaf(__uint_as_float(i & 1 ? xb[i >> 1] & 0xFFFF0000u : xb[i >> 1] << 16), wb, acc_b);
    }
  }
  return make_float2(acc_a, acc_b);
}

// acc (this warpgroup's 64 x 64 f32) = a (a 64 x 128 K-major bf16 tile) w
// (128 x 64, the N-major panel at wp) on the tensor cores, each k16 step
// summed from 0 and added to acc on the CUDA cores: the recompute's sums,
// whose error the certificate's gamma_tc bounds (a running sum kept on the
// tensor cores would be bounded by the whole sum's magnitudes at every
// step, 7x looser).
__device__ __forceinline__ void stepwise_product(float (&acc)[32], const unsigned char* a,
                                                 const unsigned char* wp) {
#pragma unroll
  for (int kk = 0; kk < kC / 16; ++kk) {
    float part[32];
    wgmma_fence();
    wgmma_bf16_n64<0, 1>(
        part, smem_desc<kSwizzle128>(a + (kk >> 2) * kH1Panel + 32 * (kk & 3), 16, kAtom),
        smem_desc<kSwizzle128>(wp + 2 * kAtom * kk, kWPanel, kAtom), 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = kk == 0 ? part[i] : acc[i] + part[i];
  }
}

// C-bf16's main kernel (H-bf16's after the windowed dedupe; kWin tags it):
// the f32 sums dY (atomics), dO, and the block's slice of dW2 | db2 | dW3^T
// | db3 in `part`, for the block's run of centroids. w2 (128, 128), w3 (128,
// C3) bf16 row-major; b2, b3, gout f32. sel: the max selections, as C's;
// stats: the flagged h2 elements and maxima, added up.
template <bool kWin, int kC3>
__global__ void __launch_bounds__(kBfThreads, 1)
sa_fused_bwd_bf16_kernel(const bf16* __restrict__ y, const bf16* __restrict__ o,
                         const int* __restrict__ drows, const int* __restrict__ counts,
                         const bf16* __restrict__ w2, const float* __restrict__ b2,
                         const bf16* __restrict__ w3, const float* __restrict__ b3,
                         const float* __restrict__ gout, float* __restrict__ dy,
                         float* __restrict__ dout_o, float* __restrict__ part,
                         int* __restrict__ sel, unsigned long long* __restrict__ stats, int n,
                         int m, int cents) {
  using L = BfSmem<kC3>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((kAtom - (smem_addr(smem_raw) & (kAtom - 1))) & (kAtom - 1));
  unsigned char* w2s = base;
  unsigned char* w2a = base + L::kW2Abs;
  unsigned char* w3s = base + L::kW3;
  unsigned char* h1s = base + L::kH1;
  unsigned char* h2s = base + L::kH2;
  unsigned char* ds = base + L::kD;
  unsigned char* dph = base + L::kDp;  // k bf16(dp3): hi, lo (C3 = 128)
  unsigned char* dpl = dph + 2 * kH1Panel;
  float* st = reinterpret_cast<float*>(base + L::kSt);
  float* b2s = reinterpret_cast<float*>(base + L::kF);
  float* b3s = b2s + kC;
  float* wn3 = b3s + kC3;  // ||W3[:, c]||, rounded up
  float* db2s = wn3 + kC3;
  float* db3s = db2s + kC;
  float* rown2 = db3s + kC3;  // ||h2[r]||, rounded up
  uint64_t* colmask = reinterpret_cast<uint64_t*>(base + L::kColmask);
  // a tile's tables, two sets: row_tab (t * n + table row), row_mult,
  // row_slot (the row's centroid in the tile), cent_id, cent_rs (first row of
  // each centroid, + end), then n_cent and n_rows
  int* tabs = reinterpret_cast<int*>(base + L::kI);
  int* tile_info = tabs + 2 * L::kTab;  // -, -, flagged h2, flagged maxima, lo
  unsigned* flags = reinterpret_cast<unsigned*>(tile_info + 8);  // h2's flags, 4 words a row
  int* fpre = reinterpret_cast<int*>(flags + 4 * kRows);        // their prefix by row
  float* out = part + static_cast<size_t>(blockIdx.x) * partial_floats(kC3);
  float* dw3 = out + kC * kC + kC;  // dW3^T (C3, C2), in the block's own slice (L2)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = tid >> 7;                 // warpgroup: columns 64 grp .. of its products
  const int r0 = 16 * (warp & 3) + (lane >> 2);  // accumulator rows r0, r0 + 8
  const int t2 = 2 * (lane & 3);

  load_w_panels(w2s, w2, kC);
  load_w_panels(w3s, w3, kC3);
  cp_async_commit();
  for (int e = tid; e < kC + kC3; e += kBfThreads) {
    b2s[e] = e < kC ? b2[e] : b3[e - kC];  // b3s follows b2s
    db2s[e] = 0.0f;                         // db3s follows db2s
  }
  for (int e = tid; e < kC3 * kC; e += kBfThreads) dw3[e] = 0.0f;
  if (tid < 8) tile_info[tid] = 0;
  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < 2 * kWPanel / 16; e += kBfThreads) {  // |W2|, as W2 lies
    const uint4 v = reinterpret_cast<const uint4*>(w2s)[e];
    reinterpret_cast<uint4*>(w2a)[e] =
        make_uint4(v.x & 0x7FFF7FFFu, v.y & 0x7FFF7FFFu, v.z & 0x7FFF7FFFu, v.w & 0x7FFF7FFFu);
  }
  for (int c = tid; c < kC3; c += kBfThreads) {  // W3's column norms
    float s = 0.0f;
    for (int k = 0; k < kC; ++k) {
      const float v = bf16_at(w3s + swz_off(k, c, kWPanel));
      s = fmaf(v, v, s);
    }
    wn3[c] = sqrtf(s) * kNormUp;
  }
  fence_async_shared();  // the weights' copies -> wgmma
  float dw2[2][32];      // this warpgroup's rows 64 grp .. of dW2, columns 64 h ..
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dw2[h][i] = 0.0f;

  // this block's tiles: an even share of all the tiles (their records, from
  // sa_pack_tiles_kernel, in order). A tile's tables are filled, and its
  // rows' table indices fetched, while the tile before it runs, into the
  // other set; warp 0's lanes hold the record after it, loaded a tile ahead.
  const int* tprefix = counts + cents + tile_chunks(cents);
  const int* trecs = tprefix + tile_chunks(cents) + 1;
  const int n_tiles = tprefix[tile_chunks(cents)];
  const int t_end =
      static_cast<int>(static_cast<long long>(n_tiles) * (blockIdx.x + 1) / gridDim.x);
  int tile = static_cast<int>(static_cast<long long>(n_tiles) * blockIdx.x / gridDim.x);
  int rec_a = 0, rec_b = 0;  // lane l: record word l and 32 + l of the next tile to pack
  auto load_rec = [&](int t) {
    if (t < t_end) {
      rec_a = __ldg(trecs + static_cast<size_t>(t) * kTileRec + lane);
      rec_b = lane < kTileRec - 32 ? __ldg(trecs + static_cast<size_t>(t) * kTileRec + 32 + lane)
                                   : 0;
    }
  };
  auto pack_next = [&](int t, int* tab) {  // warp 0: tile t's centroids, or none past the share
    int* info = tab + 3 * kRows + 2 * kMaxCent + 2;  // n_cent, n_rows
    if (t < t_end) {  // the record: words 0 .. nc the rows' prefix, 33 first, 34 nc
      const int first = __shfl_sync(0xffffffffu, rec_b, 1);
      const int nc = __shfl_sync(0xffffffffu, rec_b, 2);
      const int rows = nc < 32 ? __shfl_sync(0xffffffffu, rec_a, nc & 31)
                               : __shfl_sync(0xffffffffu, rec_b, 0);
      if (lane < nc) tab[3 * kRows + lane] = first + lane;
      if (lane <= nc) tab[3 * kRows + kMaxCent + lane] = rec_a;
      if (lane == 0) {
        tab[3 * kRows + kMaxCent + 32] = rec_b;  // (word 32: used when nc = 32)
        info[0] = nc;
        info[1] = rows;
      }
      load_rec(t + 1);
    } else if (lane == 0) {
      info[0] = info[1] = 0;
    }
  };
  // row t < n_rows of the packed tables `tab`: its packed row * 128 + k
  auto fetch_row = [&](const int* tab, int t) {
    const int* rs = tab + 3 * kRows + kMaxCent;
    int lo = 0, hi = tab[3 * kRows + 2 * kMaxCent + 2];  // the centroid j: rs[j] <= t < rs[j + 1]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (rs[mid] <= t)
        lo = mid;
      else
        hi = mid;
    }
    return make_int2(
        lo, __ldg(drows + static_cast<size_t>(tab[3 * kRows + lo]) * kRows + t - rs[lo]));
  };
  auto store_row = [&](int* tab, int t, int2 jp) {
    const int cent = tab[3 * kRows + jp.x];
    tab[t] = (cent / m) * n + (jp.y >> 7);
    tab[kRows + t] = jp.y & 127;
    tab[2 * kRows + t] = jp.x;
  };
  int b = 0;  // the current tile's set
  if (warp == 0) {
    load_rec(tile);
    pack_next(tile, tabs);
  }
  __syncthreads();
  if (tid < tabs[3 * kRows + 2 * kMaxCent + 3]) store_row(tabs, tid, fetch_row(tabs, tid));
  while (tile < t_end) {
    __syncthreads();  // the previous tile is done with every buffer; this one's tables are in
    int* tab = tabs + b * L::kTab;
    int* ntab = tabs + (b ^ 1) * L::kTab;
    const int* row_tab = tab;
    const int* row_mult = tab + kRows;
    const int* row_slot = tab + 2 * kRows;
    const int* cent_id = tab + 3 * kRows;
    const int* cent_rs = cent_id + kMaxCent;
    const int n_cent = cent_rs[kMaxCent + 2];
    const int n_rows = cent_rs[kMaxCent + 3];
    if (warp == 0) pack_next(tile + 1, ntab);
    if (tid == 64) tile_info[4] = 0;
    gather_h1_bf16<kBfThreads>(h1s, y, o, row_tab, row_slot, cent_id, n_rows, tid);
    fence_async_shared();  // h1's stores -> wgmma
    __syncthreads();
    const int n_next = ntab[3 * kRows + 2 * kMaxCent + 3];  // warp 0 has packed the next tile
    int2 next_row = make_int2(0, 0);
    if (tid < n_next) next_row = fetch_row(ntab, tid);  // in flight while this tile runs

    // p2 = h1 W2 + b2 on the tensor cores (warpgroup grp: columns 64 grp ..);
    // accumulator i: row r0 (+ 8 when i % 4 >= 2), column 8 (i / 4) + t2 + i % 2.
    // S = h1 |W2| first, into the staging (its terms are >= 0, so the
    // tensor cores' sum, cut toward 0, is within 1.5 K 2^-23 below S: kSUp
    // lifts it above).
    // h2 = bf16(relu(p2)) where certified, else flagged for the exact sum:
    // each thread's flags of its two rows, OR-ed over the four lanes that
    // share them, one word of 32 columns a lane, no atomics.
    {
      float sacc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk)
        wgmma_bf16_n64<0, 1>(
            sacc, smem_desc<kSwizzle128>(h1s + (kk >> 2) * kH1Panel + 32 * (kk & 3), 16, kAtom),
            smem_desc<kSwizzle128>(w2a + grp * kWPanel + 2 * kAtom * kk, kWPanel, kAtom), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; i += 2)
        *reinterpret_cast<float2*>(st + (r0 + (i & 2) * 4) * kStLd + 64 * grp + 8 * (i >> 2) + t2) =
            make_float2(sacc[i], sacc[i + 1]);
    }
    {
      float acc[32];
      stepwise_product(acc, h1s, w2s + grp * kWPanel);
      uint64_t fl[2] = {0, 0};
      float sq[2] = {0.0f, 0.0f};  // ||h2[r]||^2 over these columns (flagged: their upper ends)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = r0 + (i & 2) * 4;
        const int cl = 8 * (i >> 2) + t2;  // the column in this warpgroup's 64
        const int c = 64 * grp + cl;
        const float2 sv = *reinterpret_cast<const float2*>(st + r * kStLd + c);
        float h[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = acc[i + e] + b2s[c + e];
          const float bound =
              kGamma * fmaf(e ? sv.y : sv.x, kSUp, fabsf(b2s[c + e])) + kBiasRound * fabsf(p);
          const float lo = __fsub_rd(p, bound);
          const float hi = __fadd_ru(p, bound);
          const float up = hi > 0.0f ? rne_bf16(hi) : 0.0f;  // >= the final h2, certified or not
          const bool ok = hi <= 0.0f || (lo > 0.0f && rne_bf16(lo) == up);
          h[e] = ok ? up : 0.0f;  // bf16(p) where certified
          fl[(i >> 1) & 1] |= static_cast<uint64_t>(!ok) << (cl + e);
          sq[(i >> 1) & 1] = fmaf(up, up, sq[(i >> 1) & 1]);
        }
        *reinterpret_cast<uint32_t*>(h2s + swz_off(r, c, kH1Panel)) =
            (__float_as_uint(h[0]) >> 16) | (__float_as_uint(h[1]) & 0xFFFF0000u);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = r0 + 8 * hr;
        uint64_t f = r < n_rows ? fl[hr] : 0;
        f |= __shfl_xor_sync(0xffffffffu, f, 1);
        f |= __shfl_xor_sync(0xffffffffu, f, 2);
        sq[hr] += __shfl_xor_sync(0xffffffffu, sq[hr], 1);
        sq[hr] += __shfl_xor_sync(0xffffffffu, sq[hr], 2);
        if ((lane & 3) == hr) {
          flags[4 * r + 2 * grp] = static_cast<unsigned>(f);
          flags[4 * r + 2 * grp + 1] = static_cast<unsigned>(f >> 32);
          st[r * kStLd + kC + grp] = sq[hr];  // the staging's padding column
        }
      }
    }
    __syncthreads();
    if (warp == 0) {  // the flagged elements' prefix by (64-column panel, row)
      int n4[4], sum = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pr = 4 * lane + u;
        const unsigned* fw = flags + 4 * (pr & (kRows - 1)) + 2 * (pr >> 6);
        n4[u] = __popc(fw[0]) + __popc(fw[1]);
        sum += n4[u];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      int run = incl - sum;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        fpre[4 * lane + u] = run;
        run += n4[u];
      }
      if (lane == 31) {
        fpre[2 * kRows] = incl;
        tile_info[2] += incl;
      }
    }
    __syncthreads();
    // the flagged h2 elements, exactly: the plain version's f32 sum, bias
    // after; a thread two neighbouring flags (j = 2 t, 2 t + 1), their chains
    // side by side; a warp's lanes on neighbouring flags of one panel, so
    // their loads of W2's column elements share a 128-byte row
    {
      auto flagged = [&](int j) {  // flag j: (row, column)
        int lo = 0, hi = 2 * kRows;  // the (panel, row) with fpre[lo] <= j < fpre[lo + 1]
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (fpre[mid] <= j)
            lo = mid;
          else
            hi = mid;
        }
        const int r = lo & (kRows - 1);
        int rank = j - fpre[lo];
        unsigned w = flags[4 * r + 2 * (lo >> 6)];
        int c = 64 * (lo >> 6);
        if (rank >= __popc(w)) {
          rank -= __popc(w);
          w = flags[4 * r + 2 * (lo >> 6) + 1];
          c += 32;
        }
        for (; rank > 0; --rank) w &= w - 1;
        return make_int2(r, c + __ffs(w) - 1);
      };
      const int n_flag = fpre[2 * kRows];
      for (int j = 2 * tid; j < n_flag; j += 2 * kBfThreads) {
        const int2 fa = flagged(j);
        const int2 fb = j + 1 < n_flag ? flagged(j + 1) : fa;
        const float2 x = exact_dot2(h1s, w2s, fa.x, fa.y, fb.x, fb.y);
        *reinterpret_cast<bf16*>(h2s + swz_off(fa.x, fa.y, kH1Panel)) =
            __float2bfloat16_rn(fmaxf(x.x + b2s[fa.y], 0.0f));
        if (j + 1 < n_flag)
          *reinterpret_cast<bf16*>(h2s + swz_off(fb.x, fb.y, kH1Panel)) =
              __float2bfloat16_rn(fmaxf(x.y + b2s[fb.y], 0.0f));
      }
    }
    if (tid < kRows)  // ||h2[r]|| rounded up, from the two warpgroups' halves
      rown2[tid] = sqrtf(st[tid * kStLd + kC] + st[tid * kStLd + kC + 1]) * kNormUp;
    fence_async_shared();  // h2's stores -> wgmma
    __syncthreads();

    // layer 3, 128 columns a pass (warpgroup grp: 64 grp ..); dh2 = bf16(dp3)
    // W3^T accumulates over the passes (warpgroup grp: dh2's columns 64 grp ..)
    float dh2[32];
    for (int c0 = 0; c0 < kC3; c0 += kC) {
      {
        float acc[32];
        stepwise_product(acc, h2s, w3s + (c0 / 64 + grp) * kWPanel);
#pragma unroll
        for (int i = 0; i < 2 * kH1Panel / 16 / kBfThreads; ++i) {  // dh2's A: 0 but the ties
          reinterpret_cast<uint4*>(ds)[tid + kBfThreads * i] = make_uint4(0u, 0u, 0u, 0u);
          if constexpr (L::kDw3Tc) {  // and dW3's pieces
            reinterpret_cast<uint4*>(dph)[tid + kBfThreads * i] = make_uint4(0u, 0u, 0u, 0u);
            reinterpret_cast<uint4*>(dpl)[tid + kBfThreads * i] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
        if (tid == 0) tile_info[5] = 0;  // no lo piece yet
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int r = r0 + (i & 2) * 4;
          const int c = 64 * grp + 8 * (i >> 2) + t2;
          *reinterpret_cast<float2*>(st + r * kStLd + c) =
              make_float2(acc[i] + b3s[c0 + c], acc[i + 1] + b3s[c0 + c + 1]);
        }
      }
      __syncthreads();
      // the max: two threads a column; with one centroid they split its rows
      // (r = q mod 2) and combine by shuffles, else each takes whole
      // centroids (j = q mod 2). One pass finds the top row (its p3, first
      // row on ties), the largest p3 + bound of the others and of all rows.
      // The certificate: the top's p3 less its bound exceeds every other
      // row's p3 plus its bound (a unique max of the plain version's,
      // positive), or every row's p3 plus its bound is <= 0 (no gradient;
      // the top's alone would not do, since a row below it with a larger
      // ||h2[r]|| has a wider interval). Otherwise the column is
      // flagged: the rows whose intervals reach the top's take their exact
      // p3, and the max, its ties and cnt come from those (the others are
      // below it in the plain version too). dp3 = gout / cnt (one sample's
      // share) goes into the staging on the tied rows only, colmask marking
      // them (a row's bit), and bf16(dp3) into dh2's K-major A.
      {
        const int c = tid >> 1;
        const int q = tid & 1;
        const int gc = c0 + c;
        const bool split = n_cent < 2;
        const int step = split ? 2 : 1;
        const unsigned pair = 3u << (lane & ~1);  // the column's two lanes
        const float gw = kGamma * wn3[gc];
        const float gb = kGamma * fabsf(b3s[gc]);
        auto upper = [&](int r, float v) {  // v plus its bound, rounded up
          return __fadd_ru(v, fmaf(rown2[r], gw, gb) + kBiasRound * fabsf(v));
        };
        uint64_t cbits = 0;
        float db3p = 0.0f;  // C3 = 128: this thread's share of db3[c], k dp3 over its tied rows
        bool lo_piece = false;
        // a tied row r: its dp3 where dW3's and dh2's products read it
        auto put = [&](int r, float gs) {
          const float g = round_bf16(gs);
          *reinterpret_cast<bf16*>(ds + swz_off(r, c, kH1Panel)) = __float2bfloat16_rn(g);
          if constexpr (L::kDw3Tc) {
            const float k = static_cast<float>(row_mult[r]);
            const float kv = k * g;  // exact: 7 + 8 significant bits
            const float hi = round_bf16(kv);
            *reinterpret_cast<bf16*>(dph + swz_off(r, c, kH1Panel)) = __float2bfloat16_rn(hi);
            *reinterpret_cast<bf16*>(dpl + swz_off(r, c, kH1Panel)) = __float2bfloat16_rn(kv - hi);
            lo_piece |= kv != hi;
            db3p += k * gs;
          } else {
            st[r * kStLd + c] = gs;
            cbits |= uint64_t{1} << r;
          }
        };
        for (int jj = 0; jj < kMaxCent; ++jj) {
          const int j = split ? jj : q + 2 * jj;
          if (j >= n_cent) break;
          const int rs = cent_rs[j] + (split ? q : 0);
          const int re = cent_rs[j + 1];
          const float gj = __ldg(gout + static_cast<size_t>(cent_id[j]) * kC3 + gc);
          float top = neg_inf(), u1 = neg_inf(), u2 = neg_inf();
          int trow = kRows, urow = kRows;
#pragma unroll 4
          for (int r = rs; r < re; r += step) {
            const float v = st[r * kStLd + c];
            const float u = upper(r, v);
            if (v > top) {
              top = v;
              trow = r;
            }
            if (u > u1) {
              u2 = u1;
              u1 = u;
              urow = r;
            } else {
              u2 = fmaxf(u2, u);
            }
          }
          if (split) {
            const float ot = __shfl_xor_sync(pair, top, 1);
            const int orow = __shfl_xor_sync(pair, trow, 1);
            if (ot > top || (ot == top && orow < trow)) {
              top = ot;
              trow = orow;
            }
          }
          float ohi = urow == trow ? u2 : u1;  // the others' largest p3 + bound
          if (split) {
            ohi = fmaxf(ohi, __shfl_xor_sync(pair, ohi, 1));
            u1 = fmaxf(u1, __shfl_xor_sync(pair, u1, 1));
          }
          const float tb = fmaf(rown2[trow], gw, gb) + kBiasRound * fabsf(top);
          const float tlo = __fsub_rd(top, tb);
          // no gradient only if every row's p3 + bound is <= 0: the bounds
          // differ by row (||h2[r]||), so a row below the top can reach 0
          const bool none = u1 <= 0.0f;
          const bool unique = !none && tlo > 0.0f && tlo > ohi;
          float mx = 0.0f;   // max of h3 = relu(p3) >= 0
          float cnt = 0.0f;  // samples at it
          int first = kRows;
          if (unique) {
            mx = top;
            cnt = static_cast<float>(row_mult[trow]);
            first = trow;
          } else if (!none) {
            for (int r = rs; r < re; r += step) {
              float* p = st + r * kStLd + c;
              *p = upper(r, *p) >= tlo ? exact_dot2(h2s, w3s, r, gc, r, gc).x + b3s[gc]
                                       : neg_inf();
            }
            for (int r = rs; r < re; r += step) {
              const float v = fmaxf(st[r * kStLd + c], 0.0f);
              if (v > mx) {
                mx = v;
                cnt = 0.0f;
                first = r;
              }
              if (v == mx) cnt += static_cast<float>(row_mult[r]);
            }
            if (split) {
              const float omx = __shfl_xor_sync(pair, mx, 1);
              const float ocnt = __shfl_xor_sync(pair, cnt, 1);
              const int ofirst = __shfl_xor_sync(pair, first, 1);
              if (omx > mx) {
                mx = omx;
                cnt = ocnt;
                first = ofirst;
              } else if (omx == mx) {
                cnt += ocnt;
                first = min(first, ofirst);
              }
            }
            if (!split || q == 0) atomicAdd(tile_info + 3, 1);
          }
          const float gs = gj / cnt;
          if (sel && (!split || q == 0))  // first tied row * 128 + tied samples, or -1
            sel[static_cast<size_t>(cent_id[j]) * kC3 + gc] =
                mx > 0.0f ? (row_tab[first] - cent_id[j] / m * n) * 128 + static_cast<int>(cnt)
                          : -1;
          if (gs == 0.0f || none) continue;
          if (unique) {
            if (!split || ((trow - cent_rs[j]) & 1) == q) put(trow, gs);
          } else {
            for (int r = rs; r < re; r += step) {
              const float p = st[r * kStLd + c];
              if (p > 0.0f && p == mx) put(r, gs);
            }
          }
        }
        if constexpr (L::kDw3Tc) {
          const float other = __shfl_xor_sync(0xffffffffu, db3p, 1);  // the pair, q = 0's first
          if (q == 0) db3s[gc] += db3p + other;
          if (lo_piece) tile_info[5] = 1;
        } else {
          const auto all = static_cast<unsigned long long>(cbits) |
                           __shfl_xor_sync(0xffffffffu, static_cast<unsigned long long>(cbits), 1);
          if (q == 0) colmask[c] = all;
        }
      }
      fence_async_shared();  // dh2's A -> wgmma
      __syncthreads();
      // dh2 += bf16(dp3) W3^T: W3's panels read as the K-major B (k = C3, n = C2)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk)
        wgmma_bf16_n64<0, 0>(
            dh2, smem_desc<kSwizzle128>(ds + (kk >> 2) * kH1Panel + 32 * (kk & 3), 16, kAtom),
            smem_desc<kSwizzle128>(w3s + (c0 / 64 + (kk >> 2)) * kWPanel + 8 * grp * kAtom +
                                       32 * (kk & 3),
                                   16, kAtom),
            c0 > 0 || kk > 0);
      wgmma_commit();

      if constexpr (L::kDw3Tc) {
        // dW3's tile sum on the tensor cores, (k bf16(dp3))^T h2 from its two
        // pieces (A M-major: the pass's columns 64 grp .. of this warpgroup;
        // B N-major: h2, 64 columns a half), from 0, then added to the
        // block's slice by f32 reductions (each element one thread's, once a
        // tile: the same sums every launch)
        const bool lo = tile_info[5];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float t3[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kRows / 16; ++kk)
            wgmma_bf16_n64<1, 1>(
                t3, smem_desc<kSwizzle128>(dph + grp * kH1Panel + 2 * kAtom * kk, kH1Panel, kAtom),
                smem_desc<kSwizzle128>(h2s + h * kH1Panel + 2 * kAtom * kk, kH1Panel, kAtom),
                kk > 0);
          if (lo)
#pragma unroll
            for (int kk = 0; kk < kRows / 16; ++kk)
              wgmma_bf16_n64<1, 1>(
                  t3,
                  smem_desc<kSwizzle128>(dpl + grp * kH1Panel + 2 * kAtom * kk, kH1Panel, kAtom),
                  smem_desc<kSwizzle128>(h2s + h * kH1Panel + 2 * kAtom * kk, kH1Panel, kAtom), 1);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < 32; i += 2)
            atomicAdd(reinterpret_cast<float2*>(dw3 + static_cast<size_t>(c0 + 64 * grp + r0 +
                                                                          (i & 2) * 4) * kC +
                                                64 * h + 8 * (i >> 2) + t2),
                      make_float2(t3[i], t3[i + 1]));
        }
      } else {
        // C3 = 256: dW3[:, c] += k bf16(dp3) h2[r] and db3[c] += k dp3 over
        // the column's nonzeros in row order, while dh2's products run: warp w has the
        // pass's columns 16 w .. 16 w + 15, four side by side, lane l dW3[4 l ..
        // 4 l + 3, c] in the block's own slice, added by four-wide f32
        // reductions (no read: each element one lane's, in row order, so the
        // slice's sums are the same every launch; k bf16(dp3) h2 is exact in
        // f32, 15 + 8 significant bits, so each addition rounds as an fmaf)
#pragma unroll 1
        for (int ci = 0; ci < kC / 8; ci += 4) {
          uint64_t nzs[4];
          float sum[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            nzs[u] = colmask[16 * warp + ci + u];
            sum[u] = 0.0f;
          }
          const unsigned had = (nzs[0] != 0) | (nzs[1] != 0) << 1 | (nzs[2] != 0) << 2 |
                               (nzs[3] != 0) << 3;
          for (bool left = had != 0; left;) {  // each column's next nonzero
            left = false;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (!nzs[u]) continue;
              const int c = 16 * warp + ci + u;
              const int r = __ffsll(static_cast<long long>(nzs[u])) - 1;
              nzs[u] &= nzs[u] - 1;
              left |= nzs[u] != 0;
              const float k = static_cast<float>(row_mult[r]);
              const float d = st[r * kStLd + c];
              sum[u] += k * d;
              const float dk = k * round_bf16(d);
              const uint2 hv =
                  *reinterpret_cast<const uint2*>(h2s + swz_off(r, 4 * lane, kH1Panel));
              atomicAdd(
                  reinterpret_cast<float4*>(dw3 + static_cast<size_t>(c0 + c) * kC + 4 * lane),
                  make_float4(dk * __uint_as_float(hv.x << 16),
                              dk * __uint_as_float(hv.x & 0xFFFF0000u),
                              dk * __uint_as_float(hv.y << 16),
                              dk * __uint_as_float(hv.y & 0xFFFF0000u)));
            }
          }
          if (lane == 0)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if ((had >> u) & 1) db3s[c0 + 16 * warp + ci + u] += sum[u];
        }
      }
      wgmma_wait<0>();
      __syncthreads();  // the pass's staging is read (the next pass, dp2, write it)
    }

    // dp2 = [h2 > 0] dh2 in registers, each thread its own elements: bf16(dp2)
    // as dh1's K-major A (over the last pass's dp3), k bf16(dp2) = hi + lo
    // exactly (8 + 7 significant bits) as dW2's N-major B pieces (hi first,
    // over h2, whose values these elements' owners have read); db2 += sum of
    // k dp2, a warp's 16 rows by shuffles, then its warpgroup's four warps in
    // order through the staging
    {
      const float ka = r0 < n_rows ? static_cast<float>(row_mult[r0]) : 0.0f;
      const float kb = r0 + 8 < n_rows ? static_cast<float>(row_mult[r0 + 8]) : 0.0f;
      float cs[16];
      bool lo_left = false;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = r0 + (i & 2) * 4;
        const int c = 64 * grp + 8 * (i >> 2) + t2;
        const float k = i & 2 ? kb : ka;
        uint32_t* hp = reinterpret_cast<uint32_t*>(h2s + swz_off(r, c, kH1Panel));
        const uint32_t hv = *hp;
        const float d0 = __uint_as_float(hv << 16) > 0.0f ? dh2[i] : 0.0f;
        const float d1 = __uint_as_float(hv & 0xFFFF0000u) > 0.0f ? dh2[i + 1] : 0.0f;
        const int j = (i >> 2) * 2;
        cs[j] = i & 2 ? fmaf(k, d0, cs[j]) : k * d0;
        cs[j + 1] = i & 2 ? fmaf(k, d1, cs[j + 1]) : k * d1;
        const float p0 = round_bf16(d0), p1 = round_bf16(d1);
        const float h0 = round_bf16(k * p0), h1 = round_bf16(k * p1);
        lo_left |= k * p0 != h0 || k * p1 != h1;
        *reinterpret_cast<uint32_t*>(ds + swz_off(r, c, kH1Panel)) = pack_bf16(p0, p1);
        *hp = pack_bf16(h0, h1);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) cs[j] += __shfl_xor_sync(0xffffffffu, cs[j], off);
      if (lane < 4)  // the warp's column sums, columns 64 grp + 8 (j / 2) + t2 + j % 2
#pragma unroll
        for (int j = 0; j < 16; ++j)
          st[(warp & 3) * kStLd + 64 * grp + 8 * (j >> 1) + t2 + (j & 1)] = cs[j];
      if (lo_left) tile_info[4] = 1;
    }
    fence_async_shared();
    __syncthreads();
    if (tid < kC)
      db2s[tid] += ((st[tid] + st[kStLd + tid]) + st[2 * kStLd + tid]) + st[3 * kStLd + tid];

    // dh1 = bf16(dp2) W2^T (W2's panels as the K-major B: k = C2, n = C1) and
    // dW2's tile sum (k h1... as (h1^T) (k bf16(dp2)): A = h1 read M-major,
    // B = the pieces N-major), from 0 on the tensor cores, then added to dw2
    // in f32 (their accumulation truncates)
    float dh1[32];
    {
      float tw[2][32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk)
        wgmma_bf16_n64<0, 0>(
            dh1, smem_desc<kSwizzle128>(ds + (kk >> 2) * kH1Panel + 32 * (kk & 3), 16, kAtom),
            smem_desc<kSwizzle128>(w2s + (kk >> 2) * kWPanel + 8 * grp * kAtom + 32 * (kk & 3),
                                   16, kAtom),
            kk > 0);
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_bf16_n64<1, 1>(
              tw[h], smem_desc<kSwizzle128>(h1s + grp * kH1Panel + 2 * kAtom * kk, kH1Panel, kAtom),
              smem_desc<kSwizzle128>(h2s + h * kH1Panel + 2 * kAtom * kk, kH1Panel, kAtom),
              kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      if (tile_info[4]) {  // the lo pieces (the same value in every thread)
        __syncthreads();   // every warpgroup is done with the hi pieces
#pragma unroll
        for (int i = 0; i < kRows * 16 / kBfThreads; ++i) {  // lo = k P - bf16(k P)
          const int r = (tid >> 4) + (kBfThreads / 16) * i;
          const int k8 = tid & 15;
          const float k = r < n_rows ? static_cast<float>(row_mult[r]) : 0.0f;
          const uint4 pv = *reinterpret_cast<const uint4*>(ds + swz_off(r, 8 * k8, kH1Panel));
          const uint32_t pw[4] = {pv.x, pv.y, pv.z, pv.w};
          uint32_t lv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v0 = k * __uint_as_float(pw[e] << 16);
            const float v1 = k * __uint_as_float(pw[e] & 0xFFFF0000u);
            lv[e] = pack_bf16(v0 - round_bf16(v0), v1 - round_bf16(v1));
          }
          *reinterpret_cast<uint4*>(h2s + swz_off(r, 8 * k8, kH1Panel)) =
              make_uint4(lv[0], lv[1], lv[2], lv[3]);
        }
        fence_async_shared();
        __syncthreads();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            wgmma_bf16_n64<1, 1>(
                tw[h],
                smem_desc<kSwizzle128>(h1s + grp * kH1Panel + 2 * kAtom * kk, kH1Panel, kAtom),
                smem_desc<kSwizzle128>(h2s + h * kH1Panel + 2 * kAtom * kk, kH1Panel, kAtom), 1);
        wgmma_commit();
        wgmma_wait<0>();
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) dw2[h][i] += tw[h][i];
    }
    __syncthreads();  // every thread is done with the staging
    // dp1 = [h1 > 0] dh1 into the staging
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = r0 + (i & 2) * 4;
      const int c = 64 * grp + 8 * (i >> 2) + t2;
      const uint32_t hv = *reinterpret_cast<const uint32_t*>(h1s + swz_off(r, c, kH1Panel));
      *reinterpret_cast<float2*>(st + r * kStLd + c) =
          make_float2(__uint_as_float(hv << 16) > 0.0f ? dh1[i] : 0.0f,
                      __uint_as_float(hv & 0xFFFF0000u) > 0.0f ? dh1[i + 1] : 0.0f);
    }
    __syncthreads();
    if (tid < n_next) store_row(ntab, tid, next_row);
    // dO = -sum of k dp1 over the centroid's rows (a dead row's dp1 is 0):
    // two lanes a (centroid, channel), the even and the odd rows, their sums
    // added even + odd; dY += k bf16(dp1), one four-wide atomicAdd a row's
    // four channels unless all are 0
    for (int e = tid; e < n_cent * 2 * kC; e += kBfThreads) {  // every lane, as often
      const int j = e >> 8;
      const int c = (e >> 1) & (kC - 1);
      float sum = 0.0f;
      for (int r = cent_rs[j] + (e & 1); r < cent_rs[j + 1]; r += 2)
        sum += static_cast<float>(row_mult[r]) * st[r * kStLd + c];
      const float other = __shfl_xor_sync(0xffffffffu, sum, 1);
      if (!(e & 1)) dout_o[static_cast<size_t>(cent_id[j]) * kC + c] = -(sum + other);
    }
#pragma unroll 2
    for (int e = tid; e < n_rows * (kC / 4); e += kBfThreads) {  // four channels a lane
      const int r = e >> 5;
      const int c = 4 * (e & 31);
      const float k = static_cast<float>(row_mult[r]);
      const float4 x = *reinterpret_cast<const float4*>(st + r * kStLd + c);
      const float4 v = make_float4(k * round_bf16(x.x), k * round_bf16(x.y), k * round_bf16(x.z),
                                   k * round_bf16(x.w));
      if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
        atomicAdd(reinterpret_cast<float4*>(dy + static_cast<size_t>(row_tab[r]) * kC + c), v);
    }
    ++tile;
    b ^= 1;
  }
  __syncthreads();

  // this block's slice: dW2 | db2 | dW3^T | db3, written once
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = 64 * grp + r0 + (i & 2) * 4;
      const int c = 64 * h + 8 * (i >> 2) + t2;
      *reinterpret_cast<float2*>(out + r * kC + c) = make_float2(dw2[h][i], dw2[h][i + 1]);
    }
  for (int e = tid; e < kC; e += kBfThreads) out[kC * kC + e] = db2s[e];
  for (int e = tid; e < kC3; e += kBfThreads) out[kC * kC + kC + kC * kC3 + e] = db3s[e];
  if (stats && tid == 0) {
    atomicAdd(stats, static_cast<unsigned long long>(tile_info[2]));
    atomicAdd(stats + 1, static_cast<unsigned long long>(tile_info[3]));
  }
}

// out[t] = a[t] (64 x 128) w (128 x 64) for bf16 a, w row-major, on the tensor
// cores exactly as C-bf16's recompute sums p2 (stepwise_product): the probe
// of their accumulation. One warpgroup a t.
__global__ void __launch_bounds__(128) sa_wgmma_sum_probe(const bf16* __restrict__ a,
                                                          const bf16* __restrict__ w,
                                                          float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ws = smem_raw + ((kAtom - (smem_addr(smem_raw) & (kAtom - 1))) & (kAtom - 1));
  unsigned char* as = ws + kWPanel;
  const bf16* at = a + static_cast<size_t>(blockIdx.x) * kRows * kC;
  load_w_panels(ws, w, 64);
  for (int e = threadIdx.x; e < kRows * 16; e += 128)
    cp_async<16>(smem_addr(as + swz_off(e >> 4, 8 * (e & 15), kH1Panel)),
                 at + (e >> 4) * kC + 8 * (e & 15), true);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_shared();
  __syncthreads();
  float acc[32];
  stepwise_product(acc, as, ws);
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
  float* ot = out + static_cast<size_t>(blockIdx.x) * kRows * 64;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    ot[(r0 + (i & 2) * 4) * 64 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)] = acc[i];
}

// out[e] = sum over blocks b, in order, of part[b][e]; w3t: the slices hold
// dW3 transposed (C3, C2) and out takes it (C2, C3).
__global__ void sa_fused_bwd_reduce(const float* __restrict__ part, int blocks, long long size,
                                    float* __restrict__ out, int c3, int w3t) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= size) return;
  long long src = e;
  const long long w3 = static_cast<long long>(kC) * kC + kC;
  if (w3t && e >= w3 && e < w3 + static_cast<long long>(kC) * c3)
    src = w3 + ((e - w3) % c3) * kC + (e - w3) / c3;
  float acc = 0.0f;
  for (int b = 0; b < blocks; ++b) acc += part[static_cast<size_t>(b) * size + src];
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

template <bool kWin, int kC3>
cudaError_t launch_bf16_main(int blocks, cudaStream_t st, const bf16* y, const bf16* o,
                             const int* rows, const int* counts, const bf16* w2, const float* b2,
                             const bf16* w3, const float* b3, const float* gout, float* dy,
                             float* d_o, float* part, int* sel, unsigned long long* stats, int n,
                             int m, int cents) {
  static std::atomic<uint64_t> smem_set{0};
  constexpr int kBytes = BfSmem<kC3>::kBytes;
  const auto kernel = sa_fused_bwd_bf16_kernel<kWin, kC3>;
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), kBytes, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kBfThreads, kBytes, st>>>(y, o, rows, counts, w2, b2, w3, b3, gout, dy, d_o,
                                             part, sel, stats, n, m, cents);
  return cudaGetLastError();
}

// Checks the shapes, then launches the dedupe, the scan, `main` (unless
// there are no centroids) and the reduction of the blocks' slices.
template <bool kWin, class Main>
int launch(const void* idx, const void* starts, void* rows, void* counts, void* part,
           void* grads, int t, int n, int m, int s, int c3, int blocks, int nb, int window,
           int bf16, void* stream, Main main) {
  if (n <= 0 || n >= (1 << 24) || s <= 0 || s > kRows || (c3 != 128 && c3 != 256) || t < 0 ||
      m < 0 || static_cast<long long>(t) * m > INT_MAX ||
      static_cast<long long>(t) * n > INT_MAX)
    return cudaErrorInvalidValue;
  const int cents = t * m;
  const long long size = partial_floats(c3);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cents > 0) {
    if (blocks < 1 || blocks > cents) return cudaErrorInvalidValue;  // (tiles >= blocks: bf16)
    const int per = kThreads / 32;
    sa_dedupe_kernel<kWin><<<(cents + per - 1) / per, kThreads, 0, st>>>(
        static_cast<const int64_t*>(idx), static_cast<const int64_t*>(starts),
        static_cast<int*>(rows), static_cast<int*>(counts), cents, n, m, s, nb, window);
    int* cnt = static_cast<int*>(counts);
    if (bf16) {  // the tiles and their records
      const int chunks = tile_chunks(cents);
      const int grid = (chunks + per - 1) / per;
      sa_pack_tiles_kernel<false><<<grid, kThreads, 0, st>>>(cnt, cnt + cents, nullptr, nullptr,
                                                             cents);
      sa_scan_kernel<0><<<1, 1024, 0, st>>>(cnt + cents, cnt + cents + chunks, chunks);
      sa_pack_tiles_kernel<true><<<grid, kThreads, 0, st>>>(
          cnt, cnt + cents, cnt + cents + chunks, cnt + cents + 2 * chunks + 1, cents);
    } else {
      sa_scan_kernel<kCentroidRows><<<1, 1024, 0, st>>>(cnt, cnt + cents, cents);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = main(blocks, st, static_cast<const int*>(rows), static_cast<const int*>(counts),
               static_cast<float*>(part), cents);
    if (err != cudaSuccess) return err;
  } else {
    blocks = 0;  // no rows: the gradients of the weights are zero
  }
  const int threads = 256;
  const long long grid = (size + threads - 1) / threads;
  sa_fused_bwd_reduce<<<static_cast<unsigned>(grid), threads, 0, st>>>(
      static_cast<const float*>(part), blocks, size, static_cast<float*>(grads), c3, bf16);
  return cudaGetLastError();
}

template <bool kWin>
int launch_f32(const void* y, const void* o, const void* idx, const void* starts, const void* w2,
               const void* w2t, const void* b2, const void* w3, const void* w3t, const void* b3,
               const void* gout, void* dy, void* d_o, void* rows, void* counts, void* part,
               void* grads, void* sel, int t, int n, int m, int s, int c3, int blocks, int nb,
               int window, void* stream) {
  auto main = [&](int bl, cudaStream_t st, const int* r, const int* cnt, float* pt, int cents) {
    auto args = [&](auto fn) {
      return fn(bl, st, static_cast<const float*>(y), static_cast<const float*>(o), r, cnt,
                static_cast<const float*>(w2), static_cast<const float*>(w2t),
                static_cast<const float*>(b2), static_cast<const float*>(w3),
                static_cast<const float*>(w3t), static_cast<const float*>(b3),
                static_cast<const float*>(gout), static_cast<float*>(dy),
                static_cast<float*>(d_o), pt, static_cast<int*>(sel), n, m, cents);
    };
    return c3 == 128 ? args(launch_main<kWin, 128>) : args(launch_main<kWin, 256>);
  };
  return launch<kWin>(idx, starts, rows, counts, part, grads, t, n, m, s, c3, blocks, nb, window,
                      0, stream, main);
}

template <bool kWin>
int launch_bf16(const void* y, const void* o, const void* idx, const void* starts,
                const void* w2, const void* b2, const void* w3, const void* b3, const void* gout,
                void* dy, void* d_o, void* rows, void* counts, void* part, void* grads, void* sel,
                void* stats, int t, int n, int m, int s, int c3, int blocks, int nb, int window,
                void* stream) {
  auto main = [&](int bl, cudaStream_t st, const int* r, const int* cnt, float* pt, int cents) {
    auto args = [&](auto fn) {
      return fn(bl, st, static_cast<const bf16*>(y), static_cast<const bf16*>(o), r, cnt,
                static_cast<const bf16*>(w2), static_cast<const float*>(b2),
                static_cast<const bf16*>(w3), static_cast<const float*>(b3),
                static_cast<const float*>(gout), static_cast<float*>(dy),
                static_cast<float*>(d_o), pt, static_cast<int*>(sel),
                static_cast<unsigned long long*>(stats), n, m, cents);
    };
    return c3 == 128 ? args(launch_bf16_main<kWin, 128>) : args(launch_bf16_main<kWin, 256>);
  };
  return launch<kWin>(idx, starts, rows, counts, part, grads, t, n, m, s, c3, blocks, nb, window,
                      1, stream, main);
}

}  // namespace

extern "C" {

// Floats of one block's dW2 | db2 | dW3 | db3 slice at C1 = C2 = 128.
long long epnet_sa_fused_bwd_partial_floats(int c3) { return partial_floats(c3); }

// Ints of the counts scratch for t * m = cents centroids: kernels C and H,
// or (bf16) C-bf16 and H-bf16.
long long epnet_sa_fused_bwd_counts_ints(int cents, int bf16) {
  return bf16 ? counts_ints_bf16(cents) : 2LL * cents + 1;
}

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
  return launch_f32<false>(y, o, idx, nullptr, w2, w2t, b2, w3, w3t, b3, gout, dy, d_o, rows,
                           counts, part, grads, sel, t, n, m, s, c3, blocks, 1, 0, stream);
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
  return launch_f32<true>(y, o, idx, starts, w2, w2t, b2, w3, w3t, b3, gout, dy, d_o, rows,
                          counts, part, grads, sel, t, n, m, s, c3, blocks, nb, window, stream);
}

// C-bf16: kernel C's arguments without the transposed weights, with y, o,
// w2 and w3 bf16 (16-byte aligned), the biases, gout and every output f32:
// dy, d_o and grads receive the f32 sums that the caller casts (dy and d_o
// to y's and o's dtype, dW to w's). stats, when not null, (2) uint64
// receives the added counts of flagged h2 elements and flagged maxima.
// part holds each block's dW3 transposed; grads receives it (128, c3).
int epnet_sa_fused_bwd_bf16_launch(const void* y, const void* o, const void* idx, const void* w2,
                                   const void* b2, const void* w3, const void* b3,
                                   const void* gout, void* dy, void* d_o, void* rows,
                                   void* counts, void* part, void* grads, void* sel, void* stats,
                                   int t, int n, int m, int s, int c3, int blocks, void* stream) {
  return launch_bf16<false>(y, o, idx, nullptr, w2, b2, w3, b3, gout, dy, d_o, rows, counts, part,
                            grads, sel, stats, t, n, m, s, c3, blocks, 1, 0, stream);
}

// H-bf16: C-bf16's arguments with kernel H's idx, starts, nb and window.
int epnet_sa_fused_win_bwd_bf16_launch(const void* y, const void* o, const void* idx,
                                       const void* starts, const void* w2, const void* b2,
                                       const void* w3, const void* b3, const void* gout,
                                       void* dy, void* d_o, void* rows, void* counts, void* part,
                                       void* grads, void* sel, void* stats, int t, int n, int m,
                                       int s, int c3, int nb, int window, int blocks,
                                       void* stream) {
  if (nb <= 0 || m % nb != 0 || window <= 0 || window > n) return cudaErrorInvalidValue;
  return launch_bf16<true>(y, o, idx, starts, w2, b2, w3, b3, gout, dy, d_o, rows, counts, part,
                           grads, sel, stats, t, n, m, s, c3, blocks, nb, window, stream);
}

// The certificate's constants at K = 128: gamma_tc (which = 0) and gamma
// (which = 1), as C-bf16 and H-bf16 use them.
float epnet_sa_fused_bwd_bf16_gamma(int which) { return which ? kGamma : kGammaTc; }

// out (tiles, 64, 64) f32 = a (tiles, 64, 128) w (128, 64), bf16 row-major,
// summed as C-bf16's recompute sums (sa_wgmma_sum_probe); on `stream`.
int epnet_sa_wgmma_sum_probe(const void* a, const void* w, void* out, int tiles, void* stream) {
  if (tiles <= 0) return cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  const int bytes = kAtom + kWPanel + 2 * kH1Panel;
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(sa_wgmma_sum_probe), bytes, smem_set);
  if (err != cudaSuccess) return err;
  sa_wgmma_sum_probe<<<tiles, 128, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w), static_cast<float*>(out));
  return cudaGetLastError();
}

const char* epnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
