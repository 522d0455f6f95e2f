// Weight gradient of the image tower's 3x3 SAME convolutions on Hopper
// (sm_90a), f32 and bf16; plain C interface. One kernel at two strides, and
// a bf16 kernel at two strides (D-bf16, E-bf16; see the end of this comment):
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
// Both are a GEMM with a small output, M = 9C rows (tap d, e and channel c)
// by N = F columns, over a long reduction, K = B * Ho * Wo output pixels:
// 491,520 at the tower's first block (batch 4, 384 x 1280). At the train
// shapes every one of the four stride-2 convs is 2 * 9 * C * F * K = 36.2
// GFLOP and every stride-1 conv 72.5 GFLOP, against 0.2-0.6 GB of x and dy.
// The TPU kernels walked row tiles in a sequential grid and kept all nine
// (C, F) slots resident in VMEM from one step to the next; Hopper blocks run
// unordered, so nothing is carried between them. Instead K is split: block
// (tile, split) owns a 128 x TN tile of the (9C, F) output (TN = 128, or 64
// when F <= 64) and a contiguous run of K, and accumulates its tile in
// registers. Row m = (d * 3 + e) * C + c of the A tile reads pixel (b, S*h +
// d - P, S*w + e - P), channel c (stride S, pad P = 1 at stride 1, 0 at
// stride 2: the only difference between D and E), so a row's 4-channel
// group is 16 bytes of x. Tiles of one split are neighbours in the grid, so
// the blocks in flight read the same pixels and x and dy come from L2 more
// than once but from device memory about once. Each block writes its tile
// to its own slice of a (splits, 9C, F) buffer; a second kernel sums the
// slices in split order, so dw is bitwise reproducible (no atomics).
//
// The products run on the TF32 tensor cores in three passes, so that the
// sum keeps f32's accuracy (the recipe is f32 with TF32 off; one TF32 pass,
// 10 mantissa bits, is another function). Each operand is split as hi =
// tf32(a), lo = tf32(a - hi), both rounded to nearest (split_tf32 of
// csrc/wgmma_common.cuh), and the tile accumulates lo*hi + hi*lo + hi*hi in
// f32 (the dropped lo*lo is ~2^-22 of a product). So the bound of this
// design is 3 x 36.2 GFLOP (D) or 3 x 72.5 GFLOP (E) at the 495 TFLOP/s
// TF32 rate, 0.22 or 0.44 ms a conv; the cuDNN Winograd count at the f32
// pipes (0.30 or 0.27 ms) is about as low, and Winograd on tensor cores is
// later work. The products are wgmma m64nNk8, two warpgroups of 64 rows
// each. wgmma takes TF32 only K-major, and both operands are M- or N-major
// in memory (a pixel's channels, a pixel's dy row). So each step of 16
// pixels is copied raw by cp.async into a 4-slot ring (three steps ahead),
// and then: A, the x rows, goes to registers in the mma fragment layout,
// split there, each thread reading only its own rows (so each element is
// split once); B, dy, is split by the threads into hi and lo planes in the
// K-major 64-byte swizzled layout that wgmma reads from shared memory. Rows
// of the raw slots are padded so that both reads, and the plane writes,
// fall in 32 distinct banks; a step's raw slot holds its 16 pixels
// whatever their stride in x, so the padding serves both strides. Once a
// step's wgmmas are done, its block splits the next step while the other
// block on the SM keeps the tensor cores busy. Shared-memory traffic, not
// the tensor cores, bounds this design on the H100: keeping A out of shared
// memory is what brought E level with conv2d_weight. The SAME pad, the
// image edges and the ends of the split are the copy's zero-fill.
//
// D-bf16 and E-bf16 (conv3x3_dw_bf16_kernel) take bf16 x and dy, the
// MIXED_PRECISION tower's, as the Pallas kernels take them (conv2d.py:
// 316-318 dots bf16 operands into f32; conv_dw_pallas_attic.py:232-233
// keeps its scratch in x's and dy's dtype) and as XLA's bf16 weight
// gradient does on the JAX package's default route: products of bf16
// operands summed in f32, the sum written f32 (the caller rounds it to w's
// dtype once, conv2d.py:191). They replace the same TPU kernels as D and E,
// run on bf16: conv2d.py::_dw_kernel (:346) and the attic's :363, :220 at
// stride 2, :306, :113 at stride 1.
//
// What bounds them. Their 36.2 / 72.5 GFLOP a conv take 0.037 / 0.073 ms
// on the 989 TFLOP/s bf16 tensor cores, and their x and dy 0.04-0.09 ms of
// HBM time; what a block brings into shared memory is far more. An im2col
// tile (rows m = tap and channel) reads x again for every tap and every
// column tile, and dy again for every row tile: the first bf16 design (128
// x 128 tiles, per-thread cp.async) moved 0.57-1.2 GB a conv into shared
// memory, and its copies alone took 65-78% of its time; its split-K
// partials (23-52 MB) took 0.007-0.025 ms more to reduce.
//
// The design. A block owns 64 channels of x by 64 columns of dy in all nine
// taps, a 576 x 64 tile, and fills an SM: one producer warp keeps a ring of
// stages filled by TMA (cp.async.bulk.tensor, 128-byte swizzle, out of
// bounds read as zeros: the SAME pad and the image edges), three consumer
// warpgroups wait on the ring's mbarriers, and warpgroup e (tap column e)
// runs wgmma m64n192k16 with A = dy (64 columns, M-major) and B = three taps
// d of 64 channels (N-major). A stage is 4 output rows by 16 columns; its x
// box holds the rows all three taps d read, so tap d is a descriptor that
// starts d rows of x later (the N chunks of B lie one x row apart), and, in
// the box shared by tap columns that read shifted pixels, tap e is a
// descriptor that starts e pixels later: the swizzle follows the rows'
// shared-memory addresses, so any row can start an operand. At stride 1 one
// box of 24 columns serves e = 0, 1, 2; at stride 2 x is read as pixel
// pairs (channels 2C), and box A (the even columns, 17 pairs) serves e = 0
// and 2, box B (the odd columns) e = 1. A stage brings 26 KB (E) or 45 KB
// (D) for 2.4 M products: 0.011 and 0.020 bytes a product, against the
// first design's 0.031-0.047; 0.35-0.41 GB a conv, 1.6-2.9x fewer (phase
// 21 of chip_smoke.py prints both). What bounds it now (PERF.md):
// E's products, which alone run at 88% of the bf16 peak, and the ring's
// writes that share shared memory with them; D's stages, which arrive at
// the rate an SM takes in (about 28 bytes a cycle), and at blk0 the HBM.
// Multicasting x to a cluster of two blocks halved the L2's reads of x but
// not an SM's intake, and gained under 2%. K is split only as far as one
// wave of blocks fills the card: at most one tile of partial sums an SM
// (19.5 MB at 132 SMs), summed in split order by conv3x3_dw_reduce, so dw
// is bitwise reproducible.

#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 128;     // output rows (tap, channel) per block
constexpr int kEK = 16;      // pixels a step (two k8 slices)
constexpr int kERing = 4;    // steps of raw x and dy in the cp.async ring
constexpr int kEBlocks = 2;  // resident blocks an SM (shared memory)
// B (pixel k, column n) sits in shared memory as hi and lo TF32 planes,
// K-major, in 64-byte swizzled atoms as wgmma reads them: 8 rows of 64 bytes
// (a row is the step's 16 pixels), the 16-byte chunk j of row r stored at
// chunk j ^ r / 2. A comes from registers.
constexpr int kEGroup = 512;

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

template <int TN>
struct ETile {
  static constexpr int kAStride = kTM + 8;  // floats a pixel row of raw A (x rows)
  static constexpr int kBStride = TN + 8;   // floats a pixel row of raw B (dy)
  static constexpr int kRaw = kEK * (kAStride + kBStride) * 4;  // bytes a ring slot
  static constexpr int kB = TN / 8 * kEGroup;   // bytes of one plane of B
  static constexpr int kBuf = 2 * kB;           // B hi, B lo
  static constexpr int kSmem = 2 * kBuf + kERing * kRaw + 1024;  // + alignment
};

// D (S = 2) and E (S = 1).
template <int S, int TN>
__global__ void __launch_bounds__(kThreads, kEBlocks)
conv3x3_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ part, int h_in, int w_in, int c, int f,
                  long long k_total, int m_tiles, int tiles, int splits) {
  using G = ETile<TN>;
  constexpr int kPad = S == 1 ? 1 : 0;               // SAME pad before the image
  constexpr int kAPasses = kEK * kTM / 4 / kThreads;  // 16-byte A copies a thread: 2
  constexpr int kBChunks = TN / 4;                    // 16-byte copies a B row
  constexpr int kBRows = kThreads / kBChunks;         // B rows a pass: 8 or 16
  constexpr int kBPasses = kEK / kBRows;              // 2 or 1
  constexpr int kBCols = TN / 64;                     // B columns a thread splits: 2 or 1
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // kERing slots of raw A [kEK][kAStride] (x rows) and raw B [kEK][kBStride] (dy)
  unsigned char* ring = smem + 2 * G::kBuf;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x % tiles;
  const int split = blockIdx.x / tiles;
  const int m0 = (tile % m_tiles) * kTM;
  const int n0 = (tile / m_tiles) * TN;
  const int m_total = 9 * c;
  const int ho = h_in / S;
  const int wo = w_in / S;
  const long long kb = k_total * split / splits;
  const long long ke = k_total * (split + 1) / splits;

  // copies: rows a_m .. a_m + 3 (one tap, 4 channels) at pixels k0 + a_kk + 8q;
  // dy columns b_n .. b_n + 3 at pixels k0 + b_kk + kBRows q
  const int a_m = m0 + 4 * (tid & 31);
  const bool a_ok = a_m < m_total;
  const int tap = a_ok ? a_m / c : 0;
  const int a_c = a_m - tap * c;
  const int a_dh = tap / 3 - kPad;
  const int a_dw = tap % 3 - kPad;
  const int a_kk = tid >> 5;
  int pb[kAPasses], ph[kAPasses], pw[kAPasses];
#pragma unroll
  for (int q = 0; q < kAPasses; ++q) {
    const long long k = kb + a_kk + 8 * q;
    pw[q] = static_cast<int>(k % wo);
    const long long t = k / wo;
    ph[q] = static_cast<int>(t % ho);
    pb[q] = static_cast<int>(t / ho);
  }
  const int b_n = n0 + 4 * (tid % kBChunks);
  const bool b_ok = b_n < f;
  const int b_kk = tid / kBChunks;
  auto load = [&](long long k0, int slot) {
    float* a_dst = reinterpret_cast<float*>(ring + slot * G::kRaw) + 4 * (tid & 31);
#pragma unroll
    for (int q = 0; q < kAPasses; ++q) {
      const int hh = S * ph[q] + a_dh;
      const int ww = S * pw[q] + a_dw;
      const bool in = a_ok && k0 + a_kk + 8 * q < ke && hh >= 0 && hh < h_in && ww >= 0 &&
                      ww < w_in;
      cp_async<16>(smem_addr(a_dst + (a_kk + 8 * q) * G::kAStride),
                   in ? x + ((static_cast<size_t>(pb[q]) * h_in + hh) * w_in + ww) * c + a_c : x,
                   in);
      advance(pb[q], ph[q], pw[q], kEK, ho, wo);
    }
    float* b_dst = reinterpret_cast<float*>(ring + slot * G::kRaw) + kEK * G::kAStride +
                   4 * (tid % kBChunks);
#pragma unroll
    for (int q = 0; q < kBPasses; ++q) {
      const long long k = k0 + b_kk + kBRows * q;
      const bool in = b_ok && k < ke;
      cp_async<16>(smem_addr(b_dst + (b_kk + kBRows * q) * G::kBStride),
                   in ? dy + static_cast<size_t>(k) * f + b_n : dy, in);
    }
  };

  // B's split: this thread takes columns 8 warp + (lane & 7) (+ 64) at pixels
  // 4j + (lane >> 3) of the slot; a warp reads 32 distinct banks of the raw
  // slot (row stride = 8 mod 32) and writes 32 distinct banks of the plane,
  // g8 * 512 + (lane & 7) * 64 + (j ^ (lane & 7) / 2) * 16 + (lane >> 3) * 4
  const int st_off = (lane & 7) * 64 + (lane >> 3) * 4;
  const int st_x = (lane & 7) / 2;
  auto convert = [&](int slot, int buf) {
    const float* rb = reinterpret_cast<const float*>(ring + slot * G::kRaw) + kEK * G::kAStride;
    unsigned char* hi = smem + buf * G::kBuf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * j + (lane >> 3);
#pragma unroll
      for (int r = 0; r < kBCols; ++r) {
        const int g8 = warp + 8 * r;
        const int off = g8 * kEGroup + (j ^ st_x) * 16 + st_off;
        float h, l;
        split_tf32(rb[k * G::kBStride + 8 * g8 + (lane & 7)], h, l);
        *reinterpret_cast<float*>(hi + off) = h;
        *reinterpret_cast<float*>(hi + G::kB + off) = l;
      }
    }
  };
  // A's fragments from the raw slot, split in registers: this warp's rows
  // row and row + 8 at pixels 8 kk + (lane & 3) and + 4 (bank = 8 k + m mod 32:
  // 32 distinct)
  const int wg = warp >> 2;  // warpgroup: rows 64 wg .. 64 wg + 63 of the tile
  const int row = 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int t = lane & 3;
  auto fragments = [&](int slot, uint32_t (&ah)[kEK / 8][4], uint32_t (&al)[kEK / 8][4]) {
    const float* ra = reinterpret_cast<const float*>(ring + slot * G::kRaw);
#pragma unroll
    for (int kk = 0; kk < kEK / 8; ++kk) {
      const float* p = ra + (8 * kk + t) * G::kAStride + row;
      split_tf32(p[0], ah[kk][0], al[kk][0]);
      split_tf32(p[8], ah[kk][1], al[kk][1]);
      split_tf32(p[4 * G::kAStride], ah[kk][2], al[kk][2]);
      split_tf32(p[4 * G::kAStride + 8], ah[kk][3], al[kk][3]);
    }
  };

  float acc[TN / 2];  // set by the first wgmma (scale-d 0)
  uint32_t ah[kEK / 8][4], al[kEK / 8][4];

  // Step i: raw in ring slot i % kERing (copied kERing - 1 steps ahead). Its
  // B split sits in plane buffer i % 2 and its A fragments in registers; once
  // its wgmmas are done, step i + 1 is split while the other block on the SM
  // keeps the tensor cores busy.
  const long long steps = (ke - kb + kEK - 1) / kEK;
#pragma unroll
  for (int i = 0; i < kERing - 1; ++i) {
    if (i < steps) load(kb + static_cast<long long>(i) * kEK, i);
    cp_async_commit();
  }
  cp_async_wait<kERing - 2>();
  __syncthreads();
  if (steps > 0) {
    convert(0, 0);
    fragments(0, ah, al);
  }
  fence_async_shared();
  __syncthreads();
  for (long long i = 0; i < steps; ++i) {
    const unsigned char* b_hi = smem + (i & 1) * G::kBuf;
    const unsigned char* b_lo = b_hi + G::kB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kEK / 8; ++kk) {
      const uint64_t bh = smem_desc<kSwizzle64>(b_hi + 32 * kk, 16, kEGroup);
      const uint64_t bl = smem_desc<kSwizzle64>(b_lo + 32 * kk, 16, kEGroup);
      wgmma_tf32<TN>(acc, al[kk], bh, i > 0 || kk > 0);
      wgmma_tf32<TN>(acc, ah[kk], bl, 1);
      wgmma_tf32<TN>(acc, ah[kk], bh, 1);
    }
    wgmma_commit();
    const long long next = i + kERing - 1;  // into the slot of step i - 1
    if (next < steps) load(kb + next * kEK, static_cast<int>(next % kERing));
    cp_async_commit();
    wgmma_wait<0>();              // step i's wgmmas are done with its registers
    cp_async_wait<kERing - 2>();  // step i + 1 has landed
    __syncthreads();
    if (i + 1 < steps) {
      convert(static_cast<int>((i + 1) % kERing), static_cast<int>((i + 1) & 1));
      fragments(static_cast<int>((i + 1) % kERing), ah, al);
    }
    fence_async_shared();
    __syncthreads();
  }
  cp_async_wait<0>();

  // accumulator 4j + r: row (+ 8 for r >= 2), columns 8j + 2t, 8j + 2t + 1
  float* out = part + static_cast<size_t>(split) * m_total * f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + row + 8 * h;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if (n < f)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(m) * f + n) =
            steps > 0 ? make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1])
                      : make_float2(0.0f, 0.0f);
    }
  }
}

// ---- D-bf16 and E-bf16: TMA ring, one producer warp, bf16 wgmma m64n192k16 ----

constexpr int kChunk = 64;     // channels of x, and columns of dy, a box row (128 bytes)
constexpr int kRows = 4;       // output rows a stage
constexpr int kCols = 16;      // output columns a stage: every tower width is a multiple
constexpr int kDyPitch = kCols * kChunk * 2;  // a dy box row: 16 pixels, two 128-byte atoms
constexpr int kTaps = 3;       // consumer warpgroups: tap column e
constexpr int kTmaThreads = kTaps * 128 + 32;  // + the producer warp

// Stage: x box(es), then the dy box, each at a multiple of 1024 bytes. S =
// 1: one x box from w0 - 1, whose first 18 columns all three tap columns
// read, shifted by e pixels; it loads 24, so that its rows of x start on
// 1024-byte atoms (with 18 the products ran slower, for fewer bytes). S = 2
// (x as pixel pairs): box A, the even columns
// (channels c of pairs w0 .. w0 + 16), which taps e = 0 and 2 read (shifted
// by 0 and 1 pair), and box B, the odd columns (channels C + c, 16 pairs),
// tap e = 1's. The rows of a box are its pixels, 128 bytes each, swizzled by
// their shared-memory address (as wgmma reads them), so a shifted operand
// is a descriptor that starts one or two rows later.
template <int S>
struct TmaTile {
  // x rows a box: output rows h0 .. h0 + 3 read x rows S h + d - P, d = 0 .. 2
  static constexpr int kXRows = S == 1 ? kRows + 2 : 2 * kRows + 1;
  static constexpr int kXCols = S == 1 ? kCols + 8 : kCols + 1;  // box A
  static constexpr int kXPitch = kXCols * kChunk * 2;
  static constexpr int kXBoxA = (kXRows * kXPitch + 1023) / 1024 * 1024;
  static constexpr int kXBoxB = S == 1 ? 0 : kXRows * kDyPitch;
  static constexpr int kDyBox = kRows * kDyPitch;
  static constexpr int kStage = kXBoxA + kXBoxB + kDyBox;  // E 26,624, D 47,104 bytes
  // bytes a stage's boxes bring (box A's alignment padding is not loaded)
  static constexpr int kLoad = kXRows * kXPitch + kXBoxB + kDyBox;
  static constexpr int kStages = S == 1 ? 8 : 4;
  static constexpr int kSmem = kStages * kStage + 1024 + 2 * kStages * 8;  // + alignment, barriers
};

// A descriptor of rows of 64 bf16 values (128-byte swizzled) at p, which
// need not start an atom: 8 rows a k-group (1024 bytes apart), 64-value
// chunks of N (or M) lbo bytes apart. The swizzle follows the rows'
// addresses, so the base offset stays 0 (one set to p's row in its atom
// read the wrong rows).
__device__ __forceinline__ uint64_t desc_rows(const void* p, uint32_t lbo) {
  return smem_desc<kSwizzle128>(p, lbo, 1024);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Waits until the phase of the given parity has completed. A lost arrival
// traps (a launch error) rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}
// A 4-d box of `map` at coordinates (c0, c1, c2, c3), innermost first, into
// shared memory at dst; its bytes complete the transaction of barrier bar.
// Coordinates outside the tensor read as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// D-bf16 (S = 2) and E-bf16 (S = 1). Block (split, tile): tile = (channel
// chunk, dy column chunk), 64 x 64 of each of the nine taps; warpgroup e
// owns tap column e, a (64 dy columns) x (3 taps d, 64 channels) product.
// xmap and xmap_b (box B, S = 2 only): x as (C, W, H, B) at S = 1, as (2C,
// W / 2, H, B) at S = 2 (pixel pairs: tap e = 0, 1 is channel e C + c of
// pair w, e = 2 channel c of pair w + 1); dymap: dy as (F, Wo, Ho, B). All
// 128-byte swizzled boxes.
template <int S>
__global__ void __launch_bounds__(kTmaThreads, 1)
conv3x3_dw_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap xmap_b,
                       const __grid_constant__ CUtensorMap dymap, float* __restrict__ part,
                       int c, int f, int ho, int wo, int batch, int tiles, int splits) {
  using G = TmaTile<S>;
  constexpr int kPad = S == 1 ? 1 : 0;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t full0 = smem_addr(smem + G::kStages * G::kStage);  // kStages full, then empty
  const uint32_t empty0 = full0 + 8 * G::kStages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x % tiles;
  const int split = blockIdx.x / tiles;
  const int f_chunks = (f + kChunk - 1) / kChunk;
  const int f0 = (tile % f_chunks) * kChunk;
  const int c0 = (tile / f_chunks) * kChunk;
  // K: stage (b, column block, row block), row blocks fastest: a box's last
  // rows are the next stage's first, still in L2
  const int col_blocks = (wo + kCols - 1) / kCols;
  const int row_blocks = (ho + kRows - 1) / kRows;
  const long long stages = static_cast<long long>(batch) * row_blocks * col_blocks;
  const long long kb = stages * split / splits;
  const int steps = static_cast<int>(stages * (split + 1) / splits - kb);

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);                // the producer's arrival and the bytes
      mbar_init(empty0 + 8 * s, kTaps * 4);      // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kTaps * 4) {  // producer
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % G::kStages;
        if (i >= G::kStages) mbar_wait(empty0 + 8 * s, (i / G::kStages - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, G::kLoad);
        const long long t = kb + i;
        const int h0 = static_cast<int>(t % row_blocks) * kRows;
        const int w0 = static_cast<int>(t / row_blocks % col_blocks) * kCols;
        const int b = static_cast<int>(t / (static_cast<long long>(col_blocks) * row_blocks));
        const uint32_t st = smem_addr(smem + s * G::kStage);
        tma_load_4d(st, &xmap, full, c0, w0 - kPad, S * h0 - kPad, b);
        if (S == 2) tma_load_4d(st + G::kXBoxA, &xmap_b, full, c + c0, w0, S * h0, b);
        tma_load_4d(st + G::kXBoxA + G::kXBoxB, &dymap, full, f0, w0, h0, b);
      }
    }
  } else {
    // consumers: warpgroup e, this warp's rows 16 (warp & 3) .. + 15 of the
    // 64 dy columns. Tap column e's x rows: box A shifted by e pixels (S =
    // 1) or e / 2 pairs (S = 2, e even), box B (S = 2, e = 1).
    const int e = warp >> 2;
    float acc[96];  // set by the first wgmma (scale-d 0)
    const int x_off = S == 1 ? e * 128 : (e == 1 ? G::kXBoxA : (e / 2) * 128);
    const int x_pitch = S == 2 && e == 1 ? kDyPitch : G::kXPitch;
    for (int i = 0; i < steps; ++i) {
      const int s = i % G::kStages;
      mbar_wait(full0 + 8 * s, (i / G::kStages) & 1);
      const unsigned char* st = smem + s * G::kStage;
      const unsigned char* xs = st + x_off;
      const unsigned char* dys = st + G::kXBoxA + G::kXBoxB;
      wgmma_fence();
#pragma unroll
      for (int r = 0; r < kRows; ++r)  // k16: output row r's 16 pixels
        wgmma_bf16_mn_192(acc, desc_rows(dys + r * kDyPitch, kDyPitch),
                          desc_rows(xs + S * r * x_pitch, x_pitch), i > 0 || r > 0);
      wgmma_commit();
      wgmma_wait<1>();  // step i - 1's products are done with its stage
      if (i > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % G::kStages));
    }
    wgmma_wait<0>();

    // accumulator 4j + r: dy column 16 (warp & 3) + g (+ 8 for r >= 2), tap d
    // = j / 8, channel 8 (j % 8) + 2t (+ 1 for odd r), for lane 4g + t
    float* out = part + static_cast<size_t>(split) * 9 * c * f;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int cc = c0 + 8 * (j % 8) + 2 * t;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ff = f0 + 16 * (warp & 3) + g + 8 * (r >> 1);
        const int ch = cc + (r & 1);
        if (ch < c && ff < f)
          out[(static_cast<size_t>((j / 8) * 3 + e) * c + ch) * f + ff] =
              steps > 0 ? acc[4 * j + r] : 0.0f;
      }
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
                   long long k, int m_tiles, int tiles, int splits, cudaStream_t st) {
  const auto kernel = conv3x3_dw_kernel<S, TN>;
  static std::atomic<uint64_t> smem_set{0};
  constexpr int smem = ETile<TN>::kSmem;
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(tiles) * splits, kThreads, smem, st>>>(
      x, dy, part, h, w, c, f, k, m_tiles, tiles, splits);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_s(const float* x, const float* dy, float* part, int h, int w, int c, int f,
                     long long k, int m_tiles, int tiles, int splits, cudaStream_t st) {
  return tile_n(f) == 64 ? launch<S, 64>(x, dy, part, h, w, c, f, k, m_tiles, tiles, splits, st)
                         : launch<S, 128>(x, dy, part, h, w, c, f, k, m_tiles, tiles, splits, st);
}

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (so the library links no libcuda of its own); null if absent.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                  : nullptr;
  }();
  return fn;
}

// A map of the bf16 tensor at p with dims (innermost first) and byte strides
// of dims 1 .. 3, read in boxes of 64 x cols x rows x 1 into 128-byte
// swizzled rows; outside the tensor reads zeros.
bool encode_box(CUtensorMap* map, const void* p, const cuuint64_t (&dims)[4],
                const cuuint64_t (&strides)[3], cuuint32_t cols, cuuint32_t rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t box[4] = {kChunk, cols, rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int S>
cudaError_t launch_bf16(const void* x, const void* dy, float* part, int b, int h, int w, int c,
                        int f, int splits, cudaStream_t st) {
  using G = TmaTile<S>;
  using U = cuuint64_t;
  const U v = 2;  // bytes a value
  const U ho = h / S, wo = w / S;
  CUtensorMap xmap, xmap_b, dymap;
  const U xdims[4] = {U(S) * c, U(w) / S, U(h), U(b)};
  const U xstrides[3] = {U(S) * c * v, U(w) * c * v, U(h) * w * c * v};
  const U dydims[4] = {U(f), wo, ho, U(b)};
  const U dystrides[3] = {f * v, wo * f * v, ho * wo * f * v};
  if (!encode_box(&xmap, x, xdims, xstrides, G::kXCols, G::kXRows) ||
      !encode_box(&dymap, dy, dydims, dystrides, kCols, kRows))
    return cudaErrorInvalidValue;
  xmap_b = xmap;  // box B: stride 2 only
  if (S == 2 && !encode_box(&xmap_b, x, xdims, xstrides, kCols, G::kXRows))
    return cudaErrorInvalidValue;
  const auto kernel = conv3x3_dw_bf16_kernel<S>;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), G::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const int tiles = ((c + kChunk - 1) / kChunk) * ((f + kChunk - 1) / kChunk);
  kernel<<<static_cast<unsigned>(tiles) * splits, kTmaThreads, G::kSmem, st>>>(
      xmap, xmap_b, dymap, part, c, f, static_cast<int>(ho), static_cast<int>(wo), b, tiles,
      splits);
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
  const long long k = static_cast<long long>(b) * (h / stride) * (w / stride);
  const int m_tiles = (9 * c + kTM - 1) / kTM;
  const long long tiles = epnet_conv3x3_dw_tiles(c, f);
  if (tiles * splits > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* dyf = static_cast<const float*>(dy);
  float* pf = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(tiles);
  const cudaError_t err =
      stride == 2 ? launch_s<2>(xf, dyf, pf, h, w, c, f, k, m_tiles, t, splits, st)
                  : launch_s<1>(xf, dyf, pf, h, w, c, f, k, m_tiles, t, splits, st);
  if (err != cudaSuccess) return err;
  const long long size = 9LL * c * f;
  const int threads = 256;
  conv3x3_dw_reduce<<<static_cast<unsigned>((size + threads - 1) / threads), threads, 0, st>>>(
      pf, splits, size, static_cast<float*>(dw));
  return cudaGetLastError();
}

// D-bf16 / E-bf16: x (b, h, w, c) and dy (b, h / stride, w / stride, f)
// bf16, 16-byte aligned, c and f multiples of 8 (TMA's 16-byte strides);
// part (splits, 9c, f) scratch and dw (3, 3, c, f) float32: dw receives the
// f32 sums. The grid is (c / 64) (f / 64) tiles (rounded up) times splits;
// split s takes the s-th of splits equal runs of the b (h / stride / 4) (w /
// stride / 16) stages (rounded up). Launches on `stream`, allocates nothing,
// returns the first CUDA error.
int epnet_conv3x3_dw_bf16_launch(const void* x, const void* dy, void* part, void* dw, int b,
                                 int h, int w, int c, int f, int stride, int splits,
                                 void* stream) {
  if (b < 0 || h <= 0 || w <= 0 || c <= 0 || f <= 0 || c % 8 || f % 8 || splits < 1)
    return cudaErrorInvalidValue;
  if (stride != 1 && (stride != 2 || h % 2 || w % 2)) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(dy) % 16)
    return cudaErrorInvalidValue;
  const long long tiles = 1LL * ((c + kChunk - 1) / kChunk) * ((f + kChunk - 1) / kChunk);
  if (tiles * splits > 0x7fffffffLL) return cudaErrorInvalidValue;
  float* pf = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = stride == 2 ? launch_bf16<2>(x, dy, pf, b, h, w, c, f, splits, st)
                                      : launch_bf16<1>(x, dy, pf, b, h, w, c, f, splits, st);
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
