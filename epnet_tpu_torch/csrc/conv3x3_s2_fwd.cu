// Forward of the image tower's 3x3 SAME stride-2 convolution on Hopper
// (sm_90a), in f32 and in bf16; plain C interface. Kernel F:
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
// What bounds it on the H100. It is an implicit GEMM, M = B * H/2 * W/2
// output pixels by N = F channels over K = 9C, walked in a fixed order: tap
// (d, e), then channel chunk. Each of the tower's four stride-2 convs is
// 2 * M * 9C * F = 9.06 GFLOP an image against 0.04-0.16 GB of x and y.
//
// F (f32): 9.06 GFLOP an image by the direct count, 0.135 ms at the 67
// TFLOP/s f32 pipes (cuDNN's Winograd count, 0.076 ms, is lower). So F runs
// on the TF32 tensor cores in three passes, as kernel E does
// (csrc/conv3x3_dw.cu): each operand split as hi = tf32(a), lo = tf32(a -
// hi), both rounded to nearest (split_tf32, csrc/wgmma_common.cuh), and
// lo*hi + hi*lo + hi*hi accumulated in f32, about as accurate as an f32
// product (the recipe is f32 with TF32 off; one TF32 pass is another
// function). Its own bound is three direct counts at 495 TFLOP/s, 0.055 ms
// an image. The TPU kernel built the stacked (tm * W/2, 9C) operand in
// VMEM; here nothing is stacked. A block owns a tile of 128 output pixels
// by TN output channels (TN = 128, or 64 when F <= 64), two warpgroups of
// 64 pixels, and walks K in steps of one tap's 16 channels through a 4-slot
// cp.async ring filled three steps ahead; the products are wgmma m64nNk8.
// TF32 wgmma reads both operands K-major. A, a pixel's 16 channels of tap
// (d, e) at (b, 2h + d, 2w + e), is K-major as NHWC holds it: the ring
// copies it raw (a pixel's row padded to 20 floats, so that fragment reads
// fall in 32 distinct banks) and each thread splits its own fragment into
// registers; kernel E found that shared-memory traffic, not the tensor
// cores, bounds this kind of kernel, so A gets no planes there. B, K[tap,
// c, f], is N-major: a prologue kernel splits and transposes K once a call
// into hi and lo planes (F, 9C) in global memory (2 x 9.4 MB at blk3), and
// the ring copies the planes into the K-major 64-byte swizzled layout that
// wgmma reads. The SAME pad (0, 1), the channel tail past C and the column
// tail past F are the copy's zero-fill. Each block splits the next step's
// A into a second set of registers while its wgmmas run (4-8% faster at TN
// = 128 than splitting after them, though that instance then spills ~32
// bytes at its 128 registers), and two blocks an SM interleave.
//
// F-bf16 (x, K and y bf16; the Pallas kernel takes x.dtype in and out and
// runs one bf16 MXU dot with f32 accumulation, conv_fwd_attic.py:73-76,
// :167): its 9 GFLOP an image take 0.009 ms on the 989 TFLOP/s bf16 tensor
// cores, so bytes bound it at batch 1 (blk0's 79 MB: 0.024 ms) and the
// tensor cores at batch 4's deeper blocks. So it is the TPU kernel's own
// arithmetic on the tensor cores: wgmma m64nNk16, bf16 operands from shared
// memory, f32 accumulators in registers, in F's tap-then-channel order (64
// channels a step). Two warpgroups own 64 pixels each of a 128 x TN tile. The
// operands come straight from the NHWC layout into the layouts wgmma reads,
// 128-byte swizzled atoms of 8 rows: A, a pixel's 64 channels of one tap, is
// K-major; B, rows of K[tap, c, :], is N-major (the transposed-B form that
// 16-bit types allow). A 4-stage ring is filled by cp.async (16 bytes a copy;
// 8 where C or F is 4 mod 8, or a pointer only 8-byte aligned), two steps
// ahead, and each step's wgmmas run while the next step's are issued. The
// SAME pad, the channel tail past C and the column tail past F are the copy's
// zero-fill (src-size 0). On the H100 the same tiles on mma.sync stayed
// well behind F.conv2d, and wgmma on unswizzled core matrices behind
// mma.sync: the swizzle is what lets wgmma run. Products of two bf16
// values are exact in f32; only the summation order differs from the plain
// version's, and y is rounded to bf16 once, at the end.
//
// Both: when the pixel tiles alone cannot fill the card (the deep convs at
// batch 1: blk3 has 60 tiles), the wrapper splits K. Each split writes its
// own f32 slice of a (splits, M, F) buffer and a second kernel sums the
// slices in split order (and rounds to bf16 for F-bf16). No atomics: y is
// bitwise reproducible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 128;  // output pixels per block
constexpr int kKc = 16;   // F: channels of one tap a step (two k8 slices)

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// ---- F: 3xTF32 wgmma fed by a cp.async ring ----

constexpr int kFRing = 4;    // F: steps in the cp.async ring (3 at least: see the loop)
constexpr int kFBlocks = 2;  // F: resident blocks an SM (shared memory)
// B (channel k, output n) sits in a ring slot as hi and lo TF32 planes,
// K-major, in 64-byte swizzled atoms: 8 rows of 64 bytes (a row is the
// step's 16 channels of one output), the 16-byte chunk j of row r stored at
// chunk j ^ r / 2. A (pixel m, channel k) sits raw behind them.
constexpr int kFGroup = 512;

template <int TN>
struct FTile {
  static constexpr int kAStride = kKc + 4;               // floats a pixel row of raw A
  static constexpr int kB = TN / 8 * kFGroup;            // bytes of one B plane
  static constexpr int kStage = 2 * kB + kTM * kAStride * 4;  // B hi, B lo, raw A
  static constexpr int kSmem = kFRing * kStage + 1024;   // + alignment
  static_assert(kStage % kFGroup == 0, "every slot's planes start on an atom");
};

// hi and lo TF32 planes of K seen as (kdim = 9C, f), transposed: wt[0][n][k]
// = hi, wt[1][n][k] = lo of K[k][n]. Blocks of 32 x 8 threads, 32 x 32 tiles.
__global__ void conv3x3_s2_fwd_split_w(const float* __restrict__ k, float* __restrict__ wt,
                                       int kdim, int f) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32;
  const int n0 = blockIdx.y * 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + threadIdx.y + 8 * i;
    const int n = n0 + threadIdx.x;
    if (kk < kdim && n < f)
      tile[threadIdx.y + 8 * i][threadIdx.x] = k[static_cast<size_t>(kk) * f + n];
  }
  __syncthreads();
  const size_t plane = static_cast<size_t>(f) * kdim;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + threadIdx.y + 8 * i;
    const int kk = k0 + threadIdx.x;
    if (n < f && kk < kdim) {
      float hi, lo;
      split_tf32(tile[threadIdx.x][threadIdx.y + 8 * i], hi, lo);
      wt[static_cast<size_t>(n) * kdim + kk] = hi;
      wt[plane + static_cast<size_t>(n) * kdim + kk] = lo;
    }
  }
}

// F: out is y (one split) or the split's slice of part, both f32; wt the
// planes of conv3x3_s2_fwd_split_w.
template <int TN>
__global__ void __launch_bounds__(kThreads, kFBlocks)
conv3x3_s2_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                      float* __restrict__ out, int h_in, int w_in, int c, int f, int m_total,
                      int m_tiles, int tiles, int splits, int c_chunks) {
  using G = FTile<TN>;
  constexpr int kBPasses = TN * (kKc / 4) / kThreads;  // 16-byte copies a plane a thread: 2 or 1
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x % tiles;
  const int split = blockIdx.x / tiles;
  const int m0 = (tile % m_tiles) * kTM;
  const int n0 = (tile / m_tiles) * TN;
  const int steps_total = 9 * c_chunks;
  const int sb = static_cast<int>(static_cast<long long>(steps_total) * split / splits);
  const int se = static_cast<int>(static_cast<long long>(steps_total) * (split + 1) / splits);
  const int ho = h_in / 2;
  const int wo = w_in / 2;
  const size_t kdim = 9 * static_cast<size_t>(c);
  const size_t plane = static_cast<size_t>(f) * kdim;

  // A copies: channels 4j .. 4j + 3 (j = tid & 3) of the step's 16, at pixel
  // rows (tid >> 2) and (tid >> 2) + 64; bit 0 of a_flags[q]: the pixel
  // exists, bit 1: tap d = 2 is inside the image, bit 2: tap e = 2 is
  const int cj = tid & 3;
  const float* a_base[2];
  int a_flags[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int m = m0 + (tid >> 2) + 64 * q;
    int pb = 0, ph = 0, pw = 0;
    if (m < m_total) {
      pw = m % wo;
      const int t = m / wo;
      ph = t % ho;
      pb = t / ho;
    }
    a_base[q] = x + ((static_cast<size_t>(pb) * h_in + 2 * ph) * w_in + 2 * pw) * c + 4 * cj;
    a_flags[q] = (m < m_total) | (2 * ph + 2 < h_in) << 1 | (2 * pw + 2 < w_in) << 2;
  }
  const int a_dst = 2 * G::kB + ((tid >> 2) * G::kAStride + 4 * cj) * 4;  // bytes in a slot
  // B copies: chunk j of plane rows n = (tid >> 2) + 64 q, at
  // (n / 8) * 512 + (n % 8) * 64 + (j ^ (n % 8) / 2) * 16
  const int b_n = tid >> 2;
  const int b_dst = (b_n / 8) * kFGroup + (b_n % 8) * 64 + ((cj ^ ((b_n % 8) >> 1)) * 16);
  const float* b_base = wt + static_cast<size_t>(n0 + b_n) * kdim + 4 * cj;

  auto load = [&](int s, int slot) {
    const int tap = s / c_chunks;
    const int c0 = (s - tap * c_chunks) * kKc;
    const int d = tap / 3;
    const int e = tap - 3 * d;
    const int need = 1 | (d == 2) << 1 | (e == 2) << 2;
    const bool ch_in = c0 + 4 * cj < c;
    const size_t a_off = (static_cast<size_t>(d) * w_in + e) * c + c0;
    unsigned char* st = smem + slot * G::kStage;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const bool in = ch_in && (a_flags[q] & need) == need;
      cp_async<16>(smem_addr(st + a_dst + 64 * G::kAStride * 4 * q),
                   in ? a_base[q] + a_off : x, in);
    }
    const size_t b_off = static_cast<size_t>(tap) * c + c0;
#pragma unroll
    for (int q = 0; q < kBPasses; ++q) {
      const bool in = ch_in && n0 + b_n + 64 * q < f;
      const float* src = in ? b_base + static_cast<size_t>(64 * q) * kdim + b_off : wt;
      const int dst = b_dst + 8 * kFGroup * q;  // row n + 64: 8 atoms on
      cp_async<16>(smem_addr(st + dst), src, in);
      cp_async<16>(smem_addr(st + G::kB + dst), in ? src + plane : wt, in);
    }
  };

  // A's fragments from the raw slot, split in registers: this warp's pixels
  // row and row + 8 at channels 8 kk + t and + 4 (bank = 20 m + k mod 32: 32
  // distinct)
  const int wg = warp >> 2;  // warpgroup: pixels 64 wg .. 64 wg + 63 of the tile
  const int row = 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int t = lane & 3;
  auto fragments = [&](const unsigned char* st, uint32_t (&ah)[kKc / 8][4],
                       uint32_t (&al)[kKc / 8][4]) {
    const float* ra = reinterpret_cast<const float*>(st + 2 * G::kB);
#pragma unroll
    for (int kk = 0; kk < kKc / 8; ++kk) {
      const float* p = ra + row * G::kAStride + 8 * kk + t;
      split_tf32(p[0], ah[kk][0], al[kk][0]);
      split_tf32(p[8 * G::kAStride], ah[kk][1], al[kk][1]);
      split_tf32(p[4], ah[kk][2], al[kk][2]);
      split_tf32(p[8 * G::kAStride + 4], ah[kk][3], al[kk][3]);
    }
  };

  float acc[TN / 2];  // set by the first wgmma (scale-d 0)
  using Frag = uint32_t[kKc / 8][4];
  Frag ah0, al0, ah1, al1;  // A fragments of two steps: one in the wgmmas, one being split

  // Step sb + i sits in slot i % kFRing, copied kFRing - 1 steps ahead into
  // the slot of step i - 1. Step i's wgmmas run while the threads split step
  // i + 1's A fragments into the other set of registers; the slot of step i
  // - 1 is refilled once every warpgroup has waited for its wgmmas (the
  // barrier in step i).
  const int steps = se - sb;
#pragma unroll
  for (int i = 0; i < kFRing - 1; ++i) {
    if (i < steps) load(sb + i, i);
    cp_async_commit();
  }
  cp_async_wait<kFRing - 2>();
  fence_async_shared();
  __syncthreads();
  fragments(smem, ah0, al0);
  auto step = [&](int i, const Frag& ah, const Frag& al, Frag& nh, Frag& nl) {
    const unsigned char* st = smem + (i % kFRing) * G::kStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKc / 8; ++kk) {
      const uint64_t bh = smem_desc<kSwizzle64>(st + 32 * kk, 16, kFGroup);
      const uint64_t bl = smem_desc<kSwizzle64>(st + G::kB + 32 * kk, 16, kFGroup);
      wgmma_tf32<TN>(acc, al[kk], bh, i > 0 || kk > 0);
      wgmma_tf32<TN>(acc, ah[kk], bl, 1);
      wgmma_tf32<TN>(acc, ah[kk], bh, 1);
    }
    wgmma_commit();
    cp_async_wait<kFRing - 3>();  // step i + 1 has landed (this thread's copies)
    fence_async_shared();
    __syncthreads();  // every thread's; every warpgroup is done with step i - 1
    const int next = i + kFRing - 1;
    if (next < steps) load(sb + next, next % kFRing);
    cp_async_commit();
    if (i + 1 < steps) fragments(smem + ((i + 1) % kFRing) * G::kStage, nh, nl);
    wgmma_wait<0>();
  };
  int i = 0;
  for (; i + 1 < steps; i += 2) {
    step(i, ah0, al0, ah1, al1);
    step(i + 1, ah1, al1, ah0, al0);
  }
  if (i < steps) step(i, ah0, al0, ah1, al1);
  cp_async_wait<0>();

  // accumulator 4j + r: pixel row (+ 8 for r >= 2), channels 8j + 2t and the next
  float* dst = out + static_cast<size_t>(split) * m_total * f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + row + 8 * h;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if (n < f)
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(m) * f + n) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// ---- F-bf16: wgmma on the bf16 tensor cores, fed by a cp.async ring ----

constexpr int kBThreads = 256;  // F-bf16: threads a block, two warpgroups of 64 pixels
constexpr int kBBlocks = 1;     // F-bf16: resident blocks an SM (shared memory)
constexpr int kBK = 64;         // F-bf16: channels of one tap a step (four k16 slices)
constexpr int kStages = 4;      // F-bf16: steps in the shared-memory ring
// Both operands sit in shared memory as wgmma reads them, in 128-byte
// swizzled atoms: 8 rows of 128 bytes, the 16-byte chunk j of row r stored at
// chunk j ^ r. A (pixel m, channel k) is K-major, a row the step's 64
// channels of one pixel; B (channel k, output n) is N-major, a row 64 outputs
// of one channel.
constexpr int kAtom = 1024;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int TN>
struct Bf16Tile {
  static constexpr int kAStage = kTM / 8 * kAtom;            // bytes: 16 KB
  static constexpr int kBStage = TN / 64 * (kBK / 8) * kAtom;  // bytes: 16 or 8 KB
  static constexpr int kSmem = kStages * (kAStage + kBStage) + 1024;  // + alignment
};

// F-bf16. V: bf16 values a copy (8: 16 bytes; 4: 8 bytes). O: bf16 for y
// (one split), f32 for a split's slice of part.
template <int TN, int V, typename O>
__global__ void __launch_bounds__(kBThreads, kBBlocks)
conv3x3_s2_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ k, O* __restrict__ out, int h_in,
                           int w_in, int c, int f, int m_total, int m_tiles, int tiles,
                           int splits, int c_chunks) {
  using G = Bf16Tile<TN>;
  constexpr int kAChunks = kBK / V;              // copies a pixel row: 8 or 16
  constexpr int kARows = kBThreads / kAChunks;   // pixel rows a pass: 32 or 16
  constexpr int kAPasses = kTM / kARows;         // 4 or 8
  constexpr int kBChunks = TN / V;               // copies a K row
  constexpr int kBRows = kBThreads / kBChunks;   // K rows a pass
  constexpr int kBPasses = kBK / kBRows;
  static_assert(kARows % 8 == 0 && kBRows * kBPasses == kBK, "tile copies");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* as = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* bs = as + kStages * G::kAStage;  // as: [kStages][kAStage], bs: [kStages][kBStage]

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

  // A copies: channels a_ch .. a_ch + V - 1 of pixel rows a_row + kARows * q;
  // bit 0 of a_flags[q]: the pixel exists, bit 1: tap d = 2 is inside the
  // image, bit 2: tap e = 2 is
  const int a_ch = (tid % kAChunks) * V;
  const int a_row = tid / kAChunks;
  const __nv_bfloat16* a_base[kAPasses];
  int a_flags[kAPasses];
#pragma unroll
  for (int q = 0; q < kAPasses; ++q) {
    const int m = m0 + a_row + kARows * q;
    int pb = 0, ph = 0, pw = 0;
    if (m < m_total) {
      pw = m % wo;
      const int t = m / wo;
      ph = t % ho;
      pb = t / ho;
    }
    a_base[q] = x + ((static_cast<size_t>(pb) * h_in + 2 * ph) * w_in + 2 * pw) * c + a_ch;
    a_flags[q] = (m < m_total) | (2 * ph + 2 < h_in) << 1 | (2 * pw + 2 < w_in) << 2;
  }
  // element (m, k) of A: (m / 8) * 1024 + (m % 8) * 128 + ((k / 8) ^ (m % 8)) * 16 + (k % 8) * 2
  const int a_dst = (a_row / 8) * kAtom + (a_row % 8) * 128 + ((a_ch / 8) ^ (a_row % 8)) * 16 +
                    (a_ch % 8) * 2;
  // B copies: columns b_col .. b_col + V - 1 of K rows b_row + kBRows * q;
  // element (k, n) of B: (n / 64) * 8 * 1024 + (k / 8) * 1024 + (k % 8) * 128
  // + ((n % 64 / 8) ^ (k % 8)) * 16 + (n % 8) * 2
  const int b_col = (tid % kBChunks) * V;
  const int b_row = tid / kBChunks;
  const bool b_ok = n0 + b_col < f;
  const __nv_bfloat16* b_base = k + n0 + b_col;
  const int b_dst = (b_col / 64) * (kBK / 8 * kAtom) + (b_col % 8) * 2;
  const int b_chunk = b_col % 64 / 8;

  auto load = [&](int s, int stage) {
    const int tap = s / c_chunks;
    const int c0 = (s - tap * c_chunks) * kBK;
    const int d = tap / 3;
    const int e = tap - 3 * d;
    const int need = 1 | (d == 2) << 1 | (e == 2) << 2;
    const bool ch_in = c0 + a_ch < c;
    const size_t a_off = (static_cast<size_t>(d) * w_in + e) * c + c0;
    unsigned char* ad = as + stage * G::kAStage + a_dst;
#pragma unroll
    for (int q = 0; q < kAPasses; ++q) {
      const bool in = ch_in && (a_flags[q] & need) == need;
      cp_async<2 * V>(smem_addr(ad + kARows / 8 * q * kAtom), in ? a_base[q] + a_off : x, in);
    }
    unsigned char* bd = bs + stage * G::kBStage + b_dst;
#pragma unroll
    for (int q = 0; q < kBPasses; ++q) {
      const int r = b_row + kBRows * q;
      const bool in = b_ok && c0 + r < c;
      cp_async<2 * V>(smem_addr(bd + (r / 8) * kAtom + (r % 8) * 128 + (b_chunk ^ (r % 8)) * 16),
                      in ? b_base + (static_cast<size_t>(tap) * c + c0 + r) * f : k, in);
    }
  };

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;  // warpgroup: pixels 64 wg .. 64 wg + 63 of the tile
  float acc[TN / 2];         // set by the first wgmma (scale-d 0)

  // The ring: step sb + i sits in stage i % kStages, copied kStages - 2 steps
  // ahead. Each step's wgmmas run while the next step's are issued; the stage
  // of step i - 2 is refilled once every warpgroup has waited for that step's
  // wgmmas (wait_group 1 after step i - 1's commit) and passed the barrier.
  const int steps = se - sb;
#pragma unroll
  for (int i = 0; i < kStages - 2; ++i) {
    if (i < steps) load(sb + i, i);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kStages - 3>();
    fence_async_shared();  // copies -> wgmma
    __syncthreads();
    if (i + kStages - 2 < steps) load(sb + i + kStages - 2, (i + kStages - 2) % kStages);
    cp_async_commit();
    const unsigned char* a_st = as + (i % kStages) * G::kAStage + wg * 8 * kAtom;
    const unsigned char* b_st = bs + (i % kStages) * G::kBStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_bf16<TN>(acc, smem_desc<kSwizzle128>(a_st + 32 * kk, 16, kAtom),
                     smem_desc<kSwizzle128>(b_st + 2 * kAtom * kk, kBK / 8 * kAtom, kAtom),
                     i > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  // accumulator 4j + r: pixel (lane >> 2) (+ 8 for r >= 2) of the warp's 16,
  // channels 8j + 2 (lane & 3) and the next
  O* dst = out + static_cast<size_t>(split) * m_total * f;
  const int row = m0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row + 8 * h;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int n = n0 + 8 * j + t2;
      if (n < f)
        store2(dst + static_cast<size_t>(m) * f + n, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// y[e] = sum over splits s, in order, of part[s][e] (f32), stored as T.
template <typename T>
__global__ void conv3x3_s2_fwd_reduce(const float* __restrict__ part, int splits,
                                      long long size, T* __restrict__ y) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += part[static_cast<size_t>(s) * size + e];
  store1(y + e, acc);
}

inline int tile_n(int f) { return f <= 64 ? 64 : 128; }

// The geometry both instances share: K steps of `chunk` channels.
struct Grid {
  int m, m_tiles, tiles, c_chunks;
};

cudaError_t grid_of(int b, int h, int w, int c, int f, int splits, const void* part, int chunk,
                    Grid* g) {
  if (b < 1 || h < 2 || w < 2 || h % 2 || w % 2 || c <= 0 || f <= 0 || c % 4 || f % 4)
    return cudaErrorInvalidValue;
  const int c_chunks = (c + chunk - 1) / chunk;
  if (splits < 1 || splits > 9 * c_chunks || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const long long m = static_cast<long long>(b) * (h / 2) * (w / 2);
  const long long tiles = ((m + kTM - 1) / kTM) * ((f + tile_n(f) - 1) / tile_n(f));
  if (m > 0x7fffffffLL || tiles * splits > 0x7fffffffLL) return cudaErrorInvalidValue;
  *g = {static_cast<int>(m), static_cast<int>((m + kTM - 1) / kTM), static_cast<int>(tiles),
        c_chunks};
  return cudaSuccess;
}

template <typename T>
cudaError_t reduce(const void* part, int splits, long long size, void* y, cudaStream_t st) {
  const int threads = 256;
  conv3x3_s2_fwd_reduce<T><<<static_cast<unsigned>((size + threads - 1) / threads), threads, 0,
                             st>>>(static_cast<const float*>(part), splits, size,
                                   static_cast<T*>(y));
  return cudaGetLastError();
}

template <int TN>
cudaError_t launch_f32(const float* x, const float* wt, float* out, int h, int w, int c, int f,
                       const Grid& g, int splits, cudaStream_t st) {
  const auto kernel = conv3x3_s2_fwd_kernel<TN>;
  static std::atomic<uint64_t> smem_set{0};
  constexpr int smem = FTile<TN>::kSmem;
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(g.tiles) * splits, kThreads, smem, st>>>(
      x, wt, out, h, w, c, f, g.m, g.m_tiles, g.tiles, splits, g.c_chunks);
  return cudaGetLastError();
}

template <int TN, int V, typename O>
cudaError_t launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* k, O* out, int h, int w,
                        int c, int f, const Grid& g, int splits, cudaStream_t st) {
  const auto kernel = conv3x3_s2_fwd_bf16_kernel<TN, V, O>;
  static std::atomic<uint64_t> smem_set{0};
  constexpr int smem = Bf16Tile<TN>::kSmem;
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(g.tiles) * splits, kBThreads, smem, st>>>(
      x, k, out, h, w, c, f, g.m, g.m_tiles, g.tiles, splits, g.c_chunks);
  return cudaGetLastError();
}

template <int V, typename O>
cudaError_t launch_bf16_v(const __nv_bfloat16* x, const __nv_bfloat16* k, O* out, int h, int w,
                          int c, int f, const Grid& g, int splits, cudaStream_t st) {
  return tile_n(f) == 64 ? launch_bf16<64, V, O>(x, k, out, h, w, c, f, g, splits, st)
                         : launch_bf16<128, V, O>(x, k, out, h, w, c, f, g, splits, st);
}

template <typename O>
cudaError_t launch_bf16_o(const __nv_bfloat16* x, const __nv_bfloat16* k, O* out, int h, int w,
                          int c, int f, const Grid& g, int splits, cudaStream_t st) {
  // 16-byte copies need every copied row and both bases 16-byte aligned
  const bool wide = c % 8 == 0 && f % 8 == 0 &&
                    (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(k)) % 16 == 0;
  return wide ? launch_bf16_v<8, O>(x, k, out, h, w, c, f, g, splits, st)
              : launch_bf16_v<4, O>(x, k, out, h, w, c, f, g, splits, st);
}

}  // namespace

extern "C" {

// Output tiles of the (b * h/2 * w/2, f) result, both instances; the launch
// has tiles * splits blocks, of which an SM holds 2 (F) or
// epnet_conv3x3_s2_fwd_bf16_blocks (F-bf16).
long long epnet_conv3x3_s2_fwd_tiles(int b, int h, int w, int f) {
  const long long m = static_cast<long long>(b) * (h / 2) * (w / 2);
  return ((m + kTM - 1) / kTM) * ((f + tile_n(f) - 1) / tile_n(f));
}
int epnet_conv3x3_s2_fwd_bf16_blocks() { return kBBlocks; }

// Steps of K that the splits share: F's (tap, 16 channels), F-bf16's (tap,
// 64 channels).
int epnet_conv3x3_s2_fwd_steps(int c) { return 9 * ((c + kKc - 1) / kKc); }
int epnet_conv3x3_s2_fwd_bf16_steps(int c) { return 9 * ((c + kBK - 1) / kBK); }

// x (b, h, w, c), k (3, 3, c, f), y (b, h / 2, w / 2, f); wt (2, f, 9c)
// scratch for K's split planes; with splits > 1, part (splits, b * h/2 *
// w/2, f) scratch (unused, may be null, when splits is 1). All float32,
// contiguous, 16-byte aligned. Needs b >= 1, even h and w, c and f
// multiples of 4, 1 <= splits <= the steps of K. Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
int epnet_conv3x3_s2_fwd_launch(const void* x, const void* k, void* wt, void* part, void* y,
                                int b, int h, int w, int c, int f, int splits, void* stream) {
  Grid g;
  cudaError_t err = grid_of(b, h, w, c, f, splits, part, kKc, &g);
  if (err != cudaSuccess) return err;
  if (wt == nullptr) return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  float* wtf = static_cast<float*>(wt);
  float* out = static_cast<float*>(splits == 1 ? y : part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kdim = 9 * c;
  conv3x3_s2_fwd_split_w<<<dim3((kdim + 31) / 32, (f + 31) / 32), dim3(32, 8), 0, st>>>(
      static_cast<const float*>(k), wtf, kdim, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = tile_n(f) == 64 ? launch_f32<64>(xf, wtf, out, h, w, c, f, g, splits, st)
                        : launch_f32<128>(xf, wtf, out, h, w, c, f, g, splits, st);
  if (err != cudaSuccess || splits == 1) return err;
  return reduce<float>(part, splits, static_cast<long long>(g.m) * f, y, st);
}

// F-bf16: as above with x, k and y bf16 (8-byte aligned; copies are 16
// bytes when c and f are multiples of 8 and x and k 16-byte aligned, else
// 8) and no wt (K is copied as it lies); part stays f32, its steps are
// epnet_conv3x3_s2_fwd_bf16_steps.
int epnet_conv3x3_s2_fwd_bf16_launch(const void* x, const void* k, void* part, void* y, int b,
                                     int h, int w, int c, int f, int splits, void* stream) {
  Grid g;
  cudaError_t err = grid_of(b, h, w, c, f, splits, part, kBK, &g);
  if (err != cudaSuccess) return err;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits == 1)
    return launch_bf16_o(xb, kb, static_cast<__nv_bfloat16*>(y), h, w, c, f, g, 1, st);
  err = launch_bf16_o(xb, kb, static_cast<float*>(part), h, w, c, f, g, splits, st);
  if (err != cudaSuccess) return err;
  return reduce<__nv_bfloat16>(part, splits, static_cast<long long>(g.m) * f, y, st);
}

const char* epnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
