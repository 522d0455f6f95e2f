// Weight gradient of the image tower's 3x3 SAME convolutions on Hopper
// (sm_90a), f32 and bf16; plain C interface. One kernel at two strides, and
// its bf16 instance (D-bf16, E-bf16; see the end of this comment):
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
// dtype once, conv2d.py:191). Its 36.2 / 72.5 GFLOP a conv take 0.04 / 0.07
// ms on the 989 TFLOP/s bf16 tensor cores, against 0.1-0.3 GB of x and dy:
// bytes bound it. One bf16 pass (wgmma m64nNk16) replaces the three TF32
// passes, and bf16 wgmma reads both operands from shared memory in either
// major order: A (row m = tap and channel, pixel k) is M-major and B (pixel
// k, column n) N-major, each stored as the copy writes it, pixel rows of 64
// values in 128-byte swizzled atoms, so nothing is split or moved between
// the copy and the product. A group of V = 8 channels (16 bytes; V = 4, 8
// bytes, when C or F is not a multiple of 8) lies in one tap because V
// divides C. A step is 32 pixels (two k16 slices) in a 4-stage cp.async
// ring, two ahead, as F-bf16's (csrc/conv3x3_s2_fwd.cu). Split-K and the
// fixed-order reduction are the f32 kernel's, so dw is bitwise
// reproducible.

#include <cuda_bf16.h>
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

// ---- D-bf16 and E-bf16: bf16 wgmma, both operands MN-major in shared memory ----

constexpr int kBK = 32;      // pixels a step (two k16 slices)
constexpr int kBStages = 4;  // steps in the ring, copied two ahead
constexpr int kAtom = 1024;  // a 128-byte swizzled atom: 8 pixel rows of 64 values
// element (k, m) of a 64-value-wide operand (A: m a tile row, B: n a
// column) at (m / 64) * kChunkBytes + (k / 8) * kAtom + (k % 8) * 128 +
// ((m % 64 / 8) ^ (k % 8)) * 16 + (m % 8) * 2
constexpr int kChunkBytes = kBK / 8 * kAtom;

template <int TN>
struct BTile {
  static constexpr int kAStage = kTM / 64 * kChunkBytes;  // 8 KB
  static constexpr int kBStage = TN / 64 * kChunkBytes;   // 8 or 4 KB
  static constexpr int kSmem = kBStages * (kAStage + kBStage) + 1024;  // + alignment
};

__device__ __forceinline__ int swz(int k, int m) {
  return (m / 64) * kChunkBytes + (k / 8) * kAtom + (k % 8) * 128 + ((m % 64 / 8) ^ (k % 8)) * 16 +
         (m % 8) * 2;
}

// D-bf16 (S = 2) and E-bf16 (S = 1); V bf16 values a copy (8: 16 bytes, 4: 8).
template <int S, int TN, int V>
__global__ void __launch_bounds__(kThreads, kEBlocks)
conv3x3_dw_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                       float* __restrict__ part, int h_in, int w_in, int c, int f,
                       long long k_total, int m_tiles, int tiles, int splits) {
  using G = BTile<TN>;
  constexpr int kPad = S == 1 ? 1 : 0;
  constexpr int kAGroups = kTM / V;              // copies a pixel row of A: 16 or 32
  constexpr int kARows = kThreads / kAGroups;    // pixel rows a pass: 16 or 8
  constexpr int kAPasses = kBK / kARows;         // 2 or 4
  constexpr int kBGroups = TN / V;               // copies a pixel row of B
  constexpr int kBRows = kThreads / kBGroups;
  constexpr int kBPasses = kBK / kBRows;
  static_assert(kAPasses * kARows == kBK && kBPasses * kBRows == kBK, "copies");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* as = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* bs = as + kBStages * G::kAStage;

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

  // A copies: tile rows a_m .. a_m + V - 1 (one tap, V channels) at pixels
  // kb + step + a_kk + kARows q
  const int a_col = V * (tid % kAGroups);
  const int a_m = m0 + a_col;
  const bool a_ok = a_m < m_total;
  const int tap = a_ok ? a_m / c : 0;
  const int a_c = a_m - tap * c;
  const int a_dh = tap / 3 - kPad;
  const int a_dw = tap % 3 - kPad;
  const int a_kk = tid / kAGroups;
  int pb[kAPasses], ph[kAPasses], pw[kAPasses];
#pragma unroll
  for (int q = 0; q < kAPasses; ++q) {
    const long long k = kb + a_kk + kARows * q;
    pw[q] = static_cast<int>(k % wo);
    const long long t = k / wo;
    ph[q] = static_cast<int>(t % ho);
    pb[q] = static_cast<int>(t / ho);
  }
  // B copies: columns b_n .. b_n + V - 1 of dy at pixels kb + step + b_kk + kBRows q
  const int b_col = V * (tid % kBGroups);
  const bool b_ok = n0 + b_col < f;
  const int b_kk = tid / kBGroups;

  auto load = [&](long long k0, int stage) {
    unsigned char* ad = as + stage * G::kAStage;
#pragma unroll
    for (int q = 0; q < kAPasses; ++q) {
      const int kr = a_kk + kARows * q;
      const int hh = S * ph[q] + a_dh;
      const int ww = S * pw[q] + a_dw;
      const bool in = a_ok && k0 + kr < ke && hh >= 0 && hh < h_in && ww >= 0 && ww < w_in;
      cp_async<2 * V>(smem_addr(ad + swz(kr, a_col)),
                      in ? x + ((static_cast<size_t>(pb[q]) * h_in + hh) * w_in + ww) * c + a_c
                         : x,
                      in);
      advance(pb[q], ph[q], pw[q], kBK, ho, wo);
    }
    unsigned char* bd = bs + stage * G::kBStage;
#pragma unroll
    for (int q = 0; q < kBPasses; ++q) {
      const int kr = b_kk + kBRows * q;
      const long long k = k0 + kr;
      const bool in = b_ok && k < ke;
      cp_async<2 * V>(smem_addr(bd + swz(kr, b_col)),
                      in ? dy + static_cast<size_t>(k) * f + n0 + b_col : dy, in);
    }
  };

  const int wg = warp >> 2;  // warpgroup: tile rows 64 wg .. 64 wg + 63
  float acc[TN / 2];         // set by the first wgmma (scale-d 0)
  const long long steps = (ke - kb + kBK - 1) / kBK;
#pragma unroll
  for (int i = 0; i < kBStages - 2; ++i) {
    if (i < steps) load(kb + static_cast<long long>(i) * kBK, i);
    cp_async_commit();
  }
  for (long long i = 0; i < steps; ++i) {
    cp_async_wait<kBStages - 3>();
    fence_async_shared();  // copies -> wgmma
    __syncthreads();
    const long long next = i + kBStages - 2;  // into the stage of step i - 2, whose wgmmas are done
    if (next < steps) load(kb + next * kBK, static_cast<int>(next % kBStages));
    cp_async_commit();
    const unsigned char* a_st = as + (i % kBStages) * G::kAStage + wg * kChunkBytes;
    const unsigned char* b_st = bs + (i % kBStages) * G::kBStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_bf16_mn<TN>(acc, smem_desc<kSwizzle128>(a_st + 2 * kAtom * kk, kChunkBytes, kAtom),
                        smem_desc<kSwizzle128>(b_st + 2 * kAtom * kk, kChunkBytes, kAtom),
                        i > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  // accumulator 4j + r: row (+ 8 for r >= 2), columns 8j + 2t, 8j + 2t + 1
  float* out = part + static_cast<size_t>(split) * m_total * f;
  const int row = 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int t = lane & 3;
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

template <int S, int TN, int V>
cudaError_t launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* dy, float* part, int h,
                        int w, int c, int f, long long k, int m_tiles, int tiles, int splits,
                        cudaStream_t st) {
  const auto kernel = conv3x3_dw_bf16_kernel<S, TN, V>;
  static std::atomic<uint64_t> smem_set{0};
  constexpr int smem = BTile<TN>::kSmem;
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(tiles) * splits, kThreads, smem, st>>>(
      x, dy, part, h, w, c, f, k, m_tiles, tiles, splits);
  return cudaGetLastError();
}

template <int S, int V>
cudaError_t launch_bf16_s(const __nv_bfloat16* x, const __nv_bfloat16* dy, float* part, int h,
                          int w, int c, int f, long long k, int m_tiles, int tiles, int splits,
                          cudaStream_t st) {
  return tile_n(f) == 64
             ? launch_bf16<S, 64, V>(x, dy, part, h, w, c, f, k, m_tiles, tiles, splits, st)
             : launch_bf16<S, 128, V>(x, dy, part, h, w, c, f, k, m_tiles, tiles, splits, st);
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

// D-bf16 / E-bf16: as above with x and dy bf16 (8-byte aligned; 16-byte
// copies where x and dy are 16-byte aligned and c and f multiples of 8), part
// and dw float32: dw receives the f32 sums.
int epnet_conv3x3_dw_bf16_launch(const void* x, const void* dy, void* part, void* dw, int b,
                                 int h, int w, int c, int f, int stride, int splits,
                                 void* stream) {
  if (b < 0 || h <= 0 || w <= 0 || c <= 0 || f <= 0 || c % 4 || f % 4 || splits < 1)
    return cudaErrorInvalidValue;
  if (stride != 1 && (stride != 2 || h % 2 || w % 2)) return cudaErrorInvalidValue;
  const long long k = static_cast<long long>(b) * (h / stride) * (w / stride);
  const int m_tiles = (9 * c + kTM - 1) / kTM;
  const long long tiles = epnet_conv3x3_dw_tiles(c, f);
  if (tiles * splits > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* dyb = static_cast<const __nv_bfloat16*>(dy);
  float* pf = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(tiles);
  const bool wide = c % 8 == 0 && f % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  cudaError_t err;
  if (stride == 2)
    err = wide ? launch_bf16_s<2, 8>(xb, dyb, pf, h, w, c, f, k, m_tiles, t, splits, st)
               : launch_bf16_s<2, 4>(xb, dyb, pf, h, w, c, f, k, m_tiles, t, splits, st);
  else
    err = wide ? launch_bf16_s<1, 8>(xb, dyb, pf, h, w, c, f, k, m_tiles, t, splits, st)
               : launch_bf16_s<1, 4>(xb, dyb, pf, h, w, c, f, k, m_tiles, t, splits, st);
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
