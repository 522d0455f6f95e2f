// Weight gradient of the image tower's 3x3 SAME convolutions on Hopper
// (sm_90a), f32; plain C interface. Two kernels:
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
// d - P, S*w + e - P), channel c, so a row's 4-channel group is 16 bytes of
// x. Tiles of one split are neighbours in the grid, so the blocks in flight
// read the same pixels and x and dy come from L2 more than once but from
// device memory about once. Each block writes its tile to its own slice of a
// (splits, 9C, F) buffer; a second kernel sums the slices in split order, so
// dw is bitwise reproducible (no atomics).
//
// D: arithmetic at the f32 FFMA pipes, 0.54 ms a conv by the direct count
// at 67 TFLOP/s. 16 x 16 threads hold 8 x 8 or 8 x 4 values each; per step
// of 16 pixels the A tile (float4 x rows) and the B tile (dy rows, float4)
// are staged in shared memory, double buffered, with the next step's global
// loads in flight while it computes.
//
// E: the same tile on the TF32 tensor cores, in three passes so that the
// sum keeps f32's accuracy (the recipe is f32 with TF32 off; one TF32 pass,
// 10 mantissa bits, is another function). Each operand is split as hi =
// cvt.rna.tf32(a), lo = cvt.rna.tf32(a - hi), and the tile accumulates lo*hi
// + hi*lo + hi*hi in f32 (the dropped lo*lo is ~2^-22 of a product). So its
// bound is 3 x 72.5 GFLOP at the 495 TFLOP/s TF32 rate, 0.44 ms a conv; the
// cuDNN Winograd count at the f32 pipes (0.27 ms) is lower still, and
// Winograd on tensor cores is later work. The products are wgmma m64nNk8,
// two warpgroups of 64 rows each. wgmma takes TF32 only K-major, and both
// operands are M- or N-major in memory (a pixel's channels, a pixel's dy
// row). So each step of 16 pixels is copied raw by cp.async into a 4-slot
// ring (three steps ahead), and then: A, the x rows, goes to registers in
// the mma fragment layout, split there, each thread reading only its own
// rows (so each element is split once); B, dy, is split by the threads into
// hi and lo planes in the K-major 64-byte swizzled layout that wgmma reads
// from shared memory. Rows of the raw slots are padded so that both reads,
// and the plane writes, fall in 32 distinct banks. Once a step's wgmmas are
// done, its block splits the next step while the other block on the SM keeps
// the tensor cores busy. Shared-memory traffic, not the tensor cores, bounds this
// design on the H100: keeping A out of shared memory is what brought it level
// with conv2d_weight. The 1-pixel SAME pad, the image edges and the ends of
// the split are the copy's zero-fill.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 128;  // output rows (tap, channel) per block
constexpr int kKc = 16;   // D: pixels staged per step

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

// D (stride 2)
template <int TN>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ part, int h_in, int w_in, int c, int f, int ho, int wo,
                  long long k_total, int m_tiles, int tiles, int splits) {
  constexpr int kJ = TN / 64;        // float4 column groups of a thread: 2 or 1
  constexpr int kBCols = TN / 4;     // float4 groups in a B row
  constexpr int kBRows = kThreads / kBCols;  // B rows loaded in one pass: 8 or 16
  constexpr int kBLoads = kKc / kBRows;      // 2 or 1
  __shared__ __align__(16) float as[2][kKc][kTM];
  __shared__ __align__(16) float bs[2][kKc][TN];

  const int tid = threadIdx.x;
  const int tile = blockIdx.x % tiles;
  const int split = blockIdx.x / tiles;
  const int m0 = (tile % m_tiles) * kTM;
  const int n0 = (tile / m_tiles) * TN;
  const int m_total = 9 * c;
  const long long kb = k_total * split / splits;
  const long long ke = k_total * (split + 1) / splits;

  // A loads: rows a_m .. a_m + 3 (one tap, 4 channels) at pixels
  // kb + a_kk and kb + a_kk + 8, then 16 further each step
  const int a_m = m0 + 4 * (tid & 31);
  const bool a_ok = a_m < m_total;
  const int tap = a_ok ? a_m / c : 0;
  const int a_c = a_m - tap * c;
  const int a_dh = tap / 3;
  const int a_dw = tap % 3;
  const int a_kk = tid >> 5;
  int pb[2], ph[2], pw[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const long long k = kb + a_kk + 8 * q;
    pw[q] = static_cast<int>(k % wo);
    const long long t = k / wo;
    ph[q] = static_cast<int>(t % ho);
    pb[q] = static_cast<int>(t / ho);
  }
  // B loads: columns b_n .. b_n + 3 of dy rows kb + b_kk + kBRows * q
  const int b_n = n0 + 4 * (tid % kBCols);
  const bool b_ok = b_n < f;
  const int b_kk = tid / kBCols;

  float4 ra[2];
  float4 rb[kBLoads];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto load = [&](long long k0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float4 v = zero;
      if (a_ok && k0 + a_kk + 8 * q < ke) {
        const int hh = 2 * ph[q] + a_dh;
        const int ww = 2 * pw[q] + a_dw;
        if (hh >= 0 && hh < h_in && ww >= 0 && ww < w_in)
          v = __ldg(reinterpret_cast<const float4*>(
              x + ((static_cast<size_t>(pb[q]) * h_in + hh) * w_in + ww) * c + a_c));
      }
      ra[q] = v;
      advance(pb[q], ph[q], pw[q], kKc, ho, wo);
    }
#pragma unroll
    for (int q = 0; q < kBLoads; ++q) {
      const long long k = k0 + b_kk + kBRows * q;
      rb[q] = (b_ok && k < ke)
                  ? __ldg(reinterpret_cast<const float4*>(dy + static_cast<size_t>(k) * f + b_n))
                  : zero;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
      *reinterpret_cast<float4*>(&as[buf][a_kk + 8 * q][4 * (tid & 31)]) = ra[q];
#pragma unroll
    for (int q = 0; q < kBLoads; ++q)
      *reinterpret_cast<float4*>(&bs[buf][b_kk + kBRows * q][4 * (tid % kBCols)]) = rb[q];
  };

  // thread (ty, tx) owns rows 4ty + i and 64 + 4ty + i, columns
  // 4tx + j (and 64 + 4tx + j when TN = 128)
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[8][4 * kJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kJ; ++j) acc[i][j] = 0.0f;

  const long long steps = (ke - kb + kKc - 1) / kKc;
  if (steps > 0) {
    load(kb);
    store(0);
    __syncthreads();
  }
  for (long long s = 0; s < steps; ++s) {
    const int buf = static_cast<int>(s & 1);
    if (s + 1 < steps) load(kb + (s + 1) * kKc);  // in flight while this step computes
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
    if (s + 1 < steps) store(buf ^ 1);  // the other buffer was last read one step ago
    __syncthreads();
  }

  float* out = part + static_cast<size_t>(split) * m_total * f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= m_total) continue;
#pragma unroll
    for (int jg = 0; jg < kJ; ++jg) {
      const int n = n0 + 64 * jg + 4 * tx;
      if (n < f)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(m) * f + n) =
            make_float4(acc[i][4 * jg], acc[i][4 * jg + 1], acc[i][4 * jg + 2],
                        acc[i][4 * jg + 3]);
    }
  }
}

// ---- E: stride 1, 3xTF32 wgmma fed by a cp.async ring ----

constexpr int kEK = 16;      // E: pixels a step (two k8 slices)
constexpr int kERing = 4;    // E: steps of raw x and dy in the cp.async ring
constexpr int kEBlocks = 2;  // E: resident blocks an SM (shared memory)
// B (pixel k, column n) sits in shared memory as hi and lo TF32 planes,
// K-major, in 64-byte swizzled atoms as wgmma reads them: 8 rows of 64 bytes
// (a row is the step's 16 pixels), the 16-byte chunk j of row r stored at
// chunk j ^ r / 2. A comes from registers.
constexpr int kEGroup = 512;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst, or 16 zeros when !in (src-size 0:
// nothing is read; src is still a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a = hi + lo + O(2^-22 a): hi and lo each rounded to TF32, nearest, ties away
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(a));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(a - __uint_as_float(hi)));
}
__device__ __forceinline__ void split_tf32(float a, float& hi, float& lo) {
  uint32_t h, l;
  split_tf32(a, h, l);
  hi = __uint_as_float(h);
  lo = __uint_as_float(l);
}

// A wgmma shared-memory descriptor of 64-byte swizzled K-major atoms at p
// (512-byte aligned atoms): lbo and sbo in bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32 |
         static_cast<uint64_t>(2) << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x N, f32) = a (64 x 8) * b (8 x N) + (acc ? d : 0), TF32: a in
// registers (this warp's 16 rows: (g, t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4) for lane 4g + t), b K-major at the shared-memory descriptor b;
// asynchronous
__device__ __forceinline__ void wgmma_128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wgmma_64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int acc);
template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int acc) {
  wgmma_128(d, a, b, acc);
}
template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) {
  wgmma_64(d, a, b, acc);
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

template <int TN>
__global__ void __launch_bounds__(kThreads, kEBlocks)
conv3x3_dw_s1_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     float* __restrict__ part, int h_in, int w_in, int c, int f,
                     long long k_total, int m_tiles, int tiles, int splits) {
  using G = ETile<TN>;
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
  const long long kb = k_total * split / splits;
  const long long ke = k_total * (split + 1) / splits;

  // copies: rows a_m .. a_m + 3 (one tap, 4 channels) at pixels k0 + a_kk + 8q;
  // dy columns b_n .. b_n + 3 at pixels k0 + b_kk + kBRows q
  const int a_m = m0 + 4 * (tid & 31);
  const bool a_ok = a_m < m_total;
  const int tap = a_ok ? a_m / c : 0;
  const int a_c = a_m - tap * c;
  const int a_dh = tap / 3 - 1;
  const int a_dw = tap % 3 - 1;
  const int a_kk = tid >> 5;
  int pb[kAPasses], ph[kAPasses], pw[kAPasses];
#pragma unroll
  for (int q = 0; q < kAPasses; ++q) {
    const long long k = kb + a_kk + 8 * q;
    pw[q] = static_cast<int>(k % w_in);
    const long long t = k / w_in;
    ph[q] = static_cast<int>(t % h_in);
    pb[q] = static_cast<int>(t / h_in);
  }
  const int b_n = n0 + 4 * (tid % kBChunks);
  const bool b_ok = b_n < f;
  const int b_kk = tid / kBChunks;
  auto load = [&](long long k0, int slot) {
    float* a_dst = reinterpret_cast<float*>(ring + slot * G::kRaw) + 4 * (tid & 31);
#pragma unroll
    for (int q = 0; q < kAPasses; ++q) {
      const int hh = ph[q] + a_dh;
      const int ww = pw[q] + a_dw;
      const bool in = a_ok && k0 + a_kk + 8 * q < ke && hh >= 0 && hh < h_in && ww >= 0 &&
                      ww < w_in;
      cp_async16(smem_addr(a_dst + (a_kk + 8 * q) * G::kAStride),
                 in ? x + ((static_cast<size_t>(pb[q]) * h_in + hh) * w_in + ww) * c + a_c : x,
                 in);
      advance(pb[q], ph[q], pw[q], kEK, h_in, w_in);
    }
    float* b_dst = reinterpret_cast<float*>(ring + slot * G::kRaw) + kEK * G::kAStride +
                   4 * (tid % kBChunks);
#pragma unroll
    for (int q = 0; q < kBPasses; ++q) {
      const long long k = k0 + b_kk + kBRows * q;
      const bool in = b_ok && k < ke;
      cp_async16(smem_addr(b_dst + (b_kk + kBRows * q) * G::kBStride),
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
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (long long i = 0; i < steps; ++i) {
    const unsigned char* b_hi = smem + (i & 1) * G::kBuf;
    const unsigned char* b_lo = b_hi + G::kB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kEK / 8; ++kk) {
      const uint64_t bh = smem_desc(b_hi + 32 * kk, 16, kEGroup);
      const uint64_t bl = smem_desc(b_lo + 32 * kk, 16, kEGroup);
      wgmma<TN>(acc, al[kk], bh, i > 0 || kk > 0);
      wgmma<TN>(acc, ah[kk], bl, 1);
      wgmma<TN>(acc, ah[kk], bh, 1);
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
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device, once a device (bit d of `done`: set on device d).
// cudaFuncSetAttribute costs milliseconds of host time a call, which every
// launch would otherwise pay.
cudaError_t allow_smem(const void* kernel, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}


template <int TN>
cudaError_t launch_s2(const float* x, const float* dy, float* part, int h, int w, int c, int f,
                      long long k, int m_tiles, int tiles, int splits, cudaStream_t st) {
  conv3x3_dw_kernel<TN><<<static_cast<unsigned>(tiles) * splits, kThreads, 0, st>>>(
      x, dy, part, h, w, c, f, h / 2, w / 2, k, m_tiles, tiles, splits);
  return cudaGetLastError();
}

template <int TN>
cudaError_t launch_s1(const float* x, const float* dy, float* part, int h, int w, int c, int f,
                      long long k, int m_tiles, int tiles, int splits, cudaStream_t st) {
  const auto kernel = conv3x3_dw_s1_kernel<TN>;
  static std::atomic<uint64_t> smem_set{0};
  constexpr int smem = ETile<TN>::kSmem;
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(tiles) * splits, kThreads, smem, st>>>(
      x, dy, part, h, w, c, f, k, m_tiles, tiles, splits);
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
  cudaError_t err;
  if (stride == 2)
    err = tile_n(f) == 64 ? launch_s2<64>(xf, dyf, pf, h, w, c, f, k, m_tiles, t, splits, st)
                          : launch_s2<128>(xf, dyf, pf, h, w, c, f, k, m_tiles, t, splits, st);
  else
    err = tile_n(f) == 64 ? launch_s1<64>(xf, dyf, pf, h, w, c, f, k, m_tiles, t, splits, st)
                          : launch_s1<128>(xf, dyf, pf, h, w, c, f, k, m_tiles, t, splits, st);
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
