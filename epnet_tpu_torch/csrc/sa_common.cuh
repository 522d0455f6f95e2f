// Device helpers of the fused set-abstraction kernels on distinct rows: the
// forwards B, G, B-bf16 and G-bf16 (csrc/sa_fused.cu) and the backward pair
// C and H (csrc/sa_fused_bwd.cu) include this one copy. ops/cuda_build.py
// keys each library on the headers its source includes, nested ones too, so
// both rebuild when this or csrc/wgmma_common.cuh changes.
//
// - sa_dedupe_kernel: each centroid's distinct table rows, a warp bitonic
//   sort a centroid;
// - sa_scan_kernel and lower_bound: blocks split the centroids by cost
//   (distinct rows plus a fixed cost a centroid), not by their number;
// - gather_h1: h1 = relu(Y[row] - O) for a tile of up to 64 distinct rows;
//   gather_h1_bf16 the same from bf16 Y and O into a swizzled bf16 tile that
//   wgmma reads, and load_w_panels a bf16 weight into the swizzled panels
//   that wgmma reads (B-bf16, G-bf16, C-bf16, H-bf16);
// - ring_product, load_w128 and slot_steps: a product against 128-column
//   K-tiles of a weight streamed from L2 through a 3-slot cp.async ring, on
//   the TF32 tensor cores (mma.sync m16n8k8) in three passes: each operand
//   split as hi = tf32(a), lo = tf32(a - hi), both rounded to nearest (in
//   integer operations: split_tf32 of csrc/wgmma_common.cuh, which the conv
//   kernels share), and lo*hi + hi*lo + hi*hi accumulated in f32, about as
//   accurate as an f32 product (B and G: each k8 step's sum added to the
//   running sum on the CUDA cores, slot_steps' kStepSums).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "wgmma_common.cuh"

namespace {

constexpr int kRows = 64;      // distinct rows a tile
constexpr int kMaxCent = 32;   // centroids a tile (one warp packs them)
constexpr int kThreads = 256;  // 8 warps
constexpr int kC = 128;        // C1 = C2
constexpr int kLd = kC + 4;    // row stride of the h1/h2 tiles: A fragments hit 32 banks
constexpr int kW2Rows = 16;    // W2 rows a ring slot (two k8 steps)
constexpr int kW2Ld = kC + 8;  // B fragments hit 32 banks
constexpr int kSlot = 32 * (64 + 8);  // floats a ring slot: a kW2Rows x kW2Ld K-tile, or
                                      // the backward's 32 x 72 W3 K-tile
constexpr int kStages = 3;
constexpr int kMaxSmem = 232448;
static_assert(kSlot >= kW2Rows * kW2Ld, "ring slot");
constexpr int kAtom = 1024;                  // a 128-byte swizzled atom: 8 rows of 128 bytes
constexpr int kWPanel = kC / 8 * kAtom;      // 64 columns of a weight's 128 rows: 16 KB
constexpr int kH1Panel = kRows / 8 * kAtom;  // 64 columns of a 64-row tile: 8 KB

// Byte offset of element (row, col) in 128-byte swizzled panels of 64 bf16
// columns, `panel` bytes apart: the K-major tiles (row a tile row, col a
// channel) and the N-major weights (row k, col n) that wgmma reads.
__device__ __forceinline__ int swz_off(int row, int col, int panel) {
  return (col >> 6) * panel + (row >> 3) * kAtom + (row & 7) * 128 +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

// A 16 x 8 TF32 fragment, split: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
// for lane 4g + t.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};
// An 8 x 8 TF32 fragment, split: (k = t, n = g), (t + 4, g).
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, hi[0], lo[0]);
    split_tf32(b1, hi[1], lo[1]);
  }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d = a b, from 0 (the accumulator's input is one zero register, which
// ptxas takes from RZ)
__device__ __forceinline__ void mma_tf32_from0(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}
// d += a b in three TF32 passes, the small terms first; accumulator (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// A product over `tiles` K-tiles of weights streamed through a ring of
// kNStages slots of kSlotFloats: load(i, slot) starts the cp.async copies
// of K-tile i, compute(i, slot) runs on it once every thread's copies have
// landed. Ends with the ring free (all copies waited for, a barrier).
template <int kNStages = kStages, int kSlotFloats = kSlot, class Load, class Compute>
__device__ __forceinline__ void ring_product(int tiles, float* ring, Load load,
                                             Compute compute) {
#pragma unroll
  for (int i = 0; i < kNStages - 1; ++i) {
    if (i < tiles) load(i, ring + i * kSlotFloats);
    cp_async_commit();
  }
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<kNStages - 2>();
    __syncthreads();  // K-tile i is in; every thread is done with K-tile i - 1
    const int next = i + kNStages - 1;
    if (next < tiles) load(next, ring + (next % kNStages) * kSlotFloats);
    cp_async_commit();
    compute(i, ring + (i % kNStages) * kSlotFloats);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Each centroid's distinct table rows, ascending, as row * 128 + multiplicity,
// and their count. A warp a centroid.
template <bool kWin>
__global__ void __launch_bounds__(kThreads)
sa_dedupe_kernel(const int64_t* __restrict__ idx, const int64_t* __restrict__ starts,
                     int* __restrict__ rows, int* __restrict__ counts, int cents, int n, int m,
                     int s, int nb, int window) {
  const int cent = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (cent >= cents) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int t = cent / m;
  const int64_t* it = idx + static_cast<size_t>(cent) * s;
  int key[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int e = 32 * j + lane;
    if (e < s) {
      int64_t p = it[e];
      if (kWin) {
        p = p < 0 ? 0 : (p >= window ? window - 1 : p);  // inside the window
        p += starts[static_cast<size_t>(t) * nb + (cent % m) / (m / nb)];
      }
      p = p < 0 ? 0 : (p >= n ? n - 1 : p);  // keep a bad index inside the table
      key[j] = static_cast<int>(p);
    } else {
      key[j] = INT_MAX;  // sorts last
    }
  }
  // bitonic sort of the 64 keys, element e = 32 j + lane
#pragma unroll
  for (int k = 2; k <= 64; k <<= 1) {
#pragma unroll
    for (int d = k >> 1; d > 0; d >>= 1) {
      int nv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 32 * j + lane;
        const int p = d == 32 ? key[j ^ 1] : __shfl_xor_sync(0xffffffffu, key[j], d);
        const bool keep_min = ((e & d) == 0) == ((e & k) == 0);
        nv[j] = keep_min ? min(key[j], p) : max(key[j], p);
      }
      key[0] = nv[0];
      key[1] = nv[1];
    }
  }
  int prev0 = __shfl_up_sync(0xffffffffu, key[0], 1);
  int prev1 = __shfl_up_sync(0xffffffffu, key[1], 1);
  const int last0 = __shfl_sync(0xffffffffu, key[0], 31);
  if (lane == 0) prev1 = last0;
  const bool first0 = lane < s && (lane == 0 || key[0] != prev0);
  const bool first1 = 32 + lane < s && key[1] != prev1;
  const uint64_t f = static_cast<uint64_t>(__ballot_sync(0xffffffffu, first0)) |
                     static_cast<uint64_t>(__ballot_sync(0xffffffffu, first1)) << 32;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (!(j ? first1 : first0)) continue;
    const int e = 32 * j + lane;
    const int pos = __popcll(f & ((uint64_t{1} << e) - 1));
    const uint64_t later = e == 63 ? 0 : f & ~((uint64_t{2} << e) - 1);
    const int end = later ? __ffsll(static_cast<long long>(later)) - 1 : s;
    rows[static_cast<size_t>(cent) * kRows + pos] = key[j] * 128 + (end - e);
  }
  if (lane == 0) counts[cent] = __popcll(f);
}

// prefix[i] = sum of counts[j] + kCost over j < i, i <= cents (one block):
// the main kernel splits the centroids among its blocks by that cost, not by
// their number, since balls differ ~60-fold in distinct rows and
// neighbouring RoIs alike. kCost is a centroid's fixed cost in distinct rows.
template <int kCost>
__global__ void __launch_bounds__(1024)
sa_scan_kernel(const int* __restrict__ counts, int* __restrict__ prefix, int cents) {
  __shared__ int part[1024];
  const int t = threadIdx.x;
  const int per = (cents + 1023) / 1024;
  const int b = min(cents, t * per);
  const int e = min(cents, b + per);
  int sum = 0;
  for (int i = b; i < e; ++i) sum += counts[i] + kCost;
  part[t] = sum;
  __syncthreads();
  for (int off = 1; off < 1024; off <<= 1) {
    const int v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = part[t] - sum;
  for (int i = b; i < e; ++i) {
    prefix[i] = run;
    run += counts[i] + kCost;
  }
  if (t == 1023) prefix[cents] = part[1023];
}

// The first i <= n with prefix[i] >= v (prefix ascending).
__device__ __forceinline__ int lower_bound(const int* prefix, int n, long long v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (prefix[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// two values rounded to bf16, to nearest even, `lo` in the low half
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
// (kN threads, `gtid` 0 .. kN - 1), into K-major 128-byte swizzled
// panels of 64 columns: element (r, k) at (k / 64) kH1Panel + (r / 8) 1024 +
// (r % 8) 128 + ((k % 64 / 8) ^ (r % 8)) 16 + (k % 8) 2. Each thread's
// loads from L2 are all issued before the first is used.
template <int kN>
__device__ __forceinline__ void gather_h1_bf16(unsigned char* h1,
                                               const __nv_bfloat16* __restrict__ y,
                                               const __nv_bfloat16* __restrict__ o,
                                               const int* row_tab, const int* row_slot,
                                               const int* cent_id, int n_rows, int gtid) {
  constexpr int kPer = kRows * (kC / 8) / kN;   // 16-byte chunks a thread
  const int k8 = gtid & 15;                     // its chunk of each of its rows
  uint4 a[kPer], b[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = (gtid >> 4) + (kN / 16) * i;
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
    const int r = (gtid >> 4) + (kN / 16) * i;
    *reinterpret_cast<uint4*>(h1 + (k8 >> 3) * kH1Panel + (r >> 3) * kAtom + (r & 7) * 128 +
                              (((k8 & 7) ^ (r & 7)) * 16)) =
        make_uint4(h(a[i].x, b[i].x), h(a[i].y, b[i].y), h(a[i].z, b[i].z), h(a[i].w, b[i].w));
  }
}

// h1 = relu(Y[row] - O[centroid]) for the tile's rows, 0 past them.
__device__ __forceinline__ void gather_h1(float* buf, const float* __restrict__ y,
                                          const float* __restrict__ o, const int* row_tab,
                                          const int* row_slot, const int* cent_id,
                                          int n_rows) {
  for (int e = threadIdx.x; e < kRows * (kC / 4); e += kThreads) {
    const int r = e >> 5;
    const int c4 = 4 * (e & 31);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < n_rows) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(
          y + static_cast<size_t>(row_tab[r]) * kC + c4));
      const float4 b = __ldg(reinterpret_cast<const float4*>(
          o + static_cast<size_t>(cent_id[row_slot[r]]) * kC + c4));
      v = make_float4(fmaxf(a.x - b.x, 0.0f), fmaxf(a.y - b.y, 0.0f), fmaxf(a.z - b.z, 0.0f),
                      fmaxf(a.w - b.w, 0.0f));
    }
    *reinterpret_cast<float4*>(buf + r * kLd + c4) = v;
  }
}

// K-tile i (kKRows rows) of a row-major weight with 128 columns from w on,
// rows `ld` floats apart (W2 or W2^T; a 128-column pass of W3), into a ring
// slot (rows kW2Ld apart).
template <int kKRows = kW2Rows>
__device__ __forceinline__ void load_w128(const float* __restrict__ w, int i, float* slot,
                                          int ld = kC) {
#pragma unroll
  for (int h = 0; h < kKRows / 8; ++h) {
    const int r = (threadIdx.x >> 5) + 8 * h;
    const int c4 = 4 * (threadIdx.x & 31);
    cp_async<16>(smem_addr(slot + r * kW2Ld + c4),
                 w + static_cast<size_t>(kKRows * i + r) * ld + c4, true);
  }
}

// A = rows of `a` (row-major, kLd) given by ra/rb; B = the slot's K-tile
// (ksteps x 8 rows, 128 columns); 32 rows x 32 columns of this warp (m-tiles
// mt < active). kStepSums (kernels B and G, whose outputs are the layer's
// values): each k8 step's three passes summed from 0 on the tensor cores,
// then added to acc on the CUDA cores, rounded to nearest. The tensor
// cores' accumulation truncates, and a running sum truncated 48 times over
// K = 128 is biased toward 0 by ~2e-6 of max|out|; per-step sums keep it
// to ~6e-7 (PERF.md, PR 12). Otherwise the passes accumulate into acc.
template <int kMT, int kNT, bool kStepSums = false>
__device__ __forceinline__ void slot_steps(float (&acc)[kMT][kNT][4], const float* a, int a_ld,
                                           const int (&ra)[kMT], const int (&rb)[kMT],
                                           int a_k0, const float* slot, int slot_ld, int ksteps,
                                           int n0, int active) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < ksteps; ++kk) {
    const int k = a_k0 + 8 * kk;
    FragA fa[kMT];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
      if (mt < active)
        fa[mt].set(a[ra[mt] * a_ld + k + t], a[rb[mt] * a_ld + k + t],
                   a[ra[mt] * a_ld + k + t + 4], a[rb[mt] * a_ld + k + t + 4]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      FragB fb;
      const float* b = slot + (8 * kk + t) * slot_ld + n0 + 8 * nt + g;
      fb.set(b[0], b[4 * slot_ld]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (mt >= active) continue;
        if (kStepSums) {
          float d[4];
          mma_tf32_from0(d, fa[mt].lo, fb.hi);
          mma_tf32(d, fa[mt].hi, fb.lo);
          mma_tf32(d, fa[mt].hi, fb.hi);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] += d[q];
        } else {
          mma3(acc[mt][nt], fa[mt], fb);
        }
      }
    }
  }
}

}  // namespace
