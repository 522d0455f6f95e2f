// Exact furthest point sampling on Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels epnet_tpu/ops/fps_pallas.py::_fps_kernel_vec
// (pallas_call at :149) and ::_fps_kernel (:166). Same function: index 0
// first; each step takes mind = min(mind, |p - p_last|^2) and picks the
// argmax, lowest index on ties. The plain version is
// epnet_tpu_torch/ops/fps.py::furthest_point_sample_plain.
//
// What bounds it on the H100: the npoint-1 steps are a dependent chain, and
// each step is an argmax over the whole cloud. The work is ~10 operations a
// point and step; the time is steps x the latency of one step (a distance
// update, then a reduction across the threads that hold the cloud).
//
// Design: one thread-block cluster per large cloud, one block per small one.
//  - A cloud of n points is cut into cs contiguous slices, one per block of
//    the cluster (cs = 1 for a small cloud). Each thread holds PPT points of
//    its block's slice (points base + tid + k * threads): their x, y, z and
//    running min-distance live in registers, so a step reads no memory.
//  - The argmax is a max over packed 64-bit keys (float_bits(mind) << 32) |
//    (0xFFFFFFFF - index): distances are >= 0, so their bit patterns order
//    as the floats do, and the max key holds the largest distance and, on
//    ties, the lowest index, as torch.argmax and the Pallas kernel pick.
//    That max is associative, so any reduction tree picks the same index.
//    A warp reduces with two __reduce_max_sync (the high word, then the low
//    word among the lanes holding the high maximum); the winning lane holds
//    the point's coordinates, which travel with the key from then on.
//  - A block combines its warps' (key, x, y, z) through a double-buffered
//    shared array and one __syncthreads; with one warp a cloud (the RCNN's
//    tables of 512 and 128 points) there is no barrier at all.
//  - A cluster combines its blocks: warp 0 of each block reduces the block,
//    and lane r writes the block's winner into slot [step & 1][rank] of
//    block r's shared memory (distributed shared memory); one
//    barrier.cluster arrive (release from warp 0, relaxed from the rest) /
//    wait (acquire) later, every block reduces the cs slots itself and
//    knows the next point's coordinates. Double-buffering by the step's
//    parity makes one cluster barrier a step enough: a block writes slot
//    [j & 1] again at step j + 2, after the barrier of step j + 1, which
//    every block reaches only after reading step j's slots. That exchange
//    costs ~0.6 us a step on the H100, whatever the cluster's size (an
//    mbarrier arrive on each block, in place of the cluster barrier, was
//    tried and was no faster), so a cluster pays only where one block's
//    step is slower: above 4096 points.
//  - The launcher picks (cs, threads) by the cloud's size (fps_config),
//    never by catching a failure; a cluster that cannot be scheduled is an
//    error. Clusters of 16 blocks are non-portable: the launcher allows them
//    once a device.
//
// Numerics: the distance is computed with __fsub_rn/__fmul_rn/__fadd_rn in
// the plain version's order ((dx*dx + dy*dy) + dz*dz), so nvcc cannot
// contract it into FMAs; the picks are then index-identical to the plain
// PyTorch loop and to the JAX reference.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;  // a block; 128 registers a thread
constexpr int kMaxPpt = 16;       // points a thread
constexpr int kMaxCluster = 16;   // blocks a cluster (non-portable above 8)

// A candidate: its key (float bits of its distance, 0xFFFFFFFF - index) and
// its coordinates. The empty key (0, 0) loses to every point.
struct __align__(16) Cand {
  uint32_t hi, lo;
  float x, y, z;
};

__device__ __forceinline__ void put(Cand* p, uint32_t hi, uint32_t lo, float x, float y,
                                    float z) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(hi, lo, __float_as_uint(x), __float_as_uint(y));
  p->z = z;
}

// The warp's largest key, in every lane; returns the lane that holds it.
// Keys of points are distinct (the index is in the low word).
__device__ __forceinline__ int warp_argmax(uint32_t& hi, uint32_t& lo) {
  const uint32_t mh = __reduce_max_sync(0xffffffffu, hi);
  const uint32_t ml = __reduce_max_sync(0xffffffffu, hi == mh ? lo : 0u);
  const unsigned who = __ballot_sync(0xffffffffu, hi == mh && lo == ml);
  hi = mh;
  lo = ml;
  return __ffs(who) - 1;
}

// Every thread of the cluster arrives and waits (acquire). Only the warps
// that wrote into other blocks' shared memory (`release`) release their
// writes to the cluster: a release waits for all of a thread's earlier
// stores, the picks' global stores included.
__device__ __forceinline__ void cluster_barrier(bool release) {
  __syncwarp();
  if (release)
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  else
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One cloud a block (kCluster false) or a cluster (true); `slice` points a
// block, PPT a thread.
template <int PPT, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, int64_t* __restrict__ out, int n, int npoint,
           int slice) {
  __shared__ Cand warp_best[2][kMaxThreads / 32];
  __shared__ Cand block_best[2][kMaxCluster];

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  int cs = 1, rank = 0;
  if (kCluster) {
    cs = static_cast<int>(cg::this_cluster().num_blocks());
    rank = static_cast<int>(cg::this_cluster().block_rank());
  }
  const int cloud = blockIdx.x / cs;
  const float* pts = xyz + static_cast<size_t>(cloud) * n * 3;
  int64_t* picks = out + static_cast<size_t>(cloud) * npoint;
  const int base = rank * slice + tid;  // this thread's first point
  const int end = min(n, (rank + 1) * slice);

  float px[PPT], py[PPT], pz[PPT], mind[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = base + k * nthreads;
    const bool in = i < end;
    px[k] = in ? pts[3 * i] : 0.0f;
    py[k] = in ? pts[3 * i + 1] : 0.0f;
    pz[k] = in ? pts[3 * i + 2] : 0.0f;
    mind[k] = in ? 1e10f : -1.0f;  // -1: never a candidate
  }
  float lx = pts[0], ly = pts[1], lz = pts[2];
  // the picks' writer: a thread that releases nothing to the cluster, so no
  // release waits for its global stores
  const bool writer = rank == 0 && tid == nthreads - 1;
  if (writer) picks[0] = 0;
  if (kCluster) cluster_barrier(false);  // every block runs before any remote write

  for (int j = 1; j < npoint; ++j) {
    const int par = j & 1;
    float bv = -1.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
    int bk = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const float dx = __fsub_rn(px[k], lx);
      const float dy = __fsub_rn(py[k], ly);
      const float dz = __fsub_rn(pz[k], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(mind[k], d);
      mind[k] = m;
      if (m > bv) {  // the index rises with k: the lowest wins a tie
        bv = m;
        bk = k;
        bx = px[k];
        by = py[k];
        bz = pz[k];
      }
    }
    uint32_t hi = bv >= 0.0f ? __float_as_uint(bv) : 0u;
    uint32_t lo = bv >= 0.0f ? 0xFFFFFFFFu - static_cast<uint32_t>(base + bk * nthreads) : 0u;
    int who = warp_argmax(hi, lo);
    if (!kCluster && nwarps == 1) {
      lx = __shfl_sync(0xffffffffu, bx, who);
      ly = __shfl_sync(0xffffffffu, by, who);
      lz = __shfl_sync(0xffffffffu, bz, who);
    } else {
      if (lane == who) put(&warp_best[par][warp], hi, lo, bx, by, bz);
      __syncthreads();
      if (!kCluster || warp == 0) {  // the block's winner
        Cand c = {0u, 0u, 0.0f, 0.0f, 0.0f};
        if (lane < nwarps) c = warp_best[par][lane];
        hi = c.hi;
        lo = c.lo;
        who = warp_argmax(hi, lo);
        lx = __shfl_sync(0xffffffffu, c.x, who);
        ly = __shfl_sync(0xffffffffu, c.y, who);
        lz = __shfl_sync(0xffffffffu, c.z, who);
        if (kCluster && lane < cs)
          put(cg::this_cluster().map_shared_rank(&block_best[par][rank], lane), hi, lo, lx, ly,
              lz);
      }
      if (kCluster) {  // the cluster's winner, in every warp
        cluster_barrier(warp == 0);
        Cand c = {0u, 0u, 0.0f, 0.0f, 0.0f};
        if (lane < cs) c = block_best[par][lane];
        hi = c.hi;
        lo = c.lo;
        who = warp_argmax(hi, lo);
        lx = __shfl_sync(0xffffffffu, c.x, who);
        ly = __shfl_sync(0xffffffffu, c.y, who);
        lz = __shfl_sync(0xffffffffu, c.z, who);
      }
    }
    if (writer) picks[j] = 0xFFFFFFFFu - lo;
  }
}

// The configuration the launcher takes for a cloud of n points: cs blocks
// a cluster (1: one block), threads a block. Chosen by n from the times of
// every configuration on the H100 (PERF.md, run AN): a step
// across a cluster costs ~1 us whatever its size (the exchange through
// distributed shared memory and the cluster barrier), one block's step
// 0.35-0.6 us at 256-4096 points, so one block takes every cloud it can
// hold at 16 points a thread in 256 threads, and a larger cloud the
// cluster of 128-thread blocks of 16 points a thread, the fastest at RPN
// sa0.
void fps_config(int n, int& cs, int& threads) {
  cs = 1;
  if (n <= 32 * kMaxPpt) {  // the RCNN's tables: one warp a cloud
    threads = 32;
  } else if (n <= 256 * kMaxPpt) {
    threads = 256;
  } else {
    threads = 128;
    cs = 2;
    while (cs < kMaxCluster && cs * threads * kMaxPpt < n) cs <<= 1;
    while (threads < kMaxThreads && cs * threads * kMaxPpt < n) threads <<= 1;
  }
}

template <int PPT, bool kCluster>
cudaError_t launch_ppt(const float* xyz, int64_t* out, int b, int n, int npoint, int cs,
                       int threads, cudaStream_t st) {
  const int slice = (n + cs - 1) / cs;
  const auto kernel = fps_kernel<PPT, kCluster>;
  if (!kCluster) {
    kernel<<<b, threads, 0, st>>>(xyz, out, n, npoint, slice);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * cs);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // once a device and cluster size: allow 16-block clusters, and check that
  // one cluster of this shape can be scheduled at all
  static std::atomic<uint64_t> checked[kMaxCluster + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(checked[cs].load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    checked[cs].fetch_or(bit, std::memory_order_release);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, xyz, out, n, npoint, slice);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kCluster>
cudaError_t launch_cfg(const float* xyz, int64_t* out, int b, int n, int npoint, int cs,
                       int threads, cudaStream_t st) {
  const int ppt = (n + cs * threads - 1) / (cs * threads);
  if (ppt <= 1) return launch_ppt<1, kCluster>(xyz, out, b, n, npoint, cs, threads, st);
  if (ppt <= 2) return launch_ppt<2, kCluster>(xyz, out, b, n, npoint, cs, threads, st);
  if (ppt <= 4) return launch_ppt<4, kCluster>(xyz, out, b, n, npoint, cs, threads, st);
  if (ppt <= 8) return launch_ppt<8, kCluster>(xyz, out, b, n, npoint, cs, threads, st);
  return launch_ppt<16, kCluster>(xyz, out, b, n, npoint, cs, threads, st);
}

}  // namespace

extern "C" {

// Largest cloud a launch takes: kMaxCluster blocks of kMaxThreads threads of
// kMaxPpt points.
int epnet_fps_max_points() { return kMaxCluster * kMaxThreads * kMaxPpt; }

// The launcher's configuration for a cloud of n points: blocks a cluster
// (1: one block a cloud) and threads a block.
void epnet_fps_config(int n, int* cs, int* threads) { fps_config(n, *cs, *threads); }

// xyz: (b, n, 3) float32, contiguous; out: (b, npoint) int64. Launches in
// the configuration fps_config picks for n (above one block a cloud, a
// thread-block cluster) on `stream`, allocates nothing, returns the
// launch's error.
int epnet_fps_launch(const void* xyz, void* out, int b, int n, int npoint, void* stream) {
  if (b == 0 || npoint == 0) return 0;
  if (n <= 0 || npoint > n || n > kMaxCluster * kMaxThreads * kMaxPpt)
    return cudaErrorInvalidValue;
  int cs = 1, threads = 32;
  fps_config(n, cs, threads);
  const auto* p = static_cast<const float*>(xyz);
  auto* o = static_cast<int64_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return cs == 1 ? launch_cfg<false>(p, o, b, n, npoint, 1, threads, st)
                 : launch_cfg<true>(p, o, b, n, npoint, cs, threads, st);
}

const char* epnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
