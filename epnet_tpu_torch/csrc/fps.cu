// Exact furthest point sampling on Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel epnet_tpu/ops/fps_pallas.py::_fps_kernel_vec
// (pallas_call at :149). Same function: index 0 first; each step takes
// mind = min(mind, |p - p_last|^2) and picks the argmax, lowest index on
// ties. The plain version is epnet_tpu_torch/ops/fps.py::
// furthest_point_sample_plain.
//
// What bounds it on the H100: the npoint-1 steps are a dependent chain, and
// each step is a block-wide argmax. At batch 1 the RPN sa0 stage (16384
// points -> 4096) runs on one SM, so the kernel is latency-bound: the time
// is steps x (per-thread distance update + one block reduction).
//
// Design: one thread block per cloud. The cloud's coordinates sit in shared
// memory as three planes (12 B a point, 192 KB at 16384 points); each thread
// owns the points tid, tid + T, ... and keeps their running min-distance in
// registers (16 a thread). A step is the register update, a warp-shuffle
// argmax carrying (value, index), and one __syncthreads to combine the warps
// through a double-buffered shared array (the next step writes the other
// buffer, so no second barrier is needed). Small clouds (the RCNN tables of
// 512 points) get a single warp per cloud and no barrier at all. Spreading a
// large cloud over a cluster of SMs is left for a later change.
//
// Numerics: the distance is computed with __fsub_rn/__fmul_rn/__fadd_rn in
// the plain version's order ((dx*dx + dy*dy) + dz*dz), so nvcc cannot
// contract it into FMAs; the picks are then index-identical to the plain
// PyTorch loop and to the JAX reference.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kPointsPerThread = 16;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    take_better(v, i, ov, oi);
  }
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, int64_t* __restrict__ out, int n,
           int npoint) {
  extern __shared__ float planes[];
  float* sx = planes;
  float* sy = sx + n;
  float* sz = sy + n;
  __shared__ float red_v[2][32];
  __shared__ int red_i[2][32];

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const float* cloud = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int64_t* picks = out + static_cast<size_t>(blockIdx.x) * npoint;

  for (int i = tid; i < n; i += nthreads) {
    sx[i] = cloud[3 * i];
    sy[i] = cloud[3 * i + 1];
    sz[i] = cloud[3 * i + 2];
  }
  float mind[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) mind[k] = 1e10f;
  if (tid == 0) picks[0] = 0;
  __syncthreads();

  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float lx = sx[last];
    const float ly = sy[last];
    const float lz = sz[last];
    float best_v = -1.0f;
    int best_i = n;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tid + k * nthreads;
      if (i < n) {
        const float dx = __fsub_rn(sx[i], lx);
        const float dy = __fsub_rn(sy[i], ly);
        const float dz = __fsub_rn(sz[i], lz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        const float m = fminf(mind[k], d);
        mind[k] = m;
        if (m > best_v) {  // i rises with k: the lowest index wins a tie
          best_v = m;
          best_i = i;
        }
      }
    }
    warp_argmax(best_v, best_i);
    if (nwarps > 1) {
      const int buf = j & 1;
      if (lane == 0) {
        red_v[buf][warp] = best_v;
        red_i[buf][warp] = best_i;
      }
      __syncthreads();
      best_v = lane < nwarps ? red_v[buf][lane] : -1.0f;
      best_i = lane < nwarps ? red_i[buf][lane] : n;
      warp_argmax(best_v, best_i);
    }
    last = best_i;
    if (tid == 0) picks[j] = last;
  }
}

}  // namespace

extern "C" {

// Largest cloud one block takes: every thread holds kPointsPerThread
// running distances in registers.
int epnet_fps_max_points() { return kPointsPerThread * kMaxThreads; }

// xyz: (b, n, 3) float32, contiguous; out: (b, npoint) int64. Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
int epnet_fps_launch(const void* xyz, void* out, int b, int n, int npoint,
                     void* stream) {
  if (b == 0 || npoint == 0) return 0;
  if (n <= 0 || n > kPointsPerThread * kMaxThreads) return cudaErrorInvalidValue;
  int threads = 32;
  while (threads * kPointsPerThread < n) threads <<= 1;
  const size_t smem = 3u * static_cast<size_t>(n) * sizeof(float);
  static std::atomic<uint64_t> smem_set{0};  // the largest cloud's, once a device
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(fps_kernel<kPointsPerThread>),
                 3 * kPointsPerThread * kMaxThreads * static_cast<int>(sizeof(float)), smem_set);
  if (err != cudaSuccess) return err;
  fps_kernel<kPointsPerThread><<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<int64_t*>(out), n, npoint);
  return cudaGetLastError();
}

const char* epnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
