// Greedy BEV NMS with the axis-aligned overlap on Hopper (sm_90a), plain C
// interface.
//
// Replaces no TPU kernel: the JAX package's epnet_tpu/ops/nms.py::nms_bev is
// a lax.while_loop over 64-box blocks that XLA compiles. The port ran that
// loop from the host (epnet_tpu_torch/ops/nms.py::nms_bev_plain): 64 steps
// of three tensor ops a block and a host sync after each block, which made
// the proposal layer's NMS the largest share of its time while the card sat
// idle. This kernel takes the proposal layer's walks (RPN.NMS_TYPE normal)
// in one launch a call, with no host sync inside; the wrapper reads the kept
// count once.
//
// Function: the boxes sb (N, 5) f32, x1, y1, x2, y2 and the angle (unused),
// are sorted by score (descending). Walking them in order, box i is kept unless an earlier kept
// box a has IoU(a, i) > thresh; only the first num_valid boxes are walked,
// and the walk stops once max_keep are kept. ranks[0:count] are the kept
// positions, ascending. The greedy prefix is the plain loop's: its first
// max_keep kept boxes are these.
//
// What bounds it on the H100: the chain of kept boxes. Each kept box needs
// the decisions of every earlier one, so the walk is `count` dependent
// steps, each one N-wide pass of IoUs (four max / min, eight differences
// and sums, three products, three clamps and a division a pair) and one
// barrier. At the proposal layer's budgets (6300 boxes, up to 358 kept)
// that is ~2.3 M IoUs, microseconds of arithmetic; the steps' latency sets
// the time.
//
// Design: one block of kThreads threads a call.
//  - The boxes are read from device memory at every step; at the proposal
//    layer's 6300 boxes (126 KB) they stay in L1 from one step to the next.
//    A copy of x1, y1, x2, y2 in shared memory timed within 2% of this at
//    the proposal layer's shapes on the H100, and needed a second path
//    above ~14,000 boxes, so there is none. Only the removed-bitmap,
//    ceil(num_valid / 64) words, lives in shared memory; the bits past
//    num_valid start set. Its 48 KB, which a block gets without opting in,
//    hold the bits of 393,216 boxes.
//  - The next kept box is the first clear bit above the last one. Every
//    warp finds it on its own: 32 words a ballot, __ffs over the ballot,
//    __ffsll over the word. No barrier is needed for that: bits are only
//    ever set, and the bits a step sets lie above the box it keeps, so a
//    warp that still searches reads the same first clear bit.
//  - The step's pass: warp w takes 32 consecutive boxes j at a time, from
//    the 32-aligned chunk that holds i + 1; a ballot of IoU(box i, box j) >
//    thresh over j > i gives 32 bits, which lane 0 ORs into their word
//    (atomicOr in shared memory). One __syncthreads ends the step. Only
//    kept rows are computed; no N x N matrix exists.
//
// Numerics: the IoU is epnet_tpu_torch/ops/rotated_iou.py::iou_axis_aligned
// operation by operation, with the earlier box as a: max / min propagating
// NaN as torch.maximum / torch.minimum do, clamps at 0 and at EPS = 1e-8f,
// (sa + sb) - inter, then the division; __fsub_rn / __fmul_rn / __fadd_rn /
// __fdiv_rn keep nvcc from contracting anything into an FMA. thresh comes
// as the f32 that PyTorch compares against. The decisions, and so the keep
// lists, are the plain loop's, index for index.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBoxes = 48 * 1024 * 8;  // one bit a box in 48 KB
constexpr float kEps = 1e-8f;             // rotated_iou.EPS

// torch.maximum / torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float tmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float tmin(float a, float b) { return (a < b || a != a) ? a : b; }

struct Box {
  float x1, y1, x2, y2;
};

// iou_axis_aligned(a, b), every operation rounded on its own
__device__ __forceinline__ float iou(const Box& a, const Box& b) {
  const float lx = tmax(a.x1, b.x1);
  const float rx = tmin(a.x2, b.x2);
  const float ly = tmax(a.y1, b.y1);
  const float ry = tmin(a.y2, b.y2);
  const float inter =
      __fmul_rn(tmax(__fsub_rn(rx, lx), 0.0f), tmax(__fsub_rn(ry, ly), 0.0f));
  const float sa = __fmul_rn(__fsub_rn(a.x2, a.x1), __fsub_rn(a.y2, a.y1));
  const float sb = __fmul_rn(__fsub_rn(b.x2, b.x1), __fsub_rn(b.y2, b.y1));
  return __fdiv_rn(inter, tmax(__fsub_rn(__fadd_rn(sa, sb), inter), kEps));
}

__device__ __forceinline__ Box load_box(const float* __restrict__ sb, int j) {
  const float* p = sb + static_cast<size_t>(j) * 5;
  return {p[0], p[1], p[2], p[3]};
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ sb, int n, float thresh, int max_keep,
           int64_t* __restrict__ ranks, int* __restrict__ count) {
  extern __shared__ unsigned long long removed[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = (n + 63) >> 6;

  for (int w = tid; w < nw; w += kThreads)  // bits past n start removed
    removed[w] = (w == nw - 1 && (n & 63)) ? ~0ull << (n & 63) : 0ull;
  __syncthreads();

  const volatile unsigned long long* bits = removed;
  int kept = 0;
  int i = -1;
  while (kept < max_keep) {
    // the first clear bit above i, the same in every warp
    const int s = i + 1;
    int next = n;
    for (int base = s >> 6; base < nw; base += 32) {
      const int w = base + lane;
      unsigned long long f = 0ull;
      if (w < nw) {
        f = ~bits[w];
        if (w == (s >> 6)) f &= ~0ull << (s & 63);
      }
      const unsigned hit = __ballot_sync(0xffffffffu, f != 0ull);
      if (hit) {
        const int src = __ffs(hit) - 1;
        const unsigned long long g = __shfl_sync(0xffffffffu, f, src);
        next = ((base + src) << 6) + __ffsll(static_cast<long long>(g)) - 1;
        break;
      }
    }
    if (next >= n) break;
    i = next;
    if (tid == 0) ranks[kept] = i;
    if (++kept == max_keep) break;

    const Box a = load_box(sb, i);
    for (int jb = ((i + 1) & ~31) + warp * 32; jb < n; jb += kThreads) {
      const int j = jb + lane;
      const bool over = j > i && j < n && iou(a, load_box(sb, j)) > thresh;
      const unsigned m = __ballot_sync(0xffffffffu, over);
      if (lane == 0 && m)
        atomicOr(&removed[jb >> 6], static_cast<unsigned long long>(m) << (jb & 32));
    }
    __syncthreads();
  }
  if (tid == 0) *count = kept;
}

}  // namespace

extern "C" {

// sb: (>= num_valid, 5) float32, contiguous, sorted by score; ranks:
// (max_keep,) int64; count: (1,) int32. Walks the first num_valid boxes on
// `stream` in one block, writes ranks[0:count] and count, allocates nothing,
// returns the launch's error.
int epnet_nms_launch(const void* sb, int num_valid, float thresh, int max_keep, void* ranks,
                     void* count, void* stream) {
  if (num_valid < 0 || num_valid > kMaxBoxes || max_keep < 1) return cudaErrorInvalidValue;
  const size_t bitmap = ((num_valid + 63) / 64) * sizeof(unsigned long long);
  nms_kernel<<<1, kThreads, bitmap, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sb), num_valid, thresh, max_keep,
      static_cast<int64_t*>(ranks), static_cast<int*>(count));
  return cudaGetLastError();
}

const char* epnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
