// Host helpers the kernel libraries share. Each csrc/<name>.cu that
// includes this header is rebuilt when it changes: ops/cuda_build.py keys a
// library on its source and the local headers it includes.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

// Raises `kernel`'s dynamic shared-memory limit on the current device to
// `bytes`, once a device (bit d of `done`: set on device d).
// cudaFuncSetAttribute costs milliseconds of host time a call, which every
// launch would otherwise pay.
inline cudaError_t allow_smem(const void* kernel, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace
