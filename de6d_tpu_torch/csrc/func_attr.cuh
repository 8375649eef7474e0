// Kernel function attributes set once per (kernel, attribute, device) and
// value, not on every launch: cudaFuncSetAttribute costs a few
// microseconds of host time, which a small kernel's launch cannot hide.
// A later request for a value no larger than the one already set (a
// smaller dynamic shared-memory size) costs a map lookup.

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace de6d {

inline cudaError_t cached_func_attribute(const void* fn,
                                         cudaFuncAttribute attr, int value) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, int> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(fn, static_cast<int>(attr), dev);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = done.find(key);
  if (it != done.end() && it->second >= value) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, attr, value);
  if (err == cudaSuccess) done[key] = value;
  return err;
}

// Opt `kernel` in to `bytes` of dynamic shared memory on the current
// device (needed above 48 KB).
template <typename Kernel>
inline cudaError_t max_dynamic_smem(Kernel kernel, int bytes) {
  return cached_func_attribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
}

}  // namespace de6d
