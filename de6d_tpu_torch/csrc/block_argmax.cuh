// Block-wide first argmax over (key, index) pairs, shared by the
// farthest-point-sampling kernels (fps.cu, matrix_fps.cu): one block of
// kThreads threads per sample, one call per pick.
//
// Larger key wins; on equal keys the lower index wins, so the result is
// the first maximum of the sample whatever thread held it.

#pragma once

#include <cuda_runtime.h>

namespace de6d {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kInit = 1e10f;  // running minimum of a point not yet measured

__device__ __forceinline__ void better(float& key, int& idx, float ok, int oi) {
  if (ok > key || (ok == key && oi < idx)) {
    key = ok;
    idx = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& key, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ok = __shfl_xor_sync(0xffffffffu, key, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    better(key, idx, ok, oi);
  }
}

// Every thread returns the block's winner. Warp winners go to the shared
// slot `slot`, one barrier, then every warp reduces the kWarps winners
// itself. `slot` must alternate between consecutive calls: the next call
// then writes the other slot while slow warps still read this one, and no
// second barrier is needed.
__device__ __forceinline__ void block_argmax(float& key, int& idx,
                                             float (*red_key)[kWarps],
                                             int (*red_idx)[kWarps], int slot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmax(key, idx);
  if (lane == 0) {
    red_key[slot][warp] = key;
    red_idx[slot][warp] = idx;
  }
  __syncthreads();
  key = red_key[slot][lane];
  idx = red_idx[slot][lane];
  warp_argmax(key, idx);
}

}  // namespace de6d
