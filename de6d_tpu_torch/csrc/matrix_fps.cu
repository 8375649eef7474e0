// f-fps: farthest-point sampling over a precomputed (N, N) distance
// matrix; one block of 1024 threads per sample runs the whole sequential
// pick loop.
//
// Replaces the TPU kernel de6d_tpu/ops/pallas/fps.py:matrix_fps_pallas
// (eight samples per grid step, each pick an aligned 8-row copy from HBM
// and a one-hot row select). Semantics (oracle
// de6d_tpu/ops/sampling.py:_fps_loop over dm[last]):
//   md0  = valid ? 1e10 : -1,  seed = index 0 (valid or not)
//   md   = valid ? min(md, dm[last, :]) : -1
//   pick = first (lowest-index) argmax of md
// Picks repeat once every valid point is taken, as the reference's do. The
// matrix must hold no NaN (fminf drops one where the reference keeps it).
//
// Bound: of the matrix only the rows of the picks are read, (npoint - 1)
// rows of N floats per sample, which is the byte bound; but the picks are a
// dependency chain, each step one row read from global memory that cannot
// start before the previous pick is known, then a block-wide argmax, so
// the kernel is held by latency. Design:
//   * nothing of the matrix is staged: row `last` is read straight into
//     registers, thread t taking columns t, t + 1024, ... (coalesced, all
//     of a thread's loads in flight together);
//   * each thread keeps its ITEMS = ceil(N / 1024) running minima in
//     registers and its valid flags in one bit mask; a thread's columns
//     ascend, so a strict '>' keeps its first maximum;
//   * the argmax per pick is block_argmax.cuh, shared with fps.cu.
// N <= 16384 (16 minima per thread). On the main path 8 of 132 SMs are
// busy; prefetching and splitting a sample over a cluster are left to a
// later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

#include "block_argmax.cuh"

namespace {

using de6d::block_argmax;
using de6d::kInit;
using de6d::kThreads;
using de6d::kWarps;

constexpr int kMaxItems = 16;  // N <= 16384

template <int ITEMS>
__global__ void __launch_bounds__(kThreads, 1)
matrix_fps_kernel(const float* __restrict__ dm,
                  const uint8_t* __restrict__ valid, int* __restrict__ out,
                  int N, int npoint) {
  __shared__ float red_key[2][kWarps];
  __shared__ int red_idx[2][kWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* dm_b = dm + static_cast<size_t>(b) * N * N;
  const uint8_t* valid_b = valid + static_cast<size_t>(b) * N;
  int* out_b = out + static_cast<size_t>(b) * npoint;

  float md[ITEMS];
  uint32_t vbits = 0u;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = tid + k * kThreads;
    const bool v = i < N && valid_b[i] != 0;
    vbits |= static_cast<uint32_t>(v) << k;
    md[k] = v ? kInit : -1.0f;
  }

  int last = 0;
  if (tid == 0) out_b[0] = 0;
  for (int j = 1; j < npoint; ++j) {
    const float* row = dm_b + static_cast<size_t>(last) * N;
    float d[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = tid + k * kThreads;
      d[k] = i < N ? __ldg(row + i) : 0.0f;
    }
    float best = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = tid + k * kThreads;
      if (i < N) {
        const float m = ((vbits >> k) & 1u) ? fminf(md[k], d[k]) : -1.0f;
        md[k] = m;
        if (m > best) {
          best = m;
          bi = i;
        }
      }
    }
    block_argmax(best, bi, red_key, red_idx, j & 1);
    last = bi;
    if (tid == 0) out_b[j] = last;
  }
}

template <int ITEMS>
cudaError_t launch(const float* dm, const uint8_t* valid, int* out, int B,
                   int N, int npoint, cudaStream_t stream) {
  matrix_fps_kernel<ITEMS><<<B, kThreads, 0, stream>>>(dm, valid, out, N,
                                                       npoint);
  return cudaGetLastError();
}

}  // namespace

// dm (B, N, N) fp32, valid (B, N) uint8, out (B, npoint) int32.
// 1 <= N <= 16384, npoint >= 1 (checked by the wrapper,
// ops/kernels/matrix_fps.py). Returns the CUDA error code.
extern "C" int de6d_matrix_fps(const void* dm, const void* valid, void* out,
                               int B, int N, int npoint, void* stream) {
  if (N < 1 || N > kMaxItems * kThreads || npoint < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(dm);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<int*>(out);
  cudaError_t err;
  if (N <= kThreads) {
    err = launch<1>(m, v, o, B, N, npoint, s);
  } else if (N <= 2 * kThreads) {
    err = launch<2>(m, v, o, B, N, npoint, s);
  } else if (N <= 4 * kThreads) {
    err = launch<4>(m, v, o, B, N, npoint, s);
  } else if (N <= 8 * kThreads) {
    err = launch<8>(m, v, o, B, N, npoint, s);
  } else {
    err = launch<kMaxItems>(m, v, o, B, N, npoint, s);
  }
  return static_cast<int>(err);
}
