// Farthest-point sampling, plain (d-fps) and weighted (s-fps): one
// block of 1024 threads per sample runs the whole sequential pick loop.
//
// Replaces the TPU kernel de6d_tpu/ops/pallas/fps.py:fps_pallas (eight
// samples per grid step on the sublanes, every operand VMEM-resident).
// Semantics (oracle de6d_tpu/ops/sampling.py:_fps_loop):
//   d   = (dx*dx + dy*dy) + dz*dz          (no FMA: -fmad=false and _rn)
//   md  = valid ? min(md, d) : -1,  md0 = valid ? 1e10 : -1
//   key = md (d-fps) | md >= 0 ? md * max(w, 1e-12) : md (s-fps)
//   pick = first (lowest-index) argmax of key; seed 0 (d-fps) or the
//   first argmax of valid ? w : -1e10 (s-fps). Picks repeat once every
//   valid point is taken, as the reference's do.
//
// Bound: the picks form a dependency chain, each step a block-wide argmax
// over N keys, so the kernel is held by latency (one __syncthreads and two
// 5-step shuffle reductions per pick), not by its ~10-12 fp32 operations
// per point per pick. Design:
//   * xyz as three planes in shared memory (12 B/point, 192 KiB at
//     N = 16384, within the 227 KiB opt-in); the winner's coordinates are
//     broadcast reads from there;
//   * each thread keeps its ITEMS = ceil(N / 1024) running minima (and
//     weights) in registers; points i = tid + k * 1024, so a thread's
//     candidates ascend in index and a strict '>' keeps the first max;
//   * argmax per pick: block_argmax.cuh (shared with matrix_fps.cu): warp
//     shuffle over (key, idx), larger key first and lower index on equal
//     keys; warp winners go to a double-buffered shared slot, one barrier,
//     then every warp reduces the 32 winners itself (no second barrier:
//     the slot parity alternates per pick).
// Splitting one sample over a cluster of blocks (DSMEM) is left to a
// later change; on the main path 8 of 132 SMs are busy.

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

template <int ITEMS, bool WEIGHTED>
__global__ void __launch_bounds__(kThreads, 1)
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
           const float* __restrict__ w, int* __restrict__ out, int N,
           int npoint) {
  extern __shared__ float planes[];  // x[N], y[N], z[N]
  __shared__ float red_key[2][kWarps];
  __shared__ int red_idx[2][kWarps];
  float* sx = planes;
  float* sy = planes + N;
  float* sz = planes + 2 * N;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* xyz_b = xyz + static_cast<size_t>(b) * N * 3;
  const uint8_t* valid_b = valid + static_cast<size_t>(b) * N;
  int* out_b = out + static_cast<size_t>(b) * npoint;

  for (int i = tid; i < 3 * N; i += kThreads) {
    planes[(i % 3) * N + i / 3] = __ldg(xyz_b + i);
  }

  float md[ITEMS];
  float wk[WEIGHTED ? ITEMS : 1];
  uint32_t vbits = 0u;
  float seed_key = -INFINITY;
  int seed = WEIGHTED ? INT_MAX : 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = tid + k * kThreads;
    md[k] = -1.0f;
    if constexpr (WEIGHTED) wk[k] = 1.0f;
    if (i < N) {
      const bool v = valid_b[i] != 0;
      vbits |= static_cast<uint32_t>(v) << k;
      md[k] = v ? kInit : -1.0f;
      if constexpr (WEIGHTED) {
        const float wi = __ldg(w + static_cast<size_t>(b) * N + i);
        wk[k] = fmaxf(wi, 1e-12f);
        const float sk = v ? wi : -kInit;
        if (sk > seed_key) {
          seed_key = sk;
          seed = i;
        }
      }
    }
  }
  __syncthreads();  // planes are loaded
  if constexpr (WEIGHTED) block_argmax(seed_key, seed, red_key, red_idx, 0);

  int last = seed;
  if (tid == 0) out_b[0] = last;
  for (int j = 1; j < npoint; ++j) {
    const float lx = sx[last];
    const float ly = sy[last];
    const float lz = sz[last];
    float best = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = tid + k * kThreads;
      if (i < N) {
        const float dx = __fsub_rn(sx[i], lx);
        const float dy = __fsub_rn(sy[i], ly);
        const float dz = __fsub_rn(sz[i], lz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        const float m = ((vbits >> k) & 1u) ? fminf(md[k], d) : -1.0f;
        md[k] = m;
        float key = m;
        if constexpr (WEIGHTED) key = m >= 0.0f ? __fmul_rn(m, wk[k]) : m;
        if (key > best) {
          best = key;
          bi = i;
        }
      }
    }
    block_argmax(best, bi, red_key, red_idx, j & 1);
    last = bi;
    if (tid == 0) out_b[j] = last;
  }
}

// The latency of the pick loop without its distance work: `rounds`
// block-wide argmax rounds, each fed by a shared-memory read that
// depends on the previous winner (as the pick loop's coordinate read
// is). Used only to measure the kernel's latency floor.
__global__ void __launch_bounds__(kThreads, 1)
argmax_rounds_kernel(int rounds, int* __restrict__ out) {
  __shared__ float table[kThreads];
  __shared__ float red_key[2][kWarps];
  __shared__ int red_idx[2][kWarps];
  table[threadIdx.x] = static_cast<float>((threadIdx.x * 7919u) & 1023u);
  __syncthreads();
  int last = 0;
  for (int j = 0; j < rounds; ++j) {
    float key = table[(threadIdx.x + last) & (kThreads - 1)];
    int idx = threadIdx.x;
    block_argmax(key, idx, red_key, red_idx, j & 1);
    last = idx;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = last;
}

template <int ITEMS, bool WEIGHTED>
cudaError_t launch(const float* xyz, const uint8_t* valid, const float* w,
                   int* out, int B, int N, int npoint, cudaStream_t stream) {
  const int dyn = static_cast<int>(sizeof(float)) * 3 * N;
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<ITEMS, WEIGHTED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dyn);
  if (err != cudaSuccess) return err;
  fps_kernel<ITEMS, WEIGHTED><<<B, kThreads, dyn, stream>>>(xyz, valid, w, out,
                                                            N, npoint);
  return cudaGetLastError();
}

template <bool WEIGHTED>
cudaError_t dispatch(const float* xyz, const uint8_t* valid, const float* w,
                     int* out, int B, int N, int npoint, cudaStream_t stream) {
  if (N <= kThreads)
    return launch<1, WEIGHTED>(xyz, valid, w, out, B, N, npoint, stream);
  if (N <= 2 * kThreads)
    return launch<2, WEIGHTED>(xyz, valid, w, out, B, N, npoint, stream);
  if (N <= 4 * kThreads)
    return launch<4, WEIGHTED>(xyz, valid, w, out, B, N, npoint, stream);
  if (N <= 8 * kThreads)
    return launch<8, WEIGHTED>(xyz, valid, w, out, B, N, npoint, stream);
  return launch<kMaxItems, WEIGHTED>(xyz, valid, w, out, B, N, npoint, stream);
}

}  // namespace

// xyz (B, N, 3) fp32, valid (B, N) uint8, w (B, N) fp32 or null (d-fps),
// out (B, npoint) int32. 1 <= N <= 16384, npoint >= 1 (checked by the
// wrapper, ops/kernels/fps.py). Returns the CUDA error code.
extern "C" int de6d_fps(const void* xyz, const void* valid, const void* w,
                        void* out, int B, int N, int npoint, void* stream) {
  if (N < 1 || N > kMaxItems * kThreads || npoint < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(xyz);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<int*>(out);
  const cudaError_t err =
      w == nullptr
          ? dispatch<false>(x, v, nullptr, o, B, N, npoint, s)
          : dispatch<true>(x, v, static_cast<const float*>(w), o, B, N, npoint, s);
  return static_cast<int>(err);
}

// B blocks of `rounds` empty argmax rounds (latency floor of de6d_fps).
extern "C" int de6d_fps_argmax_rounds(int rounds, int B, void* out,
                                      void* stream) {
  argmax_rounds_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rounds, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
