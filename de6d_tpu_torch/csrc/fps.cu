// Farthest-point sampling, plain (d-fps) and weighted (s-fps): a cluster
// of C thread blocks per sample runs the whole sequential pick loop, each
// block on its own slice of the points, the points in registers.
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
// Bound: the picks form a dependency chain, each step an argmax over the
// sample's N keys, so the kernel is held by the latency of one pick, not
// by its ~10-12 fp32 operations per point per pick. One 1024-thread block
// per sample uses 8 of 132 SMs at batch 8 and is issue-bound on its 16
// points per thread; spreading a sample over SMs makes the per-pick
// exchange between them the cost to minimise. Design:
//   * a thread-block cluster of C CTAs per sample (cudaLaunchKernelEx with
//     a cluster dimension; C = 16 needs the non-portable cluster size).
//     CTA rank r owns points [r * ppc, (r + 1) * ppc), ppc = ceil(N / C);
//     each thread keeps its ITEMS points' x, y, z, running minimum and
//     (s-fps) weight in registers. Every CTA also holds the whole sample's
//     xyz in shared memory (12 B a point, 192 KiB at N = 16384), so a
//     winner travels as its index alone;
//   * the per-pick argmax exchange is cluster_argmax.cuh (shared with
//     matrix_fps.cu): ordered 64-bit (key, 16383 - index) words, the warps'
//     winners met by one __syncthreads, each CTA's winner sent to every
//     CTA of the cluster as one 8-byte st.async counted by an mbarrier per
//     (double) buffer. The winner's x, y, z then come from the CTA's own
//     copy of the sample;
//   * one CTA per sample (C = 1) is a plain launch: warp slots and one
//     __syncthreads per pick.
// Why not simpler exchanges: on the H100 (chip_smoke.py's latency floors
// per pick at batch 8) a barrier.cluster arrive.release / wait.acquire
// per pick cost ~1.05 us (1.65 us at C = 16), every warp sending its own
// (key, x, y, z) cost 1.16 us, and polled slots that every warp wrote
// slowed the warps still computing distances; one CTA's round costs
// 0.16 us, the kept exchange ~0.4 us more.
// Dispatch (de6d_fps_dispatch; ops/kernels/fps.py says the same): one CTA
// per sample for N <= 2048 (8 points a thread); else C is the largest of
// 16, 8, 4, 2 that leaves every CTA at least kMinPointsPerCta = 512
// points, keeps B * C within the SM count and lets all B clusters be
// resident at once (cudaOccupancyMaxActiveClusters); otherwise the least
// C that fits the points in registers (1 for N <= 8192, else 2). Blocks
// have 256 threads while ppc <= 1024 (ITEMS 1-4), 512 up to 2048 (ITEMS
// 4), else 1024 (ITEMS 4, 8).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "block_argmax.cuh"
#include "cluster_argmax.cuh"

namespace {

using de6d::exchange;
using de6d::finish_slots;
using de6d::init_slots;
using de6d::launch_config;
using de6d::kMaxCluster;
using de6d::kMaxN;
using de6d::message;
using de6d::message_index;
using de6d::ordered;
using de6d::Slots;
using ull = de6d::ull;

constexpr float kInit = de6d::kInit;
constexpr int kMaxPpc = 8192;          // points per CTA: 1024 threads x 8
constexpr int kSingleCtaMaxN = 2048;    // one CTA, 8 points a thread
constexpr int kMinPointsPerCta = 512;   // fewer: the exchange dominates

template <int T, int ITEMS, bool WEIGHTED, bool CLUSTER>
__global__ void __launch_bounds__(T)
fps_cluster_kernel(const float* __restrict__ xyz,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ w, int* __restrict__ out, int N,
                   int npoint, int C) {
  __shared__ Slots slots;
  extern __shared__ float planes[];  // x[N], y[N], z[N] of the sample
  float* sx = planes;
  float* sy = planes + N;
  float* sz = planes + 2 * N;
  const int b = blockIdx.x / C;
  const int rank = blockIdx.x % C;  // the CTA's rank in its 1-D cluster
  const int tid = threadIdx.x;
  const int ppc = (N + C - 1) / C;
  const int base = rank * ppc;
  const float* xyz_b = xyz + static_cast<size_t>(b) * N * 3;
  const uint8_t* valid_b = valid + static_cast<size_t>(b) * N;
  int* out_b = out + static_cast<size_t>(b) * npoint;

  for (int i = tid; i < 3 * N; i += T) {
    planes[(i % 3) * N + i / 3] = __ldg(xyz_b + i);
  }
  // md: running minimum of a valid point, -1 for an invalid one, -inf for
  // a slot past the CTA's points (its key never wins)
  float px[ITEMS], py[ITEMS], pz[ITEMS], md[ITEMS];
  float wk[WEIGHTED ? ITEMS : 1];
  uint32_t vbits = 0u;
  float seed_key = -INFINITY;
  int seed = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int off = tid + k * T;
    const int i = base + off;
    px[k] = py[k] = pz[k] = 0.f;
    md[k] = -INFINITY;
    if constexpr (WEIGHTED) wk[k] = 1.0f;
    if (off < ppc && i < N) {
      px[k] = __ldg(xyz_b + 3 * i);
      py[k] = __ldg(xyz_b + 3 * i + 1);
      pz[k] = __ldg(xyz_b + 3 * i + 2);
      const bool v = valid_b[i] != 0;
      vbits |= static_cast<uint32_t>(v) << k;
      md[k] = v ? kInit : -1.0f;
      if constexpr (WEIGHTED) {
        const float wi = __ldg(w + static_cast<size_t>(b) * N + i);
        wk[k] = fmaxf(wi, 1e-12f);
        const float sk = v ? wi : -kInit;
        if (sk > seed_key) {  // items ascend in index: the first maximum
          seed_key = sk;
          seed = i;
        }
      }
    }
  }
  unsigned phase = 0u;
  init_slots<CLUSTER>(slots);  // also orders the planes' stores

  int last = 0;
  if constexpr (WEIGHTED) {
    const unsigned ok = seed_key == -INFINITY ? 0u : ordered(seed_key);
    last = message_index(exchange<T, CLUSTER>(slots, message(ok, seed), 0,
                                              phase, C, rank));
  }
  if (rank == 0 && tid == 0) out_b[0] = last;
  for (int j = 1; j < npoint; ++j) {
    const float lx = sx[last];
    const float ly = sy[last];
    const float lz = sz[last];
    // a thread's items ascend in index, so a strict '>' keeps the first
    float bk = -INFINITY;
    int bi = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const float dx = __fsub_rn(px[k], lx);
      const float dy = __fsub_rn(py[k], ly);
      const float dz = __fsub_rn(pz[k], lz);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float m = ((vbits >> k) & 1u) ? fminf(md[k], d) : md[k];
      md[k] = m;
      float key = m;
      if constexpr (WEIGHTED) key = m >= 0.0f ? __fmul_rn(m, wk[k]) : m;
      if (key > bk) {
        bk = key;
        bi = k;
      }
    }
    const unsigned ok = bk == -INFINITY ? 0u : ordered(bk);
    last = message_index(exchange<T, CLUSTER>(
        slots, message(ok, base + tid + bi * T), j, phase, C, rank));
    if (rank == 0 && tid == 0) out_b[j] = last;
  }
  finish_slots<CLUSTER>();
}

// The latency of the pick loop without its distance work: `rounds`
// rounds of the warp reduce and the exchange, each fed by a shared-memory
// read that depends on the previous winner (as the pick loop's distances
// depend on the previous winner's coordinates). Used only to measure the
// kernel's latency floor.
template <int T, bool CLUSTER>
__global__ void __launch_bounds__(T)
cluster_rounds_kernel(int rounds, int C, int* __restrict__ out) {
  __shared__ Slots slots;
  __shared__ float table[T];
  const int rank = blockIdx.x % C;
  table[threadIdx.x] = static_cast<float>((threadIdx.x * 7919u) & (T - 1));
  unsigned phase = 0u;
  init_slots<CLUSTER>(slots);
  int last = 0;
  for (int j = 0; j < rounds; ++j) {
    const float key = table[(threadIdx.x + last) & (T - 1)];
    const ull m =
        message(ordered(key), (rank * T + threadIdx.x) & de6d::kIdxMask);
    last = message_index(exchange<T, CLUSTER>(slots, m, j, phase, C, rank));
  }
  finish_slots<CLUSTER>();
  if (threadIdx.x == 0) out[blockIdx.x] = last;
}

// The first version's latency floor: `rounds` block-wide argmax rounds of
// block_argmax.cuh in one 1024-thread block per sample.
__global__ void __launch_bounds__(de6d::kThreads, 1)
argmax_rounds_kernel(int rounds, int* __restrict__ out) {
  using de6d::kThreads;
  using de6d::kWarps;
  __shared__ float table[kThreads];
  __shared__ float red_key[2][kWarps];
  __shared__ int red_idx[2][kWarps];
  table[threadIdx.x] = static_cast<float>((threadIdx.x * 7919u) & 1023u);
  __syncthreads();
  int last = 0;
  for (int j = 0; j < rounds; ++j) {
    float key = table[(threadIdx.x + last) & (kThreads - 1)];
    int idx = threadIdx.x;
    de6d::block_argmax(key, idx, red_key, red_idx, j & 1);
    last = idx;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = last;
}

// What one variant runs with: the kernel, its threads per block.
struct Variant {
  void (*kernel)(const float*, const uint8_t*, const float*, int*, int, int,
                 int);
  int threads;
};

template <bool WEIGHTED, bool CLUSTER>
Variant variant_of(int ppc) {
  if (ppc <= 256) return {fps_cluster_kernel<256, 1, WEIGHTED, CLUSTER>, 256};
  if (ppc <= 512) return {fps_cluster_kernel<256, 2, WEIGHTED, CLUSTER>, 256};
  if (ppc <= 1024) return {fps_cluster_kernel<256, 4, WEIGHTED, CLUSTER>, 256};
  if (ppc <= 2048) return {fps_cluster_kernel<512, 4, WEIGHTED, CLUSTER>, 512};
  if (ppc <= 4096) return {fps_cluster_kernel<1024, 4, WEIGHTED, CLUSTER>, 1024};
  return {fps_cluster_kernel<1024, 8, WEIGHTED, CLUSTER>, 1024};
}

Variant variant(int ppc, bool weighted, int C) {
  if (C > 1) {
    return weighted ? variant_of<true, true>(ppc) : variant_of<false, true>(ppc);
  }
  return weighted ? variant_of<true, false>(ppc) : variant_of<false, false>(ppc);
}

int ppc_of(int N, int C) { return (N + C - 1) / C; }

int planes_bytes(int N) { return static_cast<int>(sizeof(float)) * 3 * N; }

int least_cluster(int N) { return N <= kMaxPpc ? 1 : 2; }

bool valid_cluster(int N, int C) {
  return (C == 1 || C == 2 || C == 4 || C == 8 || C == 16) &&
         ppc_of(N, C) <= kMaxPpc;
}

// The dispatch rule (see the head of this file).
int choose_cluster(int B, int N, bool weighted) {
  if (N <= kSingleCtaMaxN) return 1;
  int sms = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    cudaGetLastError();
    return least_cluster(N);
  }
  for (int C = kMaxCluster; C > 1; C /= 2) {
    if (!valid_cluster(N, C) || ppc_of(N, C) < kMinPointsPerCta ||
        static_cast<long long>(B) * C > sms) {
      continue;
    }
    const Variant v = variant(ppc_of(N, C), weighted, C);
    cudaLaunchAttribute attr[1];
    cudaError_t err;
    cudaLaunchConfig_t cfg = launch_config(v.kernel, B, C, v.threads,
                                           planes_bytes(N), nullptr, attr,
                                           &err);
    int clusters = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveClusters(&clusters, v.kernel, &cfg);
    }
    if (err != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    if (clusters >= B) return C;
  }
  return least_cluster(N);
}

}  // namespace

// The cluster size de6d_fps takes for (B, N) when it is given 0.
extern "C" int de6d_fps_dispatch(int B, int N, int weighted) {
  if (N < 1 || N > kMaxN || B < 1) return -1;
  return choose_cluster(B, N, weighted != 0);
}

// xyz (B, N, 3) fp32, valid (B, N) uint8, w (B, N) fp32 or null (d-fps),
// out (B, npoint) int32. 1 <= N <= 16384, npoint >= 1 (checked by the
// wrapper, ops/kernels/fps.py). `cluster` is the number of CTAs per
// sample (1, 2, 4, 8 or 16, with ceil(N / cluster) <= 8192), or 0 for the
// dispatch rule. Returns the CUDA error code.
extern "C" int de6d_fps(const void* xyz, const void* valid, const void* w,
                        void* out, int B, int N, int npoint, int cluster,
                        void* stream) {
  if (N < 1 || N > kMaxN || npoint < 1 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool weighted = w != nullptr;
  const int C = cluster == 0 ? choose_cluster(B, N, weighted) : cluster;
  if (!valid_cluster(N, C)) return static_cast<int>(cudaErrorInvalidValue);
  const Variant v = variant(ppc_of(N, C), weighted, C);
  cudaLaunchAttribute attr[1];
  cudaError_t err;
  cudaLaunchConfig_t cfg = launch_config(
      v.kernel, B, C, v.threads, planes_bytes(N),
      static_cast<cudaStream_t>(stream), attr, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, v.kernel, static_cast<const float*>(xyz),
                           static_cast<const uint8_t*>(valid),
                           static_cast<const float*>(w),
                           static_cast<int*>(out), N, npoint, C);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// B clusters of C CTAs of `threads` (256 or 1024) threads, `rounds` empty
// pick rounds each: the latency floor of the de6d_fps variant with that
// cluster size and block size.
extern "C" int de6d_fps_cluster_rounds(int rounds, int B, int C, int threads,
                                       void* out, void* stream) {
  if (B < 1 || !(C == 1 || C == 2 || C == 4 || C == 8 || C == 16) ||
      (threads != 256 && threads != 512 && threads != 1024)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kernel)(int, int, int*) =
      C > 1 ? (threads == 256   ? cluster_rounds_kernel<256, true>
               : threads == 512 ? cluster_rounds_kernel<512, true>
                                : cluster_rounds_kernel<1024, true>)
            : (threads == 256   ? cluster_rounds_kernel<256, false>
               : threads == 512 ? cluster_rounds_kernel<512, false>
                                : cluster_rounds_kernel<1024, false>);
  cudaLaunchAttribute attr[1];
  cudaError_t err;
  cudaLaunchConfig_t cfg = launch_config(
      kernel, B, C, threads, 0, static_cast<cudaStream_t>(stream), attr,
      &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, rounds, C, static_cast<int*>(out));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The threads per block of the de6d_fps variant for (N, C).
extern "C" int de6d_fps_threads(int N, int C) {
  if (N < 1 || N > kMaxN || !valid_cluster(N, C)) return -1;
  const int ppc = ppc_of(N, C);
  return ppc <= 1024 ? 256 : ppc <= 2048 ? 512 : 1024;
}

// B blocks of `rounds` block-wide argmax rounds of block_argmax.cuh (the
// latency floor of the first, single-block FPS kernel).
extern "C" int de6d_fps_argmax_rounds(int rounds, int B, void* out,
                                      void* stream) {
  argmax_rounds_kernel<<<B, de6d::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      rounds, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
