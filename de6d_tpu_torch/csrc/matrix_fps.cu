// f-fps: farthest-point sampling over a precomputed (N, N) distance
// matrix; a thread-block cluster of C CTAs per sample runs the whole
// sequential pick loop, each CTA on its own slice of the columns.
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
// dependency chain, each step one row read from device memory (the SA2
// matrix, 537 MB, is ~10x the L2, so from HBM) that cannot start before
// the previous pick is known, then an argmax over the sample. The first
// kernel (one 1024-thread block per sample, 8 of 132 SMs) took 1.33 us a
// pick at SA2: the row's HBM latency plus a 1024-thread block argmax.
// Design:
//   * a cluster of C CTAs per sample (cudaLaunchKernelEx with a cluster
//     dimension; C = 16 needs the non-portable cluster size). CTA rank r
//     owns columns [r * ppc, (r + 1) * ppc), ppc = ceil(N / C); each thread
//     keeps its ITEMS running minima in registers and its valid flags in a
//     bit mask, and per pick reads its columns of row `last` straight into
//     registers (coalesced, all of a thread's loads in flight together);
//   * the argmax is cluster_argmax.cuh, shared with fps.cu: ordered 64-bit
//     (key, 16383 - index) words, one __syncthreads, each CTA's winner sent
//     to every CTA as one 8-byte st.async counted by an mbarrier. The
//     winner is an index and the next row's address follows from it, so
//     nothing but that word travels and shared memory holds only the slots
//     (C = 16 fits 8 samples, where fps.cu's xyz copy stops it);
//   * prefetch: while its message is in flight, each CTA of a cluster asks
//     for its own winner's whole row to be brought into L2
//     (prefetch.global.L2, one 128-byte line a thread). The next pick's row
//     is one of the C local winners' rows, so the dependent read that
//     follows the exchange hits L2 instead of HBM; the price is C rows of
//     HBM traffic a pick instead of one;
//   * one CTA per sample (C = 1) is a plain launch: warp slots and one
//     __syncthreads per pick, no prefetch (the winner is read at once).
// Dispatch (de6d_matrix_fps_dispatch; ops/kernels/matrix_fps.py says the
// same): one CTA per sample for N <= 1024; else C is the largest of 16, 8,
// 4, 2 that leaves every CTA at least kMinColsPerCta = 512 columns, keeps
// B * C within the SM count and lets all B clusters be resident at once
// (cudaOccupancyMaxActiveClusters); otherwise 1. On the H100 at SA2
// (8 x 4096 -> 512) C = 8 took 0.385 ms, C = 16 0.404 (each pick
// prefetches C rows: 16 of them, 2 MB a pick over the batch, cost more HBM
// time than they save), C = 4 0.431, one 1024-thread CTA 0.505; clusters
// without the prefetch took 0.50-0.60 ms at every size. Blocks have 256 threads while
// ppc <= 1024 (ITEMS 1, 2, 4), 512 up to 2048 (ITEMS 4), else 1024
// (ITEMS 4, 8, 16). N <= 16384.

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
using de6d::message;
using de6d::message_index;
using de6d::ordered;
using de6d::Slots;
using ull = de6d::ull;

constexpr float kInit = de6d::kInit;
constexpr int kMaxN = de6d::kMaxN;
constexpr int kMaxCluster = de6d::kMaxCluster;
constexpr int kSingleCtaMaxN = 1024;  // one CTA of 256 threads, 4 a thread
constexpr int kMinColsPerCta = 512;   // fewer: see the head

// The hook of a prefetching cluster: the CTA's winner's row into L2.
struct RowPrefetch {
  static constexpr bool kActive = true;
  const float* dm_b;
  int N;
  __device__ __forceinline__ void operator()(ull m) const {
    const uintptr_t row = reinterpret_cast<uintptr_t>(
        dm_b + static_cast<size_t>(message_index(m)) * N);
    const uintptr_t end = row + static_cast<uintptr_t>(N) * sizeof(float);
    for (uintptr_t a = (row & ~uintptr_t(127)) + threadIdx.x * 128u; a < end;
         a += blockDim.x * 128u) {
      asm volatile("prefetch.global.L2 [%0];" :: "l"(a));
    }
  }
};

template <int T, int ITEMS, bool CLUSTER>
__global__ void __launch_bounds__(T)
matrix_fps_kernel(const float* __restrict__ dm,
                  const uint8_t* __restrict__ valid, int* __restrict__ out,
                  int N, int npoint, int C) {
  __shared__ Slots slots;
  const int b = blockIdx.x / C;
  const int rank = blockIdx.x % C;  // the CTA's rank in its 1-D cluster
  const int tid = threadIdx.x;
  const int ppc = (N + C - 1) / C;
  const int base = rank * ppc;
  const float* dm_b = dm + static_cast<size_t>(b) * N * N;
  const uint8_t* valid_b = valid + static_cast<size_t>(b) * N;
  int* out_b = out + static_cast<size_t>(b) * npoint;

  // md: running minimum of a valid column, -1 for an invalid one, -inf for
  // a slot past the CTA's columns (its key never wins)
  float md[ITEMS];
  uint32_t vbits = 0u;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int off = tid + k * T;
    const int i = base + off;
    md[k] = -INFINITY;
    if (off < ppc && i < N) {
      const bool v = valid_b[i] != 0;
      vbits |= static_cast<uint32_t>(v) << k;
      md[k] = v ? kInit : -1.0f;
    }
  }
  unsigned phase = 0u;
  init_slots<CLUSTER>(slots);

  int last = 0;
  if (rank == 0 && tid == 0) out_b[0] = 0;
  for (int j = 1; j < npoint; ++j) {
    const float* row = dm_b + static_cast<size_t>(last) * N;
    float d[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int off = tid + k * T;
      const int i = base + off;
      d[k] = off < ppc && i < N ? __ldg(row + i) : 0.0f;
    }
    // a thread's columns ascend, so a strict '>' keeps the first maximum
    float bk = -INFINITY;
    int bi = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const float m = ((vbits >> k) & 1u) ? fminf(md[k], d[k]) : md[k];
      md[k] = m;
      if (m > bk) {
        bk = m;
        bi = k;
      }
    }
    const ull msg = message(bk == -INFINITY ? 0u : ordered(bk),
                            base + tid + bi * T);
    last = message_index(exchange<T, CLUSTER>(slots, msg, j, phase, C, rank,
                                              RowPrefetch{dm_b, N}));
    if (rank == 0 && tid == 0) out_b[j] = last;
  }
  finish_slots<CLUSTER>();
}

// What one variant runs with: the kernel, its threads per block.
struct Variant {
  void (*kernel)(const float*, const uint8_t*, int*, int, int, int);
  int threads;
};

template <bool CLUSTER>
Variant variant_of(int ppc) {
  if (ppc <= 256) return {matrix_fps_kernel<256, 1, CLUSTER>, 256};
  if (ppc <= 512) return {matrix_fps_kernel<256, 2, CLUSTER>, 256};
  if (ppc <= 1024) return {matrix_fps_kernel<256, 4, CLUSTER>, 256};
  if (ppc <= 2048) return {matrix_fps_kernel<512, 4, CLUSTER>, 512};
  if (ppc <= 4096) return {matrix_fps_kernel<1024, 4, CLUSTER>, 1024};
  if (ppc <= 8192) return {matrix_fps_kernel<1024, 8, CLUSTER>, 1024};
  return {matrix_fps_kernel<1024, 16, CLUSTER>, 1024};
}

Variant variant(int ppc, int C) {
  return C == 1 ? variant_of<false>(ppc) : variant_of<true>(ppc);
}

int ppc_of(int N, int C) { return (N + C - 1) / C; }

bool valid_cluster(int C) {
  return C == 1 || C == 2 || C == 4 || C == 8 || C == kMaxCluster;
}

// The dispatch rule (see the head of this file).
int choose_cluster(int B, int N) {
  if (N <= kSingleCtaMaxN) return 1;
  int sms = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    cudaGetLastError();
    return 1;
  }
  for (int C = kMaxCluster; C > 1; C /= 2) {
    if (ppc_of(N, C) < kMinColsPerCta ||
        static_cast<long long>(B) * C > sms) {
      continue;
    }
    const Variant v = variant(ppc_of(N, C), C);
    cudaLaunchAttribute attr[1];
    cudaError_t err;
    cudaLaunchConfig_t cfg =
        launch_config(v.kernel, B, C, v.threads, 0, nullptr, attr, &err);
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
  return 1;
}

}  // namespace

// The cluster size de6d_matrix_fps takes for (B, N) when it is given 0.
extern "C" int de6d_matrix_fps_dispatch(int B, int N) {
  if (N < 1 || N > kMaxN || B < 1) return -1;
  return choose_cluster(B, N);
}

// The threads per block of the de6d_matrix_fps variant for (N, C).
extern "C" int de6d_matrix_fps_threads(int N, int C) {
  if (N < 1 || N > kMaxN || !valid_cluster(C)) return -1;
  return variant(ppc_of(N, C), C).threads;
}

// dm (B, N, N) fp32, valid (B, N) uint8, out (B, npoint) int32.
// 1 <= N <= 16384, npoint >= 1 (checked by the wrapper,
// ops/kernels/matrix_fps.py). `cluster` is the number of CTAs per sample
// (1, 2, 4, 8 or 16), or 0 for the dispatch rule. Returns the CUDA error
// code.
extern "C" int de6d_matrix_fps(const void* dm, const void* valid, void* out,
                               int B, int N, int npoint, int cluster,
                               void* stream) {
  if (N < 1 || N > kMaxN || npoint < 1 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int C = cluster == 0 ? choose_cluster(B, N) : cluster;
  if (!valid_cluster(C)) return static_cast<int>(cudaErrorInvalidValue);
  const Variant v = variant(ppc_of(N, C), C);
  cudaLaunchAttribute attr[1];
  cudaError_t err;
  cudaLaunchConfig_t cfg =
      launch_config(v.kernel, B, C, v.threads, 0,
                    static_cast<cudaStream_t>(stream), attr, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, v.kernel, static_cast<const float*>(dm),
                           static_cast<const uint8_t*>(valid),
                           static_cast<int*>(out), N, npoint, C);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
