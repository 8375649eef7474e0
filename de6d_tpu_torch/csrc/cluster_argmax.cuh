// The per-pick argmax exchange of the farthest-point-sampling kernels
// (fps.cu, matrix_fps.cu): a thread-block cluster of C CTAs per sample,
// or one CTA, finds the first maximum of the sample's keys once per pick.
//
//   * The argmax is one ordered 64-bit word: the order-preserving uint
//     image of the fp32 key (-0.0 canonicalised to +0.0) in the high word,
//     16383 - index in the low word, so the maximum word is the first
//     maximum whatever thread, warp or CTA held it. A warp reduces with two
//     redux.sync (__reduce_max_sync: the high word, then the low word
//     among the lanes that hold it).
//   * The warps' winners meet in shared memory (one __syncthreads); with a
//     cluster, warp 0 reduces them and sends the CTA's winner by st.async
//     (an 8-byte DSMEM store that completes transaction bytes on the
//     receiver's mbarrier) into slot `rank` of a double-buffered slot
//     array in every CTA of the cluster; each CTA waits on its own barrier
//     for its C messages (no cluster barrier, no fence).
//   * An optional hook sees the CTA's own winner while the messages are in
//     flight (matrix_fps.cu prefetches that winner's matrix row into L2).
// Why not simpler exchanges: fps.cu's head gives the measured floors.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "func_attr.cuh"

namespace de6d {

using ull = unsigned long long;

constexpr int kMaxN = 16384;
constexpr int kMaxCluster = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kIdxMask = kMaxN - 1;  // index < kMaxN = 2^14

__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(__fadd_rn(f, 0.0f));  // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// `okey` 0 is below every real key (a warp without points sends it)
__device__ __forceinline__ ull message(unsigned okey, int idx) {
  return (static_cast<ull>(okey) << 32) |
         (kIdxMask - static_cast<unsigned>(idx));
}

__device__ __forceinline__ int message_index(ull m) {
  return static_cast<int>(kIdxMask - (static_cast<unsigned>(m) & kIdxMask));
}

__device__ __forceinline__ ull warp_max(ull m) {
  const unsigned hi = static_cast<unsigned>(m >> 32);
  const unsigned lo = static_cast<unsigned>(m);
  const unsigned mhi = __reduce_max_sync(kFull, hi);
  const unsigned mlo = __reduce_max_sync(kFull, hi == mhi ? lo : 0u);
  return (static_cast<ull>(mhi) << 32) | mlo;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Double-buffered message slots: one per warp of the CTA, one per CTA of
// the cluster, and (cluster launches) one transaction barrier per buffer.
struct Slots {
  ull warp_msg[2][32];
  ull cta_msg[2][kMaxCluster];
  ull bar[2];
};

// Before the pick loop: the barriers exist in every CTA of the cluster
// before any CTA stores into another.
template <bool CLUSTER>
__device__ __forceinline__ void init_slots(Slots& s) {
  if constexpr (CLUSTER) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&s.bar[0])) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&s.bar[1])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();
  if constexpr (CLUSTER) cluster_barrier();
}

// After the pick loop: no CTA leaves while another may still address it.
template <bool CLUSTER>
__device__ __forceinline__ void finish_slots() {
  if constexpr (CLUSTER) cluster_barrier();
}

// The waiting threads read only the slot that the phase's transaction
// wrote, so the default (CTA-scope) acquire is enough.
__device__ __forceinline__ void wait_parity(unsigned bar, unsigned parity) {
  for (unsigned spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spin > (1u << 26)) __trap();  // a lost message: fail, do not hang
  }
}

// The largest of the first `n` slots, in every lane of the warp.
__device__ __forceinline__ ull slots_max(const ull* slots, int n) {
  const int lane = threadIdx.x & 31;
  return warp_max(lane < n ? slots[lane] : 0ull);
}

// No hook: the CTA's winner is reduced by warp 0 alone.
struct NoHook {
  static constexpr bool kActive = false;
  __device__ __forceinline__ void operator()(ull) const {}
};

// Every thread of every CTA of the cluster returns the winning message of
// pick `seq` (buffers seq & 1), given its own best message; `phase` holds
// the parity each buffer's barrier waits for next.
//   The warps' winners meet in the CTA's warp slots (one __syncthreads).
//   With CLUSTER, warp 0 reduces them and its lanes r < C send the CTA's
//   winner by st.async into CTA slot `rank` of CTA r; every CTA waits on
//   its own barrier for its C messages. A CTA slot of buffer b is stored
//   into again two picks later, only after the storing CTA has received
//   this CTA's message of the pick between, which this CTA sends after the
//   __syncthreads that every one of its warps reaches after reading
//   buffer b. An active hook is called by every thread with the CTA's
//   winner after the send and before the wait (the other warps reduce
//   the warp slots themselves for it).
template <int T, bool CLUSTER, typename Hook = NoHook>
__device__ __forceinline__ ull exchange(Slots& s, ull m, int seq,
                                        unsigned& phase, int C, int rank,
                                        const Hook& hook = Hook()) {
  constexpr int kWarps = T / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int buf = seq & 1;
  m = warp_max(m);
  if (lane == 0) s.warp_msg[buf][warp] = m;
  __syncthreads();
  if constexpr (!CLUSTER) {
    return slots_max(s.warp_msg[buf], kWarps);
  } else {
    const unsigned bar = smem_addr(&s.bar[buf]);
    if (warp == 0) {
      m = slots_max(s.warp_msg[buf], kWarps);
      if (lane == 0) {
        asm volatile(
            "{\n .reg .b64 st;\n"
            " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}"
            :: "r"(bar), "r"(C * static_cast<int>(sizeof(ull)))
            : "memory");
      }
      if (lane < C) {
        unsigned slot, remote_bar;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                     : "=r"(slot)
                     : "r"(smem_addr(&s.cta_msg[buf][rank])), "r"(lane));
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                     : "=r"(remote_bar) : "r"(bar), "r"(lane));
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 "
            "[%0], %1, [%2];" :: "r"(slot), "l"(m), "r"(remote_bar)
            : "memory");
      }
    }
    if constexpr (Hook::kActive) {
      hook(warp == 0 ? m : slots_max(s.warp_msg[buf], kWarps));
    }
    wait_parity(bar, (phase >> buf) & 1u);
    phase ^= 1u << buf;
    return slots_max(s.cta_msg[buf], C);
  }
}

// Host side: the launch configuration of B clusters of C CTAs of T
// threads with `dyn` bytes of dynamic shared memory (a plain launch for
// C = 1); sets the kernel's attributes (once per device, func_attr.cuh)
// and reports their error in *err.
template <typename Kernel>
inline cudaLaunchConfig_t launch_config(Kernel kernel, int B, int C, int T,
                                        int dyn, cudaStream_t stream,
                                        cudaLaunchAttribute* attr,
                                        cudaError_t* err) {
  *err = max_dynamic_smem(kernel, dyn);
  if (*err == cudaSuccess && C > 8) {
    *err = cached_func_attribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C, 1, 1);
  cfg.blockDim = dim3(T, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;  // one CTA per sample: a plain launch
  return cfg;
}

}  // namespace de6d
