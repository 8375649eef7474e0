// Sorted-table key lookup for the sparse voxel backbone: for every query
// key, its row in the sample's ascending key table and whether it is there.
//
// Replaces the TPU kernel de6d_tpu/ops/pallas/lookup.py:lookup_pallas (a
// bucket-head compare plus a one-hot MXU bucket fetch of hi/lo 16-bit key
// halves, V <= 16384), which exists because the TPU's vector unit cannot
// index its memory per lane. Contract (de6d_tpu/ops/sparse.py:lookup):
//   hit[q] <=> query[q] != INT32_MAX and query[q] is in table[b];
//   then table[b][idx[q]] == query[q].
// On a miss this kernel writes min(lower_bound, V - 1), the index that
// torch.searchsorted gives, so the plain version is matched everywhere.
//
// Bound: bytes. Every query is read once and (idx, hit) written once, 9
// bytes a query (~31 MB for a batch of 8 x 432,000 queries, ~9 us at
// 3.35 TB/s); the table is read once per block from L2. Design:
//   * a block takes kPerBlock consecutive queries of one sample
//     (blockIdx.y = sample), so one launch covers the whole batch;
//   * the block stages its sample's table (at most 64 KB on the SECOND
//     path) in dynamic shared memory, and each thread binary-searches its
//     queries there: log2(V) dependent shared-memory reads per query;
//   * a table larger than kMaxSharedKeys is searched in global memory
//     through the read-only cache by the same code (no size cap).

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 512;
constexpr int kPerThread = 8;
constexpr int kPerBlock = kThreads * kPerThread;  // queries per block
// 224 KB of the 227 KB a block may use
constexpr int kMaxSharedKeys = 224 * 1024 / 4;
constexpr int kInvalid = INT_MAX;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
lookup_kernel(const int* __restrict__ table, const int* __restrict__ queries,
              int* __restrict__ idx, uint8_t* __restrict__ hit, int V,
              int Q) {
  extern __shared__ int smem_table[];
  const int b = blockIdx.y;
  const int* tab = table + static_cast<size_t>(b) * V;
  if (kShared) {
    for (int i = threadIdx.x; i < V; i += kThreads) {
      smem_table[i] = __ldg(tab + i);
    }
    __syncthreads();
  }
  const size_t base = static_cast<size_t>(b) * Q;
  const int q0 = blockIdx.x * kPerBlock;
  const int q1 = min(Q, q0 + kPerBlock);
  for (int i = q0 + threadIdx.x; i < q1; i += kThreads) {
    const int key = __ldg(queries + base + i);
    int lo = 0, hi = V;  // first position whose key is >= `key`
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int t = kShared ? smem_table[mid] : __ldg(tab + mid);
      if (t < key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    bool found = false;
    if (lo < V && key != kInvalid) {
      found = (kShared ? smem_table[lo] : __ldg(tab + lo)) == key;
    }
    idx[base + i] = min(lo, V - 1);
    hit[base + i] = found ? 1 : 0;
  }
}

}  // namespace

// table (B, V) int32 ascending per row, queries (B, Q) int32 -> idx (B, Q)
// int32, hit (B, Q) uint8. V >= 1. Returns a cudaError_t.
extern "C" int de6d_lookup(const void* table, const void* queries, void* idx,
                           void* hit, int B, int V, int Q, void* stream) {
  if (V < 1 || Q < 0 || B < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Q == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const int*>(table);
  const auto* q = static_cast<const int*>(queries);
  auto* o = static_cast<int*>(idx);
  auto* h = static_cast<uint8_t*>(hit);
  const dim3 grid((Q + kPerBlock - 1) / kPerBlock, B);
  if (V <= kMaxSharedKeys) {
    const size_t smem = static_cast<size_t>(V) * sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(
        lookup_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    lookup_kernel<true><<<grid, kThreads, smem, s>>>(t, q, o, h, V, Q);
  } else {
    lookup_kernel<false><<<grid, kThreads, 0, s>>>(t, q, o, h, V, Q);
  }
  return static_cast<int>(cudaGetLastError());
}
