// Batched fused greedy rotated-BEV NMS with a compacted kept list.
//
// Replaces the TPU kernel de6d_tpu/ops/pallas/nms_fused.py:nms_keep_batched
// (IoU tile nms_mask._green_tile). Input: per sample, P score-descending
// candidates packed as (9, P) fp32 rows [x of 4 corners; y of 4 corners;
// area], the first counts[b] valid. Output: keep (B, P) bytes, the greedy
// keep flags truncated at post_k: once a sample has post_k keeps, later
// 128-column blocks are all zero (exact for a caller that takes the first
// post_k keeps, NMS_POST_MAXSIZE).
//
// What bounds it: fp32 operations, 547 per IoU (two Green's-theorem
// passes of 4 edges x 4 Liang-Barsky clips; counted in
// ops/kernels/nms_fused.py:FLOPS_PER_IOU). The work depends on the
// data: per column block, (kept so far) x (live columns) IoUs against
// the kept list plus the live pairs of the diagonal tile. Design:
//   * one block of 128 threads per sample walks its column blocks in
//     order (the TPU grid's sequential axis becomes this loop), so only
//     B SMs are busy -- spreading a sample over several blocks is later
//     work;
//   * thread t owns column col0 + t: it tests the column against the
//     compacted kept boxes in shared memory (9 floats each, broadcast
//     reads) and stops at the first suppressor;
//   * the diagonal 128 x 128 tile is computed for live pairs only and
//     stored as one 128-bit suppressor mask per column; live columns are
//     gathered with warp ballots, and thread 0 resolves the recurrence
//     in column order on those bits;
//   * kept columns append themselves to the kept list at nk + (kept
//     lanes below them) -- one spare block of room beyond post_k.
// The IoU is csrc/iou_bev.cuh (ops/iou3d.py's arithmetic, operation by
// operation, no FMA), so it rounds exactly like the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "iou_bev.cuh"

namespace {

using de6d::iou_pair;
using de6d::Quad;

constexpr int kBlk = 128;
constexpr int kWords = kBlk / 32;
constexpr int kRows = 9;

__global__ void __launch_bounds__(kBlk)
nms_fused_kernel(const float* __restrict__ packed,
                 const int* __restrict__ counts, uint8_t* __restrict__ keep,
                 int P, float thresh, int post_k, int k_cap) {
  extern __shared__ float kept[];  // (kRows, k_cap) compacted kept boxes
  __shared__ float diag[kRows][kBlk];
  __shared__ uint32_t supmask[kBlk][kWords];  // bit r: row r suppresses t
  __shared__ uint32_t live_bits[kWords];
  __shared__ uint32_t keep_bits[kWords];
  __shared__ int s_nk;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int count = min(counts[b], P);
  const float* pk = packed + static_cast<size_t>(b) * kRows * P;
  uint8_t* keep_b = keep + static_cast<size_t>(b) * P;
  if (t == 0) s_nk = 0;
  __syncthreads();

  for (int col0 = 0; col0 < P; col0 += kBlk) {
    const int nk = s_nk;
    if (!(col0 < count && nk < post_k)) {
      // nothing later can be needed: the rest of the sample is zero
      for (int i = col0 + t; i < P; i += kBlk) keep_b[i] = 0;
      break;
    }
    const int col = col0 + t;
    Quad mine;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mine.x[i] = pk[i * P + col];
      mine.y[i] = pk[(4 + i) * P + col];
    }
    const float area = pk[8 * P + col];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      diag[i][t] = mine.x[i];
      diag[4 + i][t] = mine.y[i];
    }
    diag[8][t] = area;

    // 1) suppression from the kept list
    bool live = col < count;
    for (int i = 0; live && i < nk; ++i) {
      Quad r;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        r.x[k] = kept[k * k_cap + i];
        r.y[k] = kept[(4 + k) * k_cap + i];
      }
      if (iou_pair(r, kept[8 * k_cap + i], mine, area) > thresh) live = false;
    }
    const uint32_t ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) live_bits[warp] = ballot;
    __syncthreads();

    // 2) the diagonal tile, live pairs r < t only
    uint32_t m[kWords] = {0u, 0u, 0u, 0u};
    if (live) {
      for (int r = 0; r < t; ++r) {
        if (!((live_bits[r >> 5] >> (r & 31)) & 1u)) continue;
        Quad q;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          q.x[k] = diag[k][r];
          q.y[k] = diag[4 + k][r];
        }
        if (iou_pair(q, diag[8][r], mine, area) > thresh) {
          m[r >> 5] |= 1u << (r & 31);
        }
      }
    }
#pragma unroll
    for (int w = 0; w < kWords; ++w) supmask[t][w] = m[w];
    __syncthreads();

    // 3) resolve the intra-block recurrence in column order
    if (t == 0) {
      uint32_t kb[kWords] = {0u, 0u, 0u, 0u};
      for (int c = 0; c < kBlk; ++c) {
        if (!((live_bits[c >> 5] >> (c & 31)) & 1u)) continue;
        uint32_t hit = 0u;
#pragma unroll
        for (int w = 0; w < kWords; ++w) hit |= supmask[c][w] & kb[w];
        if (!hit) kb[c >> 5] |= 1u << (c & 31);
      }
#pragma unroll
      for (int w = 0; w < kWords; ++w) keep_bits[w] = kb[w];
    }
    __syncthreads();

    // 4) write the flags; kept columns append to the kept list
    const bool k = (keep_bits[warp] >> lane) & 1u;
    keep_b[col] = k ? 1 : 0;
    if (k) {
      int pos = nk + __popc(keep_bits[warp] & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) pos += __popc(keep_bits[w]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kept[i * k_cap + pos] = mine.x[i];
        kept[(4 + i) * k_cap + pos] = mine.y[i];
      }
      kept[8 * k_cap + pos] = area;
    }
    __syncthreads();
    if (t == 0) {
      int added = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) added += __popc(keep_bits[w]);
      s_nk = nk + added;
    }
    __syncthreads();
  }
}

}  // namespace

// packed (B, 9, P) fp32, counts (B,) int32, keep (B, P) uint8.
// P % 128 == 0; k_cap >= ceil(post_k / 128) * 128 + 128 (checked by the
// wrapper, ops/kernels/nms_fused.py). Returns the CUDA error code.
extern "C" int de6d_nms_keep_batched(const void* packed, const void* counts,
                                     void* keep, int B, int P, float thresh,
                                     int post_k, int k_cap, void* stream) {
  const int dyn = static_cast<int>(sizeof(float)) * kRows * k_cap;
  cudaError_t err = cudaFuncSetAttribute(
      nms_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_fused_kernel<<<B, kBlk, dyn, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<const int*>(counts),
      static_cast<uint8_t*>(keep), P, thresh, post_k, k_cap);
  return static_cast<int>(cudaGetLastError());
}
