// Pairwise rotated-BEV-IoU suppression mask for greedy NMS, as a bit mask,
// and the sequential greedy resolve that reads it.
//
// Replaces the TPU kernel de6d_tpu/ops/pallas/nms_mask.py:
// nms_suppression_mask (an fp32 (P, P) 0/1 array written through
// (128, 256) VMEM tiles). Input: per sample, P score-descending candidates
// packed as (9, P) fp32 rows [x of 4 corners; y of 4 corners; area], the
// first counts[b] live. Output: mask (B, P, W) 64-bit words, W =
// ceil(P / 64); bit (j % 64) of word (i, j / 64) is IoU_bev(i, j) > thresh
// for every pair i < j < counts[b], and every other bit is 0 (rows and
// columns past the count, the diagonal and everything below it).
//
// What bounds it: fp32 operations, 547 per IoU (csrc/iou_bev.cuh), for
// count * (count - 1) / 2 IoUs per sample; the mask's bytes (P * W * 8 per
// sample, each written once) are two orders of magnitude below that.
// Design:
//   * the dense fp32 array becomes the bit mask of the reference
//     implementation's NMS: 32x fewer bytes than one float per pair;
//   * one block of 64 threads per (64-row, 64-column) tile and sample:
//     the column tile's corners sit in shared memory (broadcast reads),
//     thread t owns row row0 + t in registers and builds that row's word;
//   * tiles below the diagonal or past the live count write zero words
//     and compute nothing (the TPU kernel's tile skip); inside a needed
//     tile only pairs with row < column < count are evaluated, so the
//     whole output is defined.
// The IoU is the device function of nms_fused.cu (no FMA), so every bit
// equals the plain PyTorch version's.
//
// nms_resolve_kernel is not a port of a TPU kernel (the JAX package
// resolves the recurrence with XLA sweeps); it is the reference
// implementation's host loop moved onto the card: one block per sample
// walks the candidates in score order with the removed set in shared
// memory, ORs in the mask row of every kept candidate, and stops after
// `post` keeps. Bound by latency: at most `post` dependent steps of one
// W-word row read each.

#include <cuda_runtime.h>
#include <stdint.h>

#include "iou_bev.cuh"

namespace {

using de6d::iou_pair;
using de6d::Quad;

constexpr int kTile = 64;
constexpr int kRows = 9;
constexpr int kResolveThreads = 256;

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float* __restrict__ packed,
                const int* __restrict__ counts,
                unsigned long long* __restrict__ mask, int P, int W,
                float thresh) {
  __shared__ float cols[kRows][kTile];
  const int ct = blockIdx.x;
  const int rt = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int count = max(0, min(counts[b], P));
  const int row0 = rt * kTile;
  const int col0 = ct * kTile;
  const int row = row0 + t;
  unsigned long long word = 0ull;
  // block-uniform: the tile holds some pair with row < column < count
  if (rt <= ct && col0 < count && row0 < count) {
    const float* pk = packed + static_cast<size_t>(b) * kRows * P;
    const int col = col0 + t;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      cols[i][t] = col < P ? pk[i * P + col] : 0.f;
    }
    __syncthreads();
    if (row < count) {
      Quad mine;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mine.x[i] = pk[i * P + row];
        mine.y[i] = pk[(4 + i) * P + row];
      }
      const float area = pk[8 * P + row];
      const int j_end = min(kTile, count - col0);
      for (int j = (rt == ct) ? t + 1 : 0; j < j_end; ++j) {
        Quad q;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          q.x[i] = cols[i][j];
          q.y[i] = cols[4 + i][j];
        }
        if (iou_pair(mine, area, q, cols[8][j]) > thresh) word |= 1ull << j;
      }
    }
  }
  if (row < P) mask[(static_cast<size_t>(b) * P + row) * W + ct] = word;
}

__global__ void __launch_bounds__(kResolveThreads)
nms_resolve_kernel(const unsigned long long* __restrict__ mask,
                   const int* __restrict__ counts, int* __restrict__ sel,
                   int* __restrict__ nsel, int P, int W, int post) {
  extern __shared__ unsigned long long removed[];  // W words
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int count = max(0, min(counts[b], P));
  int* sel_b = sel + static_cast<size_t>(b) * post;
  for (int k = tid; k < W; k += kResolveThreads) removed[k] = 0ull;
  for (int k = tid; k < post; k += kResolveThreads) sel_b[k] = 0;
  __syncthreads();

  int nk = 0;
  const int n_words = (count + kTile - 1) / kTile;
  for (int w = 0; w < n_words && nk < post; ++w) {
    const int left = count - w * kTile;
    const unsigned long long live = left >= kTile ? ~0ull : (1ull << left) - 1ull;
    unsigned long long done = 0ull;  // bits of this word already walked
    while (nk < post) {
      // every thread reads the same word: the branch is block-uniform
      const unsigned long long cand = ~removed[w] & live & ~done;
      if (cand == 0ull) break;
      const int bit = __ffsll(static_cast<long long>(cand)) - 1;
      const int i = w * kTile + bit;
      done |= bit == kTile - 1 ? ~0ull : (2ull << bit) - 1ull;
      if (tid == 0) sel_b[nk] = i;
      ++nk;
      __syncthreads();  // removed[w] was read by all before it changes
      const unsigned long long* row =
          mask + (static_cast<size_t>(b) * P + i) * W;
      for (int k = w + tid; k < W; k += kResolveThreads) removed[k] |= row[k];
      __syncthreads();
    }
  }
  if (tid == 0) nsel[b] = nk;
}

}  // namespace

// packed (B, 9, P) fp32, counts (B,) int32, mask (B, P, ceil(P / 64)) 64-bit
// words. B, P >= 1 and ceil(P / 64), B <= 65535 (checked by the wrapper,
// ops/kernels/nms_mask.py). Returns the CUDA error code.
extern "C" int de6d_nms_mask(const void* packed, const void* counts,
                             void* mask, int B, int P, float thresh,
                             void* stream) {
  const int W = (P + kTile - 1) / kTile;
  const dim3 grid(W, W, B);
  nms_mask_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<const int*>(counts),
      static_cast<unsigned long long*>(mask), P, W, thresh);
  return static_cast<int>(cudaGetLastError());
}

// mask as de6d_nms_mask writes it, counts (B,) int32 -> sel (B, post) int32
// (the first `post` kept candidates in score order, padded with 0) and
// nsel (B,) int32 (how many). Returns the CUDA error code.
extern "C" int de6d_nms_resolve(const void* mask, const void* counts,
                                void* sel, void* nsel, int B, int P, int post,
                                void* stream) {
  const int W = (P + kTile - 1) / kTile;
  const int dyn = static_cast<int>(sizeof(unsigned long long)) * W;
  cudaError_t err = cudaFuncSetAttribute(
      nms_resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_resolve_kernel<<<B, kResolveThreads, dyn,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const int*>(counts), static_cast<int*>(sel),
      static_cast<int*>(nsel), P, W, post);
  return static_cast<int>(cudaGetLastError());
}
