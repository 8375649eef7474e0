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
// What bounds it: fp32 operations, 547 per IoU (csrc/iou_bev.cuh), for the
// pairs whose bit is not known to be 0 beforehand, plus a cheap pre-test
// (11 operations, ops/kernels/nms_mask.py:PRETEST_FLOPS) for each of the
// count * (count - 1) / 2 live pairs. The
// mask's bytes (P * W * 8 per sample, written once) are far below that.
// The first version ran the full IoU on every live pair, a thread walking
// 64 columns serially in 64-thread blocks over a W x W grid; at 8 x 9000
// nearly all of its 324 M IoUs were between boxes metres apart. Design:
//   * the mask is zeroed by one cudaMemsetAsync; only blocks whose tile
//     holds a live pair on or above the diagonal do any work;
//   * a block of 256 threads takes 64 rows x 256 columns (4 words per
//     row). It stages both sides' corners in shared memory and every box's
//     BEV bounds, then pre-tests all its live pairs (thread t owns column
//     t, rows are broadcast reads), ballots the survivors into a compact
//     list per warp in shared memory, and then all 256 threads take the
//     surviving pairs one each: iou_pair, and atomicOr of the bit into a
//     shared 64 x 4-word tile, written out at the end. Lanes stay busy
//     however the survivors are spread over the tile;
//   * the IoU is iou_bev.cuh:iou_pair, unchanged (no FMA), so every bit
//     equals the plain PyTorch version's.
//
// The pre-test and the argument that it skips only bits that are 0 are
// in nms_pretest.cuh, shared with nms_fused.cu.
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

#include "func_attr.cuh"
#include "iou_bev.cuh"
#include "nms_pretest.cuh"

namespace {

using de6d::Bounds;
using de6d::iou_pair;
using de6d::kMinThresh;
using de6d::Quad;
using de6d::skippable;

constexpr int kTile = 64;      // rows per block, bits per word
constexpr int kColWords = 4;   // words (64-column tiles) per block
constexpr int kCols = kTile * kColWords;
constexpr int kMaskThreads = kCols;  // thread t owns column t
constexpr int kRows = 9;
constexpr int kResolveThreads = 256;

// BEV bounds of packed box k of a (9, n) shared-memory block.
template <int N>
__device__ __forceinline__ Bounds box_bounds_at(const float (*v)[N], int k) {
  Quad q;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    q.x[e] = v[e][k];
    q.y[e] = v[4 + e][k];
  }
  return de6d::box_bounds(q, v[8][k]);
}

__global__ void __launch_bounds__(kMaskThreads, 3)
nms_mask_kernel(const float* __restrict__ packed,
                const int* __restrict__ counts,
                unsigned long long* __restrict__ mask, int P, int W,
                float thresh) {
  __shared__ float rows[kRows][kTile];
  __shared__ float cols[kRows][kCols];
  __shared__ Bounds row_b[kTile];
  __shared__ unsigned long long words[kTile][kColWords];
  // survivors, (row << 8) | column: warp w's in [w * 64 * 32, ...)
  __shared__ uint16_t pairs[kTile * kCols];
  __shared__ int n_warp[kMaskThreads / 32];
  const int rt = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int count = max(0, min(counts[b], P));
  const int row0 = rt * kTile;
  const int col0 = g * kCols;
  // block-uniform: the tile holds some pair with row < column < count
  if (row0 >= count || col0 >= count || row0 >= col0 + kCols) return;
  const float* pk = packed + static_cast<size_t>(b) * kRows * P;
  const int col = col0 + t;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    cols[i][t] = col < P ? pk[i * P + col] : 0.f;
    if (t < kTile) rows[i][t] = row0 + t < P ? pk[i * P + row0 + t] : 0.f;
  }
  words[t / kColWords][t % kColWords] = 0ull;
  __syncthreads();
  if (t < kTile) row_b[t] = box_bounds_at<kTile>(rows, t);
  const Bounds mine = box_bounds_at<kCols>(cols, t);
  const bool pretest = thresh >= kMinThresh;
  __syncthreads();

  const int lane = t & 31;
  const int warp = t >> 5;
  const int r_end = min(kTile, count - row0);
  uint16_t* mine_pairs = pairs + warp * kTile * 32;
  int n_mine = 0;  // warp-uniform
  for (int r = 0; r < r_end; ++r) {
    const bool live = row0 + r < col && col < count;
    const bool survive = live && !(pretest && skippable(row_b[r], mine));
    const unsigned ballot = __ballot_sync(0xffffffffu, survive);
    if (survive) {
      mine_pairs[n_mine + __popc(ballot & ((1u << lane) - 1u))] =
          static_cast<uint16_t>((r << 8) | t);
    }
    n_mine += __popc(ballot);
  }
  if (lane == 0) n_warp[warp] = n_mine;
  __syncthreads();
  int n = 0;
  for (int k = 0; k < kMaskThreads / 32; ++k) n += n_warp[k];
  for (int e = t; e < n; e += kMaskThreads) {
    int k = 0, off = e;  // the e-th survivor: warp k's off-th
    while (off >= n_warp[k]) off -= n_warp[k++];
    const uint16_t pair = pairs[k * kTile * 32 + off];
    const int r = pair >> 8;
    const int c = pair & (kCols - 1);
    Quad q_r, q_c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q_r.x[i] = rows[i][r];
      q_r.y[i] = rows[4 + i][r];
      q_c.x[i] = cols[i][c];
      q_c.y[i] = cols[4 + i][c];
    }
    if (iou_pair(q_r, rows[8][r], q_c, cols[8][c]) > thresh) {
      atomicOr(&words[r][c / kTile], 1ull << (c % kTile));
    }
  }
  __syncthreads();
  const int r = t / kColWords;
  const int w = g * kColWords + t % kColWords;
  if (row0 + r < P && w < W) {
    mask[(static_cast<size_t>(b) * P + row0 + r) * W + w] =
        words[r][t % kColWords];
  }
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
// words. B <= 65535, P >= 1 (checked by the wrapper, ops/kernels/
// nms_mask.py). Returns the CUDA error code.
extern "C" int de6d_nms_mask(const void* packed, const void* counts,
                             void* mask, int B, int P, float thresh,
                             void* stream) {
  const int W = (P + kTile - 1) / kTile;
  const int groups = (P + kCols - 1) / kCols;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      mask, 0, sizeof(unsigned long long) * static_cast<size_t>(B) * P * W, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(W, groups, B);
  nms_mask_kernel<<<grid, kMaskThreads, 0, s>>>(
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
  cudaError_t err = de6d::max_dynamic_smem(nms_resolve_kernel, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_resolve_kernel<<<B, kResolveThreads, dyn,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const int*>(counts), static_cast<int*>(sel),
      static_cast<int*>(nsel), P, W, post);
  return static_cast<int>(cudaGetLastError());
}
