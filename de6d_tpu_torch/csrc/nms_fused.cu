// Batched fused greedy rotated-BEV NMS with a compacted kept list.
//
// Replaces the TPU kernel de6d_tpu/ops/pallas/nms_fused.py:nms_keep_batched
// (IoU tile nms_mask._green_tile). Input: per sample, P score-descending
// candidates as (B, P, D) boxes, the first counts[b] valid; the kernel
// builds their corners as (9, P) fp32 rows [x of 4 corners; y of 4
// corners; area] in device memory. Output: keep (B, P) bytes, the greedy
// keep flags
// truncated at post_k: once a sample has post_k keeps, later 128-column
// blocks are all zero (exact for a caller that takes the first post_k
// keeps, NMS_POST_MAXSIZE).
//
// What bounds it: fp32 operations, 547 per IoU (two Green's-theorem
// passes of 4 edges x 4 Liang-Barsky clips; counted in
// ops/kernels/nms_fused.py:FLOPS_PER_IOU), for the pairs that the
// BEV-bounds pre-test (nms_pretest.cuh, 11 operations a pair) does not
// prove 0. The work depends on the data: per column block, (kept so far)
// x (live columns) pairs against the kept list plus the live pairs of the
// diagonal tile. The first version ran one 128-thread block per sample,
// each thread testing its column against every kept box with the full
// IoU and lane 127 computing 127 diagonal IoUs in a row, so a sample was
// one long dependent chain on one SM. Design:
//   * one block of 512 threads per sample walks its 128-column blocks in
//     order (the TPU grid's sequential axis), which keeps the greedy
//     recurrence and the post_k truncation exactly as they were;
//   * the kept list lives in shared memory as each kept box's index and
//     BEV bounds (24 bytes a box); its corners stay in device memory,
//     where the kernel wrote them;
//   * kept-vs-column pairs go in chunks of 64 kept boxes, 4 threads a
//     column: pre-test, survivors ballotted into one shared list, then all
//     512 threads take the surviving pairs one each (iou_pair, atomicOr
//     into the column's suppressed bit). A column suppressed in one chunk
//     is not tested in the next;
//   * the diagonal tile's live pairs r < c go the same way into a 128-bit
//     suppressor mask per column;
//   * one thread resolves the tile's recurrence in column order on those
//     masks, a 4-word AND per column still alive;
//   * the corners come from boxes_to_corners_bev's operations in the same
//     order (cosf, sinf, separate products and sums; -fmad=false), so they
//     equal iou3d.pack_bev's bit for bit; de6d_nms_pack_bev exposes them
//     for that check.
// The IoU is csrc/iou_bev.cuh (ops/iou3d.py's arithmetic, operation by
// operation, no FMA), so it rounds exactly like the plain PyTorch version.

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

constexpr int kBlk = 128;             // columns per block (the TPU tile)
constexpr int kWords = kBlk / 32;
constexpr int kRows = 9;
constexpr int kThreads = 512;
constexpr int kSplit = kThreads / kBlk;  // threads per column
constexpr int kChunk = 64;               // kept boxes per pre-test pass
// pairs of one pass: a kept chunk's 64 x 128, or the tile's 128 * 127 / 2
constexpr int kListCap = kChunk * kBlk;

// Corners and area of box (x, y, z, l, w, h, yaw) in the operations of
// ops/geometry.py:boxes_to_corners_bev and ops/iou3d.py:pack_bev.
__device__ __forceinline__ void box_corners(const float* box, Quad* q,
                                            float* area) {
  const float tx[4] = {0.5f, 0.5f, -0.5f, -0.5f};
  const float ty[4] = {0.5f, -0.5f, -0.5f, 0.5f};
  const float cx = box[0], cy = box[1], l = box[3], w = box[4];
  const float c = cosf(box[6]);
  const float s = sinf(box[6]);
  const float ns = -s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lx = l * tx[i];
    const float ly = w * ty[i];
    q->x[i] = (c * lx + ns * ly) + cx;
    q->y[i] = (s * lx + c * ly) + cy;
  }
  *area = l * w;
}

__device__ __forceinline__ void load_quad(const float* pk, int P, int i,
                                          Quad* q, float* area) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q->x[k] = pk[k * P + i];
    q->y[k] = pk[(4 + k) * P + i];
  }
  *area = pk[8 * P + i];
}

__device__ __forceinline__ bool bit(const uint32_t* words, int i) {
  return (words[i >> 5] >> (i & 31)) & 1u;
}

// Reads (B, P, D) boxes and writes their corners to `corners` (B, 9, P)
// as each column block is loaded; kept boxes' corners are read back from
// there by the same block (plain loads, not the read-only path).
__global__ void __launch_bounds__(kThreads)
nms_fused_kernel(const float* __restrict__ boxes, int D, float* corners,
                 const int* __restrict__ counts, uint8_t* __restrict__ keep,
                 int P, float thresh, int post_k, int k_cap) {
  extern __shared__ float dyn[];  // kept list: bounds (5, k_cap), index
  float* kept_b = dyn;
  int* kept_i = reinterpret_cast<int*>(dyn + 5 * k_cap);
  __shared__ float cols[kRows][kBlk];
  __shared__ Bounds col_b[kBlk];
  __shared__ uint32_t supmask[kBlk][kWords];  // bit r: row r suppresses c
  __shared__ uint16_t list[kListCap];
  __shared__ uint32_t alive_bits[kWords];  // live, not suppressed by kept
  __shared__ uint32_t keep_bits[kWords];
  __shared__ int n_list[2];
  __shared__ int s_nk;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int c_own = t & (kBlk - 1);  // this thread's column in pre-tests
  const int sub = t / kBlk;
  const int count = max(0, min(counts[b], P));
  float* pk = corners + static_cast<size_t>(b) * kRows * P;
  uint8_t* keep_b = keep + static_cast<size_t>(b) * P;
  const bool pretest = thresh >= kMinThresh;
  if (t == 0) {
    s_nk = 0;
    n_list[0] = n_list[1] = 0;
  }
  __syncthreads();
  int pass = 0;  // n_list[pass & 1] counts the current pass's survivors

  // Append the warp's surviving pairs to the current pass's list; every
  // lane of the warp calls it with the same trip count.
  auto append = [&](bool survive, uint16_t entry) {
    const uint32_t ballot = __ballot_sync(0xffffffffu, survive);
    if (ballot == 0u) return;
    int base = 0;
    if (lane == 0) base = atomicAdd(&n_list[pass & 1], __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (survive) list[base + __popc(ballot & ((1u << lane) - 1u))] = entry;
  };

  for (int col0 = 0; col0 < P; col0 += kBlk) {
    const int nk = s_nk;
    if (!(col0 < count && nk < post_k)) {
      // nothing later can be needed: the rest of the sample is zero
      for (int i = col0 + t; i < P; i += kThreads) keep_b[i] = 0;
      break;
    }
    const int n_live = min(kBlk, count - col0);
    // 1) the column block's corners and bounds
    if (t < kBlk) {
      const int col = col0 + t;
      Quad q;
      float area = 0.f;
      if (t < n_live) {
        box_corners(boxes + (static_cast<size_t>(b) * P + col) * D, &q,
                    &area);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          pk[k * P + col] = q.x[k];
          pk[(4 + k) * P + col] = q.y[k];
        }
        pk[8 * P + col] = area;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) q.x[k] = q.y[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cols[k][t] = q.x[k];
        cols[4 + k][t] = q.y[k];
      }
      cols[8][t] = area;
      col_b[t] = de6d::box_bounds(q, area);
    }
    if (t < kWords) {
      const int left = n_live - 32 * t;
      alive_bits[t] = left >= 32 ? ~0u : left > 0 ? (1u << left) - 1u : 0u;
    }
    for (int i = t; i < kBlk * kWords; i += kThreads) {
      supmask[i / kWords][i % kWords] = 0u;
    }
    __syncthreads();

    // 2) suppression from the kept list, a chunk of kept boxes a pass
    const Bounds mine = col_b[c_own];
    for (int k0 = 0; k0 < nk; k0 += kChunk) {
      const int kn = min(kChunk, nk - k0);
      const bool test_col = bit(alive_bits, c_own);
      for (int i = sub; i < kn; i += kSplit) {
        const float* kb = kept_b + k0 + i;
        const Bounds r = {kb[0], kb[k_cap], kb[2 * k_cap], kb[3 * k_cap],
                          kb[4 * k_cap]};
        append(test_col && !(pretest && skippable(r, mine)),
               static_cast<uint16_t>((i << 7) | c_own));
      }
      if (t == 0) n_list[(pass + 1) & 1] = 0;
      __syncthreads();
      const int n = n_list[pass & 1];
      for (int e = t; e < n; e += kThreads) {
        const int i = list[e] >> 7;
        const int c = list[e] & (kBlk - 1);
        Quad qr, qc;
        float ar;
        load_quad(pk, P, kept_i[k0 + i], &qr, &ar);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          qc.x[k] = cols[k][c];
          qc.y[k] = cols[4 + k][c];
        }
        if (iou_pair(qr, ar, qc, cols[8][c]) > thresh) {
          atomicAnd(&alive_bits[c >> 5], ~(1u << (c & 31)));
        }
      }
      ++pass;
      __syncthreads();
    }

    // 3) the diagonal tile, live pairs r < c only
    {
      const bool col_alive = bit(alive_bits, c_own);
      const int r_end = (c_own | 31);  // the warp's last column
      for (int r = sub; r < r_end; r += kSplit) {
        append(r < c_own && col_alive && bit(alive_bits, r) &&
                   !(pretest && skippable(col_b[r], mine)),
               static_cast<uint16_t>((r << 7) | c_own));
      }
      if (t == 0) n_list[(pass + 1) & 1] = 0;
      __syncthreads();
      const int n = n_list[pass & 1];
      for (int e = t; e < n; e += kThreads) {
        const int r = list[e] >> 7;
        const int c = list[e] & (kBlk - 1);
        Quad qr, qc;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          qr.x[k] = cols[k][r];
          qr.y[k] = cols[4 + k][r];
          qc.x[k] = cols[k][c];
          qc.y[k] = cols[4 + k][c];
        }
        if (iou_pair(qr, cols[8][r], qc, cols[8][c]) > thresh) {
          atomicOr(&supmask[c][r >> 5], 1u << (r & 31));
        }
      }
      ++pass;
      __syncthreads();
    }

    // 4) resolve the tile's recurrence in column order
    if (t == 0) {
      uint32_t kb[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) kb[w] = alive_bits[w];
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        uint32_t todo = kb[w];
        while (todo) {
          const int c = w * 32 + __ffs(todo) - 1;
          todo &= todo - 1u;
          uint32_t hit = 0u;
#pragma unroll
          for (int v = 0; v < kWords; ++v) hit |= supmask[c][v] & kb[v];
          if (hit) kb[w] &= ~(1u << (c & 31));
        }
      }
#pragma unroll
      for (int w = 0; w < kWords; ++w) keep_bits[w] = kb[w];
    }
    __syncthreads();

    // 5) write the flags; kept columns append to the kept list
    if (t < kBlk) {
      const int warp = t >> 5;
      const bool k = (keep_bits[warp] >> lane) & 1u;
      keep_b[col0 + t] = k ? 1 : 0;
      if (k) {
        int pos = nk + __popc(keep_bits[warp] & ((1u << lane) - 1u));
        for (int w = 0; w < warp; ++w) pos += __popc(keep_bits[w]);
        const Bounds& m = col_b[t];
        kept_b[pos] = m.x0;
        kept_b[k_cap + pos] = m.x1;
        kept_b[2 * k_cap + pos] = m.y0;
        kept_b[3 * k_cap + pos] = m.y1;
        kept_b[4 * k_cap + pos] = m.s;
        kept_i[pos] = col0 + t;
      }
    }
    if (t == 0) {
      int added = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) added += __popc(keep_bits[w]);
      s_nk = nk + added;
    }
    __syncthreads();
  }
}

// The corners of box_corners as (B, 9, P) rows: the check that they equal
// iou3d.pack_bev bit for bit.
__global__ void pack_bev_kernel(const float* __restrict__ boxes, int D,
                                float* __restrict__ packed, int P,
                                long long n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  const long long b = i / P;
  const int col = static_cast<int>(i - b * P);
  Quad q;
  float area;
  box_corners(boxes + i * D, &q, &area);
  float* pk = packed + b * kRows * P;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pk[k * P + col] = q.x[k];
    pk[(4 + k) * P + col] = q.y[k];
  }
  pk[8 * P + col] = area;
}

}  // namespace

// boxes (B, P, D) fp32 contiguous, D >= 7; corners (B, 9, P) fp32 scratch
// that the kernel fills as far as it walks; counts (B,) int32, keep (B, P)
// uint8. P % 128 == 0; k_cap >= ceil(post_k / 128) * 128 + 128 (checked by
// the wrapper, ops/kernels/nms_fused.py). Returns the CUDA error code.
extern "C" int de6d_nms_keep_batched(const void* boxes, int D, void* corners,
                                     const void* counts, void* keep, int B,
                                     int P, float thresh, int post_k,
                                     int k_cap, void* stream) {
  const int dyn = static_cast<int>(sizeof(float)) * 6 * k_cap;
  cudaError_t err = de6d::max_dynamic_smem(nms_fused_kernel, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_fused_kernel<<<B, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), D, static_cast<float*>(corners),
      static_cast<const int*>(counts), static_cast<uint8_t*>(keep), P,
      thresh, post_k, k_cap);
  return static_cast<int>(cudaGetLastError());
}

// boxes (B, P, D) fp32 contiguous -> packed (B, 9, P) fp32, the corners
// the NMS kernel builds. Returns the CUDA error code.
extern "C" int de6d_nms_pack_bev(const void* boxes, int D, void* packed,
                                 int B, int P, void* stream) {
  const long long n = static_cast<long long>(B) * P;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  pack_bev_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), D, static_cast<float*>(packed), P, n);
  return static_cast<int>(cudaGetLastError());
}
