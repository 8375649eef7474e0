// BEV canvas scatter for PointPillars: key-sorted pillar rows -> dense
// (B, G = ny*nx, C) canvas, cells without a pillar set to zero.
//
// Replaces the TPU kernel de6d_tpu/ops/pallas/canvas.py:scatter_canvas
// (a one-hot MXU row select over VMEM blocks). On Hopper the work is a
// pure copy, bound by bytes: every canvas byte is written once (219 MB
// of bf16 at KITTI size, batch 8) and every feature row read at most
// once. Design:
//   * one block per tile of kTile consecutive cells of one sample;
//   * lin[b] is ascending (the voxelizer's slot order, invalid ids >= G
//     as a suffix), so the tile's pillars are the contiguous range
//     [lower_bound(cell0), lower_bound(cell1)) found by binary search;
//   * the range is spread into a per-cell owner table in shared memory,
//     then the tile is written row by row with 16-byte vector stores
//     (the row is copied as raw bytes, so bf16 and fp32 share the code).
// The wrapper (ops/kernels/canvas.py) checks devices, dtypes, shapes,
// contiguity and that a row is a whole number of 16-byte vectors.
//
// The backward (canvas_grad_kernel) replaces the JAX custom VJP
// de6d_tpu/ops/pallas/canvas.py:_scatter_canvas_bwd, plain XLA under the
// Pallas forward: d_feat[b, v] = d_canvas[b, lin[b, v]] where lin[b, v]
// is a cell, zeros elsewhere. It is a row gather, bound by bytes: at
// PointPillars' training shape (4 x 16000 x 64 bf16) it reads 8.2 MB of
// rows and 0.26 MB of ids and writes 8.2 MB, about 5 us at 3.35 TB/s, so
// the launch dominates. Each thread copies one 16-byte vector: the
// threads of a warp cover whole rows with neighbouring addresses, the
// slot's id is read once per vector (an L1 hit after the first), and the
// row is moved as raw bytes, so bf16 and fp32 share the code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;     // cells per block
constexpr int kThreads = 256;

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
canvas_kernel(const uint4* __restrict__ feat, const int* __restrict__ lin,
              uint4* __restrict__ out, int V, int G, int vec_per_row) {
  __shared__ int owner[kTile];
  __shared__ int range[2];
  const int b = blockIdx.y;
  const int cell0 = blockIdx.x * kTile;
  const int cell1 = min(cell0 + kTile, G);
  const int* lin_b = lin + static_cast<size_t>(b) * V;

  if (threadIdx.x < 2) {
    range[threadIdx.x] = lower_bound(lin_b, V, threadIdx.x == 0 ? cell0 : cell1);
  }
  for (int i = threadIdx.x; i < kTile; i += kThreads) owner[i] = -1;
  __syncthreads();
  for (int p = range[0] + threadIdx.x; p < range[1]; p += kThreads) {
    const int c = __ldg(lin_b + p) - cell0;
    if (c >= 0 && c < kTile) owner[c] = p;  // guards an unsorted lin
  }
  __syncthreads();

  const uint4* feat_b = feat + static_cast<size_t>(b) * V * vec_per_row;
  uint4* out_t = out + (static_cast<size_t>(b) * G + cell0) * vec_per_row;
  const int n_vec = (cell1 - cell0) * vec_per_row;
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    const int c = i / vec_per_row;
    const int k = i - c * vec_per_row;
    const int p = owner[c];
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (p >= 0) val = __ldg(feat_b + static_cast<size_t>(p) * vec_per_row + k);
    out_t[i] = val;
  }
}

__global__ void __launch_bounds__(kThreads)
canvas_grad_kernel(const uint4* __restrict__ d_canvas,
                   const int* __restrict__ lin, uint4* __restrict__ d_feat,
                   int V, int G, int vec_per_row, int64_t n_vec) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       i < n_vec; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t row = i / vec_per_row;  // b * V + v
    const int k = static_cast<int>(i - row * vec_per_row);
    const int cell = __ldg(lin + row);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (static_cast<unsigned>(cell) < static_cast<unsigned>(G)) {
      const int64_t b = row / V;
      val = __ldg(d_canvas + (b * G + cell) * vec_per_row + k);
    }
    d_feat[i] = val;
  }
}

}  // namespace

// feat (B, V, C) of row_bytes per row, lin (B, V) int32, out (B, G, C).
// Returns cudaGetLastError() after the launch.
extern "C" int de6d_scatter_canvas(const void* feat, const void* lin,
                                   void* out, int B, int V, int G,
                                   int row_bytes, void* stream) {
  const int vec_per_row = row_bytes / 16;
  const dim3 grid((G + kTile - 1) / kTile, B);
  canvas_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(feat), static_cast<const int*>(lin),
      static_cast<uint4*>(out), V, G, vec_per_row);
  return static_cast<int>(cudaGetLastError());
}

// d_canvas (B, G, C) of row_bytes per row, lin (B, V) int32, d_feat
// (B, V, C). Returns cudaGetLastError() after the launch.
extern "C" int de6d_scatter_canvas_grad(const void* d_canvas, const void* lin,
                                        void* d_feat, int B, int V, int G,
                                        int row_bytes, void* stream) {
  const int vec_per_row = row_bytes / 16;
  const int64_t n_vec = static_cast<int64_t>(B) * V * vec_per_row;
  const int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 65535 * 32 ? blocks : 65535 * 32);
  canvas_grad_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(d_canvas), static_cast<const int*>(lin),
      static_cast<uint4*>(d_feat), V, G, vec_per_row, n_vec);
  return static_cast<int>(cudaGetLastError());
}
