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
