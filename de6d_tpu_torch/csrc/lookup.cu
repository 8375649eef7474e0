// Sorted-table key lookup for the sparse voxel backbone, and the neighbour
// table of a sparse convolution built with its keys generated here.
//
// Replaces the TPU kernel de6d_tpu/ops/pallas/lookup.py:lookup_pallas (a
// bucket-head compare plus a one-hot MXU bucket fetch of hi/lo 16-bit key
// halves, V <= 16384), which exists because the TPU's vector unit cannot
// index its memory per lane. Contract (de6d_tpu/ops/sparse.py:lookup):
//   hit[q] <=> query[q] != INT32_MAX and query[q] is in table[b];
//   then table[b][idx[q]] == query[q].
// On a miss both kernels write min(lower_bound, V - 1), the index that
// torch.searchsorted gives (lower_bound(INT32_MAX) for an INVALID query),
// so the plain versions are matched everywhere.
//
// Bound: bytes. The lookup reads every query once and writes (idx, hit)
// once, 9 bytes a query; the neighbour table reads its asking keys once
// and writes 5 bytes per (row, offset); both read each table once.
//
// The device search (both entry points): a block takes a run of queries,
// finds the range [lb(min query), lb(max query)] of the table that holds
// every answer, stages that window in shared memory when it fits, and
// each query binary-searches the window (branch-free, so the lanes of a
// warp do not diverge); what does not fit is searched in device memory.
// The answer is exact whatever the queries, and cheap when a run's keys
// are close together. The window's ends come from every 32nd table entry
// staged in shared memory and one read of the 31 entries between two of
// them: all of a block's searches cost one device-memory round trip, not
// log2(V) dependent reads. The first version staged the sample's whole
// table (64 KB at V = 16000) in every block of 4096 queries and walked
// log2(V) dependent shared-memory reads per query.
//   * lookup: a block of 512 threads takes 4096 consecutive queries;
//     where the window outgrows shared memory, every S-th entry of it is
//     staged and a query ends with log2(S) steps in device memory;
//   * neighbor_table: a block takes 128 asking rows and generates their
//     K neighbour keys itself (ask coords * stride - padding + offset, in
//     or out of the grid), one window per (kz, ky) group of offsets: for
//     a fixed offset the neighbour key is a monotone function of the
//     asking key (de6d_tpu/ops/sparse.py:strided_neighbor_table), so a
//     run of sorted asking rows reads a narrow window. Within a group the
//     kx neighbours of a row are consecutive keys, so a row binary-
//     searches its first one and walks to the rest (a first version that
//     searched every (row, offset) and divided by runtime sizes was held
//     by its ~260 instructions a query). Results go through shared memory
//     as idx * 2 + hit and out in (row, offset) order.
//   * transposed_table: the data gradient's table of a strided conv (no
//     TPU kernel behind it: JAX differentiates the XLA gather-GEMM), a
//     gather over the input sites: input p's entry at offset k is the
//     output site (coords(p) + padding - d_k) / stride where that divides
//     on every axis and lies in the output grid, looked up among the
//     layer's sorted output keys. For one offset the map is injective, so
//     each entry is the transpose's pair (q, k) or nothing: tidx[p, k] = q
//     where idx[q, k] = p. Bound: bytes, B * V * K * 5 written once, no
//     memset. The scatter it replaced zeroed its whole output with three
//     cudaMemsetAsync and wrote a lone 4-byte idx and two bytes per live
//     pair into rows the map scattered (4 nodes a table in a CUDA graph).
//     On an NVIDIA H100 80GB HBM3 at 700 W (sparse_conv_ab.py), a first
//     gather, the neighbour-table kernel above with its key generator
//     inverted, ran at ~12x its bound (0.081 ms for SECOND's 4 strided
//     tables in a graph, slower than the scatter's 0.045): its per-block
//     phases (heads, group windows, staging) cost more than the searches
//     they save. This one takes 0.037 ms: a thread takes one input row,
//     the offsets that divide come from each axis's parity (at most 8 of
//     27 for stride 2), their output keys are searched in lockstep, 8 at
//     a time, straight in the table (its top levels cached for the whole
//     block; lanes without a candidate search too: skipping their loads
//     by a branch per lane broke the lockstep, 0.054 ms), and a block of
//     128 rows writes its results out through shared memory in (row,
//     offset) order: one barrier, no staging.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kInvalid = INT_MAX;
constexpr int kThreads = 256;

// first position p in [lo, hi) of the device table with tab[p] >= key
__device__ __forceinline__ int lower_bound_global(const int* tab, int lo,
                                                  int hi, int key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(tab + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// first position p in [0, n) of a shared window with win[p] >= key, or n:
// ceil(log2(n)) + 1 steps whatever the key, so the lanes of a warp searching
// one window do not diverge
__device__ __forceinline__ int lower_bound_shared(const int* win, int n,
                                                  int key) {
  if (n <= 0) return 0;
  int base = 0;
  while (n > 1) {
    const int half = n >> 1;
    base = win[base + half - 1] < key ? base + half : base;
    n -= half;
  }
  return base + (win[base] < key ? 1 : 0);
}

// lower_bound_shared of N keys in one window, in lockstep: the same
// steps for every key, so N chains of dependent shared-memory reads are in
// flight at once (a thread searching its keys one after another waits a
// shared-memory latency per step)
template <int N>
__device__ __forceinline__ void lower_bounds_shared(const int* win, int n,
                                                    const int (&key)[N],
                                                    int (&pos)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) pos[j] = 0;
  if (n <= 0) return;
  while (n > 1) {
    const int half = n >> 1;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      pos[j] = win[pos[j] + half - 1] < key[j] ? pos[j] + half : pos[j];
    }
    n -= half;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) pos[j] += win[pos[j]] < key[j] ? 1 : 0;
}

// One window [lo, hi] of the table, staged at win + off when off >= 0.
struct Window {
  int lo, hi, off;
};

// the table entry at pos, lo <= pos <= min(hi, V - 1), through window w
__device__ __forceinline__ int window_at(const int* tab, const int* win,
                                         const Window& w, int pos) {
  return w.off >= 0 ? win[w.off + pos - w.lo] : __ldg(tab + pos);
}

// Entries of window [lo, hi] that exist (hi may be V).
__device__ __forceinline__ int window_size(int lo, int hi, int V) {
  return lo > hi ? 0 : min(hi, V - 1) - lo + 1;
}

// dst[i] = src[i << shift] for i < n, by all T threads of the block with
// U loads in flight each (a loop of one load and one store would wait a
// device-memory latency per element)
template <int T, int U>
__device__ __forceinline__ void stage(int* dst, const int* src, int n,
                                      int shift) {
  for (int i0 = threadIdx.x; i0 < n; i0 += T * U) {
    int v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * T;
      if (i < n) v[u] = __ldg(src + (static_cast<size_t>(i) << shift));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * T;
      if (i < n) dst[i] = v[u];
    }
  }
}

constexpr int kHeads = 512;       // staged table heads: every S-th entry
constexpr int kMinHeadShift = 5;  // S >= 32
constexpr int kNoKey = INT_MIN;   // a search not to make

// The shift of S: the least >= kMinHeadShift with V / S <= kHeads.
__device__ __forceinline__ int head_shift(int V) {
  int shift = kMinHeadShift;
  while (((V + (1 << shift) - 1) >> shift) > kHeads) ++shift;
  return shift;
}

// out[i] = lower_bound(keys[i]) in the table, or -1 for kNoKey, for i < n,
// through its heads (every (1 << shift)-th entry, staged in shared
// memory): each key's bucket between two heads, then the 31 entries of
// every bucket read at once into `scratch` (n * 32 ints); buckets wider
// than 32 entries are searched in device memory. Called by every thread of
// the block (T of them); ends with the results visible to all.
template <int T>
__device__ __forceinline__ void bounds_by_heads(
    const int* tab, int V, const int* heads, int nh, int shift,
    const int* keys, int n, int* scratch, int* hs, int* out) {
  const int t = threadIdx.x;
  if (t < n) {
    hs[t] = keys[t] == kNoKey ? -1 : lower_bound_shared(heads, nh, keys[t]);
  }
  __syncthreads();
  if (shift == kMinHeadShift) {
    for (int e = t; e < n * 32; e += T) {
      const int h = hs[e >> 5];
      const int p = ((h - 1) << shift) + 1 + (e & 31);
      if (h >= 1) {
        scratch[e] = p < min(h << shift, V) ? __ldg(tab + p) : INT_MAX;
      }
    }
    __syncthreads();
  }
  if (t < n) {
    const int h = hs[t];
    int pos = h;  // -1 (no key) or 0
    if (h >= 1) {
      if (shift == kMinHeadShift) {
        pos = ((h - 1) << shift) + 1;
        for (int l = 0; l < 31; ++l) pos += scratch[t * 32 + l] < keys[t];
      } else {
        pos = lower_bound_global(tab, ((h - 1) << shift) + 1,
                                 min(h << shift, V), keys[t]);
      }
    }
    out[t] = pos;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------
// lookup: arbitrary queries
// ---------------------------------------------------------------------

constexpr int kLookupThreads = 512;
constexpr int kLookupWarps = kLookupThreads / 32;
constexpr int kPerThread = 8;
constexpr int kChunk = kLookupThreads * kPerThread;  // queries per block
constexpr int kWindowKeys = 8192;                    // 32 KB

// The block's window [lo, hi] holds m entries (lo .. min(hi, V - 1));
// shared memory keeps every S-th of them, S = 1 << shift the least power
// of two that fits them in kWindowKeys. A query's lower bound is found
// among those heads, then by log2(S) steps in device memory between two
// of them (none when the whole window fits).
__global__ void __launch_bounds__(kLookupThreads)
lookup_kernel(const int* __restrict__ table, const int* __restrict__ queries,
              int* __restrict__ idx, uint8_t* __restrict__ hit, int V,
              int Q) {
  __shared__ int win[kWindowKeys];
  __shared__ int heads[kHeads];
  __shared__ int scratch[3 * 32];
  __shared__ int s_min[kLookupWarps], s_max[kLookupWarps];
  __shared__ int s_keys[3], s_hs[3], s_pos[3];  // lo, hi, end
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int* tab = table + static_cast<size_t>(b) * V;
  const size_t base = static_cast<size_t>(b) * Q;
  const int q0 = blockIdx.x * kChunk;
  int key[kPerThread];
  int kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = q0 + j * kLookupThreads + t;
    key[j] = i < Q ? __ldg(queries + base + i) : kInvalid;
    if (key[j] != kInvalid) {
      kmin = min(kmin, key[j]);
      kmax = max(kmax, key[j]);
    }
  }
  const int head_sh = head_shift(V);
  const int nth = (V + (1 << head_sh) - 1) >> head_sh;
  stage<kLookupThreads, kHeads / kLookupThreads>(heads, tab, nth, head_sh);
  kmin = __reduce_min_sync(0xffffffffu, kmin);
  kmax = __reduce_max_sync(0xffffffffu, kmax);
  if ((t & 31) == 0) {
    s_min[t >> 5] = kmin;
    s_max[t >> 5] = kmax;
  }
  __syncthreads();
  if (t < 3) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int w = 0; w < kLookupWarps; ++w) {
      lo = min(lo, s_min[w]);
      hi = max(hi, s_max[w]);
    }
    // no valid query: lo = lb(INT32_MAX), hi = -1, an empty window
    s_keys[t] = t == 0 ? lo : t == 1 ? (hi == INT_MIN ? kNoKey : hi)
                                     : kInvalid;
  }
  __syncthreads();
  bounds_by_heads<kLookupThreads>(tab, V, heads, nth, head_sh, s_keys, 3,
                                  scratch, s_hs, s_pos);
  const int lo = s_pos[0];
  const int end = s_pos[2];
  const int m = window_size(lo, s_pos[1], V);
  int shift = 0;
  while (((m + (1 << shift) - 1) >> shift) > kWindowKeys) ++shift;
  const int nh = (m + (1 << shift) - 1) >> shift;
  stage<kLookupThreads, kWindowKeys / kLookupThreads>(win, tab + lo, nh,
                                                      shift);
  __syncthreads();
  int heads_lb[kPerThread];
  lower_bounds_shared<kPerThread>(win, nh, key, heads_lb);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = q0 + j * kLookupThreads + t;
    if (i >= Q) continue;
    int pos = end;
    bool found = false;
    if (key[j] != kInvalid) {
      const int h = heads_lb[j];
      pos = h == 0 ? lo
                   : lower_bound_global(tab, lo + ((h - 1) << shift) + 1,
                                        lo + min(h << shift, m), key[j]);
      if (pos < V) {
        const int off = pos - lo;
        const int e = (off & ((1 << shift) - 1)) == 0 && (off >> shift) < nh
                          ? win[off >> shift]
                          : __ldg(tab + pos);
        found = e == key[j];
      }
    }
    idx[base + i] = min(pos, V - 1);
    hit[base + i] = found ? 1 : 0;
  }
}

// ---------------------------------------------------------------------
// neighbor_table: queries generated from asking keys
// ---------------------------------------------------------------------

constexpr int kRowsPerBlock = 128;
constexpr int kRowStride = kRowsPerBlock + 1;  // results, bank-conflict free
constexpr int kMaxOffsets = 32;
constexpr int kNbrWindowKeys = 2560;  // 10 KB: ~32 KB a block, 7 an SM

struct Geometry {
  int nz, ny, nx;      // the table's grid
  int ask_ny, ask_nx;  // the asking keys' grid (y, x extents)
  int kz, ky, kx;      // kernel
  int sz, sy, sx;      // stride
  int pz, py, px;      // padding, plus kernel // 2 when centered
};

// The neighbours of one asking row in one (kz, ky) group of offsets: keys
// key0 + ox for ox in [ox_lo, ox_hi] lie in the grid; none when ox_lo >
// ox_hi (no row, or z or y outside the grid).
struct Run {
  int key0, ox_lo, ox_hi;
};

__device__ __forceinline__ Run row_run(int bz, int by, int bx, int oz, int oy,
                                       const Geometry& g) {
  Run run = {0, 1, 0};
  if (bz == INT_MIN) return run;
  const int z = bz + oz, y = by + oy;
  if (z < 0 || z >= g.nz || y < 0 || y >= g.ny) return run;
  run.ox_lo = max(0, -bx);
  run.ox_hi = min(g.kx - 1, g.nx - 1 - bx);
  if (run.ox_lo <= run.ox_hi) run.key0 = (z * g.ny + y) * g.nx + bx;
  return run;
}

__global__ void __launch_bounds__(kThreads)
neighbor_table_kernel(const int* __restrict__ table,
                      const int* __restrict__ ask, int* __restrict__ idx,
                      uint8_t* __restrict__ hit, int V, int Q, Geometry g) {
  __shared__ int win[kNbrWindowKeys];
  __shared__ int res[kMaxOffsets * kRowStride];  // idx * 2 + hit
  __shared__ int base_z[kRowsPerBlock], base_y[kRowsPerBlock],
      base_x[kRowsPerBlock];
  __shared__ int g_oz[kMaxOffsets], g_oy[kMaxOffsets];
  __shared__ int g_min[kMaxOffsets], g_max[kMaxOffsets];
  __shared__ Window g_w[kMaxOffsets];
  __shared__ int g_n[kMaxOffsets];  // entries staged (0: not staged)
  __shared__ int heads[kHeads];
  __shared__ int s_key[2 * kMaxOffsets + 1], s_head[2 * kMaxOffsets + 1],
      s_pos[2 * kMaxOffsets + 1];
  __shared__ int s_staged;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int groups = g.kz * g.ky;
  const int K = groups * g.kx;
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, Q - r0);
  const int* tab = table + static_cast<size_t>(b) * V;

  // 1) the table's heads, and the asking rows' base coordinates (z =
  // INT_MIN: no row)
  const int key = t < rows ? __ldg(ask + static_cast<size_t>(b) * Q + r0 + t)
                           : kInvalid;  // in flight while the heads load
  const int shift = head_shift(V);
  const int nh = (V + (1 << shift) - 1) >> shift;
  stage<kThreads, kHeads / kThreads>(heads, tab, nh, shift);
  if (t < kRowsPerBlock) {
    if (key == kInvalid) {
      base_z[t] = INT_MIN;
    } else {
      const int plane = g.ask_ny * g.ask_nx;
      const int z = key / plane;
      const int rem = key - z * plane;
      const int y = rem / g.ask_nx;
      const int x = rem - y * g.ask_nx;
      base_z[t] = z * g.sz - g.pz;
      base_y[t] = y * g.sy - g.py;
      base_x[t] = x * g.sx - g.px;
    }
  }
  if (t < groups) {
    g_oz[t] = t / g.ky;
    g_oy[t] = t % g.ky;
    g_min[t] = INT_MAX;
    g_max[t] = INT_MIN;
  }
  __syncthreads();

  // 2) each group's range of keys, a warp on 32 rows of one group
  for (int e = t; e < groups * kRowsPerBlock; e += kThreads) {
    const int gi = e / kRowsPerBlock;  // warp-uniform
    const int r = e - gi * kRowsPerBlock;
    const Run run = row_run(base_z[r], base_y[r], base_x[r], g_oz[gi],
                            g_oy[gi], g);
    const bool any = run.ox_lo <= run.ox_hi;
    const int lo = __reduce_min_sync(0xffffffffu,
                                     any ? run.key0 + run.ox_lo : INT_MAX);
    const int hi = __reduce_max_sync(0xffffffffu,
                                     any ? run.key0 + run.ox_hi : INT_MIN);
    if (lane == 0 && lo <= hi) {
      atomicMin(&g_min[gi], lo);
      atomicMax(&g_max[gi], hi);
    }
  }
  __syncthreads();

  // 3) each group's window [lb(min), lb(max)], and lb(INT32_MAX)
  const int n_search = 2 * groups + 1;
  if (t < n_search) {
    const int gi = t % groups;
    const bool none = t < 2 * groups && g_min[gi] > g_max[gi];
    s_key[t] = none ? kNoKey
               : t < groups ? g_min[gi]
               : t < 2 * groups ? g_max[gi]
                                : kInvalid;
  }
  __syncthreads();
  bounds_by_heads<kThreads>(tab, V, heads, nh, shift, s_key, n_search, res,
                            s_head, s_pos);
  if (t < groups) {
    // a group with no neighbour in the grid gets the empty window [1, 0]
    g_w[t].lo = s_pos[t] < 0 ? 1 : s_pos[t];
    g_w[t].hi = s_pos[t] < 0 ? 0 : s_pos[groups + t];
  }
  __syncthreads();
  if (t == 0) {
    int off = 0;
    for (int gi = 0; gi < groups; ++gi) {
      const int n = window_size(g_w[gi].lo, g_w[gi].hi, V);
      const bool fits = off + n <= kNbrWindowKeys;
      g_w[gi].off = fits ? off : -1;
      g_n[gi] = fits ? n : 0;
      off += fits ? n : 0;
    }
    s_staged = off;
  }
  __syncthreads();

  // 4) stage the windows that fit, back to back in `win`, by all threads
  // with four loads in flight each (a thread's groups only go up)
  {
    constexpr int kU = 4;
    const int staged = s_staged;
    int gi = 0, g_off = 0;
    for (int i0 = t; i0 < staged; i0 += kThreads * kU) {
      int v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kThreads;
        if (i < staged) {
          while (i >= g_off + g_n[gi]) g_off += g_n[gi++];
          v[u] = __ldg(tab + g_w[gi].lo + (i - g_off));
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kThreads;
        if (i < staged) win[i] = v[u];
      }
    }
  }
  __syncthreads();

  // 5) a thread takes 4 rows of one group (a warp stays in one group),
  // binary-searches their first neighbours in the grid in lockstep, then
  // walks each row along x (keys + 1 each: the lower bound moves past the
  // entries equal to the previous key, at most one in a key set)
  constexpr int kRowsPerThread = kRowsPerBlock / 32;
  const int miss = min(s_pos[2 * groups], V - 1) * 2;
  for (int task = t; task < groups * 32; task += kThreads) {
    const int gi = task >> 5;  // warp-uniform
    const Window w = g_w[gi];
    Run run[kRowsPerThread];
    int first[kRowsPerThread], pos[kRowsPerThread];
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const int r = (task & 31) + 32 * u;
      run[u] = row_run(base_z[r], base_y[r], base_x[r], g_oz[gi], g_oy[gi],
                       g);
      first[u] = run[u].ox_lo <= run[u].ox_hi ? run[u].key0 + run[u].ox_lo
                                              : INT_MAX;
    }
    if (w.off >= 0) {
      lower_bounds_shared<kRowsPerThread>(win + w.off, w.hi - w.lo, first,
                                          pos);
#pragma unroll
      for (int u = 0; u < kRowsPerThread; ++u) pos[u] += w.lo;
    } else {
#pragma unroll
      for (int u = 0; u < kRowsPerThread; ++u) {
        pos[u] = lower_bound_global(tab, w.lo, w.hi, first[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      int* out = res + gi * g.kx * kRowStride + (task & 31) + 32 * u;
      int p = pos[u];
      for (int ox = 0; ox < g.kx; ++ox) {
        int v = miss;
        if (ox >= run[u].ox_lo && ox <= run[u].ox_hi) {
          const int q = run[u].key0 + ox;
          while (p < V && window_at(tab, win, w, p) < q) ++p;
          const bool found = p < V && window_at(tab, win, w, p) == q;
          v = min(p, V - 1) * 2 + (found ? 1 : 0);
        }
        out[ox * kRowStride] = v;
      }
    }
  }
  __syncthreads();

  // 6) out in (row, offset) order: the block's rows are one contiguous
  // run; r = j / K by an fp32 reciprocal, exact for j < 2^12 (the error
  // of (j + 0.5) / K is ~5e-4, the margin 0.5 / K >= 1/64)
  const size_t out0 = (static_cast<size_t>(b) * Q + r0) * K;
  const float inv_k = 1.0f / static_cast<float>(K);
  for (int j = t; j < rows * K; j += kThreads) {
    const int r = __float2int_rz((static_cast<float>(j) + 0.5f) * inv_k);
    const int k = j - r * K;
    const int v = res[k * kRowStride + r];
    idx[out0 + j] = v >> 1;
    hit[out0 + j] = static_cast<uint8_t>(v & 1);
  }
}

// ---------------------------------------------------------------------
// transposed_table: a strided conv's table transposed onto its inputs
// ---------------------------------------------------------------------

constexpr int kTransRows = 128;  // input rows per block, one a thread
constexpr int kSearchLanes = 8;  // output keys a thread searches at once

// Offsets d in [0, k) along one axis whose output (c + pad - d) / s
// divides exactly and lies in [0, n): first, first + s, ..., count of them
// (the output coordinate falls by one each).
struct AxisRun {
  int first, count;
};

__device__ __forceinline__ AxisRun axis_run(int c, int pad, int k, int s,
                                            int n) {
  AxisRun run = {0, 0};
  const int a = c + pad;
  const int lo = max(0, a - n * s + 1);
  const int hi = min(k - 1, a);
  if (lo > hi) return run;
  run.first = lo + (a - lo) % s;
  run.count = run.first <= hi ? (hi - run.first) / s + 1 : 0;
  return run;
}

// lower_bound of N keys in the device table tab[0, n), in lockstep (N
// independent chains of loads in flight): the same steps for every key
template <int N>
__device__ __forceinline__ void lower_bounds_global(const int* tab, int n,
                                                    const int (&key)[N],
                                                    int (&pos)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) pos[j] = 0;
  while (n > 1) {
    const int half = n >> 1;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      pos[j] = __ldg(tab + pos[j] + half - 1) < key[j] ? pos[j] + half
                                                       : pos[j];
    }
    n -= half;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) pos[j] += __ldg(tab + pos[j]) < key[j] ? 1 : 0;
}

__global__ void __launch_bounds__(kTransRows)
transposed_table_kernel(const int* __restrict__ table,
                        const int* __restrict__ ask, int* __restrict__ idx,
                        uint8_t* __restrict__ hit,
                        uint8_t* __restrict__ tvalid, int V, int Q,
                        Geometry g) {
  __shared__ int res[kMaxOffsets * kRowStride];  // idx * 2 + hit
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int K = g.kz * g.ky * g.kx;
  const int r0 = blockIdx.x * kTransRows;
  const int rows = min(kTransRows, Q - r0);
  const int* tab = table + static_cast<size_t>(b) * V;
  const int key = t < rows ? __ldg(ask + static_cast<size_t>(b) * Q + r0 + t)
                           : kInvalid;
  for (int k = 0; k < K; ++k) res[k * kRowStride + t] = 0;  // a miss
  AxisRun rz = {0, 0}, ry = {0, 0}, rx = {0, 0};
  int z = 0, y = 0, x = 0;
  if (key != kInvalid) {
    const int plane = g.ask_ny * g.ask_nx;
    z = key / plane;
    const int rem = key - z * plane;
    y = rem / g.ask_nx;
    x = rem - y * g.ask_nx;
    rz = axis_run(z, g.pz, g.kz, g.sz, g.nz);
    ry = axis_run(y, g.py, g.ky, g.sy, g.ny);
    rx = axis_run(x, g.px, g.kx, g.sx, g.nx);
  }
  const int total = rz.count * ry.count * rx.count;
  bool any = false;
  for (int i0 = 0; i0 < total; i0 += kSearchLanes) {
    int want[kSearchLanes], col[kSearchLanes], pos[kSearchLanes];
#pragma unroll
    for (int j = 0; j < kSearchLanes; ++j) {
      const int i = i0 + j;
      want[j] = INT_MAX;  // no candidate: found nowhere
      col[j] = -1;
      if (i < total) {
        const int ix = i % rx.count, iyz = i / rx.count;
        const int iy = iyz % ry.count, iz = iyz / ry.count;
        const int dz = rz.first + iz * g.sz, dy = ry.first + iy * g.sy,
                  dx = rx.first + ix * g.sx;
        want[j] = (((z + g.pz - dz) / g.sz) * g.ny + (y + g.py - dy) / g.sy) *
                      g.nx +
                  (x + g.px - dx) / g.sx;
        col[j] = (dz * g.ky + dy) * g.kx + dx;
      }
    }
    lower_bounds_global<kSearchLanes>(tab, V, want, pos);
#pragma unroll
    for (int j = 0; j < kSearchLanes; ++j) {
      if (col[j] >= 0 && pos[j] < V && __ldg(tab + pos[j]) == want[j]) {
        res[col[j] * kRowStride + t] = pos[j] * 2 + 1;
        any = true;
      }
    }
  }
  if (t < rows) tvalid[static_cast<size_t>(b) * Q + r0 + t] = any ? 1 : 0;
  __syncthreads();
  // out in (row, offset) order, as neighbor_table_kernel writes it
  const size_t out0 = (static_cast<size_t>(b) * Q + r0) * K;
  const float inv_k = 1.0f / static_cast<float>(K);
  for (int j = t; j < rows * K; j += kTransRows) {
    const int r = __float2int_rz((static_cast<float>(j) + 0.5f) * inv_k);
    const int v = res[(j - r * K) * kRowStride + r];
    idx[out0 + j] = v >> 1;
    hit[out0 + j] = static_cast<uint8_t>(v & 1);
  }
}

// Nothing: one launch's cost on the card, for the latency floor of a
// short kernel (chip_smoke.py times it in a CUDA graph).
__global__ void empty_kernel() {}

}  // namespace

// table (B, V) int32 ascending per row, queries (B, Q) int32 -> idx (B, Q)
// int32, hit (B, Q) uint8. V >= 1. Returns a cudaError_t.
extern "C" int de6d_lookup(const void* table, const void* queries, void* idx,
                           void* hit, int B, int V, int Q, void* stream) {
  if (V < 1 || Q < 0 || B < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Q == 0) return 0;
  const dim3 grid((Q + kChunk - 1) / kChunk, B);
  lookup_kernel<<<grid, kLookupThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(queries),
      static_cast<int*>(idx), static_cast<uint8_t*>(hit), V, Q);
  return static_cast<int>(cudaGetLastError());
}

// table (B, V) int32 ascending per row; ask (B, Q) int32 keys of the
// asking sites in their own grid; geom = {nz, ny, nx, ask_ny, ask_nx, kz,
// ky, kx, sz, sy, sx, pz, py, px} with pz.. the padding plus kernel // 2
// for a centered (submanifold) kernel -> idx, hit (B, Q, K), K = kz*ky*kx
// <= 32, neighbour k of row q at ask_coord * stride - padding + (k's
// z-major offset). V >= 1, nz * ny * nx < INT32_MAX (checked by the
// wrapper, ops/kernels/lookup.py). Returns a cudaError_t.
extern "C" int de6d_neighbor_table(const void* table, const void* ask,
                                   void* idx, void* hit, int B, int V, int Q,
                                   const int* geom, void* stream) {
  const Geometry g = {geom[0], geom[1], geom[2],  geom[3],  geom[4],
                      geom[5], geom[6], geom[7],  geom[8],  geom[9],
                      geom[10], geom[11], geom[12], geom[13]};
  if (V < 1 || Q < 0 || B < 0 || g.kz * g.ky * g.kx > kMaxOffsets ||
      g.kz < 1 || g.ky < 1 || g.kx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Q == 0) return 0;
  const dim3 grid((Q + kRowsPerBlock - 1) / kRowsPerBlock, B);
  neighbor_table_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(ask),
      static_cast<int*>(idx), static_cast<uint8_t*>(hit), V, Q, g);
  return static_cast<int>(cudaGetLastError());
}

// The transposed table of a strided conv, the input rows asking: table
// (B, V) int32, the layer's output keys ascending per row; ask (B, Q)
// int32, its input keys (any order, INVALID rows allowed, each key once);
// geom = {nz, ny, nx (the output grid), ask_ny, ask_nx (the input grid's),
// kz, ky, kx, sz, sy, sx, pz, py, px (the padding)} -> idx, hit (B, Q, K):
// the output row whose neighbour k is input row q, or idx 0 and no hit;
// tvalid (B, Q): some k of row q hits. Every entry is written once. V >= 1,
// K <= 32, strides >= 1. Returns a cudaError_t.
extern "C" int de6d_transposed_table(const void* table, const void* ask,
                                     void* idx, void* hit, void* tvalid,
                                     int B, int V, int Q, const int* geom,
                                     void* stream) {
  const Geometry g = {geom[0], geom[1], geom[2],  geom[3],  geom[4],
                      geom[5], geom[6], geom[7],  geom[8],  geom[9],
                      geom[10], geom[11], geom[12], geom[13]};
  if (V < 1 || Q < 0 || B < 0 || g.kz * g.ky * g.kx > kMaxOffsets ||
      g.kz < 1 || g.ky < 1 || g.kx < 1 || g.sz < 1 || g.sy < 1 ||
      g.sx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Q == 0) return 0;
  const dim3 grid((Q + kTransRows - 1) / kTransRows, B);
  transposed_table_kernel<<<grid, kTransRows, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(ask),
      static_cast<int*>(idx), static_cast<uint8_t*>(hit),
      static_cast<uint8_t*>(tvalid), V, Q, g);
  return static_cast<int>(cudaGetLastError());
}

// `blocks` blocks of 32 threads of an empty kernel. Returns a cudaError_t.
extern "C" int de6d_empty_kernel(int blocks, void* stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<blocks, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
