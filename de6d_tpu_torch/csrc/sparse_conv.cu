// Sparse 3D convolution as a gather-GEMM (implicit GEMM) for the sparse
// voxel backbone: submanifold and strided layers alike, from a
// precomputed neighbour table.
//
//   out[b, q, :] = valid[b, q] ? sum_k hit[b, q, k] * feat[b, idx[b, q, k], :]
//                                      @ W[k] : 0
//
// with fp32 accumulation, cast to the feature type (fp32 or bf16).
//
// Replaces the TPU kernel de6d_tpu/ops/pallas/sparse_gather.py:
// subm_conv_slab, which DMAs a contiguous slab of feature rows per tile
// and selects each site's row with a one-hot MXU product, because the TPU
// cannot gather rows by index; it needs Cin to divide 128 and a per-sample
// "fits the slab" flag with a fallback. A GPU gathers rows directly, so
// neither is kept: any Cin, any K, Cout <= 128, and no fallback.
//
// Bound: bytes on every SECOND layer. The function must read hit for
// every (q, k) of a valid row, idx where it hits, the referenced feature
// rows and the weights once and write the output once; it does
// 2 * Cin * Cout operations per hit, a few hundred MFLOP per layer, far
// below the tensor cores' rate. The first bf16 kernel walked the 27
// offsets of a 64-row tile one after another, each a dependent round trip
// for the table, another for the gather, W[k] restaged from L2 and two
// block barriers; it took ~27x the bound.
//
// bf16 (sparse_conv_gather_kernel): the tensor cores fed by a pipelined
// gather. 256 threads, 8 warps of 16 rows: a tile is kTileRows = 128
// output rows of one sample; blocks are persistent (as many as fit on the
// card at once) and walk the tiles.
//   * Per tile and block of up to 32 offsets, the (rows x offsets) table is
//     read once, coalesced, eight entries a thread with independent loads,
//     as source row or -1 (a miss, or a row that is not valid) into shared
//     memory. One pass over it gives, per offset, the live 16-row groups as
//     a bit mask and the hit rows in order (a prefix sum over the 8 lanes
//     of an offset); warp 0 lists the offsets with a hit. A step is one
//     (live offset, 64-channel chunk); an offset without a hit in the tile
//     costs nothing.
//   * A 2-stage ring of gathered rows, filled by cp.async (16, 8 or 4 bytes
//     a copy, the widest that the rows' size and alignment allow; 2-byte
//     rows take plain loads): the next step's copies are in flight while
//     the tensor cores work on the current one, one __syncthreads a step.
//     Only hit rows are copied; a miss leaves a stale row in the ring, and
//     its A fragment registers are zeroed after ldmatrix instead (a row of
//     a dead 16-row group is never read: its warp skips the step).
//   * Products: ldmatrix fragments from padded shared-memory rows (no bank
//     conflicts) and mma.sync m16n8k16 bf16 x bf16 -> fp32, each warp 16
//     rows x all Cout columns, accumulated in registers: NT = 2, 4, 8 or 16
//     n8 tiles by Cout, so that narrow layers run 4 blocks an SM (3 up to
//     Cout 64, 2 up to 128). bf16 products are exact in fp32, so only the
//     order of the fp32 sums differs from the plain version's.
//   * Weights: resident (variant "resident") when K * Cin16 * (Cout8 + 8)
//     * 2 bytes fit beside the ring and the table without costing a block
//     an SM (plan()), loaded once per block for its whole life; otherwise
//     (variant "streamed") each step's W[k] chunk travels in the ring
//     beside its rows, by cp.async from L2. Choice: plan(), mirrored by
//     ops/kernels/sparse_conv.py:plan; the library reports the variant it
//     launched.
// What the H100 showed (chip_smoke.py's per-layer times, and experiments
// on copies of this kernel that were not kept): the layers are held by the
// SM's issue of many small operations (the gather copies, the dense
// 16-row MMAs, the streamed weight copies, in that order of cost), not by
// memory latency (4 or 8 ring stages instead of 2 changed nothing) nor by
// bytes. So occupancy decides: a resident block that held an SM alone
// (32 -> 32, 124 KB) took 1.5x the streamed one, and sizing the
// accumulators by Cout (more blocks an SM) gave the largest single gain.
// Tried and dropped: compacting each step's hit rows into dense MMA groups
// with fp32 accumulators in shared memory (MMA rows per hit 3.25 -> ~1.2
// on the SECOND fixture, sparse_conv.tile_stats) was no faster: the
// scatter-add and the lost registers ate the saving; one TMA bulk copy
// (cp.async.bulk, counted on a stage mbarrier) per gathered row and per
// weight row was slower (12 layers 1.17 against 0.82 ms): rows of 32 to
// 128 bytes cost the copy engine more per request than cp.async costs;
// 64-row tiles (4 warps) and cp.async.cg changed nothing. Not built:
// wgmma (the layers are not held by the tensor cores' rate).
// fp32 (sparse_conv_kernel, variant "simt"): the parity path, unchanged:
// 256 threads, 64 rows, each offset's rows gathered into shared memory,
// each thread 4 rows x up to 8 output columns (column cg + 16 j) in fp32
// registers, 32-channel chunks, explicit __fmaf_rn (the library is built
// with -fmad=false, which would leave a * b + c unfused), so its products
// stay exact fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "func_attr.cuh"

namespace {

constexpr int kRows = 64;         // output rows per block
constexpr int kThreads = 256;
constexpr int kColGroups = 16;    // threads across the output columns
constexpr int kRowsPerThread = 4;  // kRows / (kThreads / kColGroups)
constexpr int kColsPerThread = 8;  // Cout <= kColGroups * kColsPerThread
constexpr int kMaxCout = kColGroups * kColsPerThread;
constexpr int kChunk = 32;        // input channels staged per step

// ---- fp32: SIMT ------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
sparse_conv_kernel(const float* __restrict__ feat, const int* __restrict__ idx,
                   const uint8_t* __restrict__ hit,
                   const float* __restrict__ w,
                   const uint8_t* __restrict__ valid, float* __restrict__ out,
                   int V, int Q, int K, int Cin, int Cout) {
  __shared__ float a_s[kRows][kChunk + 1];  // +1: rows 4 apart, other banks
  __shared__ float w_s[kChunk][kMaxCout];
  __shared__ int row_s[kRows];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int r0 = (tid / kColGroups) * kRowsPerThread;
  const size_t qbase = static_cast<size_t>(b) * Q;
  const float* feat_b = feat + static_cast<size_t>(b) * V * Cin;

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.0f;
  }

  int row_valid = 0;
  if (tid < kRows && q0 + tid < Q) row_valid = valid[qbase + q0 + tid];
  if (__syncthreads_or(row_valid)) {
    for (int k = 0; k < K; ++k) {
      int has = 0;
      if (tid < kRows) {
        int src = -1;
        const int q = q0 + tid;
        if (q < Q) {
          const size_t e = (qbase + q) * K + k;
          if (__ldg(hit + e)) src = __ldg(idx + e);
        }
        row_s[tid] = src;
        has = src >= 0;
      }
      if (!__syncthreads_or(has)) continue;  // uniform: no row hits at k
      bool mine = false;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) mine |= row_s[r0 + i] >= 0;
      const bool warp_live = __any_sync(0xffffffffu, mine);
      for (int c0 = 0; c0 < Cin; c0 += kChunk) {
        for (int e = tid; e < kRows * kChunk; e += kThreads) {
          const int r = e / kChunk;
          const int c = e % kChunk;
          const int src = row_s[r];
          float v = 0.0f;
          if (src >= 0 && c0 + c < Cin) {
            v = feat_b[static_cast<size_t>(src) * Cin + c0 + c];
          }
          a_s[r][c] = v;
        }
        for (int e = tid; e < kChunk * Cout; e += kThreads) {
          const int c = e / Cout;
          const int o = e % Cout;
          w_s[c][o] = c0 + c < Cin
              ? w[(static_cast<size_t>(k) * Cin + c0 + c) * Cout + o]
              : 0.0f;
        }
        __syncthreads();
        if (warp_live) {
          const int nc = min(kChunk, Cin - c0);
          for (int c = 0; c < nc; ++c) {
            float a[kRowsPerThread];
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i) a[i] = a_s[r0 + i][c];
#pragma unroll
            for (int j = 0; j < kColsPerThread; ++j) {
              const int o = cg + j * kColGroups;
              if (o < Cout) {
                const float wv = w_s[c][o];
#pragma unroll
                for (int i = 0; i < kRowsPerThread; ++i) {
                  acc[i][j] = __fmaf_rn(a[i], wv, acc[i][j]);
                }
              }
            }
          }
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int q = q0 + r0 + i;
    if (q >= Q) continue;
    const bool ok = valid[qbase + q] != 0;
    float* orow = out + (qbase + q) * Cout;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int o = cg + j * kColGroups;
      if (o < Cout) orow[o] = ok ? acc[i][j] : 0.0f;
    }
  }
}


// ---- bf16: tensor cores, pipelined gather ----------------------------------

constexpr int kTileRows = 128;        // output rows per tile: 8 warps x 16
constexpr int kGatherThreads = 256;
constexpr int kGroups = kTileRows / 16;
constexpr int kOffsetBlock = 32;      // offsets whose table a tile holds
constexpr int kTableBatch = 8;        // table entries a thread loads at once
constexpr int kSrcStride = kTileRows + 1;  // an offset's source rows, padded
constexpr int kMaxChunk = 64;         // input channels per step
constexpr int kStages = 2;            // ring stages
constexpr int kSmemLimit = 232448;    // a block's shared memory on sm_90
constexpr int kSmemPerSm = 228 * 1024;  // 1 KB of it reserved per block
// resident weights at most this large (padded): a block then loads no more
// weight bytes up front than its steps would stream (see plan())
constexpr int kResidentWeightBytes = 32 * 1024;
constexpr unsigned kFull = 0xffffffffu;

enum Variant { kSimt = 1, kResident = 2, kStreamed = 3 };

// The shapes of a launch, from (Cin, Cout, K): see plan().
struct Plan {
  int variant;
  int stages;
  int smem;     // dynamic shared memory, bytes
  int cin_pad;  // Cin rounded up to 16 (the mma depth)
  int astr;     // elements per gathered row in shared memory
  int wstr;     // elements per weight row in shared memory
};

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Blocks an SM for a kernel whose accumulators are NT n8 tiles (4 NT fp32
// registers a thread): the register budget of __launch_bounds__.
constexpr int blocks_per_sm(int NT) { return NT <= 4 ? 4 : NT <= 8 ? 3 : 2; }

// The accumulator tiles of the kernel that takes Cout (2, 4, 8 or 16).
int nt_of(int cout) {
  const int nt = (cout + 7) / 8;
  return nt <= 2 ? 2 : nt <= 4 ? 4 : nt <= 8 ? 8 : kMaxCout / 8;
}

// The rule: fp32 takes the SIMT kernel; bf16 keeps its weights resident
// when they take at most kResidentWeightBytes and fit beside the ring and
// the table in an SM's shared memory shared by as many blocks as the
// registers allow (blocks_per_sm), so that resident weights never cost a
// block an SM; else it streams them through the ring. On the H100 the
// resident SECOND layers with 20.7 KB of weights ran ~10 % faster than
// streamed; at 34.6 KB (16 -> 32) and 52 KB (the (3, 1, 1) z-conv, whose
// blocks take about one tile each) streaming was faster. `force` (a Variant, or 0) asks for one variant, which
// may use up to kSmemLimit; variant -1 means it does not fit.
Plan plan(int cin, int cout, int K, int dtype, int force) {
  Plan p = {-1, 0, 0, 0, 0, 0};
  if (dtype == 0) {
    if (force == 0 || force == kSimt) p.variant = kSimt;
    return p;
  }
  p.cin_pad = round_up(cin, 16);
  const int kc = p.cin_pad < kMaxChunk ? p.cin_pad : kMaxChunk;
  p.astr = kc + 8;
  p.wstr = round_up(cout, 8) + 8;
  const long long kb = K < kOffsetBlock ? K : kOffsetBlock;
  // source rows, live masks, hit counts, the offset list and its length,
  // the hit rows (bytes)
  const long long table = (kb * kSrcStride + 3 * kOffsetBlock + 1) * 4 +
      kb * kTileRows;
  const int resident_limit = kSmemPerSm / blocks_per_sm(nt_of(cout)) - 1024;
  const long long a_stage = kTileRows * p.astr * 2;
  const long long resident = static_cast<long long>(K) * p.cin_pad *
      p.wstr * 2 + kStages * a_stage + table;
  const long long streamed = kStages * (a_stage + kc * p.wstr * 2) + table;
  const long long weights = static_cast<long long>(K) * p.cin_pad * p.wstr *
      2;
  if ((force == 0 && resident <= resident_limit &&
       weights <= kResidentWeightBytes) || force == kResident) {
    if (resident > kSmemLimit) return p;
    p.variant = kResident;
    p.smem = static_cast<int>(resident);
  } else if (force == 0 || force == kStreamed) {
    if (streamed > kSmemLimit) return p;
    p.variant = kStreamed;
    p.smem = static_cast<int>(streamed);
  }
  p.stages = kStages;
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES from `src` into shared `dst`, of which the first `src_bytes` (0 or
// BYTES) are read and the rest zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
               :: "r"(smem_addr(dst)), "l"(src), "n"(BYTES), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// NT: n8 tiles of the output the accumulators hold (2, 4, 8 or 16: Cout up
// to 16, 32, 64, 128). PIECE: bytes a gather copy moves (16, 8 or 4 by
// cp.async; 2 by plain loads and stores), chosen by the host from Cin and
// the features' alignment. Shared memory, in order: the A ring (kStages x
// kTileRows x astr), the weights (resident: K * cin_pad rows; streamed:
// kStages x 64 rows, of wstr), the table (kb x kSrcStride source rows),
// the live masks, the hit counts, the offset list and its length, the hit
// rows of each offset (kb x kTileRows bytes).
template <bool RESIDENT, int PIECE, int NT>
__global__ void __launch_bounds__(kGatherThreads, blocks_per_sm(NT))
sparse_conv_gather_kernel(const __nv_bfloat16* __restrict__ feat,
                          const int* __restrict__ idx,
                          const uint8_t* __restrict__ hit,
                          const __nv_bfloat16* __restrict__ w,
                          const uint8_t* __restrict__ valid,
                          __nv_bfloat16* __restrict__ out, int V, int Q,
                          int K, int Cin, int Cout, int cin_pad, int astr,
                          int wstr, bool vec_w, int tiles_per_sample,
                          int n_tiles) {
  constexpr int S = kStages;
  constexpr int PE = PIECE / 2;  // bf16 elements per copy
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kc_max = cin_pad < kMaxChunk ? cin_pad : kMaxChunk;
  const int nch = (cin_pad + kMaxChunk - 1) / kMaxChunk;
  const int kb_max = K < kOffsetBlock ? K : kOffsetBlock;
  const int ntiles = (Cout + 7) / 8;
  const int cout8 = ntiles * 8;
  const int a_elems = kTileRows * astr;
  const int w_elems = RESIDENT ? K * cin_pad * wstr : kc_max * wstr;
  auto* a_ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w_s = a_ring + S * a_elems;
  auto* src_s = reinterpret_cast<int*>(w_s + (RESIDENT ? 1 : S) * w_elems);
  auto* live_s = reinterpret_cast<unsigned*>(src_s + kb_max * kSrcStride);
  int* cnt_s = reinterpret_cast<int*>(live_s + kOffsetBlock);
  int* list_s = cnt_s + kOffsetBlock;  // kOffsetBlock entries + the length
  auto* hit_rows = reinterpret_cast<uint8_t*>(list_s + kOffsetBlock + 1);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  // weight row r of chunk rows: W[k][c0 + r] (zeros past Cin and Cout)
  auto stage_w = [&](__nv_bfloat16* dst, int k, int c0, int rows) {
    const __nv_bfloat16* wk = w + (static_cast<size_t>(k) * Cin + c0) * Cout;
    if (vec_w) {  // Cout % 8 == 0, 16-byte aligned
      const int groups = cout8 / 8;
      for (int e = tid; e < rows * groups; e += kGatherThreads) {
        const int r = e / groups;
        const int o = (e % groups) * 8;
        const bool ok = c0 + r < Cin;
        const __nv_bfloat16* g = ok ? wk + static_cast<size_t>(r) * Cout + o
                                    : w;
        cp_async<16>(dst + r * wstr + o, g, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < rows * cout8; e += kGatherThreads) {
        const int r = e / cout8;
        const int o = e % cout8;
        dst[r * wstr + o] = c0 + r < Cin && o < Cout
            ? wk[static_cast<size_t>(r) * Cout + o] : zero;
      }
    }
  };

  if constexpr (RESIDENT) {  // in flight while the first table is read;
    // the first step's wait_group covers this oldest group
    for (int k = 0; k < K; ++k) {
      stage_w(w_s + static_cast<size_t>(k) * cin_pad * wstr, k, 0, cin_pad);
    }
    cp_async_commit();
  }

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[t][j] = 0.0f;
  }

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_sample;
    const int q0 = (tile % tiles_per_sample) * kTileRows;
    const size_t qbase = static_cast<size_t>(b) * Q;
    const __nv_bfloat16* feat_b = feat + static_cast<size_t>(b) * V * Cin;

    for (int k0 = 0; k0 < K; k0 += kOffsetBlock) {
      const int kb = K - k0 < kOffsetBlock ? K - k0 : kOffsetBlock;
      __syncthreads();  // the previous steps' readers are done
      // the table: row-major in memory, so consecutive threads read
      // consecutive entries; kTableBatch entries a thread at a time, their
      // valid, hit and idx loads independent (idx is read on a miss too)
      const int n_ent = kTileRows * kb;
      for (int e0 = tid; e0 < n_ent; e0 += kGatherThreads * kTableBatch) {
        int src[kTableBatch];
#pragma unroll
        for (int u = 0; u < kTableBatch; ++u) {
          const int e = e0 + u * kGatherThreads;
          const int q = q0 + e / kb;
          src[u] = -1;
          if (e < n_ent && q < Q) {
            const size_t ent = (qbase + q) * K + k0 + e % kb;
            const int x = __ldg(idx + ent);
            src[u] = __ldg(valid + qbase + q) & __ldg(hit + ent) ? x : -1;
          }
        }
#pragma unroll
        for (int u = 0; u < kTableBatch; ++u) {
          const int e = e0 + u * kGatherThreads;
          if (e < n_ent) src_s[(e % kb) * kSrcStride + e / kb] = src[u];
        }
      }
      __syncthreads();
      {  // per offset, the live 16-row groups as a mask and the hit rows
         // in order: thread (kk, g) takes rows 16g .. 16g + 15 of offset
         // kk, the 8 threads of an offset are 8 consecutive lanes
        const int kk = tid / kGroups;
        const int g = tid % kGroups;
        unsigned rows = 0u;
        if (kk < kb) {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            rows |= static_cast<unsigned>(
                src_s[kk * kSrcStride + g * 16 + i] >= 0) << i;
          }
        }
        const unsigned groups = __ballot_sync(kFull, rows != 0u);
        const int c = __popc(rows);
        int incl = c;
#pragma unroll
        for (int d = 1; d < kGroups; d <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, d, kGroups);
          if (g >= d) incl += v;
        }
        if (kk < kb) {
          uint8_t* dst = hit_rows + kk * kTileRows + incl - c;
          for (; rows; rows &= rows - 1u) *dst++ = g * 16 + __ffs(rows) - 1;
          if (g == kGroups - 1) {
            cnt_s[kk] = incl;
            live_s[kk] = (groups >> (lane & ~(kGroups - 1))) &
                         ((1u << kGroups) - 1u);
          }
        }
      }
      __syncthreads();
      if (warp == 0) {  // the offsets with a live group, in order
        const bool live = lane < kb && live_s[lane] != 0u;
        const unsigned mask = __ballot_sync(kFull, live);
        if (live) list_s[__popc(mask & ((1u << lane) - 1u))] = lane;
        if (lane == 0) list_s[kOffsetBlock] = __popc(mask);
      }
      __syncthreads();
      const int n_steps = list_s[kOffsetBlock] * nch;

      // step m: offset list_s[m / nch], channels from (m % nch) * 64
      auto issue = [&](int m) {
        const int kk = list_s[m / nch];
        const int c0 = (m % nch) * kMaxChunk;
        const int kc = cin_pad - c0 < kMaxChunk ? cin_pad - c0 : kMaxChunk;
        const int* srcs = src_s + kk * kSrcStride;
        const uint8_t* rows = hit_rows + kk * kTileRows;
        __nv_bfloat16* a = a_ring + (m % S) * a_elems;
        const int ppr = kc / PE;  // copies per row
        // the hit rows only: a miss is not copied, its A fragment is masked
        const int n_copies = cnt_s[kk] * ppr;
        for (int e = tid; e < n_copies; e += kGatherThreads) {
          const int r = rows[e / ppr];
          const int src = srcs[r];
          const int col = c0 + (e % ppr) * PE;
          const bool ok = col < Cin;  // else a zero pad column
          const __nv_bfloat16* g =
              ok ? feat_b + static_cast<size_t>(src) * Cin + col : feat_b;
          __nv_bfloat16* d = a + r * astr + col - c0;
          if constexpr (PIECE >= 4) {
            cp_async<PIECE>(d, g, ok ? PIECE : 0);
          } else {
            *d = ok ? *g : zero;
          }
        }
        if constexpr (!RESIDENT) {
          stage_w(w_s + (m % S) * w_elems, k0 + kk, c0, kc);
        }
      };

      for (int m = 0; m < S - 1; ++m) {
        if (m < n_steps) issue(m);
        cp_async_commit();
      }
      for (int n = 0; n < n_steps; ++n) {
        cp_async_wait<S - 2>();
        __syncthreads();  // step n's rows are in; step n - 1's slot is free
        if (n + S - 1 < n_steps) issue(n + S - 1);
        cp_async_commit();
        const int kk = list_s[n / nch];
        if (!((live_s[kk] >> warp) & 1u)) continue;
        // this lane's two A rows (fragments a0/a2 and a1/a3); a miss was
        // not copied, so its stale shared-memory row is masked here
        const int* rows = src_s + kk * kSrcStride + warp * 16 + lane / 4;
        const uint32_t m0 = rows[0] >= 0 ? kFull : 0u;
        const uint32_t m1 = rows[8] >= 0 ? kFull : 0u;
        const int c0 = (n % nch) * kMaxChunk;
        const int kc = cin_pad - c0 < kMaxChunk ? cin_pad - c0 : kMaxChunk;
        const __nv_bfloat16* a = a_ring + (n % S) * a_elems;
        const __nv_bfloat16* wb = RESIDENT
            ? w_s + (static_cast<size_t>(k0 + kk) * cin_pad + c0) * wstr
            : w_s + (n % S) * w_elems;
        for (int kq = 0; kq < kc; kq += 16) {
          uint32_t a0, a1, a2, a3;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
              "[%4];\n"
              : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
              : "r"(smem_addr(a + (warp * 16 + (lane & 15)) * astr + kq
                              + (lane >> 4) * 8)));
          a0 &= m0;
          a1 &= m1;
          a2 &= m0;
          a3 &= m1;
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            if (t < ntiles) {
              uint32_t b0, b1;
              asm volatile(
                  "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 "
                  "{%0,%1}, [%2];\n"
                  : "=r"(b0), "=r"(b1)
                  : "r"(smem_addr(wb + (kq + (lane & 15)) * wstr + t * 8)));
              asm volatile(
                  "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                  "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
                  "{%0,%1,%2,%3};\n"
                  : "+f"(acc[t][0]), "+f"(acc[t][1]), "+f"(acc[t][2]),
                    "+f"(acc[t][3])
                  : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
            }
          }
        }
      }
      cp_async_wait<0>();
    }

    // accumulator (t, j): row warp*16 + lane/4 (+8 for j >= 2), column
    // t*8 + 2*(lane%4) + (j & 1)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = q0 + warp * 16 + lane / 4 + half * 8;
      if (q >= Q) continue;
      const bool ok = valid[qbase + q] != 0;
      __nv_bfloat16* orow = out + (qbase + q) * Cout;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (t >= ntiles) continue;
        const int o = t * 8 + 2 * (lane % 4);
        const float v0 = ok ? acc[t][half * 2] : 0.0f;
        const float v1 = ok ? acc[t][half * 2 + 1] : 0.0f;
        if (Cout % 2 == 0) {  // o even: a 4-byte aligned pair
          if (o < Cout) {
            *reinterpret_cast<__nv_bfloat162*>(orow + o) =
                __floats2bfloat162_rn(v0, v1);
          }
        } else {
          if (o < Cout) orow[o] = __float2bfloat16_rn(v0);
          if (o + 1 < Cout) orow[o + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[t][j] = 0.0f;
    }
  }
}

int last_variant = 0;  // the variant of the last launch, for the wrapper

template <bool RESIDENT, int PIECE, int NT>
cudaError_t launch_gather(const Plan& p, const void* feat, const void* idx,
                          const void* hit, const void* w, const void* valid,
                          void* out, int B, int V, int Q, int K, int Cin,
                          int Cout, bool vec_w, cudaStream_t s) {
  auto kernel = sparse_conv_gather_kernel<RESIDENT, PIECE, NT>;
  // the attribute once per device (func_attr.cuh), the occupancy query
  // once per shared-memory size
  cudaError_t err = de6d::max_dynamic_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  static int cached_smem = -1, sms = 0, per_sm = 0;
  if (cached_smem != p.smem) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kGatherThreads, p.smem);
    }
    if (err != cudaSuccess) return err;
    cached_smem = p.smem;
  }
  const int tiles_per_sample = (Q + kTileRows - 1) / kTileRows;
  const int n_tiles = B * tiles_per_sample;
  const int resident_blocks = sms * (per_sm > 0 ? per_sm : 1);
  const int grid = n_tiles < resident_blocks ? n_tiles : resident_blocks;
  kernel<<<grid, kGatherThreads, p.smem, s>>>(
      static_cast<const __nv_bfloat16*>(feat), static_cast<const int*>(idx),
      static_cast<const uint8_t*>(hit),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const uint8_t*>(valid), static_cast<__nv_bfloat16*>(out),
      V, Q, K, Cin, Cout, p.cin_pad, p.astr, p.wstr, vec_w, tiles_per_sample,
      n_tiles);
  return cudaGetLastError();
}

// the kernel for (variant, copy size, accumulator tiles)
template <bool RESIDENT, int PIECE>
cudaError_t launch_gather_nt(const Plan& p, const void* feat, const void* idx,
                             const void* hit, const void* w,
                             const void* valid, void* out, int B, int V,
                             int Q, int K, int Cin, int Cout, bool vec_w,
                             cudaStream_t s) {
  const int nt = nt_of(Cout);
  if (nt <= 2) {
    return launch_gather<RESIDENT, PIECE, 2>(p, feat, idx, hit, w, valid,
                                             out, B, V, Q, K, Cin, Cout,
                                             vec_w, s);
  }
  if (nt <= 4) {
    return launch_gather<RESIDENT, PIECE, 4>(p, feat, idx, hit, w, valid,
                                             out, B, V, Q, K, Cin, Cout,
                                             vec_w, s);
  }
  if (nt <= 8) {
    return launch_gather<RESIDENT, PIECE, 8>(p, feat, idx, hit, w, valid,
                                             out, B, V, Q, K, Cin, Cout,
                                             vec_w, s);
  }
  return launch_gather<RESIDENT, PIECE, kMaxCout / 8>(
      p, feat, idx, hit, w, valid, out, B, V, Q, K, Cin, Cout, vec_w, s);
}

template <bool RESIDENT>
cudaError_t launch_gather_piece(int piece, const Plan& p, const void* feat,
                                const void* idx, const void* hit,
                                const void* w, const void* valid, void* out,
                                int B, int V, int Q, int K, int Cin, int Cout,
                                bool vec_w, cudaStream_t s) {
  switch (piece) {
    case 16:
      return launch_gather_nt<RESIDENT, 16>(p, feat, idx, hit, w, valid, out,
                                            B, V, Q, K, Cin, Cout, vec_w, s);
    case 8:
      return launch_gather_nt<RESIDENT, 8>(p, feat, idx, hit, w, valid, out,
                                           B, V, Q, K, Cin, Cout, vec_w, s);
    case 4:
      return launch_gather_nt<RESIDENT, 4>(p, feat, idx, hit, w, valid, out,
                                           B, V, Q, K, Cin, Cout, vec_w, s);
    default:
      return launch_gather_nt<RESIDENT, 2>(p, feat, idx, hit, w, valid, out,
                                           B, V, Q, K, Cin, Cout, vec_w, s);
  }
}


// ---- backward: the weight gradient and the table transpose ----------------
//
// The data gradient is the forward kernel itself on a transposed table
// (ops/kernels/sparse_conv.py:sparse_conv_dgrad). The weight gradient
//
//   dW[k] = sum over (b, q) with hit[b, q, k] and valid[b, q] of
//           feat[b, idx[b, q, k]]^T (x) dy[b, q]          (Cin x Cout)
//
// has no TPU kernel behind it (JAX differentiates the XLA gather-GEMM); it
// is the port's own, so that the convolution trains on the card. Bound:
// bytes (the table once, the referenced feature rows, dy's valid rows,
// dW written once) against 2 * Cin * Cout operations per live pair, which
// on SECOND's layers is a few hundred MFLOP, far below the fp32 SIMT rate.
// A simple design that is right, deterministic and without atomics:
//   * one block per (Cin x Cout tile of 64 x 64, offset k, slice of rows);
//     256 threads, each 4 x 4 fp32 accumulators (input channel ty + 16 i,
//     output channel tx + 16 j: a warp reads two input and 16 consecutive
//     output channels from shared memory, no bank conflicts);
//   * the block scans its slice 256 candidate rows at a time, compacts the
//     live ones (a ballot and a prefix over the 8 warps, in row order), and
//     gathers 32 of them at a time into shared memory (feature rows by idx,
//     dy rows), as fp32; the products are explicit __fmaf_rn in row order;
//   * each block writes its partial sums; a second kernel adds the slices
//     in slice order and rounds once to the features' dtype. Two runs give
//     bit-equal gradients.
// Tensor cores, TMA and wgmma are not used: later work.
constexpr int kWgTile = 64;      // channels of a block's tile, each side
constexpr int kWgThreads = 256;  // 16 x 16
constexpr int kWgScan = 256;     // candidate rows scanned at once
constexpr int kWgRows = 32;      // live rows staged at once
constexpr int kWgPer = 4;        // accumulators a thread, each side

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kWgThreads)
sparse_conv_wgrad_kernel(const T* __restrict__ feat, const T* __restrict__ dy,
                         const int* __restrict__ idx,
                         const uint8_t* __restrict__ hit,
                         const uint8_t* __restrict__ valid,
                         float* __restrict__ partial, int V, int Q, int K,
                         int Cin, int Cout, int co_tiles, long long rows,
                         long long rows_per_slice) {
  __shared__ float xs[kWgRows][kWgTile];
  __shared__ float ds[kWgRows][kWgTile];
  __shared__ long long src_s[kWgScan];  // feature row (b * V + idx)
  __shared__ long long dst_s[kWgScan];  // dy row (b * Q + q)
  __shared__ int warp_n[kWgThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  const int ci0 = (blockIdx.x / co_tiles) * kWgTile;
  const int co0 = (blockIdx.x % co_tiles) * kWgTile;
  const int k = blockIdx.y;
  const long long begin = blockIdx.z * rows_per_slice;
  const long long end = begin + rows_per_slice < rows ? begin + rows_per_slice
                                                      : rows;
  float acc[kWgPer][kWgPer];
#pragma unroll
  for (int i = 0; i < kWgPer; ++i) {
#pragma unroll
    for (int j = 0; j < kWgPer; ++j) acc[i][j] = 0.0f;
  }
  for (long long base = begin; base < end; base += kWgScan) {
    const long long r = base + tid;
    bool live = false;
    long long src = 0;
    if (r < end && valid[r]) {
      const long long e = r * K + k;
      if (hit[e]) {
        live = true;
        src = (r / Q) * V + idx[e];
      }
    }
    const unsigned ballot = __ballot_sync(kFull, live);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, n_live = 0;
#pragma unroll
    for (int w = 0; w < kWgThreads / 32; ++w) {
      offset += w < warp ? warp_n[w] : 0;
      n_live += warp_n[w];
    }
    if (live) {
      const int at = offset + __popc(ballot & ((1u << lane) - 1u));
      src_s[at] = src;
      dst_s[at] = r;
    }
    __syncthreads();
    for (int c0 = 0; c0 < n_live; c0 += kWgRows) {
      const int n = n_live - c0 < kWgRows ? n_live - c0 : kWgRows;
      for (int e = tid; e < kWgRows * kWgTile; e += kWgThreads) {
        const int rr = e / kWgTile, c = e % kWgTile;
        float x = 0.0f, d = 0.0f;
        if (rr < n) {
          if (ci0 + c < Cin) x = to_f32(feat[src_s[c0 + rr] * Cin + ci0 + c]);
          if (co0 + c < Cout) d = to_f32(dy[dst_s[c0 + rr] * Cout + co0 + c]);
        }
        xs[rr][c] = x;
        ds[rr][c] = d;
      }
      __syncthreads();
      for (int rr = 0; rr < n; ++rr) {
        float a[kWgPer], bv[kWgPer];
#pragma unroll
        for (int i = 0; i < kWgPer; ++i) a[i] = xs[rr][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kWgPer; ++j) bv[j] = ds[rr][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kWgPer; ++i) {
#pragma unroll
          for (int j = 0; j < kWgPer; ++j) {
            acc[i][j] = __fmaf_rn(a[i], bv[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
  }
  float* out = partial + (static_cast<size_t>(blockIdx.z) * K + k) * Cin * Cout;
#pragma unroll
  for (int i = 0; i < kWgPer; ++i) {
    const int ci = ci0 + ty + 16 * i;
    if (ci >= Cin) continue;
#pragma unroll
    for (int j = 0; j < kWgPer; ++j) {
      const int co = co0 + tx + 16 * j;
      if (co < Cout) out[static_cast<size_t>(ci) * Cout + co] = acc[i][j];
    }
  }
}

// dW = the slices' partial sums added in slice order, rounded once
template <typename T>
__global__ void sparse_conv_wgrad_reduce(const float* __restrict__ partial,
                                         T* __restrict__ dw, int slices,
                                         int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int t = 0; t < slices; ++t) {
    s = __fadd_rn(s, partial[static_cast<size_t>(t) * n + i]);
  }
  from_f32(s, dw + i);
}

// The transpose of a strided layer's table: for each live pair (q, k),
// tidx[b, idx[b, q, k], k] = q and thit there 1, and tvalid[b, v] = 1 for
// every input row v that a live pair references. For a fixed k the map
// q -> idx is injective (distinct outputs, one offset), so no two pairs
// write one entry. One thread per (b, q, k); bytes-bound.
__global__ void sparse_conv_transpose_kernel(
    const int* __restrict__ idx, const uint8_t* __restrict__ hit,
    const uint8_t* __restrict__ valid, int* __restrict__ tidx,
    uint8_t* __restrict__ thit, uint8_t* __restrict__ tvalid, int V, int Q,
    int K, long long total) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (e >= total) return;
  const long long r = e / K;  // b * Q + q
  if (!hit[e] || !valid[r]) return;
  const int v = idx[e];
  if (v < 0 || v >= V) return;
  const long long row = (r / Q) * V + v;
  const long long t = row * K + e % K;
  tidx[t] = static_cast<int>(r % Q);
  thit[t] = 1;
  tvalid[row] = 1;
}

}  // namespace

// The plan for (Cin, Cout, K) in dtype 0 (fp32) or 1 (bf16), or the forced
// variant `force` (1 simt, 2 resident, 3 streamed; 0: the rule): writes
// {variant, stages, dynamic shared memory bytes} to info and returns the
// variant, or -1 where that variant does not take the shape.
extern "C" int de6d_sparse_conv_plan(int Cin, int Cout, int K, int dtype,
                                     int force, int* info) {
  if (Cin < 1 || Cout < 1 || Cout > kMaxCout || K < 1) return -1;
  const Plan p = plan(Cin, Cout, K, dtype, force);
  info[0] = p.variant;
  info[1] = p.stages;
  info[2] = p.smem;
  return p.variant;
}

// The variant of the last de6d_sparse_conv launch in this process.
extern "C" int de6d_sparse_conv_last_variant() { return last_variant; }

// feat (B, V, Cin), idx (B, Q, K) int32, hit (B, Q, K) uint8, w (K, Cin,
// Cout), valid (B, Q) uint8 -> out (B, Q, Cout); feat, w and out are fp32
// (dtype 0) or bf16 (dtype 1). `force` as for de6d_sparse_conv_plan.
// Returns a cudaError_t.
extern "C" int de6d_sparse_conv(const void* feat, const void* idx,
                                const void* hit, const void* w,
                                const void* valid, void* out, int B, int V,
                                int Q, int K, int Cin, int Cout, int dtype,
                                int force, void* stream) {
  if (B < 0 || V < 1 || Q < 0 || K < 1 || Cin < 1 || Cout < 1 ||
      Cout > kMaxCout || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = plan(Cin, Cout, K, dtype, force);
  if (p.variant < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Q == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  last_variant = p.variant;
  if (p.variant == kSimt) {
    const dim3 grid((Q + kRows - 1) / kRows, B);
    sparse_conv_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(feat), static_cast<const int*>(idx),
        static_cast<const uint8_t*>(hit), static_cast<const float*>(w),
        static_cast<const uint8_t*>(valid), static_cast<float*>(out), V, Q,
        K, Cin, Cout);
    return static_cast<int>(cudaGetLastError());
  }
  const auto aligned = [](const void* ptr, int bytes) {
    return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
  };
  int piece = 2;
  for (int c = 16; c >= 4; c /= 2) {
    if ((Cin * 2) % c == 0 && aligned(feat, c)) {
      piece = c;
      break;
    }
  }
  const bool vec_w = Cout % 8 == 0 && aligned(w, 16);
  const cudaError_t err = p.variant == kResident
      ? launch_gather_piece<true>(piece, p, feat, idx, hit, w, valid, out, B,
                                  V, Q, K, Cin, Cout, vec_w, s)
      : launch_gather_piece<false>(piece, p, feat, idx, hit, w, valid, out,
                                   B, V, Q, K, Cin, Cout, vec_w, s);
  return static_cast<int>(err);
}

// The weight gradient: feat (B, V, Cin), dy (B, Q, Cout) of the features'
// dtype (0 fp32, 1 bf16), the forward's idx / hit (B, Q, K) and valid
// (B, Q) -> dw (K, Cin, Cout) in that dtype, through `partial` (slices, K,
// Cin, Cout) fp32 scratch: slice s takes rows [s * rows_per_slice, ...) of
// the B * Q rows. Returns a cudaError_t.
extern "C" int de6d_sparse_conv_wgrad(const void* feat, const void* dy,
                                      const void* idx, const void* hit,
                                      const void* valid, void* partial,
                                      void* dw, int B, int V, int Q, int K,
                                      int Cin, int Cout, int slices,
                                      long long rows_per_slice, int dtype,
                                      void* stream) {
  const long long rows = static_cast<long long>(B) * Q;
  if (B < 1 || V < 1 || Q < 1 || K < 1 || Cin < 1 || Cout < 1 ||
      slices < 1 || slices > 65535 || K > 65535 || rows_per_slice < 1 ||
      (slices - 1) * rows_per_slice >= rows || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int co_tiles = (Cout + kWgTile - 1) / kWgTile;
  const dim3 grid(((Cin + kWgTile - 1) / kWgTile) * co_tiles, K, slices);
  auto* part = static_cast<float*>(partial);
  const int n = K * Cin * Cout;
  const int blocks = (n + 255) / 256;
  if (dtype == 0) {
    sparse_conv_wgrad_kernel<float><<<grid, kWgThreads, 0, s>>>(
        static_cast<const float*>(feat), static_cast<const float*>(dy),
        static_cast<const int*>(idx), static_cast<const uint8_t*>(hit),
        static_cast<const uint8_t*>(valid), part, V, Q, K, Cin, Cout,
        co_tiles, rows, rows_per_slice);
    sparse_conv_wgrad_reduce<float><<<blocks, 256, 0, s>>>(
        part, static_cast<float*>(dw), slices, n);
  } else {
    sparse_conv_wgrad_kernel<__nv_bfloat16><<<grid, kWgThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feat),
        static_cast<const __nv_bfloat16*>(dy), static_cast<const int*>(idx),
        static_cast<const uint8_t*>(hit), static_cast<const uint8_t*>(valid),
        part, V, Q, K, Cin, Cout, co_tiles, rows, rows_per_slice);
    sparse_conv_wgrad_reduce<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        part, static_cast<__nv_bfloat16*>(dw), slices, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// The transpose of the table idx / hit (B, Q, K) over the valid (B, Q)
// rows onto V input rows: tidx (B, V, K) int32 (0 where no pair), thit
// (B, V, K) and tvalid (B, V) uint8. Returns a cudaError_t.
extern "C" int de6d_sparse_conv_transpose(const void* idx, const void* hit,
                                          const void* valid, void* tidx,
                                          void* thit, void* tvalid, int B,
                                          int V, int Q, int K, void* stream) {
  if (B < 0 || V < 1 || Q < 0 || K < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t entries = static_cast<size_t>(B) * V * K;
  cudaError_t err = cudaMemsetAsync(tidx, 0, entries * sizeof(int), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(thit, 0, entries, s);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(tvalid, 0, static_cast<size_t>(B) * V, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(B) * Q * K;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  sparse_conv_transpose_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                                 s>>>(
      static_cast<const int*>(idx), static_cast<const uint8_t*>(hit),
      static_cast<const uint8_t*>(valid), static_cast<int*>(tidx),
      static_cast<uint8_t*>(thit), static_cast<uint8_t*>(tvalid), V, Q, K,
      total);
  return static_cast<int>(cudaGetLastError());
}
