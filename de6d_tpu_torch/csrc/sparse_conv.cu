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
// Bound: bytes for bf16, operations for fp32 on SECOND's layers. The
// function must read hit for every (q, k) of a valid row, idx where it
// hits, the referenced feature rows and the weights once and write the
// output once; it does 2 * Cin * Cout operations per hit, a few hundred
// MFLOP per layer. The first kernels walked the 27 offsets of a 64-row
// block one after another, each a dependent round trip for the table,
// another for the gather, W[k] restaged from L2 and two block barriers:
// bf16 took ~27x its bound, fp32 ~31x (and lost to one gather plus one
// cuBLAS product on 8 of SECOND's 12 layers).
//
// One kernel, sparse_conv_gather_kernel<T, ...>, for both types: a shared
// front end feeds a tensor-core back end (bf16) or a SIMT one (fp32).
// 256 threads, 8 warps of 16 rows: a tile is kTileRows = 128 output rows
// of one sample; blocks are persistent (as many as fit on the card at
// once) and walk the tiles.
//   * Per tile and block of up to 32 offsets, the (rows x offsets) table is
//     read once, coalesced, eight entries a thread with independent loads,
//     as source row or -1 (a miss, or a row that is not valid) into shared
//     memory. The MIRROR instantiations read column K-1-k at offset k (a
//     submanifold layer's data gradient on the forward's own table, which
//     is its transpose through the mirrored offsets: bit-equal to the
//     kernel on the scattered transpose, with no table built) and raise a
//     fault word where the table breaks that contract; the forward's own
//     instantiations hold neither. One pass over it
//     gives, per offset, the live 16-row groups as a bit mask and the hit
//     rows in order (a prefix sum over the 8 lanes of an offset); warp 0
//     lists the offsets with a hit. A step is one
//     (live offset, chunk of channels: 64 bf16, 32 fp32); an offset without
//     a hit in the tile costs nothing.
//   * A 2-stage ring of gathered rows, filled by cp.async (16, 8 or 4 bytes
//     a copy, the widest that the rows' size and alignment allow; 2-byte
//     rows take plain loads): the next step's copies are in flight while
//     the current one is multiplied, one __syncthreads a step. Only hit
//     rows are copied; a miss leaves a stale row in the ring that is never
//     used (bf16 zeroes its A fragment registers after ldmatrix, fp32 reads
//     a row of zeros instead), and a warp without a hit row at the step
//     skips it.
//   * Weights: resident for the block's life when K * Cin_pad * wstr bytes
//     fit beside the ring and the table without costing a block an SM and
//     take at most kResidentWeightBytes (plan()); otherwise each step's
//     W[k] chunk travels in the ring beside its rows, by cp.async from L2.
//     plan() is mirrored by ops/kernels/sparse_conv.py:plan; the library
//     reports the variant it launched.
//   * Accumulators are sized by Cout (NT = 2, 4, 8 or 16 n8 tiles: 4 NT
//     fp32 registers a thread either way), so that narrow layers run more
//     blocks an SM (bf16: 4 up to Cout 32, 3 up to 64, 2 up to 128; fp32:
//     3 up to 32, then 2).
// bf16 back end (variants "resident" / "streamed"): ldmatrix fragments from
// padded shared-memory rows and mma.sync m16n8k16 bf16 x bf16 -> fp32, each
// warp 16 rows x all Cout columns. bf16 products are exact in fp32, so only
// the order of the fp32 sums differs from the plain version's.
// fp32 back end (variant "simt"): a warp owns the tile's rows warp + 8 m
// (m < 16), interleaved so that a step's hit rows, which cluster in
// sorted-key order, spread over all 8 warps; its 32 lanes split the Cout
// columns (below 32 columns, 2 rows side by side), each lane holding its
// rows x columns in registers. Per step a ballot gives the warp's hit
// rows; per 8 channels (4 at Cout > 64) the lane loads its weights once
// and takes its rows by quads: a quad without a hit is skipped, the others
// are multiplied densely (a missed row is read from a row of zeros), 4 x
// TC independent chains of explicit __fmaf_rn (the library is built with
// -fmad=false). The sum of each output element is the same sequence of
// FMAs as a dense walk (live offsets ascending, then input channels
// ascending; a miss adds fma(0, w, acc) == acc, and so do the zero pad
// channels), so fp32 outputs round exactly as the first kernel's did and
// equal the plain version on SECOND's layers. No tensor cores: TF32
// misses the fp32 train tolerance and 3xTF32 changes every output's
// rounding.
// What the H100 showed for fp32 (sparse_conv_ab.py, parent and copies of
// this kernel in turns in one call): SECOND's 12 forwards at batch 8 in
// 1.78-1.81 ms against the first kernel's 6.60-6.62 (bound 0.21, operations),
// every layer below its plain version; skipping single rows (a
// branch or a switch per row) left each row's loads and FMA chain
// serialised and lost to dense quads; interleaving the rows and the
// contiguous 16-row groups ran alike; 3 ring stages or 16-channel chunks
// changed little; the bf16 register budgets spilled (hence blocks_per_sm's
// fp32 budget); 8-channel passes instead of 4 gained ~13 %. With its
// products removed the kernel keeps ~30 % of its time: the FMA loop is
// what holds it.
// What the H100 showed for bf16 (chip_smoke.py's per-layer times, and
// experiments on copies of this kernel that were not kept): the layers are
// held by the SM's issue of many small operations (the gather copies, the
// dense 16-row MMAs, the streamed weight copies, in that order of cost),
// not by memory latency (4 or 8 ring stages instead of 2 changed nothing)
// nor by bytes. So occupancy decides: a resident block that held an SM
// alone (32 -> 32, 124 KB) took 1.5x the streamed one, and sizing the
// accumulators by Cout gave the largest single gain. Tried and dropped:
// compacting each step's hit rows into dense MMA groups with fp32
// accumulators in shared memory (MMA rows per hit 3.25 -> ~1.2 on the
// SECOND fixture, sparse_conv.tile_stats) was no faster; one TMA bulk copy
// per gathered row was slower (12 layers 1.17 against 0.82 ms): rows of 32
// to 128 bytes cost the copy engine more per request than cp.async costs;
// 64-row tiles (4 warps) and cp.async.cg changed nothing. Not built: wgmma
// (the layers are not held by the tensor cores' rate).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "func_attr.cuh"

namespace {

constexpr int kMaxCout = 128;
constexpr int kTileRows = 128;        // output rows per tile: 8 warps x 16
constexpr int kGatherThreads = 256;
constexpr int kGroups = kTileRows / 16;
constexpr int kOffsetBlock = 32;      // offsets whose table a tile holds
constexpr int kTableBatch = 8;        // table entries a thread loads at once
constexpr int kSrcStride = kTileRows + 1;  // an offset's source rows, padded
constexpr int kChunkBf16 = 64;        // input channels per step, bf16
constexpr int kChunkF32 = 32;         // input channels per step, fp32
constexpr int kZeroRowBytes = kChunkF32 * 4;  // fp32: a row of zeros
constexpr int kStages = 2;            // ring stages
constexpr int kSmemLimit = 232448;    // a block's shared memory on sm_90
constexpr int kSmemPerSm = 228 * 1024;  // 1 KB of it reserved per block
// resident weights at most this large (padded): a block then loads no more
// weight bytes up front than its steps would stream (see plan())
constexpr int kResidentWeightBytes = 32 * 1024;
constexpr unsigned kFull = 0xffffffffu;

enum Variant { kSimt = 1, kResident = 2, kStreamed = 3 };

// The shapes of a launch, from (Cin, Cout, K, dtype): see plan().
struct Plan {
  int variant;
  int resident;  // weights resident in shared memory for the block's life
  int stages;
  int smem;     // dynamic shared memory, bytes
  int cin_pad;  // Cin rounded up to 16 (bf16: the mma depth) or 8 (fp32)
  int astr;     // elements per gathered row in shared memory
  int wstr;     // elements per weight row in shared memory
};

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Blocks an SM for a kernel whose accumulators are NT n8 tiles (4 NT fp32
// registers a thread): the register budget of __launch_bounds__. The fp32
// back end also holds a quad's 16 gathered values and its weights, and
// spilled at the bf16 budgets (64 and 80 registers); at these it does not.
constexpr int blocks_per_sm(int NT, bool f32) {
  return f32 ? (NT <= 4 ? 3 : 2) : NT <= 4 ? 4 : NT <= 8 ? 3 : 2;
}

// The accumulator tiles of the kernel that takes Cout (2, 4, 8 or 16).
int nt_of(int cout) {
  const int nt = (cout + 7) / 8;
  return nt <= 2 ? 2 : nt <= 4 ? 4 : nt <= 8 ? 8 : kMaxCout / 8;
}

// The rule, the same for both dtypes: weights stay resident when they take
// at most kResidentWeightBytes and fit beside the ring and the table in an
// SM's shared memory shared by as many blocks as the registers allow
// (blocks_per_sm), so that resident weights never cost a block an SM; else
// they stream through the ring. bf16 names the two "resident" and
// "streamed"; fp32 is "simt" either way (on SECOND, in both dtypes, stage
// 1's layers keep theirs resident). On the H100 the resident bf16 SECOND
// layers with 20.7 KB of weights ran ~10 % faster than streamed; at 34.6 KB
// (16 -> 32) and 52 KB (the (3, 1, 1) z-conv, whose blocks take about one
// tile each) streaming was faster. `force` (a Variant, or 0) asks for one
// bf16 variant, which may use up to kSmemLimit; variant -1 means it does
// not take the shape.
Plan plan(int cin, int cout, int K, int dtype, int force) {
  Plan p = {-1, 0, 0, 0, 0, 0, 0};
  const bool f32 = dtype == 0;
  if (f32 ? force != 0 && force != kSimt : force == kSimt) return p;
  const int esize = f32 ? 4 : 2;
  p.cin_pad = round_up(cin, f32 ? 8 : 16);
  const int chunk = f32 ? kChunkF32 : kChunkBf16;
  const int kc = p.cin_pad < chunk ? p.cin_pad : chunk;
  p.astr = kc + (f32 ? 4 : 8);
  p.wstr = f32 ? 8 * nt_of(cout) : round_up(cout, 8) + 8;
  const long long kb = K < kOffsetBlock ? K : kOffsetBlock;
  // source rows, live masks, hit counts, the offset list and its length,
  // the hit rows (bytes)
  const long long table = (kb * kSrcStride + 3 * kOffsetBlock + 1) * 4 +
      kb * kTileRows + (f32 ? kZeroRowBytes : 0);
  const int resident_limit =
      kSmemPerSm / blocks_per_sm(nt_of(cout), f32) - 1024;
  const long long a_stage = static_cast<long long>(kTileRows) * p.astr *
      esize;
  const long long weights = static_cast<long long>(K) * p.cin_pad * p.wstr *
      esize;
  const long long resident = weights + kStages * a_stage + table;
  const long long streamed = kStages * (a_stage + static_cast<long long>(kc) *
      p.wstr * esize) + table;
  const bool fits = resident <= resident_limit &&
      weights <= kResidentWeightBytes;
  p.stages = kStages;
  if (f32) {
    p.variant = kSimt;
    p.resident = fits;
    p.smem = static_cast<int>(fits ? resident : streamed);
    return p;  // streamed fp32 takes at most ~88 KB
  }
  if ((force == 0 && fits) || force == kResident) {
    if (resident > kSmemLimit) return p;
    p.variant = kResident;
    p.resident = 1;
    p.smem = static_cast<int>(resident);
  } else if (force == 0 || force == kStreamed) {
    if (streamed > kSmemLimit) return p;
    p.variant = kStreamed;
    p.smem = static_cast<int>(streamed);
  }
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

template <typename T>
__device__ __forceinline__ T zero_of() {
  if constexpr (std::is_same<T, float>::value) {
    return 0.0f;
  } else {
    return __float2bfloat16_rn(0.0f);
  }
}

// N consecutive values from shared memory as fp32, in the widest loads
// their alignment (N * sizeof(T) bytes) allows.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int u = 0; u < N; u += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + u);
      out[u] = v.x;
      out[u + 1] = v.y;
      out[u + 2] = v.z;
      out[u + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int u = 0; u < N; u += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + u);
      out[u] = v.x;
      out[u + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int u = 0; u < N; ++u) out[u] = p[u];
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p,
                                         float* out) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int u = 0; u < N; u += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + u);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&words[h]));
        out[u + 2 * h] = f.x;
        out[u + 2 * h + 1] = f.y;
      }
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int u = 0; u < N; u += 2) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p + u));
      out[u] = f.x;
      out[u + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int u = 0; u < N; ++u) out[u] = __bfloat162float(p[u]);
  }
}

// Compress the even bits of a 16-bit mask into its low 8 bits.
__device__ __forceinline__ unsigned even_bits(unsigned x) {
  x &= 0x5555u;
  x = (x | (x >> 1)) & 0x3333u;
  x = (x | (x >> 2)) & 0x0f0fu;
  return (x | (x >> 4)) & 0x00ffu;
}

// T: float (the SIMT back end) or __nv_bfloat16 (the tensor cores). NT: n8
// tiles of the output the accumulators hold (2, 4, 8 or 16: Cout up to 16,
// 32, 64, 128). PIECE: bytes a gather copy moves (16, 8 or 4 by cp.async;
// 2 by plain loads and stores, bf16 only), chosen by the host from Cin and
// the features' alignment. Shared memory, in order: fp32's row of zeros
// (kZeroRowBytes), the A ring (kStages x
// kTileRows x astr), the weights (resident: K * cin_pad rows; streamed:
// kStages x chunk rows, of wstr), the table (kb x kSrcStride source rows),
// the live masks, the hit counts, the offset list and its length, the hit
// rows of each offset (kb x kTileRows bytes).
template <typename T, bool RESIDENT, int PIECE, int NT, bool MIRROR>
__global__ void __launch_bounds__(
    kGatherThreads, blocks_per_sm(NT, std::is_same<T, float>::value))
sparse_conv_gather_kernel(const T* __restrict__ feat,
                          const int* __restrict__ idx,
                          const uint8_t* __restrict__ hit,
                          const T* __restrict__ w,
                          const uint8_t* __restrict__ valid,
                          T* __restrict__ out, int V, int Q, int K, int Cin,
                          int Cout, int cin_pad, int astr, int wstr,
                          bool vec_w, int* __restrict__ fault,
                          int tiles_per_sample, int n_tiles) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int S = kStages;
  constexpr int PE = PIECE / static_cast<int>(sizeof(T));  // per copy
  constexpr int CHUNK = F32 ? kChunkF32 : kChunkBf16;
  constexpr int EPV = 16 / static_cast<int>(sizeof(T));  // per 16 bytes
  // fp32: lanes along the columns (CG of them, TC columns each), RG rows
  // side by side, RPL rows a lane; RPL * TC == 4 * NT either way
  constexpr int NC = 8 * NT;
  constexpr int CG = NC < 32 ? NC : 32;
  constexpr int TC = NC / CG;
  constexpr int RG = 32 / CG;
  constexpr int RPL = 16 / RG;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // fp32: a chunk of zeros first, read in place of a missed row
  const float* zero_row = reinterpret_cast<const float*>(smem);
  if (F32 && tid < kChunkF32) reinterpret_cast<float*>(smem)[tid] = 0.0f;
  const int kc_max = cin_pad < CHUNK ? cin_pad : CHUNK;
  const int nch = (cin_pad + CHUNK - 1) / CHUNK;
  const int kb_max = K < kOffsetBlock ? K : kOffsetBlock;
  const int ntiles = (Cout + 7) / 8;
  const int wcols = F32 ? Cout : ntiles * 8;  // weight columns staged
  const int a_elems = kTileRows * astr;
  const int w_elems = RESIDENT ? K * cin_pad * wstr : kc_max * wstr;
  auto* a_ring = reinterpret_cast<T*>(smem + (F32 ? kZeroRowBytes : 0));
  T* w_s = a_ring + S * a_elems;
  auto* src_s = reinterpret_cast<int*>(w_s + (RESIDENT ? 1 : S) * w_elems);
  auto* live_s = reinterpret_cast<unsigned*>(src_s + kb_max * kSrcStride);
  int* cnt_s = reinterpret_cast<int*>(live_s + kOffsetBlock);
  int* list_s = cnt_s + kOffsetBlock;  // kOffsetBlock entries + the length
  auto* hit_rows = reinterpret_cast<uint8_t*>(list_s + kOffsetBlock + 1);
  const T zero = zero_of<T>();

  // weight row r of chunk rows: W[k][c0 + r] (zeros past Cin and Cout)
  auto stage_w = [&](T* dst, int k, int c0, int rows) {
    const T* wk = w + (static_cast<size_t>(k) * Cin + c0) * Cout;
    if (F32 && vec_w) {  // Cout % 4 == 0, 16-byte aligned: 2 NT threads a
      // row of the padded 8 NT columns, a 16-byte copy each (shifts)
      constexpr int TPW = NC / 4;
      const int o = (tid % TPW) * 4;
      if (o < Cout) {
        for (int r = tid / TPW; r < rows; r += kGatherThreads / TPW) {
          const bool ok = c0 + r < Cin;
          const T* g = ok ? wk + static_cast<size_t>(r) * Cout + o : w;
          cp_async<16>(dst + r * wstr + o, g, ok ? 16 : 0);
        }
      }
    } else if (vec_w) {  // Cout % EPV == 0, 16-byte aligned
      const int groups = Cout / EPV;
      for (int e = tid; e < rows * groups; e += kGatherThreads) {
        const int r = e / groups;
        const int o = (e % groups) * EPV;
        const bool ok = c0 + r < Cin;
        const T* g = ok ? wk + static_cast<size_t>(r) * Cout + o : w;
        cp_async<16>(dst + r * wstr + o, g, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < rows * wcols; e += kGatherThreads) {
        const int r = e / wcols;
        const int o = e % wcols;
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

  float acc[4 * NT];
#pragma unroll
  for (int j = 0; j < 4 * NT; ++j) acc[j] = 0.0f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_sample;
    const int q0 = (tile % tiles_per_sample) * kTileRows;
    const size_t qbase = static_cast<size_t>(b) * Q;
    const T* feat_b = feat + static_cast<size_t>(b) * V * Cin;

    for (int k0 = 0; k0 < K; k0 += kOffsetBlock) {
      const int kb = K - k0 < kOffsetBlock ? K - k0 : kOffsetBlock;
      __syncthreads();  // the previous steps' readers are done
      // the table: row-major in memory, so consecutive threads read
      // consecutive entries; kTableBatch entries a thread at a time, their
      // valid, hit and idx loads independent (idx is read on a miss too).
      // MIRROR: step k reads column K - 1 - k, which is the transpose only
      // for a submanifold table of the valid rows: each valid row hits
      // itself at the centre, no other row hits, and each hit of a valid
      // row is a valid row; an entry that breaks it sets *fault
      const int n_ent = kTileRows * kb;
      for (int e0 = tid; e0 < n_ent; e0 += kGatherThreads * kTableBatch) {
        int src[kTableBatch];
#pragma unroll
        for (int u = 0; u < kTableBatch; ++u) {
          const int e = e0 + u * kGatherThreads;
          const int q = q0 + e / kb;
          src[u] = -1;
          if (e < n_ent && q < Q) {
            if constexpr (MIRROR) {
              const int col = K - 1 - k0 - e % kb;
              const size_t ent = (qbase + q) * K + col;
              const int x = __ldg(idx + ent);
              const bool h = __ldg(hit + ent);
              const bool v = __ldg(valid + qbase + q);
              src[u] = v & h ? x : -1;
              if (h ? !v || x < 0 || x >= V || !__ldg(valid + qbase + x)
                    : v && 2 * col == K - 1) {
                *reinterpret_cast<volatile int*>(fault) = 1;
              }
            } else {
              const size_t ent = (qbase + q) * K + k0 + e % kb;
              const int x = __ldg(idx + ent);
              src[u] = __ldg(valid + qbase + q) & __ldg(hit + ent) ? x : -1;
            }
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

      // step m: offset list_s[m / nch], channels from (m % nch) * CHUNK
      auto issue = [&](int m) {
        const int kk = list_s[m / nch];
        const int c0 = (m % nch) * CHUNK;
        const int kc = cin_pad - c0 < CHUNK ? cin_pad - c0 : CHUNK;
        const int* srcs = src_s + kk * kSrcStride;
        const uint8_t* rows = hit_rows + kk * kTileRows;
        T* a = a_ring + (m % S) * a_elems;
        // the hit rows only: a miss is not copied
        if constexpr (F32) {  // TPR threads a row, a piece each (shifts)
          constexpr int TPR = CHUNK / PE;
          const int p = tid % TPR;
          const int col = c0 + p * PE;
          const bool ok = col < Cin;  // else a zero pad column
          if (p * PE < kc) {
            for (int h = tid / TPR; h < cnt_s[kk];
                 h += kGatherThreads / TPR) {
              const int r = rows[h];
              const T* g = ok ? feat_b + static_cast<size_t>(srcs[r]) * Cin +
                                    col
                              : feat_b;
              cp_async<PIECE>(a + r * astr + col - c0, g, ok ? PIECE : 0);
            }
          }
        } else {
          const int ppr = kc / PE;  // copies per row
          const int n_copies = cnt_s[kk] * ppr;
          for (int e = tid; e < n_copies; e += kGatherThreads) {
            const int r = rows[e / ppr];
            const int src = srcs[r];
            const int col = c0 + (e % ppr) * PE;
            const bool ok = col < Cin;  // else a zero pad column
            const T* g = ok ? feat_b + static_cast<size_t>(src) * Cin + col
                            : feat_b;
            T* d = a + r * astr + col - c0;
            if constexpr (PIECE >= 4) {
              cp_async<PIECE>(d, g, ok ? PIECE : 0);
            } else {
              *d = ok ? *g : zero;
            }
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
        const int c0 = (n % nch) * CHUNK;
        const int kc = cin_pad - c0 < CHUNK ? cin_pad - c0 : CHUNK;
        const T* a = a_ring + (n % S) * a_elems;
        const T* wb = RESIDENT
            ? w_s + (static_cast<size_t>(k0 + kk) * cin_pad + c0) * wstr
            : w_s + (n % S) * w_elems;
        if constexpr (F32) {
          // this warp's rows: warp + 8 m, m < 16, interleaved so that a
          // step's hit rows spread over all 8 warps; lane (rg, cg) takes
          // slots i (rows warp + 8 (i RG + rg)) and columns cg TC .. + TC.
          // Per CW channels the lane loads its weights once; the slots go
          // by quads, a quad without a hit skipped, the others multiplied
          // densely (a missed row read from the zero row), 4 TC
          // independent FMA chains of CW a quad.
          const int* srcs = src_s + kk * kSrcStride + warp;
          const unsigned hits =
              __ballot_sync(kFull, srcs[8 * (lane & 15)] >= 0) & 0xffffu;
          if (hits == 0u) continue;  // warp-uniform
          const int cg = lane % CG;
          const int rg = lane / CG;
          const unsigned mine = RG == 1 ? hits : even_bits(hits >> rg);
          const float* ar = a + (warp + 8 * rg) * astr;
          const float* wl = wb + cg * TC;
          constexpr int CW = NT >= 16 ? 4 : 8;  // channels a pass
          for (int c = 0; c < kc; c += CW) {
            float wv[CW][TC];
#pragma unroll
            for (int u = 0; u < CW; ++u) load_f32<TC>(wl + (c + u) * wstr,
                                                      wv[u]);
#pragma unroll
            for (int qd = 0; qd < RPL / 4; ++qd) {
              if (!((hits >> (4 * qd * RG)) & ((1u << (4 * RG)) - 1u))) {
                continue;  // warp-uniform
              }
              float x[4][CW];
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int i = 4 * qd + r;
                const float* row = (mine >> i) & 1u
                    ? ar + i * RG * 8 * astr + c : zero_row + c;
                load_f32<CW>(row, x[r]);
              }
#pragma unroll
              for (int u = 0; u < CW; ++u) {
#pragma unroll
                for (int r = 0; r < 4; ++r) {
#pragma unroll
                  for (int j = 0; j < TC; ++j) {
                    float& o = acc[(4 * qd + r) * TC + j];
                    o = __fmaf_rn(x[r][u], wv[u][j], o);
                  }
                }
              }
            }
          }
        } else {
          if (!((live_s[kk] >> warp) & 1u)) continue;
          const int* rows = src_s + kk * kSrcStride + warp * 16;
          // this lane's two A rows (fragments a0/a2 and a1/a3); a miss was
          // not copied, so its stale shared-memory row is masked here
          const uint32_t m0 = rows[lane / 4] >= 0 ? kFull : 0u;
          const uint32_t m1 = rows[lane / 4 + 8] >= 0 ? kFull : 0u;
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
                    : "r"(smem_addr(wb + (kq + (lane & 15)) * wstr
                                    + t * 8)));
                asm volatile(
                    "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                    "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
                    "{%0,%1,%2,%3};\n"
                    : "+f"(acc[t * 4]), "+f"(acc[t * 4 + 1]),
                      "+f"(acc[t * 4 + 2]), "+f"(acc[t * 4 + 3])
                    : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0),
                      "r"(b1));
              }
            }
          }
        }
      }
      cp_async_wait<0>();
    }

    if constexpr (F32) {  // acc[i * TC + j]: row warp + 8 (i RG + rg),
      // column cg * TC + j
      const int cg = lane % CG;
      const int rg = lane / CG;
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const int q = q0 + warp + 8 * (i * RG + rg);
        if (q >= Q) continue;
        const bool ok = valid[qbase + q] != 0;
        float* orow = out + (qbase + q) * Cout;
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int o = cg * TC + j;
          if (o < Cout) orow[o] = ok ? acc[i * TC + j] : 0.0f;
        }
      }
    } else {  // accumulator (t, j): row warp*16 + lane/4 (+8 for j >= 2),
      // column t*8 + 2*(lane%4) + (j & 1)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = q0 + warp * 16 + lane / 4 + half * 8;
        if (q >= Q) continue;
        const bool ok = valid[qbase + q] != 0;
        T* orow = out + (qbase + q) * Cout;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          if (t >= ntiles) continue;
          const int o = t * 8 + 2 * (lane % 4);
          const float v0 = ok ? acc[t * 4 + half * 2] : 0.0f;
          const float v1 = ok ? acc[t * 4 + half * 2 + 1] : 0.0f;
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
    }
#pragma unroll
    for (int j = 0; j < 4 * NT; ++j) acc[j] = 0.0f;
  }
}

int last_variant = 0;  // the variant of the last launch, for the wrapper

// The MIRROR launches' fault word: pinned host memory that the card
// writes, so that the host reads it with no sync (0: no fault yet).
int* mirror_fault() {
  static int* word = [] {
    int* w = nullptr;
    if (cudaHostAlloc(&w, sizeof(int),
                      cudaHostAllocMapped | cudaHostAllocPortable) !=
        cudaSuccess) {
      return static_cast<int*>(nullptr);
    }
    *w = 0;
    return w;
  }();
  return word;
}

template <typename T, bool RESIDENT, int PIECE, int NT, bool MIRROR>
cudaError_t launch_kernel(const Plan& p, const void* feat, const void* idx,
                          const void* hit, const void* w, const void* valid,
                          void* out, int B, int V, int Q, int K, int Cin,
                          int Cout, bool vec_w, cudaStream_t s) {
  auto kernel = sparse_conv_gather_kernel<T, RESIDENT, PIECE, NT, MIRROR>;
  int* fault = nullptr;
  if constexpr (MIRROR) {
    fault = mirror_fault();
    if (fault == nullptr) return cudaErrorMemoryAllocation;
  }
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
      static_cast<const T*>(feat), static_cast<const int*>(idx),
      static_cast<const uint8_t*>(hit), static_cast<const T*>(w),
      static_cast<const uint8_t*>(valid), static_cast<T*>(out), V, Q, K, Cin,
      Cout, p.cin_pad, p.astr, p.wstr, vec_w, fault, tiles_per_sample,
      n_tiles);
  return cudaGetLastError();
}

// the forward's kernel, or with `mirror` its data gradient's
template <typename T, bool RESIDENT, int PIECE, int NT>
cudaError_t launch_gather(const Plan& p, const void* feat, const void* idx,
                          const void* hit, const void* w, const void* valid,
                          void* out, int B, int V, int Q, int K, int Cin,
                          int Cout, bool vec_w, bool mirror,
                          cudaStream_t s) {
  return mirror
      ? launch_kernel<T, RESIDENT, PIECE, NT, true>(
            p, feat, idx, hit, w, valid, out, B, V, Q, K, Cin, Cout, vec_w, s)
      : launch_kernel<T, RESIDENT, PIECE, NT, false>(
            p, feat, idx, hit, w, valid, out, B, V, Q, K, Cin, Cout, vec_w,
            s);
}

// the kernel for (dtype, weights, copy size, accumulator tiles)
template <typename T, bool RESIDENT, int PIECE>
cudaError_t launch_gather_nt(const Plan& p, const void* feat, const void* idx,
                             const void* hit, const void* w,
                             const void* valid, void* out, int B, int V,
                             int Q, int K, int Cin, int Cout, bool vec_w,
                             bool mirror, cudaStream_t s) {
  const int nt = nt_of(Cout);
  if (nt <= 2) {
    return launch_gather<T, RESIDENT, PIECE, 2>(
        p, feat, idx, hit, w, valid, out, B, V, Q, K, Cin, Cout, vec_w,
        mirror, s);
  }
  if (nt <= 4) {
    return launch_gather<T, RESIDENT, PIECE, 4>(
        p, feat, idx, hit, w, valid, out, B, V, Q, K, Cin, Cout, vec_w,
        mirror, s);
  }
  if (nt <= 8) {
    return launch_gather<T, RESIDENT, PIECE, 8>(
        p, feat, idx, hit, w, valid, out, B, V, Q, K, Cin, Cout, vec_w,
        mirror, s);
  }
  return launch_gather<T, RESIDENT, PIECE, kMaxCout / 8>(
      p, feat, idx, hit, w, valid, out, B, V, Q, K, Cin, Cout, vec_w,
      mirror, s);
}

template <typename T, bool RESIDENT>
cudaError_t launch_gather_piece(int piece, const Plan& p, const void* feat,
                                const void* idx, const void* hit,
                                const void* w, const void* valid, void* out,
                                int B, int V, int Q, int K, int Cin, int Cout,
                                bool vec_w, bool mirror, cudaStream_t s) {
  switch (piece) {
    case 16:
      return launch_gather_nt<T, RESIDENT, 16>(
          p, feat, idx, hit, w, valid, out, B, V, Q, K, Cin, Cout, vec_w,
        mirror, s);
    case 8:
      return launch_gather_nt<T, RESIDENT, 8>(
          p, feat, idx, hit, w, valid, out, B, V, Q, K, Cin, Cout, vec_w,
        mirror, s);
    case 4:
      return launch_gather_nt<T, RESIDENT, 4>(
          p, feat, idx, hit, w, valid, out, B, V, Q, K, Cin, Cout, vec_w,
        mirror, s);
    default:  // 2-byte rows: bf16 only
      if constexpr (sizeof(T) == 2) {
        return launch_gather_nt<T, RESIDENT, 2>(
            p, feat, idx, hit, w, valid, out, B, V, Q, K, Cin, Cout, vec_w,
            mirror, s);
      } else {
        return cudaErrorInvalidValue;
      }
  }
}

template <typename T>
cudaError_t launch_gather_dtype(const Plan& p, int piece, const void* feat,
                                const void* idx, const void* hit,
                                const void* w, const void* valid, void* out,
                                int B, int V, int Q, int K, int Cin, int Cout,
                                bool vec_w, bool mirror, cudaStream_t s) {
  return p.resident
      ? launch_gather_piece<T, true>(piece, p, feat, idx, hit, w, valid, out,
                                     B, V, Q, K, Cin, Cout, vec_w, mirror, s)
      : launch_gather_piece<T, false>(piece, p, feat, idx, hit, w, valid,
                                      out, B, V, Q, K, Cin, Cout, vec_w,
                                      mirror, s);
}


// ---- backward: the weight gradient ----------------------------------------
//
// The data gradient is the forward kernel itself on the table's transpose
// (ops/kernels/sparse_conv.py:sparse_conv_dgrad): a submanifold table is
// its own transpose through the mirrored offsets (`mirror`, no table is
// built), a strided layer's is built by csrc/lookup.cu's transposed_table
// (a gather, each entry written once). The weight gradient
//
//   dW[k] = sum over (b, q) with hit[b, q, k] and valid[b, q] of
//           feat[b, idx[b, q, k]]^T (x) dy[b, q]          (Cin x Cout)
//
// has no TPU kernel behind it (JAX differentiates the XLA gather-GEMM); it
// is the port's own, so that the convolution trains on the card. Bound:
// operations on SECOND's layers (2 * Cin * Cout per live pair against the
// table once, the referenced feature rows, dy's valid rows, dW written
// once), at the fp32 SIMT rate. The first kernel took a 64 x 64 channel
// tile whatever the widths (1/64 of its FMAs useful at 4 -> 16) and had
// every (tile, offset, slice) block rescan its slice's table with a K-byte
// stride: ~27x its bound, no faster than its plain version.
// The design:
//   * a block takes (a slice of the B * Q rows, a channel tile, a group of
//     kWgOffsets = 8 offsets), one offset a warp; the tile (CI x CO: 16 x
//     16, 16 x 32, 32 x 32 or 32 x 64) is chosen by the layer's widths
//     (wgrad_plan(): least padding, then the larger tile), each lane
//     holding TI x TJ of it in fp32 registers;
//   * per chunk of kWgRows = 128 rows: the dy rows of the chunk (the tile's
//     CO columns) are copied by cp.async while the (rows x 8 offsets) table
//     block is read once, coalesced, as feature row or -1 into shared
//     memory; each warp then lists its offset's hit rows in order (ballots)
//     and gathers their feature rows (the tile's CI columns), 512 / CI rows
//     at a time, by cp.async into a 2-stage ring of its own, synchronised
//     by __syncwarp: the next rows are in flight while the current ones are
//     multiplied, explicit __fmaf_rn, rows in order;
//   * each block writes its partial sums (per slice, offset and tile); a
//     second kernel adds a slice group's partials in order per thread, then
//     the groups in order, and rounds once to the features' dtype. No
//     atomics: two runs give bit-equal gradients.
// On the H100 (sparse_conv_ab.py, one call) a SECOND train step's 12
// weight gradients take 0.98 ms in a CUDA graph against the first
// kernel's 2.92-2.97 (bound 0.11, operations); 256-row chunks ran no
// faster. Not measured yet: how much of it is each chunk's chain of
// dependent round trips (table, then the hit lists, then the gather),
// which is not overlapped with the previous chunk's products. No tensor
// cores, TMA or wgmma: fp32 gradients need fp32 products (TF32 misses the
// train tolerance).
constexpr int kWgThreads = 256;
constexpr int kWgRows = 128;     // rows of a chunk
constexpr int kWgOffsets = 8;    // offsets of a block, one a warp
constexpr int kWgRingElems = 512;  // a warp's ring stage: 512 / CI rows

// The weight-gradient tile for (Cin, Cout): CI x CO, lanes LI along Cin.
struct WgPlan {
  int tile;  // 0: 16 x 16, 1: 16 x 32, 2: 32 x 32, 3: 32 x 64
  int ci;
  int co;
  int smem;    // dynamic shared memory, bytes
  int blocks;  // blocks an SM the registers allow
};

constexpr int kWgTiles[4][2] = {{16, 16}, {16, 32}, {32, 32}, {32, 64}};

constexpr int wg_blocks_per_sm(int elems) {
  return elems <= 512 ? 4 : elems <= 1024 ? 3 : 2;
}

WgPlan wgrad_plan(int cin, int cout, int dtype) {
  WgPlan p = {0, 0, 0, 0, 0};
  long long best = -1;
  for (int t = 0; t < 4; ++t) {
    const long long area =
        static_cast<long long>(round_up(cin, kWgTiles[t][0])) *
        round_up(cout, kWgTiles[t][1]);
    if (best < 0 || area <= best) {  // ties: the later, larger tile
      best = area;
      p.tile = t;
    }
  }
  p.ci = kWgTiles[p.tile][0];
  p.co = kWgTiles[p.tile][1];
  const int esize = dtype == 0 ? 4 : 2;
  p.smem = (kWgRows * p.co + kWgOffsets * 2 * kWgRingElems) * esize +
           kWgOffsets * kWgRows * 5;  // source rows (int) and hit lists
  p.blocks = wg_blocks_per_sm(p.ci * p.co);
  return p;
}

// `bytes` (16, 8 or 4 by cp.async; 2, bf16, by a plain copy) from `src`
// into shared `dst`, zeros where not `ok`.
template <typename T>
__device__ __forceinline__ void copy_piece(T* dst, const T* src, bool ok,
                                           int bytes) {
  switch (bytes) {
    case 16:
      cp_async<16>(dst, src, ok ? 16 : 0);
      break;
    case 8:
      cp_async<8>(dst, src, ok ? 8 : 0);
      break;
    case 4:
      cp_async<4>(dst, src, ok ? 4 : 0);
      break;
    default:
      *dst = ok ? *src : zero_of<T>();
  }
}

template <typename T, int CI, int CO, int LI>
__global__ void __launch_bounds__(kWgThreads, wg_blocks_per_sm(CI * CO))
sparse_conv_wgrad_kernel(const T* __restrict__ feat, const T* __restrict__ dy,
                         const int* __restrict__ idx,
                         const uint8_t* __restrict__ hit,
                         const uint8_t* __restrict__ valid,
                         float* __restrict__ partial, int V, int Q, int K,
                         int Cin, int Cout, int co_tiles, long long rows,
                         long long rows_per_slice, int xpiece, int dpiece) {
  constexpr int LJ = 32 / LI;
  constexpr int TI = CI / LI;
  constexpr int TJ = CO / LJ;
  constexpr int GR = kWgRingElems / CI;  // rows of a ring stage
  extern __shared__ __align__(128) unsigned char smem[];
  T* dy_s = reinterpret_cast<T*>(smem);         // kWgRows x CO
  T* x_s = dy_s + kWgRows * CO;                 // 8 warps x 2 x GR x CI
  auto* src_s = reinterpret_cast<int*>(x_s + kWgOffsets * 2 * kWgRingElems);
  auto* list_s = reinterpret_cast<uint8_t*>(src_s + kWgOffsets * kWgRows);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int li = lane / LJ;
  const int lj = lane % LJ;
  const int ci0 = (blockIdx.y / co_tiles) * CI;
  const int co0 = (blockIdx.y % co_tiles) * CO;
  const int k0 = blockIdx.z * kWgOffsets;
  const int k = k0 + warp;  // this warp's offset, none if K <= k
  const long long begin = blockIdx.x * rows_per_slice;
  const long long end = begin + rows_per_slice < rows
      ? begin + rows_per_slice : rows;
  const int xpe = xpiece / static_cast<int>(sizeof(T));
  const int dpe = dpiece / static_cast<int>(sizeof(T));
  T* ring = x_s + warp * 2 * kWgRingElems;
  int* my_src = src_s + warp * kWgRows;
  uint8_t* my_list = list_s + warp * kWgRows;

  float acc[TI][TJ];
#pragma unroll
  for (int a = 0; a < TI; ++a) {
#pragma unroll
    for (int c = 0; c < TJ; ++c) acc[a][c] = 0.0f;
  }

  for (long long base = begin; base < end; base += kWgRows) {
    const int n_rows = end - base < kWgRows ? static_cast<int>(end - base)
                                            : kWgRows;
    __syncthreads();  // the previous chunk's readers are done
    {  // dy rows base .. base + n_rows, columns co0 .. co0 + CO
      const int ppr = CO / dpe;
      for (int e = tid; e < n_rows * ppr; e += kWgThreads) {
        const int r = e / ppr;
        const int col = co0 + (e % ppr) * dpe;
        const bool ok = col < Cout;
        copy_piece(dy_s + r * CO + col - co0,
                   ok ? dy + (base + r) * Cout + col : dy, ok, dpiece);
      }
      cp_async_commit();
    }
    // the table block: 8 consecutive entries of a row to 8 consecutive
    // threads; idx, hit and valid loaded independently
    for (int e = tid; e < kWgRows * kWgOffsets; e += kWgThreads) {
      const int r = e / kWgOffsets;
      const int kk = e % kWgOffsets;
      int src = -1;
      if (r < n_rows && k0 + kk < K) {
        const long long row = base + r;
        const long long ent = row * K + k0 + kk;
        const int x = __ldg(idx + ent);
        if (__ldg(valid + row) & __ldg(hit + ent)) {
          src = static_cast<int>((row / Q) * V) + x;
        }
      }
      src_s[kk * kWgRows + r] = src;
    }
    __syncthreads();
    int n = 0;  // this warp's offset: its hit rows in order
    if (k < K) {
      for (int r0 = 0; r0 < kWgRows; r0 += 32) {
        const bool h = my_src[r0 + lane] >= 0;
        const unsigned m = __ballot_sync(kFull, h);
        if (h) my_list[n + __popc(m & ((1u << lane) - 1u))] = r0 + lane;
        n += __popc(m);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // dy is in
    if (n == 0) continue;
    const int ppr = CI / xpe;
    auto issue = [&](int g) {  // rows g * GR .. of the list, stage g % 2
      T* dst = ring + (g & 1) * kWgRingElems;
      const int r0 = g * GR;
      const int cnt = n - r0 < GR ? n - r0 : GR;
      for (int e = lane; e < cnt * ppr; e += 32) {
        const int i = e / ppr;
        const int col = ci0 + (e % ppr) * xpe;
        const bool ok = col < Cin;
        const int src = my_src[my_list[r0 + i]];
        copy_piece(dst + i * CI + col - ci0,
                   ok ? feat + static_cast<size_t>(src) * Cin + col : feat,
                   ok, xpiece);
      }
    };
    const int ng = (n + GR - 1) / GR;
    issue(0);
    cp_async_commit();
    for (int g = 0; g < ng; ++g) {
      if (g + 1 < ng) issue(g + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();  // group g's rows are in, from every lane
      const T* xg = ring + (g & 1) * kWgRingElems + li * TI;
      const T* dl = dy_s + lj * TJ;
      const int r0 = g * GR;
      const int cnt = n - r0 < GR ? n - r0 : GR;
#pragma unroll 2
      for (int i = 0; i < cnt; ++i) {
        float xv[TI], dv[TJ];
        load_f32<TI>(xg + i * CI, xv);
        load_f32<TJ>(dl + my_list[r0 + i] * CO, dv);
#pragma unroll
        for (int a = 0; a < TI; ++a) {
#pragma unroll
          for (int c = 0; c < TJ; ++c) {
            acc[a][c] = __fmaf_rn(xv[a], dv[c], acc[a][c]);
          }
        }
      }
      __syncwarp();  // stage g % 2 is free for group g + 2
    }
  }
  if (k >= K) return;
  float* out = partial + (static_cast<size_t>(blockIdx.x) * K + k) *
      Cin * Cout;
#pragma unroll
  for (int a = 0; a < TI; ++a) {
    const int ci = ci0 + li * TI + a;
    if (ci >= Cin) continue;
#pragma unroll
    for (int c = 0; c < TJ; ++c) {
      const int co = co0 + lj * TJ + c;
      if (co < Cout) out[static_cast<size_t>(ci) * Cout + co] = acc[a][c];
    }
  }
}

constexpr int kReduceCols = 32;   // outputs a reduce block takes
constexpr int kReduceParts = 8;   // slice groups added side by side

// dW = the slices' partial sums: thread (i, part) adds the slices of its
// group in order, then part 0 adds the groups in order and rounds once
template <typename T>
__global__ void __launch_bounds__(kReduceCols * kReduceParts)
sparse_conv_wgrad_reduce(const float* __restrict__ partial,
                         T* __restrict__ dw, int slices, int n) {
  __shared__ float part_s[kReduceParts][kReduceCols];
  const int i = blockIdx.x * kReduceCols + threadIdx.x;
  const int per = (slices + kReduceParts - 1) / kReduceParts;
  const int t0 = threadIdx.y * per;
  const int t1 = t0 + per < slices ? t0 + per : slices;
  float s = 0.0f;
  if (i < n) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) {
      s = __fadd_rn(s, partial[static_cast<size_t>(t) * n + i]);
    }
  }
  part_s[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || i >= n) return;
  s = part_s[0][threadIdx.x];
#pragma unroll
  for (int p = 1; p < kReduceParts; ++p) {
    s = __fadd_rn(s, part_s[p][threadIdx.x]);
  }
  if constexpr (std::is_same<T, float>::value) {
    dw[i] = s;
  } else {
    dw[i] = __float2bfloat16_rn(s);
  }
}

template <typename T, int CI, int CO, int LI>
cudaError_t launch_wgrad(const WgPlan& p, const void* feat, const void* dy,
                         const void* idx, const void* hit, const void* valid,
                         float* part, void* dw, int V, int Q, int K, int Cin,
                         int Cout, int slices, long long rows,
                         long long rows_per_slice, int xpiece, int dpiece,
                         cudaStream_t s) {
  auto kernel = sparse_conv_wgrad_kernel<T, CI, CO, LI>;
  cudaError_t err = de6d::max_dynamic_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  const int co_tiles = (Cout + CO - 1) / CO;
  const dim3 grid(slices, ((Cin + CI - 1) / CI) * co_tiles,
                  (K + kWgOffsets - 1) / kWgOffsets);
  kernel<<<grid, kWgThreads, p.smem, s>>>(
      static_cast<const T*>(feat), static_cast<const T*>(dy),
      static_cast<const int*>(idx), static_cast<const uint8_t*>(hit),
      static_cast<const uint8_t*>(valid), part, V, Q, K, Cin, Cout,
      co_tiles, rows, rows_per_slice, xpiece, dpiece);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = K * Cin * Cout;
  sparse_conv_wgrad_reduce<T>
      <<<(n + kReduceCols - 1) / kReduceCols,
         dim3(kReduceCols, kReduceParts), 0, s>>>(
          part, static_cast<T*>(dw), slices, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgrad_tile(const WgPlan& p, const void* feat,
                              const void* dy, const void* idx,
                              const void* hit, const void* valid, float* part,
                              void* dw, int V, int Q, int K, int Cin,
                              int Cout, int slices, long long rows,
                              long long rows_per_slice, int xpiece,
                              int dpiece, cudaStream_t s) {
  switch (p.tile) {
    case 0:
      return launch_wgrad<T, 16, 16, 8>(p, feat, dy, idx, hit, valid, part,
                                        dw, V, Q, K, Cin, Cout, slices, rows,
                                        rows_per_slice, xpiece, dpiece, s);
    case 1:
      return launch_wgrad<T, 16, 32, 4>(p, feat, dy, idx, hit, valid, part,
                                        dw, V, Q, K, Cin, Cout, slices, rows,
                                        rows_per_slice, xpiece, dpiece, s);
    case 2:
      return launch_wgrad<T, 32, 32, 4>(p, feat, dy, idx, hit, valid, part,
                                        dw, V, Q, K, Cin, Cout, slices, rows,
                                        rows_per_slice, xpiece, dpiece, s);
    default:
      return launch_wgrad<T, 32, 64, 4>(p, feat, dy, idx, hit, valid, part,
                                        dw, V, Q, K, Cin, Cout, slices, rows,
                                        rows_per_slice, xpiece, dpiece, s);
  }
}

// The widest copy (16, 8 or 4 bytes; 2 for bf16) that rows of `width`
// elements of `esize` bytes at `ptr` allow.
int copy_bytes(const void* ptr, int width, int esize) {
  for (int c = 16; c >= 4; c /= 2) {
    if ((width * esize) % c == 0 &&
        reinterpret_cast<uintptr_t>(ptr) % c == 0) {
      return c;
    }
  }
  return esize == 4 ? 4 : 2;
}

}  // namespace

// The plan for (Cin, Cout, K) in dtype 0 (fp32) or 1 (bf16), or the forced
// variant `force` (1 simt, 2 resident, 3 streamed; 0: the rule): writes
// {variant, stages, dynamic shared memory bytes, weights resident} to info
// and returns the variant, or -1 where that variant does not take the
// shape.
extern "C" int de6d_sparse_conv_plan(int Cin, int Cout, int K, int dtype,
                                     int force, int* info) {
  if (Cin < 1 || Cout < 1 || Cout > kMaxCout || K < 1) return -1;
  const Plan p = plan(Cin, Cout, K, dtype, force);
  info[0] = p.variant;
  info[1] = p.stages;
  info[2] = p.smem;
  info[3] = p.resident;
  return p.variant;
}

// The variant of the last de6d_sparse_conv launch in this process.
extern "C" int de6d_sparse_conv_last_variant() { return last_variant; }

// feat (B, V, Cin), idx (B, Q, K) int32, hit (B, Q, K) uint8, w (K, Cin,
// Cout), valid (B, Q) uint8 -> out (B, Q, Cout); feat, w and out are fp32
// (dtype 0) or bf16 (dtype 1). `force` as for de6d_sparse_conv_plan.
// `mirror` != 0: offset k reads the table's column K - 1 - k (the data
// gradient of a submanifold conv on its own table, K odd, Q == V), and an
// entry that breaks the submanifold contract sets the fault word that
// de6d_sparse_conv_mirror_fault reads. Returns a cudaError_t.
extern "C" int de6d_sparse_conv(const void* feat, const void* idx,
                                const void* hit, const void* w,
                                const void* valid, void* out, int B, int V,
                                int Q, int K, int Cin, int Cout, int dtype,
                                int force, int mirror, void* stream) {
  if (B < 0 || V < 1 || Q < 0 || K < 1 || Cin < 1 || Cout < 1 ||
      Cout > kMaxCout || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = plan(Cin, Cout, K, dtype, force);
  if (p.variant < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Q == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  last_variant = p.variant;
  const int esize = dtype == 0 ? 4 : 2;
  const int piece = copy_bytes(feat, Cin, esize);
  const bool vec_w = Cout % (16 / esize) == 0 &&
      reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (mirror && (K % 2 == 0 || Q != V)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = dtype == 0
      ? launch_gather_dtype<float>(p, piece, feat, idx, hit, w, valid, out,
                                   B, V, Q, K, Cin, Cout, vec_w, mirror, s)
      : launch_gather_dtype<__nv_bfloat16>(p, piece, feat, idx, hit, w,
                                           valid, out, B, V, Q, K, Cin, Cout,
                                           vec_w, mirror, s);
  return static_cast<int>(err);
}

// The mirrored launches' fault word as the card last wrote it, with no
// sync (1: a finished launch met a table that is not the submanifold table
// of its valid rows); `clear` != 0 resets it to 0.
extern "C" int de6d_sparse_conv_mirror_fault(int clear) {
  int* word = mirror_fault();
  if (word == nullptr) return -1;
  const int seen = *reinterpret_cast<volatile int*>(word);
  if (clear) *reinterpret_cast<volatile int*>(word) = 0;
  return seen;
}

// The weight gradient's tile for (Cin, Cout) in dtype 0 (fp32) or 1
// (bf16): writes {tile CI, tile CO, dynamic shared memory bytes, blocks an
// SM} to info and returns the tile's index.
extern "C" int de6d_sparse_conv_wgrad_plan(int Cin, int Cout, int dtype,
                                           int* info) {
  if (Cin < 1 || Cout < 1 || (dtype != 0 && dtype != 1)) return -1;
  const WgPlan p = wgrad_plan(Cin, Cout, dtype);
  info[0] = p.ci;
  info[1] = p.co;
  info[2] = p.smem;
  info[3] = p.blocks;
  return p.tile;
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
  const WgPlan p = wgrad_plan(Cin, Cout, dtype);
  if (B < 1 || V < 1 || Q < 1 || K < 1 || Cin < 1 || Cout < 1 ||
      slices < 1 || rows_per_slice < 1 ||
      (slices - 1) * rows_per_slice >= rows ||
      static_cast<long long>(slices) * rows_per_slice < rows ||
      (K + kWgOffsets - 1) / kWgOffsets > 65535 ||
      static_cast<long long>((Cin + p.ci - 1) / p.ci) *
          ((Cout + p.co - 1) / p.co) > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int esize = dtype == 0 ? 4 : 2;
  const int xpiece = copy_bytes(feat, Cin, esize);
  const int dpiece = copy_bytes(dy, Cout, esize);
  auto* part = static_cast<float*>(partial);
  const cudaError_t err = dtype == 0
      ? launch_wgrad_tile<float>(p, feat, dy, idx, hit, valid, part, dw, V,
                                 Q, K, Cin, Cout, slices, rows,
                                 rows_per_slice, xpiece, dpiece, s)
      : launch_wgrad_tile<__nv_bfloat16>(p, feat, dy, idx, hit, valid, part,
                                         dw, V, Q, K, Cin, Cout, slices,
                                         rows, rows_per_slice, xpiece,
                                         dpiece, s);
  return static_cast<int>(err);
}
