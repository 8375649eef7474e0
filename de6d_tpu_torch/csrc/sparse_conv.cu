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
// below the tensor cores' rate. Both kernels below work on the dense
// (64 rows x K offsets) tile and are held by that arithmetic and by the
// per-offset gather, not by the bound. Shared design:
//   * one block per tile of kRows = 64 output rows of one sample; a tile
//     with no valid row only writes its zeros; per offset k the tile's 64
//     neighbour rows are read once (row or -1 on a miss), and an offset
//     with no hit in the tile is skipped;
//   * per offset and per chunk of input channels the tile's gathered rows
//     (zeros on a miss) and W[k]'s chunk are staged in shared memory; a
//     warp whose rows all miss at k skips its products;
//   * the (Q, K, Cin) gathered tensor is never formed.
// fp32 (sparse_conv_kernel): 256 threads, each 4 rows x up to 8 output
// columns (column cg + 16 j) in fp32 registers, 32-channel chunks, explicit
// __fmaf_rn (the library is built with -fmad=false, which would leave
// a * b + c unfused), so the parity path stays in exact fp32 products.
// bf16 (sparse_conv_mma_kernel): the tensor cores. 4 warps, each 16 rows x
// all Cout columns; 64-channel chunks padded to a multiple of 16 with
// zeros; ldmatrix fragments from padded shared-memory rows (no bank
// conflicts) and mma.sync m16n8k16 bf16 x bf16 -> fp32. bf16 products are
// exact in fp32, so only the order of the fp32 sums differs from the
// plain version's.
// wgmma tiles, a row-compacted gather per offset and a fused key lookup
// are left to later changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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


// ---- bf16: tensor cores ----------------------------------------------------

constexpr int kMmaThreads = 128;             // 4 warps x 16 rows
constexpr int kMmaChunk = 64;                // input channels staged per step
constexpr int kAStride = kMmaChunk + 8;      // 144-byte rows
constexpr int kWStride = kMaxCout + 8;       // 272-byte rows
constexpr int kNTiles = kMaxCout / 8;        // n8 tiles of the output

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(kMmaThreads)
sparse_conv_mma_kernel(const __nv_bfloat16* __restrict__ feat,
                       const int* __restrict__ idx,
                       const uint8_t* __restrict__ hit,
                       const __nv_bfloat16* __restrict__ w,
                       const uint8_t* __restrict__ valid,
                       __nv_bfloat16* __restrict__ out, int V, int Q, int K,
                       int Cin, int Cout, bool vec_feat, bool vec_w) {
  __shared__ __align__(16) __nv_bfloat16 a_s[kRows][kAStride];
  __shared__ __align__(16) __nv_bfloat16 w_s[kMmaChunk][kWStride];
  __shared__ int row_s[kRows];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t qbase = static_cast<size_t>(b) * Q;
  const __nv_bfloat16* feat_b = feat + static_cast<size_t>(b) * V * Cin;
  const int ntiles = (Cout + 7) / 8;
  const int wcols = ntiles * 8;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  float acc[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.0f;
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
      const bool warp_live =
          __any_sync(0xffffffffu, lane < 16 && row_s[warp * 16 + lane] >= 0);
      for (int c0 = 0; c0 < Cin; c0 += kMmaChunk) {
        const int nc = min(kMmaChunk, Cin - c0);
        const int kc = (nc + 15) & ~15;  // mma depth is 16
        if (vec_feat) {  // Cin % 8 == 0: 16-byte row pieces
          const int groups = kc / 8;
          for (int e = tid; e < kRows * groups; e += kMmaThreads) {
            const int r = e / groups;
            const int c = (e % groups) * 8;
            const int src = row_s[r];
            uint4 v = make_uint4(0, 0, 0, 0);
            if (src >= 0 && c < nc) {
              v = __ldg(reinterpret_cast<const uint4*>(
                  feat_b + static_cast<size_t>(src) * Cin + c0 + c));
            }
            *reinterpret_cast<uint4*>(&a_s[r][c]) = v;
          }
        } else {
          for (int e = tid; e < kRows * kc; e += kMmaThreads) {
            const int r = e / kc;
            const int c = e % kc;
            const int src = row_s[r];
            a_s[r][c] = src >= 0 && c < nc
                ? feat_b[static_cast<size_t>(src) * Cin + c0 + c]
                : zero;
          }
        }
        const __nv_bfloat16* wk = w + (static_cast<size_t>(k) * Cin + c0) * Cout;
        if (vec_w) {  // Cout % 8 == 0
          const int groups = wcols / 8;
          for (int e = tid; e < kc * groups; e += kMmaThreads) {
            const int c = e / groups;
            const int o = (e % groups) * 8;
            uint4 v = make_uint4(0, 0, 0, 0);
            if (c < nc) {
              v = __ldg(reinterpret_cast<const uint4*>(
                  wk + static_cast<size_t>(c) * Cout + o));
            }
            *reinterpret_cast<uint4*>(&w_s[c][o]) = v;
          }
        } else {
          for (int e = tid; e < kc * wcols; e += kMmaThreads) {
            const int c = e / wcols;
            const int o = e % wcols;
            w_s[c][o] = c < nc && o < Cout
                ? wk[static_cast<size_t>(c) * Cout + o]
                : zero;
          }
        }
        __syncthreads();
        if (warp_live) {
          for (int kk = 0; kk < kc; kk += 16) {
            uint32_t a0, a1, a2, a3;
            asm volatile(
                "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
                "[%4];\n"
                : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
                : "r"(smem_addr(
                    &a_s[warp * 16 + (lane & 15)][kk + (lane >> 4) * 8])));
#pragma unroll
            for (int n = 0; n < kNTiles; ++n) {
              if (n < ntiles) {
                uint32_t b0, b1;
                asm volatile(
                    "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 "
                    "{%0,%1}, [%2];\n"
                    : "=r"(b0), "=r"(b1)
                    : "r"(smem_addr(&w_s[kk + (lane & 15)][n * 8])));
                asm volatile(
                    "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                    "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
                    "{%0,%1,%2,%3};\n"
                    : "+f"(acc[n][0]), "+f"(acc[n][1]), "+f"(acc[n][2]),
                      "+f"(acc[n][3])
                    : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
              }
            }
          }
        }
        __syncthreads();
      }
    }
  }

  // accumulator (n, j): row warp*16 + lane/4 (+8 for j >= 2), column
  // n*8 + 2*(lane%4) + (j & 1)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + warp * 16 + lane / 4 + half * 8;
    if (q >= Q) continue;
    const bool ok = valid[qbase + q] != 0;
    __nv_bfloat16* orow = out + (qbase + q) * Cout;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      if (n >= ntiles) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = n * 8 + 2 * (lane % 4) + j;
        if (o < Cout) {
          orow[o] = __float2bfloat16_rn(ok ? acc[n][half * 2 + j] : 0.0f);
        }
      }
    }
  }
}

}  // namespace

// feat (B, V, Cin), idx (B, Q, K) int32, hit (B, Q, K) uint8, w (K, Cin,
// Cout), valid (B, Q) uint8 -> out (B, Q, Cout); feat, w and out are fp32
// (dtype 0) or bf16 (dtype 1). Returns a cudaError_t.
extern "C" int de6d_sparse_conv(const void* feat, const void* idx,
                                const void* hit, const void* w,
                                const void* valid, void* out, int B, int V,
                                int Q, int K, int Cin, int Cout, int dtype,
                                void* stream) {
  if (B < 0 || V < 1 || Q < 0 || K < 1 || Cin < 1 || Cout < 1 ||
      Cout > kMaxCout || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Q == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Q + kRows - 1) / kRows, B);
  if (dtype == 0) {
    sparse_conv_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(feat), static_cast<const int*>(idx),
        static_cast<const uint8_t*>(hit), static_cast<const float*>(w),
        static_cast<const uint8_t*>(valid), static_cast<float*>(out), V, Q,
        K, Cin, Cout);
  } else {
    const auto aligned = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    sparse_conv_mma_kernel<<<grid, kMmaThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feat), static_cast<const int*>(idx),
        static_cast<const uint8_t*>(hit),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const uint8_t*>(valid), static_cast<__nv_bfloat16*>(out),
        V, Q, K, Cin, Cout, Cin % 8 == 0 && aligned(feat),
        Cout % 8 == 0 && aligned(w));
  }
  return static_cast<int>(cudaGetLastError());
}
