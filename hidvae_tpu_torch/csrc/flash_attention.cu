// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ with segment
// ids, head_dim 64 or 128, fp32 or bf16. Replaces the Pallas kernels that
// hidvae_tpu/models/attention.py:75 reaches (jax 0.9.0's
// jax/experimental/pallas/ops/tpu/flash_attention.py):
//   flash_fwd      <- _flash_attention_kernel      (:331, pallas_call :758)
//   flash_bwd_dkv  <- _flash_attention_dkv_kernel  (:796, pallas_call :1121)
//   flash_bwd_dq   <- _flash_attention_dq_kernel   (:1146, pallas_call :1456)
// The library's semantics: logits (q k^T) * sm_scale, -0.7 * FLT_MAX across
// segments or above the causal diagonal, softmax in fp32. The forward saves
// m and l apart (one logsumexp would give a keyless row P = 1, not 1/N);
// the backward takes di = rowsum(dO * O), P = exp(logit - m) * (1 / l)
// (:900-904, :1226-1232). Arithmetic bounds every kernel at B 64, H 8,
// N 2432, Dh 64.
// * bf16 (`flash_*_tc_kernel`): mma.sync m16n8k16, fp32 accumulators
//   (mma_bf16.cuh); a warp owns 16 rows at each product's full width; the
//   streamed side cp.async double-buffered, XOR-swizzled for ldmatrix.
//   Softmax in registers; P (P^T, dS, dS^T) rounded to bf16 where the
//   library rounds it (:471, :900, :918, :1256); exp2((x - m) * log2 e), so
//   the mask never scales to -inf; an all-0 mask block skips the mask.
// * fp32: FFMA, 256 threads a 64-row tile, 4 x 4 a thread, operands
//   transposed in shared memory for 16-byte loads.
// Causal blocks skip tiles above the diagonal unless a row sees no key
// (`keyless`: uniform weights, as the plain version); ragged tails masked.
// Each C entry point launches on its stream, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int TILE = 64;       // rows of every FFMA tile
constexpr int THREADS = 256;   // FFMA: 16 x 16 threads, a 4 x 4 sub-tile each
constexpr int LD = 68;         // padded transposed row [d][row], in floats (16-byte aligned)
constexpr float MASK_VALUE = -0.7f * FLT_MAX;  // the library's DEFAULT_MASK_VALUE
constexpr float LOG2E = 1.4426950408889634f;

// Natural rows [row][d] of an FFMA tile, padded by 4 floats.
template <int DH>
constexpr int LDN = DH + 4;
// Floats of one FFMA operand tile, transposed or natural.
template <int DH>
constexpr int TILE_FLOATS = DH * LD > TILE * LDN<DH> ? DH * LD : TILE * LDN<DH>;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Rows [row0, row0 + n) of a [*, DH] matrix into dst[d * LD + r] (transposed);
// rows r >= n are zero.
template <int DH>
__device__ __forceinline__ void load_tile_t(const float* src, int n, float* dst) {
  for (int idx = threadIdx.x; idx < TILE * DH / 4; idx += THREADS) {
    const int r = idx % TILE, d0 = (idx / TILE) * 4;
    const float4 x = r < n ? load4(src + (size_t)r * DH + d0) : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[(d0 + 0) * LD + r] = x.x;
    dst[(d0 + 1) * LD + r] = x.y;
    dst[(d0 + 2) * LD + r] = x.z;
    dst[(d0 + 3) * LD + r] = x.w;
  }
}

// The same rows into dst[r * LDN + d] (natural layout); rows r >= n are zero.
template <int DH>
__device__ __forceinline__ void load_tile_n(const float* src, int n, float* dst) {
  for (int idx = threadIdx.x; idx < TILE * DH / 4; idx += THREADS) {
    const int r = idx / (DH / 4), d0 = (idx % (DH / 4)) * 4;
    const float4 x = r < n ? load4(src + (size_t)r * DH + d0) : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + r * LDN<DH> + d0, x);
  }
}

// acc[a][c] += sum_d A[d][ra + a] * B[d][rb + c] over d < DH, both operands
// stored transposed.
template <int DH>
__device__ __forceinline__ void mma_tt(const float* at, int ra, const float* bt, int rb,
                                       float acc[4][4]) {
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    const float4 a = load4(at + d * LD + ra);
    const float4 b = load4(bt + d * LD + rb);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(get(a, i), get(b, j), acc[i][j]);
  }
}

// acc[a][c] += sum_r P[r][ra + a] * X[r][cb + c] over r < TILE: P stored
// [r][row] (stride LD), X in natural layout [r][col] (stride LDX).
template <int LDX>
__device__ __forceinline__ void mma_nn(const float* p, int ra, const float* x, int cb,
                                       float acc[4][4]) {
#pragma unroll 8
  for (int r = 0; r < TILE; ++r) {
    const float4 a = load4(p + r * LD + ra);
    const float4 b = load4(x + r * LDX + cb);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(get(a, i), get(b, j), acc[i][j]);
  }
}

// Store a thread's 4 x 4 sub-tile v[a][c] (row ra + a, col cb + c) into
// dst[(cb + c) * LD + ra + a]: transposed, one 16-byte store per column.
__device__ __forceinline__ void store_t(float* dst, int ra, int cb, const float v[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    store4(dst + (cb + c) * LD + ra, make_float4(v[0][c], v[1][c], v[2][c], v[3][c]));
}

// Sum or max over the 16 threads of a half-warp (the threads sharing ty).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Max or sum over the four threads of an mma row (lanes 4g .. 4g + 3).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The library's masked, scaled logit of query `row` against key `col`;
// keys at or past nk do not exist (-inf).
__device__ __forceinline__ float masked_logit(float s, float scale, int row, int col, int nk,
                                              int seg_q, int seg_kv, int causal) {
  if (col >= nk) return -INFINITY;
  const bool ok = seg_q == seg_kv && (!causal || col <= row);
  return s * scale + (ok ? 0.f : MASK_VALUE);
}

// A causal row that sees no key of its segment has m = MASK_VALUE and the
// plain version's uniform weights over all Nk keys, above the diagonal
// too. A block (in dK/dV a query tile) holding such a row visits the tiles
// above its diagonal as well, under the same mask; other rows lose nothing
// there (exp(MASK_VALUE - m) is 0, the rescale 1). After the tiles below
// the diagonal a block asks by __syncthreads_or whether it needs more.
// Non-causal tensor-core builds (the model's) hold none of this.
__device__ __forceinline__ bool keyless(bool valid_row, float m) {
  return valid_row && m == MASK_VALUE;
}

// dK/dV under causal masking: whether a query row in [0, end), before a
// block's diagonal tile, saw no key (m is the row max the forward saved).
// Block-uniform: every thread must call it.
__device__ __forceinline__ bool keyless_before(const float* m, int end, int tid, int nthreads) {
  bool mine = false;
  for (int r = tid; r < end; r += nthreads) mine |= keyless(true, m[r]);
  return __syncthreads_or(mine);
}

// The first query tile of BQ rows from q0 on, before end, that holds a row
// that saw no key; end if none. Block-uniform.
template <int BQ>
__device__ __forceinline__ int next_keyless_tile(const float* m, int q0, int end, int tid) {
  while (q0 < end && !__syncthreads_or(tid < BQ && q0 + tid < end && keyless(true, m[q0 + tid])))
    q0 += BQ;
  return min(q0, end);
}

// ==== bf16 on tensor cores =================================================

using namespace mma_bf16;
using bf16 = __nv_bfloat16;

// ---- forward --------------------------------------------------------------
// grid (ceil(Nq / BM), H, B). Writes O [B, H, Nq, DH] and the row statistics
// m and l [B, H, Nq] (fp32), from which the backward kernels recompute P.
template <int DH>
struct FwdTC {
  static constexpr int WARPS = 8;           // 16 query rows each
  static constexpr int BM = 16 * WARPS;     // query rows per block
  static constexpr int BN = 64;             // keys per streamed tile
  static constexpr int NTHREADS = 32 * WARPS;
  static constexpr int CHUNKS = DH / 8;     // 16-byte chunks per row
  // Q tile, two stages of K and of V (bf16), two stages of kv segment ids.
  static constexpr size_t SMEM = (size_t)(BM + 4 * BN) * DH * 2 + 2 * BN * 4;
};

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(FwdTC<DH>::NTHREADS, DH == 64 ? 2 : 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ seg_q,
                    const int* __restrict__ seg_kv, bf16* __restrict__ o,
                    float* __restrict__ m_out, float* __restrict__ l_out, int H, int Nq, int Nk,
                    float scale) {
  using C = FwdTC<DH>;
  constexpr int causal = CAUSAL;
  constexpr int BM = C::BM, BN = C::BN, CH = C::CHUNKS;
  constexpr uint32_t KV_BYTES = BN * DH * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + BM * DH * 2;
  const uint32_t sV = sK + 2 * KV_BYTES;
  const int* s_seg = reinterpret_cast<const int*>(smem + (size_t)(BM + 4 * BN) * DH * 2);
  const uint32_t sSeg = smem_u32(s_seg);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, bh = b * H + blockIdx.y;
  const int q0 = blockIdx.x * BM, mq = min(BM, Nq - q0);
  const bf16* kb = k + (size_t)bh * Nk * DH;
  const bf16* vb = v + (size_t)bh * Nk * DH;
  const int* skv_b = seg_kv + (size_t)b * Nk;
  const int k_end = causal ? min(Nk, q0 + mq) : Nk;
  const int n_tiles = (k_end + BN - 1) / BN, all_tiles = (Nk + BN - 1) / BN;

  auto load_kv = [&](int stage, int k0) {
    const int nk = min(BN, Nk - k0);
    load_tile_async<BN, DH>(sK + stage * KV_BYTES, kb + (size_t)k0 * DH, nk, tid, C::NTHREADS);
    load_tile_async<BN, DH>(sV + stage * KV_BYTES, vb + (size_t)k0 * DH, nk, tid, C::NTHREADS);
    if (tid < BN) cp_async_4(sSeg + (stage * BN + tid) * 4, skv_b + k0 + min(tid, nk - 1), tid < nk);
  };

  load_tile_async<BM, DH>(sQ, q + ((size_t)bh * Nq + q0) * DH, mq, tid, C::NTHREADS);
  load_kv(0, 0);
  cp_async_commit();

  // This thread's two query rows: g and g + 8 of the warp's 16.
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const int sq_lo = row_lo < Nq ? seg_q[(size_t)b * Nq + row_lo] : 0;
  const int sq_hi = row_hi < Nq ? seg_q[(size_t)b * Nq + row_hi] : 0;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running row max (natural units)
  float l_lo = 0.f, l_hi = 0.f;              // this thread's share of the row sum
  float acc[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // Key tile j of tiles [.., end): S, the online softmax and O += P V.
  auto step = [&](int j, int end) {
    const int stage = j & 1, k0 = j * BN;
    if (j + 1 < end) load_kv(stage ^ 1, k0 + BN);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and, on the first, Q) has landed
    __syncthreads();
    const uint32_t tK = sK + stage * KV_BYTES, tV = sV + stage * KV_BYTES;

    // S = Q K^T: 16 rows x BN keys per warp; the Q fragments come from the
    // resident Q tile each time (holding them would spill at DH 64).
    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t qa[4];
      load_a(qa, sQ, warp * 16, kk, CH, lane);
#pragma unroll
      for (int nb = 0; nb < BN / 16; ++nb) {
        uint32_t bf[4];
        load_b_rows(bf, tK, nb * 16, kk, CH, lane);
        mma_16816(s[2 * nb], qa, bf[0], bf[1]);
        mma_16816(s[2 * nb + 1], qa, bf[2], bf[3]);
      }
    }

    // Whether the mask is 0 on the warp's whole 16 x BN block (keys exist,
    // causal-visible, one segment): such blocks skip the per-element mask.
    const int seg_a = s_seg[stage * BN + lane], seg_b = s_seg[stage * BN + 32 + lane];
    const int seg_u = __shfl_sync(0xffffffffu, seg_a, 0);
    const bool unmasked =
        __all_sync(0xffffffffu, seg_a == seg_u && seg_b == seg_u && sq_lo == seg_u &&
                                    sq_hi == seg_u) &&
        k0 + BN <= Nk && (!causal || k0 + BN - 1 <= q0 + warp * 16);

    // Masked, scaled logits (or, unmasked, the raw products) and the tile's
    // row max of the logits.
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
    if (unmasked) {
#pragma unroll
      for (int nj = 0; nj < BN / 8; ++nj) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[nj][0], s[nj][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[nj][2], s[nj][3]));
      }
      mx_lo *= scale;  // scale > 0
      mx_hi *= scale;
    } else {
#pragma unroll
      for (int nj = 0; nj < BN / 8; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nj * 8 + 2 * t + e;
          const int skv = s_seg[stage * BN + col];
          s[nj][e] = masked_logit(s[nj][e], scale, row_lo, k0 + col, Nk, sq_lo, skv, causal);
          s[nj][2 + e] =
              masked_logit(s[nj][2 + e], scale, row_hi, k0 + col, Nk, sq_hi, skv, causal);
          mx_lo = fmaxf(mx_lo, s[nj][e]);
          mx_hi = fmaxf(mx_hi, s[nj][2 + e]);
        }
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));  // finite: key 0 is in tile 0
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float alpha_lo = exp2_approx((m_lo - mn_lo) * LOG2E);  // 0 on the first tile
    const float alpha_hi = exp2_approx((m_hi - mn_hi) * LOG2E);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= alpha_lo;
    l_hi *= alpha_hi;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      acc[i][0] *= alpha_lo;
      acc[i][1] *= alpha_lo;
      acc[i][2] *= alpha_hi;
      acc[i][3] *= alpha_hi;
    }
    if (unmasked) {  // mn is a real logit here, so mn * log2 e is finite
      const float c = scale * LOG2E, b_lo = -mn_lo * LOG2E, b_hi = -mn_hi * LOG2E;
#pragma unroll
      for (int nj = 0; nj < BN / 8; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nj][e] = exp2_approx(fmaf(s[nj][e], c, b_lo));
          s[nj][2 + e] = exp2_approx(fmaf(s[nj][2 + e], c, b_hi));
        }
    } else {
#pragma unroll
      for (int nj = 0; nj < BN / 8; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nj][e] = exp2_approx((s[nj][e] - mn_lo) * LOG2E);
          s[nj][2 + e] = exp2_approx((s[nj][2 + e] - mn_hi) * LOG2E);
        }
    }
#pragma unroll
    for (int nj = 0; nj < BN / 8; ++nj) {
      l_lo += s[nj][0] + s[nj][1];
      l_hi += s[nj][2] + s[nj][3];
    }

    // O += P V, P rounded to bf16 in registers as the A operand.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int db = 0; db < DH / 16; ++db) {
        uint32_t bf[4];
        load_b_cols(bf, tV, kk * 16, db, CH, lane);
        mma_16816(acc[2 * db], pa, bf[0], bf[1]);
        mma_16816(acc[2 * db + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  };
  for (int j = 0; j < n_tiles; ++j) step(j, n_tiles);
  // Causal, and a row still sees no key (keyless): the tiles above the
  // diagonal too.
  if (CAUSAL && n_tiles < all_tiles &&
      __syncthreads_or(keyless(row_lo < Nq, m_lo) || keyless(row_hi < Nq, m_hi))) {
    load_kv(n_tiles & 1, n_tiles * BN);
    cp_async_commit();
    for (int j = n_tiles; j < all_tiles; ++j) step(j, all_tiles);
  }

  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  bf16* ob = o + (size_t)bh * Nq * DH;
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (row_lo < Nq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_lo * DH + col) =
          pack_bf16(acc[i][0] * inv_lo, acc[i][1] * inv_lo);
    if (row_hi < Nq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_hi * DH + col) =
          pack_bf16(acc[i][2] * inv_hi, acc[i][3] * inv_hi);
  }
  if (t == 0) {
    if (row_lo < Nq) {
      m_out[(size_t)bh * Nq + row_lo] = m_lo;
      l_out[(size_t)bh * Nq + row_lo] = l_lo;
    }
    if (row_hi < Nq) {
      m_out[(size_t)bh * Nq + row_hi] = m_hi;
      l_out[(size_t)bh * Nq + row_hi] = l_hi;
    }
  }
}

// ---- backward: dK, dV ------------------------------------------------------
// grid (ceil(Nk / BK), H, B). One block owns BK keys and streams the query
// tiles: S^T = K Q^T, P^T = exp(S^T * scale + mask - m) / l, dP^T = V dO^T,
// dS^T = P^T (dP^T - di), dV += P^T dO, dK += dS^T Q; dK * scale at the end.
template <int DH>
struct DkvTC {
  static constexpr int WARPS = 4;                // 16 key rows each
  static constexpr int BK = 16 * WARPS;          // keys per block
  static constexpr int BQ = DH == 64 ? 64 : 32;  // queries per streamed tile
  static constexpr int NTHREADS = 32 * WARPS;
  static constexpr int CHUNKS = DH / 8;
  // K and V tiles, two stages of Q and of dO (bf16), two stages of the
  // query rows' m, 1/l, di and segment ids.
  static constexpr int ROWS = 4;
  static constexpr size_t SMEM = (size_t)(2 * BK + 4 * BQ) * DH * 2 + 2 * ROWS * BQ * 4;
};

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(DkvTC<DH>::NTHREADS)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ seg_q,
                        const int* __restrict__ seg_kv, const bf16* __restrict__ dout,
                        const float* __restrict__ m, const float* __restrict__ inv_l,
                        const float* __restrict__ di, bf16* __restrict__ dk,
                        bf16* __restrict__ dv,
                        int H, int Nq, int Nk, float scale) {
  using C = DkvTC<DH>;
  constexpr int causal = CAUSAL;
  constexpr int BK = C::BK, BQ = C::BQ, CH = C::CHUNKS;
  constexpr uint32_t Q_BYTES = BQ * DH * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + BK * DH * 2;
  const uint32_t sQ = sV + BK * DH * 2;
  const uint32_t sdO = sQ + 2 * Q_BYTES;
  const float* s_rows = reinterpret_cast<const float*>(smem + (size_t)(2 * BK + 4 * BQ) * DH * 2);
  const uint32_t sRows = smem_u32(s_rows);  // [stage][m, 1/l, di, seg][BQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, bh = b * H + blockIdx.y;
  const int k0 = blockIdx.x * BK, nk = min(BK, Nk - k0);
  const bf16* qb = q + (size_t)bh * Nq * DH;
  const bf16* dob = dout + (size_t)bh * Nq * DH;
  const float* m_b = m + (size_t)bh * Nq;
  const float* il_b = inv_l + (size_t)bh * Nq;
  const float* di_b = di + (size_t)bh * Nq;
  const int* sq_b = seg_q + (size_t)b * Nq;

  auto load_q = [&](int stage, int q0) {
    const int mq = min(BQ, Nq - q0);
    load_tile_async<BQ, DH>(sQ + stage * Q_BYTES, qb + (size_t)q0 * DH, mq, tid, C::NTHREADS);
    load_tile_async<BQ, DH>(sdO + stage * Q_BYTES, dob + (size_t)q0 * DH, mq, tid, C::NTHREADS);
    if (tid < BQ) {  // rows past Nq read as zeros: 1/l = 0 there, so P and dS are 0
      const int r = q0 + min(tid, mq - 1);
      const uint32_t dst = sRows + (stage * C::ROWS * BQ + tid) * 4;
      cp_async_4(dst, m_b + r, tid < mq);
      cp_async_4(dst + BQ * 4, il_b + r, tid < mq);
      cp_async_4(dst + 2 * BQ * 4, di_b + r, tid < mq);
      cp_async_4(dst + 3 * BQ * 4, sq_b + r, tid < mq);
    }
  };

  load_tile_async<BK, DH>(sK, k + ((size_t)bh * Nk + k0) * DH, nk, tid, C::NTHREADS);
  load_tile_async<BK, DH>(sV, v + ((size_t)bh * Nk + k0) * DH, nk, tid, C::NTHREADS);
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int n_tiles = Nq > q_begin ? (Nq - q_begin + BQ - 1) / BQ : 0;
  if (n_tiles > 0) load_q(0, q_begin);
  cp_async_commit();
  // Causal: rows before the diagonal tile that saw no key (keyless) need
  // these keys too.
  const int pre_end = min(q_begin, Nq);
  const bool pre_keyless =
      CAUSAL && pre_end > 0 && keyless_before(m_b, pre_end, tid, C::NTHREADS);

  // This thread's two key rows: g and g + 8 of the warp's 16.
  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
  const int skv_lo = key_lo < Nk ? seg_kv[(size_t)b * Nk + key_lo] : 0;
  const int skv_hi = key_hi < Nk ? seg_kv[(size_t)b * Nk + key_hi] : 0;
  float acc_k[DH / 8][4], acc_v[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // Query tile j, rows from q0; the next one, before end, from q_next.
  auto step = [&](int j, int q0, int q_next, int end) {
    const int stage = j & 1;
    if (q_next < end) load_q(stage ^ 1, q_next);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and, on the first, K and V) has landed
    __syncthreads();
    const uint32_t tQ = sQ + stage * Q_BYTES, tdO = sdO + stage * Q_BYTES;
    const float* r_m = s_rows + stage * C::ROWS * BQ;
    const float* r_il = r_m + BQ;
    const float* r_di = r_il + BQ;
    const int* r_seg = reinterpret_cast<const int*>(r_di + BQ);

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries per warp.
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[i][c] = dpt[i][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, sK, warp * 16, kk, CH, lane);
      load_a(va, sV, warp * 16, kk, CH, lane);
#pragma unroll
      for (int nb = 0; nb < BQ / 16; ++nb) {
        uint32_t bf[4];
        load_b_rows(bf, tQ, nb * 16, kk, CH, lane);
        mma_16816(st[2 * nb], ka, bf[0], bf[1]);
        mma_16816(st[2 * nb + 1], ka, bf[2], bf[3]);
        load_b_rows(bf, tdO, nb * 16, kk, CH, lane);
        mma_16816(dpt[2 * nb], va, bf[0], bf[1]);
        mma_16816(dpt[2 * nb + 1], va, bf[2], bf[3]);
      }
    }

    // P^T and dS^T = P^T (dP^T - di), elementwise in registers.
#pragma unroll
    for (int nj = 0; nj < BQ / 8; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nj * 8 + 2 * t + e, row = q0 + col;
        const float m_q = r_m[col], il_q = r_il[col], di_q = r_di[col];
        const int sq = r_seg[col];
        const float p_lo = exp2_approx(
            (masked_logit(st[nj][e], scale, row, key_lo, Nk, sq, skv_lo, causal) - m_q) * LOG2E) *
            il_q;
        const float p_hi = exp2_approx(
            (masked_logit(st[nj][2 + e], scale, row, key_hi, Nk, sq, skv_hi, causal) - m_q) *
            LOG2E) * il_q;
        st[nj][e] = p_lo;
        st[nj][2 + e] = p_hi;
        dpt[nj][e] = p_lo * (dpt[nj][e] - di_q);
        dpt[nj][2 + e] = p_hi * (dpt[nj][2 + e] - di_q);
      }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16 as A operands.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t da[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int db = 0; db < DH / 16; ++db) {
        uint32_t bf[4];
        load_b_cols(bf, tdO, kk * 16, db, CH, lane);
        mma_16816(acc_v[2 * db], pa, bf[0], bf[1]);
        mma_16816(acc_v[2 * db + 1], pa, bf[2], bf[3]);
        load_b_cols(bf, tQ, kk * 16, db, CH, lane);
        mma_16816(acc_k[2 * db], da, bf[0], bf[1]);
        mma_16816(acc_k[2 * db + 1], da, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  };
  for (int j = 0; j < n_tiles; ++j) step(j, q_begin + j * BQ, q_begin + (j + 1) * BQ, Nq);
  if (CAUSAL && pre_keyless) {  // then the tiles before the diagonal that hold such rows
    int q0 = next_keyless_tile<BQ>(m_b, 0, pre_end, tid);
    if (q0 < pre_end) load_q(n_tiles & 1, q0);
    cp_async_commit();
    for (int j = n_tiles; q0 < pre_end; ++j) {
      const int q_next = next_keyless_tile<BQ>(m_b, q0 + BQ, pre_end, tid);
      step(j, q0, q_next, pre_end);
      q0 = q_next;
    }
  }

  bf16* dkb = dk + (size_t)bh * Nk * DH;
  bf16* dvb = dv + (size_t)bh * Nk * DH;
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (key_lo < Nk) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)key_lo * DH + col) =
          pack_bf16(acc_k[i][0] * scale, acc_k[i][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)key_lo * DH + col) =
          pack_bf16(acc_v[i][0], acc_v[i][1]);
    }
    if (key_hi < Nk) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)key_hi * DH + col) =
          pack_bf16(acc_k[i][2] * scale, acc_k[i][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)key_hi * DH + col) =
          pack_bf16(acc_v[i][2], acc_v[i][3]);
    }
  }
}

// ---- backward: dQ ----------------------------------------------------------
// grid (ceil(Nq / BM), H, B). The forward's shape: one block owns BM queries
// and streams the key tiles. S = Q K^T, P = exp(S * scale + mask - m) / l,
// dP = dO V^T, dS = P (dP - di) * scale, dQ += dS K. The scale is folded
// into 1/l, so dS comes out scaled, as the library rounds it (:1256-1259).
template <int DH>
struct DqTC {
  static constexpr int WARPS = 4;                // 16 query rows each
  static constexpr int BM = 16 * WARPS;          // queries per block
  static constexpr int BN = DH == 64 ? 64 : 32;  // keys per streamed tile
  static constexpr int NTHREADS = 32 * WARPS;
  static constexpr int CHUNKS = DH / 8;
  // Q and dO tiles, two stages of K and of V (bf16), two stages of kv
  // segment ids.
  static constexpr size_t SMEM = (size_t)(2 * BM + 4 * BN) * DH * 2 + 2 * BN * 4;
};

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(DqTC<DH>::NTHREADS)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const int* __restrict__ seg_q,
                       const int* __restrict__ seg_kv, const bf16* __restrict__ dout,
                       const float* __restrict__ m, const float* __restrict__ inv_l,
                       const float* __restrict__ di, bf16* __restrict__ dq,
                       int H, int Nq, int Nk, float scale) {
  using C = DqTC<DH>;
  constexpr int causal = CAUSAL;
  constexpr int BM = C::BM, BN = C::BN, CH = C::CHUNKS;
  constexpr uint32_t KV_BYTES = BN * DH * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sdO = sQ + BM * DH * 2;
  const uint32_t sK = sdO + BM * DH * 2;
  const uint32_t sV = sK + 2 * KV_BYTES;
  const int* s_seg = reinterpret_cast<const int*>(smem + (size_t)(2 * BM + 4 * BN) * DH * 2);
  const uint32_t sSeg = smem_u32(s_seg);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, bh = b * H + blockIdx.y;
  const int q0 = blockIdx.x * BM, mq = min(BM, Nq - q0);
  const bf16* kb = k + (size_t)bh * Nk * DH;
  const bf16* vb = v + (size_t)bh * Nk * DH;
  const int* skv_b = seg_kv + (size_t)b * Nk;

  auto load_kv = [&](int stage, int k0) {
    const int nk = min(BN, Nk - k0);
    load_tile_async<BN, DH>(sK + stage * KV_BYTES, kb + (size_t)k0 * DH, nk, tid, C::NTHREADS);
    load_tile_async<BN, DH>(sV + stage * KV_BYTES, vb + (size_t)k0 * DH, nk, tid, C::NTHREADS);
    if (tid < BN) cp_async_4(sSeg + (stage * BN + tid) * 4, skv_b + k0 + min(tid, nk - 1), tid < nk);
  };

  load_tile_async<BM, DH>(sQ, q + ((size_t)bh * Nq + q0) * DH, mq, tid, C::NTHREADS);
  load_tile_async<BM, DH>(sdO, dout + ((size_t)bh * Nq + q0) * DH, mq, tid, C::NTHREADS);
  load_kv(0, 0);
  cp_async_commit();

  // This thread's two query rows, g and g + 8 of the warp's 16, and their
  // statistics in registers; 1/l carries the scale. Rows past Nq get
  // 1/l = 0, so their P and dS are 0.
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const size_t at_lo = (size_t)bh * Nq + row_lo, at_hi = (size_t)bh * Nq + row_hi;
  const bool in_lo = row_lo < Nq, in_hi = row_hi < Nq;
  const int sq_lo = in_lo ? seg_q[(size_t)b * Nq + row_lo] : 0;
  const int sq_hi = in_hi ? seg_q[(size_t)b * Nq + row_hi] : 0;
  const float m_lo = in_lo ? m[at_lo] : 0.f, m_hi = in_hi ? m[at_hi] : 0.f;
  const float il_lo = in_lo ? inv_l[at_lo] * scale : 0.f;
  const float il_hi = in_hi ? inv_l[at_hi] * scale : 0.f;
  const float di_lo = in_lo ? di[at_lo] : 0.f, di_hi = in_hi ? di[at_hi] : 0.f;
  // Causal: the key tiles up to the block's diagonal, or all of them if a
  // row saw no key in the forward (keyless).
  const int all_tiles = (Nk + BN - 1) / BN;
  const int diag_tiles = (min(Nk, q0 + mq) + BN - 1) / BN;
  const int n_tiles = causal && (diag_tiles == all_tiles ||
                                 !__syncthreads_or(keyless(in_lo, m_lo) || keyless(in_hi, m_hi)))
                          ? diag_tiles
                          : all_tiles;
  float acc[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1, k0 = j * BN;
    if (j + 1 < n_tiles) load_kv(stage ^ 1, k0 + BN);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and, on the first, Q and dO) has landed
    __syncthreads();
    const uint32_t tK = sK + stage * KV_BYTES, tV = sV + stage * KV_BYTES;

    // S = Q K^T and dP = dO V^T: 16 rows x BN keys per warp; the Q and dO
    // fragments come from their resident tiles each time, as in the forward.
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, sQ, warp * 16, kk, CH, lane);
      load_a(da, sdO, warp * 16, kk, CH, lane);
#pragma unroll
      for (int nb = 0; nb < BN / 16; ++nb) {
        uint32_t bf[4];
        load_b_rows(bf, tK, nb * 16, kk, CH, lane);
        mma_16816(s[2 * nb], qa, bf[0], bf[1]);
        mma_16816(s[2 * nb + 1], qa, bf[2], bf[3]);
        load_b_rows(bf, tV, nb * 16, kk, CH, lane);
        mma_16816(dp[2 * nb], da, bf[0], bf[1]);
        mma_16816(dp[2 * nb + 1], da, bf[2], bf[3]);
      }
    }

    // Whether the mask is 0 on the warp's whole 16 x BN block, as in the
    // forward. Warp-uniform.
    const int seg_u = s_seg[stage * BN];
    bool same = sq_lo == seg_u && sq_hi == seg_u;
#pragma unroll
    for (int c = 0; c < BN; c += 32) same = same && s_seg[stage * BN + c + lane] == seg_u;
    const bool unmasked = __all_sync(0xffffffffu, same) && k0 + BN <= Nk &&
                          (!causal || k0 + BN - 1 <= q0 + warp * 16);

    // P, then dS = P (dP - di), elementwise in registers (P into s).
    if (unmasked) {  // m is a real logit here, so m * log2 e is finite
      const float c = scale * LOG2E, b_lo = -m_lo * LOG2E, b_hi = -m_hi * LOG2E;
#pragma unroll
      for (int nj = 0; nj < BN / 8; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nj][e] = exp2_approx(fmaf(s[nj][e], c, b_lo)) * il_lo;
          s[nj][2 + e] = exp2_approx(fmaf(s[nj][2 + e], c, b_hi)) * il_hi;
        }
    } else {
#pragma unroll
      for (int nj = 0; nj < BN / 8; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nj * 8 + 2 * t + e;
          const int skv = s_seg[stage * BN + col];
          const float x_lo = masked_logit(s[nj][e], scale, row_lo, k0 + col, Nk, sq_lo, skv, causal);
          const float x_hi =
              masked_logit(s[nj][2 + e], scale, row_hi, k0 + col, Nk, sq_hi, skv, causal);
          s[nj][e] = exp2_approx((x_lo - m_lo) * LOG2E) * il_lo;
          s[nj][2 + e] = exp2_approx((x_hi - m_hi) * LOG2E) * il_hi;
        }
    }
#pragma unroll
    for (int nj = 0; nj < BN / 8; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[nj][e] = s[nj][e] * (dp[nj][e] - di_lo);
        dp[nj][2 + e] = s[nj][2 + e] * (dp[nj][2 + e] - di_hi);
      }

    // dQ += dS K, dS rounded to bf16 in registers as the A operand.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int db = 0; db < DH / 16; ++db) {
        uint32_t bf[4];
        load_b_cols(bf, tK, kk * 16, db, CH, lane);
        mma_16816(acc[2 * db], da, bf[0], bf[1]);
        mma_16816(acc[2 * db + 1], da, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  bf16* dqb = dq + (size_t)bh * Nq * DH;
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (in_lo)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)row_lo * DH + col) =
          pack_bf16(acc[i][0], acc[i][1]);
    if (in_hi)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)row_hi * DH + col) =
          pack_bf16(acc[i][2], acc[i][3]);
  }
}

// ==== fp32 FFMA ============================================================

// ---- forward (fp32) --------------------------------------------------------
// grid (ceil(Nq / 64), H, B). Writes O [B, H, Nq, DH] and m, l [B, H, Nq].
template <int DH>
__global__ void __launch_bounds__(THREADS, DH == 64 ? 2 : 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv, float* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int H, int Nq, int Nk, int causal, float scale) {
  constexpr int TF = TILE_FLOATS<DH>, CG = DH / 64;  // CG column groups of 64
  extern __shared__ float4 smem4[];
  float* q_t = reinterpret_cast<float*>(smem4);
  float* k_t = q_t + TF;
  float* v_n = k_t + TF;
  float* p_t = v_n + TF;  // P transposed: p_t[key][query]
  __shared__ int sq[TILE], skv[TILE];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, bh = b * H + blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int mq = min(TILE, Nq - q0);
  const float* qb = q + ((size_t)bh * Nq + q0) * DH;
  const float* kb = k + (size_t)bh * Nk * DH;
  const float* vb = v + (size_t)bh * Nk * DH;

  load_tile_t<DH>(qb, mq, q_t);
  if (threadIdx.x < TILE) sq[threadIdx.x] = threadIdx.x < mq ? seg_q[(size_t)b * Nq + q0 + threadIdx.x] : 0;

  float m[4], l[4], acc[CG][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[cg][i][c] = 0.f;
  }

  int k_end = causal ? min(Nk, q0 + mq) : Nk;  // all keys if a row sees none (keyless)
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    const int nk = min(TILE, Nk - k0);
    __syncthreads();  // the previous tile's readers are done
    load_tile_t<DH>(kb + (size_t)k0 * DH, nk, k_t);
    load_tile_n<DH>(vb + (size_t)k0 * DH, nk, v_n);
    if (threadIdx.x < TILE) skv[threadIdx.x] = threadIdx.x < nk ? seg_kv[(size_t)b * Nk + k0 + threadIdx.x] : 0;
    __syncthreads();

    float s[4][4] = {};
    mma_tt<DH>(q_t, ty * 4, k_t, tx * 4, s);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = masked_logit(s[i][c], scale, row, k0 + tx * 4 + c, Nk, sq[ty * 4 + i],
                               skv[tx * 4 + c], causal);
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = __expf(m[i] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = __expf(s[i][c] - m_new);
        sum += s[i][c];
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int cg = 0; cg < CG; ++cg)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[cg][i][c] *= alpha;
    }
    store_t(p_t, ty * 4, tx * 4, s);
    __syncthreads();
#pragma unroll
    for (int cg = 0; cg < CG; ++cg) mma_nn<LDN<DH>>(p_t, ty * 4, v_n, cg * 64 + tx * 4, acc[cg]);
    if (k0 + TILE >= k_end && k_end < Nk &&
        __syncthreads_or(keyless(ty * 4 < mq, m[0]) || keyless(ty * 4 + 1 < mq, m[1]) ||
                         keyless(ty * 4 + 2 < mq, m[2]) || keyless(ty * 4 + 3 < mq, m[3])))
      k_end = Nk;
  }

  float* ob = o + ((size_t)bh * Nq + q0) * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= mq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
      store4(ob + (size_t)r * DH + cg * 64 + tx * 4,
             make_float4(acc[cg][i][0] * inv, acc[cg][i][1] * inv, acc[cg][i][2] * inv,
                         acc[cg][i][3] * inv));
    if (tx == 0) {
      m_out[(size_t)bh * Nq + q0 + r] = m[i];
      l_out[(size_t)bh * Nq + q0 + r] = l[i];
    }
  }
}

// ---- backward: dK, dV (fp32) ----------------------------------------------
// grid (ceil(Nk / 64), H, B). One block owns 64 keys and streams the query
// tiles: P^T = exp(S^T - m) / l, dP^T = V dO^T, dS^T = P^T (dP^T - di) * scale,
// dV += P^T dO, dK += dS^T Q.
template <int DH>
__global__ void __launch_bounds__(THREADS, DH == 64 ? 2 : 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_kv, const float* __restrict__ dout,
                     const float* __restrict__ m, const float* __restrict__ inv_l,
                     const float* __restrict__ di, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Nq, int Nk, int causal, float scale) {
  constexpr int TF = TILE_FLOATS<DH>, CG = DH / 64;
  extern __shared__ float4 smem4[];
  float* k_t = reinterpret_cast<float*>(smem4);
  float* v_t = k_t + TF;
  float* buf_q = v_t + TF;     // Q transposed, then Q natural
  float* buf_do = buf_q + TF;  // dO transposed, then dO natural
  float* p_s = buf_do + TF;    // P as [query][key]
  float* ds_s = p_s + TILE * LD;  // dS as [query][key]
  __shared__ int sq[TILE], skv[TILE];
  __shared__ float s_m[TILE], s_il[TILE], s_di[TILE];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // ty: keys, tx: queries
  const int b = blockIdx.z, bh = b * H + blockIdx.y;
  const int k0 = blockIdx.x * TILE;
  const int nk = min(TILE, Nk - k0);
  const float* qb = q + (size_t)bh * Nq * DH;
  const float* dob = dout + (size_t)bh * Nq * DH;

  load_tile_t<DH>(k + ((size_t)bh * Nk + k0) * DH, nk, k_t);
  load_tile_t<DH>(v + ((size_t)bh * Nk + k0) * DH, nk, v_t);
  if (threadIdx.x < TILE) skv[threadIdx.x] = threadIdx.x < nk ? seg_kv[(size_t)b * Nk + k0 + threadIdx.x] : 0;

  float acc_k[CG][4][4] = {}, acc_v[CG][4][4] = {};
  // Query tile from q0.
  auto step = [&](int q0) {
    const int mq = min(TILE, Nq - q0);
    __syncthreads();
    load_tile_t<DH>(qb + (size_t)q0 * DH, mq, buf_q);
    load_tile_t<DH>(dob + (size_t)q0 * DH, mq, buf_do);
    if (threadIdx.x < TILE) {
      const bool in = threadIdx.x < mq;
      const size_t row = (size_t)bh * Nq + q0 + threadIdx.x;
      sq[threadIdx.x] = in ? seg_q[(size_t)b * Nq + q0 + threadIdx.x] : 0;
      s_m[threadIdx.x] = in ? m[row] : 0.f;
      s_il[threadIdx.x] = in ? inv_l[row] : 0.f;  // P = 0 on rows past Nq
      s_di[threadIdx.x] = in ? di[row] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    mma_tt<DH>(k_t, ty * 4, buf_q, tx * 4, s);
    mma_tt<DH>(v_t, ty * 4, buf_do, tx * 4, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = ty * 4 + a, qr = tx * 4 + c;
        // key is the row of S^T here; masked_logit takes (query row, key col).
        const float x = masked_logit(s[a][c], scale, q0 + qr, k0 + key, Nk, sq[qr], skv[key],
                                     causal);
        const float p = __expf(x - s_m[qr]) * s_il[qr];
        s[a][c] = p;
        dp[a][c] = p * (dp[a][c] - s_di[qr]) * scale;
      }
    __syncthreads();  // done reading the transposed Q and dO
    store_t(p_s, ty * 4, tx * 4, s);
    store_t(ds_s, ty * 4, tx * 4, dp);
    load_tile_n<DH>(qb + (size_t)q0 * DH, mq, buf_q);
    load_tile_n<DH>(dob + (size_t)q0 * DH, mq, buf_do);
    __syncthreads();
#pragma unroll
    for (int cg = 0; cg < CG; ++cg) {
      mma_nn<LDN<DH>>(p_s, ty * 4, buf_do, cg * 64 + tx * 4, acc_v[cg]);
      mma_nn<LDN<DH>>(ds_s, ty * 4, buf_q, cg * 64 + tx * 4, acc_k[cg]);
    }
  };
  const float* m_b = m + (size_t)bh * Nq;
  const int q_begin = causal ? (k0 / TILE) * TILE : 0, pre_end = min(q_begin, Nq);
  for (int q0 = q_begin; q0 < Nq; q0 += TILE) step(q0);
  // Causal: then the tiles before the diagonal that hold a row that saw no
  // key (keyless).
  if (pre_end > 0 && keyless_before(m_b, pre_end, threadIdx.x, THREADS))
    for (int q0 = next_keyless_tile<TILE>(m_b, 0, pre_end, threadIdx.x); q0 < pre_end;
         q0 = next_keyless_tile<TILE>(m_b, q0 + TILE, pre_end, threadIdx.x))
      step(q0);

  float* dkb = dk + ((size_t)bh * Nk + k0) * DH;
  float* dvb = dv + ((size_t)bh * Nk + k0) * DH;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty * 4 + a;
    if (r >= nk) continue;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg) {
      const int c0 = cg * 64 + tx * 4;
      store4(dkb + (size_t)r * DH + c0,
             make_float4(acc_k[cg][a][0], acc_k[cg][a][1], acc_k[cg][a][2], acc_k[cg][a][3]));
      store4(dvb + (size_t)r * DH + c0,
             make_float4(acc_v[cg][a][0], acc_v[cg][a][1], acc_v[cg][a][2], acc_v[cg][a][3]));
    }
  }
}

// ---- backward: dQ (fp32) --------------------------------------------------
// grid (ceil(Nq / 64), H, B). One block owns 64 queries and streams the key
// tiles: P = exp(S - m) / l, dP = dO V^T, dS = P (dP - di) * scale,
// dQ += dS K.
template <int DH>
__global__ void __launch_bounds__(THREADS, DH == 64 ? 2 : 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ seg_q,
                    const int* __restrict__ seg_kv, const float* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ inv_l,
                    const float* __restrict__ di, float* __restrict__ dq,
                    int H, int Nq, int Nk, int causal, float scale) {
  constexpr int TF = TILE_FLOATS<DH>, CG = DH / 64;
  extern __shared__ float4 smem4[];
  float* q_t = reinterpret_cast<float*>(smem4);
  float* do_t = q_t + TF;
  float* buf_k = do_t + TF;  // K transposed, then K natural
  float* v_t = buf_k + TF;
  float* ds_t = v_t + TF;    // dS transposed: ds_t[key][query]
  __shared__ int sq[TILE], skv[TILE];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // ty: queries, tx: keys
  const int b = blockIdx.z, bh = b * H + blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int mq = min(TILE, Nq - q0);
  const float* kb = k + (size_t)bh * Nk * DH;
  const float* vb = v + (size_t)bh * Nk * DH;

  load_tile_t<DH>(q + ((size_t)bh * Nq + q0) * DH, mq, q_t);
  load_tile_t<DH>(dout + ((size_t)bh * Nq + q0) * DH, mq, do_t);
  if (threadIdx.x < TILE) sq[threadIdx.x] = threadIdx.x < mq ? seg_q[(size_t)b * Nq + q0 + threadIdx.x] : 0;
  float row_m[4], row_il[4], row_di[4];  // rows past Nq: 1/l = 0, so P = 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    row_m[i] = r < mq ? m[(size_t)bh * Nq + q0 + r] : 0.f;
    row_il[i] = r < mq ? inv_l[(size_t)bh * Nq + q0 + r] : 0.f;
    row_di[i] = r < mq ? di[(size_t)bh * Nq + q0 + r] : 0.f;
  }

  float acc[CG][4][4] = {};
  // All keys if a row saw none in the forward (keyless).
  const int k_end =
      causal && !__syncthreads_or(keyless(ty * 4 < mq, row_m[0]) || keyless(ty * 4 + 1 < mq, row_m[1]) ||
                                  keyless(ty * 4 + 2 < mq, row_m[2]) || keyless(ty * 4 + 3 < mq, row_m[3]))
          ? min(Nk, q0 + mq)
          : Nk;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    const int nk = min(TILE, Nk - k0);
    __syncthreads();
    load_tile_t<DH>(kb + (size_t)k0 * DH, nk, buf_k);
    load_tile_t<DH>(vb + (size_t)k0 * DH, nk, v_t);
    if (threadIdx.x < TILE) skv[threadIdx.x] = threadIdx.x < nk ? seg_kv[(size_t)b * Nk + k0 + threadIdx.x] : 0;
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    mma_tt<DH>(q_t, ty * 4, buf_k, tx * 4, s);
    mma_tt<DH>(do_t, ty * 4, v_t, tx * 4, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qr = ty * 4 + i, key = tx * 4 + c;
        const float x = masked_logit(s[i][c], scale, q0 + qr, k0 + key, Nk, sq[qr], skv[key],
                                     causal);
        const float p = __expf(x - row_m[i]) * row_il[i];
        dp[i][c] = p * (dp[i][c] - row_di[i]) * scale;
      }
    __syncthreads();  // done reading the transposed K
    store_t(ds_t, ty * 4, tx * 4, dp);
    load_tile_n<DH>(kb + (size_t)k0 * DH, nk, buf_k);
    __syncthreads();
#pragma unroll
    for (int cg = 0; cg < CG; ++cg) mma_nn<LDN<DH>>(ds_t, ty * 4, buf_k, cg * 64 + tx * 4, acc[cg]);
  }

  float* dqb = dq + ((size_t)bh * Nq + q0) * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= mq) continue;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
      store4(dqb + (size_t)r * DH + cg * 64 + tx * 4,
             make_float4(acc[cg][i][0], acc[cg][i][1], acc[cg][i][2], acc[cg][i][3]));
  }
}

// ==== launches =============================================================

template <int DH>
constexpr size_t FWD_SMEM = 4 * TILE_FLOATS<DH> * sizeof(float);
template <int DH>
constexpr size_t DKV_SMEM = (4 * TILE_FLOATS<DH> + 2 * TILE * LD) * sizeof(float);
template <int DH>
constexpr size_t DQ_SMEM = (4 * TILE_FLOATS<DH> + TILE * LD) * sizeof(float);

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

inline dim3 grid_for(int n, int rows, int H, int B) { return dim3((n + rows - 1) / rows, H, B); }

// Sets the kernel's dynamic shared memory and launches it; returns the
// launch status.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int DH>
int fwd(int dtype, const void* q, const void* k, const void* v, const int* seg_q,
        const int* seg_kv, void* o, float* m, float* l, int B, int H, int Nq, int Nk, int causal,
        float scale, cudaStream_t s) {
  if (dtype == DTYPE_BF16) {
    using C = FwdTC<DH>;
    return launch(causal ? flash_fwd_tc_kernel<DH, true> : flash_fwd_tc_kernel<DH, false>,
                  grid_for(Nq, C::BM, H, B), C::NTHREADS, C::SMEM, s, (const bf16*)q,
                  (const bf16*)k, (const bf16*)v, seg_q, seg_kv, (bf16*)o, m, l, H, Nq, Nk, scale);
  }
  return launch(flash_fwd_kernel<DH>, grid_for(Nq, TILE, H, B), THREADS, FWD_SMEM<DH>, s,
                (const float*)q, (const float*)k, (const float*)v, seg_q, seg_kv, (float*)o, m, l,
                H, Nq, Nk, causal, scale);
}

template <int DH>
int bwd_dkv(int dtype, const void* q, const void* k, const void* v, const int* seg_q,
            const int* seg_kv, const void* dout, const float* m, const float* inv_l,
            const float* di, void* dk, void* dv, int B, int H, int Nq, int Nk, int causal,
            float scale, cudaStream_t s) {
  if (dtype == DTYPE_BF16) {
    using C = DkvTC<DH>;
    return launch(causal ? flash_bwd_dkv_tc_kernel<DH, true> : flash_bwd_dkv_tc_kernel<DH, false>,
                  grid_for(Nk, C::BK, H, B), C::NTHREADS, C::SMEM, s, (const bf16*)q,
                  (const bf16*)k, (const bf16*)v, seg_q, seg_kv, (const bf16*)dout, m, inv_l, di,
                  (bf16*)dk, (bf16*)dv, H, Nq, Nk, scale);
  }
  return launch(flash_bwd_dkv_kernel<DH>, grid_for(Nk, TILE, H, B), THREADS, DKV_SMEM<DH>, s,
                (const float*)q, (const float*)k, (const float*)v, seg_q, seg_kv,
                (const float*)dout, m, inv_l, di, (float*)dk, (float*)dv, H, Nq, Nk, causal,
                scale);
}

template <int DH>
int bwd_dq(int dtype, const void* q, const void* k, const void* v, const int* seg_q,
           const int* seg_kv, const void* dout, const float* m, const float* inv_l,
           const float* di, void* dq, int B, int H, int Nq, int Nk, int causal, float scale,
           cudaStream_t s) {
  if (dtype == DTYPE_BF16) {
    using C = DqTC<DH>;
    return launch(causal ? flash_bwd_dq_tc_kernel<DH, true> : flash_bwd_dq_tc_kernel<DH, false>,
                  grid_for(Nq, C::BM, H, B), C::NTHREADS, C::SMEM, s, (const bf16*)q,
                  (const bf16*)k, (const bf16*)v, seg_q, seg_kv, (const bf16*)dout, m, inv_l, di,
                  (bf16*)dq, H, Nq, Nk, scale);
  }
  return launch(flash_bwd_dq_kernel<DH>, grid_for(Nq, TILE, H, B), THREADS, DQ_SMEM<DH>, s,
                (const float*)q, (const float*)k, (const float*)v, seg_q, seg_kv,
                (const float*)dout, m, inv_l, di, (float*)dq, H, Nq, Nk, causal, scale);
}

inline bool supported(int head_dim, int dtype) {
  return (head_dim == 64 || head_dim == 128) && (dtype == DTYPE_F32 || dtype == DTYPE_BF16);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, dO, O, dQ, dK, dV); m, l
// (or 1/l) and di float32 [B, H, Nq]; segment ids int32 [B, N]; all
// contiguous, head_dim 64 or 128 (else cudaErrorInvalidValue).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, const int* seg_q,
                                const int* seg_kv, void* o, float* m, float* l, int B, int H,
                                int Nq, int Nk, int head_dim, int dtype, int causal, float scale,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!supported(head_dim, dtype)) return (int)cudaErrorInvalidValue;
  return head_dim == 64
             ? fwd<64>(dtype, q, k, v, seg_q, seg_kv, o, m, l, B, H, Nq, Nk, causal, scale, s)
             : fwd<128>(dtype, q, k, v, seg_q, seg_kv, o, m, l, B, H, Nq, Nk, causal, scale, s);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const int* seg_q,
                                    const int* seg_kv, const void* dout, const float* m,
                                    const float* inv_l, const float* di, void* dk, void* dv,
                                    int B, int H, int Nq, int Nk, int head_dim, int dtype,
                                    int causal, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!supported(head_dim, dtype)) return (int)cudaErrorInvalidValue;
  return head_dim == 64 ? bwd_dkv<64>(dtype, q, k, v, seg_q, seg_kv, dout, m, inv_l, di, dk, dv,
                                      B, H, Nq, Nk, causal, scale, s)
                        : bwd_dkv<128>(dtype, q, k, v, seg_q, seg_kv, dout, m, inv_l, di, dk,
                                       dv, B, H, Nq, Nk, causal, scale, s);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const int* seg_q,
                                   const int* seg_kv, const void* dout, const float* m,
                                   const float* inv_l, const float* di, void* dq, int B, int H,
                                   int Nq, int Nk, int head_dim, int dtype, int causal,
                                   float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!supported(head_dim, dtype)) return (int)cudaErrorInvalidValue;
  return head_dim == 64 ? bwd_dq<64>(dtype, q, k, v, seg_q, seg_kv, dout, m, inv_l, di, dq, B, H,
                                     Nq, Nk, causal, scale, s)
                        : bwd_dq<128>(dtype, q, k, v, seg_q, seg_kv, dout, m, inv_l, di, dq, B,
                                      H, Nq, Nk, causal, scale, s);
}
