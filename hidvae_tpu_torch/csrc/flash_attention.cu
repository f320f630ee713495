// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels with
// segment-id masking, for head_dim 64 and fp32 or bf16 inputs.
//
// Replaces the three Pallas TPU kernels that the JAX package reaches through
// `_flash_self_attention` (hidvae_tpu/models/attention.py:75) and the `jax`
// library's `flash_attention` (jax/experimental/pallas/ops/tpu/
// flash_attention.py, jax 0.9.0):
//   flash_fwd      <- _flash_attention_kernel      (:331, pallas_call :758)
//   flash_bwd_dkv  <- _flash_attention_dkv_kernel  (:796, pallas_call :1121)
//   flash_bwd_dq   <- _flash_attention_dq_kernel   (:1146, pallas_call :1456)
// The semantics are the library's: logits = (q k^T) * sm_scale, plus
// -0.7 * FLT_MAX where the segment ids differ (or, when causal, where the key
// comes after the query); softmax in fp32; the backward takes
// di = rowsum(dO * O) and recomputes P from the saved row logsumexp.
//
// Bound. At the long-history training shape (B 64, H 8, N 2432, Dh 64) one
// [N, N] x [N, 64] product per head is 2*B*H*N^2*Dh = 3.9e11 operations; the
// forward does two, dK/dV four, dQ three. The bytes are q, k, v, O (and dO,
// dQ, dK, dV) once each, about 160 MB apiece in bf16: some 0.2 ms at
// 3.35 TB/s against 0.8 ms of bf16 tensor-core work for the forward. So
// arithmetic bounds every kernel, by a factor of four or more.
//
// Design. This first version does its arithmetic in fp32 FFMA (no tensor
// cores, no TF32), so it is held to the 67 TFLOP/s fp32 rate, about 15x
// above the bf16 tensor-core bound; moving the products to wgmma is later
// work. What the design does for the arithmetic bound:
//   * no [N, N] matrix ever reaches device memory: one block owns a 64-row
//     tile (queries for the forward and dQ, keys for dK/dV) and streams the
//     other side's 64-row tiles through shared memory, with an online
//     softmax in the forward;
//   * each of the 256 threads owns a 4 x 4 sub-tile of every 64 x 64
//     product, so one broadcast and one contiguous 16-byte shared load feed
//     16 FMAs;
//   * the operands of the first products are stored transposed ([d][row],
//     rows padded to 68 floats) so those loads are 16-byte and aligned;
//   * causal blocks skip the tiles above the diagonal; ragged tails (rows or
//     keys past N) are masked in the block, so N need not be a multiple of 64.
//
// Each C entry point launches on the given stream and returns
// cudaGetLastError(); the Python wrapper (hidvae_tpu_torch/ops/
// flash_attention.py) allocates every output and raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;         // head dim
constexpr int TILE = 64;       // rows of every tile
constexpr int THREADS = 256;   // 16 x 16 threads, a 4 x 4 sub-tile each
constexpr int LD = 68;         // padded shared row, in floats (16-byte aligned)
constexpr int TILE_FLOATS = TILE * LD;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;  // the library's DEFAULT_MASK_VALUE

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Rows [row0, row0 + n) of a [*, DH] matrix into dst[d * LD + r] (transposed);
// rows r >= n are zero.
template <typename T>
__device__ __forceinline__ void load_tile_t(const T* src, int n, float* dst) {
  for (int idx = threadIdx.x; idx < TILE * DH / 4; idx += THREADS) {
    const int r = idx % TILE, d0 = (idx / TILE) * 4;
    const float4 x = r < n ? load4(src + (size_t)r * DH + d0) : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[(d0 + 0) * LD + r] = x.x;
    dst[(d0 + 1) * LD + r] = x.y;
    dst[(d0 + 2) * LD + r] = x.z;
    dst[(d0 + 3) * LD + r] = x.w;
  }
}

// The same rows into dst[r * LD + d] (natural layout); rows r >= n are zero.
template <typename T>
__device__ __forceinline__ void load_tile_n(const T* src, int n, float* dst) {
  for (int idx = threadIdx.x; idx < TILE * DH / 4; idx += THREADS) {
    const int r = idx / (DH / 4), d0 = (idx % (DH / 4)) * 4;
    const float4 x = r < n ? load4(src + (size_t)r * DH + d0) : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + r * LD + d0, x);
  }
}

// acc[a][c] += sum_d A[d][ra + a] * B[d][rb + c] over d < DH, both operands
// stored transposed.
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
// [r][row], X in natural layout [r][col].
__device__ __forceinline__ void mma_nn(const float* p, int ra, const float* x, int cb,
                                       float acc[4][4]) {
#pragma unroll 8
  for (int r = 0; r < TILE; ++r) {
    const float4 a = load4(p + r * LD + ra);
    const float4 b = load4(x + r * LD + cb);
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

// The library's masked, scaled logit of query `row` against key `col`;
// keys at or past nk do not exist (-inf).
__device__ __forceinline__ float masked_logit(float s, float scale, int row, int col, int nk,
                                              int seg_q, int seg_kv, int causal) {
  if (col >= nk) return -INFINITY;
  const bool ok = seg_q == seg_kv && (!causal || col <= row);
  return s * scale + (ok ? 0.f : MASK_VALUE);
}

// ---- forward --------------------------------------------------------------
// grid (ceil(Nq / 64), H, B). Writes O [B, H, Nq, 64] and the row logsumexp
// lse [B, H, Nq] (fp32), which the backward kernels use for P.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                 T* __restrict__ o, float* __restrict__ lse,
                 int H, int Nq, int Nk, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* q_t = reinterpret_cast<float*>(smem4);
  float* k_t = q_t + TILE_FLOATS;
  float* v_n = k_t + TILE_FLOATS;
  float* p_t = v_n + TILE_FLOATS;  // P transposed: p_t[key][query]
  __shared__ int sq[TILE], skv[TILE];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, bh = b * H + blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int mq = min(TILE, Nq - q0);
  const T* qb = q + ((size_t)bh * Nq + q0) * DH;
  const T* kb = k + (size_t)bh * Nk * DH;
  const T* vb = v + (size_t)bh * Nk * DH;

  load_tile_t(qb, mq, q_t);
  if (threadIdx.x < TILE) sq[threadIdx.x] = threadIdx.x < mq ? seg_q[(size_t)b * Nq + q0 + threadIdx.x] : 0;

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(Nk, q0 + mq) : Nk;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    const int nk = min(TILE, Nk - k0);
    __syncthreads();  // the previous tile's readers are done
    load_tile_t(kb + (size_t)k0 * DH, nk, k_t);
    load_tile_n(vb + (size_t)k0 * DH, nk, v_n);
    if (threadIdx.x < TILE) skv[threadIdx.x] = threadIdx.x < nk ? seg_kv[(size_t)b * Nk + k0 + threadIdx.x] : 0;
    __syncthreads();

    float s[4][4] = {};
    mma_tt(q_t, ty * 4, k_t, tx * 4, s);

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
      for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
    }
    store_t(p_t, ty * 4, tx * 4, s);
    __syncthreads();
    mma_nn(p_t, ty * 4, v_n, tx * 4, acc);
  }

  T* ob = o + ((size_t)bh * Nq + q0) * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= mq) continue;
    const float inv = 1.f / l[i];
    store4(ob + (size_t)r * DH + tx * 4,
           make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv));
    if (tx == 0) lse[(size_t)bh * Nq + q0 + r] = m[i] + logf(l[i]);
  }
}

// ---- backward: dK, dV -----------------------------------------------------
// grid (ceil(Nk / 64), H, B). One block owns 64 keys and streams the query
// tiles: P^T = exp(S^T - lse), dP^T = V dO^T, dS^T = P^T (dP^T - di) * scale,
// dV += P^T dO, dK += dS^T Q.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
                     int H, int Nq, int Nk, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* k_t = reinterpret_cast<float*>(smem4);
  float* v_t = k_t + TILE_FLOATS;
  float* buf_q = v_t + TILE_FLOATS;    // Q transposed, then Q natural
  float* buf_do = buf_q + TILE_FLOATS;  // dO transposed, then dO natural
  float* p_s = buf_do + TILE_FLOATS;   // P as [query][key]
  float* ds_s = p_s + TILE_FLOATS;     // dS as [query][key]
  __shared__ int sq[TILE], skv[TILE];
  __shared__ float s_lse[TILE], s_di[TILE];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // ty: keys, tx: queries
  const int b = blockIdx.z, bh = b * H + blockIdx.y;
  const int k0 = blockIdx.x * TILE;
  const int nk = min(TILE, Nk - k0);
  const T* qb = q + (size_t)bh * Nq * DH;
  const T* dob = dout + (size_t)bh * Nq * DH;

  load_tile_t(k + ((size_t)bh * Nk + k0) * DH, nk, k_t);
  load_tile_t(v + ((size_t)bh * Nk + k0) * DH, nk, v_t);
  if (threadIdx.x < TILE) skv[threadIdx.x] = threadIdx.x < nk ? seg_kv[(size_t)b * Nk + k0 + threadIdx.x] : 0;

  float acc_k[4][4] = {}, acc_v[4][4] = {};
  const int q_begin = causal ? (k0 / TILE) * TILE : 0;
  for (int q0 = q_begin; q0 < Nq; q0 += TILE) {
    const int mq = min(TILE, Nq - q0);
    __syncthreads();
    load_tile_t(qb + (size_t)q0 * DH, mq, buf_q);
    load_tile_t(dob + (size_t)q0 * DH, mq, buf_do);
    if (threadIdx.x < TILE) {
      const bool in = threadIdx.x < mq;
      const size_t row = (size_t)bh * Nq + q0 + threadIdx.x;
      sq[threadIdx.x] = in ? seg_q[(size_t)b * Nq + q0 + threadIdx.x] : 0;
      s_lse[threadIdx.x] = in ? lse[row] : INFINITY;  // P = 0 on rows past Nq
      s_di[threadIdx.x] = in ? di[row] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    mma_tt(k_t, ty * 4, buf_q, tx * 4, s);
    mma_tt(v_t, ty * 4, buf_do, tx * 4, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = ty * 4 + a, qr = tx * 4 + c;
        // key is the row of S^T here; masked_logit takes (query row, key col).
        const float x = masked_logit(s[a][c], scale, q0 + qr, k0 + key, Nk, sq[qr], skv[key],
                                     causal);
        const float p = __expf(x - s_lse[qr]);
        s[a][c] = p;
        dp[a][c] = p * (dp[a][c] - s_di[qr]) * scale;
      }
    __syncthreads();  // done reading the transposed Q and dO
    store_t(p_s, ty * 4, tx * 4, s);
    store_t(ds_s, ty * 4, tx * 4, dp);
    load_tile_n(qb + (size_t)q0 * DH, mq, buf_q);
    load_tile_n(dob + (size_t)q0 * DH, mq, buf_do);
    __syncthreads();
    mma_nn(p_s, ty * 4, buf_do, tx * 4, acc_v);
    mma_nn(ds_s, ty * 4, buf_q, tx * 4, acc_k);
  }

  T* dkb = dk + ((size_t)bh * Nk + k0) * DH;
  T* dvb = dv + ((size_t)bh * Nk + k0) * DH;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty * 4 + a;
    if (r >= nk) continue;
    store4(dkb + (size_t)r * DH + tx * 4, make_float4(acc_k[a][0], acc_k[a][1], acc_k[a][2], acc_k[a][3]));
    store4(dvb + (size_t)r * DH + tx * 4, make_float4(acc_v[a][0], acc_v[a][1], acc_v[a][2], acc_v[a][3]));
  }
}

// ---- backward: dQ ---------------------------------------------------------
// grid (ceil(Nq / 64), H, B). One block owns 64 queries and streams the key
// tiles: P = exp(S - lse), dP = dO V^T, dS = P (dP - di) * scale, dQ += dS K.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq,
                    int H, int Nq, int Nk, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* q_t = reinterpret_cast<float*>(smem4);
  float* do_t = q_t + TILE_FLOATS;
  float* buf_k = do_t + TILE_FLOATS;  // K transposed, then K natural
  float* v_t = buf_k + TILE_FLOATS;
  float* ds_t = v_t + TILE_FLOATS;    // dS transposed: ds_t[key][query]
  __shared__ int sq[TILE], skv[TILE];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // ty: queries, tx: keys
  const int b = blockIdx.z, bh = b * H + blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int mq = min(TILE, Nq - q0);
  const T* kb = k + (size_t)bh * Nk * DH;
  const T* vb = v + (size_t)bh * Nk * DH;

  load_tile_t(q + ((size_t)bh * Nq + q0) * DH, mq, q_t);
  load_tile_t(dout + ((size_t)bh * Nq + q0) * DH, mq, do_t);
  if (threadIdx.x < TILE) sq[threadIdx.x] = threadIdx.x < mq ? seg_q[(size_t)b * Nq + q0 + threadIdx.x] : 0;
  float row_lse[4], row_di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    row_lse[i] = r < mq ? lse[(size_t)bh * Nq + q0 + r] : INFINITY;
    row_di[i] = r < mq ? di[(size_t)bh * Nq + q0 + r] : 0.f;
  }

  float acc[4][4] = {};
  const int k_end = causal ? min(Nk, q0 + mq) : Nk;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    const int nk = min(TILE, Nk - k0);
    __syncthreads();
    load_tile_t(kb + (size_t)k0 * DH, nk, buf_k);
    load_tile_t(vb + (size_t)k0 * DH, nk, v_t);
    if (threadIdx.x < TILE) skv[threadIdx.x] = threadIdx.x < nk ? seg_kv[(size_t)b * Nk + k0 + threadIdx.x] : 0;
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    mma_tt(q_t, ty * 4, buf_k, tx * 4, s);
    mma_tt(do_t, ty * 4, v_t, tx * 4, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qr = ty * 4 + i, key = tx * 4 + c;
        const float x = masked_logit(s[i][c], scale, q0 + qr, k0 + key, Nk, sq[qr], skv[key],
                                     causal);
        const float p = __expf(x - row_lse[i]);
        dp[i][c] = p * (dp[i][c] - row_di[i]) * scale;
      }
    __syncthreads();  // done reading the transposed K
    store_t(ds_t, ty * 4, tx * 4, dp);
    load_tile_n(kb + (size_t)k0 * DH, nk, buf_k);
    __syncthreads();
    mma_nn(ds_t, ty * 4, buf_k, tx * 4, acc);
  }

  T* dqb = dq + ((size_t)bh * Nq + q0) * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= mq) continue;
    store4(dqb + (size_t)r * DH + tx * 4, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

constexpr size_t FWD_SMEM = 4 * TILE_FLOATS * sizeof(float);
constexpr size_t DKV_SMEM = 6 * TILE_FLOATS * sizeof(float);
constexpr size_t DQ_SMEM = 5 * TILE_FLOATS * sizeof(float);

inline dim3 grid_for(int n, int H, int B) { return dim3((n + TILE - 1) / TILE, H, B); }

template <typename T>
int fwd(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv, void* o,
        float* lse, int B, int H, int Nq, int Nk, int causal, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<T><<<grid_for(Nq, H, B), THREADS, FWD_SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, seg_q, seg_kv, (T*)o, lse, H, Nq, Nk, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv,
            const void* dout, const float* lse, const float* di, void* dk, void* dv, int B, int H,
            int Nq, int Nk, int causal, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<T><<<grid_for(Nk, H, B), THREADS, DKV_SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, seg_q, seg_kv, (const T*)dout, lse, di, (T*)dk,
      (T*)dv, H, Nq, Nk, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv,
           const void* dout, const float* lse, const float* di, void* dq, int B, int H, int Nq,
           int Nk, int causal, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T><<<grid_for(Nq, H, B), THREADS, DQ_SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, seg_q, seg_kv, (const T*)dout, lse, di, (T*)dq, H,
      Nq, Nk, causal, scale);
  return (int)cudaGetLastError();
}

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs O, dQ, dK,
// dV share it); lse and di are float32; segment ids int32 [B, N]. All
// tensors contiguous, [B, H, N, 64] for the matrices.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, const int* seg_q,
                                const int* seg_kv, void* o, float* lse, int B, int H, int Nq,
                                int Nk, int dtype, int causal, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32) return fwd<float>(q, k, v, seg_q, seg_kv, o, lse, B, H, Nq, Nk, causal, scale, s);
  if (dtype == DTYPE_BF16)
    return fwd<__nv_bfloat16>(q, k, v, seg_q, seg_kv, o, lse, B, H, Nq, Nk, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const int* seg_q,
                                    const int* seg_kv, const void* dout, const float* lse,
                                    const float* di, void* dk, void* dv, int B, int H, int Nq,
                                    int Nk, int dtype, int causal, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return bwd_dkv<float>(q, k, v, seg_q, seg_kv, dout, lse, di, dk, dv, B, H, Nq, Nk, causal, scale, s);
  if (dtype == DTYPE_BF16)
    return bwd_dkv<__nv_bfloat16>(q, k, v, seg_q, seg_kv, dout, lse, di, dk, dv, B, H, Nq, Nk,
                                  causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const int* seg_q,
                                   const int* seg_kv, const void* dout, const float* lse,
                                   const float* di, void* dq, int B, int H, int Nq, int Nk,
                                   int dtype, int causal, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return bwd_dq<float>(q, k, v, seg_q, seg_kv, dout, lse, di, dq, B, H, Nq, Nk, causal, scale, s);
  if (dtype == DTYPE_BF16)
    return bwd_dq<__nv_bfloat16>(q, k, v, seg_q, seg_kv, dout, lse, di, dq, B, H, Nq, Nk, causal,
                                 scale, s);
  return (int)cudaErrorInvalidValue;
}
