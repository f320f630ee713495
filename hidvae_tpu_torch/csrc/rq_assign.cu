// Fused L-level residual quantization for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rq_kernel` / `rq_assign` in
// hidvae_tpu/ops/pallas/rq_kernels.py (kernel at :32, pallas_call at :83).
// For every row of x [B, D] and every level l of codebooks [L, K, D]:
//   dist_k = (||r||^2 + ||c_k||^2) - 2 r.c_k     (fp32 FMA, no TF32)
//   id     = argmin_k dist_k                      (first index on ties)
//   qsum  += c_id;  r -= c_id                     (lookup by gather)
// Outputs ids [B, L] int32 and qsum [B, D] fp32.
//
// What bounds it: at B = 1M, D = 32, L = 3, K = 256 the distance products are
// 2*B*K*D*L = 51.5 GFLOP against ~280 MB of traffic, so fp32 arithmetic
// (67 TFLOP/s on an H100 SXM outside the tensor cores) sets the bound, not
// memory. The design keeps everything the arithmetic touches on chip: one
// thread owns one row and keeps its residual and running qsum in registers;
// the block stages one level's [K, D] codebook (32 KB at D = 32, 64 KB at
// D = 64) and its K squared norms in shared memory, so the inner loop is a
// broadcast 16-byte shared load feeding four FMAs. The [B, K] distance matrix
// never exists in device memory. The ragged last block is masked, not padded:
// its idle threads take part in the barriers and write nothing. Built for
// D = 32, 64 and 128; at D = 128 the residual alone fills 128 registers, so
// the running qsum is kept in the output row instead (same fp32 sums, in the
// same order) and the codebook stage is 128 KB.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int D>
__global__ void __launch_bounds__(kThreads)
rq_assign_kernel(const float* __restrict__ x, const float* __restrict__ codebooks,
                 int32_t* __restrict__ ids, float* __restrict__ qsum,
                 long long n_rows, int n_levels, int n_embed) {
  extern __shared__ float4 smem4[];
  float* cb_s = reinterpret_cast<float*>(smem4);  // [K, D]
  float* c2_s = cb_s + (size_t)n_embed * D;       // [K]

  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool active = row < n_rows;

  constexpr bool kQInRegisters = D <= 64;
  float r[D];
  float q[kQInRegisters ? D : 1];
  const float4* x4 = reinterpret_cast<const float4*>(x + (active ? row : 0) * D);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    float4 v = active ? x4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    r[4 * i + 0] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int d = 0; d < (kQInRegisters ? D : 1); ++d) q[d] = 0.f;

  const int n_vec = n_embed * D / 4;
  for (int level = 0; level < n_levels; ++level) {
    __syncthreads();  // every thread is done with the previous level's codebook
    const float4* src = reinterpret_cast<const float4*>(codebooks + (size_t)level * n_embed * D);
    for (int i = threadIdx.x; i < n_vec; i += kThreads) smem4[i] = src[i];
    __syncthreads();
    for (int k = threadIdx.x; k < n_embed; k += kThreads) {
      const float* c = cb_s + (size_t)k * D;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(c[d], c[d], s);
      c2_s[k] = s;
    }
    __syncthreads();

    float x2 = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) x2 = fmaf(r[d], r[d], x2);

    float best = INFINITY;
    int best_k = 0;
#pragma unroll 2
    for (int k = 0; k < n_embed; ++k) {
      const float4* c4 = reinterpret_cast<const float4*>(cb_s + (size_t)k * D);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        const float4 c = c4[i];
        dot = fmaf(r[4 * i + 0], c.x, dot);
        dot = fmaf(r[4 * i + 1], c.y, dot);
        dot = fmaf(r[4 * i + 2], c.z, dot);
        dot = fmaf(r[4 * i + 3], c.w, dot);
      }
      // Same association as the reference: (x2 + c2) - 2 * xc. 2 * xc is
      // exact in fp32, so a contracted FMA rounds identically.
      const float dist = (x2 + c2_s[k]) - 2.0f * dot;
      if (dist < best) {  // strict: the first index wins a tie
        best = dist;
        best_k = k;
      }
    }

    const float* code = cb_s + (size_t)best_k * D;
#pragma unroll
    for (int d = 0; d < D; ++d) r[d] -= code[d];
    if constexpr (kQInRegisters) {
#pragma unroll
      for (int d = 0; d < D; ++d) q[d] += code[d];
    } else if (active) {  // qsum row += code, as 0 + code on the first level
      float4* out4 = reinterpret_cast<float4*>(qsum + row * D);
      const float4* c4 = reinterpret_cast<const float4*>(code);
      for (int i = 0; i < D / 4; ++i) {
        const float4 c = c4[i];
        const float4 o = level == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : out4[i];
        out4[i] = make_float4(o.x + c.x, o.y + c.y, o.z + c.z, o.w + c.w);
      }
    }
    if (active) ids[row * n_levels + level] = best_k;
  }

  if constexpr (kQInRegisters) {
    if (active) {
      float4* out4 = reinterpret_cast<float4*>(qsum + row * D);
#pragma unroll
      for (int i = 0; i < D / 4; ++i)
        out4[i] = make_float4(q[4 * i + 0], q[4 * i + 1], q[4 * i + 2], q[4 * i + 3]);
    }
  }
}

template <int D>
cudaError_t launch(const float* x, const float* codebooks, int32_t* ids, float* qsum,
                   long long n_rows, int n_levels, int n_embed, cudaStream_t stream) {
  const size_t smem = ((size_t)n_embed * D + n_embed) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rq_assign_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (n_rows + kThreads - 1) / kThreads;
  rq_assign_kernel<D><<<(unsigned int)blocks, kThreads, smem, stream>>>(
      x, codebooks, ids, qsum, n_rows, n_levels, n_embed);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes. Pointers are device pointers of contiguous fp32 /
// int32 tensors; the wrapper (hidvae_tpu_torch/ops/rq_assign.py) checks
// shapes, types, alignment and n_rows > 0. Returns the cudaError_t of the
// launch; 0 is success. Dimensions without an instantiation return
// cudaErrorInvalidValue.
extern "C" int rq_assign_launch(const void* x, const void* codebooks, void* ids, void* qsum,
                                long long n_rows, int dim, int n_levels, int n_embed,
                                void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(codebooks);
  int32_t* id = static_cast<int32_t*>(ids);
  float* qs = static_cast<float*>(qsum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 32: return (int)launch<32>(xf, cf, id, qs, n_rows, n_levels, n_embed, s);
    case 64: return (int)launch<64>(xf, cf, id, qs, n_rows, n_levels, n_embed, s);
    case 128: return (int)launch<128>(xf, cf, id, qs, n_rows, n_levels, n_embed, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
