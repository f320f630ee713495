// Fused L-level residual quantization for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rq_kernel` / `rq_assign` in
// hidvae_tpu/ops/pallas/rq_kernels.py (kernel at :32, pallas_call at :83).
// For every row of x [B, D] and every level l of codebooks [L, K, D]:
//   dist_k = (||r||^2 + ||c_k||^2) - 2 r.c_k     (fp32 FMA, no TF32)
//   id     = argmin_k dist_k                      (first index on ties)
//   qsum  += c_id;  r -= c_id
// Outputs ids [B, L] int32, qsum [B, D] fp32. Bound by fp32 arithmetic
// (2*B*K*D*L operations against ~4*B*(2D + L) bytes); FFMA, as the JAX
// kernel's Precision.HIGHEST: TF32 would flip near ties.
//
// Design: a persistent grid of a block a SM (16 warps at D 16 and 32, 12 at
// D 64, 4 at D 128), no block barrier in the steady state.
// * Codebooks staged once a block, transposed to [D][KP] with norms: all
//   levels if they fit (a cp.async group each), else streamed by level.
// * A warp owns 16 rows; the next tile's rows arrive by cp.async meanwhile.
// * A lane computes a 4 x 8 micro-tile; 8 lanes sweep the codes in passes
//   of 64 and reduce (dist, k) lexicographically: the first index wins.
// * qsum = ((0 + c_id0) + c_id1) + ...: each value in the reference's
//   expression and order, so ids and qsum are bitwise a row-a-thread's.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

// Shape for code width D. Warps work alone: each owns 16 rows (4 lane
// groups x 4) and sweeps every code, 8 lanes x 4 * NG a pass, reducing the
// argmin in the warp. Fewer warps at wider D (row buffers grow with D; at
// D 64, 12 was taken of 8, 12 and 14 timed); a codebook too large for
// WARPS warps gets fewer (read at run time).
template <int D>
struct Cfg {
  // D 16: 16 warps as at D 32, whose row buffers are twice as large; more
  // warps would fit in shared memory, but 512 threads leave each its 128
  // registers under __launch_bounds__(THREADS, 1), and 24 would spill.
  static constexpr int WARPS = D <= 32 ? 16 : (D == 64 ? 12 : 4);  // warps a block, at most
  static constexpr int NG = 2;        // C = 4 * NG codes per thread and pass
  static constexpr int UNROLL = 8;    // d steps unrolled (a full unroll spills)
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int ROWS = 16;     // rows a warp owns at a time
  static constexpr int RP = ROWS + 4; // padded d-major row stride (16-byte aligned)
  static constexpr int KC = 32 * NG;  // codes a warp sweeps in one pass
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, asynchronously; zeros when not `valid`.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `n` of this thread's committed groups are still in
// flight (waits for more when n > 6, which is never wrong).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::); break;
  }
}

// (d, k) < (best_d, best_k), lexicographically.
__device__ __forceinline__ bool better(float d, int k, float best_d, int best_k) {
  return d < best_d || (d == best_d && k < best_k);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
rq_assign_kernel(const float* __restrict__ x, const float* __restrict__ codebooks,
                 int32_t* __restrict__ ids, float* __restrict__ qsum, long long n_rows,
                 int n_levels, int n_embed, int kp, int n_pass, int resident) {
  using C = Cfg<D>;
  constexpr int ROWS = C::ROWS, RP = C::RP, NG = C::NG, KC = C::KC;
  extern __shared__ float4 smem4[];
  const int n_slots = resident ? n_levels : 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int threads = blockDim.x, warps = threads >> 5;
  float* cb_s = reinterpret_cast<float*>(smem4);  // [slot][D][kp], d-major
  float* c2_s = cb_s + (size_t)n_slots * D * kp;  // [slot][kp]
  float* warp_s = c2_s + (size_t)n_slots * kp;    // per warp: [2][D][RP] rows, [ROWS] norms
  float* rows_s = warp_s + warp * (2 * D * RP + ROWS);
  float* x2_s = rows_s + 2 * D * RP;
  int* id_s = reinterpret_cast<int*>(warp_s + warps * (2 * D * RP + ROWS)) +
              warp * n_levels * ROWS;             // [L][ROWS]

  const int rg = lane >> 3, cg = lane & 7;  // this lane's rows 4 rg + i, codes 4 cg + j
  const long long n_tiles = (n_rows + ROWS - 1) / ROWS;
  const long long stride = (long long)gridDim.x * warps;
  // Warp w of block b takes tiles b + gridDim.x * (w + warps * it): a small
  // launch spreads over every block before it fills a block's warps.
  const long long first = blockIdx.x + (long long)gridDim.x * warp;
  const int kpad = n_pass * KC;  // codes k in [n_embed, kpad) are zero, with infinite norm

  auto slot = [&](int level) { return cb_s + (size_t)(resident ? level : 0) * D * kp; };
  auto norms = [&](int level) { return c2_s + (size_t)(resident ? level : 0) * kp; };

  // Level `level`'s codebook into its slot, transposed: cb[d][k] = c_k[d].
  // All threads of the block.
  auto stage_level = [&](int level) {
    const float* src = codebooks + (size_t)level * n_embed * D;
    const uint32_t dst = smem_u32(slot(level));
    for (int i = tid; i < kpad * D; i += threads) {
      const int k = i / D, d = i % D;
      const bool valid = k < n_embed;
      cp_async_4(dst + (uint32_t)(d * kp + k) * 4, src + (valid ? i : 0), valid);
    }
  };
  // Squared norms of a staged level, in the reference's order. All threads.
  auto stage_norms = [&](int level) {
    const float* cb = slot(level);
    float* c2 = norms(level);
    for (int k = tid; k < kpad; k += threads) {
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(cb[d * kp + k], cb[d * kp + k], s);
      c2[k] = k < n_embed ? s : INFINITY;
    }
  };
  // Rows of tile `tile` into this warp's buffer `buf`, transposed. The warp.
  auto stage_rows = [&](int buf, long long tile) {
    const uint32_t dst = smem_u32(rows_s + buf * D * RP);
    const float* src = x + tile * ROWS * D;
    const long long rows = n_rows - tile * ROWS;
    for (int i = lane; i < ROWS * D; i += 32) {
      const int row = i / D, d = i % D;
      const bool valid = row < rows;
      cp_async_4(dst + (uint32_t)(d * RP + row) * 4, src + (valid ? i : 0), valid);
    }
  };
  // qsum of the tile's rows over levels [l0, l1]: ((q + c_l0) + ...) with
  // q = 0 when l0 = 0, else the output row so far; d fastest, coalesced.
  auto add_codes = [&](long long tile, int l0, int l1) {
    for (int i = lane; i < ROWS * D; i += 32) {
      const int row = i / D, d = i % D;
      const long long g = tile * ROWS + row;
      if (g >= n_rows) break;  // rows of the tile only grow with i
      float q = l0 == 0 ? 0.f : qsum[g * D + d];
      for (int l = l0; l <= l1; ++l) q += slot(l)[d * kp + id_s[l * ROWS + row]];
      qsum[g * D + d] = q;
    }
  };
  // Squared norm of residual row `row` of buffer `r`, in the reference's order.
  auto row_norm = [&](const float* r, int row) {
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s = fmaf(r[d * RP + row], r[d * RP + row], s);
    return s;
  };

  // Every warp runs the first iteration (its barriers stage the codebooks);
  // streamed, every warp runs as many iterations as warp 0.
  const long long mine = first < n_tiles ? (n_tiles - first + stride - 1) / stride : 0;
  const long long n_iter = resident ? (mine > 0 ? mine : 1)
                                    : (n_tiles - blockIdx.x + stride - 1) / stride;

  // Prologue: this warp's first rows with level 0, then the other levels,
  // one cp.async group each.
  if (first < n_tiles) stage_rows(0, first);
  stage_level(0);
  cp_async_commit();
  if (resident)
    for (int l = 1; l < n_levels; ++l) {
      stage_level(l);
      cp_async_commit();
    }

  for (long long it = 0; it < n_iter; ++it) {
    const long long tile = first + it * stride;
    const bool have = tile < n_tiles;
    const int buf = it & 1;
    float* r = rows_s + buf * D * RP;
    if (tile + stride < n_tiles) stage_rows(buf ^ 1, tile + stride);
    cp_async_commit();
    // This tile's rows (and, on the first, level 0) have landed; later
    // levels and the next tile may still be in flight.
    cp_async_wait_upto(it == 0 && resident ? n_levels : 1);
    __syncwarp();
    if (have && lane < ROWS) x2_s[lane] = row_norm(r, lane);
    __syncwarp();

    for (int level = 0; level < n_levels; ++level) {
      if (!resident) {  // stream this level into the one slot
        __syncthreads();  // every warp is done with the slot's last level
        if (level > 0 || it > 0) stage_level(level);
        cp_async_commit();
        cp_async_wait_upto(0);
        __syncthreads();
        stage_norms(level);
        __syncthreads();
      } else if (it == 0) {
        cp_async_wait_upto(n_levels - level);  // this level has landed
        __syncthreads();
        stage_norms(level);
        __syncthreads();
      }
      if (!have) continue;
      const float* cb = slot(level);
      const float* c2 = norms(level);

      float best[4], x2[4];
      int best_k[4];
      {
        const float4 v = *reinterpret_cast<const float4*>(x2_s + 4 * rg);
        x2[0] = v.x;
        x2[1] = v.y;
        x2[2] = v.z;
        x2[3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        best[i] = INFINITY;
        best_k[i] = INT_MAX;
      }
      for (int pass = 0; pass < n_pass; ++pass) {
        const int kbase = pass * KC + 4 * cg;
        float acc[4][4 * NG];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.f;
#pragma unroll C::UNROLL
        for (int d = 0; d < D; ++d) {
          const float4 rv = *reinterpret_cast<const float4*>(r + d * RP + 4 * rg);
          const float rr[4] = {rv.x, rv.y, rv.z, rv.w};
          float cv[4 * NG];
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const float4 v =
                *reinterpret_cast<const float4*>(cb + d * kp + kbase + g * (KC / NG));
            cv[4 * g + 0] = v.x;
            cv[4 * g + 1] = v.y;
            cv[4 * g + 2] = v.z;
            cv[4 * g + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4 * NG; ++j) acc[i][j] = fmaf(rr[i], cv[j], acc[i][j]);
        }
        // Codes in increasing k: group g's four, then group g + 1's.
#pragma unroll
        for (int j = 0; j < 4 * NG; ++j) {
          const int k = kbase + (j / 4) * (KC / NG) + (j % 4);
          const float ck = c2[k];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // The reference's association: (x2 + c2) - 2 * xc. 2 * xc is
            // exact in fp32, so a contracted FMA rounds identically.
            const float dist = (x2[i] + ck) - 2.0f * acc[i][j];
            if (dist < best[i]) {  // strict: the first index wins a tie
              best[i] = dist;
              best_k[i] = k;
            }
          }
        }
      }

      // Reduce over the 8 lanes that share these rows.
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) {
          const float od = __shfl_xor_sync(0xffffffffu, best[i], o);
          const int ok = __shfl_xor_sync(0xffffffffu, best_k[i], o);
          if (better(od, ok, best[i], best_k[i])) {
            best[i] = od;
            best_k[i] = ok;
          }
        }
      if (cg == 0)
#pragma unroll
        for (int i = 0; i < 4; ++i)  // no finite distance: code 0, as a scan from 0 gives
          id_s[level * ROWS + 4 * rg + i] = best_k[i] == INT_MAX ? 0 : best_k[i];
      __syncwarp();
      if (lane < ROWS && level + 1 < n_levels) {  // r -= c_id, and the next ||r||^2
        const int id = id_s[level * ROWS + lane];
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          const float v = r[d * RP + lane] - cb[d * kp + id];
          r[d * RP + lane] = v;
          s = fmaf(v, v, s);
        }
        x2_s[lane] = s;
      }
      __syncwarp();
      if (!resident) add_codes(tile, level, level);
    }

    if (have) {
      for (int i = lane; i < ROWS * n_levels; i += 32) {
        const int row = i / n_levels, level = i % n_levels;
        const long long g = tile * ROWS + row;
        if (g < n_rows) ids[g * n_levels + level] = id_s[level * ROWS + row];
      }
      if (resident) add_codes(tile, 0, n_levels - 1);
    }
    __syncwarp();  // the warp is done with this buffer before it is refilled
  }
}

// Codes per codebook row in shared memory: K rounded up to whole passes,
// +4 so that a column of codes (one d, many k) spreads over the banks.
template <int D>
int padded_codes(int n_embed) {
  return (n_embed + Cfg<D>::KC - 1) / Cfg<D>::KC * Cfg<D>::KC + 4;
}

// Shared memory of the layout above: `slots` codebook slots with their
// norms, and each of `warps` warps' two row buffers, row norms and ids.
template <int D>
size_t smem_bytes(int slots, int warps, int n_levels, int kp) {
  using C = Cfg<D>;
  return sizeof(float) * ((size_t)slots * (D + 1) * kp +
                          (size_t)warps * (2 * D * C::RP + C::ROWS + n_levels * C::ROWS));
}

// The staging of a launch: all levels resident beside WARPS warps if they
// fit in max_smem bytes, else one streamed slot beside as many warps as
// fit. Returns the bytes it takes (more than max_smem: no staging fits).
template <int D>
size_t plan(int n_levels, int n_embed, int max_smem, bool* resident, int* warps) {
  using C = Cfg<D>;
  const int kp = padded_codes<D>(n_embed);
  *resident = smem_bytes<D>(n_levels, C::WARPS, n_levels, kp) <= (size_t)max_smem;
  *warps = C::WARPS;
  while (!*resident && *warps > 1 &&
         smem_bytes<D>(1, *warps, n_levels, kp) > (size_t)max_smem)
    --*warps;
  return smem_bytes<D>(*resident ? n_levels : 1, *warps, n_levels, kp);
}

cudaError_t max_shared(int* max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

template <int D>
cudaError_t launch(const float* x, const float* codebooks, int32_t* ids, float* qsum,
                   long long n_rows, int n_levels, int n_embed, cudaStream_t stream) {
  using C = Cfg<D>;
  int dev = 0, max_smem = 0, sms = 0, per_sm = 0;
  cudaError_t err = max_shared(&max_smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int kp = padded_codes<D>(n_embed), n_pass = (kp - 4) / C::KC;
  bool resident = false;
  int warps = 0;
  const size_t smem = plan<D>(n_levels, n_embed, max_smem, &resident, &warps);
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(rq_assign_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rq_assign_kernel<D>,
                                                        32 * warps, smem);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (n_rows + C::ROWS - 1) / C::ROWS;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long blocks = n_tiles < slots ? n_tiles : slots;
  rq_assign_kernel<D><<<(unsigned int)blocks, 32 * warps, smem, stream>>>(
      x, codebooks, ids, qsum, n_rows, n_levels, n_embed, kp, n_pass, (int)resident);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes: device pointers of contiguous fp32 / int32
// tensors, checked by ops/rq_assign.py. Returns the launch's cudaError_t;
// an uninstantiated width or an oversized codebook: cudaErrorInvalidValue.
extern "C" int rq_assign_launch(const void* x, const void* codebooks, void* ids, void* qsum,
                                long long n_rows, int dim, int n_levels, int n_embed,
                                void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(codebooks);
  int32_t* id = static_cast<int32_t*>(ids);
  float* qs = static_cast<float*>(qsum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 16: return (int)launch<16>(xf, cf, id, qs, n_rows, n_levels, n_embed, s);
    case 32: return (int)launch<32>(xf, cf, id, qs, n_rows, n_levels, n_embed, s);
    case 64: return (int)launch<64>(xf, cf, id, qs, n_rows, n_levels, n_embed, s);
    case 128: return (int)launch<128>(xf, cf, id, qs, n_rows, n_levels, n_embed, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Bytes of shared memory a launch at this width would take with one level
// resident and one warp (the least it needs), for the wrapper's check; 0
// for a width without an instantiation.
extern "C" long long rq_assign_min_smem(int dim, int n_levels, int n_embed) {
  switch (dim) {
    case 16: return (long long)smem_bytes<16>(1, 1, n_levels, padded_codes<16>(n_embed));
    case 32: return (long long)smem_bytes<32>(1, 1, n_levels, padded_codes<32>(n_embed));
    case 64: return (long long)smem_bytes<64>(1, 1, n_levels, padded_codes<64>(n_embed));
    case 128: return (long long)smem_bytes<128>(1, 1, n_levels, padded_codes<128>(n_embed));
    default: return 0;
  }
}

// A launch's staging on this device: *slots (n_levels resident, 1
// streamed), *warps a block, *smem bytes. Returns the query's cudaError_t
// (cudaErrorInvalidValue for an uninstantiated width).
extern "C" int rq_assign_plan(int dim, int n_levels, int n_embed, int* slots, int* warps,
                              long long* smem) {
  int max_smem = 0;
  cudaError_t err = max_shared(&max_smem);
  if (err != cudaSuccess) return (int)err;
  bool resident = false;
  size_t bytes = 0;
  switch (dim) {
    case 16: bytes = plan<16>(n_levels, n_embed, max_smem, &resident, warps); break;
    case 32: bytes = plan<32>(n_levels, n_embed, max_smem, &resident, warps); break;
    case 64: bytes = plan<64>(n_levels, n_embed, max_smem, &resident, warps); break;
    case 128: bytes = plan<128>(n_levels, n_embed, max_smem, &resident, warps); break;
    default: return (int)cudaErrorInvalidValue;
  }
  *slots = resident ? n_levels : 1;
  *smem = (long long)bytes;
  return 0;
}
