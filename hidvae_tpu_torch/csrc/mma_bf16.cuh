// Warp-level tensor-core helpers for bf16 kernels on Hopper (sm_90a):
// cp.async copies, swizzled shared-memory tiles, ldmatrix and
// mma.sync m16n8k16 with fp32 accumulators. Inline PTX only, no library.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// for lane = 4 * g + t (g = lane / 4 in 0..7, t = lane % 4):
//   A (16 x 16, row-major), 4 registers of two bf16:
//     a0 = A[g][2t, 2t+1]   a1 = A[g+8][2t, 2t+1]
//     a2 = A[g][2t+8, +9]   a3 = A[g+8][2t+8, +9]
//   B (16 x 8, k x n), 2 registers:  b0 = B[2t, 2t+1][g]   b1 = B[2t+8, +9][g]
//   C (16 x 8, fp32), 4 floats:      c0, c1 = C[g][2t, 2t+1]   c2, c3 = C[g+8][2t, 2t+1]
// So the C fragments of two neighbouring 8-column blocks, rounded to bf16
// and paired, are exactly the A fragment of the next product over those 16
// columns: an attention kernel's P never needs shared memory.
//
// Tiles of bf16 rows live in shared memory as 16-byte chunks, chunk c of
// row r stored at chunk (c ^ (r & 7)): the eight row addresses that one
// ldmatrix phase reads (eight rows, one logical chunk) then fall in eight
// distinct bank groups, so ldmatrix is free of bank conflicts for rows of
// 64 or 128 bf16.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of chunk `c` (16 bytes) of row `r` in a swizzled tile whose
// rows hold `row_chunks` chunks.
__device__ __forceinline__ uint32_t swizzle(int r, int c, int row_chunks) {
  return static_cast<uint32_t>((r * row_chunks + (c ^ (r & 7))) * 16);
}

// 16 bytes global -> shared, asynchronously; `valid` false writes zeros and
// reads nothing (the src-size 0 form), for ragged tails.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously, zeros when not `valid`.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `N` committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [0, n_valid) of a [rows, D] bf16 matrix (row stride D) into a
// swizzled tile; rows past n_valid become zeros. All threads of the block
// take part; `nthreads` is the block size.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile_async(uint32_t tile, const __nv_bfloat16* src,
                                                int n_valid, int tid, int nthreads) {
  constexpr int CHUNKS = D / 8;
  for (int i = tid; i < ROWS * CHUNKS; i += nthreads) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool valid = r < n_valid;
    const __nv_bfloat16* p = src + (size_t)(valid ? r : 0) * D + c * 8;
    cp_async_16(tile + swizzle(r, c, CHUNKS), p, valid);
  }
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of each lane holds its two elements of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed on the way to the registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a * b on one 16 x 8 x 16 tile, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (one MUFU op; -inf gives 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 (round to nearest even) in one register, `lo`
// in the low half: the element with the lower column index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 rows x 16 columns, at row0 and column chunk 2 * kk) of a
// swizzled row-major tile: row (lane & 15), chunk 2 * kk + (lane >> 4).
__device__ __forceinline__ void load_a(uint32_t a[4], uint32_t tile, int row0, int kk,
                                       int row_chunks, int lane) {
  ldmatrix_x4(a, tile + swizzle(row0 + (lane & 15), 2 * kk + (lane >> 4), row_chunks));
}

// B fragments of two 8-column blocks for the product X * T^T, where the
// tile T holds the 16 rows n0..n0+15 as rows (the product's columns) and the
// reduction runs along its row: b[0], b[1] for rows n0..n0+7, b[2], b[3] for
// n0+8..n0+15, reduction columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ void load_b_rows(uint32_t b[4], uint32_t tile, int n0, int kk,
                                            int row_chunks, int lane) {
  const int r = n0 + (lane & 7) + ((lane >> 4) << 3);
  const int c = 2 * kk + ((lane >> 3) & 1);
  ldmatrix_x4(b, tile + swizzle(r, c, row_chunks));
}

// B fragments of two 8-column blocks for the product X * T, where the tile
// T holds the reduction along its rows k0..k0+15 and the product's columns
// along its row: b[0], b[1] for columns 16 db .. 16 db + 7, b[2], b[3] for
// the next 8.
__device__ __forceinline__ void load_b_cols(uint32_t b[4], uint32_t tile, int k0, int db,
                                            int row_chunks, int lane) {
  ldmatrix_x4_trans(b, tile + swizzle(k0 + (lane & 15), 2 * db + (lane >> 4), row_chunks));
}

}  // namespace mma_bf16
