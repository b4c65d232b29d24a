// bf16 tensor-core products and fragment loads for the amp kernels
// (flash_attn_bf16.cu, lm_head_lse_bf16.cu), sm_90a.
//
// mma.sync.m16n8k16 with bf16 operands and f32 accumulators: the
// products of two bf16 values are exact in f32, and the sums stay f32,
// which is the reference kernels' preferred_element_type=f32. Fragments
// (PTX ISA; g = lane / 4, t = lane % 4; each register holds two bf16,
// the lower index in the low half):
//   A 16 x 16, row-major: a0 (g, 2t..2t+1)      a1 (g + 8, 2t..2t+1)
//                         a2 (g, 2t+8..2t+9)    a3 (g + 8, 2t+8..2t+9)
//   B 16 x 8 (k x n):     b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C 16 x 8, f32:        c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)
//                         c3 (g + 8, 2t + 1)
// So the C fragments of two adjacent n-tiles, packed to bf16, are the A
// fragment of the next product whose reduction runs over those 16
// columns (P.V, dS.K): (c0 c1 | c2 c3) of n-tile 2j and of 2j + 1 are
// a0, a1, a2, a3 — no shuffle, no shared memory.
//
// An operand stored with the reduction index along its rows ([k][n],
// like V in P.V) is read with ldmatrix.trans, which delivers the
// transposed 8 x 8 blocks straight into B fragments; one stored with
// the reduction index along its columns ([n][k], like K in Q.K^T) is
// read with plain ldmatrix. Either way no transposed copy is made.
//
// Shared-memory tiles have a row stride of D + 8 bf16 (an odd multiple
// of 16 bytes): ldmatrix's eight row addresses of one 8 x 8 block then
// fall in eight different 16-byte bank groups, conflict-free.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats -> one register of two bf16 (round to nearest even), lo in
// the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a.b, bf16 x bf16 -> f32
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 8 bf16 blocks; lane l gives the row address of block l / 8,
// row l % 8, and receives in r[i] its two elements of block i
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// the same four blocks, each transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// A fragment (16 rows x 16 k) of a row-major [row][k] tile with row
// stride S elements, rows r0.., columns k0..
__device__ __forceinline__ void load_a(uint32_t a[4],
                                       const __nv_bfloat16* tile, int S,
                                       int r0, int k0, int lane) {
  // blocks: (rows 0-7, k 0-7) (rows 8-15, k 0-7) (rows 0-7, k 8-15)
  // (rows 8-15, k 8-15) = a0 a1 a2 a3
  const int blk = lane >> 3, rr = lane & 7;
  ldsm_x4(a, tile + (r0 + rr + 8 * (blk & 1)) * S + k0 + 8 * (blk >> 1));
}

// B fragments of two adjacent n-tiles (n0.., n0 + 8..) x 16 k from a
// tile stored [n][k] (reduction index along the row): b[0..1] for n0,
// b[2..3] for n0 + 8
__device__ __forceinline__ void load_b_nk(uint32_t b[4],
                                          const __nv_bfloat16* tile, int S,
                                          int n0, int k0, int lane) {
  // blocks: (n 0-7, k 0-7) (n 0-7, k 8-15) (n 8-15, k 0-7) (n 8-15, k 8-15)
  const int blk = lane >> 3, rr = lane & 7;
  ldsm_x4(b, tile + (n0 + rr + 8 * (blk >> 1)) * S + k0 + 8 * (blk & 1));
}

// B fragments of two adjacent n-tiles x 16 k from a tile stored [k][n]
// (reduction index down the rows), transposed by ldmatrix
__device__ __forceinline__ void load_b_kn(uint32_t b[4],
                                          const __nv_bfloat16* tile, int S,
                                          int k0, int n0, int lane) {
  // blocks: (k 0-7, n 0-7) (k 8-15, n 0-7) (k 0-7, n 8-15) (k 8-15, n 8-15)
  const int blk = lane >> 3, rr = lane & 7;
  ldsm_x4_t(b, tile + (k0 + rr + 8 * (blk & 1)) * S + n0 + 8 * (blk >> 1));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (src
// is then not read, but must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (row statistics, whose rows are not 16-byte
// aligned); zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

}  // namespace bf
