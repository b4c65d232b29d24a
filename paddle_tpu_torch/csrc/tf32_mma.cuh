// f32-accurate tensor-core products and asynchronous tile copies for the
// flash-attention kernels (flash_attn_fwd.cu, flash_attn_bwd.cu), sm_90a.
//
// 3xTF32. A TF32 operand keeps 10 of f32's 23 mantissa bits, so one TF32
// product is good to about 1e-3. Each f32 operand x is split into
// hi = tf32(x) and lo = tf32(x - hi) (both rounded to nearest, ties away),
// and a product a.b is taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi on the
// tensor cores, small terms first, accumulating in f32. The dropped
// a_lo.b_lo is below 2^-20 of |a.b|, so the result is at the level of an
// f32 FMA loop (about 1e-6 here), at three TF32 products per product:
// 495 / 3 = 165 TFLOP/s on an H100 SXM against 67 TFLOP/s of f32 FMA.
// The tensor core's own accumulation rounds less carefully than an FMA,
// and the error grows with the number of mma steps chained on one
// accumulator. So a reduction longer than one 64-wide tile is summed a
// tile at a time into a fresh fragment, and the tiles' sums are added in
// f32 by the SIMT cores.
//
// mma.sync.m16n8k8 fragments (PTX ISA; g = lane / 4, t = lane % 4):
//   A 16 x 8, row-major:  a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)
//                         a3 (g + 8, t + 4)
//   B 8 x 8 (k x n):      b0 (t, g)   b1 (t + 4, g)
//   C 16 x 8:             c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)
//                         c3 (g + 8, 2t + 1)
// The reduction index k inside one k-step may be relabelled, as long as A
// and B use the same labels. Two labellings are used:
//   plain     k = t and t + 4 are columns t and t + 4 of the 8-wide step;
//   paired    k = t and t + 4 are columns 2t and 2t + 1.
// Under the paired labelling a C fragment (c0, c2, c1, c3) is the A
// fragment of the next product (P.V, dS.K) without leaving registers.
//
// Shared-memory tiles are 64 rows padded to a row stride of D + 4 floats
// (68 for D = 64, 36 for D = 32: 4 mod 32). With it a warp's fragment
// loads hit 32 distinct banks both along a row (plain labelling, bank
// 4g + t) and down the rows (paired labelling, bank 8t + g), so one tile
// serves as a product's row-major and its transposed operand.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// round to TF32, nearest with ties away from zero: cvt.rna.tf32.f32 for
// every finite x, done as two integer instructions (add half of the
// dropped last place to the magnitude bits, clear the 13 dropped bits).
// A type conversion issues at a quarter of the integer rate (16 against
// 64 results a clock an SM); with cvt, K1 and K2 took 18-32 % longer on
// an H100.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 2^-22 of |x| (x - hi is exact)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// the same with lo left unrounded: the tensor core reads the top 19 bits
// of a tf32 operand, so lo is truncated there. x - hi is exact and at
// most 2^-11 |x|, so x = hi + lo to about 2^-21 of |x|, in three
// instructions a value instead of five, two of them on the half-rate
// integer pipe instead of four (CUTLASS's fast-f32 split also truncates
// its small part)
__device__ __forceinline__ void split_rz(float x, uint32_t& hi,
                                         uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b in 3xTF32: the two cross terms first, hi.hi last
__device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4],
                                     const uint32_t al[4],
                                     const uint32_t bh[2],
                                     const uint32_t bl[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

template <bool kRoundLo>
__device__ __forceinline__ void split_as(float x, uint32_t& hi,
                                         uint32_t& lo) {
  if (kRoundLo)
    split(x, hi, lo);
  else
    split_rz(x, hi, lo);
}

// A fragment split from four f32 values in fragment order a0..a3 (by
// split, or by split_rz when kRoundLo is false)
template <bool kRoundLo = true>
__device__ __forceinline__ void split_a(float a0, float a1, float a2,
                                        float a3, uint32_t hi[4],
                                        uint32_t lo[4]) {
  split_as<kRoundLo>(a0, hi[0], lo[0]);
  split_as<kRoundLo>(a1, hi[1], lo[1]);
  split_as<kRoundLo>(a2, hi[2], lo[2]);
  split_as<kRoundLo>(a3, hi[3], lo[3]);
}

template <bool kRoundLo = true>
__device__ __forceinline__ void split_b(float b0, float b1, uint32_t hi[2],
                                        uint32_t lo[2]) {
  split_as<kRoundLo>(b0, hi[0], lo[0]);
  split_as<kRoundLo>(b1, hi[1], lo[1]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

}  // namespace tc
