// Warp-level tensor-core building blocks for the port's redesigned kernels
// (conv_bn_tc.cuh, the bf16 forward of flash_attention_fwd.cu, the bf16
// dK/dV kernels of flash_attention_bwd.cu):
// asynchronous 16-byte copies into shared memory with zero fill, ldmatrix
// loads of 8x8 bf16 tiles (plain and transposed), and the bf16 x bf16 -> f32
// mma.sync.m16n8k16.
//
// Why mma.sync and not wgmma.  wgmma needs its shared-memory operands in
// one of the swizzled layouts that a matrix descriptor names, and its
// register fragments in another order; every operand of these kernels is
// gathered with a mask (a shifted image row that may fall in the halo, a
// ragged key or query block), which cp.async writes row by row.  mma.sync
// takes the same tiles through ldmatrix from a padded row-major layout, so
// a right kernel comes first on the simpler instruction; its rate is in
// PERF.md.  Moving the products to wgmma with TMA is later work.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16, row major: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                       a3 (g+8, 2t+8..)
//   B 16x8, col major:  b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C 16x8 (f32):       c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; with inside == false nothing is
// read and the 16 bytes are zeros (the source size 0 of cp.async)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool inside) {
  const int bytes = inside ? 16 : 0;  // outside reads zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 tiles; lane l gives the address of row l % 8 of tile l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b, bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to nearest bf16, lo in the low half: the
// reference's cast of an f32 value to a bf16 operand
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a bf16 pair as the 32 bits of an A or B fragment register
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace tc
