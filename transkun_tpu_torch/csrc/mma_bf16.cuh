// The bf16 tensor-core pieces that the fused MLP and the streaming attention
// kernels share: `cp.async` copies into shared memory, `ldmatrix` fragment
// loads, `mma.sync.m16n8k16` on bf16 operands with fp32 accumulators, and
// the packing of fp32 accumulator tiles into bf16 A operands (rounded once,
// or split high/low).
//
// Fragment layouts of m16n8k16 (PTX ISA), g = lane / 4, t = lane % 4, two
// 16-bit values a register, the lower k in the low half:
//   A (16 x 16, row): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16 x 8, col):  b0 (k = 2t..2t+1, n = g)  b1 (k = 2t+8..2t+9, n = g)
//   C (16 x 8):       c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// So two neighbouring accumulator tiles (columns 0-7 and 8-15 of a 16-wide
// step) are the four A registers of the next product as they stand, packed
// in pairs: {c0,c1} and {c2,c3} of the first, then of the second.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory without passing through registers;
// `bytes` of them are read (0 or 16), the rest is written as zeros.
__device__ __forceinline__ void copy16_async(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_address(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
// The same for 4 bytes (0 or 4 read).
__device__ __forceinline__ void copy4_async(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_address(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most N of this thread's committed groups are still in flight.
template <int N = 0>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 tiles of 16-bit values from shared memory: lane 8i + r gives the
// address of row r (16 bytes) of tile i, and gets of every tile the values
// 2t, 2t+1 of row g: a tile whose rows run along k is an `mma` fragment
// register as it comes.
__device__ __forceinline__ void load_tiles(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_address(row)));
}
// The same, transposed: of every tile the lane gets rows 2t, 2t+1 of column
// g, so a tile whose rows run along k is a B fragment register.
__device__ __forceinline__ void load_tiles_t(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_address(row)));
}

// two floats rounded to bf16 (nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats split x = hi + lo into bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
// (x - hi is exact in fp32).  hi + lo keeps 16 significant bits: a product
// with a bf16 operand taken as lo*b + hi*b is off by at most 2^-18 of |x b|.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 back = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - back.x, b - back.y);
}

}  // namespace
