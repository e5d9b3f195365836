// The warp-level tensor-core product that the attention kernels and the
// fused MLP share: `mma.sync.m16n8k8` on TF32 operands with fp32 accumulators,
// the high/low operand split that makes it fp32-grade, an accumulator tile
// reused as the next product's A operand, and the shared-memory opt-in.
//
// A TF32 value keeps 11 significant bits, so one product is three decimal
// digits; the kernels' contract is fp32.  Every operand that is fp32 by
// contract is therefore split, x = hi + lo with hi = tf32(x) and lo = x - hi
// (of which the tensor core reads 11 bits), and a product a*b becomes
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (the lo*lo term, 2^-22 of the product, is
// dropped): about 2^-20 relative, the order of fp32's own rounding over short
// sums.  A bf16 value has 8 significant bits, is exact in TF32 and needs no
// split.
//
// Fragment layouts of m16n8k8 (PTX ISA), g = lane / 4, t = lane % 4:
//   A (16 x 8, row):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8, col):   b0 (k = t, n = g)  b1 (k = t+4, n = g)
//   C (16 x 8):       c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// The sum over k may run in any order, so a thread may declare any two of
// its values to be k-slots t and t+4 as long as A and B agree: an
// accumulator tile becomes an A operand without any exchange between lanes
// (columns 2t and 2t+1 are slots t and t+4, B is read from rows 2t and 2t+1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>
#include <set>
#include <utility>

#include "as_float.cuh"

namespace {

constexpr size_t kSmemLimit = 232448;  // bytes a Hopper block may use

template <typename T>
constexpr bool kExactInTf32 = sizeof(T) == 2;  // bf16: 8 significant bits

__host__ __device__ constexpr int ceil_to(int x, int m) { return (x + m - 1) / m * m; }

// x rounded to TF32's 11 significant bits, ties away from zero, as
// `cvt.rna.tf32.f32` rounds; that conversion is emulated with a test for
// infinity and a select (four operations), this is two.  The inputs are
// finite (an infinite one would give NaN here, as its logits do anyway).
__device__ __forceinline__ uint32_t tf32_of(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x - hi, the low part of the split.  It goes to the `mma` as it is: the
// tensor core reads the upper 19 bits of an operand, so the low part is cut
// to 11 bits, 2^-21 of x, where rounding it would leave 2^-22.
__device__ __forceinline__ uint32_t low_part(float x, uint32_t hi) {
  return __float_as_uint(x - __uint_as_float(hi));
}

// d += a b: a 16 x 8 (row), b 8 x 8 (col), TF32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment, split; `lo` is unused (and compiled away) where the values
// are exact in TF32.
struct AFrag {
  uint32_t hi[4], lo[4];
};

template <bool kExact>
__device__ __forceinline__ void set_a(AFrag& f, int i, float x) {
  if (kExact) {
    f.hi[i] = __float_as_uint(x);
  } else {
    f.hi[i] = tf32_of(x);
    f.lo[i] = low_part(x, f.hi[i]);
  }
}

// An accumulator tile as an A operand whose k-slots t and t+4 are the
// tile's columns 2t and 2t+1; fp32 by contract, so always split.
__device__ __forceinline__ AFrag a_from_acc(const float (&c)[4]) {
  AFrag f;
  set_a<false>(f, 0, c[0]);
  set_a<false>(f, 1, c[2]);
  set_a<false>(f, 2, c[1]);
  set_a<false>(f, 3, c[3]);
  return f;
}

// d[i] += a b_i for G accumulator tiles that share the A operand, with the
// operands that are not exact in TF32 split and the small terms added
// first.  The G products are written term by term, so that consecutive
// `mma`s go to different accumulators and none waits for the one before it
// (the compiler's own schedule measured the same).
template <bool kAExact, bool kBExact, int G>
__device__ __forceinline__ void mma_split(float (*d)[4], const AFrag& a,
                                          const float (&b0)[G], const float (&b1)[G]) {
  uint32_t b0h[G], b1h[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    b0h[i] = kBExact ? __float_as_uint(b0[i]) : tf32_of(b0[i]);
    b1h[i] = kBExact ? __float_as_uint(b1[i]) : tf32_of(b1[i]);
  }
  if (!kBExact) {
#pragma unroll
    for (int i = 0; i < G; ++i)
      mma_tf32(d[i], a.hi, low_part(b0[i], b0h[i]), low_part(b1[i], b1h[i]));
  }
  if (!kAExact) {
#pragma unroll
    for (int i = 0; i < G; ++i) mma_tf32(d[i], a.lo, b0h[i], b1h[i]);
  }
#pragma unroll
  for (int i = 0; i < G; ++i) mma_tf32(d[i], a.hi, b0h[i], b1h[i]);
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per kernel and
// device, to the most a block may use, instead of on every launch.
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int device) {
  static std::mutex mutex;
  static std::set<std::pair<const void*, int>> done;
  const std::pair<const void*, int> key(reinterpret_cast<const void*>(kernel), device);
  std::lock_guard<std::mutex> lock(mutex);
  if (done.count(key)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
  if (err == cudaSuccess) done.insert(key);
  return err;
}

}  // namespace
