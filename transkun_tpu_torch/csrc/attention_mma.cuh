// Building blocks of the two attention kernels (attention_fwd.cu,
// attention_bwd.cu): the warp-level tensor-core product, the high/low split
// that makes it fp32-grade, the tile loader and the launch bookkeeping.
//
// The product is `mma.sync.m16n8k8` on TF32 operands with fp32 accumulators
// in registers.  A TF32 value keeps 11 significant bits, so one product is
// three decimal digits; the kernels' contract is fp32.  Every operand that is
// fp32 by contract is therefore split, x = hi + lo with hi = tf32(x) and
// lo = x - hi (of which the tensor core reads 11 bits), and a product a*b
// becomes a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (the lo*lo term, 2^-22 of the
// product, is dropped): about 2^-20 relative, the order of fp32's own
// rounding over these short sums.  A bf16 input has 8 significant bits, is
// exact in TF32 and needs no split, so with bf16 q, k, v, do the two
// products of inputs take one `mma` and the products whose left operand is
// fp32 by contract (p, dl) take two.
//
// Why not `wgmma` and TMA: the products here are 149 x 149 x 32 per head.
// `wgmma`'s 64-row tiles pad 149 -> 192 and 89 -> 128 rows (22-30% wasted
// against 7% with 16-row tiles), its B operand has to sit swizzled in shared
// memory, and its accumulators cannot feed the next product's A operand
// without a detour, which is what keeps p and dl out of shared memory here.
// Why TF32 `mma` also for bf16 inputs, and not `m16n8k16` bf16: the fp32
// operands p and dl would need a bf16 high/low split (16 bits in all, against
// 22 here), the kernels are nowhere near the tensor cores' rate at these
// sizes (the time goes to shared-memory reads and the schedulers), and one
// fragment layout serves both types.
//
// Fragment layouts of m16n8k8 (PTX ISA), g = lane / 4, t = lane % 4:
//   A (16 x 8, row):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8, col):   b0 (k = t, n = g)  b1 (k = t+4, n = g)
//   C (16 x 8):       c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// An accumulator tile is used as the next product's A operand without any
// exchange between lanes: the sum over k may run in any order, so the thread
// declares its columns 2t and 2t+1 to be k-slots t and t+4 (a0 = c0, a1 = c2,
// a2 = c1, a3 = c3) and loads B from rows 2t and 2t+1 instead of t and t+4.
//
// Shared-memory tiles are fp32, rows on a pitch of (padded head_dim + 4)
// floats.  The pitch is 4 mod 8 words, so the 8 rows x 4 columns of a B
// fragment read along the head dimension, and the 4 row pairs x 8 columns of
// one read across it, each fall into 32 different banks.

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

constexpr int kPitchPad = 4;      // floats added to a tile row
constexpr int kMaxKeyTiles = 20;  // 8-key tiles a thread keeps: Skv <= 160
constexpr int kGroup = 4;         // tiles whose `mma`s are interleaved; 32 rows
constexpr int kMaxHeadDim = 64;   // head_dim of the largest mma instance
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

// Rows g and g+8, columns k0+t and k0+t+4 of the 16-row tile at `tile`.
template <bool kExact>
__device__ __forceinline__ AFrag a_from_tile(const float* tile, int pitch, int k0,
                                             int g, int t) {
  AFrag f;
  set_a<kExact>(f, 0, tile[g * pitch + k0 + t]);
  set_a<kExact>(f, 1, tile[(g + 8) * pitch + k0 + t]);
  set_a<kExact>(f, 2, tile[g * pitch + k0 + t + 4]);
  set_a<kExact>(f, 3, tile[(g + 8) * pitch + k0 + t + 4]);
  return f;
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

// d[i] += a B_i^T for G consecutive 8-row tiles B_i (the first at `rows`)
// whose rows are the product's columns and whose columns k0.. are summed
// over: logits = q k^T, dp = do v^T.
template <bool kAExact, bool kBExact, int G>
__device__ __forceinline__ void mma_rows_as_columns(float (*d)[4], const AFrag& a,
                                                    const float* rows, int pitch,
                                                    int k0, int g, int t) {
  float b0[G], b1[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const float* p = rows + (i * 8 + g) * pitch + k0 + t;
    b0[i] = p[0];
    b1[i] = p[4];
  }
  mma_split<kAExact, kBExact, G>(d, a, b0, b1);
}

// d[i] += a B_i for an A made by a_from_acc and one 8-row tile (at `rows`)
// whose rows are summed over and whose G column tiles of 8, from column 0,
// are the product's: p v, dl k, p^T do, dl^T q.
template <bool kBExact, int G>
__device__ __forceinline__ void mma_rows_summed(float (*d)[4], const AFrag& a,
                                                const float* rows, int pitch, int g,
                                                int t) {
  float b0[G], b1[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const float* p = rows + 2 * t * pitch + i * 8 + g;
    b0[i] = p[0];
    b1[i] = p[pitch];
  }
  mma_split<false, kBExact, G>(d, a, b0, b1);
}

// max and sum over the four lanes that share an accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 16 bytes of T as floats
__device__ __forceinline__ void unpack16(const uint4& raw, float (&out)[4], float) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw, float (&out)[8],
                                         __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its fp32
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One head's rows [rows, dh] of `src` (row stride `ld` elements) into the
// fp32 tile `dst` [rows_pad, pitch], zero in the rows past `rows` and the
// columns dh .. dhp-1.  `vec`: 16-byte loads (the caller has checked that
// dh * sizeof(T) is a multiple of 16 and `src` is 16-byte aligned).
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int rows, int rows_pad, int dh, int dhp,
                                          int pitch, size_t ld, bool vec) {
  constexpr int kPer = 16 / sizeof(T);
  if (vec) {
    const int chunks = dhp / kPer;
    for (int idx = threadIdx.x; idx < rows_pad * chunks; idx += blockDim.x) {
      const int r = idx / chunks, c = (idx - r * chunks) * kPer;
      float vals[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) vals[i] = 0.f;
      if (r < rows && c < dh)
        unpack16(__ldg(reinterpret_cast<const uint4*>(src + (size_t)r * ld + c)),
                 vals, T());
      float4* out = reinterpret_cast<float4*>(dst + r * pitch + c);
#pragma unroll
      for (int i = 0; i < kPer / 4; ++i)
        out[i] = make_float4(vals[4 * i], vals[4 * i + 1], vals[4 * i + 2],
                             vals[4 * i + 3]);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows_pad * dhp; idx += blockDim.x) {
      const int r = idx / dhp, c = idx - r * dhp;
      dst[r * pitch + c] =
          (r < rows && c < dh) ? as_float(src[(size_t)r * ld + c]) : 0.f;
    }
  }
}

// Columns n0+2t and n0+2t+1 of rows g and g+8 of an accumulator tile, times
// `f0` (row g) and `f1` (row g+8), to `dst` (row 0 of the tile, row stride
// `ld`), where the row is below `rows` and the column below `dh`.
template <typename T>
__device__ __forceinline__ void store_acc(T* __restrict__ dst, const float (&c)[4],
                                          float f0, float f1, int row0, int rows,
                                          int n0, int dh, size_t ld, int g, int t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + g + (i >> 1) * 8, col = n0 + 2 * t + (i & 1);
    if (r < rows && col < dh)
      store_float(dst + (size_t)r * ld + col, c[i] * ((i >> 1) ? f1 : f0));
  }
}

// Warps of a block that walks `tiles` 16-row tiles: as few rounds as
// `max_warps` allows, and no warp idle in the last round but one.
inline int warps_for(int tiles, int max_warps) {
  const int rounds = (tiles + max_warps - 1) / max_warps;
  return (tiles + rounds - 1) / rounds;
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
