// Building blocks of the two attention kernels (attention_fwd.cu,
// attention_bwd.cu) on top of mma_tf32.cuh, which holds the warp-level
// tensor-core product and the high/low split that makes it fp32-grade (the
// fused MLP shares them): the fragment loaders over fp32 tiles, the tile
// loader and the launch bookkeeping.  The streaming kernels' own pieces are
// in attention_stream.cuh.
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
// Why not `wgmma` and TMA in the tensor-core kernels: the products there are
// 149 x 149 x 32 per head.  `wgmma`'s 64-row tiles pad 149 -> 192 and 89 ->
// 128 rows (22-30% wasted against 7% with 16-row tiles), its B operand has to
// sit swizzled in shared memory, and its accumulators cannot feed the next
// product's A operand without a detour, which is what keeps p and dl out of
// shared memory here.  Why TF32 `mma` also for bf16 inputs there: at these
// sizes the time goes to shared-memory reads and the schedulers, not to the
// tensor cores, and one fragment layout serves both types.
// The streaming kernels (attention_stream.cuh) are another matter: at 13261
// keys the products are long and the tensor cores' rate counts, so their
// bf16 instances keep bf16 tiles and run `m16n8k16` (the fp32 operand p or dl
// split into two bf16 halves, 16 bits in all); their fp32 instances use the
// TF32 products below.
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

#include "mma_tf32.cuh"

namespace {

constexpr int kPitchPad = 4;      // floats added to a tile row
constexpr int kMaxKeyTiles = 20;  // 8-key tiles a thread keeps: Skv <= 160
constexpr int kGroup = 4;         // tiles whose `mma`s are interleaved; 32 rows
constexpr int kMaxHeadDim = 64;   // head_dim of the largest mma instance

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

}  // namespace
