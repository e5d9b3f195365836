// Building blocks of the streaming attention kernels (attention_fwd.cu's
// attention_fwd_stream, attention_bwd.cu's attention_bwd_stream_rows and
// _keys): the tile geometry, the ring of tiles that `cp.async` fills, and
// the two products every pass is made of, for each input type.
//
// A warp owns 16 rows of its side (query rows; keys in the backward's pass
// B) as A fragments in registers, and the other side streams through shared
// memory in tiles of 64 rows, kStages of them in flight: tile j+1 (and j+2
// at bf16) is copied while tile j is multiplied.  The two products:
//   rows_product:   d_j += A R_j^T for 8-row tiles R_j of a streamed tile
//                   (logits q k^T, dp = do v^T; k q^T, v do^T in pass B);
//   summed_product: d_n += P R for an fp32 accumulator tile P whose columns
//                   are the streamed tile's rows (p v, dl k; p^T do, dl^T q).
//
// bf16 (the shared-memory tiles in bf16, as the inputs come):
//   * `mma.sync.m16n8k16` with fp32 accumulators.  A product of two bf16
//     inputs is exact in fp32, so rows_product is one `mma` a 16 x 8 x 16
//     step.  P is fp32 by contract: it is split into a bf16 high part and a
//     bf16 low part (split_bf16, 16 significant bits) and summed_product is
//     two `mma` a step, the low part first.
//   * Fragments come by `ldmatrix`: A and the rows_product B as they lie,
//     the summed_product B transposed (`.trans`), four 8 x 8 tiles a load.
//     Rows are (head_dim + 8) elements apart: 4 mod 32 words at head_dim 64
//     and 12 or 20 words at 16 and 32, so the 8 rows an `ldmatrix` phase
//     reads fall into 8 different 16-byte bank groups.
// fp32 (the tiles in fp32): the TF32 `m16n8k8` products of attention_mma.cuh
// with the high/low split of every operand, three `mma` a product, fragments
// by scalar loads on a pitch of head_dim + 4 floats; the same ring.

#pragma once

#include "attention_mma.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kStreamKeys = 64;     // rows of a streamed tile
constexpr int kStreamMaxWarps = 6;  // 16-row warps a block owns: forward and pass A
constexpr int kKeyWarps = kStreamKeys / 16;  // pass B: a block owns one tile of keys
constexpr float kLog2e = 1.4426950408889634f;

// The block size that the forward's and pass A's registers are planned for
// (__launch_bounds__ with 2 blocks an SM): 128 registers a thread at bf16,
// so 4 blocks of 4 warps fit an SM; 170 at fp32, whose split operands take
// more, so 3 blocks of 4 warps or 2 of 6.
template <typename T>
constexpr int kStreamThreads = sizeof(T) == 2 ? 256 : kStreamMaxWarps * 32;

__host__ __device__ constexpr bool stream_takes(int dh) { return dh >= 1 && dh <= kMaxHeadDim; }

template <typename T, int KD>
struct StreamTile {
  static constexpr int kDhp = 8 * KD;  // head_dim padded to 16, 32 or 64
  static constexpr int kPitch = kDhp + (sizeof(T) == 4 ? kPitchPad : 8);  // elements a row
  static constexpr int kStages = sizeof(T) == 4 ? 2 : 3;                  // tiles in the ring
  static constexpr int kTile = kStreamKeys * kPitch;                      // elements of a tile
  static constexpr size_t kTileBytes = (size_t)kTile * sizeof(T);
};

// Shared memory of each kernel, in bytes (ops/attention.py::stream_plan
// computes the same): the block's own rows, then the ring.
template <typename T, int KD>
__host__ __device__ constexpr size_t fwd_stream_smem(int warps) {
  using G = StreamTile<T, KD>;
  return (size_t)warps * 16 * G::kPitch * sizeof(T) + G::kStages * 2 * G::kTileBytes;
}
template <typename T, int KD>
__host__ __device__ constexpr size_t rows_stream_smem(int warps) {
  using G = StreamTile<T, KD>;
  return (size_t)2 * warps * 16 * G::kPitch * sizeof(T) + G::kStages * 2 * G::kTileBytes;
}
template <typename T, int KD>
__host__ __device__ constexpr size_t keys_stream_smem() {
  using G = StreamTile<T, KD>;
  return 2 * G::kTileBytes + G::kStages * (2 * G::kTileBytes + 3 * kStreamKeys * sizeof(float));
}

// Rows [0, rows) of one head (row stride `ld` elements) into the tile `dst`
// of `tile_rows` rows on the pitch of StreamTile, zeros in the rows past
// `rows` and the columns past dh.  `vec` (dh * sizeof(T) a multiple of 16,
// the tensors 16-byte aligned): 16-byte `cp.async` copies, which the caller
// commits and waits for; else plain loads and stores, done when they return.
template <typename T, int KD>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, int rows,
                                          int tile_rows, size_t ld, int dh, bool vec) {
  using G = StreamTile<T, KD>;
  if (vec) {
    constexpr int kPer = 16 / sizeof(T), kChunks = G::kDhp / kPer;
    for (int idx = threadIdx.x; idx < tile_rows * kChunks; idx += blockDim.x) {
      const int r = idx / kChunks, c = (idx - r * kChunks) * kPer;
      const bool real = r < rows && c < dh;
      copy16_async(dst + r * G::kPitch + c, real ? src + (size_t)r * ld + c : src, real ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < tile_rows * G::kDhp; idx += blockDim.x) {
      const int r = idx / G::kDhp, c = idx - r * G::kDhp;
      if (r < rows && c < dh)
        dst[r * G::kPitch + c] = src[(size_t)r * ld + c];
      else
        store_float(dst + r * G::kPitch + c, 0.f);
    }
  }
}

// `rows` fp32 values into `dst` by 4-byte `cp.async`, zeros up to kStreamKeys.
__device__ __forceinline__ void load_row_values(float* dst, const float* __restrict__ src,
                                                int rows) {
  for (int r = threadIdx.x; r < kStreamKeys; r += blockDim.x)
    copy4_async(dst + r, r < rows ? src + r : src, r < rows ? 4 : 0);
}

template <typename T, int KD>
struct StreamMath;

// fp32: TF32 m16n8k8 with every operand split (attention_mma.cuh), three
// `mma` a product.
template <int KD>
struct StreamMath<float, KD> {
  static constexpr int kPitch = StreamTile<float, KD>::kPitch;
  using Frags = AFrag[KD];  // k-steps of 8 along head_dim

  // The warp's 16 rows (row 0 at `rows`) as A fragments.
  static __device__ __forceinline__ void a_frags(Frags& a, const float* rows, int lane) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) a[kk] = a_from_tile<false>(rows, kPitch, kk * 8, lane >> 2, lane & 3);
  }
  // d[i] += A R_i^T for the four 8-row tiles R_i from `tile`.
  static __device__ __forceinline__ void rows_product(float (*d)[4], const Frags& a,
                                                      const float* tile, int lane) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      mma_rows_as_columns<false, false, kGroup>(d, a[kk], tile, kPitch, kk * 8, lane >> 2, lane & 3);
  }
  // d[n] += P R for the 32 rows of R from `tile`, P the four accumulator
  // tiles p[0..3] (columns 8i.. of P are rows 8i.. of R).
  static __device__ __forceinline__ void summed_product(float (*d)[4], const float (*p)[4],
                                                        const float* tile, int lane) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      mma_rows_summed<false, KD>(d, a_from_acc(p[i]), tile + i * 8 * kPitch, kPitch, lane >> 2,
                                 lane & 3);
  }
};

// bf16: m16n8k16 from `ldmatrix` fragments; P split high/low.
template <int KD>
struct StreamMath<__nv_bfloat16, KD> {
  static_assert(KD % 2 == 0, "head_dim in steps of 16");
  static constexpr int kPitch = StreamTile<__nv_bfloat16, KD>::kPitch;
  using Frags = uint32_t[KD / 2][4];  // k-steps of 16 along head_dim

  // A tiles (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
  // (rows 8-15, k 8-15) are a0..a3.
  static __device__ __forceinline__ void a_frags(Frags& a, const __nv_bfloat16* rows, int lane) {
    const int r = lane & 7, tile = lane >> 3;
    const __nv_bfloat16* p = rows + (r + 8 * (tile & 1)) * kPitch + 8 * (tile >> 1);
#pragma unroll
    for (int ks = 0; ks < KD / 2; ++ks) load_tiles(a[ks], p + ks * 16);
  }
  // B of R_i^T: R's rows are the product's columns and run along n, its
  // columns along k; of two neighbouring row tiles, (k 0-7) and (k 8-15) of
  // each are b0, b1.
  static __device__ __forceinline__ void rows_product(float (*d)[4], const Frags& a,
                                                      const __nv_bfloat16* tile, int lane) {
    const int r = lane & 7, q = lane >> 3;
    const __nv_bfloat16* p = tile + (r + 8 * (q >> 1)) * kPitch + 8 * (q & 1);
#pragma unroll
    for (int ks = 0; ks < KD / 2; ++ks)
#pragma unroll
      for (int i = 0; i < kGroup; i += 2) {
        uint32_t b[4];
        load_tiles(b, p + i * 8 * kPitch + ks * 16);
        mma_bf16(d[i], a[ks], b[0], b[1]);
        mma_bf16(d[i + 1], a[ks], b[2], b[3]);
      }
  }
  // B of R: R's rows run along k, its columns along n, so the tiles are
  // read transposed: (rows 0-7, columns 8n..), (rows 8-15, 8n..), then the
  // same at 8n+8 are b0, b1 of column tile n and of n+1.
  static __device__ __forceinline__ void summed_product(float (*d)[4], const float (*p)[4],
                                                        const __nv_bfloat16* tile, int lane) {
    const int r = lane & 7, q = lane >> 3;
    const __nv_bfloat16* base = tile + (r + 8 * (q & 1)) * kPitch + 8 * (q >> 1);
#pragma unroll
    for (int ks = 0; ks < kGroup / 2; ++ks) {  // rows 16ks .. 16ks+15 of R
      uint32_t hi[4], lo[4];
      split_bf16(p[2 * ks][0], p[2 * ks][1], hi[0], lo[0]);
      split_bf16(p[2 * ks][2], p[2 * ks][3], hi[1], lo[1]);
      split_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1], hi[2], lo[2]);
      split_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int n = 0; n < KD; n += 2) {
        uint32_t b[4];
        load_tiles_t(b, base + ks * 16 * kPitch + n * 8);
        mma_bf16(d[n], lo, b[0], b[1]);
        mma_bf16(d[n + 1], lo, b[2], b[3]);
        mma_bf16(d[n], hi, b[0], b[1]);
        mma_bf16(d[n + 1], hi, b[2], b[3]);
      }
    }
  }
};

// 2^x by the SFU's `ex2.approx.ftz` alone, x <= 0 here (a logit less the
// row max, in log2 units).  exp2f without --use_fast_math adds a range test
// and two predicated multiplies to return the results below 2^-126 as
// subnormals; flushed to zero, such a p is below 2^-126 of the row's
// largest, which every fp32 sum it enters drops anyway.  Relative error
// 2^-22, as exp2f's.
__device__ __forceinline__ float exp2_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The key tiles [first, end) of split `split` of `key_tiles`, `per` a split.
struct SplitRange {
  int first, end;
};
__device__ __forceinline__ SplitRange split_range(int split, int per, int key_tiles) {
  const int first = split * per;
  return {first, min(first + per, key_tiles)};
}

// The plan's numbers as the launch checks them: 1-8 warps, every key tile in
// one split, no split empty.
inline bool plan_takes(int warps, int splits, int per, int key_tiles) {
  return warps >= 1 && warps <= kStreamMaxWarps && splits >= 1 && per >= 1 &&
         (splits - 1) * per < key_tiles && key_tiles <= splits * per;
}

}  // namespace
