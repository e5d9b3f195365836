// Fused MLP forward on Hopper (sm_90a): out = gelu(x w1 + b1) w2 + b2 with
// the exact-erf GELU, the hidden activation never leaving the registers.
//
// Replaces the TPU kernel _mlp_kernel in transkun_tpu/ops/mlp_pallas.py
// (called through _mlp_fwd_call / fused_mlp).  x [M, D], w1 [D, hidden],
// b1 [hidden], w2 [hidden, D], b2 [D], all float or all bfloat16.
// h = x w1 with an fp32 sum, + b1 in fp32, GELU in fp32 with erff (the TPU
// kernel's rational erf exists only because its compiler has no erf), g
// rounded to the input type, o = g w2 with an fp32 sum, + b2, rounded once
// to the input type.  At fp32 the roundings are no-ops.
//
// The weights come in either of two layouts, told apart by the caller from
// their strides: [in, out] row-major (the contract of the public signature),
// or the `.t()` view of a row-major [out, in] tensor, which is how
// nn.Linear stores them: the element (k, n) then lies at n * in + k, "k
// contiguous", the layout the `mma` B operand wants.  Shared memory always
// holds the k-contiguous form, so both layouts run the same arithmetic in
// the same order and give the same bits.
//
// What bounds it: operations on the tensor cores.  At the flagship shape
// (M = 13261, D = 256, hidden = 1024) it does 13.9 GFLOP on 29 MB of inputs
// and outputs; the [M, 1024] hidden activation (54 MB written and read back
// by the unfused route) stays on chip.  fp32 takes three TF32 `mma` a
// product (the high/low split of mma_tf32.cuh), 41.7 GFLOP at the TF32 rate;
// bf16 one bf16 `mma`.
//
// Design:
//   * A warp owns 16 rows of x and all D output columns: D/8 accumulator
//     tiles (128 registers a thread at D = 256) live across the whole
//     kernel.  A block is up to 8 such warps (128 rows) around one copy of
//     the streamed weights; 255 registers a thread, one block an SM.
//   * The hidden units are walked in chunks (32 at fp32, 64 at bf16: 128
//     bytes of a w2 row either way).  For a chunk the warp forms its
//     [16, chunk] tile of h from its rows of x (shared memory) and the
//     chunk's rows of w1, adds b1, applies GELU, and uses the accumulator
//     tiles of g directly as the A operand of the second product with the
//     chunk's columns of w2: g never touches shared memory.  fp32: the
//     thread's columns 2t, 2t+1 of a tile are k-slots t, t+4 of an m16n8k8
//     (mma_tf32.cuh).  bf16: two neighbouring tiles, packed in pairs, are
//     the four A registers of an m16n8k16 as they stand.
//   * Weight tiles are double-buffered with cp.async: w1's chunk c in slot
//     0, w2's chunk c in slot 1; while the first product of chunk c runs,
//     w2's chunk c lands; while the second runs, w1's chunk c+1 lands.  One
//     __syncthreads a tile.  The [in, out] layout has no 16-byte runs along
//     k, so it is loaded and transposed with plain loads and does not
//     overlap; the production path (models/layers.py) hands nn.Linear's
//     layout.
//   * Fragment reads.  fp32: the k-slots of a step of 8 are permuted the
//     same way for A and B (slot t is word 2t, slot t+4 word 2t+1), so every
//     fragment is one 8-byte shared-memory load a row; row pitches are 8
//     mod 32 words, which spreads the 16 lanes of a half-warp over all
//     banks.  bf16: `ldmatrix` brings the four registers of an A fragment, or
//     the B fragments of two neighbouring tiles, in one load (a
//     quarter of the loads that 4-byte reads take: 0.091 against 0.101 ms
//     at M = 13261 on an H100 SXM at 700 W); pitches are 4 mod 32 words, so
//     the 8 rows of 16 bytes of a tile fall into different banks.
//   * Rows are dealt evenly: with T tiles of 16 rows and S SMs, the launch
//     takes w = ceil(T / (S * waves)) warps a block (waves = ceil(T / 8S))
//     and ceil(T / w) blocks, so M = 13261 runs as 119 blocks of 7 warps in
//     one wave and M = 53044 as 474 blocks of 7 warps, instead of 64-row
//     blocks whose last wave fills half the card.  Rows past M are loaded as
//     zeros and not stored.
//   * The tensor core truncates when it adds into its accumulator.  Chained
//     over the 384 `mma`s of an fp32 output tile that is a bias of 3e-5, so
//     at fp32 a chain is at most 24 (first product) or 12 (second) long and
//     the partial sums are added with ordinary fp32 adds (6e-6 then, the
//     plain version's own distance from an fp64 reference).  At bf16 the
//     output's rounding is 2^-9 and the chains stay whole.
// No --use_fast_math: erff and the divisions are the accurate ones.

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kMaxWarps = 8;   // 16-row tiles a block holds
constexpr int kWarpRows = 16;
constexpr int kGroup = 4;      // fp32: accumulator tiles whose `mma`s interleave

// Geometry by element type, in 32-bit words of shared memory.
template <typename T>
struct Geometry;
template <>
struct Geometry<float> {
  static constexpr int kChunk = 32;  // hidden units a step
  static constexpr int kPad = 8;     // words added to a tile row: pitch 8 mod 32
};
template <>
struct Geometry<__nv_bfloat16> {
  static constexpr int kChunk = 64;
  static constexpr int kPad = 4;     // pitch 4 mod 32
};

template <typename T, int D>
struct Layout {
  static constexpr int kPerWord = 4 / sizeof(T);
  static constexpr int kChunk = Geometry<T>::kChunk;
  static constexpr int kDWords = D / kPerWord;            // words of a row of x or w1
  static constexpr int kChunkWords = kChunk / kPerWord;   // 32: words of a w2 tile row
  static constexpr int kPitchX = kDWords + Geometry<T>::kPad;       // x and w1 tiles
  static constexpr int kPitch2 = kChunkWords + Geometry<T>::kPad;   // w2 tile
  static constexpr int kXWords = kMaxWarps * kWarpRows * kPitchX;
  static constexpr int kW1Words = kChunk * kPitchX;   // slot 0: [chunk][D]
  static constexpr int kW2Words = D * kPitch2;        // slot 1: [D][chunk]
  static constexpr size_t kSmemBytes = (size_t)(kXWords + kW1Words + kW2Words) * 4;
  static constexpr int kSteps1 = kDWords / 8;      // k-steps of the first product
  static constexpr int kSteps2 = kChunkWords / 8;  // bf16: k-steps of the second, a chunk
  static constexpr int kTiles1 = kChunk / 8;       // accumulator tiles of h
  static constexpr int kTiles2 = D / 8;            // accumulator tiles of out
};

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752440f));
}

// The block's rows of x into the x tile, zeros past row m.
template <typename T, int D>
__device__ __forceinline__ void load_x(uint32_t* xs, const T* __restrict__ x, int row0,
                                       int rows, int m) {
  using L = Layout<T, D>;
  constexpr int kPieces = L::kDWords / 4;  // 16-byte pieces of a row
  for (int idx = threadIdx.x; idx < rows * kPieces; idx += blockDim.x) {
    const int r = idx / kPieces, p = idx - r * kPieces;
    const bool real = row0 + r < m;
    const T* src = x + (size_t)(real ? row0 + r : 0) * D + p * (16 / sizeof(T));
    copy16_async(xs + r * L::kPitchX + p * 4, src, real ? 16 : 0);
  }
}

// Hidden units c0 .. c0+chunk-1 of w1 into slot 0 as [unit][k].
template <typename T, int D>
__device__ __forceinline__ void load_w1(uint32_t* slot, const T* __restrict__ w1, int c0,
                                        int hidden, bool k_contiguous) {
  using L = Layout<T, D>;
  if (k_contiguous) {  // unit n is the row w1 + n * D
    constexpr int kPieces = L::kDWords / 4;
    for (int idx = threadIdx.x; idx < L::kChunk * kPieces; idx += blockDim.x) {
      const int n = idx / kPieces, p = idx - n * kPieces;
      copy16_async(slot + n * L::kPitchX + p * 4,
                   w1 + (size_t)(c0 + n) * D + p * (16 / sizeof(T)), 16);
    }
  } else {  // [D][hidden]: neighbouring lanes on neighbouring units
    T* tile = reinterpret_cast<T*>(slot);
    for (int idx = threadIdx.x; idx < D * L::kChunk; idx += blockDim.x) {
      const int k = idx / L::kChunk, n = idx - k * L::kChunk;
      tile[n * (L::kPitchX * L::kPerWord) + k] = w1[(size_t)k * hidden + c0 + n];
    }
  }
}

// Hidden units c0 .. c0+chunk-1 of w2 into slot 1 as [output column][unit].
template <typename T, int D>
__device__ __forceinline__ void load_w2(uint32_t* slot, const T* __restrict__ w2, int c0,
                                        int hidden, bool k_contiguous) {
  using L = Layout<T, D>;
  if (k_contiguous) {  // output column n is the row w2 + n * hidden
    constexpr int kPieces = L::kChunkWords / 4;
    for (int idx = threadIdx.x; idx < D * kPieces; idx += blockDim.x) {
      const int n = idx / kPieces, p = idx - n * kPieces;
      copy16_async(slot + n * L::kPitch2 + p * 4,
                   w2 + (size_t)n * hidden + c0 + p * (16 / sizeof(T)), 16);
    }
  } else {  // [hidden][D]
    T* tile = reinterpret_cast<T*>(slot);
    for (int idx = threadIdx.x; idx < L::kChunk * D; idx += blockDim.x) {
      const int k = idx / D, n = idx - k * D;
      tile[n * (L::kPitch2 * L::kPerWord) + k] = w2[(size_t)(c0 + k) * D + n];
    }
  }
}

// d[i] += t[i] for G accumulator tiles, in fp32 with round to nearest.
template <int G>
__device__ __forceinline__ void add_tiles(float (*d)[4], const float (&t)[G][4]) {
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) d[i][c] += t[i][c];
}

// h += x_rows w1_chunk for the warp's 16 rows (`xr`: row 0 of them).  The
// tensor core adds into its accumulator with truncation, a bias that grows
// with the number of `mma`s chained on one accumulator (3e-5 over this
// kernel's 384 at hidden = 1024): at fp32 at most kFlush k-steps are chained
// and the partial sums are added here, rounded to nearest.
constexpr int kFlush = 8;

template <int D>
__device__ __forceinline__ void first_product(float (*h)[4], const uint32_t* xr,
                                              const uint32_t* w1s, int g, int t, float) {
  using L = Layout<float, D>;
  static_assert(L::kTiles1 == kGroup, "one group of accumulator tiles a chunk");
  static_assert(L::kSteps1 % kFlush == 0, "whole runs of k-steps");
  for (int k0 = 0; k0 < L::kSteps1; k0 += kFlush) {
    float part[kGroup][4] = {};
#pragma unroll 4
    for (int ks = k0; ks < k0 + kFlush; ++ks) {
      // slot t is word 2t of the step, slot t+4 word 2t+1, for A and B alike
      const uint2 r0 = *reinterpret_cast<const uint2*>(xr + g * L::kPitchX + ks * 8 + 2 * t);
      const uint2 r8 =
          *reinterpret_cast<const uint2*>(xr + (g + 8) * L::kPitchX + ks * 8 + 2 * t);
      AFrag a;
      set_a<false>(a, 0, __uint_as_float(r0.x));
      set_a<false>(a, 1, __uint_as_float(r8.x));
      set_a<false>(a, 2, __uint_as_float(r0.y));
      set_a<false>(a, 3, __uint_as_float(r8.y));
      float b0[kGroup], b1[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const uint2 b = *reinterpret_cast<const uint2*>(w1s + (j * 8 + g) * L::kPitchX +
                                                        ks * 8 + 2 * t);
        b0[j] = __uint_as_float(b.x);
        b1[j] = __uint_as_float(b.y);
      }
      mma_split<false, false, kGroup>(part, a, b0, b1);
    }
    add_tiles<kGroup>(h, part);
  }
}

template <int D>
__device__ __forceinline__ void first_product(float (*h)[4], const uint32_t* xr,
                                              const uint32_t* w1s, int g, int t,
                                              __nv_bfloat16) {
  using L = Layout<__nv_bfloat16, D>;
  // A: tiles (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
  // (rows 8-15, k 8-15) are a0..a3.  B: of two neighbouring unit tiles, (k
  // 0-7) and (k 8-15) of each are b0, b1.
  const int lane = g * 4 + t, r = lane & 7, tile = lane >> 3;
  const uint32_t* a_row = xr + (r + 8 * (tile & 1)) * L::kPitchX + 4 * (tile >> 1);
  const uint32_t* b_row = w1s + (r + 8 * (tile >> 1)) * L::kPitchX + 4 * (tile & 1);
#pragma unroll 4
  for (int ks = 0; ks < L::kSteps1; ++ks) {
    uint32_t a[4];
    load_tiles(a, a_row + ks * 8);
#pragma unroll
    for (int j = 0; j < L::kTiles1; j += 2) {
      uint32_t b[4];
      load_tiles(b, b_row + j * 8 * L::kPitchX + ks * 8);
      mma_bf16(h[j], a, b[0], b[1]);
      mma_bf16(h[j + 1], a, b[2], b[3]);
    }
  }
}

// h = gelu(h + b1[c0 ..]) in fp32; the thread holds columns 2t, 2t+1 of
// every tile, in rows g (c0, c1) and g+8 (c2, c3).
template <typename T, int NT>
__device__ __forceinline__ void bias_gelu(float (*h)[4], const T* __restrict__ b1, int c0,
                                          int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float bias0 = as_float(b1[c0 + j * 8 + 2 * t]);
    const float bias1 = as_float(b1[c0 + j * 8 + 2 * t + 1]);
    h[j][0] = gelu_erf(h[j][0] + bias0);
    h[j][1] = gelu_erf(h[j][1] + bias1);
    h[j][2] = gelu_erf(h[j][2] + bias0);
    h[j][3] = gelu_erf(h[j][3] + bias1);
  }
}

// acc += g w2_chunk, g being the accumulator tiles of the first product.
// fp32: the chunk's product of a group of output tiles is summed on its own
// (12 chained `mma`s) and added to acc rounded to nearest; see first_product.
template <int D>
__device__ __forceinline__ void second_product(float (*acc)[4], const float (*h)[4],
                                               const uint32_t* w2s, int g, int t, float) {
  using L = Layout<float, D>;
  AFrag a[L::kTiles1];  // hidden units 8j .. 8j+7 of the chunk
#pragma unroll
  for (int j = 0; j < L::kTiles1; ++j) a[j] = a_from_acc(h[j]);
#pragma unroll
  for (int n0 = 0; n0 < L::kTiles2; n0 += kGroup) {
    float part[kGroup][4] = {};
#pragma unroll
    for (int j = 0; j < L::kTiles1; ++j) {
      float b0[kGroup], b1[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            w2s + ((n0 + i) * 8 + g) * L::kPitch2 + j * 8 + 2 * t);
        b0[i] = __uint_as_float(b.x);
        b1[i] = __uint_as_float(b.y);
      }
      mma_split<false, false, kGroup>(part, a[j], b0, b1);
    }
    add_tiles<kGroup>(acc + n0, part);
  }
}

template <int D>
__device__ __forceinline__ void second_product(float (*acc)[4], const float (*h)[4],
                                               const uint32_t* w2s, int g, int t,
                                               __nv_bfloat16) {
  using L = Layout<__nv_bfloat16, D>;
#pragma unroll
  for (int j = 0; j < L::kSteps2; ++j) {  // hidden units 16j .. 16j+15 of the chunk
    // g rounded to bf16 here; tiles 2j and 2j+1 are k = 2t, 2t+1 and
    // k = 2t+8, 2t+9 of the step, which is the A layout of m16n8k16
    const uint32_t a[4] = {pack_bf16(h[2 * j][0], h[2 * j][1]),
                           pack_bf16(h[2 * j][2], h[2 * j][3]),
                           pack_bf16(h[2 * j + 1][0], h[2 * j + 1][1]),
                           pack_bf16(h[2 * j + 1][2], h[2 * j + 1][3])};
    const int lane = g * 4 + t;
    const uint32_t* b_row =
        w2s + ((lane & 7) + 8 * (lane >> 4)) * L::kPitch2 + 4 * ((lane >> 3) & 1) + j * 8;
#pragma unroll
    for (int n = 0; n < L::kTiles2; n += 2) {
      uint32_t b[4];
      load_tiles(b, b_row + n * 8 * L::kPitch2);
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                     const T* __restrict__ b1, const T* __restrict__ w2,
                     const T* __restrict__ b2, T* __restrict__ out, int m, int hidden,
                     int w1_k_contiguous, int w2_k_contiguous) {
  using L = Layout<T, D>;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* xs = smem;                // [warps * 16][kPitchX]
  uint32_t* w1s = xs + L::kXWords;    // [chunk][kPitchX]
  uint32_t* w2s = w1s + L::kW1Words;  // [D][kPitch2]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int block_rows = (blockDim.x >> 5) * kWarpRows;
  const int block_row0 = blockIdx.x * block_rows;
  const int row0 = block_row0 + warp * kWarpRows;
  const bool has_rows = row0 < m;  // the same for the whole warp
  const uint32_t* xr = xs + warp * kWarpRows * L::kPitchX;

  load_x<T, D>(xs, x, block_row0, block_rows, m);
  load_w1<T, D>(w1s, w1, 0, hidden, w1_k_contiguous);
  commit_copies();

  float acc[L::kTiles2][4];
#pragma unroll
  for (int n = 0; n < L::kTiles2; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int c0 = 0; c0 < hidden; c0 += L::kChunk) {
    // w1's chunk has landed for everyone, and everyone is done with w2's slot
    wait_copies();
    __syncthreads();
    load_w2<T, D>(w2s, w2, c0, hidden, w2_k_contiguous);
    commit_copies();

    float h[L::kTiles1][4];
#pragma unroll
    for (int j = 0; j < L::kTiles1; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) h[j][c] = 0.f;
    if (has_rows) {
      first_product<D>(h, xr, w1s, g, t, T());
      bias_gelu<T, L::kTiles1>(h, b1, c0, t);
    }

    // w2's chunk has landed, and everyone is done with w1's slot
    wait_copies();
    __syncthreads();
    if (c0 + L::kChunk < hidden) {
      load_w1<T, D>(w1s, w1, c0 + L::kChunk, hidden, w1_k_contiguous);
      commit_copies();
    }
    if (has_rows) second_product<D>(acc, h, w2s, g, t, T());
  }

#pragma unroll
  for (int n = 0; n < L::kTiles2; ++n) {
    const int col = n * 8 + 2 * t;
    const float bias0 = as_float(b2[col]), bias1 = as_float(b2[col + 1]);
    if (row0 + g < m)
      store_pair(out + (size_t)(row0 + g) * D + col, acc[n][0] + bias0, acc[n][1] + bias1);
    if (row0 + g + 8 < m)
      store_pair(out + (size_t)(row0 + g + 8) * D + col, acc[n][2] + bias0, acc[n][3] + bias1);
  }
}

// Warps a block and blocks for m rows on `sms` SMs: as few waves of
// 8-warp blocks as the rows need, and the rows dealt evenly over them.
void plan(int m, int sms, int* blocks, int* warps) {
  const int tiles = (m + kWarpRows - 1) / kWarpRows;
  const int waves = (tiles + sms * kMaxWarps - 1) / (sms * kMaxWarps);
  *warps = (tiles + sms * waves - 1) / (sms * waves);
  *blocks = (tiles + *warps - 1) / *warps;
}

cudaError_t sm_count(int device, int* sms) {
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

template <typename T, int D>
cudaError_t launch_d(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, void* out, int m, int hidden, int w1_k_contiguous,
                     int w2_k_contiguous, int device, cudaStream_t stream) {
  auto kernel = fused_mlp_kernel<T, D>;
  cudaError_t err = allow_dynamic_smem(kernel, device);
  if (err != cudaSuccess) return err;
  int sms = 0, blocks = 0, warps = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  plan(m, sms, &blocks, &warps);
  kernel<<<blocks, warps * 32, Layout<T, D>::kSmemBytes, stream>>>(
      (const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, (T*)out, m,
      hidden, w1_k_contiguous, w2_k_contiguous);
  return cudaGetLastError();
}

bool takes(int d, int hidden) {
  return (d == 128 || d == 256) && hidden > 0 && hidden % 64 == 0;
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int m, int d, int hidden, int w1_k_contiguous, int w2_k_contiguous,
           int device, void* stream) {
  if (m <= 0 || !takes(d, hidden)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d == 128)
    return (int)launch_d<T, 128>(x, w1, b1, w2, b2, out, m, hidden, w1_k_contiguous,
                                 w2_k_contiguous, device, (cudaStream_t)stream);
  return (int)launch_d<T, 256>(x, w1, b1, w2, b2, out, m, hidden, w1_k_contiguous,
                               w2_k_contiguous, device, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// 1 where the kernel takes these widths: D of 128 or 256, hidden a positive
// multiple of 64.
int fused_mlp_takes(int d, int hidden) { return takes(d, hidden); }

// The launch of m rows on `device`: blocks, and warps (16 rows each) a block.
int fused_mlp_plan(int m, int device, int* blocks, int* warps) {
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err == cudaSuccess) plan(m, sms, blocks, warps);
  return (int)err;
}

const char* fused_mlp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream`; allocate nothing, do not synchronise.  Return the
// cudaError_t of the launch (0 on success).  `w*_k_contiguous`: 1 where the
// weight is the transposed view of a row-major [out, in] tensor, 0 where it
// is row-major [in, out].  All tensors float, or all bfloat16.
int fused_mlp(const void* x, const void* w1, const void* b1, const void* w2,
              const void* b2, void* out, int m, int d, int hidden, int w1_k_contiguous,
              int w2_k_contiguous, int device, void* stream) {
  return launch<float>(x, w1, b1, w2, b2, out, m, d, hidden, w1_k_contiguous,
                       w2_k_contiguous, device, stream);
}

int fused_mlp_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int m, int d, int hidden,
                   int w1_k_contiguous, int w2_k_contiguous, int device, void* stream) {
  return launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, m, d, hidden, w1_k_contiguous,
                               w2_k_contiguous, device, stream);
}

}  // extern "C"
