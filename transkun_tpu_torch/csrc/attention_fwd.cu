// Multi-head attention forward on Hopper (sm_90a).
//
// Replaces the TPU kernel _fwd_kernel in transkun_tpu/ops/attention_pallas.py
// (called through _fwd / fused_attention).  Per batch element b and head h,
// with heads as column slices of the flat [B, S, H*dh] layout:
//
//   logits = (q k^T) * scale     [Sq, Skv], fp32
//   p      = exp(logits - rowmax(logits))
//   o      = (p v) / rowsum(p)   [Sq, dh]
//
// q, k, v are float or bfloat16 and go to fp32 as they are loaded; logits,
// softmax and both sums are fp32; o is written in the input type.  The
// [Sq, Skv] logits never reach device memory (nor shared memory) and no
// [B, H, S, dh] transpose pass exists.  Accurate expf; the build must not
// use --use_fast_math.
//
// What bounds it: by the count, operations (at the flagship shape
// [89, 149, 256], 8 heads, fp32: 54 MB moved, 2.0 GFLOP, 0.030 ms at the
// CUDA cores' fp32 rate against 0.016 ms for the bytes); at bf16, bytes.  In
// practice the sequences are short (S = 89..149, dh = 32), the work is many
// small products, and what a design can lose is shared-memory bandwidth,
// the schedulers' rate and occupancy.  The first version of this kernel fed
// every FMA from two shared-memory loads, which caps it at 1/8 of the fp32
// rate (it measured 7.2%).
//
// Design (attention_fwd_mma; the building blocks are in attention_mma.cuh):
//   * One block per (b, h).  q, k and v of that head are loaded once into
//     fp32 shared-memory tiles with 16-byte loads (scalar loads where a
//     head's row is not 16-byte aligned), zero in the padding.
//   * Both products run on the tensor cores as m16n8k8 TF32 `mma.sync` with
//     the high/low operand split that makes them fp32-grade (three `mma` a
//     product at fp32, one or two at bf16).  The split rounds with two
//     integer operations; `cvt.rna.tf32.f32` compiles to four and made the
//     fp32 kernel a third slower.
//   * A warp owns 16 query rows at a time.  Its q fragments and the whole
//     row of logits, up to 20 tiles of 8 keys, stay in registers; row max
//     and row sum go through two shuffles among the four lanes that share a
//     row; expf once an element; the accumulator tiles of p are the A
//     operand of p v directly; one reciprocal a row.  The `mma`s of four
//     key tiles (or of the four column tiles of o) are written term by term,
//     so consecutive ones do not depend on each other.
//   * Keys past Skv get -inf logits, so p = 0 there; query rows past Sq are
//     computed on zeros and not stored.
//   * Blocks: 5 warps at Sq = 149 (10 row tiles, 2 a warp), 3 at Sq = 89 (6
//     tiles).  128 registers a thread (__launch_bounds__(160, 3); 8 bytes of
//     spill in the 20-tile fp32 instance) and 69,120 B of shared memory at
//     S = 149, dh = 32: 3 blocks, 15 warps an SM, so the 712 blocks of one
//     segment run in 1.8 waves of 396.  What is left is latency: about 4200
//     machine operations a row tile at fp32 (3000 at bf16), most of them the
//     softmax's elementwise work, running at half the schedulers' rate.
//   * cudaFuncSetAttribute once per kernel and device.
// The TPU kernel's group of G batch elements per grid step and its static
// lane slices were VMEM and Mosaic choices and are not carried over.
//
// Shapes the mma kernel does not hold in registers (Skv > 160, head_dim >
// 64, or tiles beyond the shared memory of a block) go to
// attention_fwd_general, the first version of this kernel: k and v in shared
// memory, a warp per query row, fp32 FMAs, any Skv that fits (about 880 keys
// at head_dim 32).
//
// Longer key sequences (the "0All" and "FT" branches attend over the whole
// F x T lattice: 89 x 149 = 13261 keys a segment at flagship width, 28480
// with downsampleF=False) go to attention_fwd_stream, which takes any Skv at
// head_dim <= 64.  The TPU kernel holds all of Skv in VMEM; a Hopper block
// has 227 KB, so the keys are streamed:
//   * A block per (b, h, tile of 64 query rows), 4 warps of 16 rows, the q
//     fragments in registers as in the mma kernel.
//   * It loops over tiles of 64 keys staged in shared memory (k and v as
//     fp32 tiles, the same loader), one tile at a time: logits by `mma`,
//     then an online softmax: the row's running max and sum in fp32, the
//     running output and sum rescaled by exp(old max - new max) as the max
//     moves.  A tile's p v goes into a fresh accumulator from the
//     accumulator tiles of p, as in the mma kernel, and is added to the
//     running output by an FMA: the tensor cores' fp32 accumulation does
//     not round to nearest, and a running sum kept in an `mma` accumulator
//     over 13261 keys (1658 `mma` deep) drifted by 1e-4 of |o| on path 7's
//     real activations (3.7e-4 at |o| = 3.4, past the products' rounding
//     bound).  One division a row at the end.  Nothing of size [Sq, Skv]
//     reaches device or shared memory.
//   * What bounds it: operations, 4 Sq Skv dh a head (0.18 TFLOP for one
//     segment's FT layer, 2.7 ms at the CUDA cores' fp32 rate).  The simple
//     schedule here loads each key tile synchronously (no copy overlapped
//     with the products within a block; 4 blocks an SM overlap each other),
//     and the 0All shape [4 x 8 heads, 89 queries, 13261 keys] gives only 64
//     blocks: splitting the keys across blocks with a combine pass, and
//     `wgmma`/TMA, are left for a redesign.

#include "attention_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// tensor-core kernel: Skv <= 8 * NT, head_dim <= 8 * KD
// ---------------------------------------------------------------------------

// Blocks of at most 5 warps, 3 to an SM: 128 registers a thread.  Device time
// at [356, 149, 256] fp32 on an H100 SXM at 700 W: 0.31 ms so, 0.39 ms with 6
// warps and 2 blocks (168 registers), 0.82 ms with 8 warps and 1 block (227
// registers).
constexpr int kMaxWarps = 5, kMinBlocks = 3;

__host__ __device__ constexpr size_t mma_smem_bytes(int sq, int skv, int dhp) {
  return (size_t)(ceil_to(sq, 16) + 2 * ceil_to(skv, 8 * kGroup)) * (dhp + kPitchPad) *
         sizeof(float);
}

template <typename T, int NT, int KD>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
    attention_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
                      int heads, int dh, float scale, int vec) {
  constexpr bool kExact = kExactInTf32<T>;
  constexpr int kDhp = KD * 8, kPitch = kDhp + kPitchPad;
  extern __shared__ __align__(16) float smem[];
  const int q_rows = ceil_to(sq, 16), kv_rows = ceil_to(skv, 8 * kGroup);
  float* qs = smem;                  // [q_rows][kPitch]
  float* ks = qs + q_rows * kPitch;  // [kv_rows][kPitch]
  float* vs = ks + kv_rows * kPitch;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t ld = (size_t)heads * dh;
  const size_t q_at = (size_t)b * sq * ld + h * dh;
  const size_t k_at = (size_t)b * skv * ld + h * dh;

  load_tile(qs, q + q_at, sq, q_rows, dh, kDhp, kPitch, ld, vec);
  load_tile(ks, k + k_at, skv, kv_rows, dh, kDhp, kPitch, ld, vec);
  load_tile(vs, v + k_at, skv, kv_rows, dh, kDhp, kPitch, ld, vec);
  __syncthreads();

  const float neg_inf = __int_as_float(0xff800000);
  for (int r0 = warp * 16; r0 < sq; r0 += warps * 16) {
    AFrag qa[KD];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      qa[kk] = a_from_tile<kExact>(qs + r0 * kPitch, kPitch, kk * 8, g, t);

    // logits of rows r0+g (s[j][0..1]) and r0+g+8 (s[j][2..3]), keys
    // 8j+2t and 8j+2t+1
    float s[NT][4];
    float m0 = neg_inf, m1 = neg_inf;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; j += kGroup) {
      if (j * 8 < skv) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          mma_rows_as_columns<kExact, kExact, kGroup>(&s[j], qa[kk], ks + j * 8 * kPitch,
                                                      kPitch, kk * 8, g, t);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c)  // only the last tile has keys past Skv
        s[j][c] = ((j + 1) * 8 <= skv || j * 8 + 2 * t + (c & 1) < skv) ? s[j][c] * scale
                                                                         : neg_inf;
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);

    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = expf(s[j][0] - m0);
      s[j][1] = expf(s[j][1] - m0);
      s[j][2] = expf(s[j][2] - m1);
      s[j][3] = expf(s[j][3] - m1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    sum0 = quad_sum(sum0);
    sum1 = quad_sum(sum1);

    float acc[KD][4];
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j * 8 < skv) {
        const AFrag pa = a_from_acc(s[j]);
        mma_rows_summed<kExact, KD>(acc, pa, vs + j * 8 * kPitch, kPitch, g, t);
      }
    }

    // every row has a key, so its sum is at least exp(0); the guard keeps a
    // zero sum from dividing all the same
    const float inv0 = sum0 > 0.f ? 1.f / sum0 : 0.f;
    const float inv1 = sum1 > 0.f ? 1.f / sum1 : 0.f;
#pragma unroll
    for (int n = 0; n < KD; ++n)
      store_acc(o + q_at, acc[n], inv0, inv1, r0, sq, n * 8, dh, ld, g, t);
  }
}

// ---------------------------------------------------------------------------
// general kernel: any Skv and head_dim whose k and v fit shared memory
// ---------------------------------------------------------------------------

constexpr int kGeneralWarps = 8;

__host__ __device__ constexpr int row_stride(int dh) { return dh | 1; }

__host__ __device__ constexpr size_t general_smem_bytes(int skv, int dh) {
  return ((size_t)2 * skv * row_stride(dh) + (size_t)kGeneralWarps * dh +
          (size_t)kGeneralWarps * skv) * sizeof(float);
}

// One block per (b, h); k and v in shared memory on an odd row stride, so 32
// lanes reading 32 rows hit 32 banks.  A warp owns one query row at a time:
// a lane per key for the logits, shuffles for max and sum, the unnormalised
// p in a per-warp row, then a lane per column for p v and one division.
template <typename T>
__global__ void __launch_bounds__(kGeneralWarps * 32)
    attention_fwd_general(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
                          int heads, int dh, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(dh);
  float* ks = smem;                             // [skv][ld]
  float* vs = ks + (size_t)skv * ld;            // [skv][ld]
  float* qrows = vs + (size_t)skv * ld;         // [kGeneralWarps][dh]
  float* probs = qrows + kGeneralWarps * dh;    // [kGeneralWarps][skv]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int d_model = heads * dh;
  const T* qb = q + (size_t)b * sq * d_model + h * dh;
  const T* kb = k + (size_t)b * skv * d_model + h * dh;
  const T* vb = v + (size_t)b * skv * d_model + h * dh;
  T* ob = o + (size_t)b * sq * d_model + h * dh;

  for (int idx = threadIdx.x; idx < skv * dh; idx += blockDim.x) {
    const int j = idx / dh, d = idx - j * dh;
    ks[j * ld + d] = as_float(kb[(size_t)j * d_model + d]);
    vs[j * ld + d] = as_float(vb[(size_t)j * d_model + d]);
  }
  __syncthreads();

  float* qrow = qrows + warp * dh;
  float* p = probs + (size_t)warp * skv;
  for (int r = warp; r < sq; r += kGeneralWarps) {
    for (int d = lane; d < dh; d += 32)
      qrow[d] = as_float(qb[(size_t)r * d_model + d]) * scale;
    __syncwarp();

    float m = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < skv; j += 32) {
      const float* kj = ks + j * ld;
      float acc = 0.f;
      for (int d = 0; d < dh; ++d) acc = fmaf(qrow[d], kj[d], acc);
      p[j] = acc;
      m = fmaxf(m, acc);
    }
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

    float s = 0.f;
    for (int j = lane; j < skv; j += 32) {
      const float e = expf(p[j] - m);
      p[j] = e;
      s += e;
    }
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    __syncwarp();

    for (int d = lane; d < dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < skv; ++j) acc = fmaf(p[j], vs[j * ld + d], acc);
      store_float(ob + (size_t)r * d_model + d, acc / s);
    }
    __syncwarp();  // the next row overwrites qrow and p
  }
}

// ---------------------------------------------------------------------------
// streaming kernel: any Skv, head_dim <= 64
// ---------------------------------------------------------------------------

// q tile, and one tile of k and of v
__host__ __device__ constexpr size_t stream_smem_bytes(int dhp) {
  return (size_t)(kStreamRows + 2 * kStreamKeys) * (dhp + kPitchPad) * sizeof(float);
}

template <typename T, int KD>
__global__ void __launch_bounds__(kStreamWarps * 32, KD > 4 ? 2 : 3)
    attention_fwd_stream(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
                         int heads, int dh, float scale, int vec) {
  constexpr bool kExact = kExactInTf32<T>;
  constexpr int kDhp = KD * 8, kPitch = kDhp + kPitchPad;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [kStreamRows][kPitch]
  float* ks = qs + kStreamRows * kPitch;  // [kStreamKeys][kPitch]
  float* vs = ks + kStreamKeys * kPitch;  // [kStreamKeys][kPitch]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q_tiles = (sq + kStreamRows - 1) / kStreamRows;
  const int bh = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * kStreamRows;
  const int b = bh / heads, h = bh % heads;
  const size_t ld = (size_t)heads * dh;
  const size_t q_at = ((size_t)b * sq + q0) * ld + h * dh;  // the block's row 0
  const size_t k_at = (size_t)b * skv * ld + h * dh;
  const int rows = min(kStreamRows, sq - q0);
  const int r0 = warp * 16;  // the warp's rows in the block's tile
  const bool active = r0 < rows;

  load_tile(qs, q + q_at, rows, kStreamRows, dh, kDhp, kPitch, ld, vec);
  __syncthreads();
  AFrag qa[KD];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    qa[kk] = a_from_tile<kExact>(qs + r0 * kPitch, kPitch, kk * 8, g, t);

  // rows r0+g (index 0) and r0+g+8 (index 1): running max, this thread's
  // part of the running sum, the running p v
  const float neg_inf = __int_as_float(0xff800000);
  float m0 = neg_inf, m1 = neg_inf, l0 = 0.f, l1 = 0.f;
  float acc[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int kv0 = 0; kv0 < skv; kv0 += kStreamKeys) {
    const int keys = min(kStreamKeys, skv - kv0);
    __syncthreads();  // every warp is done with the previous tile
    load_tile(ks, k + k_at + (size_t)kv0 * ld, keys, kStreamKeys, dh, kDhp, kPitch, ld, vec);
    load_tile(vs, v + k_at + (size_t)kv0 * ld, keys, kStreamKeys, dh, kDhp, kPitch, ld, vec);
    __syncthreads();
    if (!active) continue;

    float s[kStreamTiles][4];
#pragma unroll
    for (int j = 0; j < kStreamTiles; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int j = 0; j < kStreamTiles; j += kGroup) {
      if (j * 8 < keys) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          mma_rows_as_columns<kExact, kExact, kGroup>(&s[j], qa[kk], ks + j * 8 * kPitch,
                                                      kPitch, kk * 8, g, t);
      }
    }
    float mt0 = neg_inf, mt1 = neg_inf;
#pragma unroll
    for (int j = 0; j < kStreamTiles; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c)  // keys past the tile's last get -inf, so p = 0
        s[j][c] = j * 8 + 2 * t + (c & 1) < keys ? s[j][c] * scale : neg_inf;
      mt0 = fmaxf(mt0, fmaxf(s[j][0], s[j][1]));
      mt1 = fmaxf(mt1, fmaxf(s[j][2], s[j][3]));
    }
    // every tile has a key, so the new max is finite; on the first tile the
    // old max is -inf and its factor 0
    const float mn0 = fmaxf(m0, quad_max(mt0)), mn1 = fmaxf(m1, quad_max(mt1));
    const float f0 = expf(m0 - mn0), f1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= f0;
    l1 *= f1;
#pragma unroll
    for (int j = 0; j < kStreamTiles; ++j) {
      s[j][0] = expf(s[j][0] - m0);
      s[j][1] = expf(s[j][1] - m0);
      s[j][2] = expf(s[j][2] - m1);
      s[j][3] = expf(s[j][3] - m1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    float part[KD][4];  // this tile's p v
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[n][c] = 0.f;
#pragma unroll
    for (int j = 0; j < kStreamTiles; ++j) {
      if (j * 8 < keys) {
        const AFrag pa = a_from_acc(s[j]);
        mma_rows_summed<kExact, KD>(part, pa, vs + j * 8 * kPitch, kPitch, g, t);
      }
    }
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] = fmaf(acc[n][c], c < 2 ? f0 : f1, part[n][c]);
  }
  if (!active) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int n = 0; n < KD; ++n)
    store_acc(o + q_at, acc[n], inv0, inv1, r0, rows, n * 8, dh, ld, g, t);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

enum Variant { kAuto = -1, kMma = 0, kGeneral = 1, kStream = 2 };

constexpr int padded_head_dim(int dh) { return dh <= 16 ? 16 : dh <= 32 ? 32 : 64; }

bool mma_takes(int sq, int skv, int dh) {
  return skv <= 8 * kMaxKeyTiles && dh <= kMaxHeadDim &&
         mma_smem_bytes(sq, skv, padded_head_dim(dh)) <= kSmemLimit;
}

// The variant that runs the shape: the one asked for; else the mma kernel
// where it takes the shape, the streaming one for any other head_dim up to
// 64 (2.9-4.2x faster than the general one at fp32 at 200 and 320 keys on an H100,
// `scripts/profile_torch_attention.py --only-variants`), and the general
// one for a wider head_dim.  Where k and v do not fit the general kernel's
// shared memory, its size exceeds the limit and makes the caller refuse
// the shape.
int pick(int variant, int sq, int skv, int dh) {
  if (variant != kAuto) return variant;
  if (mma_takes(sq, skv, dh)) return kMma;
  return stream_takes(dh) ? kStream : kGeneral;
}

template <typename T, int NT, int KD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int b,
                       int sq, int skv, int heads, int dh, float scale, int device,
                       cudaStream_t stream) {
  auto kernel = attention_fwd_mma<T, NT, KD>;
  cudaError_t err = allow_dynamic_smem(kernel, device);
  if (err != cudaSuccess) return err;
  bool vec = (dh * sizeof(T)) % 16 == 0;
  for (const void* p : {q, k, v}) vec = vec && ((uintptr_t)p % 16 == 0);
  const int warps = warps_for((sq + 15) / 16, kMaxWarps);
  kernel<<<b * heads, warps * 32, mma_smem_bytes(sq, skv, KD * 8), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, heads, dh, scale, (int)vec);
  return cudaGetLastError();
}

template <typename T, int KD>
cudaError_t launch_stream(const void* q, const void* k, const void* v, void* o, int b,
                          int sq, int skv, int heads, int dh, float scale, int device,
                          cudaStream_t stream) {
  auto kernel = attention_fwd_stream<T, KD>;
  cudaError_t err = allow_dynamic_smem(kernel, device);
  if (err != cudaSuccess) return err;
  bool vec = (dh * sizeof(T)) % 16 == 0;
  for (const void* p : {q, k, v}) vec = vec && ((uintptr_t)p % 16 == 0);
  const int q_tiles = (sq + kStreamRows - 1) / kStreamRows;
  kernel<<<b * heads * q_tiles, kStreamWarps * 32, stream_smem_bytes(KD * 8), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, heads, dh, scale, (int)vec);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq,
           int skv, int heads, int dh, float scale, int variant, int device,
           void* stream_ptr, int* ran) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  variant = pick(variant, sq, skv, dh);
  *ran = variant;
  if (variant == kStream) {
    if (!stream_takes(dh)) return (int)cudaErrorInvalidValue;
    switch (padded_head_dim(dh)) {
      case 16:
        return (int)launch_stream<T, 2>(q, k, v, o, b, sq, skv, heads, dh, scale, device, stream);
      case 32:
        return (int)launch_stream<T, 4>(q, k, v, o, b, sq, skv, heads, dh, scale, device, stream);
      default:
        return (int)launch_stream<T, 8>(q, k, v, o, b, sq, skv, heads, dh, scale, device, stream);
    }
  }
  if (variant == kGeneral) {
    auto kernel = attention_fwd_general<T>;
    err = allow_dynamic_smem(kernel, device);
    if (err != cudaSuccess) return (int)err;
    kernel<<<b * heads, kGeneralWarps * 32, general_smem_bytes(skv, dh), stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, heads, dh, scale);
    return (int)cudaGetLastError();
  }
  if (variant != kMma || !mma_takes(sq, skv, dh)) return (int)cudaErrorInvalidValue;
#define ATTENTION_FWD_CASE(NT, KD) \
  launch_mma<T, NT, KD>(q, k, v, o, b, sq, skv, heads, dh, scale, device, stream)
  const bool few_keys = skv <= 96;
  switch (padded_head_dim(dh)) {
    case 16:
      return (int)(few_keys ? ATTENTION_FWD_CASE(12, 2)
                            : ATTENTION_FWD_CASE(kMaxKeyTiles, 2));
    case 32:
      return (int)(few_keys ? ATTENTION_FWD_CASE(12, 4)
                            : ATTENTION_FWD_CASE(kMaxKeyTiles, 4));
    default:
      return (int)(few_keys ? ATTENTION_FWD_CASE(12, 8)
                            : ATTENTION_FWD_CASE(kMaxKeyTiles, 8));
  }
#undef ATTENTION_FWD_CASE
}

}  // namespace

extern "C" {

// Shared memory a block needs at this shape with `variant` (-1: the one the
// launch would pick, 0: the tensor-core kernel, 1: the general kernel, 2:
// the streaming kernel), or -1 where that variant does not take the shape.
// Above the block's limit means that nothing takes it.
long long attention_fwd_smem_bytes(int sq, int skv, int dh, int variant) {
  variant = pick(variant, sq, skv, dh);
  if (variant == kGeneral) return (long long)general_smem_bytes(skv, dh);
  if (variant == kStream)
    return stream_takes(dh) ? (long long)stream_smem_bytes(padded_head_dim(dh)) : -1;
  if (variant != kMma || !mma_takes(sq, skv, dh)) return -1;
  return (long long)mma_smem_bytes(sq, skv, padded_head_dim(dh));
}

// 0: the tensor-core kernel runs this shape, 1: the general kernel, 2: the
// streaming kernel.
int attention_fwd_variant(int sq, int skv, int dh) { return pick(kAuto, sq, skv, dh); }

const char* attention_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream`; allocate nothing, do not synchronise.  Return the
// cudaError_t of the launch (0 on success) and write the variant that ran
// to `ran`.  float and bfloat16 tensors.
int attention_fwd(const void* q, const void* k, const void* v, void* o, int b,
                  int sq, int skv, int heads, int dh, float scale, int variant,
                  int device, void* stream, int* ran) {
  return launch<float>(q, k, v, o, b, sq, skv, heads, dh, scale, variant, device, stream,
                       ran);
}

int attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, int b,
                       int sq, int skv, int heads, int dh, float scale, int variant,
                       int device, void* stream, int* ran) {
  return launch<__nv_bfloat16>(q, k, v, o, b, sq, skv, heads, dh, scale, variant, device,
                               stream, ran);
}

}  // extern "C"
