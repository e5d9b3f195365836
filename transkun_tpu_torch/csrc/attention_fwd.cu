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
// [B, H, S, dh] transpose pass exists.  Accurate expf (in the streaming
// kernel the SFU's 2^x, exp2_neg); the build must not use --use_fast_math.
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
// has 227 KB, so the keys are streamed (building blocks in
// attention_stream.cuh):
//   * A block per (b, h, query tile, split of the keys): a tile is up to 96
//     rows (0All's 89: 6 warps, none idle) or 64, 16 rows a warp with their
//     q fragments in registers.  Key tiles of 64 stream through a ring of
//     shared-memory stages that `cp.async` fills (2 at fp32, 3 at bf16):
//     tile j+1 lands while tile j is multiplied, one __syncthreads a tile.
//   * bf16 keeps k and v as bf16 tiles and runs `mma.m16n8k16` from
//     `ldmatrix` fragments: q k^T one `mma` a step (exact products), p v two
//     (p split into bf16 high and low halves).  fp32 keeps the TF32 high/low
//     split, three `mma` a product.
//   * Online softmax in log2 units (scale * log2(e) folded into the FMA
//     before the SFU's 2^x, exp2_neg): the row's running max and sum in
//     fp32, the running output rescaled as the max moves; the key mask only
//     on the last, partial tile.  A tile's p v goes into a fresh accumulator, added to
//     the running output by an FMA: the tensor cores' fp32 accumulation
//     does not round to nearest, and a running sum kept in an `mma`
//     accumulator over 13261 keys drifted by 1e-4 of |o| on path 7's real
//     activations.  One division a row at the end.
//   * Where the blocks of (b, h, query tile) are short of two an SM (0All:
//     8 or 32 of them for 132 SMs), ops/attention.py::stream_plan splits the
//     keys into contiguous runs of tiles, a block each; each writes its
//     unnormalised output and its rows' max and sum in fp32, and
//     attention_fwd_combine joins them in split order (same bits every
//     run).  FT (1664 blocks) takes one split and writes o directly.
//   * Each row's max and 1 / sum go to `stats` [2, B*H, Sq], which the
//     backward takes instead of sweeping the keys for them.
//   * What bounds it: at bf16 the exponentials (one an element: 0.34 ms for
//     FT's 8 x 13261^2 at 16 an SM a clock) and the elementwise work around
//     them (scale, max, sum, the split of p: about 10 operations an
//     element), against 0.18 ms for the tensor cores; at fp32 the TF32
//     products (three a product, 1.09 ms for FT); 0All is latency of short
//     blocks.  Nothing of size [Sq, Skv] reaches device or shared memory.

#include "attention_stream.cuh"

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
// streaming kernel: any Skv, head_dim <= 64 (building blocks in
// attention_stream.cuh)
// ---------------------------------------------------------------------------

// A block per (b, h, tile of 16 * warps query rows, split of the key tiles).
// The exponent base is 2: the logits are taken in log2 units, scale *
// log2(e) * q k^T, folded into the FMA before 2^x.  With one split the
// block writes o and each row's statistics (max of those logits, 1 / sum)
// to `stats` [2, B*H, Sq]; with more, its unnormalised output to `part`
// [splits, B*H, Sq, dh] and each row's max and sum to `part_ml` [2, splits,
// B*H, Sq], which attention_fwd_combine joins.
template <typename T, int KD>
__global__ void __launch_bounds__(kStreamThreads<T>, KD <= 4 ? 2 : 1)
    attention_fwd_stream(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, float* __restrict__ stats,
                         float* __restrict__ part, float* __restrict__ part_ml, int sq, int skv,
                         int heads, int dh, float scale, int splits, int per_split, int vec) {
  using G = StreamTile<T, KD>;
  using M = StreamMath<T, KD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const float log2_scale = scale * kLog2e;  // the logits in log2 units, for 2^x
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int block_rows = warps * 16, q_tiles = (sq + block_rows - 1) / block_rows;
  const int split = blockIdx.x % splits, qt = (blockIdx.x / splits) % q_tiles;
  const int bh = blockIdx.x / (splits * q_tiles), b = bh / heads, h = bh % heads;
  const int key_tiles = (skv + kStreamKeys - 1) / kStreamKeys;
  const SplitRange range = split_range(split, per_split, key_tiles);
  const int n = range.end - range.first;  // at least 1 (plan_takes)
  const size_t ld = (size_t)heads * dh;
  const int q0 = qt * block_rows, rows = min(block_rows, sq - q0);
  const size_t q_at = ((size_t)b * sq + q0) * ld + h * dh;  // the block's row 0
  const size_t k_at = ((size_t)b * skv + (size_t)range.first * kStreamKeys) * ld + h * dh;
  const int r0 = warp * 16;  // the warp's rows in the block's tile
  const bool active = r0 < rows;
  T* qs = reinterpret_cast<T*>(smem_raw);  // [block_rows][kPitch]
  T* ring = qs + block_rows * G::kPitch;   // kStages x (k tile, v tile)

  auto keys_of = [&](int j) { return min(kStreamKeys, skv - (range.first + j) * kStreamKeys); };
  auto load_kv = [&](int j) {  // the split's tile j into its stage of the ring
    T* ks = ring + (j % G::kStages) * 2 * G::kTile;
    const size_t at = k_at + (size_t)j * kStreamKeys * ld;
    load_rows<T, KD>(ks, k + at, keys_of(j), kStreamKeys, ld, dh, vec);
    load_rows<T, KD>(ks + G::kTile, v + at, keys_of(j), kStreamKeys, ld, dh, vec);
  };

  load_rows<T, KD>(qs, q + q_at, rows, block_rows, ld, dh, vec);
  commit_copies();
#pragma unroll
  for (int j = 0; j < G::kStages - 1; ++j) {
    if (j < n) load_kv(j);
    commit_copies();
  }
  wait_copies<G::kStages - 1>();  // the query rows have landed
  __syncthreads();
  typename M::Frags qa;
  M::a_frags(qa, qs + r0 * G::kPitch, lane);

  // rows r0+g (index 0) and r0+g+8 (index 1): running max of the logits
  // in log2 units, this thread's part of the running sum, the running p v
  const float neg_inf = __int_as_float(0xff800000);
  float m0 = neg_inf, m1 = neg_inf, l0 = 0.f, l1 = 0.f;
  float acc[KD][4] = {};
  for (int j = 0; j < n; ++j) {
    wait_copies<G::kStages - 2>();  // this thread's copies of tile j have landed
    __syncthreads();                // everyone's; and every warp is done with tile j-1
    if (j + G::kStages - 1 < n) load_kv(j + G::kStages - 1);  // into tile j-1's stage
    commit_copies();
    if (!active) continue;
    const T* ks = ring + (j % G::kStages) * 2 * G::kTile;
    const T* vs = ks + G::kTile;

    // logits of rows r0+g (s[i][0..1]) and r0+g+8 (s[i][2..3]), keys
    // 8i+2t and 8i+2t+1 of the tile, not yet scaled
    float s[2 * kGroup][4] = {};
    M::rows_product(s, qa, ks, lane);
    M::rows_product(s + kGroup, qa, ks + 8 * kGroup * G::kPitch, lane);
    const int keys = keys_of(j);
    if (keys < kStreamKeys) {  // the last tile of the keys: p = 0 past its last key
#pragma unroll
      for (int i = 0; i < 2 * kGroup; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (i * 8 + 2 * t + (c & 1) >= keys) s[i][c] = neg_inf;
    }
    float mt0 = neg_inf, mt1 = neg_inf;
#pragma unroll
    for (int i = 0; i < 2 * kGroup; ++i) {
      mt0 = fmaxf(mt0, fmaxf(s[i][0], s[i][1]));
      mt1 = fmaxf(mt1, fmaxf(s[i][2], s[i][3]));
    }
    // every tile has a key, so the new max is finite; on the first tile the
    // old max is -inf and its factor 0
    const float mn0 = fmaxf(m0, quad_max(mt0) * log2_scale),
                mn1 = fmaxf(m1, quad_max(mt1) * log2_scale);
    const float f0 = exp2_neg(m0 - mn0), f1 = exp2_neg(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= f0;
    l1 *= f1;
#pragma unroll
    for (int i = 0; i < 2 * kGroup; ++i) {
      s[i][0] = exp2_neg(fmaf(s[i][0], log2_scale, -m0));
      s[i][1] = exp2_neg(fmaf(s[i][1], log2_scale, -m0));
      s[i][2] = exp2_neg(fmaf(s[i][2], log2_scale, -m1));
      s[i][3] = exp2_neg(fmaf(s[i][3], log2_scale, -m1));
      l0 += s[i][0] + s[i][1];
      l1 += s[i][2] + s[i][3];
    }
    float pv[KD][4] = {};  // this tile's p v, added to the running sum by an FMA
    M::summed_product(pv, s, vs, lane);
    M::summed_product(pv, s + kGroup, vs + 8 * kGroup * G::kPitch, lane);
#pragma unroll
    for (int c0 = 0; c0 < KD; ++c0)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c0][c] = fmaf(acc[c0][c], c < 2 ? f0 : f1, pv[c0][c]);
  }
  if (!active) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const size_t plane = (size_t)(gridDim.x / (splits * q_tiles)) * sq;  // B*H*Sq
  const size_t row_at = (size_t)bh * sq + q0 + r0 + g;  // row r0+g in a [B*H, Sq] plane
  const bool row0 = r0 + g < rows, row1 = r0 + g + 8 < rows;
  if (splits == 1) {
    // every row has a key, so its sum is at least exp(0)
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
    for (int c0 = 0; c0 < KD; ++c0)
      store_acc(o + q_at, acc[c0], inv0, inv1, r0, rows, c0 * 8, dh, ld, g, t);
    if (t == 0) {
      if (row0) stats[row_at] = m0, stats[plane + row_at] = inv0;
      if (row1) stats[row_at + 8] = m1, stats[plane + row_at + 8] = inv1;
    }
    return;
  }
  float* mine = part + ((size_t)split * plane + (size_t)bh * sq + q0) * dh;
#pragma unroll
  for (int c0 = 0; c0 < KD; ++c0)
    store_acc(mine, acc[c0], 1.f, 1.f, r0, rows, c0 * 8, dh, (size_t)dh, g, t);
  if (t == 0) {
    const size_t m_at = split * plane + row_at, l_at = (splits + split) * plane + row_at;
    if (row0) part_ml[m_at] = m0, part_ml[l_at] = l0;
    if (row1) part_ml[m_at + 8] = m1, part_ml[l_at + 8] = l1;
  }
}

// The splits' partial outputs joined in split order, a thread per (b, h,
// row, column): o = sum_s part_s 2^(m_s - m) / sum_s l_s 2^(m_s - m) with
// m the largest m_s; column 0's thread writes the row's statistics.
template <typename T>
__global__ void __launch_bounds__(256)
    attention_fwd_combine(const float* __restrict__ part, const float* __restrict__ part_ml,
                          T* __restrict__ o, float* __restrict__ stats, int bh_count, int sq,
                          int heads, int dh, int splits) {
  const size_t plane = (size_t)bh_count * sq;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane * dh) return;
  const size_t at = idx / dh;  // bh * sq + row
  const int d = (int)(idx - at * dh);
  float m = __int_as_float(0xff800000);
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_ml[s * plane + at]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = exp2_neg(part_ml[s * plane + at] - m);
    l = fmaf(part_ml[(splits + s) * plane + at], w, l);
    acc = fmaf(part[(s * plane + at) * dh + d], w, acc);
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  const int bh = (int)(at / sq), row = (int)(at - (size_t)bh * sq);
  const int b = bh / heads, h = bh % heads;
  store_float(o + ((size_t)b * sq + row) * heads * dh + (size_t)h * dh + d, acc * inv);
  if (d == 0) stats[at] = m, stats[plane + at] = inv;
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

struct Args {
  const void *q, *k, *v;
  void* o;
  float* stats;    // the streaming kernel's [2, B*H, Sq] row statistics
  float* scratch;  // its partials with more than one split
  int b, sq, skv, heads, dh;
  float scale;
  int warps, splits, per_split;  // the streaming kernel's plan
};

template <typename T, int NT, int KD>
cudaError_t launch_mma(const Args& a, int device, cudaStream_t stream) {
  auto kernel = attention_fwd_mma<T, NT, KD>;
  cudaError_t err = allow_dynamic_smem(kernel, device);
  if (err != cudaSuccess) return err;
  bool vec = (a.dh * sizeof(T)) % 16 == 0;
  for (const void* p : {a.q, a.k, a.v}) vec = vec && ((uintptr_t)p % 16 == 0);
  const int warps = warps_for((a.sq + 15) / 16, kMaxWarps);
  kernel<<<a.b * a.heads, warps * 32, mma_smem_bytes(a.sq, a.skv, KD * 8), stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.sq, a.skv, a.heads, a.dh, a.scale,
      (int)vec);
  return cudaGetLastError();
}

template <typename T, int KD>
cudaError_t launch_stream(const Args& a, int device, cudaStream_t stream) {
  const int key_tiles = (a.skv + kStreamKeys - 1) / kStreamKeys;
  if (!plan_takes(a.warps, a.splits, a.per_split, key_tiles) || a.stats == nullptr ||
      (a.splits > 1 && a.scratch == nullptr))
    return cudaErrorInvalidValue;
  auto kernel = attention_fwd_stream<T, KD>;
  cudaError_t err = allow_dynamic_smem(kernel, device);
  if (err != cudaSuccess) return err;
  bool vec = (a.dh * sizeof(T)) % 16 == 0;
  for (const void* p : {a.q, a.k, a.v}) vec = vec && ((uintptr_t)p % 16 == 0);
  const int q_tiles = (a.sq + 16 * a.warps - 1) / (16 * a.warps);
  const size_t plane = (size_t)a.b * a.heads * a.sq;
  float* part_ml = a.splits > 1 ? a.scratch + (size_t)a.splits * plane * a.dh : nullptr;
  kernel<<<a.b * a.heads * q_tiles * a.splits, a.warps * 32, fwd_stream_smem<T, KD>(a.warps),
           stream>>>((const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.stats, a.scratch,
                     part_ml, a.sq, a.skv, a.heads, a.dh, a.scale, a.splits, a.per_split,
                     (int)vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const size_t total = plane * a.dh;
  attention_fwd_combine<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      a.scratch, part_ml, (T*)a.o, a.stats, a.b * a.heads, a.sq, a.heads, a.dh, a.splits);
  return cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int variant, int device, void* stream_ptr, int* ran) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  variant = pick(variant, a.sq, a.skv, a.dh);
  *ran = variant;
  if (variant == kStream) {
    if (!stream_takes(a.dh)) return (int)cudaErrorInvalidValue;
    switch (padded_head_dim(a.dh)) {
      case 16:
        return (int)launch_stream<T, 2>(a, device, stream);
      case 32:
        return (int)launch_stream<T, 4>(a, device, stream);
      default:
        return (int)launch_stream<T, 8>(a, device, stream);
    }
  }
  if (variant == kGeneral) {
    auto kernel = attention_fwd_general<T>;
    err = allow_dynamic_smem(kernel, device);
    if (err != cudaSuccess) return (int)err;
    kernel<<<a.b * a.heads, kGeneralWarps * 32, general_smem_bytes(a.skv, a.dh), stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.sq, a.skv, a.heads, a.dh,
        a.scale);
    return (int)cudaGetLastError();
  }
  if (variant != kMma || !mma_takes(a.sq, a.skv, a.dh)) return (int)cudaErrorInvalidValue;
  const bool few_keys = a.skv <= 96;
  switch (padded_head_dim(a.dh)) {
    case 16:
      return (int)(few_keys ? launch_mma<T, 12, 2>(a, device, stream)
                            : launch_mma<T, kMaxKeyTiles, 2>(a, device, stream));
    case 32:
      return (int)(few_keys ? launch_mma<T, 12, 4>(a, device, stream)
                            : launch_mma<T, kMaxKeyTiles, 4>(a, device, stream));
    default:
      return (int)(few_keys ? launch_mma<T, 12, 8>(a, device, stream)
                            : launch_mma<T, kMaxKeyTiles, 8>(a, device, stream));
  }
}

}  // namespace

extern "C" {

// Shared memory a block needs at this shape with `variant` (-1: the one the
// launch would pick, 0: the tensor-core kernel, 1: the general kernel), or
// -1 where that variant does not take the shape, and for the streaming
// kernel, whose shared memory follows its plan
// (attention_fwd_stream_smem_bytes).  Above the block's limit means that
// nothing takes it.
long long attention_fwd_smem_bytes(int sq, int skv, int dh, int variant) {
  variant = pick(variant, sq, skv, dh);
  if (variant == kGeneral) return (long long)general_smem_bytes(skv, dh);
  if (variant != kMma || !mma_takes(sq, skv, dh)) return -1;
  return (long long)mma_smem_bytes(sq, skv, padded_head_dim(dh));
}

// Shared memory of a streaming block of `warps` warps at head_dim `dh`, fp32
// (bf16 = 0) or bf16 tensors; -1 where the streaming kernel does not take dh.
long long attention_fwd_stream_smem_bytes(int warps, int dh, int bf16) {
  if (!stream_takes(dh)) return -1;
  const int kd = padded_head_dim(dh) / 8;
  if (bf16)
    return (long long)(kd == 2   ? fwd_stream_smem<__nv_bfloat16, 2>(warps)
                       : kd == 4 ? fwd_stream_smem<__nv_bfloat16, 4>(warps)
                                 : fwd_stream_smem<__nv_bfloat16, 8>(warps));
  return (long long)(kd == 2   ? fwd_stream_smem<float, 2>(warps)
                     : kd == 4 ? fwd_stream_smem<float, 4>(warps)
                               : fwd_stream_smem<float, 8>(warps));
}

// 0: the tensor-core kernel runs this shape, 1: the general kernel, 2: the
// streaming kernel.
int attention_fwd_variant(int sq, int skv, int dh) { return pick(kAuto, sq, skv, dh); }

const char* attention_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream`; allocate nothing, do not synchronise.  Return the
// cudaError_t of the launch (0 on success) and write the variant that ran
// to `ran`.  float and bfloat16 tensors.  The streaming variant takes its
// plan (warps a block, splits of the key tiles, key tiles a split; from
// ops/attention.py::stream_plan), writes the rows' statistics to `stats`
// (fp32 [2, B*H, Sq]: max of the logits in log2 units, 1 / sum) and, with more
// than one split, its partials to `scratch` (fp32, splits * B*H*Sq * (dh +
// 2)) before a second launch joins them; the other variants read none of
// these.
int attention_fwd(const void* q, const void* k, const void* v, void* o, void* stats,
                  void* scratch, int b, int sq, int skv, int heads, int dh, float scale,
                  int variant, int warps, int splits, int per_split, int device, void* stream,
                  int* ran) {
  return launch<float>({q, k, v, o, (float*)stats, (float*)scratch, b, sq, skv, heads, dh,
                        scale, warps, splits, per_split},
                       variant, device, stream, ran);
}

int attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* stats,
                       void* scratch, int b, int sq, int skv, int heads, int dh, float scale,
                       int variant, int warps, int splits, int per_split, int device,
                       void* stream, int* ran) {
  return launch<__nv_bfloat16>({q, k, v, o, (float*)stats, (float*)scratch, b, sq, skv, heads,
                                dh, scale, warps, splits, per_split},
                               variant, device, stream, ran);
}

}  // extern "C"
