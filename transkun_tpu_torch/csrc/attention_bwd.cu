// Multi-head attention backward on Hopper (sm_90a).
//
// Replaces the TPU kernel _bwd_kernel in transkun_tpu/ops/attention_pallas.py
// (called through _bwd_call, the VJP of fused_attention).  Inputs q, k, v,
// the saved output o and the cotangent do, flat [B, S, H*dh]; per batch
// element and head:
//
//   p     = softmax((q k^T) * scale)     recomputed, [Sq, Skv]
//   delta = rowsum(do * o)               [Sq]
//   dp    = do v^T
//   dl    = p * (dp - delta)
//   dq    = (dl k) * scale,   dk = (dl^T q) * scale,   dv = p^T do
//
// The inputs are float or bfloat16 and go to fp32 as they are loaded; p,
// delta, dp, dl and every sum are fp32; dq, dk, dv are written in the input
// type.  Nothing of size [Sq, Skv] reaches device memory or shared memory.
// Accurate expf (in the streaming kernels the SFU's 2^x, exp2_neg), no
// --use_fast_math.
//
// What bounds it: by the count, operations (five products, 2.5 times the
// forward's two: at [356, 149, 256], 8 heads, fp32, 20 GFLOP against 434 MB,
// 0.302 ms at the CUDA cores' fp32 rate); at bf16, bytes.  In practice, as in
// the forward, shared-memory bandwidth, the schedulers' rate and occupancy.  The
// first version fed every FMA from two shared-memory loads, evaluated expf
// three times an element and divided per element; it measured 7.6% of the
// bound.
//
// Design (attention_bwd_mma; the building blocks are in attention_mma.cuh):
//   * One block per (b, h); q, do, k and v of that head in fp32
//     shared-memory tiles (16-byte loads, zero padding).  All products are
//     m16n8k8 TF32 `mma.sync` with the high/low split (fp32-grade).
//   * dq sums over keys, dk and dv over queries.  The block makes two
//     passes, and no output is accumulated by more than one warp: no
//     atomics, no reduction through shared memory, and the same bits on
//     every run.
//     Pass A, a warp per 16 query rows: the row of logits in registers (up
//     to 20 tiles of 8 keys), max, expf once an element, sum, one
//     reciprocal; delta from do and o; the row's max, reciprocal and delta
//     go to shared memory.  Then, a key tile at a time, dp = do v^T, dl, and
//     dq += dl k with the accumulator tile of dl as the A operand.
//     Pass B, a warp per 16 keys, streams over the queries 32 at a time:
//     logits^T = k q^T and dp^T = v do^T (keys as the rows of the tile), p
//     and dl from the stored row statistics (expf a second time; no
//     division), then dv += p^T do and dk += dl^T q, again straight from
//     the accumulators.  Nothing but eight 16 x 8 tiles is live per step.
//   * The price is seven products for five (logits and dp are formed in
//     both passes).  One pass would have to transpose p and dl between
//     lanes or through shared memory and add dk and dv up across warps; on
//     the tensor cores the two extra products cost less than that.
//   * Blocks: 5 warps at S = 149 (10 tiles, 2 a warp and pass), 6 at S = 89;
//     94,080 B of shared memory at S = 149, dh = 32, so 2 blocks an SM, and
//     168 registers a thread (__launch_bounds__(192, 2); 36 bytes of spill in
//     the 20-tile fp32 instance) so that registers allow 2 as well: 10-12
//     warps an SM; the 2848 blocks of a training batch run in 10.8 waves of
//     264.  Left to itself the compiler took 255 registers, one block an
//     SM, and twice the time.
//   * cudaFuncSetAttribute once per kernel and device.
//
// Shapes the mma kernel does not take (Skv > 160, head_dim > 64, tiles
// beyond a block's shared memory) go to attention_bwd_general, the first
// version of this kernel: fp32 FMAs, a warp per query row and then per key.
//
// Key sequences too long for the general kernel's shared memory (the 0All
// and FT branches: 13261 keys a segment at flagship width) go to the
// streaming kernels, which take any Sq and Skv at head_dim <= 64 and keep
// nothing of size [Sq, Skv] anywhere (building blocks in
// attention_stream.cuh: the ring of `cp.async` tiles, bf16 `m16n8k16` with
// the fp32 operand split high/low at bf16, TF32 x3 at fp32).  They take the
// forward's row statistics (max of the logits in log2 units and 1 / sum,
// [2, B*H, Sq]), so each pass sweeps the other side once: 2 exponentials
// and 7 products an element across the two passes.  Two launches on the
// stream, and a third with split keys; no atomics, so the same bits on
// every run:
//   * Pass A (attention_bwd_stream_rows), a block per (b, h, query tile,
//     split of the keys) as the forward's plan: q and do fragments in
//     registers, delta = rowsum(do o) from the block's rows, then a key tile
//     at a time logits and dp = do v^T, p = 2^(logit - max) / sum, dl = p
//     (dp - delta) and dq += dl k.  Split 0 writes each row's delta for
//     pass B.  With split keys each block writes its part of dq in fp32 and
//     attention_bwd_combine adds them in split order.
//   * Pass B (attention_bwd_stream_keys), a block per (b, h, 64 keys), 16
//     keys a warp with their k and v fragments in registers, streams the
//     query tiles (q, do and their rows' max, 1 / sum and delta through the
//     ring) and accumulates dk += dl^T q and dv += p^T do.
//   * Each streamed tile's products go into fresh accumulators, added to the
//     running sums by the CUDA cores (the tensor cores' fp32 accumulation
//     does not round to nearest).
//   * What bounds them: as the forward, the elementwise work around the
//     exponentials at bf16 (pass B's is the larger: two splits and three
//     statistics an element) and the TF32 products at fp32.

#include "attention_stream.cuh"

namespace {

// ---------------------------------------------------------------------------
// tensor-core kernel: Skv <= 8 * NT, head_dim <= 8 * KD
// ---------------------------------------------------------------------------

// Blocks of at most 6 warps, 2 to an SM (what shared memory allows at S =
// 149): 168 registers a thread.  Device time at [356, 149, 256] fp32 on an
// H100 SXM at 700 W: 1.00 ms so, 1.29 ms with 5 warps and 128 registers
// (spills), 2.1 ms with 8 warps and 255 registers (1 block an SM).
constexpr int kMaxWarps = 6, kMinBlocks = 2;

__host__ __device__ constexpr size_t mma_smem_bytes(int sq, int skv, int dhp) {
  const int q_rows = ceil_to(sq, 8 * kGroup), k_rows = ceil_to(skv, 8 * kGroup);
  return ((size_t)2 * (q_rows + k_rows) * (dhp + kPitchPad) + (size_t)3 * q_rows) *
         sizeof(float);
}

template <typename T, int NT, int KD>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
    attention_bwd_mma(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ o,
                      const T* __restrict__ d_o, T* __restrict__ dq,
                      T* __restrict__ dk, T* __restrict__ dv, int sq, int skv,
                      int heads, int dh, float scale, int vec) {
  constexpr bool kExact = kExactInTf32<T>;
  constexpr int kDhp = KD * 8, kPitch = kDhp + kPitchPad;
  extern __shared__ __align__(16) float smem[];
  const int q_rows = ceil_to(sq, 8 * kGroup), k_rows = ceil_to(skv, 8 * kGroup);
  float* qs = smem;                    // [q_rows][kPitch]
  float* dos = qs + q_rows * kPitch;   // [q_rows][kPitch]
  float* ks = dos + q_rows * kPitch;   // [k_rows][kPitch]
  float* vs = ks + k_rows * kPitch;    // [k_rows][kPitch]
  float* row_max = vs + k_rows * kPitch;  // [q_rows] max of the scaled logits
  float* row_inv = row_max + q_rows;      // [q_rows] 1 / sum exp
  float* row_delta = row_inv + q_rows;    // [q_rows]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t ld = (size_t)heads * dh;
  const size_t q_at = (size_t)b * sq * ld + h * dh;
  const size_t k_at = (size_t)b * skv * ld + h * dh;

  load_tile(qs, q + q_at, sq, q_rows, dh, kDhp, kPitch, ld, vec);
  load_tile(dos, d_o + q_at, sq, q_rows, dh, kDhp, kPitch, ld, vec);
  load_tile(ks, k + k_at, skv, k_rows, dh, kDhp, kPitch, ld, vec);
  load_tile(vs, v + k_at, skv, k_rows, dh, kDhp, kPitch, ld, vec);
  __syncthreads();

  const float neg_inf = __int_as_float(0xff800000);

  // Pass A: a warp per 16 query rows -> row statistics and dq.
  for (int r0 = warp * 16; r0 < sq; r0 += warps * 16) {
    // p of rows r0+g (s[j][0..1]) and r0+g+8 (s[j][2..3]), keys 8j+2t, 8j+2t+1
    float s[NT][4];
    float m0 = neg_inf, m1 = neg_inf;
    {
      AFrag qa[KD];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        qa[kk] = a_from_tile<kExact>(qs + r0 * kPitch, kPitch, kk * 8, g, t);
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
          s[j][c] = ((j + 1) * 8 <= skv || j * 8 + 2 * t + (c & 1) < skv)
                        ? s[j][c] * scale
                        : neg_inf;
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
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
    // every row has a key, so its sum is at least exp(0)
    const float inv0 = sum0 > 0.f ? 1.f / sum0 : 0.f;
    const float inv1 = sum1 > 0.f ? 1.f / sum1 : 0.f;

    float delta0 = 0.f, delta1 = 0.f;
    for (int d = t; d < dh; d += 4) {
      if (r0 + g < sq)
        delta0 = fmaf(dos[(r0 + g) * kPitch + d],
                      as_float(o[q_at + (size_t)(r0 + g) * ld + d]), delta0);
      if (r0 + g + 8 < sq)
        delta1 = fmaf(dos[(r0 + g + 8) * kPitch + d],
                      as_float(o[q_at + (size_t)(r0 + g + 8) * ld + d]), delta1);
    }
    delta0 = quad_sum(delta0);
    delta1 = quad_sum(delta1);
    if (t == 0) {
      row_max[r0 + g] = m0;
      row_inv[r0 + g] = inv0;
      row_delta[r0 + g] = delta0;
      row_max[r0 + g + 8] = m1;
      row_inv[r0 + g + 8] = inv1;
      row_delta[r0 + g + 8] = delta1;
    }

    AFrag doa[KD];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      doa[kk] = a_from_tile<kExact>(dos + r0 * kPitch, kPitch, kk * 8, g, t);
    float acc[KD][4];
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; j += kGroup) {
      if (j * 8 < skv) {
        float dl[kGroup][4];  // dp first
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) dl[i][c] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          mma_rows_as_columns<kExact, kExact, kGroup>(dl, doa[kk], vs + j * 8 * kPitch,
                                                      kPitch, kk * 8, g, t);
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          // keys past Skv have p = 0 and v = 0, so dl = 0 there
          dl[i][0] = s[j + i][0] * inv0 * (dl[i][0] - delta0);
          dl[i][1] = s[j + i][1] * inv0 * (dl[i][1] - delta0);
          dl[i][2] = s[j + i][2] * inv1 * (dl[i][2] - delta1);
          dl[i][3] = s[j + i][3] * inv1 * (dl[i][3] - delta1);
          const AFrag dla = a_from_acc(dl[i]);
          mma_rows_summed<kExact, KD>(acc, dla, ks + (j + i) * 8 * kPitch, kPitch, g, t);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < KD; ++n)
      store_acc(dq + q_at, acc[n], scale, scale, r0, sq, n * 8, dh, ld, g, t);
  }
  __syncthreads();

  // Pass B: a warp per 16 keys, the queries 32 at a time -> dk and dv.
  for (int c0 = warp * 16; c0 < skv; c0 += warps * 16) {
    AFrag ka[KD], va[KD];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      ka[kk] = a_from_tile<kExact>(ks + c0 * kPitch, kPitch, kk * 8, g, t);
      va[kk] = a_from_tile<kExact>(vs + c0 * kPitch, kPitch, kk * 8, g, t);
    }
    float acc_k[KD][4], acc_v[KD][4];
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc_k[n][c] = acc_v[n][c] = 0.f;
    const bool key0 = c0 + g < skv, key1 = c0 + g + 8 < skv;

    for (int i0 = 0; i0 < sq; i0 += 8 * kGroup) {
      // keys c0+g (x[0..1]) and c0+g+8 (x[2..3]); tile i: queries
      // i0+8i+2t and i0+8i+2t+1
      float pt[kGroup][4], dlt[kGroup][4];
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) pt[i][c] = dlt[i][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        mma_rows_as_columns<kExact, kExact, kGroup>(pt, ka[kk], qs + i0 * kPitch, kPitch,
                                                    kk * 8, g, t);
        mma_rows_as_columns<kExact, kExact, kGroup>(dlt, va[kk], dos + i0 * kPitch, kPitch,
                                                    kk * 8, g, t);
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = i0 + 8 * i + 2 * t + (c & 1);
          const bool there = r < sq && ((c >> 1) ? key1 : key0);
          pt[i][c] = there ? expf(pt[i][c] * scale - row_max[r]) * row_inv[r] : 0.f;
          dlt[i][c] = there ? pt[i][c] * (dlt[i][c] - row_delta[r]) : 0.f;
        }
        const AFrag pa = a_from_acc(pt[i]), dla = a_from_acc(dlt[i]);
        mma_rows_summed<kExact, KD>(acc_v, pa, dos + (i0 + 8 * i) * kPitch, kPitch, g, t);
        mma_rows_summed<kExact, KD>(acc_k, dla, qs + (i0 + 8 * i) * kPitch, kPitch, g, t);
      }
    }
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      store_acc(dk + k_at, acc_k[n], scale, scale, c0, skv, n * 8, dh, ld, g, t);
      store_acc(dv + k_at, acc_v[n], 1.f, 1.f, c0, skv, n * 8, dh, ld, g, t);
    }
  }
}

// ---------------------------------------------------------------------------
// general kernel: any Sq, Skv and head_dim whose tiles fit shared memory
// ---------------------------------------------------------------------------

constexpr int kGeneralWarps = 16;

__host__ __device__ constexpr int row_stride(int dh) { return dh | 1; }

__host__ __device__ constexpr size_t general_smem_bytes(int sq, int skv, int dh) {
  const int longest = sq > skv ? sq : skv;
  return ((size_t)2 * (sq + skv) * row_stride(dh) + (size_t)3 * sq +
          (size_t)2 * kGeneralWarps * longest) * sizeof(float);
}

__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float acc = 0.f;
  for (int d = 0; d < n; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// One block per (b, h) with that head's q * scale, k, v and do in shared
// memory on an odd row stride.  Pass A, a warp per query row: logits (a lane
// per key), max and sum by shuffles, delta, dl in a per-warp buffer, dq with
// a lane per column.  Pass B, a warp per key: the same logits against every
// query row, p and dl from the kept statistics, dk and dv with a lane per
// column.  No output is accumulated by more than one warp.
template <typename T>
__global__ void __launch_bounds__(kGeneralWarps * 32)
    attention_bwd_general(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ o,
                          const T* __restrict__ d_o, T* __restrict__ dq,
                          T* __restrict__ dk, T* __restrict__ dv, int sq, int skv,
                          int heads, int dh, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(dh);
  const int longest = sq > skv ? sq : skv;
  float* qs = smem;                             // [sq][ld], scaled
  float* dos = qs + (size_t)sq * ld;            // [sq][ld]
  float* ks = dos + (size_t)sq * ld;            // [skv][ld]
  float* vs = ks + (size_t)skv * ld;            // [skv][ld]
  float* row_max = vs + (size_t)skv * ld;       // [sq]
  float* row_sum = row_max + sq;                // [sq]
  float* row_delta = row_sum + sq;              // [sq]
  float* buf_a = row_delta + sq;                // [kGeneralWarps][longest]
  float* buf_b = buf_a + (size_t)kGeneralWarps * longest;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int d_model = heads * dh;
  const size_t q_at = (size_t)b * sq * d_model + h * dh;
  const size_t k_at = (size_t)b * skv * d_model + h * dh;

  for (int idx = threadIdx.x; idx < sq * dh; idx += blockDim.x) {
    const int r = idx / dh, d = idx - r * dh;
    qs[r * ld + d] = as_float(q[q_at + (size_t)r * d_model + d]) * scale;
    dos[r * ld + d] = as_float(d_o[q_at + (size_t)r * d_model + d]);
  }
  for (int idx = threadIdx.x; idx < skv * dh; idx += blockDim.x) {
    const int j = idx / dh, d = idx - j * dh;
    ks[j * ld + d] = as_float(k[k_at + (size_t)j * d_model + d]);
    vs[j * ld + d] = as_float(v[k_at + (size_t)j * d_model + d]);
  }
  __syncthreads();

  float* mine_a = buf_a + (size_t)warp * longest;
  float* mine_b = buf_b + (size_t)warp * longest;

  // Pass A: a warp per query row -> row statistics and dq.
  for (int r = warp; r < sq; r += kGeneralWarps) {
    const float* qr = qs + r * ld;
    const float* dor = dos + r * ld;

    float m = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < skv; j += 32) {
      const float l = dot(qr, ks + j * ld, dh);
      mine_a[j] = l;
      m = fmaxf(m, l);
    }
    float s = 0.f;
    float delta = 0.f;
    for (int d = lane; d < dh; d += 32)
      delta = fmaf(dor[d], as_float(o[q_at + (size_t)r * d_model + d]), delta);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    for (int j = lane; j < skv; j += 32) s += expf(mine_a[j] - m);
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      delta += __shfl_xor_sync(0xffffffffu, delta, off);
    }
    if (lane == 0) {
      row_max[r] = m;
      row_sum[r] = s;
      row_delta[r] = delta;
    }
    for (int j = lane; j < skv; j += 32) {
      const float pn = expf(mine_a[j] - m) / s;
      mine_a[j] = pn * (dot(dor, vs + j * ld, dh) - delta);  // dl[r][j]
    }
    __syncwarp();
    for (int d = lane; d < dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < skv; ++j) acc = fmaf(mine_a[j], ks[j * ld + d], acc);
      store_float(dq + q_at + (size_t)r * d_model + d, acc * scale);
    }
    __syncwarp();  // the next row overwrites mine_a
  }
  __syncthreads();

  // Pass B: a warp per key -> dk and dv.
  for (int j = warp; j < skv; j += kGeneralWarps) {
    const float* kj = ks + j * ld;
    const float* vj = vs + j * ld;
    for (int r = lane; r < sq; r += 32) {
      const float l = dot(qs + r * ld, kj, dh);
      const float pn = expf(l - row_max[r]) / row_sum[r];
      mine_b[r] = pn;
      mine_a[r] = pn * (dot(dos + r * ld, vj, dh) - row_delta[r]);
    }
    __syncwarp();
    for (int d = lane; d < dh; d += 32) {
      float acc_k = 0.f, acc_v = 0.f;
      for (int r = 0; r < sq; ++r) {
        acc_k = fmaf(mine_a[r], qs[r * ld + d], acc_k);
        acc_v = fmaf(mine_b[r], dos[r * ld + d], acc_v);
      }
      store_float(dk + k_at + (size_t)j * d_model + d, acc_k);
      store_float(dv + k_at + (size_t)j * d_model + d, acc_v);
    }
    __syncwarp();  // the next key overwrites mine_a and mine_b
  }
}

// ---------------------------------------------------------------------------
// streaming kernels: any Sq and Skv, head_dim <= 64 (building blocks in
// attention_stream.cuh)
// ---------------------------------------------------------------------------

// Pass A: a block per (b, h, tile of 16 * warps query rows, split of the key
// tiles) -> dq, from the forward's row statistics (`stats` [2, B*H, Sq]:
// max of the logits in log2 units, 1 / sum); split 0 writes each row's delta =
// rowsum(do o) to `delta` [B*H, Sq] for pass B.  With one split it writes
// dq; with more, its part of dq / scale to `dq_part` [splits, B*H, Sq, dh],
// which attention_bwd_combine adds up.
template <typename T, int KD>
__global__ void __launch_bounds__(kStreamThreads<T>, KD <= 4 ? 2 : 1)
    attention_bwd_stream_rows(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ o,
                              const T* __restrict__ d_o, T* __restrict__ dq,
                              const float* __restrict__ stats, float* __restrict__ delta,
                              float* __restrict__ dq_part, int sq, int skv, int heads, int dh,
                              float scale, int splits, int per_split, int vec) {
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
  const int n = range.end - range.first;
  const size_t ld = (size_t)heads * dh;
  const int q0 = qt * block_rows, rows = min(block_rows, sq - q0);
  const size_t q_at = ((size_t)b * sq + q0) * ld + h * dh;
  const size_t k_at = ((size_t)b * skv + (size_t)range.first * kStreamKeys) * ld + h * dh;
  const int r0 = warp * 16;
  const bool active = r0 < rows;
  T* qs = reinterpret_cast<T*>(smem_raw);  // [block_rows][kPitch]
  T* dos = qs + block_rows * G::kPitch;    // [block_rows][kPitch]
  T* ring = dos + block_rows * G::kPitch;  // kStages x (k tile, v tile)

  auto keys_of = [&](int j) { return min(kStreamKeys, skv - (range.first + j) * kStreamKeys); };
  auto load_kv = [&](int j) {
    T* ks = ring + (j % G::kStages) * 2 * G::kTile;
    const size_t at = k_at + (size_t)j * kStreamKeys * ld;
    load_rows<T, KD>(ks, k + at, keys_of(j), kStreamKeys, ld, dh, vec);
    load_rows<T, KD>(ks + G::kTile, v + at, keys_of(j), kStreamKeys, ld, dh, vec);
  };

  load_rows<T, KD>(qs, q + q_at, rows, block_rows, ld, dh, vec);
  load_rows<T, KD>(dos, d_o + q_at, rows, block_rows, ld, dh, vec);
  commit_copies();
#pragma unroll
  for (int j = 0; j < G::kStages - 1; ++j) {
    if (j < n) load_kv(j);
    commit_copies();
  }
  wait_copies<G::kStages - 1>();
  __syncthreads();
  typename M::Frags qa, doa;
  M::a_frags(qa, qs + r0 * G::kPitch, lane);
  M::a_frags(doa, dos + r0 * G::kPitch, lane);

  // rows r0+g (index 0) and r0+g+8 (index 1): the forward's statistics and delta
  const size_t plane = (size_t)(gridDim.x / (splits * q_tiles)) * sq;
  const size_t row_at = (size_t)bh * sq + q0 + r0 + g;
  const bool row0 = active && r0 + g < rows, row1 = active && r0 + g + 8 < rows;
  const float m0 = row0 ? stats[row_at] : 0.f, m1 = row1 ? stats[row_at + 8] : 0.f;
  const float inv0 = row0 ? stats[plane + row_at] : 0.f;
  const float inv1 = row1 ? stats[plane + row_at + 8] : 0.f;
  float delta0 = 0.f, delta1 = 0.f;
  for (int d = t; d < dh; d += 4) {
    if (row0)
      delta0 = fmaf(as_float(dos[(r0 + g) * G::kPitch + d]),
                    as_float(o[q_at + (size_t)(r0 + g) * ld + d]), delta0);
    if (row1)
      delta1 = fmaf(as_float(dos[(r0 + g + 8) * G::kPitch + d]),
                    as_float(o[q_at + (size_t)(r0 + g + 8) * ld + d]), delta1);
  }
  delta0 = quad_sum(delta0);
  delta1 = quad_sum(delta1);
  if (split == 0 && t == 0) {
    if (row0) delta[row_at] = delta0;
    if (row1) delta[row_at + 8] = delta1;
  }

  float acc[KD][4] = {};
  for (int j = 0; j < n; ++j) {
    wait_copies<G::kStages - 2>();
    __syncthreads();
    if (j + G::kStages - 1 < n) load_kv(j + G::kStages - 1);
    commit_copies();
    if (!active) continue;
    const T* ks = ring + (j % G::kStages) * 2 * G::kTile;
    const T* vs = ks + G::kTile;
    const int keys = keys_of(j);
    float part[KD][4] = {};  // this tile's dl k, added to the running sum
#pragma unroll
    for (int k0 = 0; k0 < kStreamKeys; k0 += 8 * kGroup) {
      if (k0 >= keys) break;
      float s[kGroup][4] = {}, dl[kGroup][4] = {};  // dl holds dp first
      M::rows_product(s, qa, ks + k0 * G::kPitch, lane);
      M::rows_product(dl, doa, vs + k0 * G::kPitch, lane);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        dl[i][0] = exp2_neg(fmaf(s[i][0], log2_scale, -m0)) * inv0 * (dl[i][0] - delta0);
        dl[i][1] = exp2_neg(fmaf(s[i][1], log2_scale, -m0)) * inv0 * (dl[i][1] - delta0);
        dl[i][2] = exp2_neg(fmaf(s[i][2], log2_scale, -m1)) * inv1 * (dl[i][2] - delta1);
        dl[i][3] = exp2_neg(fmaf(s[i][3], log2_scale, -m1)) * inv1 * (dl[i][3] - delta1);
      }
      // the last tile of the keys: dl = 0 past its last key, whose logit 0
      // gives p = 2^(-max) / sum, infinite where the row's max is below -128
      if (keys < kStreamKeys) {
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (k0 + i * 8 + 2 * t + (c & 1) >= keys) dl[i][c] = 0.f;
      }
      M::summed_product(part, dl, ks + k0 * G::kPitch, lane);
    }
#pragma unroll
    for (int c0 = 0; c0 < KD; ++c0)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c0][c] += part[c0][c];
  }
  if (!active) return;
  if (splits == 1) {
#pragma unroll
    for (int c0 = 0; c0 < KD; ++c0)
      store_acc(dq + q_at, acc[c0], scale, scale, r0, rows, c0 * 8, dh, ld, g, t);
    return;
  }
  float* mine = dq_part + ((size_t)split * plane + (size_t)bh * sq + q0) * dh;
#pragma unroll
  for (int c0 = 0; c0 < KD; ++c0)
    store_acc(mine, acc[c0], 1.f, 1.f, r0, rows, c0 * 8, dh, (size_t)dh, g, t);
}

// Pass B: a block per (b, h, tile of 64 keys), 16 keys a warp with their k
// and v fragments in registers -> dk and dv, streaming the query tiles (q,
// do and the rows' max, 1 / sum and delta) through the ring.
template <typename T, int KD>
__global__ void __launch_bounds__(kKeyWarps * 32, sizeof(T) == 2 && KD <= 4 ? 3 : 2)
    attention_bwd_stream_keys(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ d_o,
                              const float* __restrict__ stats, const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, int sq, int skv, int heads,
                              int dh, float scale, int vec) {
  using G = StreamTile<T, KD>;
  using M = StreamMath<T, KD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const float log2_scale = scale * kLog2e;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k_tiles = (skv + kStreamKeys - 1) / kStreamKeys;
  const int bh = blockIdx.x / k_tiles, c0 = (blockIdx.x % k_tiles) * kStreamKeys;
  const int b = bh / heads, h = bh % heads;
  const size_t plane = (size_t)(gridDim.x / k_tiles) * sq;
  const size_t ld = (size_t)heads * dh;
  const size_t q_at = (size_t)b * sq * ld + h * dh;
  const size_t k_at = ((size_t)b * skv + c0) * ld + h * dh;  // the block's key 0
  const int keys = min(kStreamKeys, skv - c0);
  const int w0 = warp * 16;  // the warp's keys in the block's tile
  const bool active = w0 < keys;
  const int n = (sq + kStreamKeys - 1) / kStreamKeys;
  T* kst = reinterpret_cast<T*>(smem_raw);  // [64][kPitch]
  T* vst = kst + G::kTile;                  // [64][kPitch]
  T* ring = vst + G::kTile;                 // kStages x (q tile, do tile)
  float* values = reinterpret_cast<float*>(ring + G::kStages * 2 * G::kTile);  // kStages x 3 x 64

  auto load_qd = [&](int i) {  // query tile i, its rows' max, 1 / sum and delta
    const int stage = i % G::kStages, rows = min(kStreamKeys, sq - i * kStreamKeys);
    T* qt = ring + stage * 2 * G::kTile;
    const size_t at = q_at + (size_t)i * kStreamKeys * ld;
    load_rows<T, KD>(qt, q + at, rows, kStreamKeys, ld, dh, vec);
    load_rows<T, KD>(qt + G::kTile, d_o + at, rows, kStreamKeys, ld, dh, vec);
    float* mine = values + stage * 3 * kStreamKeys;
    const size_t row_at = (size_t)bh * sq + (size_t)i * kStreamKeys;
    load_row_values(mine, stats + row_at, rows);
    load_row_values(mine + kStreamKeys, stats + plane + row_at, rows);
    load_row_values(mine + 2 * kStreamKeys, delta + row_at, rows);
  };

  load_rows<T, KD>(kst, k + k_at, keys, kStreamKeys, ld, dh, vec);
  load_rows<T, KD>(vst, v + k_at, keys, kStreamKeys, ld, dh, vec);
  commit_copies();
#pragma unroll
  for (int i = 0; i < G::kStages - 1; ++i) {
    if (i < n) load_qd(i);
    commit_copies();
  }
  wait_copies<G::kStages - 1>();
  __syncthreads();
  typename M::Frags ka, va;
  M::a_frags(ka, kst + w0 * G::kPitch, lane);
  M::a_frags(va, vst + w0 * G::kPitch, lane);

  float acc_k[KD][4] = {}, acc_v[KD][4] = {};
  for (int i = 0; i < n; ++i) {
    wait_copies<G::kStages - 2>();
    __syncthreads();
    if (i + G::kStages - 1 < n) load_qd(i + G::kStages - 1);
    commit_copies();
    if (!active) continue;
    const int stage = i % G::kStages, rows = min(kStreamKeys, sq - i * kStreamKeys);
    const T* qt = ring + stage * 2 * G::kTile;
    const T* dot = qt + G::kTile;
    const float* row_max = values + stage * 3 * kStreamKeys;
    const float* row_inv = row_max + kStreamKeys;
    const float* row_delta = row_inv + kStreamKeys;
    float part_k[KD][4] = {}, part_v[KD][4] = {};  // this tile's dl^T q and p^T do
#pragma unroll
    for (int r0 = 0; r0 < kStreamKeys; r0 += 8 * kGroup) {
      if (r0 >= rows) break;
      // keys w0+g (x[0..1]) and w0+g+8 (x[2..3]); tile i: query rows
      // r0+8i+2t and r0+8i+2t+1 of the streamed tile.  Rows past Sq have
      // zero statistics, so p = 0 there.  A key past Skv (k = v = 0) may
      // get p = inf, but only in its own rows of dk and dv, never stored.
      float pt[kGroup][4] = {}, dlt[kGroup][4] = {};
      M::rows_product(pt, ka, qt + r0 * G::kPitch, lane);
      M::rows_product(dlt, va, dot + r0 * G::kPitch, lane);
#pragma unroll
      for (int ii = 0; ii < kGroup; ++ii) {
        const int r = r0 + ii * 8 + 2 * t;  // this thread's columns r and r+1
        const float2 m = *reinterpret_cast<const float2*>(row_max + r);
        const float2 inv = *reinterpret_cast<const float2*>(row_inv + r);
        const float2 delta = *reinterpret_cast<const float2*>(row_delta + r);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool odd = c & 1;
          pt[ii][c] = exp2_neg(fmaf(pt[ii][c], log2_scale, -(odd ? m.y : m.x))) * (odd ? inv.y : inv.x);
          dlt[ii][c] = pt[ii][c] * (dlt[ii][c] - (odd ? delta.y : delta.x));
        }
      }
      M::summed_product(part_v, pt, dot + r0 * G::kPitch, lane);
      M::summed_product(part_k, dlt, qt + r0 * G::kPitch, lane);
    }
#pragma unroll
    for (int n0 = 0; n0 < KD; ++n0)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc_k[n0][c] += part_k[n0][c];
        acc_v[n0][c] += part_v[n0][c];
      }
  }
  if (!active) return;
#pragma unroll
  for (int n0 = 0; n0 < KD; ++n0) {
    store_acc(dk + k_at, acc_k[n0], scale, scale, w0, keys, n0 * 8, dh, ld, g, t);
    store_acc(dv + k_at, acc_v[n0], 1.f, 1.f, w0, keys, n0 * 8, dh, ld, g, t);
  }
}

// The splits' parts of dq added in split order, a thread per (b, h, row,
// column), times scale.
template <typename T>
__global__ void __launch_bounds__(256)
    attention_bwd_combine(const float* __restrict__ dq_part, T* __restrict__ dq, int bh_count,
                          int sq, int heads, int dh, int splits, float scale) {
  const size_t plane = (size_t)bh_count * sq;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane * dh) return;
  const size_t at = idx / dh;  // bh * sq + row
  const int d = (int)(idx - at * dh);
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += dq_part[(s * plane + at) * dh + d];
  const int bh = (int)(at / sq), row = (int)(at - (size_t)bh * sq);
  const int b = bh / heads, h = bh % heads;
  store_float(dq + ((size_t)b * sq + row) * heads * dh + (size_t)h * dh + d, acc * scale);
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
// where it takes the shape, the streaming ones for any other head_dim up to
// 64 (2.5-3.1x faster than the general one at fp32 at 200 and 320 keys on an H100,
// `scripts/profile_torch_attention.py --only-variants`), and the general
// one for a wider head_dim.  Where its tiles do not fit the general
// kernel's shared memory, its size exceeds the limit and makes the caller
// refuse the shape.
int pick(int variant, int sq, int skv, int dh) {
  if (variant != kAuto) return variant;
  if (mma_takes(sq, skv, dh)) return kMma;
  return stream_takes(dh) ? kStream : kGeneral;
}

struct Args {
  const void *q, *k, *v, *o, *d_o;
  void *dq, *dk, *dv;
  const float* stats;  // the streaming kernels' [2, B*H, Sq], from the forward
  float* scratch;      // and their delta [B*H, Sq], then dq's partials
  int b, sq, skv, heads, dh;
  float scale;
  int warps, splits, per_split;  // the streaming kernels' plan
};

template <typename T, int KD>
cudaError_t launch_stream(const Args& a, int device, cudaStream_t stream) {
  const int key_tiles = (a.skv + kStreamKeys - 1) / kStreamKeys;
  if (!plan_takes(a.warps, a.splits, a.per_split, key_tiles) || a.stats == nullptr ||
      a.scratch == nullptr)
    return cudaErrorInvalidValue;
  auto rows_kernel = attention_bwd_stream_rows<T, KD>;
  auto keys_kernel = attention_bwd_stream_keys<T, KD>;
  cudaError_t err = allow_dynamic_smem(rows_kernel, device);
  if (err == cudaSuccess) err = allow_dynamic_smem(keys_kernel, device);
  if (err != cudaSuccess) return err;
  bool vec = (a.dh * sizeof(T)) % 16 == 0;
  for (const void* p : {a.q, a.k, a.v, a.d_o}) vec = vec && ((uintptr_t)p % 16 == 0);
  const size_t plane = (size_t)a.b * a.heads * a.sq;
  float* delta = a.scratch;
  float* dq_part = a.splits > 1 ? a.scratch + plane : nullptr;
  const int q_tiles = (a.sq + 16 * a.warps - 1) / (16 * a.warps);
  rows_kernel<<<a.b * a.heads * q_tiles * a.splits, a.warps * 32,
                rows_stream_smem<T, KD>(a.warps), stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.o, (const T*)a.d_o, (T*)a.dq,
      a.stats, delta, dq_part, a.sq, a.skv, a.heads, a.dh, a.scale, a.splits, a.per_split,
      (int)vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  keys_kernel<<<a.b * a.heads * key_tiles, kKeyWarps * 32, keys_stream_smem<T, KD>(), stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.d_o, a.stats, delta, (T*)a.dk,
      (T*)a.dv, a.sq, a.skv, a.heads, a.dh, a.scale, (int)vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const size_t total = plane * a.dh;
  attention_bwd_combine<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      dq_part, (T*)a.dq, a.b * a.heads, a.sq, a.heads, a.dh, a.splits, a.scale);
  return cudaGetLastError();
}

template <typename T, int NT, int KD>
cudaError_t launch_mma(const Args& a, int device, cudaStream_t stream) {
  auto kernel = attention_bwd_mma<T, NT, KD>;
  cudaError_t err = allow_dynamic_smem(kernel, device);
  if (err != cudaSuccess) return err;
  bool vec = (a.dh * sizeof(T)) % 16 == 0;
  for (const void* p : {a.q, a.k, a.v, a.d_o}) vec = vec && ((uintptr_t)p % 16 == 0);
  const int tiles = ((a.sq > a.skv ? a.sq : a.skv) + 15) / 16;
  kernel<<<a.b * a.heads, warps_for(tiles, kMaxWarps) * 32, mma_smem_bytes(a.sq, a.skv, KD * 8),
           stream>>>((const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.o,
                     (const T*)a.d_o, (T*)a.dq, (T*)a.dk, (T*)a.dv, a.sq, a.skv,
                     a.heads, a.dh, a.scale, (int)vec);
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
    auto kernel = attention_bwd_general<T>;
    err = allow_dynamic_smem(kernel, device);
    if (err != cudaSuccess) return (int)err;
    kernel<<<a.b * a.heads, kGeneralWarps * 32, general_smem_bytes(a.sq, a.skv, a.dh),
             stream>>>((const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.o,
                       (const T*)a.d_o, (T*)a.dq, (T*)a.dk, (T*)a.dv, a.sq, a.skv,
                       a.heads, a.dh, a.scale);
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

template <typename T, int KD>
long long stream_smem(int warps, int pass) {
  return (long long)(pass == 0 ? rows_stream_smem<T, KD>(warps) : keys_stream_smem<T, KD>());
}

}  // namespace

extern "C" {

// Shared memory a block needs at this shape with `variant` (-1: the one the
// launch would pick, 0: the tensor-core kernel, 1: the general kernel), or
// -1 where that variant does not take the shape, and for the streaming
// kernels, whose shared memory follows their plan
// (attention_bwd_stream_smem_bytes).  Above the block's limit means that
// nothing takes it.
long long attention_bwd_smem_bytes(int sq, int skv, int dh, int variant) {
  variant = pick(variant, sq, skv, dh);
  if (variant == kGeneral) return (long long)general_smem_bytes(sq, skv, dh);
  if (variant != kMma || !mma_takes(sq, skv, dh)) return -1;
  return (long long)mma_smem_bytes(sq, skv, padded_head_dim(dh));
}

// Shared memory of a streaming block at head_dim `dh`, fp32 (bf16 = 0) or
// bf16 tensors: pass 0 (query rows, `warps` warps) or pass 1 (key tiles);
// -1 where the streaming kernels do not take dh.
long long attention_bwd_stream_smem_bytes(int warps, int dh, int bf16, int pass) {
  if (!stream_takes(dh)) return -1;
  const int kd = padded_head_dim(dh) / 8;
  if (bf16)
    return kd == 2   ? stream_smem<__nv_bfloat16, 2>(warps, pass)
           : kd == 4 ? stream_smem<__nv_bfloat16, 4>(warps, pass)
                     : stream_smem<__nv_bfloat16, 8>(warps, pass);
  return kd == 2   ? stream_smem<float, 2>(warps, pass)
         : kd == 4 ? stream_smem<float, 4>(warps, pass)
                   : stream_smem<float, 8>(warps, pass);
}

// 0: the tensor-core kernel runs this shape, 1: the general kernel, 2: the
// streaming kernels.
int attention_bwd_variant(int sq, int skv, int dh) { return pick(kAuto, sq, skv, dh); }

const char* attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream`; allocate nothing, do not synchronise.  Return the
// cudaError_t of the launch (0 on success) and write the variant that ran
// to `ran`.  float and bfloat16 tensors.  The streaming variant takes its
// plan (warps a block of pass A, splits of the key tiles, key tiles a
// split; from ops/attention.py::stream_plan), the forward's row statistics
// `stats` (fp32 [2, B*H, Sq]) and an fp32 `scratch` of B*H*Sq floats (the
// rows' delta), plus splits * B*H*Sq * dh with more than one split (dq's
// partials, which a third launch adds up); the other variants read none of
// these.
int attention_bwd(const void* q, const void* k, const void* v, const void* o,
                  const void* d_o, void* dq, void* dk, void* dv, const void* stats,
                  void* scratch, int b, int sq, int skv, int heads, int dh, float scale,
                  int variant, int warps, int splits, int per_split, int device, void* stream,
                  int* ran) {
  return launch<float>({q, k, v, o, d_o, dq, dk, dv, (const float*)stats, (float*)scratch, b,
                        sq, skv, heads, dh, scale, warps, splits, per_split},
                       variant, device, stream, ran);
}

int attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                       const void* d_o, void* dq, void* dk, void* dv, const void* stats,
                       void* scratch, int b, int sq, int skv, int heads, int dh, float scale,
                       int variant, int warps, int splits, int per_split, int device,
                       void* stream, int* ran) {
  return launch<__nv_bfloat16>({q, k, v, o, d_o, dq, dk, dv, (const float*)stats,
                                (float*)scratch, b, sq, skv, heads, dh, scale, warps, splits,
                                per_split},
                               variant, device, stream, ran);
}

}  // extern "C"
