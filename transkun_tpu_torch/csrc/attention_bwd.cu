// Multi-head attention backward on Hopper (sm_90a).
//
// Replaces the TPU kernel _bwd_kernel in transkun_tpu/ops/attention_pallas.py
// (called through _bwd_call, the VJP of fused_attention).  Inputs q, k, v,
// the saved output o and the cotangent do, flat [B, S, H*dh]; per batch
// element and head, with qs = q * scale:
//
//   p     = softmax(qs k^T)              recomputed, [Sq, Skv]
//   delta = rowsum(do * o)               [Sq]
//   dp    = do v^T
//   dl    = p * (dp - delta)
//   dq    = (dl k) * scale,   dk = dl^T qs,   dv = p^T do
//
// Every product is computed here, in fp32 FMAs; nothing of size [Sq, Skv]
// reaches device memory.  Accurate expf, no --use_fast_math.
//
// What bounds it: operations (the five products above are 2.5 times the
// forward's two), far from the card's rate for the same reason as the
// forward: short sequences, FMAs fed from shared memory.
//
// Design: one block per (b, h), with that head's qs, k, v and do in shared
// memory (rows on an odd stride, so lanes reading different rows hit
// different banks).  dq is a sum over keys and dk, dv are sums over queries,
// so the block makes two passes, and no output is accumulated by more than
// one warp: no atomics, no accumulators in shared memory, and a result that
// does not depend on scheduling.
//   Pass A, a warp per query row: logits over the keys (a lane per key),
//   row max and sum by shuffles, delta from do and o, then dl for the row in
//   a per-warp buffer and dq with a lane per column.  The row's max, sum and
//   delta are kept in shared memory.
//   Pass B, a warp per key: the logits of that key against every query row
//   (a lane per row, the same FMA chain as in pass A, so the same bits), p
//   and dl from the kept row statistics, then dk and dv with a lane per
//   column.
// The price is seven products instead of five (logits and dp are formed
// twice).  The alternative, tiling over queries and adding dk and dv up
// across blocks, needs atomics or a second reduction kernel.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 16;

__host__ __device__ constexpr int row_stride(int dh) { return dh | 1; }

__host__ __device__ constexpr size_t smem_bytes(int sq, int skv, int dh) {
  const int longest = sq > skv ? sq : skv;
  return ((size_t)2 * (sq + skv) * row_stride(dh) + (size_t)3 * sq +
          (size_t)2 * kWarps * longest) * sizeof(float);
}

__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float acc = 0.f;
  for (int d = 0; d < n; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

__global__ void __launch_bounds__(kWarps * 32)
    attention_bwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ o,
                         const float* __restrict__ d_o, float* __restrict__ dq,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int sq, int skv, int heads, int dh, float scale) {
  extern __shared__ float smem[];
  const int ld = row_stride(dh);
  const int longest = sq > skv ? sq : skv;
  float* qs = smem;                             // [sq][ld], scaled
  float* dos = qs + (size_t)sq * ld;            // [sq][ld]
  float* ks = dos + (size_t)sq * ld;            // [skv][ld]
  float* vs = ks + (size_t)skv * ld;            // [skv][ld]
  float* row_max = vs + (size_t)skv * ld;       // [sq]
  float* row_sum = row_max + sq;                // [sq]
  float* row_delta = row_sum + sq;              // [sq]
  float* buf_a = row_delta + sq;                // [kWarps][longest]
  float* buf_b = buf_a + (size_t)kWarps * longest;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int d_model = heads * dh;
  const size_t q_at = (size_t)b * sq * d_model + h * dh;
  const size_t k_at = (size_t)b * skv * d_model + h * dh;

  for (int idx = threadIdx.x; idx < sq * dh; idx += blockDim.x) {
    const int r = idx / dh, d = idx - r * dh;
    qs[r * ld + d] = q[q_at + (size_t)r * d_model + d] * scale;
    dos[r * ld + d] = d_o[q_at + (size_t)r * d_model + d];
  }
  for (int idx = threadIdx.x; idx < skv * dh; idx += blockDim.x) {
    const int j = idx / dh, d = idx - j * dh;
    ks[j * ld + d] = k[k_at + (size_t)j * d_model + d];
    vs[j * ld + d] = v[k_at + (size_t)j * d_model + d];
  }
  __syncthreads();

  float* mine_a = buf_a + (size_t)warp * longest;
  float* mine_b = buf_b + (size_t)warp * longest;

  // Pass A: a warp per query row -> row statistics and dq.
  for (int r = warp; r < sq; r += kWarps) {
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
      delta = fmaf(dor[d], o[q_at + (size_t)r * d_model + d], delta);
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
      dq[q_at + (size_t)r * d_model + d] = acc * scale;
    }
    __syncwarp();  // the next row overwrites mine_a
  }
  __syncthreads();

  // Pass B: a warp per key -> dk and dv.
  for (int j = warp; j < skv; j += kWarps) {
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
      dk[k_at + (size_t)j * d_model + d] = acc_k;
      dv[k_at + (size_t)j * d_model + d] = acc_v;
    }
    __syncwarp();  // the next key overwrites mine_a and mine_b
  }
}

}  // namespace

extern "C" {

long long attention_bwd_smem_bytes(int sq, int skv, int dh) {
  return (long long)smem_bytes(sq, skv, dh);
}

const char* attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches on `stream`, allocates nothing and does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
int attention_bwd(const void* q, const void* k, const void* v, const void* o,
                  const void* d_o, void* dq, void* dk, void* dv, int b, int sq,
                  int skv, int heads, int dh, float scale, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(sq, skv, dh);
  err = cudaFuncSetAttribute(attention_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_kernel<<<b * heads, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)d_o, (float*)dq, (float*)dk, (float*)dv, sq, skv, heads,
      dh, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
