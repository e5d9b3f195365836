// Multi-head attention forward on Hopper (sm_90a).
//
// Replaces the TPU kernel _fwd_kernel in transkun_tpu/ops/attention_pallas.py
// (called through _fwd / fused_attention).  Per batch element b and head h,
// with heads as column slices of the flat [B, S, H*dh] layout:
//
//   logits = (q * scale) k^T     [Sq, Skv], fp32
//   p      = exp(logits - rowmax(logits))
//   o      = (p v) / rowsum(p)   [Sq, dh]
//
// Both products are computed here, in fp32 FMAs; the [Sq, Skv] logits never
// reach device memory and no [B, H, S, dh] transpose pass exists.  Accurate
// expf; the build must not use --use_fast_math.
//
// What bounds it: operations, but far from the card's rate.  At the flagship
// shape [89, 149, 256], 8 heads, the kernel moves 54 MB and does 2.0 GFLOP;
// the sequences are short (S = 89..149, dh = 32), so the work is many small
// products, and this first version feeds every FMA from shared memory.
//
// Design: one block per (b, h).  That head's k and v live in shared memory,
// rows padded to an odd stride so that 32 lanes reading 32 different rows
// hit 32 different banks.  A warp owns one query row at a time: each lane
// takes the keys j = lane, lane+32, ... and forms their logits (the scaled
// query row is broadcast from shared memory), the row max and the row sum
// meet through warp shuffles, the unnormalised p goes to a per-warp row in
// shared memory, and then lane d accumulates sum_j p[j] v[j][d] and divides
// once.  The TPU kernel's group of G batch elements per grid step and its
// static lane slices were VMEM and Mosaic choices and are not carried over.
// Faster later: several query rows per warp (register tiling), so that a k
// or v value read from shared memory feeds more than one FMA.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;

__host__ __device__ constexpr int row_stride(int dh) { return dh | 1; }

__host__ __device__ constexpr size_t smem_bytes(int skv, int dh) {
  return ((size_t)2 * skv * row_stride(dh) + (size_t)kWarps * dh +
          (size_t)kWarps * skv) * sizeof(float);
}

__global__ void __launch_bounds__(kWarps * 32)
    attention_fwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int sq, int skv, int heads, int dh, float scale) {
  extern __shared__ float smem[];
  const int ld = row_stride(dh);
  float* ks = smem;                             // [skv][ld]
  float* vs = ks + (size_t)skv * ld;            // [skv][ld]
  float* qrows = vs + (size_t)skv * ld;         // [kWarps][dh]
  float* probs = qrows + kWarps * dh;           // [kWarps][skv]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int d_model = heads * dh;
  const float* qb = q + (size_t)b * sq * d_model + h * dh;
  const float* kb = k + (size_t)b * skv * d_model + h * dh;
  const float* vb = v + (size_t)b * skv * d_model + h * dh;
  float* ob = o + (size_t)b * sq * d_model + h * dh;

  for (int idx = threadIdx.x; idx < skv * dh; idx += blockDim.x) {
    const int j = idx / dh, d = idx - j * dh;
    ks[j * ld + d] = kb[(size_t)j * d_model + d];
    vs[j * ld + d] = vb[(size_t)j * d_model + d];
  }
  __syncthreads();

  float* qrow = qrows + warp * dh;
  float* p = probs + (size_t)warp * skv;
  for (int r = warp; r < sq; r += kWarps) {
    for (int d = lane; d < dh; d += 32)
      qrow[d] = qb[(size_t)r * d_model + d] * scale;
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
      ob[(size_t)r * d_model + d] = acc / s;
    }
    __syncwarp();  // the next row overwrites qrow and p
  }
}

}  // namespace

extern "C" {

long long attention_fwd_smem_bytes(int sq, int skv, int dh) {
  (void)sq;
  return (long long)smem_bytes(skv, dh);
}

const char* attention_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches on `stream`, allocates nothing and does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
int attention_fwd(const void* q, const void* k, const void* v, void* o, int b,
                  int sq, int skv, int heads, int dh, float scale, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(skv, dh);
  err = cudaFuncSetAttribute(attention_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_fwd_kernel<<<b * heads, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, sq, skv,
      heads, dh, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
