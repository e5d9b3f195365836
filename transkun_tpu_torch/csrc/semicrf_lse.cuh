// The log-space semi-CRF tables on Hopper (sm_90a): one kernel template for
// the forward (alpha) and the backward (beta) recurrence, included by
// semicrf_alpha.cu and semicrf_beta.cu.
//
//   alpha, i = 0 .. Tp-1:   v[0] = spdiag[0]
//     v[i] = logaddexp(v[i-1] + noise[i], logsumexp_{j<i} v[j] + s[i, j])
//            + spdiag[i]                       (noise = the shifted noise)
//   beta, t = Tp-1 .. 0:    q[Tp-1] = spdiag[Tp-1]
//     q[t] = logaddexp(q[t+1] + noise[t], logsumexp_{e>t} q[e] + s[e, t])
//            + spdiag[t]
//
// s is the alpha-layout tensor [Tp, Tp, NBp] ([end, begin, lane]); the beta
// table reads its columns (stride Tp*NBp between ends), so no flipped copy
// is made.  Padded rows and lanes hold NEG scores and zero noise, and reduce
// to zero-weight skip chains.
//
// What bounds it: the chain of Tp dependent positions, not bytes.  At the
// flagship training shape (Tp = 696, NBp = 384) a table reads one triangle
// of the 744 MB tensor (372 MB in bf16), about 0.1 ms at the card's bandwidth, but every
// position waits for the one before it, and only NBp / 32 = 12 blocks run.
//
// Design: one block per 32 consecutive lanes, so a warp reads 128
// contiguous bytes of a [Tp, NBp] row.  32 warps stride over the terms of a
// position; each thread keeps an online (max, rescaled sum) pair, so the
// row is read once.  The 32 partial pairs of a lane meet through shared
// memory, transposed so that warp w merges lane w with shuffles, and lane 0
// of warp w adds the skip and writes the table entry.  The block's column
// of the table lives in shared memory (Tp * 32 * 4 bytes, 89 KB at
// Tp = 696).  The TPU kernels' VMEM blocking (KP = 8 positions per grid
// step, a full-stripe "far" sum and an unrolled "near" corner) existed to
// stream the score through VMEM in large tiles; here blocks carry no state
// between grid steps, so the loop over positions runs inside the block and
// the recurrence is computed directly.  Making it fast (more blocks per
// lane group, prefetching the next row) is later work.
//
// s is fp32 or bf16 (the template's score type; one exported function
// each).  A bf16 score is converted to fp32 as it is loaded, which is exact,
// as the TPU kernels upcast their stripe; the table, noise, spdiag and every
// sum stay fp32.
//
// Numerics: sums in another order than the plain version, so the tables
// agree to rounding, not bit for bit.  An empty partial (no term, or a
// merge with no mass) contributes an explicit 0, never exp(-inf - -inf).
// The + 1e-38 before the log is subnormal: the build must not use
// --use_fast_math (flush-to-zero), and expf/logf are the accurate ones.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "as_float.cuh"

namespace {

constexpr int kLanes = 32;      // lanes per block
constexpr int kWarps = 32;      // warps per block, striding over the terms
constexpr int kPad = kLanes + 1;  // row pitch of the merge arrays (no bank conflicts)

__host__ __device__ constexpr size_t lse_smem_bytes(int tp) {
  return (size_t)tp * kLanes * sizeof(float) +
         2 * (size_t)kWarps * kPad * sizeof(float);
}

template <bool kForward, typename S>
__global__ void __launch_bounds__(kLanes * kWarps)
    lse_table_kernel(const S* __restrict__ s,
                     const float* __restrict__ noise,
                     const float* __restrict__ spdiag,
                     float* __restrict__ out, int tp, int nbp) {
  extern __shared__ float smem[];
  float* tab = smem;                           // [tp][kLanes]
  float* red_m = tab + (size_t)tp * kLanes;    // [kWarps][kPad]
  float* red_s = red_m + kWarps * kPad;        // [kWarps][kPad]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kLanes;
  const float neg_inf = __int_as_float(0xff800000);
  // distance in elements between consecutive terms of one position
  const size_t term_stride = kForward ? (size_t)nbp : (size_t)tp * nbp;

  const int first = kForward ? 0 : tp - 1;
  if (warp == 0) {
    const size_t at = (size_t)first * nbp + col0 + lane;
    const float x = spdiag[at];
    tab[first * kLanes + lane] = x;
    out[at] = x;
  }
  __syncthreads();

  for (int k = 1; k < tp; ++k) {
    const int i = kForward ? k : tp - 1 - k;
    const int lo = kForward ? 0 : i + 1;   // terms j in [lo, hi)
    const int hi = kForward ? i : tp;
    // term j of position i: forward s[i, j] = s[(i*tp + j)*nbp],
    // backward s[j, i] = s[(j*tp + i)*nbp]
    const S* base = s + (kForward ? (size_t)i * tp * nbp : (size_t)i * nbp) +
                        col0 + lane;
    float m = neg_inf;
    float acc = 0.f;
    for (int j = lo + warp; j < hi; j += kWarps) {
      const float x =
          tab[j * kLanes + lane] + as_float(base[(size_t)j * term_stride]);
      if (x > m) {
        acc = acc * expf(m - x) + 1.f;  // acc = 0 while m = -inf
        m = x;
      } else {
        acc += expf(x - m);
      }
    }
    red_m[warp * kPad + lane] = m;
    red_s[warp * kPad + lane] = acc;
    __syncthreads();

    // warp w merges lane w: thread l holds warp l's partial for that lane
    const float pm = red_m[lane * kPad + warp];
    const float ps = red_s[lane * kPad + warp];
    float mx = pm;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    float sum = ps > 0.f ? ps * expf(pm - mx) : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    }
    if (lane == 0) {
      const int prev = kForward ? i - 1 : i + 1;
      const size_t at = (size_t)i * nbp + col0 + warp;
      const float skip = tab[prev * kLanes + warp] + noise[at];
      const float top = fmaxf(mx, skip);
      const float total =
          (sum > 0.f ? sum * expf(mx - top) : 0.f) + expf(skip - top);
      const float x = top + logf(total + 1e-38f) + spdiag[at];
      tab[i * kLanes + warp] = x;
      out[at] = x;
    }
    __syncthreads();
  }
}

// Launches on `stream`, allocates nothing and does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
template <bool kForward, typename S>
int launch_lse_table(const void* s, const void* noise, const void* spdiag,
                     void* out, int tp, int nbp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = lse_smem_bytes(tp);
  err = cudaFuncSetAttribute(lse_table_kernel<kForward, S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  lse_table_kernel<kForward, S><<<nbp / kLanes, kLanes * kWarps, smem,
                                  (cudaStream_t)stream>>>(
      (const S*)s, (const float*)noise, (const float*)spdiag,
      (float*)out, tp, nbp);
  return (int)cudaGetLastError();
}

}  // namespace
