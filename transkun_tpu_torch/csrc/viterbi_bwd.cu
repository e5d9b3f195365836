// Right-to-left semi-CRF Viterbi tables on Hopper (sm_90a).
//
// Replaces the TPU kernel _viterbi_bwd_kernel in
// transkun_tpu/ops/semicrf_pallas.py (called through
// viterbi_backward_tables_padded).  It computes, from the same padded inputs,
// the same pointer table bit for bit:
//
//   for p = Tp-1 down to 0, per lane:
//     best, best_e = max / smallest argmax over e > p of q[e] + s_t[p, e]
//     skip         = q[p+1] + noise[p]        (none at p = Tp-1)
//     q[p]         = max(skip, best) + diag_gate[p]   (q[Tp-1] = diag_gate)
//     ptr[p]       = skip >= best ? -1 : best_e - (p+1)
//
// Every step is one fp32 add, compare or max, so the result does not depend
// on the order in which the maximum is reduced: the tables equal the plain
// PyTorch version exactly.  The build must not use --use_fast_math.
//
// s_t is fp32 or bf16 (one exported function each).  A bf16 score is
// converted to fp32 as it is loaded, which is exact, as the TPU kernel
// upcasts its stripe; q, noise, diag_gate and every add, compare and max
// stay fp32, so the same bf16 bits give the same table as the plain
// version, and tie rules and padding do not change.
//
// What bounds it: the chain of Tp dependent positions, not bytes.  At the
// flagship shape (Tp = 696, 128 lanes) the kernel reads the upper triangle
// of the 248 MB score tensor once (124 MB in bf16), which is tens of
// microseconds at the card's bandwidth, but every position waits for the
// one before it.
//
// Design: one block per group of 32 consecutive lanes, so a warp reads 128
// contiguous bytes of a [Tp, NBp] row (64 in bf16).  32 warps stride over the end
// position e; per position the (max, smallest e) pairs meet through shared
// memory and warp 0 finishes the step.  q for the block's lanes lives in
// shared memory (Tp * 32 * 4 bytes, 89 KB at Tp = 696).  The TPU kernel's
// VMEM blocking (KP = 8 positions per sequential grid step, a full-stripe
// "far" reduction and an unrolled "near" corner) existed to stream the
// score tensor through VMEM in large tiles; here blocks cannot carry state
// between grid steps and the loop over positions lives inside the block, so
// the recurrence is computed directly.  Making it fast (more blocks per SM,
// splitting e across a cluster, prefetching the next row) is later work.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "as_float.cuh"

namespace {

constexpr int kLanes = 32;  // lanes per block
constexpr int kWarps = 32;  // warps per block, striding over e

__host__ __device__ constexpr size_t smem_bytes(int tp) {
  return (size_t)tp * kLanes * sizeof(float) +
         (size_t)kWarps * kLanes * (sizeof(float) + sizeof(int));
}

template <typename S>
__global__ void __launch_bounds__(kLanes * kWarps)
    viterbi_bwd_kernel(const S* __restrict__ s_t,
                       const float* __restrict__ noise,
                       const float* __restrict__ diag_gate,
                       int* __restrict__ ptr, int tp, int nbp) {
  extern __shared__ float smem[];
  float* q = smem;                                   // [tp][kLanes]
  float* red_v = q + (size_t)tp * kLanes;            // [kWarps][kLanes]
  int* red_e = reinterpret_cast<int*>(red_v + kWarps * kLanes);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kLanes + lane;
  const float neg_inf = __int_as_float(0xff800000);

  if (warp == 0) {
    const size_t at = (size_t)(tp - 1) * nbp + col;
    q[(tp - 1) * kLanes + lane] = diag_gate[at];
    ptr[at] = -1;
  }
  __syncthreads();

  for (int p = tp - 2; p >= 0; --p) {
    const S* row = s_t + (size_t)p * tp * nbp + col;
    float best = neg_inf;
    int best_e = INT_MAX;
#pragma unroll 4
    for (int e = p + 1 + warp; e < tp; e += kWarps) {
      const float v = q[e * kLanes + lane] + as_float(row[(size_t)e * nbp]);
      if (v > best) {  // strict: the smallest e of this warp wins ties
        best = v;
        best_e = e;
      }
    }
    red_v[warp * kLanes + lane] = best;
    red_e[warp * kLanes + lane] = best_e;
    __syncthreads();
    if (warp == 0) {
      for (int w = 1; w < kWarps; ++w) {
        const float v = red_v[w * kLanes + lane];
        const int e = red_e[w * kLanes + lane];
        if (v > best || (v == best && e < best_e)) {
          best = v;
          best_e = e;
        }
      }
      const size_t at = (size_t)p * nbp + col;
      const float skip = q[(p + 1) * kLanes + lane] + noise[at];
      q[p * kLanes + lane] = fmaxf(skip, best) + diag_gate[at];
      ptr[at] = skip >= best ? -1 : best_e - (p + 1);
    }
    __syncthreads();
  }
}

// Launches on `stream`, allocates nothing and does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
template <typename S>
int launch_viterbi_bwd(const void* s_t, const void* noise,
                       const void* diag_gate, void* ptr, int tp, int nbp,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(tp);
  err = cudaFuncSetAttribute(viterbi_bwd_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  viterbi_bwd_kernel<S><<<nbp / kLanes, kLanes * kWarps, smem,
                          (cudaStream_t)stream>>>(
      (const S*)s_t, (const float*)noise, (const float*)diag_gate, (int*)ptr,
      tp, nbp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int viterbi_bwd_lanes_per_block() { return kLanes; }

long long viterbi_bwd_smem_bytes(int tp) { return (long long)smem_bytes(tp); }

const char* viterbi_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// fp32 scores
int viterbi_bwd(const void* s_t, const void* noise, const void* diag_gate,
                void* ptr, int tp, int nbp, int device, void* stream) {
  return launch_viterbi_bwd<float>(s_t, noise, diag_gate, ptr, tp, nbp, device,
                                   stream);
}

// bf16 scores; noise, diag_gate and ptr as above
int viterbi_bwd_bf16(const void* s_t, const void* noise, const void* diag_gate,
                     void* ptr, int tp, int nbp, int device, void* stream) {
  return launch_viterbi_bwd<__nv_bfloat16>(s_t, noise, diag_gate, ptr, tp, nbp,
                                           device, stream);
}

}  // extern "C"
