// The blocked right-to-left / left-to-right semi-CRF recurrences on Hopper:
// the pieces that the Viterbi kernel (viterbi_bwd.cu) and the log-space
// table kernel (semicrf_lse_cluster.cuh) share.
//
// Both recurrences walk Tp positions in "processing order" k = 0 .. Tp-1
// (k = Tp-1-p for a right-to-left table), and the entry of position k is a
// reduction over every earlier position m < k of table[m] + score(k, m),
// then a skip from table[k-1].  The positions are taken in blocks of
// kBlock = 8: for the block [k0, k0+8) the "far" part, the reduction over
// every m < k0, reads only entries that are final, so it is one parallel
// pass; only the 8 x 8 "near" corner (m in [k0, k)) runs in sequence.
//
// The work of one lane group (a 32-byte sector of each score row: 8 fp32 or
// 16 bf16 lanes) is spread over the CTAs of a thread-block cluster:
//
//   * CTA `rank` of the cluster owns the earlier positions m = rank (mod C)
//     and keeps their table entries in its shared memory (ceil(Tp/C) rows).
//   * One warp a position of the block; its 32 threads are 16 "slots" of
//     earlier positions x 2 halves of the sector, one 16-byte load each.
//     Slot s takes the owned positions u = s, s + 16, ... (m = rank + C*u).
//   * A thread loads up to kRound such pieces into registers ahead of the
//     block (the scores do not depend on the table), reduces them, the 16
//     slots meet by shuffles, and slot c hands the warp's partial to CTA c
//     through distributed shared memory, into a slot of its own there
//     (kernel-specific: a packed (value, end) key, or a (max, sum) pair).
//   * One cluster barrier a block, in two halves: the next block's loads are
//     issued between the arrive and the wait.  Then every CTA merges the C partials of
//     each (position, lane) in rank order and runs the same corner on the
//     same inputs (so every CTA derives the same 8 new entries, bit for
//     bit), keeps the ones it owns, and rank 0 writes the output.  CTA
//     barriers order the merge, the corner and the next block's far pass.
//
// The partials go into one of two buffers by the block's parity: a CTA
// reads buffer n & 1 after the barrier of block n, while faster CTAs may
// already write block n+1's partials into the other one.
//
// The alpha kernel (semicrf_lse_cluster.cuh) takes its far scores otherwise:
// a TMA tensor copy of each block's box into a ring in shared memory,
// completed on mbarriers (the primitives at the end of this file), and runs
// its corner on threads of their own.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap (a type only: the map is encoded through the runtime)
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "as_float.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kBlock = 8;                 // positions a block, one warp each
constexpr int kThreads = kBlock * 32;     // threads a CTA
// Bytes of a score row a CTA owns: one 32-byte sector.  128 bytes (4
// sectors, whole lines) was measured slower on an H100 at every path shape
// (0.67 against 0.48 ms at [696,696,128] fp32, scripts/study_cluster_dp.py):
// a CTA's share of a block, not the size of its requests, sets the time.
constexpr int kRowBytes = 32;
constexpr int kParts = kRowBytes / 16;    // threads that share one row, 16 bytes each
constexpr int kSlots = 32 / kParts;       // slots of earlier positions a warp
constexpr int kRound = 24;                // 16-byte loads a thread keeps in flight
constexpr int kCornerTerms = kBlock * (kBlock - 1) / 2;  // near terms of a block

// A lane group: the lanes of kRowBytes of a score row.
template <typename S>
struct Lanes {
  static constexpr int kGroup = kRowBytes / (int)sizeof(S);  // lanes a CTA
  static constexpr int kPiece = 16 / (int)sizeof(S);         // lanes of one 16-byte load
};

// The cluster barrier in two halves, so that a thread can issue loads
// between them: the partials stored before the arrive are visible to every
// CTA of the cluster after the wait.  A thread that has exited is not
// waited for.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// A named barrier (not barrier 0, which __syncthreads takes) of `threads`
// threads: a producer of data arrives, which does not wait, and its
// consumers sync; what the producers stored before they arrived is visible
// to the consumers after the sync.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Dynamic shared memory of either kernel: two buffers of the C CTAs' 8-byte
// partials [C][kBlock][lanes] (a packed key, or a (max, sum) pair), the
// merged partials [kBlock][lanes] and the CTA's ceil(tp / C) table rows.
template <typename S>
__host__ __device__ constexpr size_t cluster_smem_bytes(int tp, int cluster) {
  return (2 * (size_t)cluster + 1) * kBlock * Lanes<S>::kGroup * 8 +
         (size_t)((tp + cluster - 1) / cluster) * Lanes<S>::kGroup * sizeof(float);
}

// Ends of the pieces a thread loads for block [k0, k0 + kBlock): the owned
// earlier positions m = rank + C*u with m < k0, u = slot + kSlots*t.
__device__ __forceinline__ int owned_below(int k0, int rank, int c) {
  return k0 > rank ? (k0 - rank + c - 1) / c : 0;
}
__device__ __forceinline__ int pieces_of_slot(int u_hi, int slot) {
  return u_hi > slot ? (u_hi - slot + kSlots - 1) / kSlots : 0;
}

// 16 bytes of scores as fp32: 4 fp32 lanes or 8 bf16 lanes (exact).
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[4], float) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[8], __nv_bfloat16) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    x[2 * a] = __uint_as_float(w[a] << 16);
    x[2 * a + 1] = __uint_as_float(w[a] & 0xffff0000u);
  }
}

// kHalf consecutive fp32 table entries from shared memory (16-byte aligned).
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&x)[N]) {
#pragma unroll
  for (int a = 0; a < N; a += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + a);
    x[a] = v.x;
    x[a + 1] = v.y;
    x[a + 2] = v.z;
    x[a + 3] = v.w;
  }
}

// The launch of `ctas` CTAs of `threads` threads in clusters of `cluster`,
// with `smem` bytes of dynamic shared memory, after setting the kernel's
// attributes that this needs.  Returns the cudaError_t (0 on success).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  template <typename... Args>
  cudaError_t prepare(void (*kernel)(Args...), int ctas, int cluster, size_t smem, void* stream,
                      int threads) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && cluster > 8) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    cfg.gridDim = dim3((unsigned)ctas);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return err;
  }
};

// Launch on `stream` with kBlockThreads threads a CTA; no allocation, no
// synchronisation.
template <int kBlockThreads = kThreads, typename... Args>
int launch_clusters(void (*kernel)(Args...), int ctas, int cluster, size_t smem,
                    void* stream, Args... args) {
  ClusterLaunch l;
  cudaError_t err = l.prepare(kernel, ctas, cluster, smem, stream, kBlockThreads);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&l.cfg, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// How many clusters of `cluster` CTAs of kBlockThreads threads the card
// holds at once (a cluster lies within one GPC), written to *n; returns the
// cudaError_t.
template <int kBlockThreads = kThreads, typename... Args>
int max_active_clusters(void (*kernel)(Args...), int cluster, size_t smem, int* n) {
  ClusterLaunch l;
  cudaError_t err = l.prepare(kernel, cluster, cluster, smem, nullptr, kBlockThreads);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(n, kernel, &l.cfg);
  return (int)err;
}

// Issue a thread's loads t = r0 .. r0 + kRound - 1 of a block (those below
// `count`); `piece(t)` is the address of its t-th 16-byte piece.
template <typename F>
__device__ __forceinline__ void load_pieces(uint4 (&buf)[kRound], int r0, int count, F piece) {
#pragma unroll
  for (int r = 0; r < kRound; ++r) {
    if (r0 + r < count) buf[r] = __ldg(reinterpret_cast<const uint4*>(piece(r0 + r)));
  }
}

// -- TMA tensor copies completed on an mbarrier (the alpha kernel's far scores)

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Initialise an mbarrier of `count` arrivals a phase (one thread); fence
// before any other thread or the TMA unit uses it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_address(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive, and with `bytes` expect that many bytes of copies in this phase.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_address(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_address(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  Before the first
// phase completes, parity 1 counts as completed, so a producer's first pass
// over a ring does not wait.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n\t}" ::"r"(smem_address(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 3-D tensor map, starting at element (x, y, z) (innermost
// first), into shared memory at `dst`; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_address(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_address(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

}  // namespace
