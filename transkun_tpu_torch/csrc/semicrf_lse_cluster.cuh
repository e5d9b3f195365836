// The log-space semi-CRF tables on Hopper (sm_90a), blocked over positions
// and spread over a thread-block cluster: one kernel template for the
// forward (alpha) and the backward (beta) recurrence.
//
//   alpha, i = 0 .. Tp-1:   v[0] = spdiag[0]
//     v[i] = logaddexp(v[i-1] + noise[i], logsumexp_{j<i} v[j] + s[i, j])
//            + spdiag[i]                       (noise = the shifted noise)
//   beta, t = Tp-1 .. 0:    q[Tp-1] = spdiag[Tp-1]
//     q[t] = logaddexp(q[t+1] + noise[t], logsumexp_{e>t} q[e] + s[e, t])
//            + spdiag[t]
//
// s is the alpha-layout tensor [Tp, Tp, NBp] ([end, begin, lane]); the beta
// table reads its columns, so no flipped copy is made.  Padded rows and
// lanes hold NEG scores and zero noise, and reduce to zero-weight skip
// chains.
//
// What bounds it: the chain of Tp dependent positions, and the accurate
// expf of every term, not bytes.  At the flagship training shape (Tp = 696,
// NBp = 384) a table reads the strict triangle of the 744 MB tensor once
// (372 MB, 186 MB in bf16), 0.11 ms at the card's bandwidth.  The first port
// (still semicrf_lse.cuh, which the alpha kernel runs) took the chain one
// position at a time on NBp/32 = 12 blocks, with two block barriers a
// position, and its beta read each term as a lone 128-byte piece about 1 MB
// from the last: 3.73 ms on an H100.
//
// Design (the shared scheme is in cluster_dp.cuh): positions in blocks of
// 8, in the recurrence's own order (k = Tp-1-t for beta, so a ragged block
// is the last one, at t = 0).  For one end e the 8 positions of a beta block
// read s[e, t0:t0+8, lanes]: 8 sectors NBp * 4 bytes apart.  A thread keeps
// an online (max, rescaled sum) pair a lane over its pieces, taken two
// passes a round (the round's max, then independent expf); the slots of a
// warp meet by a max and a sum of shuffles; each warp stores its pairs into
// every CTA's shared memory; after the cluster barrier each CTA merges the
// C pairs of each (position, lane) with one expf each, then runs the corner:
// a serial logaddexp of at most 7 near terms and the skip a position.  The
// cluster size is planned as for the Viterbi kernel (ops/logz.py::
// launch_plan: 2 at fp32 [696,696,384] on an H100, 96 CTAs).
//
// What bounds it now: as for the Viterbi kernel, the issue of each block's
// sector loads and the barrier, plus the far pass's expf (up to 88 a thread
// a block at 2 CTAs a lane group) and the corner's serial logf: about 11 us
// a block, 0.94 ms at [696,696,384] fp32, 8.4 times the byte bound.
//
// s is fp32 or bf16 (the template's score type; one exported function
// each).  A bf16 score is converted to fp32 as it is loaded, which is exact;
// the table, noise, spdiag and every sum stay fp32.
//
// Numerics: sums in another order than the plain version, so the tables
// agree to rounding, not bit for bit; every order is fixed, so two runs give
// the same bits.  An empty partial (no term, or a merge with no mass)
// contributes an explicit 0, never exp(-inf - -inf).  The + 1e-38 before the
// log is subnormal: the build must not use --use_fast_math (flush-to-zero),
// and expf/logf are the accurate ones.

#pragma once

#include "cluster_dp.cuh"

namespace {

// Processing index k (0 = the recurrence's first position) -> row of the
// table, the noise and spdiag.
template <bool kForward>
__device__ __forceinline__ int row_of(int k, int tp) {
  return kForward ? k : tp - 1 - k;
}

// Element offset of the score of position k's term from the earlier
// position m (both processing indices), lane 0: forward s[k, m], backward
// s[Tp-1-m, Tp-1-k].
template <bool kForward>
__device__ __forceinline__ size_t term_at(int k, int m, int tp, int nbp) {
  return kForward ? ((size_t)k * tp + m) * nbp
                  : ((size_t)(tp - 1 - m) * tp + (tp - 1 - k)) * nbp;
}

template <bool kForward, typename S>
__global__ void __launch_bounds__(kThreads, 1)
    lse_cluster_kernel(const S* __restrict__ s,
                       const float* __restrict__ noise,
                       const float* __restrict__ spdiag,
                       float* __restrict__ out, int tp, int nbp) {
  constexpr int G = Lanes<S>::kGroup;
  constexpr int V = Lanes<S>::kPiece;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  float2* parts = reinterpret_cast<float2*>(smem);      // [2][C][kBlock][G]
  float2* merged = parts + 2 * c * kBlock * G;          // [kBlock][G]
  float* tab = reinterpret_cast<float*>(merged + kBlock * G);  // [ceil(tp/C)][G]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = lane % kParts, slot = lane / kParts;
  const int col0 = (int)(blockIdx.x / c) * G;
  const int cl = threadIdx.x;  // a corner thread's lane in the group
  const bool corner = cl < G;
  const int col = col0 + cl;
  const int nb = (tp + kBlock - 1) / kBlock;
  const float neg_inf = __int_as_float(0xff800000);

  // the t-th piece of block n for this thread: position k = k0 + warp, the
  // earlier position m = rank + C*(slot + kSlots*t)
  auto piece = [&](int n, int t) {
    return s + term_at<kForward>(n * kBlock + warp, rank + c * (slot + kSlots * t), tp, nbp) +
           col0 + part * V;
  };
  // pieces of block n for this thread; none for a position past the end
  auto count_of = [&](int n) {
    const int k0 = n * kBlock;
    return k0 + warp < tp ? pieces_of_slot(owned_below(k0, rank, c), slot) : 0;
  };
  uint4 buf[kRound];
  float near[kCornerTerms], nz[kBlock], dg[kBlock];
  auto load_corner = [&](int n) {
    const int k0 = n * kBlock;
#pragma unroll
    for (int i = 0; i < kBlock; ++i) {
      const int k = k0 + i;
      if (k < tp) {
        const size_t at = (size_t)row_of<kForward>(k, tp) * nbp + col;
        nz[i] = noise[at];
        dg[i] = spdiag[at];
#pragma unroll
        for (int j = 0; j < i; ++j) {
          near[i * (i - 1) / 2 + j] = as_float(s[term_at<kForward>(k, k0 + j, tp, nbp) + col]);
        }
      }
    }
  };
  if (corner) load_corner(0);  // block 0 has no far part
  cluster.sync();              // every CTA of the cluster running

  float carry = 0.f;  // table entry of the previous block's last position
  for (int n = 0; n < nb; ++n) {
    const int k0 = n * kBlock;
    const int count = count_of(n);
    // -- far part: (max, sum of exp(x - max)) a lane over the thread's pieces
    float mx[V], acc[V];
#pragma unroll
    for (int l = 0; l < V; ++l) {
      mx[l] = neg_inf;
      acc[l] = 0.f;
    }
    for (int r0 = 0; r0 < count; r0 += kRound) {
      if (r0 > 0) load_pieces(buf, r0, count, [&](int t) { return piece(n, t); });
      float rm[V];  // the round's max
#pragma unroll
      for (int l = 0; l < V; ++l) rm[l] = mx[l];
#pragma unroll
      for (int r = 0; r < kRound; ++r) {
        if (r0 + r < count) {
          float sc[V], q[V];
          unpack(buf[r], sc, S{});
          load_row(tab + (slot + kSlots * (r0 + r)) * G + part * V, q);
#pragma unroll
          for (int l = 0; l < V; ++l) rm[l] = fmaxf(rm[l], q[l] + sc[l]);
        }
      }
#pragma unroll
      for (int l = 0; l < V; ++l) {
        acc[l] = acc[l] > 0.f ? acc[l] * expf(mx[l] - rm[l]) : 0.f;
        mx[l] = rm[l];
      }
#pragma unroll
      for (int r = 0; r < kRound; ++r) {
        if (r0 + r < count) {
          float sc[V], q[V];
          unpack(buf[r], sc, S{});
          load_row(tab + (slot + kSlots * (r0 + r)) * G + part * V, q);
#pragma unroll
          for (int l = 0; l < V; ++l) acc[l] += expf(q[l] + sc[l] - mx[l]);
        }
      }
    }
    // the slots of the warp meet: the max, then the rescaled sums
    float2 pair[V];
#pragma unroll
    for (int l = 0; l < V; ++l) {
      float m = mx[l];
#pragma unroll
      for (int o = kParts; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = acc[l] > 0.f ? acc[l] * expf(mx[l] - m) : 0.f;
#pragma unroll
      for (int o = kParts; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      pair[l] = make_float2(m, sum);
    }
    const int parity = n & 1;
    for (int to = slot; to < c; to += kSlots) {  // slot s: CTAs s, s + kSlots, ...
      float4* dst = reinterpret_cast<float4*>(
          cluster.map_shared_rank(parts, to) +
          ((parity * c + rank) * kBlock + warp) * G + part * V);
#pragma unroll
      for (int l = 0; l < V; l += 2) {
        dst[l / 2] = make_float4(pair[l].x, pair[l].y, pair[l + 1].x, pair[l + 1].y);
      }
    }
    cluster_arrive();
    if (n + 1 < nb) {  // the next block's scores, while this block finishes
      const int next = count_of(n + 1);
      load_pieces(buf, 0, next, [&](int t) { return piece(n + 1, t); });
    }
    cluster_wait();

    // -- merge the C CTAs' pairs of each (position, lane), in rank order
    for (int x = threadIdx.x; x < kBlock * G; x += kThreads) {
      const float2* src = parts + parity * c * kBlock * G + x;
      float m = neg_inf;
      for (int r = 0; r < c; ++r) m = fmaxf(m, src[r * kBlock * G].x);
      float sum = 0.f;
      for (int r = 0; r < c; ++r) {
        const float2 pr = src[r * kBlock * G];
        sum += pr.y > 0.f ? pr.y * expf(pr.x - m) : 0.f;
      }
      merged[x] = make_float2(m, sum);
    }
    __syncthreads();

    // -- corner: positions k0 .. k0+7 in order, one thread a lane
    if (corner) {
      float qb[kBlock];
      float prev = carry;
#pragma unroll
      for (int i = 0; i < kBlock; ++i) {
        const int k = k0 + i;
        if (k >= tp) break;
        if (k == 0) {  // the first position: no term, no skip
          qb[i] = dg[i];
          prev = qb[i];
          continue;
        }
        const float2 far = merged[i * G + cl];
        const float skip = prev + nz[i];
        float x[kBlock - 1];
        float top = fmaxf(far.x, skip);
#pragma unroll
        for (int j = 0; j < i; ++j) {
          x[j] = qb[j] + near[i * (i - 1) / 2 + j];
          top = fmaxf(top, x[j]);
        }
        float total = (far.y > 0.f ? far.y * expf(far.x - top) : 0.f) + expf(skip - top);
#pragma unroll
        for (int j = 0; j < i; ++j) total += expf(x[j] - top);
        qb[i] = top + logf(total + 1e-38f) + dg[i];
        prev = qb[i];
      }
      carry = prev;
#pragma unroll
      for (int i = 0; i < kBlock; ++i) {
        const int k = k0 + i;
        if (k < tp) {
          if (k % c == rank) tab[(k / c) * G + cl] = qb[i];
          if (rank == 0) out[(size_t)row_of<kForward>(k, tp) * nbp + col] = qb[i];
        }
      }
      if (n + 1 < nb) load_corner(n + 1);
    }
    __syncthreads();
  }
}

// Launches on `stream` as clusters of `cluster` CTAs, allocates nothing and
// does not synchronise.  Returns the cudaError_t of the launch (0 on success).
template <bool kForward, typename S>
int launch_lse_cluster(const void* s, const void* noise, const void* spdiag,
                       void* out, int tp, int nbp, int cluster, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_clusters(lse_cluster_kernel<kForward, S>, nbp / Lanes<S>::kGroup * cluster,
                         cluster, cluster_smem_bytes<S>(tp, cluster), stream, (const S*)s,
                         (const float*)noise, (const float*)spdiag, (float*)out, tp, nbp);
}

// clusters of `cluster` CTAs the card holds at once, into *n
template <bool kForward>
int lse_cluster_max_clusters(int tp, int cluster, int bf16, int device, int* n) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return bf16 ? max_active_clusters(lse_cluster_kernel<kForward, __nv_bfloat16>, cluster,
                                    cluster_smem_bytes<__nv_bfloat16>(tp, cluster), n)
              : max_active_clusters(lse_cluster_kernel<kForward, float>, cluster,
                                    cluster_smem_bytes<float>(tp, cluster), n);
}

}  // namespace
