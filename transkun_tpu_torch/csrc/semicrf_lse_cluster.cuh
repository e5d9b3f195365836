// The log-space semi-CRF tables on Hopper (sm_90a), blocked over positions
// and spread over a thread-block cluster: the backward (beta) kernel, whose
// far scores each thread loads into registers, and the forward (alpha)
// kernel, whose far scores arrive by TMA into a ring in shared memory.
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
// What bounds them: the chain of Tp dependent positions, and the accurate
// expf of every term, not bytes.  At the flagship training shape (Tp = 696,
// NBp = 384) a table reads the strict triangle of the 744 MB tensor once
// (372 MB, 186 MB in bf16), 0.11 ms at the card's bandwidth.
//
// Design (the shared scheme is in cluster_dp.cuh): positions in blocks of
// 8, in the recurrence's own order (k = Tp-1-t for beta, so a ragged block
// is the last one, at t = 0).  A thread keeps an online (max, rescaled sum)
// pair a lane over its terms; the slots of a warp meet by a max and a sum of
// shuffles; each warp stores its pairs into every CTA's shared memory; after
// the cluster barrier the C pairs of each (position, lane) are merged with
// one expf each, and the corner adds at most 7 near terms and the skip a
// position, in order.  The cluster size is planned as for the Viterbi
// kernel (ops/logz.py).
//
// Beta (lse_cluster_kernel<false, S>): for one end e the 8 positions of a
// block read s[e, t0:t0+8, lanes], 8 sectors NBp * 4 bytes apart.  A thread
// loads kRound 16-byte pieces into registers ahead of the block and takes
// them two passes a round (the round's max, then independent expf); one
// thread a lane runs the corner.  2 CTAs a lane group at fp32 [696,696,384]
// on an H100 (96 CTAs); about 11 us a block, 0.94 ms.  The forward instance
// of the same body (lse_cluster_kernel<true, S>) is built only by
// scripts/study_cluster_dp.py, as the yardstick of the alpha kernel.
//
// Alpha (alpha_tma_kernel<S>): the far terms of block [k0, k0+8) that CTA
// `rank` owns are s[k0:k0+8, m, lanes] for m = rank (mod C), m < k0: boxes
// of a 3-D tensor map over s ({lanes, begins, ends}, innermost first) with
// elementStrides {1, C, 1}, each 8 ends x kRows owned begins x one row, in
// a ring of kAlphaStages stages in shared memory.  A CTA has three roles:
//  * a producer thread issues the copies (completed on a "full" mbarrier a
//    stage) and reuses a stage once the consumer warps release it (an
//    "empty" mbarrier).  The scores do not depend on the table, so the ring
//    runs a block ahead; no other thread issues a global load for them or
//    waits on the TMA unit.
//  * 8 consumer warps (warp w is position k0 + w) read their rows from the
//    ring, 16 bytes a thread, conflict-free, at one expf a term: the smaller
//    of (max, term) over the larger is exponentiated, and the sum rescaled
//    by it only when the max moves.
//  * a corner thread a (position, lane), on warps of its own, merges its C
//    pairs and takes the block's positions in order: at step j the entry of
//    position j reaches the later positions by a shuffle, and each adds its
//    near term (position j + 1 its skip too).  It runs while the consumers
//    take the next block's rows whose entries were already final; they wait
//    for it (named barrier 2) only before the previous block's own rows.
// The TMA unit strides at most 8 elements and a box traverses at most 256
// along a dimension, so C is at most 8 and a stage traverses kRows * C <=
// 256 begins.
//
// What bounds alpha (scripts/study_cluster_dp.py --phases, an H100 at fp32
// [696,696,384], C = 2): about 4.7 us a block, of which the far pass over
// the older rows is half (about 44 terms a thread), the previous block's
// rows and the warp's merge a third, the cluster barrier a sixth; the
// corner (5600 cycles) is hidden behind the far pass.  0.40 ms in all, 3.6
// times the byte bound; 32-byte rows were measured against 64 and 128.
//
// s is fp32 or bf16 (the template's score type; one exported function
// each).  A bf16 score is converted to fp32 as it is read, which is exact;
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

// The slots of a warp meet (slot = lane / kParts): the max of each lane,
// then the sums rescaled to it.
template <int kParts, int V>
__device__ __forceinline__ void meet_slots(const float (&mx)[V], const float (&acc)[V],
                                           float2 (&pair)[V]) {
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
}

// Warp `warp`'s pairs into buffer `parity` of every CTA of the cluster, in
// the place of CTA `rank` ([2][C][kBlock][G]): slot s stores to CTAs s,
// s + kSlots, ...
template <int kParts, int G, int V>
__device__ __forceinline__ void store_pairs(cg::cluster_group& cluster, float2* parts,
                                            const float2 (&pair)[V], int c, int rank, int parity,
                                            int warp, int slot, int part) {
  for (int to = slot; to < c; to += 32 / kParts) {
    float4* dst = reinterpret_cast<float4*>(cluster.map_shared_rank(parts, to) +
                                            ((parity * c + rank) * kBlock + warp) * G + part * V);
#pragma unroll
    for (int l = 0; l < V; l += 2) {
      dst[l / 2] = make_float4(pair[l].x, pair[l].y, pair[l + 1].x, pair[l + 1].y);
    }
  }
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
    float2 pair[V];
    meet_slots<kParts>(mx, acc, pair);
    const int parity = n & 1;
    store_pairs<kParts, G>(cluster, parts, pair, c, rank, parity, warp, slot, part);
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

// -- alpha: the far scores by TMA ----------------------------------------------

// Bytes of a score row an alpha CTA owns, for fp32 and for bf16 scores.
constexpr int kAlphaRowBytesF32 = 32;
constexpr int kAlphaRowBytesBF16 = 32;
// Stages of the ring: 128 KB, so that one CTA fills an SM (two CTAs an SM
// were slower: scripts/study_cluster_dp.py --sweep).
constexpr int kAlphaStages = 16;
constexpr int kAlphaMaxCluster = 8;  // the TMA unit's largest element stride

template <typename S>
struct AlphaShape {
  static constexpr int kRowBytes = sizeof(S) == 4 ? kAlphaRowBytesF32 : kAlphaRowBytesBF16;
  static constexpr int kGroup = kRowBytes / (int)sizeof(S);  // lanes a CTA
  static constexpr int kPiece = 16 / (int)sizeof(S);         // lanes of one 16-byte read
  static constexpr int kParts = kRowBytes / 16;              // threads that share one row
  static constexpr int kSlots = 32 / kParts;                 // slots of owned begins a warp
  static constexpr int kRows = 2 * kSlots;                   // owned begins a stage, 2 a slot
  static constexpr int kStageBytes = kBlock * kRows * kRowBytes;  // 8 KB
  // threads a CTA: 8 consumer warps, a corner thread a (position, lane), a producer warp
  static constexpr int kCornerThreads = kBlock * kGroup;
  static constexpr int kThreadsAll = kThreads + kCornerThreads + 32;
  static_assert(kRows * kAlphaMaxCluster <= 256, "a box traverses at most 256 elements");
  static_assert(kThreadsAll <= 1024, "threads a CTA");
};

// Dynamic shared memory of the alpha kernel: the ring [stages][kBlock][kRows][G]
// of scores, the two buffers of the C CTAs' (max, sum) pairs [C][kBlock][G],
// the CTA's ceil(tp / C) table rows [G] and the ring's full and empty
// mbarriers.
template <typename S>
__host__ __device__ constexpr size_t alpha_smem_bytes(int tp, int cluster) {
  using A = AlphaShape<S>;
  return (size_t)kAlphaStages * A::kStageBytes + 2 * (size_t)cluster * kBlock * A::kGroup * 8 +
         (size_t)((tp + cluster - 1) / cluster) * A::kGroup * sizeof(float) +
         2 * kAlphaStages * sizeof(uint64_t);
}

// The corner of an alpha block, one thread a (position i, lane): it merges
// the C CTAs' far pairs of its own (position, lane), then takes the block's
// entries in order: at step j the entry of position j reaches the later
// positions by a shuffle among the lane's 8 threads, each adds its near term
// from it (and position j + 1 its skip) to its (max, sum) pair, and position
// j + 1 is final.  A step is a shuffle, three independent expf and a logf.
// Its inputs (the near scores of its own position, noise and spdiag) are
// loaded a block ahead.
template <typename S>
struct ChainCorner {
  float near[kBlock - 1], nz = 0.f, dg = 0.f;
  float carry = 0.f;  // the entry of the previous block's last position

  // the inputs of position k0 + i of block n for lane `col`
  __device__ __forceinline__ void load(const S* s, const float* noise, const float* spdiag, int n,
                                       int i, int tp, int nbp, int col) {
    const int k0 = n * kBlock, k = k0 + i;
    if (k >= tp) return;
    nz = noise[(size_t)k * nbp + col];
    dg = spdiag[(size_t)k * nbp + col];
#pragma unroll
    for (int j = 0; j < kBlock - 1; ++j) {
      if (j < i) near[j] = as_float(s[((size_t)k * tp + k0 + j) * nbp + col]);
    }
  }

  // the entry of position k0 + i of block n from buffer `parity` of the
  // C CTAs' pairs [C][kBlock][G]; the CTA keeps it in `tab` if it owns it,
  // and rank 0 writes the output
  template <int G>
  __device__ __forceinline__ void run(const float2* parts, float* tab, float* out, int n, int i,
                                      int cl, int tp, int nbp, int col, int c, int rank,
                                      int parity) {
    const float neg_inf = __int_as_float(0xff800000);
    const int k = n * kBlock + i;
    const float2* src = parts + (parity * c * kBlock + i) * G + cl;
    float mx = neg_inf;
    for (int r = 0; r < c; ++r) mx = fmaxf(mx, src[r * kBlock * G].x);
    float sum = 0.f;
    for (int r = 0; r < c; ++r) {
      const float2 pr = src[r * kBlock * G];
      sum += pr.y > 0.f ? pr.y * expf(pr.x - mx) : 0.f;
    }
    float q = 0.f;
#pragma unroll
    for (int j = -1; j < kBlock - 1; ++j) {
      const float qj = j < 0 ? carry : __shfl_sync(0xffffffffu, q, j, kBlock);
      const float xn = j >= 0 && i > j ? qj + near[j < 0 ? 0 : j] : neg_inf;  // near term
      const float xs = i == j + 1 && k > 0 ? qj + nz : neg_inf;              // skip
      const float hi = fmaxf(mx, fmaxf(xn, xs));
      sum = (sum > 0.f ? sum * expf(mx - hi) : 0.f) + (xn > neg_inf ? expf(xn - hi) : 0.f) +
            (xs > neg_inf ? expf(xs - hi) : 0.f);
      mx = hi;
      if (i == j + 1) q = k == 0 ? dg : mx + logf(sum + 1e-38f) + dg;
    }
    carry = __shfl_sync(0xffffffffu, q, kBlock - 1, kBlock);
    if (k < tp) {
      if (k % c == rank) tab[(k / c) * G + cl] = q;
      if (rank == 0) out[(size_t)k * nbp + col] = q;
    }
  }
};

// Three roles a CTA, all meeting at one cluster barrier a block:
//  * warps 0-7 consume the ring (warp w is position k0 + w of each block).
//    A block's far pass first takes the rows whose entries were final
//    before the previous block (m < k0 - 8), then waits on named barrier 2
//    for the previous block's corner, then takes the rest (its last one or
//    two stages, which it releases only then), then stores its pairs.
//  * the corner threads (one a position and lane) run block n's corner
//    after the barrier of block n and arrive on named barrier 2, while the
//    consumers take block n + 1's older rows.
//  * lane 0 of the producer warp, after it arrives at the barrier of block
//    n, issues every stage of block n + 1, each once the consumers have
//    released its ring place, and then waits at the barrier; no other
//    thread waits on the TMA unit.  The other lanes exit at once, and so
//    take no part in the barriers.
template <typename S>
__global__ void __launch_bounds__(AlphaShape<S>::kThreadsAll, 1)
    alpha_tma_kernel(const __grid_constant__ CUtensorMap map, const S* __restrict__ s,
                     const float* __restrict__ noise, const float* __restrict__ spdiag,
                     float* __restrict__ out, int tp, int nbp) {
  using A = AlphaShape<S>;
  constexpr int G = A::kGroup, V = A::kPiece, kRows = A::kRows;
  constexpr int kCornerDone = 2, kCornerMeet = kThreads + A::kCornerThreads;  // named barrier
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const S* ring = reinterpret_cast<const S*>(smem);  // [kAlphaStages][kBlock][kRows][G]
  float2* parts = reinterpret_cast<float2*>(smem + kAlphaStages * A::kStageBytes);
  float* tab = reinterpret_cast<float*>(parts + 2 * c * kBlock * G);  // [ceil(tp/C)][G]
  uint64_t* full = reinterpret_cast<uint64_t*>(tab + (tp + c - 1) / c * G);
  uint64_t* empty = full + kAlphaStages;

  const int col0 = (int)(blockIdx.x / c) * G;
  const int nb = (tp + kBlock - 1) / kBlock;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kAlphaStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kBlock);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  const int ct = (int)threadIdx.x - kThreads;  // a corner thread: position ct % 8, lane ct / 8
  const bool corner = ct >= 0 && ct < A::kCornerThreads;
  ChainCorner<S> cn;
  if (corner) cn.load(s, noise, spdiag, 0, ct & (kBlock - 1), tp, nbp, col0 + (ct >> 3));
  cluster.sync();  // every CTA of the cluster running, the mbarriers ready

  if (ct >= A::kCornerThreads) {  // -- the producer
    if (ct == A::kCornerThreads) {
      unsigned head = 0;  // stages issued
      for (int n = 0; n < nb; ++n) {
        cluster_arrive();
        const int stages = n + 1 < nb ? (owned_below((n + 1) * kBlock, rank, c) + kRows - 1) / kRows : 0;
        for (int j = 0; j < stages; ++j, ++head) {
          const int at = (int)(head % kAlphaStages);
          mbar_wait(&empty[at], ((head / kAlphaStages) & 1) ^ 1);
          mbar_arrive_expect(&full[at], A::kStageBytes);
          tma_load_3d(smem + at * A::kStageBytes, &map, &full[at], col0, rank + c * kRows * j,
                      (n + 1) * kBlock);
        }
        cluster_wait();
      }
    }
    return;
  }
  if (corner) {  // -- the corner
    const int i = ct & (kBlock - 1), cl = ct >> 3;
    for (int n = 0; n < nb; ++n) {
      cluster_arrive();
      cluster_wait();
      cn.template run<G>(parts, tab, out, n, i, cl, tp, nbp, col0 + cl, c, rank, n & 1);
      if (n + 1 < nb) {
        named_arrive(kCornerDone, kCornerMeet);
        cn.load(s, noise, spdiag, n + 1, i, tp, nbp, col0 + cl);
      }
    }
    return;
  }

  // -- the consumers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = lane % A::kParts, slot = lane / A::kParts;
  const float neg_inf = __int_as_float(0xff800000);
  unsigned first = 0;  // the ring's stage number of the block's first stage
  for (int n = 0; n < nb; ++n) {
    const int k0 = n * kBlock;
    const int owned = owned_below(k0, rank, c);
    // rows below `fresh` need no entry of the previous block
    const int fresh = n > 0 ? owned_below(k0 - kBlock, rank, c) : 0;
    const int stages = (owned + kRows - 1) / kRows, held = fresh / kRows;  // stages >= held wait
    const bool live = k0 + warp < tp;  // no terms for a position past the end
    // -- far part: (max, sum of exp(x - max)) a lane over the thread's rows
    float mx[V], acc[V];
#pragma unroll
    for (int l = 0; l < V; ++l) {
      mx[l] = neg_inf;
      acc[l] = 0.f;
    }
    // rows [lo, hi) of stage j, which is waited for first when `wait`, and
    // released after when `release`
    auto take = [&](int j, int lo, int hi, bool wait, bool release) {
      const unsigned stage = first + j;
      const int at = (int)(stage % kAlphaStages), u0 = j * kRows;
      if (wait) mbar_wait(&full[at], (stage / kAlphaStages) & 1);
      if (live) {
        const S* rows = ring + ((size_t)(at * kBlock + warp) * kRows) * G + part * V;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int u = slot + A::kSlots * t;  // row of the stage
          if (u0 + u >= lo && u0 + u < hi) {
            float sc[V], q[V];
            unpack(*reinterpret_cast<const uint4*>(rows + u * G), sc, S{});
            load_row(tab + (u0 + u) * G + part * V, q);
#pragma unroll
            for (int l = 0; l < V; ++l) {
              const float x = q[l] + sc[l];
              const float hi_ = fmaxf(mx[l], x);
              const float e = expf(fminf(mx[l], x) - hi_);  // 0 against the first term
              acc[l] = x > mx[l] ? fmaf(acc[l], e, 1.f) : acc[l] + e;
              mx[l] = hi_;
            }
          }
        }
      }
      if (release) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[at]);
      }
    };
    for (int j = 0; j < stages; ++j) take(j, 0, fresh, true, j < held);
    if (n > 0) named_sync(kCornerDone, kCornerMeet);  // the previous block's entries
    for (int j = held; j < stages; ++j) take(j, fresh, owned, false, true);
    first += stages;

    float2 pair[V];
    meet_slots<A::kParts>(mx, acc, pair);
    store_pairs<A::kParts, G>(cluster, parts, pair, c, rank, n & 1, warp, slot, part);
    cluster_arrive();
    cluster_wait();
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
