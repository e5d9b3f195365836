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
// on the order in which the maximum is reduced, as long as every merge keeps
// one rule: the larger value, then the smaller end.  A thread walks its ends
// in descending order and keeps the later of two equal values; the slots of
// a warp and the CTAs of a cluster merge a packed 64-bit key (the value's
// bits made monotonic in the high word, the complement of the end in the low
// word) with an integer max; the corner compares value and end explicitly.
// The CTAs' keys meet by stores into per-source slots, not by remote 64-bit
// atomic max: on the card those lost updates between SMs (tables that
// differed from run to run at every cluster size above 1).
// -0 is taken as +0 in the key: zeros of either sign compare equal, so no
// comparison, and so no pointer, changes.  The tables equal the plain
// PyTorch version exactly.  The build must not use --use_fast_math.
//
// s_t is fp32 or bf16 (one exported function each).  A bf16 score is
// converted to fp32 as it is loaded, which is exact, as the TPU kernel
// upcasts its stripe; q, noise, diag_gate and every add, compare and max
// stay fp32, so the same bf16 bits give the same table as the plain
// version, and tie rules and padding do not change.
//
// What bounds it: the chain of Tp dependent positions, not bytes.  At the
// flagship shape (Tp = 696, 128 lanes) the kernel reads the strict upper
// triangle of the score tensor once (124 MB, 62 MB in bf16), 37 us at the
// card's bandwidth, but every position waits for the one before it.  The
// first port ran that chain position by position, with two 1024-thread
// barriers and a 32-way serial merge each, on NBp/32 blocks (4 SMs at
// NBp = 128): 2.33 ms on an H100.
//
// Design (the shared scheme is in cluster_dp.cuh): the positions go in
// blocks of 8, as the TPU kernel's KP = 8 blocks.  A block's far part (all
// ends e > its positions that are already final) is one parallel pass; its
// 8 x 8 corner runs in one thread a lane with no barrier, each new q pushed
// at once into the best of the block's later positions.  A CTA owns a
// 32-byte sector of lanes (8 fp32, 16 bf16) and the ends e with
// (Tp-1-e) = rank (mod C) of its cluster of C CTAs, so a lane group's ends
// are split over C SMs; C is the largest size of which the card holds all
// NBp / lanes clusters at once (ops/viterbi.py::launch_plan: 6 at fp32
// [696,696,128] on an H100, 96 CTAs).  Each CTA stores its far partials into
// every CTA's shared memory; one cluster barrier (split, with the next
// block's score loads issued between its halves) and two CTA barriers a
// block, 87 blocks at Tp = 696, against 1390 full-block barriers before.
//
// What bounds it now (scripts/study_cluster_dp.py on an H100): about 6 us a
// block, half of it issuing the next block's loads.  Each is a lone 32-byte
// sector, and an SM takes about one every 10 cycles however the rows are cut
// (128-byte rows were slower, an L2 prefetch hint gained 2%); the rest is
// the cluster barrier, the corner and the merge.  The tables cost 0.49 ms at
// [696,696,128] fp32, 13 times the byte bound.

#include "cluster_dp.cuh"

namespace {

// (value, end) -> a key whose unsigned order is: larger value, then smaller
// end.  0 is no candidate.
__device__ __forceinline__ unsigned long long pack_key(float v, int e) {
  const unsigned u = __float_as_uint(v + 0.0f);  // -0 -> +0
  const unsigned o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)o << 32) | (unsigned)(~e);
}
__device__ __forceinline__ void unpack_key(unsigned long long key, float& v, int& e) {
  if (key == 0ull) {
    v = __int_as_float(0xff800000);
    e = INT_MAX;
    return;
  }
  const unsigned o = (unsigned)(key >> 32);
  v = __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
  e = (int)~(unsigned)key;
}

template <typename S>
__global__ void __launch_bounds__(kThreads, 1)
    viterbi_bwd_kernel(const S* __restrict__ s_t,
                       const float* __restrict__ noise,
                       const float* __restrict__ diag_gate,
                       int* __restrict__ ptr, int tp, int nbp) {
  constexpr int G = Lanes<S>::kGroup;
  constexpr int V = Lanes<S>::kPiece;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);  // [2][C][kBlock][G]
  unsigned long long* merged = keys + 2 * c * kBlock * G;                 // [kBlock][G]
  float* qtab = reinterpret_cast<float*>(merged + kBlock * G);            // [ceil(tp/C)][G]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = lane % kParts, slot = lane / kParts;
  const int col0 = (int)(blockIdx.x / c) * G;  // the lane group's first lane
  const int cl = threadIdx.x;                  // a corner thread's lane in the group
  const bool corner = cl < G;
  const int col = col0 + cl;
  const int nb = tp / kBlock;

  // the t-th piece of block n for this thread: position k = k0 + warp
  // (p = Tp-1-k), end e = Tp-1-m with m = rank + C*(slot + kSlots*t)
  auto piece = [&](int n, int t) {
    const int p = tp - 1 - (n * kBlock + warp);
    const int e = tp - 1 - (rank + c * (slot + kSlots * t));
    return s_t + ((size_t)p * tp + e) * nbp + col0 + part * V;
  };
  uint4 buf[kRound];
  float near[kCornerTerms], nz[kBlock], dg[kBlock];
  auto load_corner = [&](int n) {
    const int k0 = n * kBlock;
#pragma unroll
    for (int i = 0; i < kBlock; ++i) {
      const int p = tp - 1 - (k0 + i);
      nz[i] = noise[(size_t)p * nbp + col];
      dg[i] = diag_gate[(size_t)p * nbp + col];
#pragma unroll
      for (int j = 0; j < i; ++j) {
        const int e = tp - 1 - (k0 + j);
        near[i * (i - 1) / 2 + j] = as_float(s_t[((size_t)p * tp + e) * nbp + col]);
      }
    }
  };
  // block 0 has no far part
  if (corner) load_corner(0);
  cluster.sync();  // every CTA of the cluster running

  float carry = 0.f;  // q of the last position of the previous block
  for (int n = 0; n < nb; ++n) {
    const int k0 = n * kBlock;
    const int count = pieces_of_slot(owned_below(k0, rank, c), slot);
    // -- far part: ends e > Tp-1-k0, descending; on a tie the later wins
    float best[V];
    int best_e[V];
#pragma unroll
    for (int l = 0; l < V; ++l) {
      best[l] = __int_as_float(0xff800000);
      best_e[l] = INT_MAX;
    }
    for (int r0 = 0; r0 < count; r0 += kRound) {
      if (r0 > 0) load_pieces(buf, r0, count, [&](int t) { return piece(n, t); });
#pragma unroll
      for (int r = 0; r < kRound; ++r) {
        const int t = r0 + r;
        if (t < count) {
          const int u = slot + kSlots * t;
          const int e = tp - 1 - (rank + c * u);
          float sc[V], q[V];
          unpack(buf[r], sc, S{});
          load_row(qtab + u * G + part * V, q);
#pragma unroll
          for (int l = 0; l < V; ++l) {
            const float v = q[l] + sc[l];
            if (v >= best[l]) {
              best[l] = v;
              best_e[l] = e;
            }
          }
        }
      }
    }
    // the slots of the warp meet; slot s stores the result into CTAs s,
    // s + kSlots, ...
    unsigned long long key[V];
#pragma unroll
    for (int l = 0; l < V; ++l) {
      key[l] = best_e[l] == INT_MAX ? 0ull : pack_key(best[l], best_e[l]);
#pragma unroll
      for (int o = kParts; o < 32; o <<= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, key[l], o);
        key[l] = other > key[l] ? other : key[l];
      }
    }
    const int parity = n & 1;
    for (int to = slot; to < c; to += kSlots) {
      ulonglong2* dst = reinterpret_cast<ulonglong2*>(
          cluster.map_shared_rank(keys, to) +
          ((parity * c + rank) * kBlock + warp) * G + part * V);
#pragma unroll
      for (int l = 0; l < V; l += 2) dst[l / 2] = make_ulonglong2(key[l], key[l + 1]);
    }
    cluster_arrive();
    if (n + 1 < nb) {  // the next block's scores, while this block finishes
      const int next = pieces_of_slot(owned_below(k0 + kBlock, rank, c), slot);
      load_pieces(buf, 0, next, [&](int t) { return piece(n + 1, t); });
    }
    cluster_wait();

    // -- the max of the C CTAs' keys of each (position, lane)
    for (int x = threadIdx.x; x < kBlock * G; x += kThreads) {
      const unsigned long long* src = keys + parity * c * kBlock * G + x;
      unsigned long long m = 0ull;
      for (int r = 0; r < c; ++r) m = src[r * kBlock * G] > m ? src[r * kBlock * G] : m;
      merged[x] = m;
    }
    __syncthreads();

    // -- corner: positions k0 .. k0+7 in order, one thread a lane.  Each new
    // q is pushed at once into the best of every later position of the
    // block, so the step itself is a skip, a max and an add.
    if (corner) {
      float bv[kBlock], qb[kBlock];
      int be[kBlock], pb[kBlock];
#pragma unroll
      for (int i = 0; i < kBlock; ++i) unpack_key(merged[i * G + cl], bv[i], be[i]);
      float prev = carry;
#pragma unroll
      for (int i = 0; i < kBlock; ++i) {
        const int p = tp - 1 - (k0 + i);
        if (k0 + i == 0) {  // p = Tp-1: no interval, no skip
          qb[i] = dg[i];
          pb[i] = -1;
        } else {
          const float skip = prev + nz[i];
          qb[i] = fmaxf(skip, bv[i]) + dg[i];
          pb[i] = skip >= bv[i] ? -1 : be[i] - (p + 1);
        }
        prev = qb[i];
        // p is a near end of every later position; later pushes bring
        // smaller ends, all below the far ones, so ties go to them
#pragma unroll
        for (int j = i + 1; j < kBlock; ++j) {
          const float v = qb[i] + near[j * (j - 1) / 2 + i];
          if (v >= bv[j]) {
            bv[j] = v;
            be[j] = p;
          }
        }
      }
      carry = prev;
#pragma unroll
      for (int i = 0; i < kBlock; ++i) {
        const int m = k0 + i;
        if (m % c == rank) qtab[(m / c) * G + cl] = qb[i];
        if (rank == 0) ptr[(size_t)(tp - 1 - m) * nbp + col] = pb[i];
      }
      if (n + 1 < nb) load_corner(n + 1);
    }
    __syncthreads();
  }
}

// Launches on `stream` as clusters of `cluster` CTAs, allocates nothing and
// does not synchronise.  Returns the cudaError_t of the launch (0 on success).
template <typename S>
int launch_viterbi_bwd(const void* s_t, const void* noise,
                       const void* diag_gate, void* ptr, int tp, int nbp,
                       int cluster, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_clusters(viterbi_bwd_kernel<S>, nbp / Lanes<S>::kGroup * cluster, cluster,
                         cluster_smem_bytes<S>(tp, cluster), stream, (const S*)s_t,
                         (const float*)noise, (const float*)diag_gate, (int*)ptr, tp, nbp);
}

}  // namespace

extern "C" {

// dynamic shared memory of a launch: fp32 scores unless bf16 != 0
long long viterbi_bwd_smem_bytes(int tp, int cluster, int bf16) {
  return (long long)(bf16 ? cluster_smem_bytes<__nv_bfloat16>(tp, cluster)
                          : cluster_smem_bytes<float>(tp, cluster));
}

// clusters of `cluster` CTAs the card holds at once, into *n
int viterbi_bwd_max_clusters(int tp, int cluster, int bf16, int device, int* n) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return bf16 ? max_active_clusters(viterbi_bwd_kernel<__nv_bfloat16>, cluster,
                                    cluster_smem_bytes<__nv_bfloat16>(tp, cluster), n)
              : max_active_clusters(viterbi_bwd_kernel<float>, cluster,
                                    cluster_smem_bytes<float>(tp, cluster), n);
}

const char* viterbi_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// fp32 scores
int viterbi_bwd(const void* s_t, const void* noise, const void* diag_gate,
                void* ptr, int tp, int nbp, int cluster, int device, void* stream) {
  return launch_viterbi_bwd<float>(s_t, noise, diag_gate, ptr, tp, nbp, cluster,
                                   device, stream);
}

// bf16 scores; noise, diag_gate and ptr as above
int viterbi_bwd_bf16(const void* s_t, const void* noise, const void* diag_gate,
                     void* ptr, int tp, int nbp, int cluster, int device, void* stream) {
  return launch_viterbi_bwd<__nv_bfloat16>(s_t, noise, diag_gate, ptr, tp, nbp,
                                           cluster, device, stream);
}

}  // extern "C"
