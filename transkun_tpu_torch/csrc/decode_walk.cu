// The stitching chain of one group of segments on Hopper (sm_90a): pointer
// walk, events, lastP and the next segment's forced start, for every track.
//
// Not a TPU kernel's port: it replaces XLA code of the JAX package, the
// lax.scan walk_backward_device (transkun_tpu/ops/semicrf.py:450) and the
// per-segment chain around it in TransKun._fused_group_traced
// (transkun_tpu/models/transkun.py:1031-1063).  For each track b and each
// segment s of the group, in order:
//
//   j = start[b]; while j < t-1:                 (backtrack_backward's walk)
//     if diag[s, j, b]: emit (j, j)
//     j = ptr[s, j, b] < 0 ? j+1 : emit (j, j+1+ptr), then j+1+ptr
//   if j == t-1 and diag[s, t-1, b]: emit (t-1, t-1)
//   count[s, b] = min(events, k_max), overflow[s, b] = events > k_max
//   lastP = max end of the first k_max events with begin < onset_bound
//           (if onset_bound >= 0) whose offset is real: end < last_frame_idx,
//           or bpres[s, b, begin, min(end - last_frame_idx, n_edge-1)]
//   start[b] = max(lastP - step_frames, 0)      (the next segment's start)
//
// and it writes begins/ends [n, P, k_max] (the events, then zeros past the
// count, as the plain version's one-hot sums leave them), count, overflow,
// and the last start into start_out [P], which the next group's launch
// reads.  All integer work: the result equals the plain PyTorch version
// exactly.  A negative start walks nothing, as in the plain version.
//
// What bounds it: the chain of dependent loads.  A step reads ptr[j] and
// diag[j] at the cursor, and the next cursor is known only when the load is
// back: a track costs one load latency a visited position, its segments one
// after the other.  A track visits ~14 positions a segment (an interval
// jumps to its end); on the flagship's 64 s piece a group of 4 segments
// visits 5184 positions, at most 100 on one track.  The bytes the walk
// needs are few (its byte bound is 0.12 us).  The first version of this
// kernel read each step from global memory, one thread a track in one
// block: 44-45 us of device time a group with its two memsets, 443-452 ns a
// chain step (an H100, 700 W; chip_smoke.py --parent).
//
// Design:
//   * A CTA takes a tile of `tile` tracks (a power of two, at most 32;
//     ops/walk.py's TILE: one, by measurement; scripts/study_walk.py
//     sweeps the others), so the grid
//     is ceil(P / tile) CTAs; the last tile may be ragged.  Warp 0 walks,
//     one lane a track; warps 1-3 stage the tables and write the outputs.
//     They meet on mbarriers, so neither waits for the other beyond what it
//     needs.
//   * The stagers copy the tile's columns of ptr ([t-1, tile] int32 a
//     segment) and diag ([t, tile] bytes) and its run of bpres into shared
//     memory with 4-byte cp.async, a ring of `slots` segments (all n where
//     they fit), each completed on its "full" mbarrier: the walk of segment
//     0 starts when its rows have landed (those below the tile's least
//     start are never read, and not copied), and the later segments' copies
//     fly under it.  No tensor map fits these tensors (a row of ptr is 4P =
//     360 bytes, of diag P = 90: TMA needs global strides that are
//     multiples of 16).  A tile's diag bytes start at any byte: a row is
//     copied as the aligned words that cover them (an aligned word holding
//     a byte of the tensor lies in its allocation), and the reader adds the
//     row's offset in its first word; so is the bpres run.  A CTA reads a
//     sector or two of every row whatever its tile, so a wider tile only
//     adds bytes and walks to a CTA.
//   * A chain step is then one shared-memory load of ptr at the cursor and
//     the few integer operations that make the next cursor and its
//     address; diag is read beside it, the next step's loads go out before
//     this step's events are stored, and the first k_max events are stored
//     as (begin, end) pairs without branching.  lastP is found after the
//     walk, from the last kept event back (ends rise along a track), its
//     presence bits in shared memory.
//   * Once segment s is walked the stagers write its rows out coalesced,
//     the zeros past the count included, while warp 0 walks segment s+1
//     (two event buffers, by segment parity); so the wrapper allocates
//     begins and ends with torch.empty: one launch a group, no memset.
//     Where the buffer does not fit (a large k_max), the walkers store
//     events to global memory and the stagers write only the zeros.  Where
//     not even one segment of one track's columns fits, the walk reads
//     global memory as the first version did (slots = 0).
//
// Measured on the flagship's first group (an H100, 700 W;
// scripts/study_walk.py): 9.4 us of device time at one track a CTA (19.5 us
// at 8).  By the clock64 marks a CTA's walker spends 8.5k cycles walking
// (158 a warp step: 111 in the loop, whose chain is a shared-memory load
// and six dependent integer operations, the rest each segment's set-up and
// tail) and 5.1k waiting for rows, most of it for segment 0's; its
// stagers spend 10.7k cycles issuing the copies, under the walk.
//
// Building with -DDECODE_WALK_PHASES adds clock64 marks at the phases
// (scripts/study_walk.py); the build the port loads has none.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_dp.cuh"  // the mbarrier primitives

namespace {

constexpr int kWalkThreads = 128;             // warp 0 walks; warps 1-3 stage and flush
constexpr int kStagers = kWalkThreads - 32;
constexpr int kMaxTile = 32;

#ifdef DECODE_WALK_PHASES
// per CTA: cycles of warp 0 waiting for rows and free buffers, walking
// (until its last walker is done), and in all; of warp 1's first thread
// issuing the first copies, waiting for walks, refilling the ring,
// flushing; the walker warp's steps (each segment's longest walk, summed);
// launches; then warp 0's cycles walking and its steps in each of the
// first 4 segments; and its cycles in the chain's loop (the slowest lane's,
// summed over segments)
constexpr int kPhases = 18;
constexpr int kPhaseBlocks = 4096;
__device__ unsigned long long walk_phase_cycles[kPhaseBlocks * kPhases];
#define PHASE_CLOCK(v) const long long v = clock64()
#define PHASE_ADD(i, v) \
  if (blockIdx.x < kPhaseBlocks) atomicAdd(&walk_phase_cycles[blockIdx.x * kPhases + (i)], (unsigned long long)(v))
#else
#define PHASE_CLOCK(v)
#define PHASE_ADD(i, v)
#endif

// Shared memory of a launch, in this order: mbarriers (full [slots],
// walked [2], flushed [2]) and counts [2][tile] int32, padded to 16 bytes;
// event buffers [2 parities][tile][k_max] (begin, end) int32 pairs (if
// buffered); then by ring slot: ptr rows [t-1][tile] int32, diag rows
// [t][diag_row] bytes, and the tile's run of bpres [tile][t][n_edge] bytes
// as the aligned words that cover it.
__host__ __device__ inline int diag_row_bytes(int tile) { return 4 * ((tile + 6) / 4); }

__host__ __device__ inline int bpres_bytes(int tile, int t, int n_edge) { return 4 * ((tile * t * n_edge + 6) / 4); }

__host__ __device__ inline int header_bytes(int tile, int slots) {
  return (8 * (slots + 4) + 8 * tile + 15) / 16 * 16;
}

__host__ __device__ inline size_t slot_bytes(int t, int tile, int n_edge) {
  return (size_t)(t - 1) * tile * 4 + (size_t)t * diag_row_bytes(tile) + bpres_bytes(tile, t, n_edge);
}

__host__ __device__ inline size_t smem_bytes(int t, int tile, int slots, bool buffered, int k_max, int n_edge) {
  return (size_t)header_bytes(tile, slots) + (buffered ? (size_t)16 * tile * k_max : 0) +
         (size_t)slots * slot_bytes(t, tile, n_edge);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_address(smem)), "l"(gmem) : "memory");
}

// arrive on `bar` once this thread's copies issued so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_address(bar)) : "memory");
}

// The byte of a run copied as the aligned words that cover it: its first
// byte lies `run & 3` bytes into the copy.
__device__ __forceinline__ int word_offset(const void* run) { return (int)((uintptr_t)run & 3); }

struct Args {
  const int* ptr;
  const uint8_t* diag;
  const uint8_t* bpres;
  const int* start_in;
  int* begins;
  int* ends;
  int* count;
  uint8_t* overflow;
  int* start_out;
  int n, t, p, n_edge, k_max, last_frame_idx, step_frames, onset_bound;
  int log_tile, slots;
};

template <bool kStaged, bool kBuffered>
__global__ void __launch_bounds__(kWalkThreads) decode_walk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = 1 << a.log_tile;
  const int b0 = blockIdx.x * tile;
  const int tw = min(tile, a.p - b0);  // real tracks of this tile
  const int t = a.t, p = a.p, k_max = a.k_max, n_edge = a.n_edge, slots = kStaged ? a.slots : 0;
  const int ring_slots = max(slots, 1);  // segment s stages into slot s % ring_slots
  const int drow = diag_row_bytes(tile);
  const size_t slot_size = slot_bytes(t, tile, n_edge);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* walked = full + slots;
  uint64_t* flushed = walked + 2;
  int* cnt_s = reinterpret_cast<int*>(flushed + 2);
  int2* buf = reinterpret_cast<int2*>(smem + header_bytes(tile, slots));  // 16-byte aligned
  unsigned char* ring = reinterpret_cast<unsigned char*>(buf + (kBuffered ? 2 * tile * k_max : 0));
  // ring slot q's ptr rows, diag rows and bpres run
  auto ptr_slot = [&](int q) { return reinterpret_cast<int*>(ring + q * slot_size); };
  auto diag_slot = [&](int q) { return ring + q * slot_size + (size_t)(t - 1) * tile * 4; };
  auto bp_slot = [&](int q) { return diag_slot(q) + (size_t)t * drow; };
  const int tid = threadIdx.x, lane = tid & 31;
  PHASE_CLOCK(c_start);
  if (tid == 0) {
    for (int q = 0; q < slots; ++q) mbar_init(&full[q], kStagers);
    for (int h = 0; h < 2; ++h) {
      mbar_init(&walked[h], 1);
      mbar_init(&flushed[h], kStagers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 32) {  // -- warp 0: the walk, one lane a track ----------------
    int start = lane < tw ? a.start_in[b0 + lane] : 0;
#ifdef DECODE_WALK_PHASES
    long long waiting = 0, walking = 0, warp_steps = 0;
#endif
    for (int s = 0; s < a.n; ++s) {
      PHASE_CLOCK(c_wait);
      if (s >= 2) mbar_wait(&flushed[s & 1], ((s >> 1) & 1) ^ 1);  // segment s-2 written out
      if (kStaged) mbar_wait(&full[s % ring_slots], (s / ring_slots) & 1);  // segment s's rows landed
#ifdef DECODE_WALK_PHASES
      PHASE_CLOCK(c_walk);
      waiting += c_walk - c_wait;
      int steps = 0;
      unsigned loop_cycles = 0;
#endif
      if (lane < tw) {
        const int c = lane, b = b0 + lane, q = s % ring_slots;
        const uint8_t* run = a.bpres + ((size_t)s * p + b0) * t * n_edge;  // the tile's bpres
        const int* P = kStaged ? ptr_slot(q) + c : a.ptr + (size_t)s * (t - 1) * p + b;
        const uint8_t* D = kStaged ? diag_slot(q) + c : a.diag + (size_t)s * t * p + b;
        const uint8_t* bp = (kStaged ? bp_slot(q) + word_offset(run) : run) + (size_t)c * t * n_edge;
        // the chain's address arithmetic in one multiply-add a step
        const char* Pb = reinterpret_cast<const char*>(P);
        const int pbytes = 4 * (kStaged ? tile : p);
        // a staged diag row starts at its first byte's offset in its word
        const int dsh = word_offset(a.diag + (size_t)s * t * p + b0), p4 = p & 3;
        auto diag_at = [&](int j) -> int {
          return kStaged ? D[j * drow + ((dsh + (j & 3) * p4) & 3)] != 0 : D[(size_t)j * p] != 0;
        };
        int2* ev = buf + ((s & 1) * tile + c) * k_max;  // buffered: (begin, end) pairs
        int* gb = a.begins + ((size_t)s * p + b) * k_max;   // else straight to the outputs
        int* ge = a.ends + ((size_t)s * p + b) * k_max;
        auto put = [&](int i, int bb, int e) {
          if (kBuffered) {
            ev[i] = make_int2(bb, e);
          } else {
            gb[i] = bb;
            ge[i] = e;
          }
        };
        // the chain: only the load of ptr at the cursor is on its path.  The
        // next step's loads go out before this step's events are stored (a
        // compiler cannot move a load of shared memory above a store there),
        // and the first k_max events are stored as they come, none of them
        // branched on
        auto sel_at = [&](int j) { return *reinterpret_cast<const int*>(Pb + j * pbytes); };
        int k = 0, j = start < 0 ? t : start;
        int sel = sel_at(min(j, t - 2)), single = diag_at(min(j, t - 1));
#ifdef DECODE_WALK_PHASES
        PHASE_CLOCK(c_loop);
#endif
        while (j < t - 1) {
#ifdef DECODE_WALK_PHASES
          ++steps;
#endif
          const int next = j + 1 + max(sel, 0);
          const int sel_next = sel_at(min(next, t - 2)), single_next = diag_at(min(next, t - 1));
          if (single && k < k_max) put(k, j, j);
          k += single;
          if (sel >= 0 && k < k_max) put(k, j, next);
          k += sel >= 0;
          j = next;
          sel = sel_next;
          single = single_next;
        }
#ifdef DECODE_WALK_PHASES
        PHASE_CLOCK(c_looped);
        loop_cycles = (unsigned)(c_looped - c_loop);
#endif
        if (j == t - 1 && single) {  // the last position's singleton
          if (k < k_max) put(k, t - 1, t - 1);
          ++k;
        }
        // lastP: ends rise along a track, so it is the end of the last kept
        // event that begins under the onset bound and whose offset is real
        int last_p = 0;
        for (int i = min(k, k_max) - 1; i >= 0; --i) {
          const int2 event = kBuffered ? ev[i] : make_int2(gb[i], ge[i]);
          if (a.onset_bound >= 0 && event.x >= a.onset_bound) continue;
          if (event.y < a.last_frame_idx ||
              bp[event.x * n_edge + min(event.y - a.last_frame_idx, n_edge - 1)]) {
            last_p = event.y;
            break;
          }
        }
        cnt_s[(s & 1) * tile + c] = min(k, k_max);
        a.count[s * p + b] = min(k, k_max);
        a.overflow[s * p + b] = k > k_max;
        start = max(last_p - a.step_frames, 0);
      }
#ifdef DECODE_WALK_PHASES
      const int seg_steps = __reduce_max_sync(0xffffffffu, steps);
      warp_steps += seg_steps;
      const unsigned seg_loop = __reduce_max_sync(0xffffffffu, loop_cycles);
#endif
      __syncwarp();
#ifdef DECODE_WALK_PHASES
      PHASE_CLOCK(c_walked);
      walking += c_walked - c_walk;
      if (lane == 0 && s < 4) {
        PHASE_ADD(9 + s, c_walked - c_walk);
        PHASE_ADD(13 + s, seg_steps);
      }
      if (lane == 0) PHASE_ADD(17, seg_loop);
#endif
      if (lane == 0) mbar_arrive(&walked[s & 1]);
    }
    if (lane < tw) a.start_out[b0 + lane] = start;
#ifdef DECODE_WALK_PHASES
    PHASE_CLOCK(c_end);
    if (lane == 0) {
      PHASE_ADD(0, waiting);
      PHASE_ADD(1, walking);
      PHASE_ADD(2, c_end - c_start);
      PHASE_ADD(7, warp_steps);
      PHASE_ADD(8, 1);
    }
#endif
    return;
  }

  // -- warps 1-3: staging and the outputs --------------------------------
  const int st = tid - 32;
  const int words_max = drow / 4;

  // copy segment s's columns of this tile from row r0 on, and its bpres run,
  // into ring slot q, completed on full[q]
  auto stage = [&](int s, int q, int r0) {
    const int* src = a.ptr + (size_t)s * (t - 1) * p + b0;
    int* dst = ptr_slot(q);
    for (int i = r0 * tile + st; i < (t - 1) * tile; i += kStagers) {
      const int r = i >> a.log_tile, c = i & (tile - 1);
      if (c < tw) cp_async4(dst + i, src + (size_t)r * p + c);
    }
    // consecutive threads take consecutive words of a row, then the next row
    const uint8_t* rows = a.diag + (size_t)s * t * p + b0;
    uint8_t* out = diag_slot(q);
    for (int i = r0 * words_max + st; i < t * words_max; i += kStagers) {
      const int r = i / words_max, w = i - r * words_max;
      const uint8_t* row = rows + (size_t)r * p;
      if (w < ((word_offset(row) + tw + 3) >> 2)) cp_async4(out + r * drow + 4 * w, row - word_offset(row) + 4 * w);
    }
    const uint8_t* run = a.bpres + ((size_t)s * p + b0) * t * n_edge;
    const int run_words = (word_offset(run) + tw * t * n_edge + 3) >> 2;
    for (int w = st; w < run_words; w += kStagers) cp_async4(bp_slot(q) + 4 * w, run - word_offset(run) + 4 * w);
    cp_async_arrive(&full[q]);
  };

  // write segment seg's rows of begins/ends for this tile: the buffered
  // events and zeros past the count (the tile's rows are one contiguous run)
  auto flush = [&](int seg) {
    const int h = seg & 1;
    const size_t out = ((size_t)seg * p + b0) * k_max;
    const int total = tw * k_max;
    const int2* ev = buf + h * tile * k_max;
    if (k_max % 4 == 0) {  // 16-byte stores: a row of k_max ints starts 16-byte aligned
      for (int i = 4 * st; i < total; i += 4 * kStagers) {
        const int c = i / k_max, k = i - c * k_max, kept = cnt_s[h * tile + c];
        if (kBuffered) {
          const int4 x = *reinterpret_cast<const int4*>(ev + i), y = *reinterpret_cast<const int4*>(ev + i + 2);
          *reinterpret_cast<int4*>(a.begins + out + i) = make_int4(
              k < kept ? x.x : 0, k + 1 < kept ? x.z : 0, k + 2 < kept ? y.x : 0, k + 3 < kept ? y.z : 0);
          *reinterpret_cast<int4*>(a.ends + out + i) = make_int4(
              k < kept ? x.y : 0, k + 1 < kept ? x.w : 0, k + 2 < kept ? y.y : 0, k + 3 < kept ? y.w : 0);
        } else {
          for (int v = 0; v < 4; ++v) {
            if (k + v >= kept) {
              a.begins[out + i + v] = 0;
              a.ends[out + i + v] = 0;
            }
          }
        }
      }
    } else {
      for (int i = st; i < total; i += kStagers) {
        const int c = i / k_max, k = i - c * k_max, kept = cnt_s[h * tile + c];
        if (kBuffered) {
          a.begins[out + i] = k < kept ? ev[i].x : 0;
          a.ends[out + i] = k < kept ? ev[i].y : 0;
        } else if (k >= kept) {
          a.begins[out + i] = 0;
          a.ends[out + i] = 0;
        }
      }
    }
  };

#ifdef DECODE_WALK_PHASES
  long long waiting = 0, refilling = 0, flushing = 0;
#endif
  // segment 0's walks start at the known starts: no row below the least is read
  int least = lane < tw ? a.start_in[b0 + lane] : INT_MAX;
  least = min(max(__reduce_min_sync(0xffffffffu, least), 0), t - 1);
  for (int q = 0; q < min(slots, a.n); ++q) stage(q, q, q == 0 ? least : 0);
  PHASE_CLOCK(c_staged);
  for (int f = 0; f < a.n; ++f) {
    PHASE_CLOCK(c_wait);
    mbar_wait(&walked[f & 1], (f >> 1) & 1);  // segment f walked: its slot and buffer are done
    PHASE_CLOCK(c_refill);
    if (kStaged && f + slots < a.n) stage(f + slots, f % ring_slots, 0);
    PHASE_CLOCK(c_flush);
    flush(f);
    mbar_arrive(&flushed[f & 1]);
#ifdef DECODE_WALK_PHASES
    PHASE_CLOCK(c_flushed);
    waiting += c_refill - c_wait;
    refilling += c_flush - c_refill;
    flushing += c_flushed - c_flush;
#endif
  }
#ifdef DECODE_WALK_PHASES
  if (st == 0) {
    PHASE_ADD(3, c_staged - c_start);
    PHASE_ADD(4, waiting);
    PHASE_ADD(5, refilling);
    PHASE_ADD(6, flushing);
  }
#endif
}

template <bool kStaged, bool kBuffered>
cudaError_t launch_walk(const Args& a, int blocks, size_t smem, cudaStream_t stream) {
  // the opt-in above 48 KB (set at each launch: it holds for the current device)
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(decode_walk_kernel<kStaged, kBuffered>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  decode_walk_kernel<kStaged, kBuffered><<<blocks, kWalkThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* decode_walk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared memory of a launch with this plan (ops/walk.py holds the
// same formula in smem_bytes).
long long decode_walk_smem_bytes(int t, int tile, int slots, int buffered, int k_max, int n_edge) {
  return (long long)smem_bytes(t, tile, slots, buffered != 0, k_max, n_edge);
}

// Launches on `stream`, allocates nothing and does not synchronise.  ptr
// [n, t-1, p] int32, diag [n, t, p] and bpres [n, p, t, n_edge] bytes (0 or
// 1), start_in [p] int32; begins and ends [n, p, k_max] int32 (every slot
// written), count [n, p] int32, overflow [n, p] bytes, start_out [p] int32,
// all contiguous.  The plan: `log_tile` (tracks a CTA: 1 << log_tile, at
// most 32), `slots` (segments staged in shared memory at once; 0 reads the
// tables from global memory), `buffered` (events through shared memory).
// Returns the cudaError_t of the launch (0 on success).
int decode_walk(const void* ptr, const void* diag, const void* bpres, const void* start_in,
                void* begins, void* ends, void* count, void* overflow, void* start_out,
                int n, int t, int p, int n_edge, int k_max, int last_frame_idx,
                int step_frames, int onset_bound, int log_tile, int slots, int buffered,
                int device, void* stream) {
  if (log_tile < 0 || (1 << log_tile) > kMaxTile || slots < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{(const int*)ptr, (const uint8_t*)diag, (const uint8_t*)bpres, (const int*)start_in,
               (int*)begins, (int*)ends, (int*)count, (uint8_t*)overflow, (int*)start_out,
               n, t, p, n_edge, k_max, last_frame_idx, step_frames, onset_bound, log_tile, slots};
  const int tile = 1 << log_tile;
  const int blocks = (p + tile - 1) / tile;
  const size_t smem = smem_bytes(t, tile, slots, buffered != 0, k_max, n_edge);
  cudaStream_t s = (cudaStream_t)stream;
  if (slots > 0) {
    err = buffered ? launch_walk<true, true>(a, blocks, smem, s) : launch_walk<true, false>(a, blocks, smem, s);
  } else {
    err = buffered ? launch_walk<false, true>(a, blocks, smem, s) : launch_walk<false, false>(a, blocks, smem, s);
  }
  return (int)err;
}

#ifdef DECODE_WALK_PHASES
int decode_walk_phases_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, walk_phase_cycles, sizeof(walk_phase_cycles));
}

int decode_walk_phases_zero() {
  static unsigned long long zero[kPhaseBlocks * kPhases];
  return (int)cudaMemcpyToSymbol(walk_phase_cycles, zero, sizeof(zero));
}
#endif

}  // extern "C"
