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
// and it writes the events into begins/ends [n, P, k_max], which the caller
// zero-fills (the plain version's one-hot sums leave zeros past the count),
// and the last start into start_out [P], which the next group's launch
// reads.  All integer work: the result equals the plain PyTorch version
// exactly.
//
// What bounds it: the chain of dependent loads.  A step reads ptr[j] and
// diag[j] at the cursor, and the next cursor is known only when the load is
// back, so a track costs one load latency a visited position: up to t-1 a
// segment (t = 691 at the flagship's 16 s), in practice its events and
// skips, and the group's segments one after the other.  The bytes are
// small: the group's tables ([t-1, 90] int32 and [t, 90] bool a segment,
// 0.31 MB) at 3.35 TB/s take 0.1 us a segment, and the walk reads only the
// visited positions.  On the flagship's 64 s piece (an H100, 700 W) a group
// of 4 segments visits 5184 positions, at most 100 on one track, and takes
// 0.051-0.062 ms: 512-620 ns a chain step, against a byte bound of 0.12 us.
//
// Design: the simple one.  One thread a track, one launch a group; the
// threads of a warp walk their tracks side by side, so a row of ptr (90
// int32, three 128-byte lines) serves the tracks whose cursors share it.
// The zeros past each track's events are not written here: a thread's
// k_max slots lie 4 * k_max bytes from its neighbour's, so a warp's store
// of one slot touches 32 sectors; the wrapper's two memsets write them
// coalesced.  Reading a track's column into shared memory first, or
// splitting a walk, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
decode_walk_kernel(const int* __restrict__ ptr, const uint8_t* __restrict__ diag,
                   const uint8_t* __restrict__ bpres, const int* __restrict__ start_in,
                   int* __restrict__ begins, int* __restrict__ ends,
                   int* __restrict__ count, uint8_t* __restrict__ overflow,
                   int* __restrict__ start_out, int n, int t, int p, int n_edge,
                   int k_max, int last_frame_idx, int step_frames, int onset_bound) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p) return;
  int start = start_in[b];
  for (int s = 0; s < n; ++s) {
    const int* ptr_s = ptr + (size_t)s * (t - 1) * p + b;
    const uint8_t* diag_s = diag + (size_t)s * t * p + b;
    const uint8_t* bp = bpres + ((size_t)s * p + b) * t * n_edge;
    const size_t row = ((size_t)s * p + b) * k_max;
    int* beg = begins + row;
    int* end = ends + row;
    int k = 0;
    int last_p = 0;
    auto emit = [&](int bb, int ee) {
      if (k < k_max) {
        beg[k] = bb;
        end[k] = ee;
        if (onset_bound < 0 || bb < onset_bound) {
          const int edge = min(max(ee - last_frame_idx, 0), n_edge - 1);
          if (ee < last_frame_idx || bp[(size_t)bb * n_edge + edge]) last_p = max(last_p, ee);
        }
      }
      ++k;
    };
    int j = start;
    while (j < t - 1) {
      const int sel = ptr_s[(size_t)j * p];
      if (diag_s[(size_t)j * p]) emit(j, j);
      if (sel < 0) {
        j += 1;
      } else {
        const int e = j + 1 + sel;
        emit(j, e);
        j = e;
      }
    }
    if (j == t - 1 && diag_s[(size_t)(t - 1) * p]) emit(t - 1, t - 1);
    count[s * p + b] = min(k, k_max);
    overflow[s * p + b] = k > k_max;
    start = max(last_p - step_frames, 0);
  }
  start_out[b] = start;
}

}  // namespace

extern "C" {

const char* decode_walk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches on `stream`, allocates nothing and does not synchronise.  ptr
// [n, t-1, p] int32, diag [n, t, p] and bpres [n, p, t, n_edge] bytes (0 or
// 1), start_in [p] int32; begins and ends [n, p, k_max] int32, zero-filled,
// count [n, p] int32, overflow [n, p] bytes, start_out [p] int32, all
// contiguous.
// Returns the cudaError_t of the launch (0 on success).
int decode_walk(const void* ptr, const void* diag, const void* bpres, const void* start_in,
                void* begins, void* ends, void* count, void* overflow, void* start_out,
                int n, int t, int p, int n_edge, int k_max, int last_frame_idx,
                int step_frames, int onset_bound, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p + kThreads - 1) / kThreads;
  decode_walk_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)ptr, (const uint8_t*)diag, (const uint8_t*)bpres, (const int*)start_in,
      (int*)begins, (int*)ends, (int*)count, (uint8_t*)overflow, (int*)start_out, n, t, p,
      n_edge, k_max, last_frame_idx, step_frames, onset_bound);
  return (int)cudaGetLastError();
}

}  // extern "C"
