// Row softmax, forward and backward, on Hopper (sm_90a).
//
// Replaces the TPU kernels _fwd_kernel and _bwd_kernel in
// transkun_tpu/ops/softmax_pallas.py (both called through _rows_call).  For
// l [R, C], fp32 or bf16, rows contiguous:
//
//   forward:   p  = exp(l - rowmax(l)) / rowsum(exp(l - rowmax(l)))
//   backward:  dl = p * (do - rowsum(do * p)),  p recomputed from l
//
// The output has the input's type; max, exp, sum and delta are fp32.
//
// What bounds it: bytes by the count (the forward reads l and writes p once,
// the backward reads l and do and writes dl once), and at fp32 in fact: the
// forward runs at 80% of the card's memory rate, where torch.softmax's own
// kernel runs too.  But the accurate expf and the true division make about
// 200 machine operations a row of 149 values, some 30 us of an SM's schedulers
// against 38 us for the fp32 bytes and 19 us for the bf16 ones: at bf16 the
// operations bind, and at either type whatever adds operations costs
// time, whatever it does for the memory system (see the design note).
//
// Design: a warp per row, 8 rows a block, the row kept in registers
// (lane j holds columns j, j + 32, ...; 5 values a lane at C = 149), one
// shuffle reduction for the maximum and one for the sum (a third for delta
// in the backward), one read and one write of every value.  Loads are
// scalar, 128 contiguous bytes a warp in fp32: a row of 149 values starts
// at no 16-byte boundary.  16-byte accesses were built four ways and
// measured on an H100 SXM (700 W, [106088, 149] fp32 forward, device time;
// this kernel 0.047 ms, torch.softmax 0.047 ms): a block's 8 rows staged in
// shared memory between two __syncthreads (0.068 ms); the 16-byte pieces
// that cover a row held by the lanes as they come, with the neighbours'
// values masked (0.074 ms: 8 values a lane where 5 are the row's); 4
// consecutive rows, a 16-byte-aligned span, staged by one warp in its own
// shared memory (0.051 ms); the same spans moved by the copy engine
// (cp.async.bulk with an mbarrier a buffer, two buffers a warp, no load or
// store operation left: 0.054 ms).  Each moves the same bytes in wider
// accesses and is slower by about the operations it adds to place the
// values where the lane that reduces them wants them, so the scalar loads
// stay.  Rows wider than 256 columns do not fit the
// registers set aside and are read again (from L1/L2) for each pass.  The
// TPU version pads R to a multiple of its 2048-row VMEM block and slices
// the result; here the last block is part full and nothing is padded.
//
// Numerics: the sums run in another order than the plain PyTorch version
// (per-lane partial sums, then a butterfly), so fp32 results agree to
// rounding (1e-6 absolute on probabilities), not bit for bit.  expf and the
// division are the accurate ones: the build must not use --use_fast_math.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "as_float.cuh"

namespace {

constexpr int kWarps = 8;    // rows per block
constexpr int kMaxRegs = 8;  // values a lane keeps: rows up to 256 wide

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The row of this warp, or -1 past the end.  A warp that returns early
// meets no barrier: the kernels use none.
__device__ __forceinline__ long long warp_row(long long rows) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  return row < rows ? row : -1;
}

// Whether column c, the lane's register i of N, lies in the row.  The launch
// picks N = ceil(cols / 32), so only the last register can lie past the end,
// and the others cost no comparison (0.030 against 0.033 ms at [106088, 149]
// bf16 forward on an H100 SXM at 700 W; nothing at fp32).
template <int N>
__device__ __forceinline__ bool in_row(int i, int c, int cols) {
  return i < N - 1 || c < cols;
}

// N > 0: the row lives in N registers a lane.  N == 0: any width, the row
// is read once per pass.
template <typename T, int N>
__global__ void __launch_bounds__(32 * kWarps)
    softmax_fwd_kernel(const T* __restrict__ l, T* __restrict__ out,
                       long long rows, int cols) {
  const long long row = warp_row(rows);
  if (row < 0) return;
  const int lane = threadIdx.x & 31;
  const T* in = l + (size_t)row * cols;
  T* o = out + (size_t)row * cols;
  const float neg_inf = __int_as_float(0xff800000);

  if constexpr (N > 0) {
    float x[N];
    float m = neg_inf;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = lane + 32 * i;
      x[i] = in_row<N>(i, c, cols) ? as_float(in[c]) : neg_inf;
      m = fmaxf(m, x[i]);
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      x[i] = in_row<N>(i, lane + 32 * i, cols) ? expf(x[i] - m) : 0.f;
      s += x[i];
    }
    s = warp_sum(s);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = lane + 32 * i;
      if (in_row<N>(i, c, cols)) store_float(o + c, x[i] / s);
    }
  } else {
    float m = neg_inf;
    for (int c = lane; c < cols; c += 32) m = fmaxf(m, as_float(in[c]));
    m = warp_max(m);
    float s = 0.f;
    for (int c = lane; c < cols; c += 32) s += expf(as_float(in[c]) - m);
    s = warp_sum(s);
    for (int c = lane; c < cols; c += 32) {
      store_float(o + c, expf(as_float(in[c]) - m) / s);
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(32 * kWarps)
    softmax_bwd_kernel(const T* __restrict__ l, const T* __restrict__ dout,
                       T* __restrict__ dl, long long rows, int cols) {
  const long long row = warp_row(rows);
  if (row < 0) return;
  const int lane = threadIdx.x & 31;
  const T* in = l + (size_t)row * cols;
  const T* din = dout + (size_t)row * cols;
  T* o = dl + (size_t)row * cols;
  const float neg_inf = __int_as_float(0xff800000);

  if constexpr (N > 0) {
    float p[N], dp[N];
    float m = neg_inf;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = lane + 32 * i;
      p[i] = in_row<N>(i, c, cols) ? as_float(in[c]) : neg_inf;
      dp[i] = in_row<N>(i, c, cols) ? as_float(din[c]) : 0.f;
      m = fmaxf(m, p[i]);
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      p[i] = in_row<N>(i, lane + 32 * i, cols) ? expf(p[i] - m) : 0.f;
      s += p[i];
    }
    s = warp_sum(s);
    float delta = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      p[i] = p[i] / s;
      delta += dp[i] * p[i];
    }
    delta = warp_sum(delta);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = lane + 32 * i;
      if (in_row<N>(i, c, cols)) store_float(o + c, p[i] * (dp[i] - delta));
    }
  } else {
    float m = neg_inf;
    for (int c = lane; c < cols; c += 32) m = fmaxf(m, as_float(in[c]));
    m = warp_max(m);
    float s = 0.f;
    for (int c = lane; c < cols; c += 32) s += expf(as_float(in[c]) - m);
    s = warp_sum(s);
    float delta = 0.f;
    for (int c = lane; c < cols; c += 32) {
      delta += as_float(din[c]) * (expf(as_float(in[c]) - m) / s);
    }
    delta = warp_sum(delta);
    for (int c = lane; c < cols; c += 32) {
      const float p = expf(as_float(in[c]) - m) / s;
      store_float(o + c, p * (as_float(din[c]) - delta));
    }
  }
}

// One launch with the register count that fits `cols`.
#define SOFTMAX_ROWS_DISPATCH(KERNEL, ...)                                   \
  switch ((cols + 31) / 32) {                                                \
    case 1: KERNEL<T, 1><<<grid, block, 0, s>>>(__VA_ARGS__); break;         \
    case 2: KERNEL<T, 2><<<grid, block, 0, s>>>(__VA_ARGS__); break;         \
    case 3: KERNEL<T, 3><<<grid, block, 0, s>>>(__VA_ARGS__); break;         \
    case 4: KERNEL<T, 4><<<grid, block, 0, s>>>(__VA_ARGS__); break;         \
    case 5: KERNEL<T, 5><<<grid, block, 0, s>>>(__VA_ARGS__); break;         \
    case 6: KERNEL<T, 6><<<grid, block, 0, s>>>(__VA_ARGS__); break;         \
    case 7: KERNEL<T, 7><<<grid, block, 0, s>>>(__VA_ARGS__); break;         \
    case 8: KERNEL<T, 8><<<grid, block, 0, s>>>(__VA_ARGS__); break;         \
    default: KERNEL<T, 0><<<grid, block, 0, s>>>(__VA_ARGS__); break;        \
  }
static_assert(kMaxRegs == 8, "the dispatch lists the cases 1..kMaxRegs");

// Both launch on `stream`, allocate nothing and do not synchronise, and
// return the cudaError_t of the launch (0 on success).
template <typename T>
int launch_fwd(const void* l, void* out, long long rows, int cols, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (rows < 1 || cols < 1 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block(32 * kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  SOFTMAX_ROWS_DISPATCH(softmax_fwd_kernel, (const T*)l, (T*)out, rows, cols)
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* l, const void* dout, void* dl, long long rows,
               int cols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (rows < 1 || cols < 1 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block(32 * kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  SOFTMAX_ROWS_DISPATCH(softmax_bwd_kernel, (const T*)l, (const T*)dout, (T*)dl,
                        rows, cols)
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* softmax_rows_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int softmax_rows_fwd_f32(const void* l, void* out, long long rows, int cols,
                         int device, void* stream) {
  return launch_fwd<float>(l, out, rows, cols, device, stream);
}

int softmax_rows_fwd_bf16(const void* l, void* out, long long rows, int cols,
                          int device, void* stream) {
  return launch_fwd<__nv_bfloat16>(l, out, rows, cols, device, stream);
}

int softmax_rows_bwd_f32(const void* l, const void* dout, void* dl,
                         long long rows, int cols, int device, void* stream) {
  return launch_bwd<float>(l, dout, dl, rows, cols, device, stream);
}

int softmax_rows_bwd_bf16(const void* l, const void* dout, void* dl,
                          long long rows, int cols, int device, void* stream) {
  return launch_bwd<__nv_bfloat16>(l, dout, dl, rows, cols, device, stream);
}

}  // extern "C"
