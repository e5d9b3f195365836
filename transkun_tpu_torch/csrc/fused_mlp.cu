// Fused MLP forward on Hopper (sm_90a): out = gelu(x w1 + b1) w2 + b2 with
// the exact-erf GELU, the hidden activation never leaving the chip.
//
// Replaces the TPU kernel _mlp_kernel in transkun_tpu/ops/mlp_pallas.py
// (called through _mlp_fwd_call / fused_mlp).  x [M, D], w1 [D, hidden],
// b1 [hidden], w2 [hidden, D], b2 [D], all fp32 and row-major.  Both products
// are computed here, in fp32 FMAs on the CUDA cores (TF32 would not keep the
// 1e-5 agreement the tests ask of fp32).  GELU uses erff: the TPU kernel's
// rational erf approximation exists only because its compiler has no erf.
//
// What bounds it: operations.  At the flagship shape (M = 13261, D = 256,
// hidden = 1024) it does 13.9 GFLOP on 29 MB of inputs and outputs; the
// [M, 1024] hidden activation (54 MB written and read back by the unfused
// route) stays in shared memory.
//
// Design: the weights (1 MB each) do not fit in a block's shared memory as
// they fit in VMEM, so a block owns a tile of 64 rows of x, held in shared
// memory for the whole kernel, and walks the hidden units in chunks of 64.
// For a chunk it loads w1[:, chunk] and w2[chunk, :] (through L2, which
// holds both matrices), forms the [64, 64] hidden tile with a 4x4 register
// tile per thread, adds b1, applies GELU, parks the tile in shared memory,
// and adds its product with w2[chunk, :] into the [64, D] output
// accumulators, an 8 x (D/32) register tile per thread that lives across all
// chunks.  Shared-memory reads are float4; rows of x and of the hidden tile
// carry 4 floats of padding so that the two rows a warp reads at once fall
// on different banks.  256 threads, one block per SM (210 KB of shared
// memory at D = 256).  The last row tile is guarded: rows past M are loaded
// as zeros and not stored.  Faster later: double-buffered weight chunks
// (cp.async or TMA) so loads overlap the FMAs, and 3xTF32 or bf16 wgmma once
// a lower-precision route is ported.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 64;     // rows of x per block
constexpr int kChunk = 64;    // hidden units per step
constexpr int kThreads = 256;
constexpr int kPad = 4;       // floats of padding per shared-memory row

template <int NV>  // D = 128 * NV
constexpr size_t smem_bytes() {
  constexpr int D = 128 * NV;
  return ((size_t)kRows * (D + kPad) + (size_t)2 * D * kChunk +
          (size_t)kRows * (kChunk + kPad)) * sizeof(float);
}

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752440f));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float component(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

template <int NV>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out,
                     int m, int hidden) {
  constexpr int D = 128 * NV;
  constexpr int LDX = D + kPad;
  constexpr int LDG = kChunk + kPad;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [kRows][LDX]
  float* w1s = xs + kRows * LDX;    // [D][kChunk]
  float* w2s = w1s + D * kChunk;    // [kChunk][D]
  float* gs = w2s + kChunk * D;     // [kRows][LDG]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;

  for (int idx = tid; idx < kRows * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < m) val = ld4(x + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<float4*>(xs + r * LDX + c) = val;
  }

  // product 1: thread (ty1, tx1) owns hidden-tile rows ty1*4.., columns tx1*4..
  const int ty1 = tid / 16, tx1 = tid % 16;
  // product 2: thread (ty2, tx2) owns output rows ty2*8.., columns
  // v*128 + tx2*4.. for v < NV
  const int ty2 = tid / 32, tx2 = tid % 32;

  float acc[8][4 * NV];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NV; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < hidden; c0 += kChunk) {
    __syncthreads();  // the previous chunk's readers of w1s, w2s and gs are done
    for (int idx = tid; idx < D * (kChunk / 4); idx += kThreads) {
      const int k = idx / (kChunk / 4), c = (idx % (kChunk / 4)) * 4;
      *reinterpret_cast<float4*>(w1s + k * kChunk + c) =
          ld4(w1 + (size_t)k * hidden + c0 + c);
    }
    for (int idx = tid; idx < kChunk * D / 4; idx += kThreads)
      reinterpret_cast<float4*>(w2s)[idx] =
          reinterpret_cast<const float4*>(w2 + (size_t)c0 * D)[idx];
    __syncthreads();

    float h[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[i][j] = 0.f;
    for (int k = 0; k < D; k += 4) {
      float4 xa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xa[i] = ld4(xs + (ty1 * 4 + i) * LDX + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 w = ld4(w1s + (k + kk) * kChunk + tx1 * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = component(xa[i], kk);
          h[i][0] = fmaf(a, w.x, h[i][0]);
          h[i][1] = fmaf(a, w.y, h[i][1]);
          h[i][2] = fmaf(a, w.z, h[i][2]);
          h[i][3] = fmaf(a, w.w, h[i][3]);
        }
      }
    }
    const float4 bias1 = ld4(b1 + c0 + tx1 * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(gs + (ty1 * 4 + i) * LDG + tx1 * 4) =
          make_float4(gelu_erf(h[i][0] + bias1.x), gelu_erf(h[i][1] + bias1.y),
                      gelu_erf(h[i][2] + bias1.z), gelu_erf(h[i][3] + bias1.w));
    __syncthreads();

    for (int k = 0; k < kChunk; k += 4) {
      float4 ga[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) ga[i] = ld4(gs + (ty2 * 8 + i) * LDG + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float4 w = ld4(w2s + (k + kk) * D + v * 128 + tx2 * 4);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float a = component(ga[i], kk);
            acc[i][v * 4 + 0] = fmaf(a, w.x, acc[i][v * 4 + 0]);
            acc[i][v * 4 + 1] = fmaf(a, w.y, acc[i][v * 4 + 1]);
            acc[i][v * 4 + 2] = fmaf(a, w.z, acc[i][v * 4 + 2]);
            acc[i][v * 4 + 3] = fmaf(a, w.w, acc[i][v * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int col = v * 128 + tx2 * 4;
    const float4 bias2 = ld4(b2 + col);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + ty2 * 8 + i;
      if (row < m)
        *reinterpret_cast<float4*>(out + (size_t)row * D + col) = make_float4(
            acc[i][v * 4 + 0] + bias2.x, acc[i][v * 4 + 1] + bias2.y,
            acc[i][v * 4 + 2] + bias2.z, acc[i][v * 4 + 3] + bias2.w);
    }
  }
}

template <int NV>
cudaError_t launch(const float* x, const float* w1, const float* b1,
                   const float* w2, const float* b2, float* out, int m,
                   int hidden, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NV>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_mlp_kernel<NV><<<(m + kRows - 1) / kRows, kThreads, smem, stream>>>(
      x, w1, b1, w2, b2, out, m, hidden);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 where the kernel takes these widths: D of 128 or 256, hidden a positive
// multiple of the chunk.
int fused_mlp_takes(int d, int hidden) {
  return (d == 128 || d == 256) && hidden > 0 && hidden % kChunk == 0;
}

const char* fused_mlp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches on `stream`, allocates nothing and does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
int fused_mlp(const void* x, const void* w1, const void* b1, const void* w2,
              const void* b2, void* out, int m, int d, int hidden, int device,
              void* stream) {
  if (m <= 0 || !fused_mlp_takes(d, hidden)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* xf = (const float*)x;
  const float* w1f = (const float*)w1;
  const float* b1f = (const float*)b1;
  const float* w2f = (const float*)w2;
  const float* b2f = (const float*)b2;
  if (d == 128)
    return (int)launch<1>(xf, w1f, b1f, w2f, b2f, (float*)out, m, hidden,
                          (cudaStream_t)stream);
  return (int)launch<2>(xf, w1f, b1f, w2f, b2f, (float*)out, m, hidden,
                        (cudaStream_t)stream);
}

}  // extern "C"
