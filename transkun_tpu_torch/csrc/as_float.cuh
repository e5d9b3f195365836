// Loads and stores that convert between a tensor's element type (float or
// bfloat16) and the fp32 every kernel of the port computes in.  The bf16
// conversions are the intrinsics: exact on load, round to nearest even on
// store, as torch's `.to(torch.bfloat16)`.

#pragma once

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

}  // namespace
