// Forward (alpha) table of the semi-CRF partition function on Hopper.
//
// Replaces the TPU kernel _alpha_kernel in transkun_tpu/ops/semicrf_pallas.py
// (called through alpha_table_padded).  From s [Tp, Tp, NBp] in [end, begin,
// lane] layout, the shifted noise (row i = noise[i-1]) and spdiag [Tp, NBp]
// it writes v [Tp, NBp]; logZ = v[Tp-1].  Bounded by its chain of Tp
// dependent positions; the recurrence, the design and the numerics are
// described in semicrf_lse.cuh.

#include "semicrf_lse.cuh"

extern "C" {

int semicrf_alpha_lanes_per_block() { return kLanes; }

long long semicrf_alpha_smem_bytes(int tp) { return (long long)lse_smem_bytes(tp); }

const char* semicrf_alpha_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// fp32 scores
int semicrf_alpha(const void* s, const void* noise_shift, const void* spdiag,
                  void* v, int tp, int nbp, int device, void* stream) {
  return launch_lse_table<true, float>(s, noise_shift, spdiag, v, tp, nbp, device,
                                       stream);
}

// bf16 scores; the other tensors as above
int semicrf_alpha_bf16(const void* s, const void* noise_shift, const void* spdiag,
                       void* v, int tp, int nbp, int device, void* stream) {
  return launch_lse_table<true, __nv_bfloat16>(s, noise_shift, spdiag, v, tp, nbp,
                                               device, stream);
}

}  // extern "C"
