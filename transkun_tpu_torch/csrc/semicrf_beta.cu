// Backward (beta) table of the semi-CRF partition function on Hopper.
//
// Replaces the TPU kernel _beta_kernel in transkun_tpu/ops/semicrf_pallas.py
// (called through beta_table_padded).  From the same alpha-layout s [Tp, Tp,
// NBp] as the alpha table, read by columns, the noise (row t = noise[t])
// and spdiag [Tp, NBp] it writes q [Tp, NBp].  Each warp's column read is
// 128 contiguous bytes with a stride of Tp*NBp floats between ends, so no
// flipped or transposed copy of the score tensor is made.  Bounded by its
// chain of Tp dependent positions; the recurrence, the design and the
// numerics are described in semicrf_lse.cuh.

#include "semicrf_lse.cuh"

extern "C" {

int semicrf_beta_lanes_per_block() { return kLanes; }

long long semicrf_beta_smem_bytes(int tp) { return (long long)lse_smem_bytes(tp); }

const char* semicrf_beta_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// fp32 scores
int semicrf_beta(const void* s, const void* noise, const void* spdiag,
                  void* q, int tp, int nbp, int device, void* stream) {
  return launch_lse_table<false, float>(s, noise, spdiag, q, tp, nbp, device,
                                       stream);
}

// bf16 scores; the other tensors as above
int semicrf_beta_bf16(const void* s, const void* noise, const void* spdiag,
                       void* q, int tp, int nbp, int device, void* stream) {
  return launch_lse_table<false, __nv_bfloat16>(s, noise, spdiag, q, tp, nbp,
                                               device, stream);
}

}  // extern "C"
