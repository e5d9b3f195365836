// Backward (beta) table of the semi-CRF partition function on Hopper.
//
// Replaces the TPU kernel _beta_kernel in transkun_tpu/ops/semicrf_pallas.py
// (called through beta_table_padded).  From the same alpha-layout s [Tp, Tp,
// NBp] as the alpha table, read by columns, the noise (row t = noise[t])
// and spdiag [Tp, NBp] it writes q [Tp, NBp]; no flipped or transposed copy
// of the score tensor is made.  Bounded by its chain of Tp dependent
// positions and the expf of every term; the recurrence, the blocked design
// spread over a thread-block cluster and the numerics are described in
// semicrf_lse_cluster.cuh (the launch plan: ops/logz.py::launch_plan).

#include "semicrf_lse_cluster.cuh"

extern "C" {

// dynamic shared memory of a launch: fp32 scores unless bf16 != 0
long long semicrf_beta_smem_bytes(int tp, int cluster, int bf16) {
  return (long long)(bf16 ? cluster_smem_bytes<__nv_bfloat16>(tp, cluster)
                          : cluster_smem_bytes<float>(tp, cluster));
}

// clusters of `cluster` CTAs the card holds at once, into *n
int semicrf_beta_max_clusters(int tp, int cluster, int bf16, int device, int* n) {
  return lse_cluster_max_clusters<false>(tp, cluster, bf16, device, n);
}

const char* semicrf_beta_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// fp32 scores
int semicrf_beta(const void* s, const void* noise, const void* spdiag, void* q,
                 int tp, int nbp, int cluster, int device, void* stream) {
  return launch_lse_cluster<false, float>(s, noise, spdiag, q, tp, nbp, cluster,
                                          device, stream);
}

// bf16 scores; the other tensors as above
int semicrf_beta_bf16(const void* s, const void* noise, const void* spdiag, void* q,
                      int tp, int nbp, int cluster, int device, void* stream) {
  return launch_lse_cluster<false, __nv_bfloat16>(s, noise, spdiag, q, tp, nbp,
                                                  cluster, device, stream);
}

}  // extern "C"
