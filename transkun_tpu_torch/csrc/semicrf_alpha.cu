// Forward (alpha) table of the semi-CRF partition function on Hopper.
//
// Replaces the TPU kernel _alpha_kernel in transkun_tpu/ops/semicrf_pallas.py
// (called through alpha_table_padded).  From s [Tp, Tp, NBp] in [end, begin,
// lane] layout, the shifted noise (row i = noise[i-1]) and spdiag [Tp, NBp]
// it writes v [Tp, NBp]; logZ = v[Tp-1].  Bounded by its chain of Tp
// dependent positions and the expf of every term; the recurrence, the
// blocked design spread over a thread-block cluster with its far scores
// brought by TMA, and the numerics are described in semicrf_lse_cluster.cuh
// (the launch plan: ops/logz.py::alpha_launch_plan).
//
// The tensor map over s is encoded on the host at every launch (s moves),
// through cuTensorMapEncodeTiled fetched from the driver by the runtime, so
// the library needs no -lcuda, and reaches the kernel as a __grid_constant__
// parameter.

#include <cstdio>

#include "semicrf_lse_cluster.cuh"

namespace {

// Error codes of the tensor map, beside the cudaError_t values (< 10000).
constexpr int kNoEncoder = 10000;  // the driver has no cuTensorMapEncodeTiled
constexpr int kEncodeFailed = 20000;  // + the CUresult of cuTensorMapEncodeTiled

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// The map of a launch over s [tp, tp, nbp]: dims {nbp, tp (begin), tp
// (end)}, a box of {G lanes, kRows * C begins, kBlock ends} taking every
// C-th begin.  A chain of at most one block (tp <= kBlock) has no far terms
// and leaves the map unused and unencoded.
template <typename S>
int alpha_map(CUtensorMap* map, const void* s, int tp, int nbp, int cluster) {
  using A = AlphaShape<S>;
  *map = CUtensorMap{};
  if (tp <= kBlock) return 0;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)nbp, (cuuint64_t)tp, (cuuint64_t)tp};
  const cuuint64_t strides[2] = {(cuuint64_t)nbp * sizeof(S), (cuuint64_t)tp * nbp * sizeof(S)};
  const cuuint32_t box[3] = {(cuuint32_t)A::kGroup, (cuuint32_t)(A::kRows * cluster),
                             (cuuint32_t)kBlock};
  const cuuint32_t steps[3] = {1, (cuuint32_t)cluster, 1};
  const CUresult r = encode(
      map, sizeof(S) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
      const_cast<void*>(s), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

template <typename S>
int launch_alpha(const void* s, const void* noise, const void* spdiag, void* v, int tp, int nbp,
                 int cluster, int device, void* stream) {
  if (cluster < 1 || cluster > kAlphaMaxCluster) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map;
  const int bad = alpha_map<S>(&map, s, tp, nbp, cluster);
  if (bad) return bad;
  return launch_clusters<AlphaShape<S>::kThreadsAll>(alpha_tma_kernel<S>, nbp / AlphaShape<S>::kGroup * cluster,
                                        cluster, alpha_smem_bytes<S>(tp, cluster), stream, map,
                                        (const S*)s, (const float*)noise, (const float*)spdiag,
                                        (float*)v, tp, nbp);
}

}  // namespace

extern "C" {

// dynamic shared memory of a launch: fp32 scores unless bf16 != 0
long long semicrf_alpha_smem_bytes(int tp, int cluster, int bf16) {
  return (long long)(bf16 ? alpha_smem_bytes<__nv_bfloat16>(tp, cluster)
                          : alpha_smem_bytes<float>(tp, cluster));
}

// clusters of `cluster` CTAs the card holds at once, into *n
int semicrf_alpha_max_clusters(int tp, int cluster, int bf16, int device, int* n) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return bf16 ? max_active_clusters<AlphaShape<__nv_bfloat16>::kThreadsAll>(alpha_tma_kernel<__nv_bfloat16>, cluster,
                                                   alpha_smem_bytes<__nv_bfloat16>(tp, cluster), n)
              : max_active_clusters<AlphaShape<float>::kThreadsAll>(alpha_tma_kernel<float>, cluster,
                                                   alpha_smem_bytes<float>(tp, cluster), n);
}

const char* semicrf_alpha_error_string(int err) {
  static thread_local char text[96];
  if (err == kNoEncoder) return "the driver has no cuTensorMapEncodeTiled";
  if (err >= kEncodeFailed) {
    snprintf(text, sizeof(text), "cuTensorMapEncodeTiled failed (CUresult %d)", err - kEncodeFailed);
    return text;
  }
  return cudaGetErrorString((cudaError_t)err);
}

// fp32 scores
int semicrf_alpha(const void* s, const void* noise_shift, const void* spdiag, void* v,
                  int tp, int nbp, int cluster, int device, void* stream) {
  return launch_alpha<float>(s, noise_shift, spdiag, v, tp, nbp, cluster, device, stream);
}

// bf16 scores; the other tensors as above
int semicrf_alpha_bf16(const void* s, const void* noise_shift, const void* spdiag, void* v,
                       int tp, int nbp, int cluster, int device, void* stream) {
  return launch_alpha<__nv_bfloat16>(s, noise_shift, spdiag, v, tp, nbp, cluster, device,
                                     stream);
}

}  // extern "C"
