// chunk_monoid_fold for sm_90a: an unsorted pair chunk folded into the carried
// [K, D] f32 table with add, max or min.
//
// Replaces the Pallas kernel
// src/repro/kernels/segment_reduce.py::chunk_monoid_fold (_chunk_fold_kernel),
// which masked each pair tile against a key block's iota and reduced the
// [Tn, Kb, D] masked expansion in VMEM.  Here each thread folds only the pairs
// of its own key, so no expansion exists; the two passes, the bound and the
// JAX rules for max/min are described in keyed_fold.cuh.

#include "keyed_fold.cuh"

extern "C" int chunk_monoid_fold_launch(const int* keys, const float* vals,
                                        const float* acc, float* out,
                                        float* partial, int n, int d, int k,
                                        int op, int block_k, int tile_n,
                                        int seg_len, int n_seg, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case keyed_fold::kAdd:
      return (int)keyed_fold::launch<keyed_fold::kAdd>(
          keys, vals, acc, out, partial, n, d, k, block_k, tile_n, seg_len,
          n_seg, s);
    case keyed_fold::kMax:
      return (int)keyed_fold::launch<keyed_fold::kMax>(
          keys, vals, acc, out, partial, n, d, k, block_k, tile_n, seg_len,
          n_seg, s);
    case keyed_fold::kMin:
      return (int)keyed_fold::launch<keyed_fold::kMin>(
          keys, vals, acc, out, partial, n, d, k, block_k, tile_n, seg_len,
          n_seg, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* chunk_monoid_fold_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
