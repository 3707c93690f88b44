// chunk_monoid_fold for sm_90a: an unsorted pair chunk folded into the carried
// [K, D] f32 table with add, max or min.
//
// Replaces the Pallas kernel
// src/repro/kernels/segment_reduce.py::chunk_monoid_fold (_chunk_fold_kernel),
// which masked each pair tile against a key block's iota and reduced the
// [Tn, Kb, D] masked expansion in VMEM: O(N * Kb) work per key block.  Here a
// block folds each pair into its key's row of a shared-memory table once,
// in index order, and a second pass joins the segments in order; the design
// and the bound are in keyed_fold.cuh.  Max and min keep JAX's rules for
// signed zeros and NaN payloads (combine<> in fold_table.cuh), so they are
// bit for bit the plain version's.
// Sums over a small table take lane tables (lane_fold.cuh).
// On an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py and
// tools/ab_keyed_fold.py): max over 2^22 pairs, D = 3, K = 100, onto acc,
// takes 0.092 ms replayed from a CUDA graph, add 0.030 ms on lane tables
// (byte bound 0.020 ms).

#include "keyed_fold.cuh"

extern "C" int chunk_monoid_fold_launch(const int* keys, const float* vals,
                                        const float* acc, float* out,
                                        float* partial, int n, int d, int k,
                                        int op, int shape, int block_k,
                                        int cols, int stage, int warps,
                                        int seg_len, int n_seg,
                                        const int* passes, int n_passes,
                                        long long scratch_bytes,
                                        int region_seg, int extra,
                                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case keyed_fold::kAdd:
      return (int)keyed_fold::launch<keyed_fold::kAdd>(
          keys, vals, acc, out, partial, n, d, k, shape, block_k, cols,
          stage, warps, seg_len, n_seg, passes, n_passes, scratch_bytes,
          region_seg, extra, s);
    case keyed_fold::kMax:
      return (int)keyed_fold::launch<keyed_fold::kMax>(
          keys, vals, acc, out, partial, n, d, k, shape, block_k, cols,
          stage, warps, seg_len, n_seg, passes, n_passes, scratch_bytes,
          region_seg, extra, s);
    case keyed_fold::kMin:
      return (int)keyed_fold::launch<keyed_fold::kMin>(
          keys, vals, acc, out, partial, n, d, k, shape, block_k, cols,
          stage, warps, seg_len, n_seg, passes, n_passes, scratch_bytes,
          region_seg, extra, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* chunk_monoid_fold_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
