// combine_scatter for sm_90a: the [K, D] add, max or min table of a pair
// buffer, built from the op's identity, with keys outside [0, K) dropped.
//
// Replaces the Pallas kernel src/repro/kernels/combine_scatter.py::
// combine_scatter (_kernel), whose VMEM-resident [K, D] table took one masked
// broadcast update per pair, table = op(table, where(iota_K == key, value,
// identity)), over a sequential grid: O(N * K) work.  GPUs usually scatter
// with atomics; float atomics give other bits on every run, so here the
// table is the two-pass keyed fold of keyed_fold.cuh started from the
// identity (no acc is read): each pair is folded into its key's row of a
// shared-memory table once, and the segments are joined in order.  max/min
// fold in index order through combine<>, which keeps JAX's rules on signed
// zeros and NaN payloads; add over a small table folds into lane tables
// (lane_fold.cuh) in a fixed order of its own.  Past the table (32768
// floats) every key tile reads the whole buffer again.
// On an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py and
// tools/ab_keyed_fold.py, CUDA graph): add over 2^24 pairs, D = 3, K = 100
// takes 0.095 ms on lane tables, also with half the pairs on one key (the
// index-order pass: 0.214 and 0.539 ms; byte bound 0.080 ms), max 0.308
// ms; add over 2^22 pairs, D = 1, K = 2^16 (two key tiles, index order)
// 0.167 ms by CUDA events (byte bound 0.010 ms).

#include "keyed_fold.cuh"

extern "C" int combine_scatter_launch(const int* keys, const float* vals,
                                      float* out, float* partial, int n, int d,
                                      int k, int op, int shape, int block_k,
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
          keys, vals, nullptr, out, partial, n, d, k, shape, block_k, cols,
          stage, warps, seg_len, n_seg, passes, n_passes, scratch_bytes,
          region_seg, extra, s);
    case keyed_fold::kMax:
      return (int)keyed_fold::launch<keyed_fold::kMax>(
          keys, vals, nullptr, out, partial, n, d, k, shape, block_k, cols,
          stage, warps, seg_len, n_seg, passes, n_passes, scratch_bytes,
          region_seg, extra, s);
    case keyed_fold::kMin:
      return (int)keyed_fold::launch<keyed_fold::kMin>(
          keys, vals, nullptr, out, partial, n, d, k, shape, block_k, cols,
          stage, warps, seg_len, n_seg, passes, n_passes, scratch_bytes,
          region_seg, extra, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* combine_scatter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
