// combine_scatter for sm_90a: the [K, D] add, max or min table of a pair
// buffer, built from the op's identity, with keys outside [0, K) dropped.
//
// Replaces the Pallas kernel src/repro/kernels/combine_scatter.py::
// combine_scatter (_kernel), whose VMEM-resident [K, D] table took one masked
// broadcast update per pair, table = op(table, where(iota_K == key, value,
// identity)), over a sequential grid.  GPUs usually scatter with atomics;
// float atomics give other bits on every run, so here the table is the
// two-pass keyed fold of keyed_fold.cuh started from the identity (no acc is
// read): each thread folds its own key's pairs in index order, then one warp
// per table element folds the segments in a fixed order.  max/min go through
// combine<>, which keeps JAX's rule on NaN and signed zero.
//
// Bound: bytes, N*(4 + 4D) read and K*D*4 written, at 3.35 TB/s.  Like the TPU
// kernel, which touches the whole [K, D] table per pair, the work is O(N * K):
// every thread of a key block compares every staged key with its own.  So the
// time grows linearly with K at a fixed N.  This matters on the combine flow's
// additive fallback past 2048 keys, which lands here; there is no size switch
// to another path.  On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py):
// max over 2^24 pairs, D = 3, K = 100 takes 2.68 ms (byte bound 0.080 ms);
// add over 2^22 pairs, D = 1, K = 2^16 takes 86.3 ms (byte bound 0.010 ms).

#include "keyed_fold.cuh"

extern "C" int combine_scatter_launch(const int* keys, const float* vals,
                                      float* out, float* partial, int n, int d,
                                      int k, int op, int block_k, int tile_n,
                                      int seg_len, int n_seg, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case keyed_fold::kAdd:
      return (int)keyed_fold::launch<keyed_fold::kAdd>(
          keys, vals, nullptr, out, partial, n, d, k, block_k, tile_n,
          seg_len, n_seg, s);
    case keyed_fold::kMax:
      return (int)keyed_fold::launch<keyed_fold::kMax>(
          keys, vals, nullptr, out, partial, n, d, k, block_k, tile_n,
          seg_len, n_seg, s);
    case keyed_fold::kMin:
      return (int)keyed_fold::launch<keyed_fold::kMin>(
          keys, vals, nullptr, out, partial, n, d, k, block_k, tile_n,
          seg_len, n_seg, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* combine_scatter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
