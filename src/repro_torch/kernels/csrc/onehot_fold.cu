// onehot_fold for sm_90a: acc[K, D] + per-key sums of an unsorted pair chunk.
//
// Replaces the Pallas kernel src/repro/kernels/onehot_combine.py::onehot_fold
// (_fold_kernel), which built a [Tn, Kb] one-hot tile in VMEM and fed it to the
// MXU.  Here the sum is the additive case of the deterministic two-pass keyed
// fold in keyed_fold.cuh, which also states the bound and the design: O(N)
// work, no float atomics, the same bits on every run; a small table
// (the KMeans one among them) takes lane tables (lane_fold.cuh), where a
// hot key costs nothing.  The stream flow's fused accumulator [K, sum(D) +
// 1] goes through this kernel with `counts` set: vals is then [N, D] and
// the kernel adds 1.0 to the table's last column for every pair that lands
// (its keys in [0, K)), reading nothing for it, so the per-key counts stay
// exact up to 2^24 and no [N, D + 1] copy of the values is made.
// On an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py and
// tools/ab_keyed_fold.py): 2^22 pairs, D = 4, K = 100, onto acc, take
// 0.036 ms replayed from a CUDA graph, also with half the pairs on one key
// (the index-order pass: 0.082 and 0.190 ms; byte bound 0.025 ms); with
// the counts column folded here, D = 3 + 1, 0.0365 ms (byte bound 0.020
// ms): the fold is bound by instruction throughput, not by the bytes it
// no longer reads.  Past one key tile the plan takes keyed_fold.cuh's
// partitioned route: the stream flow's fused [2.5M, 1 + 1] accumulator
// (Pavlo et al.'s GROUP BY sourceIP) takes 0.359 ms a 2^22-pair chunk,
// in two sub-chunks of 2^21 folded in place, against 10.888 ms on the
// tile route's 77 x 2 tiles (tools/fold_route_sweep.py, CUDA graph).

#include "keyed_fold.cuh"

extern "C" int onehot_fold_launch(const int* keys, const float* vals,
                                  const float* acc, float* out, float* partial,
                                  int n, int d, int k, int shape, int block_k,
                                  int cols, int stage, int warps, int seg_len,
                                  int n_seg, int counts, const int* passes,
                                  int n_passes, long long scratch_bytes,
                                  int region_seg, int extra, void* stream) {
  // d: the columns of acc and out (with counts, vals has d - 1)
  const cudaStream_t s = (cudaStream_t)stream;
  if (counts)
    return (int)keyed_fold::launch<keyed_fold::kAdd, true>(
        keys, vals, acc, out, partial, n, d, k, shape, block_k, cols, stage,
        warps, seg_len, n_seg, passes, n_passes, scratch_bytes, region_seg,
        extra, s);
  return (int)keyed_fold::launch<keyed_fold::kAdd>(
      keys, vals, acc, out, partial, n, d, k, shape, block_k, cols, stage,
      warps, seg_len, n_seg, passes, n_passes, scratch_bytes, region_seg,
      extra, s);
}

extern "C" const char* onehot_fold_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
