// onehot_combine for sm_90a: the [K, D] per-key f32 sums of a whole pair
// buffer, the combine flow's additive fold.
//
// Replaces the Pallas kernel src/repro/kernels/onehot_combine.py::onehot_combine
// (_kernel), which kept the whole [K, Td] table resident in VMEM across a
// sequential grid over pair tiles and fed [Tn, K] one-hot tiles to the MXU:
// O(N * K) multiply-adds.  Hopper runs blocks in parallel and in no order,
// so the sum is the additive case of the deterministic two-pass keyed fold
// in keyed_fold.cuh, started from zero (no acc is read): O(N) work, no float
// atomics, the same bits on every run.  The combine flow takes it up to
// 2048 keys (the reference's cutoff, collector.ONEHOT_MAX_KEYS), on lane
// tables (lane_fold.cuh) up to the plan's crossover.  Integer channels come
// here in f32 and are exact up to 2^24 per key.
// On an NVIDIA H100 80GB HBM3 at 700.00 W (tools/ab_keyed_fold.py, CUDA
// graph): 2^24 pairs, K = 100 take 0.095 ms at D = 3 and 0.051 ms at D = 1
// (the index-order pass: 0.215 and 0.198 ms; byte bounds 0.080 and 0.040).

#include "keyed_fold.cuh"

extern "C" int onehot_combine_launch(const int* keys, const float* vals,
                                     float* out, float* partial, int n, int d,
                                     int k, int shape, int block_k, int cols,
                                     int stage, int warps, int seg_len,
                                     int n_seg, const int* passes,
                                     int n_passes, long long scratch_bytes,
                                     int region_seg, int extra,
                                     void* stream) {
  return (int)keyed_fold::launch<keyed_fold::kAdd>(
      keys, vals, nullptr, out, partial, n, d, k, shape, block_k, cols, stage,
      warps, seg_len, n_seg, passes, n_passes, scratch_bytes, region_seg,
      extra, (cudaStream_t)stream);
}

extern "C" const char* onehot_combine_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
