// Deterministic keyed fold of an unsorted pair chunk into a [K, D] f32 table,
// shared by onehot_fold.cu (sums) and chunk_monoid_fold.cu (add/max/min),
// which fold onto a carried table, and by onehot_combine.cu (sums) and
// combine_scatter.cu (add/max/min), which build the table from the identity.
//
// What it computes: out[k, :] = acc[k, :] (op) fold_op{ vals[i, :] : keys[i] == k },
// with keys outside [0, K) (the sentinel K and negative keys included)
// dropped; max and min fold the pairs in index order, sums in an order
// fixed by the shapes.  Rows of keys absent from the
// chunk fold only the identity, so they pass through.  With acc == nullptr
// no table is read: out[k, :] is the fold alone, and the identity for an
// absent key.
//
// Design.  The Pallas kernels ran their grid in order on one TPU core and kept
// the [Kb, D] table block resident in VMEM across the pair tiles, touching
// the whole block for every pair tile (a one-hot product or a masked
// expansion).  Blocks on Hopper run in parallel and in no order, a float sum
// must not depend on that order, and O(N * K) work is issue-bound here, so
// there are no float atomics and the work per pair does not depend on K:
//   pass 1  grid (segment, key tile, column tile).  A block folds its
//           segment's pairs whose keys lie in its key tile into a [block_k,
//           cols] table in shared memory and writes partial[segment, key,
//           cols], or, when there is one segment, out itself (folded onto
//           acc).  Three block shapes, chosen by the caller's plan:
//             ballot  one warp matching keys by ballots, for a small table
//                     (fold_range in fold_table.cuh), in index order;
//             bucket  eight warps that bucket pairs by owner, for a large
//                     one (fold_range), in index order;
//             lane    sums into a small table only: one warp a column, one
//                     private copy of the column a lane, joined in a fixed
//                     order at the end (lane_fold.cuh).
//   pass 2  (several segments) a group of up to 32 threads per (key,
//           column) folds the segments' partials, each thread a contiguous
//           run of them in order; a fixed shuffle tree joins the runs left
//           to right, and the result is folded onto acc (when there is
//           one).
// The order of every float operation is fixed by the input and the shapes,
// so two runs give the same bits, and max/min give the plain version's
// bits, NaN payloads included (their fold is in index order; the lane
// shape, which sums in lane order, refuses them).
//
// The sizes come from the caller's plan (ops.fold_plan in Python): block_k
// keys and cols columns a table (at most kTableFloats floats; the lane
// shape holds 32 copies of it), W = 1 or 8 warps a block (the lane shape:
// cols), `stage` pairs a ring stage, segments of seg_len pairs (the lane
// shape: every n_seg-th run of seg_len = stage pairs).  A table that holds
// all of K x D reads each pair once; past that every key tile reads the
// whole chunk again.
//
// Bound on this card: bytes.  The function must read N*(4 + 4D) bytes of
// pairs and K*D*4 of acc (none without acc) and write K*D*4; at 3.35 TB/s
// that is the floor.  What holds the index-order fold back is issue: at
// K = 100 a window of 32 pairs costs one ballot a key bit to find the
// lanes that share a key, and the first of them folds the others' values
// in lane order, about a hundred instructions a window at sixteen one-warp
// blocks an SM; a key holding half the pairs triples that.  The lane shape
// has no such chain; what holds it back is still issue, the copies and
// the adds of 12 warps an SM at K = 100, which 16-byte copies and a fold
// specialised to its width cut.  On an NVIDIA H100 80GB HBM3 at 700.00
// W (chip_smoke.py and tools/ab_keyed_fold.py, CUDA graph, K = 100): B2's
// max over 2^22 pairs, D = 3, takes 0.092 ms on the index-order pass
// (bound 0.020); on lane tables B1's sum over 2^22 pairs, D = 4, onto acc
// takes 0.036 ms (index order: 0.082; bound 0.025) and B7's over 2^24
// pairs, D = 3, 0.095 ms (index order: 0.214; bound 0.080), the same with
// half the pairs on one key.  The lane shape beats the index-order pass
// at every sweep shape where a block of whole rows fits (K up to 1024 at
// D = 1, 512 at D = 3, 256 at D = 4); column tiles of three warps an SM
// lose (K = 512 at D = 4), so the plan takes them only from eight.

#pragma once

#include <cuda_runtime.h>

#include "fold_table.cuh"
#include "lane_fold.cuh"

namespace keyed_fold {

using fold_table::combine;
using fold_table::identity;
using fold_table::kAdd;
using fold_table::kMax;
using fold_table::kMin;

// Block shapes of pass 1 (ops.FOLD_SHAPES in Python).
enum Shape { kBallot = 0, kBucket = 1, kLane = 2 };

constexpr int kMergeThreads = 256;
constexpr int kMergeRun = 8;  // segments one merge thread folds, at most

template <int OP, int W, bool CNT>
__global__ void __launch_bounds__(W * 32, 16 / W)
    fold_segments(const int* __restrict__ keys, const float* __restrict__ vals,
                  const float* __restrict__ acc, float* __restrict__ out,
                  float* __restrict__ partial, long long n, fold_table::Geom g,
                  int seg_len, int n_seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int key0 = blockIdx.y * g.block_k;
  const int col0 = blockIdx.z * g.cols;
  const int nc = min(g.cols, g.d - col0);
  const long long lo = (long long)blockIdx.x * seg_len;
  const long long hi = min(n, lo + seg_len);
  fold_table::fold_range<OP, W, CNT>(keys, vals, g, key0, col0, nc, lo, hi,
                                    smem);
  const float* table = reinterpret_cast<const float*>(smem);
  const int kb = min(g.block_k, g.k - key0);  // keys of this tile below K
  const long long row0 = n_seg == 1 ? 0 : (long long)blockIdx.x * g.k;
  float* dst = n_seg == 1 ? out : partial;
  for (int i = threadIdx.x; i < kb * nc; i += W * 32) {
    const int local = i / nc;
    const long long e = (long long)(key0 + local) * g.d + col0 +
                        (i - local * nc);
    const float r = table[i];
    dst[row0 * g.d + e] =
        n_seg == 1 && acc != nullptr ? combine<OP>(acc[e], r) : r;
  }
}

// Every element of the [K, D] table: a group of 2^group_log2 threads (at
// most a block) folds the segments in order, each thread a contiguous run;
// a shuffle tree joins the runs of a warp left to right, the group's first
// thread joins its warps in order, then the result goes onto acc.
template <int OP>
__global__ void __launch_bounds__(kMergeThreads)
    merge_segments(const float* __restrict__ acc,
                   const float* __restrict__ partial, float* __restrict__ out,
                   long long kd, int n_seg, int group_log2) {
  __shared__ float s_warp[kMergeThreads / 32];
  const long long gid = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  const int group = 1 << group_log2;
  const long long e = gid >> group_log2;
  const int g = (int)(gid & (group - 1));
  float r = identity<OP>();
  if (e < kd) {
    const int run = (n_seg + group - 1) / group;
    const int s0 = g * run, s1 = min(n_seg, s0 + run);
#pragma unroll 4
    for (int s = s0; s < s1; ++s) r = combine<OP>(r, partial[s * kd + e]);
  }
  for (int off = 1; off < min(group, 32); off <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, r, off);
    if ((g & (2 * off - 1)) == 0) r = combine<OP>(r, o);
  }
  if (group > 32) {  // the same in every thread of the block
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) s_warp[warp] = r;
    __syncthreads();
    if (g == 0)
      for (int w = 1; w < group / 32; ++w) r = combine<OP>(r, s_warp[warp + w]);
  }
  if (g == 0 && e < kd) out[e] = acc != nullptr ? combine<OP>(acc[e], r) : r;
}

// Past 48 KB of dynamic shared memory a kernel must be allowed it first.
// Asked on every such launch: a function-local static here would be one
// object shared by every library built from this header (the linker
// unifies such objects across shared libraries), and would let one
// library's kernel go without the attribute.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Pass 1 of the lane shape: fold_runs of the block's width.
template <int OP, bool CNT, int C = 1>
inline cudaError_t launch_lanes(const int* keys, const float* vals,
                                const float* acc, float* out, float* partial,
                                int n, int d, int k, int block_k, int cols,
                                int n_seg, dim3 grid, size_t smem,
                                cudaStream_t stream) {
  if constexpr (C < lane_fold::kMaxWarps) {
    if (cols != C)
      return launch_lanes<OP, CNT, C + 1>(keys, vals, acc, out, partial, n,
                                          d, k, block_k, cols, n_seg, grid,
                                          smem, stream);
  }
  const cudaError_t err = allow_smem(lane_fold::fold_runs<OP, C, CNT>, smem);
  if (err != cudaSuccess) return err;
  lane_fold::fold_runs<OP, C, CNT><<<grid, C * 32, smem, stream>>>(
      keys, vals, acc, out, partial, n, d, k, block_k, n_seg);
  return cudaSuccess;
}

// One fold: pass 1, and pass 2 when there are several segments.  Returns
// cudaErrorInvalidValue for a plan the kernels cannot run, a lane-table
// plan for max or min among them.  With CNT (sums only) vals is [n, d - 1]
// and the table's last column counts the pairs that land (a sum of ones,
// exact below 2^24); acc, out and partial keep d columns.
template <int OP, bool CNT = false>
inline cudaError_t launch(const int* keys, const float* vals, const float* acc,
                          float* out, float* partial, int n, int d, int k,
                          int shape, int block_k, int cols, int stage,
                          int warps, int seg_len, int n_seg,
                          cudaStream_t stream) {
  static_assert(!CNT || OP == kAdd, "the counts column is a sum");
  const bool lane = shape == kLane, bucket = shape == kBucket;
  if (n <= 0 || d <= 0 || k <= 0 || block_k <= 0 || block_k > k ||
      cols <= 0 || cols > d || cols > fold_table::kMaxCols ||
      (long long)block_k * cols > fold_table::kTableFloats ||
      seg_len <= 0 || n_seg <= 0 || (n_seg > 1 && !partial))
    return cudaErrorInvalidValue;
  if (lane) {  // n_seg blocks, each every n_seg-th run of kStage pairs
    if (OP != kAdd || warps != cols || cols > lane_fold::kMaxWarps ||
        stage != lane_fold::kStage || seg_len != lane_fold::kStage ||
        (long long)seg_len * (n_seg - 1) >= n)
      return cudaErrorInvalidValue;
  } else if ((shape != kBallot && !bucket) ||
             warps != (bucket ? fold_table::kBucketWarps : 1) || stage < 32 ||
             stage % 32 != 0 ||
             stage > (bucket ? fold_table::kMaxStage
                             : fold_table::kBallotStage) ||
             (long long)seg_len * n_seg < n ||
             (long long)seg_len * (n_seg - 1) >= n) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = lane ? lane_fold::smem_bytes(block_k, cols)
                           : fold_table::smem_bytes(block_k, cols, stage,
                                                    warps);
  const int key_tiles = (k + block_k - 1) / block_k;
  const int col_tiles = (d + cols - 1) / cols;
  if (smem > (size_t)fold_table::kSmemBytes || key_tiles > 65535 ||
      col_tiles > 65535)
    return cudaErrorInvalidValue;
  const fold_table::Geom g{d, k, block_k, cols, stage,
                           fold_table::key_bits(block_k)};
  const dim3 grid(n_seg, key_tiles, col_tiles);
  cudaError_t err = cudaSuccess;
  if (lane) {
    if constexpr (OP == kAdd) err = launch_lanes<OP, CNT>(
        keys, vals, acc, out, partial, n, d, k, block_k, cols, n_seg, grid,
        smem, stream);
  } else if (bucket) {
    constexpr int W = fold_table::kBucketWarps;
    err = allow_smem(fold_segments<OP, W, CNT>, smem);
    if (err != cudaSuccess) return err;
    fold_segments<OP, W, CNT><<<grid, W * 32, smem, stream>>>(
        keys, vals, acc, out, partial, n, g, seg_len, n_seg);
  } else {
    err = allow_smem(fold_segments<OP, 1, CNT>, smem);
    if (err != cudaSuccess) return err;
    fold_segments<OP, 1, CNT><<<grid, 32, smem, stream>>>(
        keys, vals, acc, out, partial, n, g, seg_len, n_seg);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || n_seg == 1) return err;
  // threads per element: runs of at most kMergeRun segments, a power of
  // two up to a block
  int group_log2 = 0;
  while ((1 << group_log2) < kMergeThreads &&
         (long long)kMergeRun << group_log2 < n_seg)
    ++group_log2;
  const long long kd = (long long)k * d;
  const long long threads = kd << group_log2;
  merge_segments<OP><<<(unsigned)((threads + kMergeThreads - 1) /
                                  kMergeThreads),
                       kMergeThreads, 0, stream>>>(acc, partial, out, kd,
                                                   n_seg, group_log2);
  return cudaGetLastError();
}

}  // namespace keyed_fold
