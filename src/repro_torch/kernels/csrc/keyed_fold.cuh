// Deterministic keyed fold of an unsorted pair chunk into a [K, D] f32 table,
// shared by onehot_fold.cu (sums) and chunk_monoid_fold.cu (add/max/min),
// which fold onto a carried table, and by onehot_combine.cu (sums) and
// combine_scatter.cu (add/max/min), which build the table from the identity.
//
// What it computes: out[k, :] = acc[k, :] (op) fold_op{ vals[i, :] : keys[i] == k },
// with keys outside [0, K) (the sentinel K included) dropped.  Rows of keys
// absent from the chunk fold only the identity, so they pass through.  With
// acc == nullptr no table is read: out[k, :] is the fold alone, and the
// identity for an absent key.
//
// Design.  The Pallas kernels ran their grid in order on one TPU core and kept
// the [Kb, D] table block resident in VMEM across the pair tiles.  Blocks on
// Hopper run in parallel and in no order, and a float sum must not depend on
// that order, so there are no float atomics here:
//   pass 1  grid (segment, key block, column tile).  A block stages its
//           segment's keys and values in shared memory, tile by tile.  Thread t
//           owns one key of the block and up to kMaxCols columns, which it
//           carries in registers, and folds the matching pairs of its segment
//           in index order.  It writes partial[segment, key, cols].
//   pass 2  one warp per (key, column): lane l folds segments l, l+32, ... in
//           order, a fixed shuffle tree joins the lanes, and the result is
//           combined onto acc (when there is one).  The order of every
//           addition is fixed by the shapes alone, so two runs give the same
//           bits.
//
// Bound on this card: bytes.  The function must read N*(4 + 4D) bytes of pairs
// and K*D*4 of acc (none without acc) and write K*D*4; at 3.35 TB/s that is
// the floor.  The design
// reads each pair once from device memory (the staging loads are coalesced),
// but every thread of a key block scans every staged key, so the work is
// O(N * K) compares: the kernel is bound by instruction throughput, not
// bytes (at K = 100 it runs at about 15x the byte bound).
// Matching JAX: max keeps +0 over -0 and min keeps -0 over +0 in either
// operand order, and NaN propagates (fmaxf/fminf would drop it).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace keyed_fold {

constexpr int kMaxCols = 8;  // columns one thread carries in registers
constexpr int kMergeWarps = 8;

enum Op { kAdd = 0, kMax = 1, kMin = 2 };

template <int OP>
__device__ __forceinline__ float identity() {
  if (OP == kAdd) return 0.0f;
  if (OP == kMax) return -INFINITY;
  return INFINITY;
}

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  if (OP == kAdd) return a + b;
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  if (a == b) {  // equal values; for +0 and -0 pick the sign JAX picks
    if (OP == kMax) return signbit(a) ? b : a;
    return signbit(a) ? a : b;
  }
  if (OP == kMax) return a > b ? a : b;
  return a < b ? a : b;
}

// Pass 1.  Dynamic shared memory: tile_n keys, then tile_n * min(d, kMaxCols)
// values.  blockDim.x == block_k.
template <int OP>
__global__ void fold_segments(const int* __restrict__ keys,
                              const float* __restrict__ vals,
                              float* __restrict__ partial, int n, int d, int k,
                              int block_k, int tile_n, int seg_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_keys = reinterpret_cast<int*>(smem);
  float* s_vals = reinterpret_cast<float*>(s_keys + tile_n);
  const int stride = d < kMaxCols ? d : kMaxCols;

  const int seg = blockIdx.x;
  const int key = blockIdx.y * block_k + threadIdx.x;
  const int col0 = blockIdx.z * kMaxCols;
  const int ncols = min(kMaxCols, d - col0);
  const long long begin = (long long)seg * seg_len;
  const long long end = min((long long)n, begin + seg_len);

  float r[kMaxCols];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) r[j] = identity<OP>();

  for (long long t0 = begin; t0 < end; t0 += tile_n) {
    const int m = (int)min((long long)tile_n, end - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < m; i += blockDim.x) s_keys[i] = keys[t0 + i];
    for (int i = threadIdx.x; i < m * ncols; i += blockDim.x) {
      const int row = i / ncols;
      const int c = i - row * ncols;
      s_vals[row * stride + c] = vals[(t0 + row) * d + col0 + c];
    }
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      if (s_keys[i] == key) {  // threads of keys >= k never write back
        const float* v = s_vals + i * stride;
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j)
          if (j < ncols) r[j] = combine<OP>(r[j], v[j]);
      }
    }
  }
  if (key < k) {
    float* out = partial + ((long long)seg * k + key) * d + col0;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (j < ncols) out[j] = r[j];
  }
}

// Pass 2.  One warp per element of the [K, D] table; kMergeWarps per block.
template <int OP>
__global__ void merge_segments(const float* __restrict__ acc,
                               const float* __restrict__ partial,
                               float* __restrict__ out, int kd, int n_seg) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (e >= kd) return;  // whole warps exit together
  float r = identity<OP>();
  for (int s = lane; s < n_seg; s += 32)
    r = combine<OP>(r, partial[(long long)s * kd + e]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    r = combine<OP>(r, __shfl_down_sync(0xffffffffu, r, off));
  if (lane == 0) out[e] = acc != nullptr ? combine<OP>(acc[e], r) : r;
}

template <int OP>
inline cudaError_t launch(const int* keys, const float* vals, const float* acc,
                          float* out, float* partial, int n, int d, int k,
                          int block_k, int tile_n, int seg_len, int n_seg,
                          cudaStream_t stream) {
  const int stride = d < kMaxCols ? d : kMaxCols;
  const size_t smem = (size_t)tile_n * (sizeof(int) + sizeof(float) * stride);
  const dim3 grid1(n_seg, (k + block_k - 1) / block_k,
                   (d + kMaxCols - 1) / kMaxCols);
  fold_segments<OP><<<grid1, block_k, smem, stream>>>(
      keys, vals, partial, n, d, k, block_k, tile_n, seg_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int kd = k * d;
  const int grid2 = (kd + kMergeWarps - 1) / kMergeWarps;
  merge_segments<OP><<<grid2, kMergeWarps * 32, 0, stream>>>(acc, partial, out,
                                                            kd, n_seg);
  return cudaGetLastError();
}

}  // namespace keyed_fold
