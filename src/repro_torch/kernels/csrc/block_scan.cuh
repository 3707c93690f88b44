// Inclusive scan of one int per thread over a thread block, shared by the
// radix partition and the segment reduce.

#pragma once

#include <cuda_runtime.h>

namespace scan {

// kMax: running maximum instead of sum.  blockDim.x a multiple of 32, at
// most 1024; s_warp holds 32 ints of shared memory.
template <bool kMax>
__device__ int block_scan(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = kMax ? max(v, y) : v + y;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int w = lane < nw ? s_warp[lane] : (kMax ? -0x7fffffff - 1 : 0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w = kMax ? max(w, y) : w + y;
    }
    if (lane < nw) s_warp[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = kMax ? max(v, s_warp[warp - 1]) : v + s_warp[warp - 1];
  __syncthreads();  // s_warp may be reused
  return v;
}

}  // namespace scan
