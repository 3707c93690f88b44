// Device primitives shared by the kernels: cp.async copies from device
// memory into shared memory, and the ballot match of lanes holding the same
// small integer.

#pragma once

#include <cuda_runtime.h>

namespace prims {

// 16 bytes, both addresses 16-byte aligned; cached in L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// 4 bytes, both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The lanes whose value v equals this lane's, among the lanes where ok
// holds, from the bits lo .. lo + nb - 1 of v (the others agree): one
// ballot a bit, where __match_any_sync would serialize on distinct values.
__device__ __forceinline__ unsigned match_bits(int v, bool ok, int lo,
                                               int nb) {
  unsigned peers = __ballot_sync(0xffffffffu, ok);
  for (int bit = lo; bit < lo + nb; ++bit) {
    const bool set = (v >> bit) & 1;
    const unsigned b = __ballot_sync(0xffffffffu, set);
    peers &= set ? b : ~b;
  }
  return peers;
}

}  // namespace prims
