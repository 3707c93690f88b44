// radix_partition for sm_90a: a pair chunk partitioned by key into padded
// bucket regions, stably (the sort flow's shuffle, one level).
//
// Replaces the Pallas kernel src/repro/kernels/radix_partition.py::
// radix_partition (_hist_kernel, _scatter_kernel).  The TPU version ran its
// grid in order on one core and carried a per-bucket cursor in VMEM from tile
// to tile, writing each pair with a dynamic VMEM store.  Blocks on Hopper run
// in parallel and in no order, so here the cursor is computed, not carried: a
// per-tile histogram, an exclusive scan over tiles, then a scatter in which a
// pair's slot follows from the counts of the pairs before it (warp ballots,
// no atomicAdd on a cursor).  The layout is therefore the reference's, bit
// for bit, on every run.  The passes are in radix_level.cuh.
//
// Layout (as the reference): bucket b holds the keys in
// [b*bucket_size, (b+1)*bucket_size) at starts[b], its region a multiple of
// pad; pad slots and the trailing region hold the key key_space and zero
// values; keys in the last bucket at or past key_space (the sentinel when
// key_space % bucket_size != 0) keep their slots and read key_space; keys
// below 0 or past the last bucket are dropped.
//
// Bound on this card: bytes.  The function reads N*(4 + 4D) bytes of pairs
// and writes Np*(4 + 4D) of layout (3.35 TB/s); the passes read the pairs
// twice.

#include "radix_level.cuh"

extern "C" long long radix_partition_scratch_bytes(int n, int d, int key_space,
                                                   int bucket_size, int pad) {
  radix::Level lv[1];
  if (radix::plan_levels(n, key_space, bucket_size, nullptr, 0, pad, lv) != 1)
    return -1;
  radix::Scratch unused;
  return (long long)radix::carve(lv, 1, d, nullptr, &unused);
}

extern "C" int radix_partition_launch(const int* keys, const float* vals,
                                      int n, int d, int key_space,
                                      int bucket_size, int pad, int* out_keys,
                                      float* out_vals, int* starts,
                                      void* scratch, void* stream) {
  radix::Level lv[1];
  if (radix::plan_levels(n, key_space, bucket_size, nullptr, 0, pad, lv) != 1)
    return (int)cudaErrorInvalidValue;
  return (int)radix::partition(lv, 1, keys, vals, d, key_space, pad, out_keys,
                               out_vals, starts, scratch,
                               (cudaStream_t)stream);
}

extern "C" const char* radix_partition_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
