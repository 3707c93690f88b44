// radix_partition and radix_partition_multi for sm_90a: a pair chunk
// partitioned by key into padded bucket regions, stably (the sort flow's
// shuffle), in one pass or several.
//
// Replaces the Pallas kernels src/repro/kernels/radix_partition.py::
// radix_partition (_hist_kernel, _scatter_kernel) and radix_partition_multi
// (_hist_level_kernel, _scatter_level_kernel).  The TPU version ran its
// grid in order on one core and carried a per-bucket cursor in VMEM from tile
// to tile, writing each pair with a dynamic VMEM store.  Blocks on Hopper run
// in parallel and in no order, so here the cursor is computed, not carried: a
// per-tile histogram, a scan over tiles, then a scatter in which a pair's
// slot follows from the counts of the pairs before it (warp ballots, no
// atomic on a cursor).  Device memory wants whole sectors, so the scatter
// stages a tile in shared memory, orders it by bucket there, and writes each
// bucket's run of keys and of values with consecutive threads on
// consecutive slots.  The layout is the reference's, bit for bit, on every
// run.  The passes are in radix_level.cuh.
//
// The reference's hierarchy (level l partitions by key / R_l, R_L =
// bucket_size, R_{l-1} = R_l * B_l) is a TPU artifact: VMEM and the
// [Tn, B] one-hot sweep bound a level's fan-out there.  Every pass is a
// stable partition of the one before, so any chain of ranges that ends at
// bucket_size gives the leaf layout, starts included.  The plan
// (radix_partition.py partition_passes) therefore splits the leaves into
// the fewest passes of at most radix::kMaxBuckets buckets a parent, for one
// level and for a hierarchy alike: at the sort flow's (8, 8) that is one
// pass of 64 buckets.
//
// Layout (as the reference): bucket b holds the keys in
// [b*bucket_size, (b+1)*bucket_size) at starts[b], its region a multiple of
// pad; pad slots and the trailing region hold the key key_space and zero
// values; keys in the last bucket at or past key_space (the sentinel when
// key_space % bucket_size != 0) keep their slots and read key_space; keys
// below 0 or past the last bucket are dropped.
//
// Bound on this card: bytes.  The function reads N*(4 + 4D) bytes of pairs
// and writes Np*(4 + 4D) of layout (3.35 TB/s); each pass reads its input
// (the keys twice) and writes a layout.

#include "radix_level.cuh"

extern "C" long long radix_partition_scratch_bytes(int n, int d, int key_space,
                                                   int pad, const int* passes,
                                                   int n_passes) {
  radix::Pass ps[radix::kMaxPasses];
  const int L = radix::read_passes(n, d, key_space, pad, passes, n_passes, ps);
  if (L == 0) return -1;
  radix::Scratch unused;
  return (long long)radix::carve(ps, L, d, nullptr, &unused);
}

extern "C" int radix_partition_launch(const int* keys, const float* vals,
                                      int n, int d, int key_space, int pad,
                                      const int* passes, int n_passes,
                                      int* out_keys, float* out_vals,
                                      int* starts, void* scratch,
                                      void* stream) {
  radix::Pass ps[radix::kMaxPasses];
  const int L = radix::read_passes(n, d, key_space, pad, passes, n_passes, ps);
  if (L == 0) return (int)cudaErrorInvalidValue;
  return (int)radix::partition(ps, L, keys, vals, d, out_keys, out_vals,
                               starts, scratch, (cudaStream_t)stream);
}

extern "C" const char* radix_partition_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
