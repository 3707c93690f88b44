// radix_partition_multi for sm_90a: the sort flow's hierarchical partition,
// digit by digit over fanouts = (B1, ..., BL), into the leaf layout.
//
// Replaces the Pallas kernel src/repro/kernels/radix_partition.py::
// radix_partition_multi (_hist_level_kernel, _scatter_level_kernel).  Level l
// partitions by key / R_l with R_L = bucket_size and R_{l-1} = R_l * B_l;
// the first level is radix_partition's three passes over the raw chunk, and
// each inner level runs them again on the previous level's layout, tile by
// tile, a tile being pad_align pairs and so inside one parent region (the
// regions start at multiples of pad_align).  A tile's digit counts go to its
// parent's rows, and a pair's cursor is its bucket's start plus the counts of
// the earlier tiles of the same parent region.  Every level is stable, so the
// leaf layout, starts included, is bit for bit radix_partition's at
// bucket_size, for any pad_align.  The passes are in radix_level.cuh.
//
// Bound on this card: bytes.  The function reads N*(4 + 4D) bytes and writes
// Np*(4 + 4D); each level reads its input twice and writes a layout, so the
// traffic is about (L + 1) times the bound.

#include "radix_level.cuh"

extern "C" long long radix_partition_multi_scratch_bytes(
    int n, int d, int key_space, int bucket_size, const int* fanouts,
    int n_fan, int pad) {
  radix::Level lv[radix::kMaxLevels];
  const int L = radix::plan_levels(n, key_space, bucket_size, fanouts, n_fan,
                                   pad, lv);
  if (L == 0) return -1;
  radix::Scratch unused;
  return (long long)radix::carve(lv, L, d, nullptr, &unused);
}

extern "C" int radix_partition_multi_launch(
    const int* keys, const float* vals, int n, int d, int key_space,
    int bucket_size, const int* fanouts, int n_fan, int pad, int* out_keys,
    float* out_vals, int* starts, void* scratch, void* stream) {
  radix::Level lv[radix::kMaxLevels];
  const int L = radix::plan_levels(n, key_space, bucket_size, fanouts, n_fan,
                                   pad, lv);
  if (L == 0) return (int)cudaErrorInvalidValue;
  return (int)radix::partition(lv, L, keys, vals, d, key_space, pad, out_keys,
                               out_vals, starts, scratch,
                               (cudaStream_t)stream);
}

extern "C" const char* radix_partition_multi_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
