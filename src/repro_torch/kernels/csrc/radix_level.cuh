// One level of the stable radix partition, shared by radix_partition.cu (one
// level) and radix_partition_multi.cu (a hierarchy of levels).
//
// What a level computes.  Every input pair whose key k >= 0 has a composite
// bucket id b = k / range below nb is "valid"; b splits into a parent
// p = b / fanout and a digit b % fanout.  Bucket b gets a region of the output
// that starts at starts[b], the exclusive prefix sum over buckets of each
// bucket's pair count rounded up to a multiple of pad; the valid pairs of b
// fill its region in input order, the rest of the region and the trailing
// slots after the last region hold fill_key and zero values.  Invalid pairs
// are dropped.  The first level has one parent (fanout == nb).  An inner level
// reads the previous level's layout, in which every parent region starts at a
// multiple of pad; its tiles are pad pairs long, so a tile lies inside one
// parent region, and within a parent region the level is the same stable
// partition restricted to that region.
//
// The passes, all deterministic (integer atomics only, and none that decides
// where a pair lands):
//   1 hist     grid = tiles.  A shared-memory histogram of the tile's digits
//              (exact in any order); the tile's column of the [fanout, tiles]
//              count matrix and its parent; the level's bucket totals.
//   2 scan     one block per digit: the exclusive prefix over tiles of that
//              digit's counts.  One block: each bucket's padded start.
//   3 scatter  grid = tiles.  Each warp owns a contiguous slice of the tile;
//              a warp histogram, a prefix across the warps, then the stable
//              write: a pair's rank among the earlier pairs of its bucket in
//              the same 32-pair step comes from __match_any_sync and popc, and
//              each warp carries its buckets' cursors from step to step.  So a
//              pair's slot is bucket start + pairs of the bucket in earlier
//              tiles of the parent + in earlier warps + in earlier steps +
//              earlier lanes: the input order, whatever the schedule.
//   4 fill     one block per bucket: the pad slots of its region; one more
//              block for the trailing slots.
//
// Bound on this card: bytes.  A level reads its input pairs twice (hist and
// scatter) and writes every output slot once; the scans touch
// tiles x fanout ints.

#pragma once

#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace radix {

constexpr int kThreads = 256;  // hist / scatter / fill blocks
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kTopTile = 2048;  // pairs per tile of the first level
constexpr int kMaxFanout = 1024;  // buckets of one level (scatter's shared memory)
constexpr int kMaxLevels = 8;

struct Level {
  int range;      // composite id = key / range
  int nb;         // valid composite ids: [0, nb)
  int fanout;     // digit = id % fanout, parent = id / fanout
  int width;      // parents x fanout: rows of the level's bucket totals
  int tile;       // pairs per tile
  int n_tiles;
  long long m;    // input pairs
  long long np;   // output slots
};

inline long long slots(long long n, int nb, int pad) {
  long long s = n + (long long)nb * pad + pad;  // + the trailing region
  return (s + pad - 1) / pad * pad;
}

// Levels of a partition of n pairs over key_space into leaves of bucket_size,
// split by fanouts[0..n_fan) (n_fan <= 1: one level).  Returns the count, or 0
// if the split is not one the kernels take.
inline int plan_levels(long long n, int key_space, int bucket_size,
                       const int* fanouts, int n_fan, int pad, Level* lv) {
  if (n_fan <= 1) {
    Level& l = lv[0];
    l.range = bucket_size;
    l.nb = (key_space + bucket_size - 1) / bucket_size;
    l.fanout = l.width = l.nb;
    l.tile = kTopTile;
    l.m = n;
    l.n_tiles = (int)((n + l.tile - 1) / l.tile);
    l.np = slots(n, l.nb, pad);
    return l.fanout <= kMaxFanout ? 1 : 0;
  }
  if (n_fan > kMaxLevels) return 0;
  long long range = bucket_size;
  for (int i = n_fan - 1; i >= 0; --i) {
    lv[i].range = (int)range;
    if (i > 0) range *= fanouts[i];
    if (range > 0x7fffffffLL) return 0;
  }
  long long m = n;
  int nb_parent = 1;
  for (int i = 0; i < n_fan; ++i) {
    Level& l = lv[i];
    l.nb = (int)(((long long)key_space + l.range - 1) / l.range);
    l.fanout = i == 0 ? l.nb : fanouts[i];
    l.width = i == 0 ? l.nb : nb_parent * fanouts[i];
    l.tile = i == 0 ? kTopTile : pad;
    l.m = m;
    l.n_tiles = (int)((m + l.tile - 1) / l.tile);
    l.np = slots(n, l.nb, pad);
    if (l.fanout > kMaxFanout) return 0;
    m = l.np;
    nb_parent = l.nb;
  }
  return n_fan;
}

__device__ __forceinline__ bool bucket_of(int key, const Level& L, int* b) {
  if (key < 0) return false;
  *b = key / L.range;
  return *b < L.nb;
}

// Pass 1.  Dynamic shared memory: fanout ints.
__global__ void level_hist(const int* __restrict__ keys, Level L,
                           int* __restrict__ counts_t,
                           int* __restrict__ tile_parent,
                           int* __restrict__ totals) {
  extern __shared__ int s_hist[];
  __shared__ int s_parent;
  const int t = blockIdx.x;
  for (int i = threadIdx.x; i < L.fanout; i += blockDim.x) s_hist[i] = 0;
  if (threadIdx.x == 0) s_parent = -1;
  __syncthreads();
  const long long lo = (long long)t * L.tile;
  const long long hi = min(L.m, lo + L.tile);
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    int b;
    if (bucket_of(keys[i], L, &b)) {
      atomicAdd(&s_hist[b % L.fanout], 1);
      atomicMax(&s_parent, b / L.fanout);  // one parent per tile
    }
  }
  __syncthreads();
  const int p = s_parent;
  for (int d = threadIdx.x; d < L.fanout; d += blockDim.x) {
    const int c = s_hist[d];
    counts_t[(long long)d * L.n_tiles + t] = c;
    if (c > 0) atomicAdd(&totals[p * L.fanout + d], c);
  }
  if (threadIdx.x == 0) tile_parent[t] = p;
}

// Pass 2a.  Row blockIdx.x of counts_t [fanout, n_tiles] -> its exclusive scan.
__global__ void column_scan(const int* __restrict__ counts_t,
                            int* __restrict__ prefix_t, int n_tiles) {
  __shared__ int s_warp[32];
  __shared__ int s_carry;
  const int* in = counts_t + (long long)blockIdx.x * n_tiles;
  int* out = prefix_t + (long long)blockIdx.x * n_tiles;
  if (threadIdx.x == 0) s_carry = 0;
  __syncthreads();
  for (int base = 0; base < n_tiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < n_tiles ? in[i] : 0;
    const int incl = scan::block_scan<false>(v, s_warp);
    const int carry = s_carry;
    if (i < n_tiles) out[i] = carry + incl - v;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) s_carry = carry + incl;
    __syncthreads();
  }
}

// Pass 2b.  One block: starts[b] = sum over b' < b of totals[b'] rounded up
// to pad; starts[width] = the end of the last region.
__global__ void starts_scan(const int* __restrict__ totals,
                            int* __restrict__ starts, int width, int pad) {
  __shared__ int s_warp[32];
  __shared__ int s_carry;
  if (threadIdx.x == 0) s_carry = 0;
  __syncthreads();
  for (int base = 0; base < width; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < width ? (totals[i] + pad - 1) / pad * pad : 0;
    const int incl = scan::block_scan<false>(v, s_warp);
    const int carry = s_carry;
    if (i < width) starts[i] = carry + incl - v;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) s_carry = carry + incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) starts[width] = s_carry;
}

// Pass 3.  Dynamic shared memory: kWarps x fanout ints.
__global__ void level_scatter(const int* __restrict__ keys,
                              const float* __restrict__ vals, int d, Level L,
                              const int* __restrict__ tile_parent,
                              const int* __restrict__ prefix_t,
                              const int* __restrict__ starts,
                              const int* __restrict__ parent_starts,
                              int* __restrict__ out_keys,
                              float* __restrict__ out_vals, int clamp_key) {
  extern __shared__ int cursor[];  // [kWarps][fanout]
  const int t = blockIdx.x;
  const int p = tile_parent[t];
  if (p < 0) return;  // no valid pair in the tile (the whole block leaves)
  const int F = L.fanout;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first_tile =
      parent_starts == nullptr ? 0 : parent_starts[p] / L.tile;
  for (int i = threadIdx.x; i < kWarps * F; i += blockDim.x) cursor[i] = 0;
  __syncthreads();
  const long long lo = (long long)t * L.tile;
  const long long hi = min(L.m, lo + L.tile);
  const int sub = (L.tile + kWarps - 1) / kWarps;
  const long long w_lo = min(hi, lo + (long long)warp * sub);
  const long long w_hi = min(hi, w_lo + sub);
  int* my = cursor + warp * F;

  for (long long i0 = w_lo; i0 < w_hi; i0 += 32) {  // warp histogram
    const long long i = i0 + lane;
    int b = 0;
    const bool ok = i < w_hi && bucket_of(keys[i], L, &b);
    const int dg = ok ? b % F : -1 - lane;  // dummies match no other lane
    const unsigned peers = __match_any_sync(0xffffffffu, dg);
    if (ok && __ffs(peers) - 1 == lane) my[dg] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int dg = threadIdx.x; dg < F; dg += blockDim.x) {
    const long long row = (long long)dg * L.n_tiles;
    int at = starts[p * F + dg] + prefix_t[row + t] - prefix_t[row + first_tile];
    for (int w = 0; w < kWarps; ++w) {
      const int c = cursor[w * F + dg];
      cursor[w * F + dg] = at;
      at += c;
    }
  }
  __syncthreads();
  for (long long i0 = w_lo; i0 < w_hi; i0 += 32) {  // stable scatter
    const long long i = i0 + lane;
    int key = 0, b = 0;
    bool ok = false;
    if (i < w_hi) {
      key = keys[i];
      ok = bucket_of(key, L, &b);
    }
    const int dg = ok ? b % F : -1 - lane;
    const unsigned peers = __match_any_sync(0xffffffffu, dg);
    if (ok) {
      const long long dst = my[dg] + __popc(peers & ((1u << lane) - 1u));
      out_keys[dst] = min(key, clamp_key);
      const float* src = vals + i * d;
      float* dv = out_vals + dst * d;
      for (int c = 0; c < d; ++c) dv[c] = src[c];
    }
    __syncwarp();
    if (ok && __ffs(peers) - 1 == lane) my[dg] += __popc(peers);
    __syncwarp();
  }
}

// Pass 4.  Block b < width: the pad slots of bucket b's region; block width:
// the slots after the last region.
__global__ void fill_pads(const int* __restrict__ totals,
                          const int* __restrict__ starts, int width,
                          long long np, int d, int fill_key,
                          int* __restrict__ out_keys,
                          float* __restrict__ out_vals) {
  const int j = blockIdx.x;
  const long long lo = j < width ? (long long)starts[j] + totals[j]
                                 : (long long)starts[width];
  const long long hi = j < width ? (long long)starts[j + 1] : np;
  for (long long s = lo + threadIdx.x; s < hi; s += blockDim.x)
    out_keys[s] = fill_key;
  for (long long e = lo * d + threadIdx.x; e < hi * d; e += blockDim.x)
    out_vals[e] = 0.0f;
}

// Scratch of a partition, carved from one buffer.
struct Scratch {
  int* counts_t;
  int* prefix_t;
  int* tile_parent;
  int* totals;
  int* starts[2];
  int* keys[2];
  float* vals[2];
};

inline size_t align_up(size_t x) { return (x + 255) / 256 * 256; }

// Bytes of scratch for levels lv[0..L); fills *s when base is not null.
inline size_t carve(const Level* lv, int L, int d, char* base, Scratch* s) {
  size_t cells = 0, tiles = 0, width = 0, inner = 0;
  for (int i = 0; i < L; ++i) {
    cells = cells > (size_t)lv[i].fanout * lv[i].n_tiles
                ? cells : (size_t)lv[i].fanout * lv[i].n_tiles;
    tiles = tiles > (size_t)lv[i].n_tiles ? tiles : (size_t)lv[i].n_tiles;
    width = width > (size_t)lv[i].width ? width : (size_t)lv[i].width;
    if (i + 1 < L && (size_t)lv[i].np > inner) inner = (size_t)lv[i].np;
  }
  const int n_bufs = L >= 3 ? 2 : (L == 2 ? 1 : 0);
  size_t sizes[] = {cells * 4, cells * 4, tiles * 4, width * 4,
                    (width + 1) * 4, (width + 1) * 4,
                    inner * 4, inner * 4, inner * d * 4, inner * d * 4};
  const bool used[] = {true, true, true, true, true, true, n_bufs > 0,
                       n_bufs > 1, n_bufs > 0, n_bufs > 1};
  void** slots_[] = {(void**)&s->counts_t, (void**)&s->prefix_t,
                     (void**)&s->tile_parent, (void**)&s->totals,
                     (void**)&s->starts[0], (void**)&s->starts[1],
                     (void**)&s->keys[0], (void**)&s->keys[1],
                     (void**)&s->vals[0], (void**)&s->vals[1]};
  size_t off = 0;
  for (int i = 0; i < 10; ++i) {
    if (!used[i]) {
      if (base) *slots_[i] = nullptr;
      continue;
    }
    if (base) *slots_[i] = base + off;
    off += align_up(sizes[i] > 0 ? sizes[i] : 4);
  }
  return off;
}

#define RADIX_CHECK()                                  \
  do {                                                 \
    cudaError_t e_ = cudaGetLastError();               \
    if (e_ != cudaSuccess) return e_;                  \
  } while (0)

// All levels: the last one writes the leaf layout into out_keys / out_vals /
// starts_out[0..nb of the last level).
inline cudaError_t partition(const Level* lv, int L, const int* keys,
                             const float* vals, int d, int key_space, int pad,
                             int* out_keys, float* out_vals, int* starts_out,
                             void* scratch, cudaStream_t stream) {
  Scratch s;
  carve(lv, L, d, (char*)scratch, &s);
  const int* in_k = keys;
  const float* in_v = vals;
  const int* parent_starts = nullptr;
  for (int i = 0; i < L; ++i) {
    const Level& l = lv[i];
    const bool last = i + 1 == L;
    int* ok = last ? out_keys : s.keys[i & 1];
    float* ov = last ? out_vals : s.vals[i & 1];
    int* st = s.starts[i & 1];
    // inner layouts pad with -1, a key no level takes, and keep their keys
    const int fill = last ? key_space : -1;
    const int clamp = last ? key_space : 0x7fffffff;
    cudaMemsetAsync(s.totals, 0, sizeof(int) * l.width, stream);
    RADIX_CHECK();
    if (l.n_tiles > 0) {
      level_hist<<<l.n_tiles, kThreads, sizeof(int) * l.fanout, stream>>>(
          in_k, l, s.counts_t, s.tile_parent, s.totals);
      RADIX_CHECK();
      column_scan<<<l.fanout, kScanThreads, 0, stream>>>(
          s.counts_t, s.prefix_t, l.n_tiles);
      RADIX_CHECK();
    }
    starts_scan<<<1, kScanThreads, 0, stream>>>(s.totals, st, l.width, pad);
    RADIX_CHECK();
    fill_pads<<<l.width + 1, kThreads, 0, stream>>>(s.totals, st, l.width,
                                                    l.np, d, fill, ok, ov);
    RADIX_CHECK();
    if (l.n_tiles > 0) {
      level_scatter<<<l.n_tiles, kThreads, sizeof(int) * kWarps * l.fanout,
                      stream>>>(in_k, in_v, d, l, s.tile_parent, s.prefix_t,
                                st, parent_starts, ok, ov, clamp);
      RADIX_CHECK();
    }
    if (last) {
      cudaMemcpyAsync(starts_out, st, sizeof(int) * l.nb,
                      cudaMemcpyDeviceToDevice, stream);
      RADIX_CHECK();
    }
    in_k = ok;
    in_v = ov;
    parent_starts = st;
  }
  return cudaSuccess;
}

}  // namespace radix
