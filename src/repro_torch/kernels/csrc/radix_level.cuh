// The stable radix partition as passes (radix_partition.cu launches them
// for the one-level partition and for the hierarchy alike).
//
// What a pass computes.  Every input pair whose key k >= 0 has a bucket id
// b = k / range below `buckets` is "valid"; b splits into a parent
// p = b / digits and a digit b - p * digits.  The first pass has one parent
// (digits == buckets).  An inner pass reads the previous pass's layout, in
// which parent p's pairs fill [starts[p], starts[p] + totals[p]) in order,
// and partitions each parent region on its own.  Bucket b gets the output
// region that starts at starts[b], the exclusive prefix sum over buckets of
// each bucket's count rounded up to a multiple of pad; its valid pairs fill
// it in input order.  The last pass pads with pad_align: the rest of each
// region and the slots after the last one hold fill_key and zero values,
// and keys clamp to key_space.  An inner pass has pad 1 (its layout is
// compact, with no pad or trailing slot) and keeps its keys.  Invalid pairs
// are dropped.  Each pass is a stable partition of the one before, so the
// last pass's layout is the one-level partition's at its range.
//
// The plan (Python: repro_torch.kernels.radix_partition.partition_plan)
// gives each pass its range, digits, buckets, parents, tile, grid and
// whether the scatter stages the values.  A
// tile is at most `tile` pairs of one parent region: the first pass cuts
// [0, n) into tiles; an inner pass cuts each parent region, its tiles in
// parent order, tile_off[p] being the first tile of parent p (written by
// the previous pass's scan).  Its grid is the bound ceil(n / tile) +
// parents; blocks past tile_off[parents] have no tile.
//
// Three launches a pass, all deterministic (no float atomic, and the one
// integer atomic, a ticket, only picks the block that runs the last scan):
//   1 hist     a warp a tile, reading its keys only: each lane counts its
//              keys' digits in its own byte counters, with no atomic and
//              no barrier, and the warp sums the lanes' counters into the
//              tile's column of the [digits, tiles] count matrix.
//   2 scan     one block per digit: the exclusive prefix of its row over
//              tiles, and each parent's total of the digit (the difference
//              of the prefix at the parent's first and last tile).  The
//              last block to finish scans the totals into starts (and the
//              caller's starts in the last pass) and the next pass's tile
//              plan.
//   3 scatter  a block a tile.  The tile's keys and its T x D values come
//              into shared memory by cp.async (16-byte copies, 4-byte ones
//              at a span's unaligned ends); values too wide for a tile of
//              kThreads pairs to share an SM four ways stay in device
//              memory (`staged` 0), where a pair's row is already a
//              contiguous run.  Warps own contiguous slices; a
//              pair's rank among its warp's pairs of its digit comes from
//              ballots, one per digit bit (lanes with the same digit find
//              each other), and a running count per (warp, digit); a scan over
//              (digit, warp) gives each pair its slot in the tile's staged
//              order: bucket runs in bucket order, input order inside each.
//              Then the block writes each run to
//              starts[b] + (pairs of b in earlier tiles of the parent),
//              consecutive threads on consecutive slots: at D <= 2 a thread
//              writes a pair's key and values (one 8-byte store at D = 2),
//              else keys as one run and values as one flat run of r x D
//              floats.  The tile holding a
//              bucket's last pair also writes the bucket's pad slots, and
//              all blocks share the trailing slots.
//
// Bound on this card: bytes.  A pass reads its input keys twice and its
// values once, and writes every output slot once; the scans touch
// digits x tiles ints.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "device_prims.cuh"

namespace radix {

constexpr int kThreads = 256;  // hist / scatter blocks
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 512;
// digits of a pass (ops.KERNEL_MAX_LEVEL_BUCKETS)
constexpr int kMaxBuckets = 256;
constexpr int kMaxPasses = 8;
constexpr int kMaxTile = 255 * 32;  // a lane's hist count fits a byte
constexpr int kSmemBytes = 232448 - 256;  // dynamic; the rest for static
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic, with no attribute
constexpr int kPassFields = 7;  // range, digits, buckets, parents, tile,
                                // grid, staged

struct Pass {
  int range;      // bucket id = key / range, computed as
  unsigned magic; // (umulhi(key, magic) + key) >> shift for a key >= 0
  int shift;
  int digits;     // digit = id - parent * digits
  int bits;       // ceil(log2(digits)): the ballots a 32-pair step takes
  int buckets;    // valid ids: [0, buckets)
  int parents;    // 1 in the first pass
  int tile;       // pairs of a tile at most, a multiple of kThreads
  int grid;       // tile blocks (a bound in an inner pass)
  int staged;     // 1: the scatter stages the tile's values in shared memory
  int last;       // the last pass: pads, clamps and fills the trailing slots
  int pad;        // region alignment: pad_align in the last pass, else 1
  int fill;       // key of a pad slot (last pass)
  int clamp;      // largest key written
  int limit;      // keys at or past it are dropped too
  long long n;    // input pairs of the first pass (bounds every layout)
  long long slots;  // output slots: the padded layout, or n inside
};

// The previous pass's layout as an inner pass reads it; all null in the
// first pass.
struct Parents {
  const int* starts;    // [parents + 1]
  const int* totals;    // [parents]
  const int* tile_off;  // [parents + 1]: first tile of each parent
};

inline long long slots(long long n, int nb, int pad) {
  long long s = n + (long long)nb * pad + pad;  // + the trailing region
  return (s + pad - 1) / pad * pad;
}

__host__ __device__ inline size_t a16(size_t x) { return (x + 15) / 16 * 16; }

// Dynamic shared memory of a scatter block (radix_partition.py
// scatter_smem_bytes): the staged values and the keys (4 words of slack
// each for the alignment shift), a meta word and a slot per pair, per-warp
// digit counts and five words a digit.
__host__ __device__ inline size_t vals_smem(int tile, int d, int staged) {
  return staged ? a16(((size_t)tile * d + 4) * 4) : 0;
}

inline size_t scatter_smem(int tile, int digits, int d, int staged) {
  return vals_smem(tile, d, staged) + a16(((size_t)tile + 4) * 4) +
         (size_t)tile * 8 + (size_t)(kWarps + 5) * digits * 4;
}

inline int ceil_log2(int x) {
  int b = 0;
  while ((1 << b) < x) ++b;
  return b;
}

// The passes of a partition of n pairs, from the plan's kPassFields ints a
// pass; 0 if the plan is not one the kernels take.  Keys at or past limit
// are dropped as negative ones are (the keyed fold's partitioned route
// drops the sentinel key_space so; the sort flow keeps it in the last
// bucket).
inline int read_passes(long long n, int d, int key_space, int pad_align,
                       const int* f, int n_passes, Pass* ps,
                       int limit = 0x7fffffff) {
  if (n < 1 || d < 0 || key_space < 1 || pad_align < 1 || n_passes < 1 ||
      n_passes > kMaxPasses)
    return 0;
  for (int i = 0; i < n_passes; ++i) {
    Pass& p = ps[i];
    const int* g = f + i * kPassFields;
    p.range = g[0];
    p.digits = g[1];
    p.buckets = g[2];
    p.parents = g[3];
    p.tile = g[4];
    p.grid = g[5];
    p.staged = g[6];
    if (p.range < 1 || p.digits < 1 || p.digits > kMaxBuckets ||
        (p.staged != 0 && p.staged != 1) ||
        p.tile < kThreads || p.tile % kThreads != 0 || p.tile > kMaxTile ||
        p.buckets != (int)(((long long)key_space + p.range - 1) / p.range) ||
        scatter_smem(p.tile, p.digits, d, p.staged) > (size_t)kSmemBytes)
      return 0;
    const long long tiles = (n + p.tile - 1) / p.tile;
    if (i == 0) {
      if (p.parents != 1 || p.digits != p.buckets || p.grid != tiles)
        return 0;
    } else {
      const Pass& q = ps[i - 1];
      if (p.parents != q.buckets ||
          (long long)p.range * p.digits != q.range ||
          p.grid != tiles + p.parents)
        return 0;
    }
    const bool last = i + 1 == n_passes;
    // division by the invariant range (Granlund and Montgomery): exact
    // for every key below 2^31
    p.shift = ceil_log2(p.range);
    p.magic = (unsigned)((((1ull << p.shift) - p.range) << 32) / p.range + 1);
    p.bits = ceil_log2(p.digits);
    p.last = last;
    p.pad = last ? pad_align : 1;
    p.fill = key_space;
    p.clamp = last ? key_space : 0x7fffffff;
    p.limit = limit;
    p.n = n;
    p.slots = last ? slots(n, p.buckets, pad_align) : n;
    if (p.slots * (d > 0 ? d : 1) > 0x7fffffffLL ||
        (long long)p.digits * (p.grid + 1) > 0x7fffffffLL)
      return 0;
  }
  return n_passes;
}

__device__ __forceinline__ bool bucket_of(int key, const Pass& P, int* b) {
  if (key < 0 || key >= P.limit) return false;
  *b = (int)((__umulhi((unsigned)key, P.magic) + (unsigned)key) >> P.shift);
  return *b < P.buckets;
}

using prims::cp_async16;
using prims::cp_async4;
using prims::cp_async_commit;
using prims::cp_async_wait;
using prims::match_bits;

// Words of 4 bytes: the shift that puts g's address modulo 16 on a
// 16-byte-aligned shared buffer.
__device__ __forceinline__ int shift_of(const void* g) {
  return (int)(((uintptr_t)g & 15) >> 2);
}

// count words from g to s, where s and g agree modulo 16: 16-byte copies,
// and 4-byte ones at the unaligned head and tail.
__device__ __forceinline__ void load_span(float* s, const float* g,
                                          int count) {
  const int head = min(count, (4 - shift_of(g)) & 3);
  const int body = (count - head) >> 2;
  for (int i = threadIdx.x; i < head; i += kThreads) cp_async4(s + i, g + i);
  for (int i = threadIdx.x; i < body; i += kThreads)
    cp_async16(s + head + 4 * i, g + head + 4 * i);
  for (int i = head + 4 * body + threadIdx.x; i < count; i += kThreads)
    cp_async4(s + i, g + i);
}

// Tile t of a pass: its pairs [lo, hi), its parent and the parent's tiles
// [t0, t1).  False when the pass has no tile t.
struct Tile {
  long long lo, hi;
  int p, t0, t1;
};

__device__ bool tile_of(int t, const Pass& P, const Parents& par, Tile* tl) {
  if (par.tile_off == nullptr) {
    tl->lo = (long long)t * P.tile;
    tl->hi = min(P.n, tl->lo + P.tile);
    tl->p = 0;
    tl->t0 = 0;
    tl->t1 = P.grid;
    return true;
  }
  if (t >= par.tile_off[P.parents]) return false;
  int lo = 0, hi = P.parents;  // the last p with tile_off[p] <= t
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (par.tile_off[mid] <= t) lo = mid; else hi = mid;
  }
  const int p = lo;
  tl->p = p;
  tl->t0 = par.tile_off[p];
  tl->t1 = par.tile_off[p + 1];
  const long long base = par.starts[p];
  tl->lo = base + (long long)(t - tl->t0) * P.tile;
  tl->hi = min(base + par.totals[p], tl->lo + P.tile);
  return true;
}

// Each warp ranks its slice of the tile, 32 pairs a step in order: for
// each valid pair i (i < len) of the keys k, meta[i] = digit << 16 | the
// pair's rank among the warp's earlier pairs of its digit, from the
// ballots of its peers and the warp's running count of each digit in my.
__device__ __forceinline__ void rank_slice(const Pass& P, int p, int len,
                                           const int* k, int* my,
                                           int* meta) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = P.tile / kWarps, base = warp * sub;
  const unsigned lower = (1u << lane) - 1u;
  for (int s = base; s < base + sub && s < len; s += 32) {
    const int i = s + lane;
    int b = 0;
    const bool ok = i < len && bucket_of(k[i], P, &b);
    const int dg = ok ? b - p * P.digits : 0;
    const unsigned peers = match_bits(dg, ok, 0, P.bits);
    if (ok) meta[i] = dg << 16 | (my[dg] + __popc(peers & lower));
    __syncwarp();
    if (ok && (peers & lower) == 0) my[dg] += __popc(peers);
    __syncwarp();
  }
}

// Pass 1.  Dynamic shared memory: hist_smem(digits).  Each warp counts
// one tile on its own, with no barrier: counts need no order, so each lane
// counts the keys it loads (kHistBatch at a time, the loads overlapping)
// into its own byte counters, four digits a word (a register when there is
// one word), and the warp sums its lanes' bytes word by word
// (__reduce_add_sync).  A lane sees at most tile / 32 <= 255 keys, so a
// byte does not overflow.
constexpr int kHistBatch = 16;

inline size_t hist_smem(int digits) {
  return (size_t)kWarps * ((digits + 3) / 4) * 32 * 4;
}

__global__ void __launch_bounds__(kThreads)
pass_hist(const int* __restrict__ keys, Pass P, Parents par,
          int* __restrict__ counts, int* __restrict__ ticket) {
  extern __shared__ unsigned s_priv[];  // [kWarps][words][32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + warp, F = P.digits;
  const int words = (F + 3) / 4;
  const long long stride = (long long)P.grid + 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) *ticket = 0;  // for the scan
  if (t >= P.grid) return;
  Tile tl;
  if (!tile_of(t, P, par, &tl)) {
    for (int dg = lane; dg < F; dg += 32) counts[dg * stride + t] = 0;
    return;
  }
  unsigned* mine = s_priv + warp * words * 32 + lane;
  for (int w = 0; w < words; ++w) mine[w * 32] = 0;
  const int len = (int)(tl.hi - tl.lo);
  const int* k = keys + tl.lo;
  unsigned reg = 0;  // the one word of up to four digits, in a register
  for (int s0 = 0; s0 < len; s0 += 32 * kHistBatch) {
    int kv[kHistBatch];
#pragma unroll
    for (int u = 0; u < kHistBatch; ++u) {
      const int i = s0 + u * 32 + lane;
      kv[u] = i < len ? __ldg(k + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kHistBatch; ++u) {
      int b;
      if (bucket_of(kv[u], P, &b)) {
        const int dg = b - tl.p * F;
        if (words == 1)
          reg += 1u << (dg * 8);
        else
          mine[(dg >> 2) * 32] += 1u << ((dg & 3) * 8);
      }
    }
  }
  if (words == 1) mine[0] = reg;
  for (int w = 0; w < words; ++w) {
    const unsigned x = mine[w * 32];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int dg = 4 * w + q;
      const unsigned c = __reduce_add_sync(0xffffffffu, (x >> (8 * q)) & 255u);
      if (lane == (dg & 31) && dg < F) counts[dg * stride + t] = (int)c;
    }
  }
}

// Pass 2.  Block dg: row dg of counts -> its exclusive prefix over tiles
// (column `grid` = the row's total), and totals[p * digits + dg].  The last
// block: starts[0 .. buckets] (padded), user_starts[0 .. buckets) when not
// null, and next_off[0 .. buckets] (the next pass's tiles of next_tile
// pairs) when not null.
__global__ void __launch_bounds__(kScanThreads)
pass_scan(Pass P, Parents par, int* __restrict__ counts,
          int* __restrict__ totals, int* __restrict__ starts,
          int* __restrict__ user_starts, int* __restrict__ next_off,
          int next_tile, int* __restrict__ ticket) {
  __shared__ int s_warp[32];
  __shared__ int s_carry[2];
  __shared__ bool s_last;
  const int dg = blockIdx.x, F = P.digits;
  const long long stride = (long long)P.grid + 1;
  int* row = counts + dg * stride;
  if (threadIdx.x == 0) s_carry[0] = 0;
  __syncthreads();
  for (int base = 0; base < P.grid; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < P.grid ? row[i] : 0;
    const int incl = scan::block_scan<false>(v, s_warp);
    const int carry = s_carry[0];
    if (i < P.grid) row[i] = carry + incl - v;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) s_carry[0] = carry + incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) row[P.grid] = s_carry[0];
  __syncthreads();
  for (int p = threadIdx.x; p < P.parents; p += kScanThreads) {
    const int b = p * F + dg;
    if (b >= P.buckets) continue;
    const int t0 = par.tile_off ? par.tile_off[p] : 0;
    const int t1 = par.tile_off ? par.tile_off[p + 1] : P.grid;
    totals[b] = row[t1] - row[t0];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x == 0) s_carry[0] = s_carry[1] = 0;
  __syncthreads();
  for (int base = 0; base < P.buckets; base += kScanThreads) {
    const int b = base + threadIdx.x;
    const int c = b < P.buckets ? __ldcg(totals + b) : 0;
    const int v = (c + P.pad - 1) / P.pad * P.pad;
    const int incl = scan::block_scan<false>(v, s_warp);
    const int nt = next_off ? (c + next_tile - 1) / next_tile : 0;
    const int incl_t = scan::block_scan<false>(nt, s_warp);
    const int carry = s_carry[0], carry_t = s_carry[1];
    if (b < P.buckets) {
      starts[b] = carry + incl - v;
      if (user_starts) user_starts[b] = carry + incl - v;
      if (next_off) next_off[b] = carry_t + incl_t - nt;
    }
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) {
      s_carry[0] = carry + incl;
      s_carry[1] = carry_t + incl_t;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    starts[P.buckets] = s_carry[0];
    if (next_off) next_off[P.buckets] = s_carry[1];
  }
}

// Pass 3.  Dynamic shared memory: scatter_smem(tile, digits, d, staged).
__global__ void __launch_bounds__(kThreads)
pass_scatter(const int* __restrict__ keys, const float* __restrict__ vals,
             int d, Pass P, Parents par, const int* __restrict__ counts,
             const int* __restrict__ starts, int* __restrict__ out_keys,
             float* __restrict__ out_vals) {
  extern __shared__ __align__(16) float smem[];
  const int T = P.tile, F = P.digits;
  float* s_vals = smem;  // [T * d + 4] when staged
  int* s_keys = (int*)(smem + vals_smem(T, d, P.staged) / 4);  // [T + 4]
  int* s_meta = s_keys + a16(((size_t)T + 4) * 4) / 4;  // [T]: digit, rank
  int* s_perm = s_meta + T;    // [T]: staged slot -> pair
  int* s_cnt = s_perm + T;     // [kWarps][F]: counts, then slot offsets
  int* s_tcnt = s_cnt + kWarps * F;  // [F]: the tile's pairs of a digit
  int* s_dst = s_tcnt + F;     // [F]: output slot of the tile's first pair
                               //      of a digit, then of staged slot 0
  int* s_rest = s_dst + F;     // [F]: pairs of the bucket from this tile on
  int* s_padn = s_rest + F;    // [F]: pad slots of the bucket
  int* s_scan = s_padn + F;    // [F]: the tile's exclusive prefix over digits
  __shared__ Tile s_tile;
  __shared__ bool s_has;
  __shared__ int s_warp[32];
  __shared__ int s_valid;

  const int t = blockIdx.x;
  if (threadIdx.x == 0) s_has = tile_of(t, P, par, &s_tile);
  for (int i = threadIdx.x; i < kWarps * F; i += kThreads) s_cnt[i] = 0;
  __syncthreads();
  if (s_has) {
    const Tile tl = s_tile;
    const int len = (int)(tl.hi - tl.lo);
    const int* gk = keys + tl.lo;
    const float* gv = vals + tl.lo * d;
    const int sk = shift_of(gk), sv = shift_of(gv);
    load_span((float*)s_keys + sk, (const float*)gk, len);
    cp_async_commit();
    if (P.staged) load_span(s_vals + sv, gv, len * d);
    cp_async_commit();  // an empty group when the values stay in place
    // while the tile flies: where each digit's pairs of the tile go
    const long long stride = (long long)P.grid + 1;
    for (int dg = threadIdx.x; dg < F; dg += kThreads) {
      const int b = tl.p * F + dg;
      if (b >= P.buckets) continue;
      const int* row = counts + dg * stride;
      const int first = row[tl.t0];
      const int before = row[t] - first;  // in earlier tiles of the parent
      const int total = row[tl.t1] - first;
      s_dst[dg] = starts[b] + before;
      s_rest[dg] = total - before;
      s_padn[dg] = total % P.pad == 0 ? 0 : P.pad - total % P.pad;
    }
    for (int i = threadIdx.x; i < T; i += kThreads) s_meta[i] = -1;
    cp_async_wait<1>();  // the keys have landed (the values may not have)
    __syncthreads();
    const int* k = s_keys + sk;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int sub = T / kWarps;
    rank_slice(P, tl.p, len, k, s_cnt + warp * F, s_meta);
    __syncthreads();
    // (digit, warp) counts -> offsets; the tile's count of each digit
    for (int dg = threadIdx.x; dg < F; dg += kThreads) {
      int acc = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_cnt[w * F + dg];
        s_cnt[w * F + dg] = acc;
        acc += c;
      }
      s_tcnt[dg] = acc;
    }
    __syncthreads();
    // exclusive scan over digits: thread i takes digits [i*q, i*q + q)
    const int q = (F + kThreads - 1) / kThreads;
    const int d0 = min(F, (int)threadIdx.x * q), d1 = min(F, d0 + q);
    int mine = 0;
    for (int dg = d0; dg < d1; ++dg) mine += s_tcnt[dg];
    int run = scan::block_scan<false>(mine, s_warp) - mine;
    for (int dg = d0; dg < d1; ++dg) {
      s_scan[dg] = run;
      s_dst[dg] -= run;
      for (int w = 0; w < kWarps; ++w) s_cnt[w * F + dg] += run;
      run += s_tcnt[dg];
    }
    if (threadIdx.x == kThreads - 1) s_valid = run;
    __syncthreads();
    const int* offs = s_cnt + warp * F;  // staged order, a warp its slice
    for (int i = warp * sub + lane; i < min(len, (warp + 1) * sub); i += 32) {
      const int m = s_meta[i];
      if (m >= 0) s_perm[offs[m >> 16] + (m & 0xffff)] = i;
    }
    __syncthreads();
    const int V = s_valid;
    cp_async_wait<0>();  // the values have landed
    __syncthreads();
    const float* v = P.staged ? s_vals + sv : gv;
    if (d <= 1 || (d == 2 && sv % 2 == 0)) {  // a pair's values in one store
      for (int j = threadIdx.x; j < V; j += kThreads) {  // runs of pairs
        const int i = s_perm[j];
        const int dst = s_dst[s_meta[i] >> 16] + j;
        out_keys[dst] = min(k[i], P.clamp);
        if (d == 1)
          out_vals[dst] = v[i];
        else if (d == 2)
          reinterpret_cast<float2*>(out_vals)[dst] =
              reinterpret_cast<const float2*>(v)[i];
      }
    } else {
      for (int j = threadIdx.x; j < V; j += kThreads) {  // key runs
        const int i = s_perm[j];
        const int dst = s_dst[s_meta[i] >> 16] + j;
        out_keys[dst] = min(k[i], P.clamp);
        s_meta[i] = dst;  // for the values
      }
      __syncthreads();
      // value runs, r x D floats each: element e of the staged run is
      // (slot j, column c), stepped without a division
      const int dj = kThreads / d, dc = kThreads % d;
      int j = threadIdx.x / d, c = threadIdx.x % d;
      for (int e = threadIdx.x; e < V * d; e += kThreads) {
        const int i = s_perm[j];
        out_vals[(long long)s_meta[i] * d + c] = v[i * d + c];
        j += dj;
        c += dc;
        if (c >= d) {
          c -= d;
          ++j;
        }
      }
    }
    // the pad slots of the buckets whose last pair is in this tile, a warp
    // a bucket
    for (int dg = warp; dg < F; dg += kWarps) {
      const int c = s_tcnt[dg];
      if (c == 0 || c != s_rest[dg] || s_padn[dg] == 0) continue;
      const int lo = s_dst[dg] + s_scan[dg] + c;
      const int np = s_padn[dg];
      for (int s = lane; s < np; s += 32) out_keys[lo + s] = P.fill;
      for (int e = lane; e < np * d; e += 32)
        out_vals[(long long)lo * d + e] = 0.0f;
    }
  }
  if (P.last) {  // the trailing slots, shared by every block
    const long long end = starts[P.buckets];
    const long long step = (long long)gridDim.x * kThreads;
    for (long long s = end + (long long)t * kThreads + threadIdx.x;
         s < P.slots; s += step)
      out_keys[s] = P.fill;
    for (long long e = end * d + (long long)t * kThreads + threadIdx.x;
         e < P.slots * d; e += step)
      out_vals[e] = 0.0f;
  }
}

// Scratch of a partition, carved from one buffer.
struct Scratch {
  int* counts;       // [digits][grid + 1], reused by every pass
  int* ticket;
  int* totals[2];    // [buckets]; pass i writes set i & 1
  int* starts[2];    // [buckets + 1]
  int* tile_off[2];  // [buckets + 1]: the next pass's tiles
  int* keys[2];      // [n]: the compact layouts between passes
  float* vals[2];    // [n * d]
};

inline size_t align_up(size_t x) { return (x + 255) / 256 * 256; }

// Bytes of scratch for passes ps[0 .. L); fills *s when base is not null.
inline size_t carve(const Pass* ps, int L, int d, char* base, Scratch* s) {
  size_t cells = 0, width = 0;
  for (int i = 0; i < L; ++i) {
    const size_t c = (size_t)ps[i].digits * (ps[i].grid + 1);
    cells = cells > c ? cells : c;
    width = width > (size_t)ps[i].buckets + 1 ? width
                                              : (size_t)ps[i].buckets + 1;
  }
  const size_t n = L > 1 ? (size_t)ps[0].n : 0;
  const int n_bufs = L >= 3 ? 2 : (L == 2 ? 1 : 0);
  const size_t sizes[] = {cells * 4, 4, width * 4, width * 4, width * 4,
                          width * 4, width * 4, width * 4, n * 4, n * 4,
                          n * d * 4, n * d * 4};
  const bool used[] = {true, true, true, true, true, true, true, true,
                       n_bufs > 0, n_bufs > 1, n_bufs > 0, n_bufs > 1};
  void** slots_[] = {(void**)&s->counts, (void**)&s->ticket,
                     (void**)&s->totals[0], (void**)&s->totals[1],
                     (void**)&s->starts[0], (void**)&s->starts[1],
                     (void**)&s->tile_off[0], (void**)&s->tile_off[1],
                     (void**)&s->keys[0], (void**)&s->keys[1],
                     (void**)&s->vals[0], (void**)&s->vals[1]};
  size_t off = 0;
  for (int i = 0; i < 12; ++i) {
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

// All passes: the last one writes the leaf layout into out_keys / out_vals
// and starts_out[0 .. buckets of the last pass).
inline cudaError_t partition(const Pass* ps, int L, const int* keys,
                             const float* vals, int d, int* out_keys,
                             float* out_vals, int* starts_out, void* scratch,
                             cudaStream_t stream) {
  Scratch s;
  carve(ps, L, d, (char*)scratch, &s);
  const int* in_k = keys;
  const float* in_v = vals;
  Parents par{nullptr, nullptr, nullptr};
  for (int i = 0; i < L; ++i) {
    const Pass& P = ps[i];
    const bool last = i + 1 == L;
    int* ok = last ? out_keys : s.keys[i & 1];
    float* ov = last ? out_vals : s.vals[i & 1];
    int* tot = s.totals[i & 1];
    int* st = s.starts[i & 1];
    int* off = last ? nullptr : s.tile_off[i & 1];
    // shared-memory attributes past the default are asked on every launch:
    // a function-local static here would be one object across every
    // library built from this header
    const size_t hsmem = hist_smem(P.digits);
    cudaError_t err = cudaSuccess;
    if (hsmem > kDefaultSmem)
      err = cudaFuncSetAttribute(
          pass_hist, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)hsmem);
    if (err != cudaSuccess) return err;
    pass_hist<<<(P.grid + kWarps - 1) / kWarps, kThreads, hsmem, stream>>>(
        in_k, P, par, s.counts, s.ticket);
    RADIX_CHECK();
    pass_scan<<<P.digits, kScanThreads, 0, stream>>>(
        P, par, s.counts, tot, st, last ? starts_out : nullptr, off,
        last ? 1 : ps[i + 1].tile, s.ticket);
    RADIX_CHECK();
    const size_t smem = scatter_smem(P.tile, P.digits, d, P.staged);
    if (smem > kDefaultSmem)
      err = cudaFuncSetAttribute(
          pass_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
    if (err != cudaSuccess) return err;
    pass_scatter<<<P.grid, kThreads, smem, stream>>>(in_k, in_v, d, P, par,
                                                     s.counts, st, ok, ov);
    RADIX_CHECK();
    in_k = ok;
    in_v = ov;
    par = Parents{st, tot, off};
  }
  return cudaSuccess;
}

}  // namespace radix
