// One block's fold of a range of pairs into a [block_k, cols] f32 table in
// shared memory, with add, max or min, in the order of the pairs and with
// no atomics.  Shared by segment_reduce.cu (a range of the sort flow's
// layout, one key block) and keyed_fold.cuh (a segment of an unsorted
// chunk, one key tile): pairs whose key lies outside [key0, key0 +
// block_k) or outside [0, K) are skipped.
//
// The range streams through a ring of kRing stages filled with 4-byte
// cp.async, two stages ahead.  Two block shapes, chosen by the caller's
// plan:
//   W == 1   one warp reads every pair of a stage, 32 at a time; lanes
//            with the same key find each other with one ballot per key bit
//            (match_bits) and the lowest folds their values in lane order.
//            For small tables, where many such blocks fit on an SM.
//   W == 8   the block buckets each stage of up to kMaxStage pairs by owner
//            (warp w owns the local keys with id % 8 == w): counts per
//            (owner, 32-pair window) from ballots on the owner's bits,
//            each warp scans its owner's row, and the pairs' indices are
//            scattered stably; three barriers a stage.  Each warp then
//            walks its own list 32 entries at a time: every lane claims its
//            key's byte, and where no claim was lost each lane folds its
//            own pair, else lanes with the same key are matched as above.
// Either way each key's pairs fold in range order, so a fold of ranges
// joined in order is the fold of the pairs in index order.  The work per
// pair does not depend on block_k.
//
// With CNT (sums only) the table's last column, d - 1, counts the pairs
// that land: vals rows hold the d - 1 value columns alone, and the ring's
// counts column is set to 1.0 once, before the first stage, and never
// copied, so nothing is read for it.
//
// combine<OP>(a, b) folds b after a.  Max and min follow the JAX package's
// rules: +0 beats -0 under max and -0 under min in either order, a NaN
// beats every number and keeps its bits, and between two NaNs max keeps a
// when a is negative and min keeps a when a is positive, else b (what
// jnp.maximum / jnp.minimum select on the CPU; repro_torch/numerics.py).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "device_prims.cuh"

namespace fold_table {

enum Op { kAdd = 0, kMax = 1, kMin = 2 };

constexpr int kTableFloats = 32768;  // 128 KB of table per block at most
constexpr int kMaxCols = 64;
constexpr int kRing = 3;  // stages in shared memory, two in flight
constexpr int kMaxStage = 1024;  // pairs per stage (bucketed warps)
constexpr int kBallotStage = 256;  // pairs per stage (one warp)
constexpr int kSmemBytes = 232448 - 256;  // dynamic shared memory a block
                                          // may use on an H100 (the rest
                                          // for its static shared memory)
constexpr int kBucketWarps = 8;  // warps of a block that buckets

template <int OP>
__device__ __forceinline__ float identity() {
  if (OP == kAdd) return 0.0f;
  if (OP == kMax) return -INFINITY;
  return INFINITY;
}

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  if (OP == kAdd) return a + b;
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb)
    return na && (!nb || (signbit(a) != 0) == (OP == kMax)) ? a : b;
  if (a == b) {  // equal values; for +0 and -0 pick the sign JAX picks
    if (OP == kMax) return signbit(a) ? b : a;
    return signbit(a) ? a : b;
  }
  if (OP == kMax) return a > b ? a : b;
  return a < b ? a : b;
}

// The shapes of one block's fold.  kbits: bits of a local key, block_k <=
// 2^kbits.  stage: pairs per ring stage (a multiple of 32; kBallotStage for
// one warp, at most kMaxStage when bucketed).
struct Geom {
  int d, k, block_k, cols, stage, kbits;
};

inline int key_bits(int block_k) {
  int b = 0;
  while ((1LL << b) < block_k) ++b;
  return b;
}

// Dynamic shared memory of a block of `warps` warps: the table, the ring
// of keys and values, and when bucketed the stage's list, the [owner,
// window] counts and a claim byte per local key.
inline size_t smem_bytes(int block_k, int cols, int stage, int warps) {
  const size_t table = (size_t)block_k * cols * 4;
  const size_t ring = (size_t)kRing * stage * (1 + cols) * 4;
  if (warps == 1) return table + ring;
  return table + ring + (size_t)stage * 4 + ((size_t)stage + 32) * 4 +
         (size_t)(block_k + 15) / 16 * 16;
}

using prims::cp_async4;
using prims::cp_async_commit;
using prims::cp_async_wait;
using prims::match_bits;

// Lanes holding pairs of the same local key lk (>= 0) fold them into the
// table, the lowest lane in lane order; a lane's pair is sv[src(lane)].
// The row is carried in registers kFoldCols columns at a time, so that the
// columns' folds run side by side.
constexpr int kFoldCols = 4;

template <int OP, typename Src>
__device__ __forceinline__ void fold_lanes(float* table, int lk, unsigned same,
                                           const float* sv, int nc, Src src) {
  const int lane = threadIdx.x & 31;
  if (lk >= 0 && __ffs(same) - 1 == lane) {
    float* row = table + lk * nc;
    for (int c0 = 0; c0 < nc; c0 += kFoldCols) {
      float r[kFoldCols];
#pragma unroll
      for (int c = 0; c < kFoldCols; ++c)
        if (c0 + c < nc) r[c] = row[c0 + c];
      for (unsigned rest = same; rest != 0; rest &= rest - 1) {
        const float* v = sv + src(__ffs(rest) - 1) * nc + c0;
#pragma unroll
        for (int c = 0; c < kFoldCols; ++c)
          if (c0 + c < nc) r[c] = combine<OP>(r[c], v[c]);
      }
#pragma unroll
      for (int c = 0; c < kFoldCols; ++c)
        if (c0 + c < nc) row[c0 + c] = r[c];
    }
  }
}

// Fold pairs [lo, hi), columns [col0, col0 + nc), keys in [key0, key0 +
// block_k) into the [block_k][nc] table at the start of `smem` (set to the
// identity first).  Every thread of the block calls it; it ends with a
// barrier, after which the table is complete.
template <int OP, int W, bool CNT = false>
__device__ __forceinline__ void fold_range(const int* __restrict__ keys,
                                           const float* __restrict__ vals,
                                           const Geom& g, int key0, int col0,
                                           int nc, long long lo, long long hi,
                                           unsigned char* smem) {
  static_assert(!CNT || OP == kAdd, "the counts column is a sum");
  constexpr int kThreads = W * 32;
  const int S = g.stage;
  // value columns of a vals row, and of this tile (the rest: counts)
  const int vd = CNT ? g.d - 1 : g.d;
  const int nv = CNT ? max(0, min(nc, vd - col0)) : nc;
  float* table = reinterpret_cast<float*>(smem);  // [block_k][nc]
  int* s_keys = reinterpret_cast<int*>(table + (size_t)g.block_k * g.cols);
  float* s_vals = reinterpret_cast<float*>(s_keys + kRing * S);  // [S][nc]
  // bucketed warps: the stage's indices grouped by owner, and the [owner,
  // window] counts, then their exclusive scan
  constexpr int kBucket = W > 1;
  const int NW = S / 32;  // windows of a stage
  const int RS = NW + 1;  // a row of counts, padded against bank conflicts
  int* s_list = reinterpret_cast<int*>(s_vals + (size_t)kRing * S * g.cols);
  int* s_cnt = s_list + S;
  // a byte per local key: the lane that last claimed it (owner warps only)
  unsigned char* s_tag = reinterpret_cast<unsigned char*>(s_cnt + S + 32);
  __shared__ int s_tot[W];
  constexpr int kOwnBits = W == 1 ? 0 : W == 2 ? 1 : W == 4 ? 2 : W == 8 ? 3
                           : W == 16 ? 4 : 5;
  static_assert(W == 1 || kMaxStage / 32 <= 32, "a row of counts is a warp");
  const int key_bits = max(0, g.kbits - kOwnBits);  // beside the owner's
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < g.block_k * nc; i += kThreads)
    table[i] = identity<OP>();
  if (CNT && nv < nc)  // the tile holds the counts column: ones, once
    for (int i = tid; i < kRing * S; i += kThreads)
      s_vals[(size_t)(i / S) * S * g.cols + (size_t)(i % S) * nc + nv] =
          1.0f;

  auto fetch = [&](int st) {
    const long long c0 = lo + (long long)st * S;
    if (c0 < hi) {
      const int m = (int)min((long long)S, hi - c0);
      const int buf = st % kRing;
      int* sk = s_keys + buf * S;
      float* sv = s_vals + (size_t)buf * S * g.cols;
      for (int i = tid; i < m; i += kThreads) cp_async4(sk + i, keys + c0 + i);
      if (!CNT && nc == g.d) {
        const float* src = vals + c0 * g.d;
        for (int i = tid; i < m * nc; i += kThreads) cp_async4(sv + i, src + i);
      } else {
        for (int i = tid; i < m * nv; i += kThreads) {
          const int row = i / nv, c = i - row * nv;
          cp_async4(sv + row * nc + c, vals + (c0 + row) * vd + col0 + c);
        }
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  fetch(0);
  fetch(1);
  cp_async_wait<1>();  // stage 0 has landed (1 may be in flight)
  __syncthreads();  // ... for every thread, and the table is set
  for (int st = 0; lo + (long long)st * S < hi; ++st) {
    const long long c0 = lo + (long long)st * S;
    const int m = (int)min((long long)S, hi - c0);
    const int buf = st % kRing;
    const int* sk = s_keys + buf * S;
    const float* sv = s_vals + (size_t)buf * S * g.cols;
    if (!kBucket) {  // every warp reads every window, folds its own keys
      fetch(st + 2);  // into the buffer of stage st - 1
      for (int j0 = 0; j0 < m; j0 += 32) {
        const int j = j0 + lane;
        const int key = j < m ? sk[j] : -1;
        const int lk = key - key0;
        const bool mine = j < m && key >= 0 && key < g.k &&
                          (unsigned)lk < (unsigned)g.block_k &&
                          (W == 1 || (lk & (W - 1)) == warp);
        if (!__any_sync(0xffffffffu, mine)) continue;
        const unsigned same = match_bits(lk, mine, kOwnBits, key_bits);
        fold_lanes<OP>(table, mine ? lk : -1, same, sv, nc,
                       [&](int l) { return j0 + l; });
      }
      cp_async_wait<1>();  // stage st + 1 has landed
      __syncthreads();
      continue;
    }
    // bucketed: warp w counts windows w, w + W, ... by owner, stably
    constexpr int kWin = kBucket ? kMaxStage / 32 / W : 1;
    int own[kWin], rank[kWin];
#pragma unroll
    for (int i = 0; i < kWin; ++i) {
      const int jw = warp + i * W;
      own[i] = -1;
      rank[i] = 0;
      if (jw < NW) {
        const int j = jw * 32 + lane;
        const int key = j < m ? sk[j] : -1;
        const int lk = key - key0;
        const bool ok = j < m && key >= 0 && key < g.k &&
                        (unsigned)lk < (unsigned)g.block_k;
        const int o = lk & (W - 1);
        const unsigned peers = match_bits(o, ok, 0, kOwnBits);
        rank[i] = __popc(peers & ((1u << lane) - 1u));
        if (lane < W) s_cnt[lane * RS + jw] = 0;
        __syncwarp();
        if (ok && rank[i] == 0) s_cnt[o * RS + jw] = __popc(peers);
        own[i] = ok ? o : -1;
      }
    }
    __syncthreads();  // counts written; every warp is past stage st - 1
    fetch(st + 2);  // into the buffer of stage st - 1
    {  // warp w: exclusive scan of owner w's row of counts
      const int c = lane < NW ? s_cnt[warp * RS + lane] : 0;
      int incl = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane < NW) s_cnt[warp * RS + lane] = incl - c;
      if (lane == 31) s_tot[warp] = incl;
    }
    __syncthreads();
    // lane o holds owner o's start: the exclusive scan of the row totals
    const int tot = lane < W ? s_tot[lane] : 0;
    int first = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, first, off);
      if (lane >= off) first += y;
    }
    first -= tot;
#pragma unroll
    for (int i = 0; i < kWin; ++i) {
      const int base = __shfl_sync(0xffffffffu, first, max(own[i], 0));
      if (own[i] >= 0)
        s_list[base + s_cnt[own[i] * RS + warp + i * W] + rank[i]] =
            (warp + i * W) * 32 + lane;
    }
    cp_async_wait<1>();  // stage st + 1 has landed
    __syncthreads();
    // warp w folds its own list, in stage order
    const int begin = __shfl_sync(0xffffffffu, first, warp);
    const int end = begin + __shfl_sync(0xffffffffu, tot, warp);
    for (int e0 = begin; e0 < end; e0 += 32) {
      const int src = e0 + lane < end ? s_list[e0 + lane] : -1;
      const int lk = src >= 0 ? sk[src] - key0 : -1;
      // keys seldom repeat within 32 entries: each lane claims its key's
      // byte, and only if a claim was lost do lanes match keys bit by bit
      if (lk >= 0) s_tag[lk] = (unsigned char)lane;
      __syncwarp();
      const bool lost = lk >= 0 && s_tag[lk] != lane;
      if (!__any_sync(0xffffffffu, lost)) {
        if (lk >= 0) {
          float* row = table + lk * nc;
          for (int c = 0; c < nc; ++c)
            row[c] = combine<OP>(row[c], sv[src * nc + c]);
        }
      } else {
        const unsigned same = match_bits(lk, src >= 0, kOwnBits, key_bits);
        const int* lst = s_list + e0;
        fold_lanes<OP>(table, lk, same, sv, nc,
                       [&](int l) { return lst[l]; });
      }
      __syncwarp();  // the claims are read before the next entries'
    }
  }
  __syncthreads();
}

}  // namespace fold_table
