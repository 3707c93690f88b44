// Lane-table fold: pass 1 of an additive keyed fold into a small table
// (keyed_fold.cuh's third block shape, "lane tables").  Sums only: max and
// min keep the index-order pass of fold_table.cuh, which their NaN rule
// needs.
//
// A block of C warps folds the pairs of its runs whose keys lie in its key
// tile [key0, key0 + block_k) into the columns [col0, col0 + C) of the
// table.  Warp w owns column col0 + w, and each lane of that warp owns a
// private copy of the column, in shared memory laid out with the lane as
// the fastest index,
//     table[(w * block_k + key) * 32 + lane],
// so that every lane stays in its own bank whatever the keys are.  A lane
// folds each of its pairs with one load, one add and one store: no
// ballots, no group leader, no serial fold of other lanes' values, and a
// hot key costs nothing more (32 lanes add to 32 copies of its row).
//
// The pairs come in runs of kStage; block b of the grid's n_seg takes the
// runs b, b + n_seg, b + 2 n_seg, ..., so that the blocks running at one
// time read neighbouring runs.  A run streams through a ring of kRing
// stages in shared memory, filled with cp.async two runs ahead: its keys,
// and the block's columns of its values as [kStage][C] rows, 16 bytes a
// copy where the rows are whole and the sources 16-byte aligned, else 4.
// Each lane takes the pairs lane, lane + 32, ... of a run, in order, into
// registers first, then folds them two at a time: both rows are loaded
// before either is stored, and where the two keys are equal the second add
// starts from the first's result, so the fold is the one of the pairs in
// that order.
//
// At the end each warp joins its 32 copies of a row: lane l takes the keys
// l, l + 32, ..., reads a row's 32 copies as eight 16-byte pieces starting
// at piece l mod 8 (so that the eight lanes of a quarter warp read
// distinct banks) and adds them by a fixed tree.  The order of every add
// is then fixed by the input and the shapes: each lane folds a fixed
// subsequence of the pairs in order, and the join's tree and rotation
// depend on the key alone.  Two runs give the same bits; the sum is not
// the one in index order, which only max and min need.  The result is the
// block's partial, or, with one block, out itself (added onto acc when
// there is one).
//
// With CNT the table's last column, d - 1, counts the pairs that land:
// vals rows hold the d - 1 value columns alone, the ring stages those (a
// block of whole rows stages [kStage][d - 1], in 16-byte pieces where they
// may), and the warp that owns the counts column adds 1.0 for each of its
// lane's pairs in the tile, in the same order as any other column, without
// reading anything for it.  The sum is exact below 2^24 and equals the one
// of a ones column of vals bit for bit.

#pragma once

#include <cuda_runtime.h>

#include "device_prims.cuh"

namespace lane_fold {

constexpr int kRing = 3;  // stages in shared memory, two in flight
constexpr int kStage = 256;  // pairs a run (and a ring stage)
constexpr int kMaxWarps = 8;  // columns of a block, one a warp
constexpr int kPerLane = kStage / 32;  // pairs a lane takes from a run
// blocks of kMaxWarps warps an SM the launch bounds ask for: at most 64
// registers a thread, so 32 warps an SM whatever the block's width
constexpr int kMinBlocks = 4;

// Dynamic shared memory of a block: the lane tables and the ring.
inline size_t smem_bytes(int block_k, int cols) {
  return (size_t)block_k * cols * 32 * 4 +
         (size_t)kRing * kStage * (1 + cols) * 4;
}

using prims::cp_async16;
using prims::cp_async4;
using prims::cp_async_commit;
using prims::cp_async_wait;

// grid (block, key tile, column tile), blocks of C warps.  partial is
// [n_seg, K, D] (unused with one block); acc may be nullptr, or out
// itself (each element is read and then written by one lane).
template <int OP, int C, bool CNT = false>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
    fold_runs(const int* __restrict__ keys, const float* __restrict__ vals,
              const float* acc, float* out, float* __restrict__ partial,
              long long n, int d, int k,
              int block_k, int n_seg) {
  static_assert(OP == 0, "lane tables fold sums only");
  static_assert(C >= 1 && C <= kMaxWarps, "one warp a column");
  constexpr int kThreads = C * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int key0 = blockIdx.y * block_k;
  const unsigned kb = (unsigned)min(block_k, k - key0);  // keys below K
  const int col0 = blockIdx.z * C;
  const int nc = min(C, d - col0);  // columns of this tile
  const int vd = CNT ? d - 1 : d;  // value columns of a vals row
  const int nv = CNT ? max(0, min(nc, vd - col0)) : nc;  // ... of the tile
  const bool whole = nc == d;  // the tile holds whole rows
  const bool wide = whole && ((reinterpret_cast<size_t>(keys) |
                               reinterpret_cast<size_t>(vals)) & 15) == 0;
  // a staged row's stride: whole rows are staged as they lie in vals
  const int rs = CNT && whole ? C - 1 : C;
  const bool ones = CNT && col0 + warp == vd;  // this warp counts
  const long long runs = (n + kStage - 1) / kStage;
  float* table = reinterpret_cast<float*>(smem);  // [C][block_k][32]
  int* s_keys = reinterpret_cast<int*>(table + (size_t)C * block_k * 32);
  float* s_vals = reinterpret_cast<float*>(s_keys + kRing * kStage);

  {
    float4* t4 = reinterpret_cast<float4*>(table);
    for (int i = tid; i < C * block_k * 8; i += kThreads)
      t4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // a column tile's values: thread tid copies the elements tid, tid +
  // kThreads, ... of a run's [m][nv]; row and column advance by fixed steps
  const int nvs = max(nv, 1);
  const int row_step = kThreads / nvs, col_step = kThreads - row_step * nvs;
  const int row_first = tid / nvs, col_first = tid - row_first * nvs;

  auto fetch = [&](int st) {
    const long long r = blockIdx.x + (long long)st * n_seg;
    if (r < runs) {
      const long long c0 = r * kStage;
      const int m = (int)min((long long)kStage, n - c0);
      const int buf = st % kRing;
      int* sk = s_keys + buf * kStage;
      float* sv = s_vals + buf * kStage * C;
      if (wide && m == kStage) {  // 16-byte pieces, a fixed count
#pragma unroll
        for (int i = tid; i < kStage / 4; i += kThreads)
          cp_async16(sk + 4 * i, keys + c0 + 4 * i);
#pragma unroll
        for (int i = tid; i < kStage * rs / 4; i += kThreads)
          cp_async16(sv + 4 * i, vals + c0 * rs + 4 * i);
      } else {
        for (int i = tid; i < m; i += kThreads)
          cp_async4(sk + i, keys + c0 + i);
        if (whole) {
          for (int i = tid; i < m * nv; i += kThreads)
            cp_async4(sv + i, vals + c0 * nv + i);
        } else if (nv > 0) {
          const float* src = vals + c0 * vd + col0;
          int row = row_first, c = col_first;
          while (row < m) {
            cp_async4(sv + row * C + c, src + (long long)row * vd + c);
            row += row_step;
            c += col_step;
            if (c >= nv) {
              c -= nv;
              ++row;
            }
          }
        }
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  // lane's pairs q * 32 + lane of a run, the first m of them real, onto
  // its copies of the rows
  float* mine = table + (size_t)warp * block_k * 32 + lane;
  auto fold = [&](const int* sk, const float* sv, int m) {
    unsigned lk[kPerLane];  // local key; kb or past it: not in the tile
    float v[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int j = q * 32 + lane;
      const bool in = j < m;
      // unsigned: a negative key, or one below key0, lands past kb
      lk[q] = in ? (unsigned)sk[j] - (unsigned)key0 : kb;
      v[q] = in ? (ones ? 1.f : sv[j * rs]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kPerLane; q += 2) {
      const unsigned a = lk[q], b = lk[q + 1];
      const bool oa = a < kb, ob = b < kb;
      float ta = oa ? mine[a * 32] : 0.f;
      float tb = ob ? mine[b * 32] : 0.f;
      ta += v[q];
      tb = (a == b ? ta : tb) + v[q + 1];
      if (oa) mine[a * 32] = ta;
      if (ob) mine[b * 32] = tb;
    }
  };

  fetch(0);
  fetch(1);
  cp_async_wait<1>();  // run 0 has landed (1 may be in flight)
  __syncthreads();  // ... for every thread, and the tables are zero
  for (int st = 0; blockIdx.x + (long long)st * n_seg < runs; ++st) {
    const long long c0 = (blockIdx.x + (long long)st * n_seg) * kStage;
    const int m = (int)min((long long)kStage, n - c0);
    const int buf = st % kRing;
    fetch(st + 2);  // into the buffer of run st - 1
    if (warp < nc) {
      const int* sk = s_keys + buf * kStage;
      const float* sv = s_vals + buf * kStage * C + warp;
      if (m == kStage)
        fold(sk, sv, kStage);  // no pair past the run's end
      else
        fold(sk, sv, m);
    }
    cp_async_wait<1>();  // run st + 1 has landed
    __syncthreads();
  }

  if (warp >= nc) return;
  const float* rows = table + (size_t)warp * block_k * 32;
  const long long row0 = n_seg == 1 ? 0 : (long long)blockIdx.x * k;
  float* dst = n_seg == 1 ? out : partial;
  for (unsigned key = lane; key < kb; key += 32) {
    const float4* row = reinterpret_cast<const float4*>(rows + key * 32);
    float4 p[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) p[t] = row[(t + lane) & 7];
#pragma unroll
    for (int h = 4; h >= 1; h >>= 1)
#pragma unroll
      for (int t = 0; t < h; ++t) {
        p[t].x += p[t + h].x;
        p[t].y += p[t + h].y;
        p[t].z += p[t + h].z;
        p[t].w += p[t + h].w;
      }
    const float sum = (p[0].x + p[0].y) + (p[0].z + p[0].w);
    const long long e = (long long)(key0 + key) * d + col0 + warp;
    dst[row0 * d + e] = n_seg == 1 && acc != nullptr ? acc[e] + sum : sum;
  }
}

}  // namespace lane_fold
