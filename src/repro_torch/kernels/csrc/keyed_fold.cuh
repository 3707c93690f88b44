// Deterministic keyed fold of an unsorted pair chunk into a [K, D] f32 table,
// shared by onehot_fold.cu (sums) and chunk_monoid_fold.cu (add/max/min),
// which fold onto a carried table, and by onehot_combine.cu (sums) and
// combine_scatter.cu (add/max/min), which build the table from the identity.
//
// What it computes: out[k, :] = acc[k, :] (op) fold_op{ vals[i, :] : keys[i] == k },
// with keys outside [0, K) (the sentinel K and negative keys included)
// dropped; max and min fold the pairs in index order, sums in an order
// fixed by the shapes.  Rows of keys absent from the
// chunk fold only the identity, so they pass through.  With acc == nullptr
// no table is read: out[k, :] is the fold alone, and the identity for an
// absent key.  out may be acc itself (a fold in place): every element of
// the table is read and then written by the one thread that owns it.
//
// Design.  The Pallas kernels ran their grid in order on one TPU core and kept
// the [Kb, D] table block resident in VMEM across the pair tiles, touching
// the whole block for every pair tile (a one-hot product or a masked
// expansion).  Blocks on Hopper run in parallel and in no order, a float sum
// must not depend on that order, and O(N * K) work is issue-bound here, so
// there are no float atomics and the work per pair does not depend on K.
// Two routes, chosen by the caller's plan.
//
// The tile route:
//   pass 1  grid (segment, key tile, column tile).  A block folds its
//           segment's pairs whose keys lie in its key tile into a [block_k,
//           cols] table in shared memory and writes partial[segment, key,
//           cols], or, when there is one segment, out itself (folded onto
//           acc).  Three block shapes, chosen by the caller's plan:
//             ballot  one warp matching keys by ballots, for a small table
//                     (fold_range in fold_table.cuh), in index order;
//             bucket  eight warps that bucket pairs by owner, for a large
//                     one (fold_range), in index order;
//             lane    sums into a small table only: one warp a column, one
//                     private copy of the column a lane, joined in a fixed
//                     order at the end (lane_fold.cuh).
//   pass 2  (several segments) a group of up to 32 threads per (key,
//           column) folds the segments' partials, each thread a contiguous
//           run of them in order; a fixed shuffle tree joins the runs left
//           to right, and the result is folded onto acc (when there is
//           one).
// A table that holds all of K x D reads each pair once; past that every
// key tile reads the whole chunk again, and keeps about one pair in
// key_tiles of what it reads.
//
// The partitioned route, for a table of many key tiles (the plan takes it
// where the tile route would read each pair more than ops.FOLD_PART_SCANS
// times): the chunk in sub-chunks of seg_len pairs, each
//   pass A  the stable radix partition of radix_level.cuh (one pass while
//           the regions fit its 256 digits): the sub-chunk's keys and value
//           columns into one padded region a key tile (its key // block_k),
//           keys outside [0, K) dropped (the sentinel K too: it takes no
//           slot of the last region), in a layout carved from the caller's
//           scratch;
//   pass B  grid (segment, 1, column tile): a bucket block folds a
//           segment of a region with fold_range (the counts column folded
//           from the keys under CNT) and writes out, folded onto acc for
//           the first sub-chunk and onto out itself for the rest.  A
//           region is one segment unless it is longer than region_seg
//           slots (a hot key: the plan makes region_seg at least twice a
//           region's mean); then its segments write partial tables, and
//           the last of them to finish (an integer ticket) joins them in
//           segment order, so a hot key's pairs are folded by several
//           blocks, as the tile route's segments fold them.
// Pass A reads each pair once and pass B once a column tile.  The
// partition is stable, so each key's pairs still fold in index order: a
// chunk folded as one sub-chunk, no region cut, gives the tile route's
// bits at one segment, and max and min give them always.  The layout is
// 4 * (1 + value columns) bytes a slot; the plan sizes the sub-chunks from
// the shapes so that the scratch stays within what the fold no longer
// allocates: the tile route's segment partials and, when it runs in
// place, the fresh table (out of place with no partials the plan keeps
// the tile route), and gives the partial tables what is left.
// The order of every float operation is fixed by the input and the shapes,
// so two runs give the same bits, and max/min give the plain version's
// bits, NaN payloads included (their fold is in index order; the lane
// shape, which sums in lane order, refuses them).
//
// The sizes come from the caller's plan (ops.fold_plan in Python): block_k
// keys and cols columns a table (at most kTableFloats floats; the lane
// shape holds 32 copies of it), W = 1 or 8 warps a block (the lane shape:
// cols), `stage` pairs a ring stage, segments of seg_len pairs (the lane
// shape: every n_seg-th run of seg_len = stage pairs; the partitioned
// route: n_seg sub-chunks of seg_len pairs, with the partition's passes).
//
// Bound on this card: bytes.  The function must read N*(4 + 4D) bytes of
// pairs and K*D*4 of acc (none without acc) and write K*D*4; at 3.35 TB/s
// that is the floor.  What holds the index-order fold back is issue: at
// K = 100 a window of 32 pairs costs one ballot a key bit to find the
// lanes that share a key, and the first of them folds the others' values
// in lane order, about a hundred instructions a window at sixteen one-warp
// blocks an SM; a key holding half the pairs triples that.  The lane shape
// has no such chain; what holds it back is still issue, the copies and
// the adds of 12 warps an SM at K = 100, which 16-byte copies and a fold
// specialised to its width cut.  On an NVIDIA H100 80GB HBM3 at 700.00
// W (chip_smoke.py and tools/ab_keyed_fold.py, CUDA graph, K = 100): B2's
// max over 2^22 pairs, D = 3, takes 0.092 ms on the index-order pass
// (bound 0.020); on lane tables B1's sum over 2^22 pairs, D = 4, onto acc
// takes 0.036 ms (index order: 0.082; bound 0.025) and B7's over 2^24
// pairs, D = 3, 0.095 ms (index order: 0.214; bound 0.080), the same with
// half the pairs on one key.  The lane shape beats the index-order pass
// at every sweep shape where a block of whole rows fits (K up to 1024 at
// D = 1, 512 at D = 3, 256 at D = 4); column tiles of three warps an SM
// lose (K = 512 at D = 4), so the plan takes them only from eight.
// The partitioned route on the same card (tools/fold_route_sweep.py, B1
// onto a [K, 1 + counts] accumulator, 2^22 uniform pairs, CUDA graph):
// K = 2.5M, the benchmark cell's uv.sourceip, 0.359 ms against the tile
// route's 10.888 (154 reads a pair against 2; byte bound 0.022 ms for the
// pairs and the table read and written); K = 2^20 0.293 against 4.115;
// where the tile route reads each pair 4 times or fewer it wins (K = 2^16:
// 0.306 against 0.322).  Half the pairs on one key, K = 2^16, D = 3 (B7):
// 3.36 ms against 7.30; every pair on key 0 at K = 2.5M (the compile's
// warm-up): 22.7 ms against 304.6.  chip_smoke.py's cell fold, in place
// with a tenth of the keys outside [0, K): 0.359 ms against 10.849, and
// half the pairs on one key 22.4 ms against 141.2.

#pragma once

#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "fold_table.cuh"
#include "lane_fold.cuh"
#include "radix_level.cuh"

namespace keyed_fold {

using fold_table::combine;
using fold_table::identity;
using fold_table::kAdd;
using fold_table::kMax;
using fold_table::kMin;

// Block shapes of pass 1 (ops.FOLD_SHAPES in Python).
enum Shape { kBallot = 0, kBucket = 1, kLane = 2 };

constexpr int kMergeThreads = 256;
constexpr int kMergeRun = 8;  // segments one merge thread folds, at most
// the partitioned route's regions start at multiples of kRegionPad slots
// (ops.FOLD_REGION_PAD)
constexpr int kRegionPad = 32;

// A block's finished [kb, nc] table into dst at its key tile and column
// tile, folded onto src where there is one.  src may be dst: each element
// is read and then written by one thread.
template <int OP, int W>
__device__ __forceinline__ void store_table(const float* table,
                                            const float* src, float* dst,
                                            const fold_table::Geom& g,
                                            int key0, int col0, int nc) {
  const int kb = min(g.block_k, g.k - key0);  // keys of this tile below K
  for (int i = threadIdx.x; i < kb * nc; i += W * 32) {
    const int local = i / nc;
    const long long e = (long long)(key0 + local) * g.d + col0 +
                        (i - local * nc);
    const float r = table[i];
    dst[e] = src != nullptr ? combine<OP>(src[e], r) : r;
  }
}

template <int OP, int W, bool CNT>
__global__ void __launch_bounds__(W * 32, 16 / W)
    fold_segments(const int* __restrict__ keys, const float* __restrict__ vals,
                  const float* acc, float* out, float* __restrict__ partial,
                  long long n, fold_table::Geom g, int seg_len, int n_seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int key0 = blockIdx.y * g.block_k;
  const int col0 = blockIdx.z * g.cols;
  const int nc = min(g.cols, g.d - col0);
  const long long lo = (long long)blockIdx.x * seg_len;
  const long long hi = min(n, lo + seg_len);
  fold_table::fold_range<OP, W, CNT>(keys, vals, g, key0, col0, nc, lo, hi,
                                    smem);
  const float* table = reinterpret_cast<const float*>(smem);
  if (n_seg == 1)
    store_table<OP, W>(table, acc, out, g, key0, col0, nc);
  else
    store_table<OP, W>(table, nullptr,
                       partial + (long long)blockIdx.x * g.k * g.d, g, key0,
                       col0, nc);
}

// Pass B's segments.  A region (the layout of one key tile) of len slots
// is cut into c = ceil(len / seg) segments of seg slots (c = 1 for an
// empty region, and with seg == 0).  Block t < R folds the first segment of
// region t; block R + i the i-th of the regions' further segments, region
// by region.  A region of several segments folds them into partial tables
// (slot: the first of its own, after those of the split regions before
// it), and its last segment block to finish joins them in order.
struct Segment {
  int r, j, c, slot;  // region, segment of it, its segments, partial slot
};

// Segment t, or false where the block has none.  Every thread of the block
// calls it; the block-wide scans run only where region t is split or t >=
// R, which every thread of the block sees alike.
__device__ bool segment_of(int t, const int* __restrict__ starts, int R,
                           int seg, Segment* out) {
  __shared__ int s_warp[32];
  __shared__ int s_carry[2];
  __shared__ Segment s_seg;
  auto pieces = [&](int r) {
    const int len = starts[r + 1] - starts[r];
    return seg > 0 && len > seg ? (len + seg - 1) / seg : 1;
  };
  if (t < R && pieces(t) == 1) {
    *out = Segment{t, 0, 1, 0};
    return true;
  }
  if (threadIdx.x == 0) {
    s_carry[0] = s_carry[1] = 0;
    s_seg.r = -1;
  }
  __syncthreads();
  // exclusive prefixes over regions of the further segments and of the
  // split regions' segments
  for (int base = 0; base < R; base += blockDim.x) {
    const int r = base + threadIdx.x;
    const int c = r < R ? pieces(r) : 1;
    const int more = c - 1, split = c > 1 ? c : 0;
    const int more_incl = scan::block_scan<false>(more, s_warp);
    const int split_incl = scan::block_scan<false>(split, s_warp);
    const int more0 = s_carry[0] + more_incl - more;
    const int slot = s_carry[1] + split_incl - split;
    if (r < R && ((t < R && r == t) ||
                  (t >= R && more0 <= t - R && t - R < more0 + more)))
      s_seg = Segment{r, t < R ? 0 : 1 + (t - R - more0), c, slot};
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) {
      s_carry[0] += more_incl;
      s_carry[1] += split_incl;
    }
    __syncthreads();
  }
  *out = s_seg;
  return out->r >= 0;
}

// Pass B of the partitioned route: grid (R + extra, 1, column tile).  The
// block of segment t folds its slots of the layout (pads and dropped keys
// hold K, which fold_range skips).  A region of one segment goes onto src
// and into out; a split region's segments write partial tables, and the
// last of them to finish (a ticket a region and column tile, reset after)
// folds them in segment order and puts the result onto src, into out.
template <int OP, int W, bool CNT>
__global__ void __launch_bounds__(W * 32, 16 / W)
    fold_regions(const int* __restrict__ keys, const float* __restrict__ vals,
                 const int* __restrict__ starts, const float* src, float* out,
                 float* partial, int* tickets, fold_table::Geom g, int R,
                 int seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool s_last;
  Segment sg;
  if (!segment_of(blockIdx.x, starts, R, seg, &sg)) return;
  const int key0 = sg.r * g.block_k;
  const int col0 = blockIdx.z * g.cols;
  const int nc = min(g.cols, g.d - col0);
  const long long lo = starts[sg.r] + (long long)sg.j * seg;
  const long long end = starts[sg.r + 1];
  const long long hi = sg.c == 1 ? end : min(end, lo + seg);
  fold_table::fold_range<OP, W, CNT>(keys, vals, g, key0, col0, nc, lo, hi,
                                    smem);
  const float* table = reinterpret_cast<const float*>(smem);
  if (sg.c == 1) {
    store_table<OP, W>(table, src, out, g, key0, col0, nc);
    return;
  }
  const long long rows = (long long)g.block_k * g.d;  // a partial table
  const int kb = min(g.block_k, g.k - key0);
  float* mine = partial + (sg.slot + sg.j) * rows;
  for (int i = threadIdx.x; i < kb * nc; i += W * 32) {
    const int local = i / nc;
    mine[(long long)local * g.d + col0 + i - local * nc] = table[i];
  }
  __threadfence();
  __syncthreads();
  int* ticket = tickets + sg.r * gridDim.z + blockIdx.z;
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == sg.c - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* first = partial + sg.slot * rows;
  for (int i = threadIdx.x; i < kb * nc; i += W * 32) {
    const int local = i / nc;
    const long long at = (long long)local * g.d + col0 + i - local * nc;
    float r = identity<OP>();
    for (int q = 0; q < sg.c; ++q)
      r = combine<OP>(r, __ldcg(first + q * rows + at));
    const long long e = (long long)key0 * g.d + at;
    out[e] = src != nullptr ? combine<OP>(src[e], r) : r;
  }
  if (threadIdx.x == 0) *ticket = 0;  // for the next sub-chunk
}

// Every element of the [K, D] table: a group of 2^group_log2 threads (at
// most a block) folds the segments in order, each thread a contiguous run;
// a shuffle tree joins the runs of a warp left to right, the group's first
// thread joins its warps in order, then the result goes onto acc.
template <int OP>
__global__ void __launch_bounds__(kMergeThreads)
    merge_segments(const float* acc, const float* __restrict__ partial,
                   float* out, long long kd, int n_seg, int group_log2) {
  __shared__ float s_warp[kMergeThreads / 32];
  const long long gid = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  const int group = 1 << group_log2;
  const long long e = gid >> group_log2;
  const int g = (int)(gid & (group - 1));
  float r = identity<OP>();
  if (e < kd) {
    const int run = (n_seg + group - 1) / group;
    const int s0 = g * run, s1 = min(n_seg, s0 + run);
#pragma unroll 4
    for (int s = s0; s < s1; ++s) r = combine<OP>(r, partial[s * kd + e]);
  }
  for (int off = 1; off < min(group, 32); off <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, r, off);
    if ((g & (2 * off - 1)) == 0) r = combine<OP>(r, o);
  }
  if (group > 32) {  // the same in every thread of the block
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) s_warp[warp] = r;
    __syncthreads();
    if (g == 0)
      for (int w = 1; w < group / 32; ++w) r = combine<OP>(r, s_warp[warp + w]);
  }
  if (g == 0 && e < kd) out[e] = acc != nullptr ? combine<OP>(acc[e], r) : r;
}

// Past 48 KB of dynamic shared memory a kernel must be allowed it first.
// Asked on every such launch: a function-local static here would be one
// object shared by every library built from this header (the linker
// unifies such objects across shared libraries), and would let one
// library's kernel go without the attribute.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Pass 1 of the lane shape: fold_runs of the block's width.
template <int OP, bool CNT, int C = 1>
inline cudaError_t launch_lanes(const int* keys, const float* vals,
                                const float* acc, float* out, float* partial,
                                int n, int d, int k, int block_k, int cols,
                                int n_seg, dim3 grid, size_t smem,
                                cudaStream_t stream) {
  if constexpr (C < lane_fold::kMaxWarps) {
    if (cols != C)
      return launch_lanes<OP, CNT, C + 1>(keys, vals, acc, out, partial, n,
                                          d, k, block_k, cols, n_seg, grid,
                                          smem, stream);
  }
  const cudaError_t err = allow_smem(lane_fold::fold_runs<OP, C, CNT>, smem);
  if (err != cudaSuccess) return err;
  lane_fold::fold_runs<OP, C, CNT><<<grid, C * 32, smem, stream>>>(
      keys, vals, acc, out, partial, n, d, k, block_k, n_seg);
  return cudaSuccess;
}

// The checks of a ballot or bucket block's plan, on either route.
inline bool index_order_ok(int shape, int warps, int stage) {
  const bool bucket = shape == kBucket;
  return (shape == kBallot || bucket) &&
         warps == (bucket ? fold_table::kBucketWarps : 1) && stage >= 32 &&
         stage % 32 == 0 &&
         stage <= (bucket ? fold_table::kMaxStage : fold_table::kBallotStage);
}

// The partitioned route: n_sub sub-chunks of sub_len pairs, each
// partitioned by `passes` (radix_level.cuh's kPassFields ints a pass, as
// the plan gives them for a whole sub-chunk; a shorter last sub-chunk gets
// its own grids) into a layout, then folded by fold_regions: bucket blocks
// (eight warps share a segment's pairs), a region cut into segments of seg
// slots, with room for 2 * extra partial tables ([block_k, d] each) and
// extra further segments (seg == 0: no region is cut).  The first
// sub-chunk folds onto acc (nullptr: the identity), the rest onto out.
// The scratch holds, each from a 256-byte boundary, a ticket a region and
// column tile, the partial tables, the layout's keys and values, and the
// partition's scratch.
template <int OP, bool CNT>
inline cudaError_t launch_regions(const int* keys, const float* vals,
                                  const float* acc, float* out,
                                  void* scratch, long long scratch_bytes,
                                  int n, int d, int k, int shape,
                                  int block_k, int cols, int stage,
                                  int warps, int sub_len, int n_sub,
                                  const int* passes, int n_passes, int seg,
                                  int extra, cudaStream_t stream) {
  constexpr int F = radix::kPassFields;
  constexpr int W = fold_table::kBucketWarps;
  const int vd = CNT ? d - 1 : d;  // value columns of a vals row
  if (shape != kBucket || !index_order_ok(shape, warps, stage) ||
      scratch == nullptr || passes == nullptr ||
      n_passes > radix::kMaxPasses || sub_len <= 0 ||
      n_sub != (int)(((long long)n + sub_len - 1) / sub_len) || vd < 0 ||
      seg < 0 || extra < 0 || (extra > 0) != (seg > 0) ||
      passes[(n_passes - 1) * F] != block_k)  // the last pass: key tiles
    return cudaErrorInvalidValue;
  const size_t smem = fold_table::smem_bytes(block_k, cols, stage, warps);
  const int regions = (k + block_k - 1) / block_k;
  const int col_tiles = (d + cols - 1) / cols;
  if (smem > (size_t)fold_table::kSmemBytes || col_tiles > 65535 ||
      (long long)regions + extra > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const fold_table::Geom g{d, k, block_k, cols, stage,
                           fold_table::key_bits(block_k)};
  cudaError_t err = allow_smem(fold_regions<OP, W, CNT>, smem);
  if (err != cudaSuccess) return err;
  const size_t ticket_bytes = radix::align_up((size_t)regions * col_tiles * 4);
  const size_t partial_bytes = (size_t)2 * extra * block_k * d * 4;
  int f[radix::kMaxPasses * F];
  radix::Pass ps[radix::kMaxPasses];
  for (int s = 0; s < n_sub; ++s) {
    const long long lo = (long long)s * sub_len;
    const int m = (int)(n - lo < sub_len ? n - lo : sub_len);
    for (int i = 0; i < n_passes * F; ++i) f[i] = passes[i];
    for (int i = 0; i < n_passes; ++i)  // grid: tiles (+ parents inside)
      f[i * F + 5] = (m + f[i * F + 4] - 1) / f[i * F + 4] +
                     (i ? f[i * F + 3] : 0);
    const int L =
        radix::read_passes(m, vd, k, kRegionPad, f, n_passes, ps, k);
    if (L == 0) return cudaErrorInvalidValue;
    const size_t slots = (size_t)ps[L - 1].slots;
    char* base = static_cast<char*>(scratch);
    int* tickets = reinterpret_cast<int*>(base);
    float* partial = reinterpret_cast<float*>(base + ticket_bytes);
    int* pkeys = reinterpret_cast<int*>(base + ticket_bytes +
                                        radix::align_up(partial_bytes));
    float* pvals = reinterpret_cast<float*>(
        reinterpret_cast<char*>(pkeys) + radix::align_up(slots * 4));
    char* rest = reinterpret_cast<char*>(pvals) +
                 radix::align_up(slots * vd * 4);
    radix::Scratch sc;
    if ((long long)(rest - base + radix::carve(ps, L, vd, nullptr, &sc)) >
        scratch_bytes)
      return cudaErrorInvalidValue;
    if (s == 0 && extra > 0) {
      err = cudaMemsetAsync(tickets, 0, ticket_bytes, stream);
      if (err != cudaSuccess) return err;
    }
    err = radix::partition(ps, L, keys + lo, vals + lo * vd, vd, pkeys, pvals,
                           nullptr, rest, stream);
    if (err != cudaSuccess) return err;
    radix::carve(ps, L, vd, rest, &sc);
    const int* starts = sc.starts[(L - 1) & 1];  // [regions + 1]
    const float* src = s == 0 ? acc : out;
    fold_regions<OP, W, CNT><<<dim3(regions + extra, 1, col_tiles), W * 32,
                               smem, stream>>>(pkeys, pvals, starts, src, out,
                                               partial, tickets, g, regions,
                                               seg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// One fold.  The tile route (n_passes == 0): pass 1, and pass 2 when there
// are several segments.  The partitioned route (n_passes > 0): partial is
// the scratch of scratch_bytes, seg_len and n_seg the sub-chunks,
// region_seg and extra pass B's segments (launch_regions).  Returns
// cudaErrorInvalidValue for a plan the kernels cannot run, a lane-table
// plan for max or min among them.  With CNT (sums only) vals is [n, d - 1]
// and the table's last column counts the pairs that land (a sum of ones,
// exact below 2^24); acc, out and partial keep d columns.  out may be acc
// (in place).
template <int OP, bool CNT = false>
inline cudaError_t launch(const int* keys, const float* vals, const float* acc,
                          float* out, float* partial, int n, int d, int k,
                          int shape, int block_k, int cols, int stage,
                          int warps, int seg_len, int n_seg,
                          const int* passes, int n_passes,
                          long long scratch_bytes, int region_seg,
                          int extra, cudaStream_t stream) {
  static_assert(!CNT || OP == kAdd, "the counts column is a sum");
  const bool lane = shape == kLane, bucket = shape == kBucket;
  if (n <= 0 || d <= 0 || k <= 0 || block_k <= 0 || block_k > k ||
      cols <= 0 || cols > d || cols > fold_table::kMaxCols ||
      (long long)block_k * cols > fold_table::kTableFloats ||
      seg_len <= 0 || n_seg <= 0 || n_passes < 0 ||
      (n_seg > 1 && !partial))
    return cudaErrorInvalidValue;
  if (n_passes > 0)
    return launch_regions<OP, CNT>(keys, vals, acc, out, partial,
                                   scratch_bytes, n, d, k, shape, block_k,
                                   cols, stage, warps, seg_len, n_seg, passes,
                                   n_passes, region_seg, extra, stream);
  if (lane) {  // n_seg blocks, each every n_seg-th run of kStage pairs
    if (OP != kAdd || warps != cols || cols > lane_fold::kMaxWarps ||
        stage != lane_fold::kStage || seg_len != lane_fold::kStage ||
        (long long)seg_len * (n_seg - 1) >= n)
      return cudaErrorInvalidValue;
  } else if (!index_order_ok(shape, warps, stage) ||
             (long long)seg_len * n_seg < n ||
             (long long)seg_len * (n_seg - 1) >= n) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = lane ? lane_fold::smem_bytes(block_k, cols)
                           : fold_table::smem_bytes(block_k, cols, stage,
                                                    warps);
  const int key_tiles = (k + block_k - 1) / block_k;
  const int col_tiles = (d + cols - 1) / cols;
  if (smem > (size_t)fold_table::kSmemBytes || key_tiles > 65535 ||
      col_tiles > 65535)
    return cudaErrorInvalidValue;
  const fold_table::Geom g{d, k, block_k, cols, stage,
                           fold_table::key_bits(block_k)};
  const dim3 grid(n_seg, key_tiles, col_tiles);
  cudaError_t err = cudaSuccess;
  if (lane) {
    if constexpr (OP == kAdd) err = launch_lanes<OP, CNT>(
        keys, vals, acc, out, partial, n, d, k, block_k, cols, n_seg, grid,
        smem, stream);
  } else if (bucket) {
    constexpr int W = fold_table::kBucketWarps;
    err = allow_smem(fold_segments<OP, W, CNT>, smem);
    if (err != cudaSuccess) return err;
    fold_segments<OP, W, CNT><<<grid, W * 32, smem, stream>>>(
        keys, vals, acc, out, partial, n, g, seg_len, n_seg);
  } else {
    err = allow_smem(fold_segments<OP, 1, CNT>, smem);
    if (err != cudaSuccess) return err;
    fold_segments<OP, 1, CNT><<<grid, 32, smem, stream>>>(
        keys, vals, acc, out, partial, n, g, seg_len, n_seg);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || n_seg == 1) return err;
  // threads per element: runs of at most kMergeRun segments, a power of
  // two up to a block
  int group_log2 = 0;
  while ((1 << group_log2) < kMergeThreads &&
         (long long)kMergeRun << group_log2 < n_seg)
    ++group_log2;
  const long long kd = (long long)k * d;
  const long long threads = kd << group_log2;
  merge_segments<OP><<<(unsigned)((threads + kMergeThreads - 1) /
                                  kMergeThreads),
                       kMergeThreads, 0, stream>>>(acc, partial, out, kd,
                                                   n_seg, group_log2);
  return cudaGetLastError();
}

}  // namespace keyed_fold
