// segment_reduce for sm_90a: a pair stream grouped into aligned key blocks
// reduced to a [K, D] f32 table with add, max or min; optionally folded onto
// a carried table acc in the same pass (the sort flow's merge).
//
// Replaces the Pallas kernel src/repro/kernels/segment_reduce.py::
// segment_reduce (_kernel, with the block of each tile scalar-prefetched).
// Its input here is what the sort flow hands it: the radix partition's
// layout, in which every tile of `tile` pairs has its keys in one aligned
// block of block_k keys, and the tiles' blocks do not decrease (a key-sorted
// stream has the same property).  The TPU kernel kept one [block_k, D] block
// in VMEM and visited the tiles in order; blocks on Hopper run in parallel.
//
// Bound on this card: bytes.  N*(4 + 4D) read, K*D*4 written (and K*D*4 of
// acc read): 54 MB, 16 us at 3.35 TB/s for the sort path's 2^22 slots, D = 2,
// K = 2^18.  What holds it back is latency, not bytes: a pair must reach
// the one warp that owns its key, in order, with no atomics, and every
// stage of that costs barriers and shuffles.  The first design (one
// 1024-thread block per SM, synchronous stage loads, six barriers and a
// block scan a stage, a one-block serial planner) ran at 17x the bound.
// This one:
//   1 tile_blocks  one warp per tile: its key block, from its first key (a
//                  tile whose first key lies outside [0, K), as the layout's
//                  trailing pad, is read by the whole warp at once).
//   2 plan         one block; each warp sweeps a contiguous range of tiles
//                  32 at a time (coalesced, loads batched) with warp scans;
//                  a block-level pass gives each range the block before it.
//                  The segments: runs of tiles of one key block cut into
//                  windows of `window` tiles, and each key block's first and
//                  last segment.  The window makes the segments one wave of
//                  the blocks that fit on the card (occupancy x SMs).
//   3 reduce       one block per segment (and column tile) folds it into a
//                  [block_k, cols] table in shared memory (fold_range, in
//                  fold_table.cuh, which keyed_fold.cuh shares).  The segment
//                  streams through a ring of three stages filled with 4-byte
//                  cp.async, two stages ahead.  A block of kBucketWarps warps
//                  buckets each stage of up to 1024 pairs by owner (warp w
//                  owns the keys with local id % 8 == w): counts per (owner,
//                  32-pair window) from ballots on the owner's bits, each
//                  warp scans its owner's row, and the pairs' indices are
//                  scattered stably; three barriers a stage.  Each warp then
//                  walks its own list 32 entries at a time: every lane claims
//                  its key's byte, and where no claim was lost each lane
//                  folds its own pair, else lanes with the same key find
//                  each other with one ballot per key bit and the lowest
//                  folds their values in lane order.  A small table (many
//                  blocks fit on an SM) takes blocks of one warp that read
//                  every pair themselves.  So each key's pairs fold in
//                  layout order inside a segment, with no atomics.  A key
//                  block that lies in one segment is written straight to
//                  out, folded with acc: no partial table.
//   4 merge        the key blocks of several segments: a group of up to 32
//                  threads per (key, column) folds the segments' partial
//                  tables, each thread a contiguous run of them in order, and
//                  a fixed shuffle tree joins the runs left to right, then
//                  onto acc.
// The order of every float operation is fixed by the input alone: two runs
// give the same bits.  Max and min follow JAX's NaN and signed-zero rules
// (combine<> in fold_table.cuh); a key absent from the stream gets the
// identity (then acc's value, when acc is given).

#include "fold_table.cuh"

namespace segred {

using fold_table::combine;
using fold_table::identity;
using fold_table::kBallotStage;
using fold_table::kBucketWarps;
using fold_table::kMaxCols;
using fold_table::kMaxStage;
using fold_table::kRing;
using fold_table::kSmemBytes;
using fold_table::kTableFloats;

constexpr int kPlanThreads = 1024;
constexpr int kPlanBatch = 4;  // steps of 32 tiles a plan warp loads at once
constexpr int kTileThreads = 256;
constexpr int kMergeThreads = 256;
constexpr int kSmPerSm = 233472;  // shared memory of one SM
constexpr int kSmReserve = 1024;  // reserved by the runtime per block
constexpr int kBucketBlocks = 2;  // such blocks an SM should hold
constexpr int kBallotFit = 8;  // blocks per SM at which one warp a block
                               // reads every pair itself

struct Plan {
  long long n;
  int d, k, block_k, tile;
  int n_tiles, nblk, window, max_seg;
  int cols, col_tiles, stage, warps, merge_log2;
  int kbits;  // bits of a local key: block_k <= 2^kbits
  size_t smem;
};

inline int resident_blocks(int warps, size_t smem);

inline bool make_plan(long long n, int d, int k, int block_k, int tile,
                      Plan* p) {
  if (n <= 0 || d <= 0 || k <= 0 || block_k <= 0 || tile <= 0) return false;
  p->n = n;
  p->d = d;
  p->k = k;
  p->block_k = block_k;
  p->tile = tile;
  p->n_tiles = (int)((n + tile - 1) / tile);
  p->nblk = (k + block_k - 1) / block_k;
  p->kbits = fold_table::key_bits(block_k);
  p->cols = min(d, min(kMaxCols, kTableFloats / block_k));
  if (p->cols < 1) return false;
  p->col_tiles = (d + p->cols - 1) / p->cols;
  const long long table = (long long)block_k * p->cols * 4;
  const long long per_pair = (long long)kRing * (1 + p->cols) * 4;
  // a small table: blocks of one warp, which folds every pair itself (no
  // bucketing), many blocks per SM
  p->stage = kBallotStage;
  p->smem = fold_table::smem_bytes(block_k, p->cols, kBallotStage, 1);
  if (kSmPerSm / (int)(p->smem + kSmReserve) >= kBallotFit) {
    p->warps = 1;
  } else {
    // else blocks of kBucketWarps warps, which bucket each stage by owner;
    // the list and the [owner, window] counts take 4 bytes a pair and 4
    // bytes an (owner, window) beside the ring
    const long long per_bucketed = per_pair + 4 + 4;
    const long long fixed = 32 * 4 + (block_k + 15) / 16 * 16;  // + tags
    // as many pairs a stage as leave room for kBucketBlocks blocks an SM
    const long long room = min((long long)kSmemBytes,
                               (long long)kSmPerSm / kBucketBlocks -
                                   kSmReserve);
    p->stage = (int)min((long long)kMaxStage,
                        (room - table - fixed) / per_bucketed) & ~31;
    if (p->stage < 32)
      p->stage = (int)min((long long)kMaxStage,
                          (kSmemBytes - table - fixed) / per_bucketed) & ~31;
    if (p->stage < 32) return false;
    p->smem = fold_table::smem_bytes(block_k, p->cols, p->stage,
                                     kBucketWarps);
    p->warps = kBucketWarps;
  }
  const int best = p->warps;
  // one wave: as many segments (x column tiles) as blocks fit on the card;
  // each key block adds at most one cut
  const int resident = max(1, resident_blocks(best, p->smem) / p->col_tiles);
  const int target = max(resident - p->nblk, (resident + 1) / 2);
  p->window = (p->n_tiles + target - 1) / target;
  p->max_seg = (p->n_tiles + p->window - 1) / p->window +
               min(p->nblk, p->n_tiles);
  // threads per (key, column) in the merge: a quarter of the segments a key
  // block has on average, a power of two up to a warp
  const int per_blk = max(1, p->max_seg / min(p->nblk, p->n_tiles));
  p->merge_log2 = 0;
  while (p->merge_log2 < 5 && (2 << p->merge_log2) * 4 <= per_blk)
    ++p->merge_log2;
  return true;
}

struct Scratch {
  int* tile_blk;
  int* seg_tile;
  int* seg_blk;
  int* n_seg;
  int* blk_first;
  int* blk_last;
  float* partial;
};

inline size_t align_up(size_t x) { return (x + 255) / 256 * 256; }

inline size_t carve(const Plan& p, char* base, Scratch* s) {
  const size_t sizes[] = {(size_t)p.n_tiles * 4, (size_t)(p.max_seg + 1) * 4,
                          (size_t)p.max_seg * 4, 4, (size_t)p.nblk * 4,
                          (size_t)p.nblk * 4,
                          (size_t)p.max_seg * p.block_k * p.d * 4};
  void** slots[] = {(void**)&s->tile_blk, (void**)&s->seg_tile,
                    (void**)&s->seg_blk, (void**)&s->n_seg,
                    (void**)&s->blk_first, (void**)&s->blk_last,
                    (void**)&s->partial};
  size_t off = 0;
  for (int i = 0; i < 7; ++i) {
    if (base) *slots[i] = base + off;
    off += align_up(sizes[i]);
  }
  return off;
}

// The key block of tile t, whose first key lies outside [0, K): that of its
// first key in [0, K), -1 if none.  The whole warp reads the tile, 8 keys a
// lane at once (t is the same in every lane; such tiles are rare: the
// layout's pad, a stream's ends).
__device__ __forceinline__ int resolve_tile(const int* __restrict__ keys,
                                            const Plan& p, int t) {
  const int lane = threadIdx.x & 31;
  const long long lo = (long long)t * p.tile;
  const long long hi = min(p.n, lo + p.tile);
  for (long long i0 = lo; i0 < hi; i0 += 256) {
    int key[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long i = i0 + 32 * j + lane;
      key[j] = i < hi ? keys[i] : -1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned ok = __ballot_sync(0xffffffffu,
                                        key[j] >= 0 && key[j] < p.k);
      if (ok)
        return __shfl_sync(0xffffffffu, key[j], __ffs(ok) - 1) / p.block_k;
    }
  }
  return -1;
}

// The key block of every tile: that of its first key in [0, K), -1 if none.
// One warp per tile, so that the rare tiles whose first key lies outside
// [0, K) (the layout's trailing pad, a stream's ends) are read in parallel.
__global__ void __launch_bounds__(kTileThreads)
    tile_blocks(const int* __restrict__ keys, Plan p,
                int* __restrict__ tile_blk) {
  const int t = blockIdx.x * (kTileThreads / 32) + (threadIdx.x >> 5);
  if (t >= p.n_tiles) return;  // whole warps
  const int first = keys[(long long)t * p.tile];
  const int b = first >= 0 && first < p.k ? first / p.block_k
                                          : resolve_tile(keys, p, t);
  if ((threadIdx.x & 31) == 0) tile_blk[t] = b;
}

// One sweep of a warp over tiles [lo, hi), 32 a step, kPlanBatch steps of
// loads at once.  The running block eff(t) = max(carry, blocks up to t) (a
// tile without a key in [0, K) joins the segment before it); a tile heads
// a segment where eff >= 0 and a window of tiles begins or eff changes.
// f(t, eff, head_mask, step) is called for every step.
template <typename F>
__device__ __forceinline__ int sweep(const int* __restrict__ tile_blk, int lo,
                                     int hi, int carry, F f) {
  const int lane = threadIdx.x & 31;
  for (int b0 = lo; b0 < hi; b0 += 32 * kPlanBatch) {
    int v[kPlanBatch];
#pragma unroll
    for (int j = 0; j < kPlanBatch; ++j) {
      const int t = b0 + 32 * j + lane;
      v[j] = t < hi ? tile_blk[t] : -1;
    }
#pragma unroll
    for (int j = 0; j < kPlanBatch; ++j) {
      const int t = b0 + 32 * j + lane;
      int e = v[j];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        e = max(e, __shfl_up_sync(0xffffffffu, e, off));  // lanes < off keep
      e = max(e, carry);
      int prev = __shfl_up_sync(0xffffffffu, e, 1);
      if (lane == 0) prev = carry;
      f(t, t < hi, e, prev);
      carry = __shfl_sync(0xffffffffu, e, 31);
    }
  }
  return carry;
}

// One block of kPlanThreads: the segments, from the tiles' blocks.  Warp w
// takes a contiguous range of tiles; a first sweep finds its largest block
// and its heads as if nothing came before, a block scan gives each range
// the block before it and corrects the first heads, a second writes them.
__global__ void __launch_bounds__(kPlanThreads)
    plan_segments(Plan p, const int* __restrict__ tile_blk,
                  int* __restrict__ seg_tile, int* __restrict__ seg_blk,
                  int* __restrict__ n_seg, int* __restrict__ blk_first,
                  int* __restrict__ blk_last) {
  constexpr int kWarps = kPlanThreads / 32;
  __shared__ int s_max[kWarps], s_heads[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int b = tid; b < p.nblk; b += kPlanThreads)
    blk_first[b] = blk_last[b] = -1;
  const int per = (p.n_tiles + kWarps - 1) / kWarps;
  const int lo = min(p.n_tiles, warp * per), hi = min(p.n_tiles, lo + per);
  // sweep 1, from carry -1: heads, the window starts before the first tile
  // with a block (heads too if a block came before), and that tile (a head
  // here; there, unless its block is the one before and no window starts)
  int heads = 0, lead = 0, fv_t = -1, fv_b = -1;
  const int mx = sweep(tile_blk, lo, hi, -1, [&](int t, bool in, int e,
                                                   int prev) {
    const bool head = in && e >= 0 && (t % p.window == 0 || e != prev);
    heads += __popc(__ballot_sync(0xffffffffu, head));
    lead += __popc(__ballot_sync(0xffffffffu,
                                 in && e < 0 && t % p.window == 0));
    const unsigned firsts = __ballot_sync(0xffffffffu, in && e >= 0 && prev < 0);
    if (firsts && fv_t < 0) {
      fv_t = __shfl_sync(0xffffffffu, t, __ffs(firsts) - 1);
      fv_b = __shfl_sync(0xffffffffu, e, __ffs(firsts) - 1);
    }
  });
  if (lane == 0) s_max[warp] = mx;
  __syncthreads();
  int carry = -1;  // the running block before this range
  for (int w = 0; w < warp; ++w) carry = max(carry, s_max[w]);
  if (carry >= 0) heads += lead;
  if (fv_t >= 0 && fv_t % p.window != 0 && fv_b == carry) --heads;
  if (lane == 0) s_heads[warp] = heads;
  __syncthreads();
  int pos = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int h = s_heads[w];
    pos += w < warp ? h : 0;
    total += h;
  }
  // sweep 2, from the true carry: write the heads
  sweep(tile_blk, lo, hi, carry, [&](int t, bool in, int e, int prev) {
    const bool head = in && e >= 0 && (t % p.window == 0 || e != prev);
    const unsigned hm = __ballot_sync(0xffffffffu, head);
    if (head) {
      const int at = pos + __popc(hm & ((1u << lane) - 1u));
      seg_tile[at] = t;
      seg_blk[at] = e;
    }
    pos += __popc(hm);
  });
  if (tid == 0) {
    *n_seg = total;
    seg_tile[total] = p.n_tiles;
  }
  __syncthreads();
  for (int s = tid; s < total; s += kPlanThreads) {
    const int b = seg_blk[s];
    if (s == 0 || seg_blk[s - 1] != b) blk_first[b] = s;
    if (s == total - 1 || seg_blk[s + 1] != b) blk_last[b] = s;
  }
}

template <int OP, int W>
__global__ void __launch_bounds__(W * 32, 16 / W)
    reduce_segments(const int* __restrict__ keys,
                    const float* __restrict__ vals,
                    const float* __restrict__ acc, float* __restrict__ out,
                    Plan p, const int* __restrict__ seg_tile,
                    const int* __restrict__ seg_blk,
                    const int* __restrict__ n_seg,
                    const int* __restrict__ blk_first,
                    const int* __restrict__ blk_last,
                    float* __restrict__ partial) {
  constexpr int kThreads = W * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x;
  if (s >= *n_seg) return;
  const int col0 = blockIdx.y * p.cols;
  const int nc = min(p.cols, p.d - col0);
  const int blk = seg_blk[s];
  const int key0 = blk * p.block_k;
  const long long lo = (long long)seg_tile[s] * p.tile;
  const long long hi = min(p.n, (long long)seg_tile[s + 1] * p.tile);
  const fold_table::Geom g{p.d, p.k, p.block_k, p.cols, p.stage, p.kbits};
  fold_table::fold_range<OP, W>(keys, vals, g, key0, col0, nc, lo, hi, smem);
  const float* table = reinterpret_cast<const float*>(smem);
  const int tid = threadIdx.x;
  const int kb = min(p.block_k, p.k - key0);  // keys of this block below K
  if (blk_first[blk] == blk_last[blk]) {  // the block's only segment
    for (int i = tid; i < kb * nc; i += kThreads) {
      const int local = i / nc;
      const size_t e = (size_t)(key0 + local) * p.d + col0 + (i - local * nc);
      out[e] = acc != nullptr ? combine<OP>(acc[e], table[i]) : table[i];
    }
    return;
  }
  float* dst = partial + (size_t)s * p.block_k * p.d + col0;
  for (int i = tid; i < kb * nc; i += kThreads) {
    const int local = i / nc;
    dst[(size_t)local * p.d + (i - local * nc)] = table[i];
  }
}

// Every (key, column) of a key block of several segments, or of none.  A
// group of 2^merge_log2 threads folds the segments in order, each thread a
// contiguous run; a shuffle tree joins the runs left to right.
template <int OP>
__global__ void __launch_bounds__(kMergeThreads)
    merge_segments(Plan p, const float* __restrict__ partial,
                   const int* __restrict__ blk_first,
                   const int* __restrict__ blk_last,
                   const float* __restrict__ acc, float* __restrict__ out) {
  const long long gid = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  const int group = 1 << p.merge_log2;
  const long long e = gid >> p.merge_log2;
  const int g = (int)(gid & (group - 1));
  const bool in = e < (long long)p.k * p.d;
  int first = -1, last = -1, key = 0, c = 0;
  if (in) {
    key = (int)(e / p.d);
    c = (int)(e - (long long)key * p.d);
    first = blk_first[key / p.block_k];
    last = blk_last[key / p.block_k];
  }
  const bool skip = !in || (first >= 0 && first == last);  // reduce wrote it
  float r = identity<OP>();
  if (!skip && first >= 0) {
    const int ns = last - first + 1;
    const int run = (ns + group - 1) / group;
    const int s0 = first + g * run, s1 = min(last + 1, s0 + run);
    const int local = key % p.block_k;
    for (int s = s0; s < s1; ++s)
      r = combine<OP>(r, partial[((size_t)s * p.block_k + local) * p.d + c]);
  }
  for (int off = 1; off < group; off <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, r, off);
    if ((g & (2 * off - 1)) == 0) r = combine<OP>(r, o);
  }
  if (g == 0 && !skip) out[e] = acc != nullptr ? combine<OP>(acc[e], r) : r;
}

template <int OP, int W>
cudaError_t prepare() {  // once per kernel: allow the large shared memory
  static cudaError_t done = cudaFuncSetAttribute(
      reduce_segments<OP, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  return done;
}

template <int W>
int occupancy(size_t smem) {
  if (prepare<fold_table::kAdd, W>() != cudaSuccess) return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, reduce_segments<fold_table::kAdd, W>, W * 32, smem) !=
      cudaSuccess)
    return 0;
  return blocks;
}

inline int resident_blocks(int warps, size_t smem) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  const int per_sm = warps == 1 ? occupancy<1>(smem)
                                 : occupancy<kBucketWarps>(smem);
  return max(1, per_sm) * sms;
}

#define SEGRED_CHECK()                     \
  do {                                     \
    cudaError_t e_ = cudaGetLastError();   \
    if (e_ != cudaSuccess) return e_;      \
  } while (0)

template <int OP, int W>
cudaError_t launch_reduce(const Plan& p, const int* keys, const float* vals,
                          const float* acc, float* out, const Scratch& s,
                          cudaStream_t stream) {
  const cudaError_t err = prepare<OP, W>();
  if (err != cudaSuccess) return err;
  reduce_segments<OP, W><<<dim3(p.max_seg, p.col_tiles), W * 32, p.smem,
                           stream>>>(keys, vals, acc, out, p, s.seg_tile,
                                     s.seg_blk, s.n_seg, s.blk_first,
                                     s.blk_last, s.partial);
  return cudaGetLastError();
}

template <int OP>
cudaError_t run(const Plan& p, const int* keys, const float* vals,
                const float* acc, float* out, void* scratch,
                cudaStream_t stream) {
  Scratch s;
  carve(p, (char*)scratch, &s);
  tile_blocks<<<(p.n_tiles + kTileThreads / 32 - 1) / (kTileThreads / 32),
                kTileThreads, 0, stream>>>(keys, p, s.tile_blk);
  SEGRED_CHECK();
  plan_segments<<<1, kPlanThreads, 0, stream>>>(p, s.tile_blk, s.seg_tile,
                                                s.seg_blk, s.n_seg,
                                                s.blk_first, s.blk_last);
  SEGRED_CHECK();
  const cudaError_t err =
      p.warps == 1
          ? launch_reduce<OP, 1>(p, keys, vals, acc, out, s, stream)
          : launch_reduce<OP, kBucketWarps>(p, keys, vals, acc, out, s,
                                            stream);
  if (err != cudaSuccess) return err;
  const long long threads = ((long long)p.k * p.d) << p.merge_log2;
  merge_segments<OP><<<(unsigned)((threads + kMergeThreads - 1) /
                                  kMergeThreads),
                       kMergeThreads, 0, stream>>>(p, s.partial, s.blk_first,
                                                   s.blk_last, acc, out);
  SEGRED_CHECK();
  return cudaSuccess;
}

}  // namespace segred

extern "C" long long segment_reduce_scratch_bytes(int n, int d, int k,
                                                  int block_k, int tile) {
  segred::Plan p;
  if (!segred::make_plan(n, d, k, block_k, tile, &p)) return -1;
  segred::Scratch unused;
  return (long long)segred::carve(p, nullptr, &unused);
}

extern "C" int segment_reduce_launch(const int* keys, const float* vals,
                                     const float* acc, float* out, int n,
                                     int d, int k, int op, int block_k,
                                     int tile, void* scratch, void* stream) {
  segred::Plan p;
  if (!segred::make_plan(n, d, k, block_k, tile, &p))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case fold_table::kAdd:
      return (int)segred::run<fold_table::kAdd>(p, keys, vals, acc, out,
                                                scratch, s);
    case fold_table::kMax:
      return (int)segred::run<fold_table::kMax>(p, keys, vals, acc, out,
                                                scratch, s);
    case fold_table::kMin:
      return (int)segred::run<fold_table::kMin>(p, keys, vals, acc, out,
                                                scratch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* segment_reduce_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
