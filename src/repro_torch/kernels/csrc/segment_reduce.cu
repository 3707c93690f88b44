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
// in VMEM and visited the tiles in order; blocks on Hopper run in parallel, so
//   1 tile_blocks     the block of each tile (its first key in [0, K));
//   2 plan_segments   one block: runs of tiles of one key block, cut into
//                     segments of at most `window` tiles, and each key block's
//                     first and last segment;
//   3 reduce          one thread block per segment (and column tile) folds the
//                     segment into a [block_k, cols] table in shared memory.
//                     Warp w owns the keys with local id % 32 == w.  The
//                     segment is staged up to 1024 pairs at a time, and each
//                     stage is bucketed stably by owner (a [owner, warp]
//                     count matrix, one block scan, a scatter of the pairs'
//                     indices).  Each warp then walks its own list 32 entries
//                     at a time: lanes holding the same key find each other
//                     with __match_any_sync and the lowest one folds their
//                     values in lane order.  So each key's pairs are folded
//                     in layout order, with no atomics at all;
//   4 merge           one thread per (key, column) folds its block's segment
//                     tables in segment order, then onto acc.
// The order of every float operation is fixed by the input alone: two runs
// give the same bits.  Max and min follow JAX's NaN and signed-zero rules
// (combine<> in keyed_fold.cuh); a key absent from the stream gets the
// identity (then acc's value, when acc is given).
//
// Bound on this card: bytes: N*(4 + 4D) read, K*D*4 written (and K*D*4 of acc
// read).  The segment tables add segments x block_k x D x 4 bytes of writes
// and reads.

#include "block_scan.cuh"
#include "keyed_fold.cuh"

namespace segred {

using keyed_fold::combine;
using keyed_fold::identity;

constexpr int kThreads = 1024;  // reduce block: 32 warps
constexpr int kWarps = kThreads / 32;  // == 32: the [owner, warp] matrix has
                                       // one entry per thread
constexpr int kTargetSegments = 264;  // two per SM of the 132
constexpr int kTableFloats = 32768;  // 128 KB of table per block
constexpr int kMaxCols = 64;
constexpr int kMaxStage = 1024;  // pairs staged in shared memory at once
constexpr int kSmemBytes = 232448;  // what one block may use on an H100

struct Plan {
  long long n;
  int d, k, block_k, tile;
  int n_tiles, nblk, window, max_seg;
  int cols, col_tiles, stage;
  size_t smem;
};

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
  p->window = (p->n_tiles + kTargetSegments - 1) / kTargetSegments;
  p->max_seg = (p->n_tiles + p->window - 1) / p->window + p->nblk;
  p->cols = min(d, min(kMaxCols, kTableFloats / block_k));
  if (p->cols < 1) return false;
  p->col_tiles = (d + p->cols - 1) / p->cols;
  const long long table = (long long)block_k * p->cols * 4;
  const long long fixed = (kWarps * kWarps + kWarps + 1) * 4;
  // per staged pair: its local key, its list entry and its values
  const long long stage = (kSmemBytes - table - fixed) / ((2 + p->cols) * 4);
  p->stage = (int)min((long long)kMaxStage, stage) & ~31;
  if (p->stage < 32) return false;
  p->smem = (size_t)table + fixed + (size_t)p->stage * (2 + p->cols) * 4;
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

__global__ void tile_blocks(const int* __restrict__ keys, Plan p,
                            int* __restrict__ tile_blk) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= p.n_tiles) return;
  const long long lo = (long long)t * p.tile;
  const long long hi = min(p.n, lo + p.tile);
  int b = -1;
  for (long long i = lo; i < hi; ++i) {
    const int key = keys[i];
    if (key >= 0 && key < p.k) {
      b = key / p.block_k;
      break;
    }
  }
  tile_blk[t] = b;
}

// One block of kThreads.  A tile without a key in [0, K) joins the segment
// before it (it adds nothing); a segment starts where the running block
// changes or a window of tiles begins.
__global__ void plan_segments(Plan p, const int* __restrict__ tile_blk,
                              int* __restrict__ seg_tile,
                              int* __restrict__ seg_blk,
                              int* __restrict__ n_seg,
                              int* __restrict__ blk_first,
                              int* __restrict__ blk_last) {
  __shared__ int s_warp[32];
  __shared__ int s_eff[kThreads];
  __shared__ int s_prev, s_count;
  for (int b = threadIdx.x; b < p.nblk; b += blockDim.x)
    blk_first[b] = blk_last[b] = -1;
  if (threadIdx.x == 0) {
    s_prev = -1;
    s_count = 0;
  }
  __syncthreads();
  for (int base = 0; base < p.n_tiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < p.n_tiles ? tile_blk[i] : -1;
    const int prev_chunk = s_prev, count = s_count;
    const int eff = max(prev_chunk, scan::block_scan<true>(v, s_warp));
    s_eff[threadIdx.x] = eff;
    __syncthreads();
    const int prev = threadIdx.x == 0 ? prev_chunk : s_eff[threadIdx.x - 1];
    const int head = i < p.n_tiles && eff >= 0 &&
                     (i % p.window == 0 || eff != prev);
    const int pos = scan::block_scan<false>(head, s_warp);
    if (head) {
      seg_tile[count + pos - 1] = i;
      seg_blk[count + pos - 1] = eff;
    }
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) {
      s_count = count + pos;
      s_prev = eff;
    }
    __syncthreads();
  }
  const int total = s_count;
  if (threadIdx.x == 0) {
    *n_seg = total;
    seg_tile[total] = p.n_tiles;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < total; s += blockDim.x) {
    const int b = seg_blk[s];
    if (s == 0 || seg_blk[s - 1] != b) blk_first[b] = s;
    if (s == total - 1 || seg_blk[s + 1] != b) blk_last[b] = s;
  }
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
    reduce_segments(const int* __restrict__ keys,
                    const float* __restrict__ vals, Plan p,
                    const int* __restrict__ seg_tile,
                    const int* __restrict__ seg_blk,
                    const int* __restrict__ n_seg,
                    float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[32];
  const int s = blockIdx.x;
  if (s >= *n_seg) return;
  const int col0 = blockIdx.y * p.cols;
  const int nc = min(p.cols, p.d - col0);
  float* table = reinterpret_cast<float*>(smem);  // [block_k][nc]
  int* s_local = reinterpret_cast<int*>(table + (size_t)p.block_k * p.cols);
  int* s_list = s_local + p.stage;  // stage indices, grouped by owner
  int* s_pos = s_list + p.stage;  // [owner][warp] counts, then offsets
  int* s_start = s_pos + kWarps * kWarps;  // each owner's list, and the end
  float* s_vals = reinterpret_cast<float*>(s_start + kWarps + 1);
  const int key0 = seg_blk[s] * p.block_k;
  const long long lo = (long long)seg_tile[s] * p.tile;
  const long long hi = min(p.n, (long long)seg_tile[s + 1] * p.tile);
  for (int i = threadIdx.x; i < p.block_k * nc; i += blockDim.x)
    table[i] = identity<OP>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;

  for (long long c0 = lo; c0 < hi; c0 += p.stage) {
    const int m = (int)min((long long)p.stage, hi - c0);
    __syncthreads();  // the table is initialized / the last stage is read
    if (threadIdx.x < m) {  // stage <= kThreads: one pair per thread
      const int key = keys[c0 + threadIdx.x];
      const int lk = key - key0;
      s_local[threadIdx.x] =
          key >= 0 && key < p.k && lk >= 0 && lk < p.block_k ? lk : -1;
    }
    for (int i = threadIdx.x; i < m * nc; i += blockDim.x) {
      const int row = i / nc;
      const int c = i - row * nc;
      s_vals[i] = vals[(c0 + row) * p.d + col0 + c];
    }
    s_pos[threadIdx.x] = 0;
    __syncthreads();
    // bucket the stage by owning warp, stably
    const int lk = threadIdx.x < m ? s_local[threadIdx.x] : -1;
    const int owner = lk >= 0 ? lk % kWarps : -1 - lane;
    const unsigned peers = __match_any_sync(0xffffffffu, owner);
    const int rank = __popc(peers & lower);
    if (lk >= 0 && rank == 0) s_pos[owner * kWarps + warp] = __popc(peers);
    __syncthreads();
    const int count = s_pos[threadIdx.x];
    const int incl = scan::block_scan<false>(count, s_warp);
    s_pos[threadIdx.x] = incl - count;
    if (lane == 0) s_start[warp] = incl - count;  // thread = owner * 32
    if (threadIdx.x == blockDim.x - 1) s_start[kWarps] = incl;
    __syncthreads();
    if (lk >= 0) s_list[s_pos[owner * kWarps + warp] + rank] = threadIdx.x;
    __syncthreads();
    // warp `warp` folds its own keys' pairs, in stage order
    const int end = s_start[warp + 1];
    for (int j0 = s_start[warp]; j0 < end; j0 += 32) {
      const int src = j0 + lane < end ? s_list[j0 + lane] : -1;
      const int key = src >= 0 ? s_local[src] : -1 - lane;
      const unsigned same = __match_any_sync(0xffffffffu, key);
      if (src >= 0 && __ffs(same) - 1 == lane) {
        float* row = table + key * nc;
        for (unsigned rest = same; rest != 0; rest &= rest - 1) {
          const float* v = s_vals + s_list[j0 + __ffs(rest) - 1] * nc;
          for (int c = 0; c < nc; ++c) row[c] = combine<OP>(row[c], v[c]);
        }
      }
    }
  }
  __syncthreads();
  float* out = partial + (size_t)s * p.block_k * p.d + col0;
  for (int i = threadIdx.x; i < p.block_k * nc; i += blockDim.x) {
    const int local = i / nc;
    out[(size_t)local * p.d + (i - local * nc)] = table[i];
  }
}

template <int OP>
__global__ void merge_segments(Plan p, const float* __restrict__ partial,
                               const int* __restrict__ blk_first,
                               const int* __restrict__ blk_last,
                               const float* __restrict__ acc,
                               float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)p.k * p.d) return;
  const int key = (int)(e / p.d);
  const int c = (int)(e - (long long)key * p.d);
  const int b = key / p.block_k;
  const int local = key - b * p.block_k;
  float r = identity<OP>();
  const int last = blk_last[b];
  for (int s = blk_first[b]; s >= 0 && s <= last; ++s)
    r = combine<OP>(r, partial[((size_t)s * p.block_k + local) * p.d + c]);
  if (acc != nullptr) r = combine<OP>(acc[e], r);
  out[e] = r;
}

#define SEGRED_CHECK()                     \
  do {                                     \
    cudaError_t e_ = cudaGetLastError();   \
    if (e_ != cudaSuccess) return e_;      \
  } while (0)

template <int OP>
cudaError_t run(const Plan& p, const int* keys, const float* vals,
                const float* acc, float* out, void* scratch,
                cudaStream_t stream) {
  Scratch s;
  carve(p, (char*)scratch, &s);
  tile_blocks<<<(p.n_tiles + 255) / 256, 256, 0, stream>>>(keys, p,
                                                           s.tile_blk);
  SEGRED_CHECK();
  plan_segments<<<1, kThreads, 0, stream>>>(p, s.tile_blk, s.seg_tile,
                                            s.seg_blk, s.n_seg, s.blk_first,
                                            s.blk_last);
  SEGRED_CHECK();
  cudaFuncSetAttribute(reduce_segments<OP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)p.smem);
  SEGRED_CHECK();
  reduce_segments<OP><<<dim3(p.max_seg, p.col_tiles), kThreads, p.smem,
                        stream>>>(keys, vals, p, s.seg_tile, s.seg_blk,
                                  s.n_seg, s.partial);
  SEGRED_CHECK();
  const long long kd = (long long)p.k * p.d;
  merge_segments<OP><<<(unsigned)((kd + 255) / 256), 256, 0, stream>>>(
      p, s.partial, s.blk_first, s.blk_last, acc, out);
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
    case keyed_fold::kAdd:
      return (int)segred::run<keyed_fold::kAdd>(p, keys, vals, acc, out,
                                                scratch, s);
    case keyed_fold::kMax:
      return (int)segred::run<keyed_fold::kMax>(p, keys, vals, acc, out,
                                                scratch, s);
    case keyed_fold::kMin:
      return (int)segred::run<keyed_fold::kMin>(p, keys, vals, acc, out,
                                                scratch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* segment_reduce_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
