// int_fold for sm_90a: the exact integer keyed fold of the stream flow.
// [n] int32 keys and [n, D] int32 or int64 rows are added into a [K, D]
// int64 table (wrapping modulo 2^64, as index_add_ does), and with counts
// the number of pairs of each key into a [K] int32 counts vector.  Keys
// outside [0, K), the sentinel K among them, never land.
//
// Replaces no Pallas kernel: the reference folds integer channels with an
// exact integer one-hot contraction that XLA fuses
// (src/repro/core/collector.py::StreamCombiner._fold_additive, and
// combine_onehot for the combine flow), which has no pallas_call.  Its
// counterpart on this card was index_add_ over masked copies of the keys and
// the rows plus torch.bincount (int_fold_plain): several passes over the
// pairs, a host sync in bincount, and a dense budget that sent large key
// spaces to the scatter fallback.  Integer addition is associative, so
// integer atomics give the same bits in any order; the port's determinism
// rule bans float atomics only.
//
// Bound: bytes.  Each key and each row is read once (8 B a pair for int32
// rows and D = 1), the table and the counts once in and once out.
// Design: one pass over the pairs, no cast, no mask tensor, no host sync.
//  * A warp takes 32 pairs at a time (kUnroll tiles loaded before any is
//    folded) and groups its lanes by key with one ballot per key bit
//    (prims::match_bits: the grouping __match_any_sync gives, at a fixed cost
//    where __match_any_sync serializes on distinct keys).  Each group's sums
//    reach its lowest lane by pointer jumping over shuffles (group_sum,
//    log2 of the largest group steps) and its pair count is __popc of the
//    group; that lane adds them with one atomic a column.  A hot key (a zipf
//    word, a histogram peak) costs one atomic a warp tile, not one a pair.
//    Summing each group with __reduce_add_sync under the group's own mask
//    took 3.6-6.2x as long (tools/ab_int_fold.py, variant redux), as if the
//    card ran one reduction a distinct mask.
//  * The table's first kp rows (all K where K * (8 D + 4) bytes fit
//    kSmemBytes: Histogram's 768 bins, the counts of K = 100) live in each
//    block's shared memory, each 64-bit cell as two 32-bit words added with
//    native 32-bit atomics and the low word's carry (shared_add64; 64-bit
//    shared atomics took 7-10 % longer, variant shared64); a block
//    flushes each nonzero entry with one global atomic at its end.  The rest
//    take global int64 atomics (atomicAdd on unsigned long long) straight
//    away.  A zipf key space is hottest at its low ids, which the shared rows
//    take.
//  * The launch copies the table and the counts into the outputs first
//    (cudaMemcpyAsync), so a call never writes its inputs.
// On an NVIDIA H100 80GB HBM3 at 700.00 W (tools/ab_int_fold.py, CUDA
// graph), 2^22 pairs with counts take 0.063 ms for WordCount's zipf keys
// over 2^16 words (int64 rows; byte bound 0.0155), 0.046 for Histogram's
// 768 keys (bound 0.0150) and 0.025 for counts alone at K = 100 (bound
// 0.0050).  Rounds of 8 tiles did not move them (variant unroll8), nor did
// issuing each round's loads before the last round was folded: the loads
// are not what bounds it; the shared-memory atomics and the grouping
// instructions are the likely bound, not yet measured apart.

#include <cuda_runtime.h>

#include "device_prims.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;     // warp tiles loaded before one is folded
constexpr int kBlocksPerSm = 2;
constexpr int kSmemBytes = 48 * 1024;  // the default dynamic-smem cap
constexpr unsigned kFull = 0xffffffffu;

// The sum over this lane's group of v, on the group's lowest lane: pointer
// jumping along the group's lanes in lane order (each step adds the partial
// sum of the lane `next` points at and jumps to that lane's pointer), so
// after `steps` steps, ceil(log2) of the largest group, the first lane holds
// its group's whole sum.  Every lane takes part in every shuffle: no step
// is serialized by group, and int32 rows are sign-extended first, so the
// sum is exact (and wraps modulo 2^64 for int64 rows, as index_add_ does).
template <typename T>
__device__ __forceinline__ unsigned long long group_sum(T v, int next,
                                                        int steps) {
  unsigned long long s = (unsigned long long)(long long)v;
  for (int i = 0; i < steps; ++i) {  // warp-uniform
    const unsigned long long o = __shfl_sync(kFull, s, next & 31);
    const int after = __shfl_sync(kFull, next, next & 31);
    if (next < 32) {
      s += o;
      next = after;
    }
  }
  return s;
}

// A 64-bit add into a shared-memory cell held as two 32-bit words, with
// native 32-bit atomics (a 64-bit shared atomic add is a compare-and-swap
// loop): the low word's carry is the one its own add made, so the words
// sum exactly, modulo 2^64, in any order.
__device__ __forceinline__ void shared_add64(unsigned* cell,
                                             unsigned long long s) {
  const unsigned lo = (unsigned)s;
  const unsigned old = atomicAdd(cell, lo);
  const unsigned hi = (unsigned)(s >> 32) + (old + lo < old ? 1u : 0u);
  if (hi != 0) atomicAdd(cell + 1, hi);
}

template <typename T, bool CNT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    int_fold_kernel(const int* __restrict__ keys, const T* __restrict__ rows,
                    unsigned long long* __restrict__ table,
                    unsigned* __restrict__ counts, int n, int d, int k,
                    int kp, int nb) {
  extern __shared__ unsigned smem[];
  unsigned* stab = smem;                          // [kp, d] (lo, hi) words
  unsigned* scnt = smem + (size_t)kp * d * 2;     // [kp]
  for (int j = threadIdx.x; j < kp * d * 2; j += blockDim.x) stab[j] = 0;
  if (CNT)
    for (int j = threadIdx.x; j < kp; j += blockDim.x) scnt[j] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  const long long step = warps * 32;
  const long long first =
      ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 32;
  for (long long base = first; base < n; base += step * kUnroll) {
    int key[kUnroll];
    T val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * step + lane;
      const bool in = i < n;
      key[u] = in ? __ldg(keys + i) : -1;
      val[u] = (in && d > 0) ? __ldg(rows + i * d) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kk = key[u];
      const bool ok = (unsigned)kk < (unsigned)k;
      if (__ballot_sync(kFull, ok) == 0) continue;  // warp-uniform
      const unsigned peers = prims::match_bits(kk, ok, 0, nb);
      const bool lead = ok && lane == __ffs(peers) - 1;
      const bool priv = ok && kk < kp;
      if (d > 0) {
        const unsigned above = peers & ~((2u << lane) - 1u);
        const int next = (ok && above) ? __ffs(above) - 1 : 32;
        const unsigned most =
            __reduce_max_sync(kFull, ok ? (unsigned)__popc(peers) : 1u);
        const int steps = most > 1 ? 32 - __clz((int)most - 1) : 0;
        const long long i = base + u * step + lane;
        for (int c = 0; c < d; ++c) {  // warp-uniform
          const T v = c == 0 ? val[u]
                             : (i < n ? __ldg(rows + i * d + c) : T(0));
          const unsigned long long s = group_sum(v, next, steps);
          if (lead) {
            if (priv)
              shared_add64(stab + ((size_t)kk * d + c) * 2, s);
            else
              atomicAdd(table + (size_t)kk * d + c, s);
          }
        }
      }
      if (CNT && lead) {
        const unsigned cnt = __popc(peers);
        if (priv)
          atomicAdd(scnt + kk, cnt);
        else
          atomicAdd(counts + kk, cnt);
      }
    }
  }
  if (kp == 0) return;
  __syncthreads();
  for (int j = threadIdx.x; j < kp * d; j += blockDim.x) {
    const unsigned long long s =
        ((unsigned long long)stab[2 * j + 1] << 32) | stab[2 * j];
    if (s != 0) atomicAdd(table + j, s);
  }
  if (CNT)
    for (int j = threadIdx.x; j < kp; j += blockDim.x)
      if (scnt[j] != 0) atomicAdd(counts + j, scnt[j]);
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return sms;
}

template <typename T, bool CNT>
cudaError_t run(const int* keys, const void* rows, long long* table,
                int* counts, int n, int d, int k, cudaStream_t s) {
  const int row_bytes = 8 * d + (CNT ? 4 : 0);
  const int kp = row_bytes ? (k < kSmemBytes / row_bytes
                                  ? k : kSmemBytes / row_bytes)
                           : 0;
  const int nb = k > 1 ? 32 - __builtin_clz((unsigned)(k - 1)) : 0;
  const long long want = ((long long)n + kThreads * kUnroll - 1) /
                         ((long long)kThreads * kUnroll);
  const long long cap = (long long)sm_count() * kBlocksPerSm;
  const int grid = (int)(want < cap ? want : cap);
  const size_t smem = (size_t)kp * row_bytes;
  int_fold_kernel<T, CNT><<<grid, kThreads, smem, s>>>(
      keys, (const T*)rows, (unsigned long long*)table, (unsigned*)counts, n,
      d, k, kp, nb);
  return cudaGetLastError();
}

}  // namespace

// table_out = table + per-key sums of rows; counts_out = counts + per-key
// pair counts when counts_out is not null.  n >= 1, K >= 1.
extern "C" int int_fold_launch(const int* keys, const void* rows,
                               int rows_int64, const long long* table,
                               long long* table_out, const int* counts,
                               int* counts_out, int n, int d, int k,
                               void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (d > 0)
    err = cudaMemcpyAsync(table_out, table, (size_t)k * d * sizeof(long long),
                          cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess && counts_out != nullptr)
    err = cudaMemcpyAsync(counts_out, counts, (size_t)k * sizeof(int),
                          cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || (d == 0 && counts_out == nullptr)) return 0;
  if (counts_out != nullptr)
    return (int)(rows_int64 ? run<long long, true>(keys, rows, table_out,
                                                   counts_out, n, d, k, s)
                            : run<int, true>(keys, rows, table_out,
                                             counts_out, n, d, k, s));
  return (int)(rows_int64 ? run<long long, false>(keys, rows, table_out,
                                                  nullptr, n, d, k, s)
                          : run<int, false>(keys, rows, table_out, nullptr,
                                            n, d, k, s));
}

extern "C" const char* int_fold_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
