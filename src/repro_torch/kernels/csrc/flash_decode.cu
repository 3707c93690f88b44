// flash_decode for sm_90a: one-token GQA decode attention over a KV cache,
// batched, with a per-row valid length.
//
// What it computes, for each batch row b and query head h (G = H / Hkv query
// heads share KV head h / G), with scale = D^-0.5 and n = min(kv_len[b], S):
//   out[b, h, :] = sum_{t < n} softmax_t(scale * q[b, h] . k[b, t, h / G]) v[b, t, h / G]
// in f32, from f32 or bf16 inputs.  n = 0 gives zeros, as the TPU kernel does.
//
// Replaces the Pallas kernel src/repro/kernels/flash_decode.py::flash_decode
// (_kernel).  Its grid (batch, kv_heads, S tiles) ran in order on one TPU
// core, with the (m, l, acc) holder of the G heads (running max, rescaled
// normalizer, rescaled value sum) resident in VMEM across the S tiles.  On
// Hopper that grid would give B * Hkv blocks, 2 at the bench shape and 32 at
// llama3-8b's decode shape, for 132 SMs, so S is split across blocks.
//
// Bound on this card: bytes.  A call must read the K and V rows below n,
// 2 * sum_b n_b * Hkv * D * sizeof(T), plus q, and write B * H * D * 4; at
// 3.35 TB/s that is about 10 us for llama3-8b's decode (B = 4, Hkv = 8,
// D = 128, n = 2080, bf16).  The operations (4 * G flops per K/V element
// pair) bind far less.  The first design read one element per lane per K
// position, folded p.V in a dependent chain per thread and merged the splits
// in a second launch: it kept about 1 KB in flight per block and ran at 12x
// the bound.  This one keeps tiles in flight and folds them from shared
// memory; what holds it back now is the latency of each tile's three phases
// in a block (a few warps an SM share the work of each tile), and the
// merge by the last block at the end.
//   - grid (split, kv head x head batch, batch row), 256 threads; a block
//     takes up to 4 heads of a KV head (8 when G > 4; more heads take more
//     blocks) and one chunk of positions, a whole number of tiles of up to
//     64 positions (split_plan in flash_decode.py sizes both from the blocks
//     that fit on an SM, for one wave).  Its tiles' K and V rows stream into
//     a ring of two stages in shared memory with 16-byte cp.async, one tile
//     ahead (rows padded by 16 bytes, so neighbouring rows fall in other
//     banks).
//   - each tile: logits, TP threads per position (adjacent lanes, a fixed
//     butterfly), from the staged K row and the scaled q (f32, broadcast from
//     shared memory), and the tile's max per head as an integer max over
//     warps (an order-free exact max); one warp per head then takes
//     m' = max(m, tile max), p = e^(x - m'), alpha = e^(m - m') and
//     l = l alpha + sum p; then thread (vector, group) folds
//     acc = acc alpha + p.V for its 8 (bf16) or 4 (f32) columns over the
//     positions of its group, independent chains over 16-byte reads.  Three
//     barriers a tile.  At the end the groups' acc are joined through shared
//     memory in group order.
//   - merge: each block writes its chunk's holder, then takes a ticket from
//     an integer counter of its (b, kv head, head batch); the block that
//     takes the last one stages every holder in shared memory (all loads at
//     once) and merges them in split order: m* = max_s m_s, then
//     l = sum_s l_s e^(m_s - m*) and acc = sum_s acc_s e^(m_s - m*) in split
//     order, out = acc / max(l, 1e-30), and resets the counter.  One launch.
// No float atomics; the order of every float operation is fixed by the
// shapes, so two runs give the same bits.  IEEE f32 on the CUDA cores, q
// scaled in f32 before the dot.  Masking follows the TPU kernel: positions
// at or past n take no part, a chunk wholly past n writes the empty holder
// (m = -1e30, l = 0, acc = 0), and l is floored at 1e-30.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "device_prims.cuh"

namespace flash_decode {

constexpr int kThreads = 256;
constexpr int kMaxRegs = 128;  // registers a thread (split_plan counts on it)
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 16;   // bytes after each staged row
constexpr int kStages = 2;  // tiles in the ring, kStages - 1 ahead
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// 16 bytes of T widened to f32: 4 floats or 8 bf16 values.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      *reinterpret_cast<unsigned*>(&h) = w[i];
      const float2 f = __bfloat1622float2(h);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

// A float as an int whose integer order is the float order (no NaN).
__device__ __forceinline__ int ordered(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

using prims::cp_async16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared memory of one block, in bytes, and its parts' offsets: GB heads'
// scaled q, one tile's logits, two tiles' maxima, the holder's m and l and
// the tile's rescale, then a ring of kStages tiles of K and V rows, over
// which the p.V sums of the position groups are joined at the end.
struct Layout {
  int row, q, p, stats, ring, total;
};

__host__ __device__ inline Layout layout(int GB, int D, int elt, int tile) {
  Layout L;
  L.row = D * elt + kPad;
  const int groups = kThreads / (D * elt / 16);
  const int red = groups * GB * D * 4;
  const int ring = kStages * 2 * tile * L.row;
  L.q = 0;
  L.p = L.q + GB * D * 4;
  L.stats = L.p + GB * tile * 4;
  L.ring = (L.stats + 5 * GB * 4 + 15) / 16 * 16;
  L.total = L.ring + (ring > red ? ring : red);
  return L;
}

template <typename T, int GB>
__global__ void __launch_bounds__(kThreads, 65536 / (kThreads * kMaxRegs))
fold_chunks(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ kv_len,
            float* __restrict__ part_m, float* __restrict__ part_l,
            float* __restrict__ part_acc, int* __restrict__ tickets,
            float* __restrict__ out, int S, int H, int Hkv, int D, int tile,
            int chunk, int n_split, float scale) {
  constexpr int VN = Vec<T>::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int G = H / Hkv, nhb = (G + GB - 1) / GB;
  const Layout L = layout(GB, D, (int)sizeof(T), tile);
  float* s_q = reinterpret_cast<float*>(smem + L.q);
  float* s_p = reinterpret_cast<float*>(smem + L.p);
  int* s_tmax = reinterpret_cast<int*>(smem + L.stats);  // [2][GB]
  float* s_mrun = reinterpret_cast<float*>(s_tmax + 2 * GB);  // the holder
  float* s_l = s_mrun + GB;
  float* s_alpha = s_l + GB;  // this tile's rescale
  unsigned char* s_ring = smem + L.ring;  // [stage][K, V][tile][row]
  float* s_red = reinterpret_cast<float*>(s_ring);

  const int split = blockIdx.x, b = blockIdx.z;
  const int kh = blockIdx.y / nhb, hbi = blockIdx.y - kh * nhb;
  const int gc = min(GB, G - hbi * GB);  // heads of this block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = min(max(kv_len[b], 0), S);
  const int lo = split * chunk;
  const int cnt = max(0, min(lo + chunk, n) - lo);
  const long long hb = (long long)b * H + (long long)kh * G + hbi * GB;
  const int R = D / VN;  // 16-byte vectors per row

  if (cnt > 0) {
    const long long row = (long long)Hkv * D;  // elements between positions
    const T* kb = k + ((long long)b * S + lo) * row + (long long)kh * D;
    const T* vb = v + ((long long)b * S + lo) * row + (long long)kh * D;
    auto fetch = [&](int i) {  // tile i's K and V rows into its stage
      const int t0 = i * tile;
      if (t0 < cnt) {
        const int m = min(tile, cnt - t0);
        unsigned char* sk = s_ring + (i % kStages) * 2 * tile * L.row;
        unsigned char* sv = sk + tile * L.row;
        for (int e = tid; e < m * R; e += kThreads) {
          const int t = e / R, c = e - t * R;
          const long long off = (long long)(t0 + t) * row + c * VN;
          cp_async16(sk + t * L.row + c * 16, kb + off);
          cp_async16(sv + t * L.row + c * 16, vb + off);
        }
      }
      prims::cp_async_commit();
    };
    for (int i = 0; i < kStages - 1; ++i) fetch(i);
    const T* qb = q + hb * D;
    for (int e = tid; e < gc * D; e += kThreads) s_q[e] = to_f32(qb[e]) * scale;
    if (tid < 2 * GB) s_tmax[tid] = ordered(kNegInf);
    if (tid < GB) {
      s_mrun[tid] = kNegInf;
      s_l[tid] = 0.0f;
    }
    // logits: TP threads per position (adjacent lanes), each a share of the
    // row's vectors, joined by a fixed butterfly
    int TP = 1;
    while (TP < 32 && TP * 2 <= R && tile * TP * 2 <= kThreads) TP *= 2;
    const int part = tid % TP, per_pass = kThreads / TP;
    // p.V: thread (c, grp) sums positions grp, grp + PG, ... of vector c,
    // and (c == 0) their p, for the running holder of each head: every
    // thread keeps the same m, its own share of l and of acc
    const int PG = kThreads / R;
    const int c = tid % R, grp = tid / R;
    float acc[GB][VN];
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int u = 0; u < VN; ++u) acc[g][u] = 0.0f;

    for (int i = 0; i * tile < cnt; ++i) {
      const int m = min(tile, cnt - i * tile);
      const unsigned char* sk = s_ring + (i % kStages) * 2 * tile * L.row;
      const unsigned char* sv = sk + tile * L.row;
      int* tmax = s_tmax + (i & 1) * GB;
      // tile i has landed (the kStages - 2 after it may be in flight)
      prims::cp_async_wait<kStages - 2>();
      __syncthreads();  // ... for every thread; tile i - 1 is read
      fetch(i + kStages - 1);  // into the stage of tile i - 1
      if (tid < GB) s_tmax[((i + 1) & 1) * GB + tid] = ordered(kNegInf);
      for (int t0 = 0; t0 < m; t0 += per_pass) {
        const int t = t0 + tid / TP;
        const unsigned char* kr = sk + min(t, m - 1) * L.row;
        float dot[GB];
#pragma unroll
        for (int g = 0; g < GB; ++g) dot[g] = 0.0f;
        for (int cc = part; cc < R; cc += TP) {
          float x[VN];
          Vec<T>::load(kr + cc * 16, x);
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            if (g < gc) {
              const float4* qv =
                  reinterpret_cast<const float4*>(s_q + g * D + cc * VN);
#pragma unroll
              for (int u = 0; u < VN / 4; ++u) {
                const float4 w = qv[u];
                dot[g] = fmaf(w.x, x[4 * u], dot[g]);
                dot[g] = fmaf(w.y, x[4 * u + 1], dot[g]);
                dot[g] = fmaf(w.z, x[4 * u + 2], dot[g]);
                dot[g] = fmaf(w.w, x[4 * u + 3], dot[g]);
              }
            }
          }
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          for (int off = 1; off < TP; off <<= 1)
            dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
          // the tile's max: a warp's, then an integer max over the warps
          const float wmax = warp_max(t < m ? dot[g] : kNegInf);
          if (lane == 0 && g < gc) atomicMax(tmax + g, ordered(wmax));
        }
        if (part == 0 && t < m) {
#pragma unroll
          for (int g = 0; g < GB; ++g)
            if (g < gc) s_p[g * tile + t] = dot[g];
        }
      }
      __syncthreads();
      // the holder of each head over this tile, one warp per head:
      // m' = max(m, tile max), p = e^(x - m'), alpha = e^(m - m'),
      // l = l alpha + sum p
      for (int g = warp; g < gc; g += kWarps) {
        float* pg = s_p + g * tile;
        const float m_old = s_mrun[g];
        const float m_new = fmaxf(m_old, unordered(tmax[g]));
        float sum = 0.0f;
        for (int t = lane; t < m; t += 32) {
          const float p = expf(pg[t] - m_new);
          pg[t] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          s_alpha[g] = alpha;
          s_l[g] = s_l[g] * alpha + sum;
          s_mrun[g] = m_new;
        }
      }
      __syncthreads();
      // acc = acc alpha + p.V over this tile
      if (grp < PG) {
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float a = g < gc ? s_alpha[g] : 0.0f;
#pragma unroll
          for (int u = 0; u < VN; ++u) acc[g][u] *= a;
        }
        for (int t = grp; t < m; t += PG) {
          float x[VN];
          Vec<T>::load(sv + t * L.row + c * 16, x);
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            const float p = g < gc ? s_p[g * tile + t] : 0.0f;
#pragma unroll
            for (int u = 0; u < VN; ++u) acc[g][u] = fmaf(p, x[u], acc[g][u]);
          }
        }
      }
    }
    __syncthreads();  // the ring is read
    // join the position groups' sums in group order, over the ring
    if (grp < PG) {
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int u = 0; u < VN; ++u)
          s_red[(grp * GB + g) * D + c * VN + u] = acc[g][u];
    }
    __syncthreads();
    for (int e = tid; e < gc * D; e += kThreads) {
      const int g = e / D, d = e - g * D;
      float sum = 0.0f;
      for (int r = 0; r < PG; ++r) sum += s_red[(r * GB + g) * D + d];
      part_acc[((hb + g) * n_split + split) * D + d] = sum;
    }
    if (tid < gc) {
      part_m[(hb + tid) * n_split + split] = s_mrun[tid];
      part_l[(hb + tid) * n_split + split] = s_l[tid];
    }
  } else {  // wholly past n: the empty holder
    for (int g = tid; g < gc; g += kThreads) {
      part_m[(hb + g) * n_split + split] = kNegInf;
      part_l[(hb + g) * n_split + split] = 0.0f;
    }
    for (int e = tid; e < gc * D; e += kThreads) {
      const int g = e / D, d = e - g * D;
      part_acc[((hb + g) * n_split + split) * D + d] = 0.0f;
    }
  }

  // the last block of this (b, kv head, head batch) to finish merges every
  // split
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ticket = tickets + ((long long)b * Hkv + kh) * nhb + hbi;
    s_last = atomicAdd(ticket, 1) == n_split - 1;
    if (s_last) *ticket = 0;  // ready for the next call
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // every holder's m, l and acc into shared memory, in batches of splits
  // (one when they fit), all loads at once; the weights e^(m_s - m*), one
  // warp per head, and l in split order; each (head, column) then sums its
  // splits in order
  float* s_w = reinterpret_cast<float*>(smem);  // [gc][n_split] each, then l
  float* s_ls = s_w + gc * n_split;
  const int wfloats = (gc * (2 * n_split + 1) + 3) / 4 * 4;
  const int batch = min(n_split, (L.total / 4 - wfloats) / (gc * D));
  float* s_acc = s_w + wfloats;  // [gc][batch][D]
  auto stage_acc = [&](int s0, int nb) {  // splits s0 .. s0 + nb - 1
    constexpr int kBatch = 8;  // loads in flight a thread
    const int q4 = D / 4, n4 = gc * nb * q4;
    for (int e0 = 0; e0 < n4; e0 += kBatch * kThreads) {
      float4 x[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = e0 + j * kThreads + tid;
        if (e < n4) {
          const int g = e / (nb * q4), r = e - g * nb * q4;
          const int sp = r / q4, d4 = r - sp * q4;
          x[j] = __ldcg(reinterpret_cast<const float4*>(
                            part_acc + ((hb + g) * n_split + s0 + sp) * D) +
                        d4);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = e0 + j * kThreads + tid;
        if (e < n4) reinterpret_cast<float4*>(s_acc)[e] = x[j];
      }
    }
  };
  if (batch < 1) {  // no room to stage: one (head, column) at a time
    for (int e = tid; e < gc * D; e += kThreads) {
      const int g = e / D, d = e - g * D;
      const float* pm = part_m + (hb + g) * n_split;
      const float* pl = part_l + (hb + g) * n_split;
      const float* pa = part_acc + (hb + g) * n_split * D + d;
      float mstar = kNegInf, l = 0.0f, a = 0.0f;
      for (int s = 0; s < n_split; ++s) mstar = fmaxf(mstar, __ldcg(pm + s));
      for (int s = 0; s < n_split; ++s) {
        const float w = expf(__ldcg(pm + s) - mstar);
        l = fmaf(__ldcg(pl + s), w, l);
        a = fmaf(__ldcg(pa + (long long)s * D), w, a);
      }
      out[(hb + g) * D + d] = a / fmaxf(l, 1e-30f);
    }
    return;
  }
  for (int e = tid; e < gc * n_split; e += kThreads) {
    const int g = e / n_split, sp = e - g * n_split;
    s_w[e] = __ldcg(part_m + (hb + g) * n_split + sp);
    s_ls[e] = __ldcg(part_l + (hb + g) * n_split + sp);
  }
  stage_acc(0, batch);
  __syncthreads();
  for (int g = warp; g < gc; g += kWarps) {
    float mstar = kNegInf;
    for (int sp = lane; sp < n_split; sp += 32)
      mstar = fmaxf(mstar, s_w[g * n_split + sp]);
    mstar = warp_max(mstar);
    for (int sp = lane; sp < n_split; sp += 32)
      s_w[g * n_split + sp] = expf(s_w[g * n_split + sp] - mstar);
    __syncwarp();
    if (lane == 0) {
      float l = 0.0f;
      for (int sp = 0; sp < n_split; ++sp)
        l = fmaf(s_ls[g * n_split + sp], s_w[g * n_split + sp], l);
      s_ls[gc * n_split + g] = l;
    }
  }
  constexpr int kPer = 8 * 256 / kThreads;  // (head, column) pairs a thread
  float a[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) a[i] = 0.0f;
  for (int s0 = 0; s0 < n_split; s0 += batch) {
    const int nb = min(batch, n_split - s0);
    if (s0 > 0) {
      __syncthreads();  // the last batch is read
      stage_acc(s0, nb);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < gc * D) {
        const int g = e / D, d = e - g * D;
        for (int sp = 0; sp < nb; ++sp)
          a[i] = fmaf(s_acc[(g * nb + sp) * D + d], s_w[g * n_split + s0 + sp],
                      a[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads;
    if (e < gc * D) {
      const int g = e / D;
      out[(hb + g) * D + (e - g * D)] =
          a[i] / fmaxf(s_ls[gc * n_split + g], 1e-30f);
    }
  }
}

template <typename T, int GB>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, float* out, float* part_m, float* part_l,
                   float* part_acc, int* tickets, int B, int S, int H, int Hkv,
                   int D, int tile, int chunk, int n_split,
                   cudaStream_t stream) {
  const int nhb = (H / Hkv + GB - 1) / GB;
  const int smem = layout(GB, D, (int)sizeof(T), tile).total;
  static int allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fold_chunks<T, GB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  fold_chunks<T, GB><<<dim3(n_split, Hkv * nhb, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_len, part_m, part_l, part_acc,
      tickets, out, S, H, Hkv, D, tile, chunk, n_split,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* kv_len, float* out, float* part_m,
                     float* part_l, float* part_acc, int* tickets, int B,
                     int S, int H, int Hkv, int D, int tile, int chunk,
                     int n_split, cudaStream_t stream) {
  if (H / Hkv <= 4)
    return launch<T, 4>(q, k, v, kv_len, out, part_m, part_l, part_acc,
                        tickets, B, S, H, Hkv, D, tile, chunk, n_split,
                        stream);
  return launch<T, 8>(q, k, v, kv_len, out, part_m, part_l, part_acc, tickets,
                      B, S, H, Hkv, D, tile, chunk, n_split, stream);
}

}  // namespace flash_decode

// q [B, H, D], k and v [B, S, Hkv, D], all f32 (bf16 = 0) or all bf16
// (bf16 = 1), contiguous and 16-byte aligned, D * sizeof(T) a multiple of 16;
// kv_len [B] int32; out [B, H, D] f32; part_m and part_l [B, H, n_split],
// part_acc [B, H, n_split, D] f32 scratch; tickets [B * Hkv * ceil(G / GB)]
// int32 (GB = 4 heads a block for G <= 4, else 8), zero on entry and left
// zero.  Split s covers positions [s * chunk, (s + 1) * chunk), folded
// `tile` positions at a time (chunk a multiple of tile, tile of 32 lanes'
// rows at most 64).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const int* kv_len, float* out, float* part_m,
                                   float* part_l, float* part_acc,
                                   int* tickets, int B, int S, int H, int Hkv,
                                   int D, int tile, int chunk, int n_split,
                                   int bf16, void* stream) {
  using namespace flash_decode;
  const int elt = bf16 ? 2 : 4;
  const int GB = H / Hkv <= 4 ? 4 : 8;
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || D < 1 ||
      (D * elt) % 16 != 0 || D * elt / 16 > kThreads || tile < 1 ||
      tile > 64 || chunk < tile || chunk % tile != 0 || n_split < 1 ||
      (long long)chunk * n_split < S || B > 65535 ||
      (long long)Hkv * ((H / Hkv + GB - 1) / GB) > 65535 ||
      layout(GB, D, elt, tile).total > 232448 - 64)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)dispatch<__nv_bfloat16>(q, k, v, kv_len, out, part_m, part_l,
                                        part_acc, tickets, B, S, H, Hkv, D,
                                        tile, chunk, n_split, s);
  return (int)dispatch<float>(q, k, v, kv_len, out, part_m, part_l, part_acc,
                              tickets, B, S, H, Hkv, D, tile, chunk, n_split,
                              s);
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
