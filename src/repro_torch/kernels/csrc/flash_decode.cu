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
// llama3-8b's decode shape, for 132 SMs.  So S is split across blocks:
//   pass 1  grid (split, kv head, batch row).  A block folds the tiles of its
//           S range that lie below n into the holder of its G heads, in f32
//           on the CUDA cores (IEEE f32, no TF32): per tile, one warp per
//           position forms the G logits (lanes split D, a fixed shuffle tree
//           joins them), one warp per head takes the tile's max and the
//           exponentials, and each thread updates its own (head, column)
//           elements of acc.  It writes its partial holder.  A range that
//           lies wholly past n writes the empty holder (m = -1e30, l = 0,
//           acc = 0).
//   pass 2  one block per (b, h), one thread per column: the partial holders
//           merged in split order with the combiner's own merge,
//           m = max(m1, m2), l = l1 e^(m1 - m) + l2 e^(m2 - m), acc likewise,
//           then out = acc / max(l, 1e-30).
// No float atomics; the order of every operation is fixed by the shapes, so
// two runs give the same bits.  Masking follows the TPU kernel: positions at
// or past n take no part (the TPU kernel's NEG_INF = -1e30 logits and p = 0),
// and an empty holder divides by max(l, 1e-30).
//
// Bound on this card: bytes.  A call must read the K and V rows below n,
// 2 * sum_b n_b * Hkv * D * sizeof(T), plus q, and write B * H * D * 4; at
// 3.35 TB/s that is about 10 us for llama3-8b's decode (B = 4, Hkv = 8,
// D = 128, n = 2080, bf16).  The operations (4 * G flops per K/V element
// pair) bind far less.  This first design reads K and V with one element per
// lane and recomputes nothing, but it is not tuned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace flash_decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;           // positions folded per step
constexpr int kMaxDPerLane = 8;     // D <= 256
constexpr int kMaxAccPerThread = 16;  // G * D <= 2048
constexpr int kMaxG = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// Pass 1.  Dynamic shared memory: q (G * D, scaled), p (G * kTile), then the
// holder's m, l and the tile's rescale alpha (G each), all f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fold_splits(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ kv_len,
            float* __restrict__ part_m, float* __restrict__ part_l,
            float* __restrict__ part_acc, int S, int H, int Hkv, int D,
            int chunk, int n_split, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int G = H / Hkv;
  float* s_q = smem;
  float* s_p = s_q + G * D;
  float* s_m = s_p + G * kTile;
  float* s_l = s_m + G;
  float* s_alpha = s_l + G;

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = min(max(kv_len[b], 0), S);
  const int lo = split * chunk;
  const int hi = min(lo + chunk, n);

  const T* qb = q + ((long long)b * H + (long long)kh * G) * D;
  for (int e = tid; e < G * D; e += kThreads) s_q[e] = to_f32(qb[e]) * scale;
  for (int g = tid; g < G; g += kThreads) {
    s_m[g] = kNegInf;
    s_l[g] = 0.0f;
  }
  float acc[kMaxAccPerThread];
#pragma unroll
  for (int i = 0; i < kMaxAccPerThread; ++i) acc[i] = 0.0f;
  __syncthreads();

  const long long row = (long long)Hkv * D;  // elements between positions
  const T* kb = k + (long long)b * S * row + (long long)kh * D;
  const T* vb = v + (long long)b * S * row + (long long)kh * D;

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int nt = min(kTile, hi - t0);
    // logits of the G heads, one warp per position
    for (int t = warp; t < nt; t += kWarps) {
      const T* kr = kb + (long long)(t0 + t) * row;
      float kv[kMaxDPerLane];
#pragma unroll
      for (int j = 0; j < kMaxDPerLane; ++j) {
        const int d = lane + 32 * j;
        kv[j] = d < D ? to_f32(kr[d]) : 0.0f;
      }
      for (int g = 0; g < G; ++g) {
        const float* qg = s_q + g * D;
        float part = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxDPerLane; ++j) {
          const int d = lane + 32 * j;
          if (d < D) part = fmaf(qg[d], kv[j], part);
        }
        part = warp_sum(part);
        if (lane == 0) s_p[g * kTile + t] = part;
      }
    }
    __syncthreads();
    // the holder update of each head, one warp per head
    for (int g = warp; g < G; g += kWarps) {
      float* pg = s_p + g * kTile;
      float mx = kNegInf;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, pg[t]);
      mx = warp_max(mx);
      const float m_prev = s_m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int t = lane; t < nt; t += 32) {
        const float p = expf(pg[t] - m_new);
        pg[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        s_m[g] = m_new;
        s_l[g] = s_l[g] * alpha + sum;
        s_alpha[g] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p . V, each thread its own (head, column) elements
#pragma unroll
    for (int i = 0; i < kMaxAccPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < G * D) {
        const int g = e / D, d = e - g * D;
        const float* pg = s_p + g * kTile;
        const T* vc = vb + (long long)t0 * row + d;
        float a = acc[i] * s_alpha[g];
        for (int t = 0; t < nt; ++t) a = fmaf(pg[t], to_f32(vc[(long long)t * row]), a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  const long long hb = (long long)b * H + (long long)kh * G;  // first head
  for (int g = tid; g < G; g += kThreads) {
    part_m[(hb + g) * n_split + split] = s_m[g];
    part_l[(hb + g) * n_split + split] = s_l[g];
  }
#pragma unroll
  for (int i = 0; i < kMaxAccPerThread; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * D) {
      const int g = e / D, d = e - g * D;
      part_acc[((hb + g) * n_split + split) * D + d] = acc[i];
    }
  }
}

// Pass 2.  Grid B * H, block D: the partial holders merged in split order.
__global__ void merge_splits(const float* __restrict__ part_m,
                             const float* __restrict__ part_l,
                             const float* __restrict__ part_acc,
                             float* __restrict__ out, int D, int n_split) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  float m = kNegInf, l = 0.0f, a = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const float ms = part_m[bh * n_split + s];
    const float ls = part_l[bh * n_split + s];
    const float as = part_acc[(bh * n_split + s) * D + d];
    const float mn = fmaxf(m, ms);
    const float a1 = expf(m - mn), a2 = expf(ms - mn);
    l = l * a1 + ls * a2;
    a = a * a1 + as * a2;
    m = mn;
  }
  out[bh * D + d] = a / fmaxf(l, 1e-30f);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, float* out, float* part_m, float* part_l,
                   float* part_acc, int B, int S, int H, int Hkv, int D,
                   int chunk, int n_split, cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem = sizeof(float) * ((size_t)G * D + (size_t)G * kTile + 3 * (size_t)G);
  fold_splits<T><<<dim3(n_split, Hkv, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_len, part_m, part_l, part_acc,
      S, H, Hkv, D, chunk, n_split, 1.0f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_splits<<<B * H, D, 0, stream>>>(part_m, part_l, part_acc, out, D,
                                        n_split);
  return cudaGetLastError();
}

}  // namespace flash_decode

// q [B, H, D], k and v [B, S, Hkv, D], all f32 (bf16 = 0) or all bf16
// (bf16 = 1), contiguous; kv_len [B] int32; out [B, H, D] f32; part_m and
// part_l [B, H, n_split], part_acc [B, H, n_split, D] f32 scratch.  Split s
// covers positions [s * chunk, (s + 1) * chunk).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const int* kv_len, float* out, float* part_m,
                                   float* part_l, float* part_acc, int B,
                                   int S, int H, int Hkv, int D, int chunk,
                                   int n_split, int bf16, void* stream) {
  using namespace flash_decode;
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || D < 1 ||
      D > 32 * kMaxDPerLane || H / Hkv > kMaxG ||
      (H / Hkv) * D > kThreads * kMaxAccPerThread || chunk < 1 ||
      n_split < 1 || (long long)chunk * n_split < S || B > 65535 ||
      Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, kv_len, out, part_m, part_l,
                                      part_acc, B, S, H, Hkv, D, chunk,
                                      n_split, s);
  return (int)launch<float>(q, k, v, kv_len, out, part_m, part_l, part_acc, B,
                            S, H, Hkv, D, chunk, n_split, s);
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
