// Paged decode attention (GQA) over the serving engine's KV pool.
//
// Replaces the Pallas TPU kernel paged_attention
// (src/repro/kernels/paged_attention/kernel.py::paged_attention).
//
// Computes, for each sequence b and kv head k, the G query rows of that
// head against the tokens t in [starts[b], lengths[b]) of its paged cache:
// token t lives in frame kt[b, t / Tp] (K) or vt[b, t / Tp] (V), slot
// t % Tp.  Scores are fp32, scaled by hd^-0.5; the softmax is taken
// online in fp32 with NEG_INF = -1e30 and the output divides by
// max(l, 1e-30) and is stored in q's type, as on the TPU.
//
// What bounds it: bytes.  Decode reads every K and V row of the window
// once (2 * tokens * hd * itemsize per (b, k)) and does ~4 * G * hd flops
// per token, far below the card's ~300 flops per byte balance point, so
// no tensor-core MMA is used.  Design:
//   * one block per (b, k); the G query rows sit in shared memory as fp32;
//   * the block walks [start, length) in chunks of 64 tokens and never
//     touches a page wholly outside that range, so padded page-table
//     columns (frame 0) and tokens before a sliding window cost nothing;
//   * scores: each warp takes whole tokens, its lanes stride the head
//     dimension (coalesced K rows) and reduce with shuffles;
//   * softmax: one warp per query row updates the running max and sum;
//   * values: thread d keeps the fp32 accumulators of dimension d for all
//     G rows in registers and reads V rows coalesced across the block.
// With B * K blocks the card is far from full at small batch: splitting
// the tokens across blocks (flash-decoding) is the next step for speed.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;       // tokens per pass; 2 per lane in softmax
constexpr int kMaxG = 16;
constexpr int kMaxHd = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                       const T* __restrict__ vpool,
                       const int* __restrict__ kt, const int* __restrict__ vt,
                       const int* __restrict__ lengths,
                       const int* __restrict__ starts, T* __restrict__ out,
                       int K, int G, int hd, int Tp, int P, float scale) {
  __shared__ float qs[kMaxG * kMaxHd];
  __shared__ float ps[kMaxG * kChunk];   // scores, then probabilities
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];

  const int b = blockIdx.x / K, kh = blockIdx.x % K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t head_off = ((int64_t)b * K + kh) * G * hd;
  for (int i = tid; i < G * hd; i += kThreads) qs[i] = to_f(q[head_off + i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;

  int len = lengths[b];
  if (len > P * Tp) len = P * Tp;
  const int st = starts[b] > 0 ? starts[b] : 0;
  const int* ktb = kt + (int64_t)b * P;
  const int* vtb = vt + (int64_t)b * P;
  __syncthreads();

  for (int t0 = st; t0 < len; t0 += kChunk) {
    // 1) scores of this chunk: one token per warp at a time
    for (int j = warp; j < kChunk; j += kWarps) {
      const int t = t0 + j;
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
      if (t < len) {
        const int64_t row = ((int64_t)ktb[t / Tp] * Tp + t % Tp) * K + kh;
        const T* kr = kpool + row * hd;
        for (int d = lane; d < hd; d += 32) {
          const float kv = to_f(kr[d]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) part[g] += qs[g * hd + d] * kv;
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float v = part[g];
          for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane == 0) ps[g * kChunk + j] = t < len ? v * scale : kNegInf;
        }
      }
    }
    __syncthreads();
    // 2) online softmax update, one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* pr = ps + g * kChunk;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      float mx = fmaxf(s0, s1);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      float sum = p0 + p1;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // 3) rescale and accumulate P @ V; thread d owns head dimension d
    const int nt = len - t0 < kChunk ? len - t0 : kChunk;
    if (tid < hd) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] *= alpha_s[g];
      for (int j = 0; j < nt; ++j) {
        const int t = t0 + j;
        const int64_t row = ((int64_t)vtb[t / Tp] * Tp + t % Tp) * K + kh;
        const float vv = to_f(vpool[row * hd + tid]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] += ps[g * kChunk + j] * vv;
      }
    }
    __syncthreads();
  }

  if (tid < hd) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G)
        out[head_off + (int64_t)g * hd + tid] =
            from_f<T>(acc[g] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* kt,
           const int* vt, const int* lengths, const int* starts, void* out,
           int B, int K, int G, int hd, int Tp, int P, float scale,
           cudaStream_t s) {
  paged_attention_kernel<T><<<B * K, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), kt, vt, lengths, starts,
      static_cast<T*>(out), K, G, hd, Tp, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, pools and out alike).
int paged_attention(const void* q, const void* kpool, const void* vpool,
                    const int* kt, const int* vt, const int* lengths,
                    const int* starts, void* out, int B, int K, int G, int hd,
                    int Tp, int P, float scale, int dtype, void* stream) {
  if (G < 1 || G > kMaxG || hd < 1 || hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  if (B * K == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, kpool, vpool, kt, vt, lengths, starts,
                                 out, B, K, G, hd, Tp, P, scale, s);
    case 1: return launch<__nv_bfloat16>(q, kpool, vpool, kt, vt, lengths,
                                         starts, out, B, K, G, hd, Tp, P,
                                         scale, s);
    case 2: return launch<__half>(q, kpool, vpool, kt, vt, lengths, starts,
                                  out, B, K, G, hd, Tp, P, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
