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
// max(l, 1e-30) and is stored in q's type, as on the TPU.  A sequence
// with no token in its range gets the mean of V over all P * Tp slots of
// its table, padded columns included, as the TPU kernel gives (every
// score masked alike, so every slot weighs the same).
//
// What bounds it: bytes.  Per token and kv head it reads 2 * hd * itemsize
// bytes of K and V and does 4 * G * hd flops: at G = 4 that is 2 flops per
// byte in fp32 and 4 in bf16, far below the ~295 at which the H100's
// tensor cores, not its memory, become the limit.  So no wgmma or mma is
// used; the design is about keeping enough bytes in flight:
//   * split across blocks (flash-decoding).  Each (b, k) is cut into
//     `splits` ranges of `cols` page-table columns, one block each, so that
//     B * K * splits is about two blocks per SM (plan.py, from the shapes
//     alone).  At the main path's decode shape (P = 1) splits == 1;
//   * one coalesced read brings the block's columns of kt/vt into shared
//     memory, and the G query rows as fp32;
//   * one thread issues cp.async.bulk loads of the K and V rows of its
//     tiles (`tile` tokens of one page) into a ring of kStages stages that
//     complete on mbarriers, so every load of a block with up to kStages
//     tiles is in flight at once.  When K == 1 (gemma3-1b) a tile's rows
//     for the head are one contiguous tile * hd * itemsize span: one copy
//     each for K and V.  Otherwise one copy per row of hd * itemsize bytes;
//   * all warps then compute from shared memory: scores (a warp per token,
//     lanes over the head dimension with their slice of q in registers,
//     shuffle sums), the online softmax (a warp per query row) and P @ V
//     (thread d owns dimension d of all G rows, reading each token's G
//     probabilities as one vector), and the tile's stage is reloaded with
//     tile k + kStages.  G is rounded up to a compile-time 1, 2, 4, 8 or 16
//     so that these loops unroll: a first version with G a run-time bound
//     spent far longer in them than in the loads.
//     Tiles wholly outside [start, length) are never loaded, and masked
//     tokens of a partial tile are never read;
//   * with splits > 1 each block writes (m, l, acc[G, hd]) in fp32 to a
//     workspace the wrapper allocates, and a second small kernel combines
//     the splits (32 head dims a block; the splits' weights staged in
//     shared memory in one parallel read, then its warps take the splits
//     in turn, summed in a fixed order, so the result is deterministic),
//     writing q's type.  A split with no token writes m = -1e30, l = 0
//     and drops out.  For an empty range every split counts its slots as
//     equal scores (m = 0, l = its slots, acc = the sum of their V), which
//     combines to the mean;
//   * where hd * itemsize is not a multiple of 16 or a pool is misaligned,
//     the same kernel fills its stage with plain loads (the `loads` route,
//     counted by the wrapper like the `tma` route).
// A stage holds 2 * tile * hd * itemsize bytes: 32 KB in fp32 at hd = 256,
// so the ring of two takes 64 KB of dynamic shared memory, and two blocks
// fit on an SM (more than 48 KB is asked for with cudaFuncSetAttribute).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kMaxHd = 256;      // one thread per head dimension
constexpr int kMaxTile = 16;     // tokens per stage (plan.py: MAX_TILE)
constexpr int kMaxCols = 256;    // page-table columns per block (MAX_COLS)
constexpr int kStages = 2;        // two blocks per SM: 4 stages in flight
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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

struct Args {
  const void *q, *kpool, *vpool;
  const int *kt, *vt, *lengths, *starts;
  void* out;
  float* ws;        // splits > 1: (B*K*splits, G, 2) m, l, then acc
  int K, G, hd, Tp, P, splits, cols, tile;
  float scale;
};

// Dynamic shared memory: the ring and its barriers, the scores (g-major)
// and probabilities (token-major), the running max/sum/rescale, q as
// fp32, the block's page-table columns.
template <typename T>
__host__ __device__ __forceinline__ int64_t ring_bytes(int tile, int hd) {
  return (int64_t)kStages * 2 * tile * hd * sizeof(T);
}

template <typename T>
__host__ __device__ __forceinline__ int64_t smem_bytes(int G, int hd,
                                                       int tile, int cols) {
  return ring_bytes<T>(tile, hd) + kStages * 8 +
         (2 * kMaxG * kMaxTile + 3 * kMaxG + (int64_t)G * hd + 2 * cols) * 4;
}

// kG: the query rows per kv head rounded up to 1, 2, 4, 8 or 16, so the
// per-row loops unroll; rows g >= G compute on q = 0 and are not stored.
template <typename T, int kG, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
paged_attention_kernel(const __grid_constant__ Args a) {
  constexpr int kD = kMaxHd / 32;            // head dims per lane, at most
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = a.G, hd = a.hd, Tp = a.Tp, tile = a.tile, K = a.K;
  const int64_t tile_elems = (int64_t)tile * hd;      // of K or of V
  T* ring = reinterpret_cast<T*>(smem);
  unsigned char* after = smem + ring_bytes<T>(tile, hd);
  const uint32_t bars = (uint32_t)__cvta_generic_to_shared(after);
  float* ps = reinterpret_cast<float*>(after + kStages * 8);  // [g][j]
  float* pt = ps + kMaxG * kMaxTile;                           // [j][g]
  float* m_s = pt + kMaxG * kMaxTile;
  float* l_s = m_s + kMaxG;
  float* alpha_s = l_s + kMaxG;
  float* qs = alpha_s + kMaxG;
  int* kt_s = reinterpret_cast<int*>(qs + G * hd);
  int* vt_s = kt_s + a.cols;

  const int split = blockIdx.x % a.splits, bk = blockIdx.x / a.splits;
  const int b = bk / K, kh = bk % K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // this block's tokens: its columns' slots, cut to [start, length) unless
  // that range is empty
  int len = a.lengths[b];
  if (len > a.P * Tp) len = a.P * Tp;
  const int st = a.starts != nullptr && a.starts[b] > 0 ? a.starts[b] : 0;
  const bool empty = st >= len;
  const int c0 = split * a.cols;
  const int c1 = c0 + a.cols < a.P ? c0 + a.cols : a.P;
  int lo = c0 * Tp, hi = c1 * Tp;
  if (!empty) {
    lo = lo > st ? lo : st;
    hi = hi < len ? hi : len;
  }
  const int u0 = lo / tile;
  const int ntiles = hi > lo ? (hi + tile - 1) / tile - u0 : 0;

  const T* q = static_cast<const T*>(a.q) + (int64_t)bk * G * hd;
  for (int i = tid; i < G * hd; i += kThreads) qs[i] = to_f(q[i]);
  for (int i = tid; i < c1 - c0; i += kThreads) {
    kt_s[i] = a.kt[(int64_t)b * a.P + c0 + i];
    vt_s[i] = a.vt[(int64_t)b * a.P + c0 + i];
  }
  if (tid < kG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  if (kTma && tid == 0) {
    for (int s = 0; s < kStages; ++s) tma::mbar_init(bars + 8 * s, 1);
    tma::mbar_fence_init();
  }
  __syncthreads();

  const T* kpool = static_cast<const T*>(a.kpool);
  const T* vpool = static_cast<const T*>(a.vpool);
  // first K and V rows of tile k, in units of hd elements; row r of the
  // tile is that plus r * K
  auto tile_rows = [&](int k, int64_t& krow, int64_t& vrow) {
    const int t = (u0 + k) * tile;
    const int col = t / Tp - c0, slot = t % Tp;
    krow = ((int64_t)kt_s[col] * Tp + slot) * K + kh;
    vrow = ((int64_t)vt_s[col] * Tp + slot) * K + kh;
  };
  auto issue = [&](int k) {               // one thread, kTma only
    int64_t krow, vrow;
    tile_rows(k, krow, vrow);
    const int s = k % kStages;
    const uint32_t kd = (uint32_t)__cvta_generic_to_shared(
        ring + (int64_t)s * 2 * tile_elems);
    const uint32_t vd = kd + (uint32_t)(tile_elems * sizeof(T));
    const uint32_t row = (uint32_t)(hd * sizeof(T));
    const uint32_t bar = bars + 8 * s;
    tma::mbar_arrive_expect_tx(bar, 2 * tile * row);
    if (K == 1) {
      tma::bulk_load(kd, kpool + krow * hd, tile * row, bar);
      tma::bulk_load(vd, vpool + vrow * hd, tile * row, bar);
    } else {
      for (int r = 0; r < tile; ++r) {
        tma::bulk_load(kd + r * row, kpool + (krow + (int64_t)r * K) * hd,
                       row, bar);
        tma::bulk_load(vd + r * row, vpool + (vrow + (int64_t)r * K) * hd,
                       row, bar);
      }
    }
  };
  if (kTma && tid == 0)
    for (int k = 0; k < ntiles && k < kStages; ++k) issue(k);

  // lane's slice of the query rows, in registers: dims lane + 32 * i
  float qr[kG][kD];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      const int d = lane + 32 * i;
      qr[g][i] = g < G && d < hd ? qs[g * hd + d] : 0.f;
    }
  float acc[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) acc[g] = 0.f;

  for (int k = 0; k < ntiles; ++k) {
    const int s = kTma ? k % kStages : 0;
    T* ks = ring + (int64_t)s * 2 * tile_elems;
    T* vs = ks + tile_elems;
    if (kTma) {
      tma::mbar_wait(bars + 8 * s, (uint32_t)(k / kStages) & 1);
    } else {
      int64_t krow, vrow;
      tile_rows(k, krow, vrow);
      for (int i = tid; i < tile_elems; i += kThreads) {
        const int r = i / hd, d = i % hd;
        ks[i] = kpool[(krow + (int64_t)r * K) * hd + d];
        vs[i] = vpool[(vrow + (int64_t)r * K) * hd + d];
      }
      __syncthreads();
    }
    // the tile's tokens in range: [jlo, jhi)
    const int t0 = (u0 + k) * tile;
    const int jlo = lo - t0 > 0 ? lo - t0 : 0;
    const int jhi = hi - t0 < tile ? hi - t0 : tile;

    // 1) scores, one token per warp at a time, lanes over the head dims
    for (int j = warp; j < tile; j += kWarps) {
      float part[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) part[g] = 0.f;
      const bool in = j >= jlo && j < jhi;
      if (in && !empty) {
        const T* kr = ks + (int64_t)j * hd;
#pragma unroll
        for (int i = 0; i < kD; ++i) {
          const int d = lane + 32 * i;
          if (d < hd) {
            const float kv = to_f(kr[d]);
#pragma unroll
            for (int g = 0; g < kG; ++g) part[g] += qr[g][i] * kv;
          }
        }
#pragma unroll
        for (int g = 0; g < kG; ++g)
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
      }
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < kG; ++g)
          ps[g * tile + j] = in ? part[g] * a.scale : kNegInf;
      }
    }
    __syncthreads();
    // 2) online softmax, one warp per query row, one lane per token;
    // probabilities stored token-major for step 3
    for (int g = warp; g < kG; g += kWarps) {
      const float sc = lane < tile ? ps[g * tile + lane] : kNegInf;
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = lane >= jlo && lane < jhi ? expf(sc - m_new) : 0.f;
      if (lane < tile) pt[lane * kG + g] = p;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float al = expf(m_old - m_new);
        alpha_s[g] = al;
        l_s[g] = l_s[g] * al + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // 3) rescale and accumulate P @ V; thread d owns head dimension d
    if (tid < hd) {
#pragma unroll
      for (int g = 0; g < kG; ++g) acc[g] *= alpha_s[g];
#pragma unroll 4
      for (int j = jlo; j < jhi; ++j) {
        const float vv = to_f(vs[(int64_t)j * hd + tid]);
        float p[kG];
        if constexpr (kG % 4 == 0) {
#pragma unroll
          for (int g = 0; g < kG; g += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(pt + j * kG + g);
            p[g] = p4.x;
            p[g + 1] = p4.y;
            p[g + 2] = p4.z;
            p[g + 3] = p4.w;
          }
        } else {
#pragma unroll
          for (int g = 0; g < kG; ++g) p[g] = pt[j * kG + g];
        }
#pragma unroll
        for (int g = 0; g < kG; ++g) acc[g] += p[g] * vv;
      }
    }
    __syncthreads();
    // the stage is free again: load tile k + kStages into it
    if (kTma && tid == 0 && k + kStages < ntiles) {
      tma::fence_proxy_async();
      issue(k + kStages);
    }
  }

  if (a.splits == 1) {
    if (tid < hd) {
      T* out = static_cast<T*>(a.out) + (int64_t)bk * G * hd;
#pragma unroll
      for (int g = 0; g < kG; ++g)
        if (g < G)
          out[(int64_t)g * hd + tid] =
              from_f<T>(acc[g] / fmaxf(l_s[g], 1e-30f));
    }
    return;
  }
  const int64_t part = (int64_t)bk * a.splits + split;
  float* ml = a.ws + part * G * 2;
  float* wacc = a.ws + (int64_t)gridDim.x * G * 2 + part * G * hd;
  if (tid < G) {
    ml[2 * tid] = m_s[tid];
    ml[2 * tid + 1] = l_s[tid];
  }
  if (tid < hd) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
      if (g < G) wacc[(int64_t)g * hd + tid] = acc[g];
  }
}

// Sum (or max) of v over the block, in a fixed order; every thread gets
// the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float x = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, x) : v + x;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kWarps; ++w) v = kMax ? fmaxf(v, red[w]) : v + red[w];
  __syncthreads();
  return v;
}

constexpr int kCombineChunk = 2048;    // split weights staged at a time

// out[bk, g, d] from the splits of (bk, g).  A block takes 32 head dims.
// All its threads first read the splits' (m, l) at once and stage the
// weights exp(m_s - max m) in shared memory; then warp w sums splits
// w, w + kWarps, ... of its lane's dim, and the warps' sums are added in
// warp order: deterministic.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine(const float* __restrict__ ws, T* __restrict__ out,
                        int splits, int G, int hd) {
  __shared__ float w_s[kCombineChunk];
  __shared__ float o_s[kWarps][32];
  __shared__ float red[kWarps];
  const int bk = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int d = blockIdx.z * 32 + lane;
  const int64_t split_ml = (int64_t)G * 2, split_acc = (int64_t)G * hd;
  const float* ml = ws + ((int64_t)bk * splits * G + g) * 2;
  const float* acc = ws + (int64_t)gridDim.x * splits * G * 2 +
                     ((int64_t)bk * splits * G + g) * hd + d;
  float m = kNegInf;
#pragma unroll 4
  for (int s = tid; s < splits; s += kThreads)
    m = fmaxf(m, ml[s * split_ml]);
  m = block_reduce<true>(m, red);
  float l = 0.f, o = 0.f;
  for (int c0 = 0; c0 < splits; c0 += kCombineChunk) {
    const int n = splits - c0 < kCombineChunk ? splits - c0 : kCombineChunk;
#pragma unroll 4
    for (int i = tid; i < n; i += kThreads) {
      const float* e = ml + (c0 + i) * split_ml;
      const float w = expf(e[0] - m);
      w_s[i] = w;
      l += w * e[1];
    }
    __syncthreads();
    if (d < hd) {
#pragma unroll 8
      for (int i = warp; i < n; i += kWarps)
        o += w_s[i] * acc[(c0 + i) * split_acc];
    }
    __syncthreads();
  }
  l = block_reduce<false>(l, red);
  o_s[warp][lane] = o;
  __syncthreads();
  if (warp == 0 && d < hd) {
    for (int w = 1; w < kWarps; ++w) o += o_s[w][lane];
    out[((int64_t)bk * G + g) * hd + d] = from_f<T>(o / fmaxf(l, 1e-30f));
  }
}

template <typename T, int kG, bool kTma>
int launch_attend(const Args& a, int blocks, cudaStream_t s) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, kG, kTma>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<T>(kMaxG, kMaxHd, kMaxTile, kMaxCols));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const size_t smem = smem_bytes<T>(a.G, a.hd, a.tile, a.cols);
  paged_attention_kernel<T, kG, kTma><<<blocks, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int kG>
int launch_routes(const Args& a, int blocks, bool use_tma, cudaStream_t s) {
  return use_tma ? launch_attend<T, kG, true>(a, blocks, s)
                 : launch_attend<T, kG, false>(a, blocks, s);
}

template <typename T>
int launch(const Args& a, int B, bool use_tma, cudaStream_t s) {
  const int bks = B * a.K, blocks = bks * a.splits;
  const int err =
      a.G <= 1 ? launch_routes<T, 1>(a, blocks, use_tma, s)
      : a.G <= 2 ? launch_routes<T, 2>(a, blocks, use_tma, s)
      : a.G <= 4 ? launch_routes<T, 4>(a, blocks, use_tma, s)
      : a.G <= 8 ? launch_routes<T, 8>(a, blocks, use_tma, s)
                 : launch_routes<T, 16>(a, blocks, use_tma, s);
  if (err != 0 || a.splits == 1) return err;
  const dim3 grid(bks, a.G, (a.hd + 31) / 32);
  paged_attention_combine<T><<<grid, kThreads, 0, s>>>(
      a.ws, static_cast<T*>(a.out), a.splits, a.G, a.hd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, pools and out alike).
// splits, cols and tile come from plan.py; ws is an fp32 workspace of
// B * K * splits * G * (hd + 2) floats when splits > 1.  use_tma asks for
// the bulk-copy route, which needs 16-byte aligned pools and rows.
// starts may be null (every start 0).
int paged_attention(const void* q, const void* kpool, const void* vpool,
                    const int* kt, const int* vt, const int* lengths,
                    const int* starts, void* out, float* ws, int B, int K,
                    int G, int hd, int Tp, int P, int splits, int cols,
                    int tile, int use_tma, float scale, int dtype,
                    void* stream) {
  static const int isz[3] = {4, 2, 2};
  if (dtype < 0 || dtype > 2 || G < 1 || G > kMaxG || hd < 1 ||
      hd > kMaxHd || P < 1 || tile < 1 || tile > kMaxTile || Tp % tile ||
      cols < 1 || cols > kMaxCols || (int64_t)splits * cols < P ||
      (int64_t)(splits - 1) * cols >= P || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (use_tma && ((((uintptr_t)kpool | (uintptr_t)vpool) & 15) ||
                  (hd * isz[dtype]) & 15))
    return (int)cudaErrorInvalidValue;
  if (B * K == 0) return 0;
  Args a{q, kpool, vpool, kt, vt, lengths, starts, out, ws,
         K, G, hd, Tp, P, splits, cols, tile, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(a, B, use_tma, s);
    case 1: return launch<__nv_bfloat16>(a, B, use_tma, s);
    default: return launch<__half>(a, B, use_tma, s);
  }
}

}  // extern "C"
