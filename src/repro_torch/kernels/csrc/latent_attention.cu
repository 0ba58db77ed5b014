// Paged decode attention over a latent cache (multi-head latent attention,
// the MLASpec block of models/mla.py), fp32.
//
// Replaces no TPU kernel: the JAX package has no latent attention.  It is
// here because in MLA one cached row per token and layer, [c, k_pe] of
// R = kv_lora_rank + qk_rope_head_dim floats (576 for Moonlight), is the
// key of every head and, in its first dv = kv_lora_rank columns, the value
// of every head.  The query of head h comes absorbed (models/mla.py:
// absorb): R wide, scored against the whole row; the output of head h is
// the softmax-weighted sum of the rows' first dv columns (un-absorbed
// outside).  paged_attention.cu cannot take this: its K and V are separate
// rows of equal width, at most 256.
//
// For sequence b and head h, over the tokens t < lengths[b] of its paged
// cache (token t in frame pt[b, t / Tp], slot t % Tp):
//   s_t = (q[b, h] . row_t) * scale,  out[b, h] = sum_t softmax(s)_t row_t[:dv]
// in fp32, the softmax taken online with kNegInf = -1e30 and the output
// divided by max(l, 1e-30).  A sequence with no token gets zeros.
//
// What bounds it: bytes, and barely.  Per token it reads R * 4 bytes once
// for all H heads and does 2 * H * (R + dv) flops: at H = 16, R = 576,
// dv = 512 that is ~15 flops a byte, under the ~20 at which fp32 work
// outside the tensor cores, and not the memory, would bound it.  Reading
// each row once for all heads is the whole design:
//   * split across blocks (flash-decoding): each sequence is cut into
//     `splits` ranges of `cols` page-table columns (paged_attention/plan.py,
//     from the shapes alone), one block each, so that a batch of one still
//     fills the card;
//   * a block stages its q (H x R) in shared memory, then each tile of
//     `tile` tokens of one page with coalesced 16-byte loads, rows padded
//     by 4 floats so that the score loop's 16-byte reads of 8 rows hit 8
//     distinct bank groups;
//   * scores: one thread per (head, token) of the tile (16 x 16 = 256
//     threads), a dot of R over float4; the online softmax of a head runs
//     in the 16 lanes of one half-warp (shuffles);
//   * values: thread i owns value columns 2i and 2i + 1 of all H heads,
//     reading each token's H probabilities as four broadcast float4s;
//   * with splits > 1 each block writes (m, l, acc[H, dv]) to a workspace
//     the wrapper allocates, and a second kernel combines the splits in a
//     fixed order (deterministic).  A split with no token writes m = -1e30,
//     l = 0 and drops out.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxH = 16;          // heads (threads of a tile: kMaxH x 16)
constexpr int kMaxTile = 16;       // tokens per tile (plan.py: MAX_TILE)
constexpr int kMaxR = 1024;        // row width, a multiple of 4
constexpr int kMaxDv = 2 * kThreads;
constexpr int kPad = 4;            // floats after each staged row
constexpr int kMaxSplits = 4096;   // the combine's staged weights
constexpr float kNegInf = -1e30f;

struct Args {
  const float* q;        // (B, H, R)
  const float* pool;     // (F, Tp, R)
  const int* pt;         // (B, P)
  const int* lengths;    // (B,)
  float* out;            // (B, H, dv)
  float* ws;             // splits > 1: (B*splits, H, 2), then from
                         // acc_offset (B*splits, H, dv)
  int H, R, dv, Tp, P, splits, cols, tile;
  float scale;
};

// the workspace's accumulators start 16-byte aligned after the (m, l)s
__host__ __device__ __forceinline__ int64_t acc_offset(int64_t parts, int H) {
  return (parts * H * 2 + 3) & ~(int64_t)3;
}

__host__ __device__ __forceinline__ int64_t smem_bytes(int H, int R,
                                                       int tile) {
  return ((int64_t)H * R + (int64_t)tile * (R + kPad) + kMaxTile * kMaxH +
          3 * kMaxH) * 4;
}

__global__ void __launch_bounds__(kThreads, 1)
latent_attention_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, R = a.R, RS = R + kPad, r4 = R / 4, Tp = a.Tp;
  float* qs = smem;                        // [H][R]
  float* rows = qs + H * R;                // [tile][RS]
  float* pt = rows + a.tile * RS;          // [token][kMaxH] probabilities
  float* m_s = pt + kMaxTile * kMaxH;
  float* l_s = m_s + kMaxH;
  float* alpha_s = l_s + kMaxH;

  const int split = blockIdx.x % a.splits, b = blockIdx.x / a.splits;
  const int tid = threadIdx.x;
  const int h = tid >> 4, j = tid & 15;    // this thread's score: (h, j)
  const int cv = 2 * tid;                  // this thread's value columns

  int len = a.lengths[b];
  if (len > a.P * Tp) len = a.P * Tp;
  const int c0 = split * a.cols;
  const int c1 = c0 + a.cols < a.P ? c0 + a.cols : a.P;
  const int lo = c0 * Tp;
  const int hi = c1 * Tp < len ? c1 * Tp : len;
  const int ntiles = hi > lo ? (hi - lo + a.tile - 1) / a.tile : 0;

  const float4* q4 = reinterpret_cast<const float4*>(a.q + (int64_t)b * H * R);
  for (int i = tid; i < H * r4; i += kThreads)
    reinterpret_cast<float4*>(qs)[i] = q4[i];
  if (tid < kMaxH) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  float acc[kMaxH][2];
#pragma unroll
  for (int g = 0; g < kMaxH; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int k = 0; k < ntiles; ++k) {
    // a tile lies in one page: lo is a page's first slot and tile | Tp
    const int t0 = lo + k * a.tile;
    const int n = hi - t0 < a.tile ? hi - t0 : a.tile;
    const int frame = a.pt[(int64_t)b * a.P + t0 / Tp];
    const float4* src = reinterpret_cast<const float4*>(
        a.pool + ((int64_t)frame * Tp + t0 % Tp) * R);
    for (int i = tid; i < n * r4; i += kThreads) {
      const int r = i / r4, d = i - r * r4;
      reinterpret_cast<float4*>(rows + r * RS)[d] = src[(int64_t)r * r4 + d];
    }
    __syncthreads();

    // 1) the score of (h, j)
    const bool in = h < H && j < n;
    float sc = kNegInf;
    if (in) {
      const float4* qr = reinterpret_cast<const float4*>(qs + h * R);
      const float4* kr = reinterpret_cast<const float4*>(rows + j * RS);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
      for (int d = 0; d < r4; ++d) {
        const float4 x = qr[d], y = kr[d];
        s0 += x.x * y.x;
        s1 += x.y * y.y;
        s2 += x.z * y.z;
        s3 += x.w * y.w;
      }
      sc = ((s0 + s1) + (s2 + s3)) * a.scale;
    }
    // 2) online softmax of head h in its half-warp
    float mx = sc;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_old = m_s[h];
    const float m_new = fmaxf(m_old, mx);
    const float p = in ? expf(sc - m_new) : 0.f;
    pt[j * kMaxH + h] = p;
    float sum = p;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    __syncwarp();
    if (j == 0) {
      const float al = expf(m_old - m_new);
      alpha_s[h] = al;
      l_s[h] = l_s[h] * al + sum;
      m_s[h] = m_new;
    }
    __syncthreads();

    // 3) rescale and accumulate the value columns cv, cv + 1
    if (cv < a.dv) {
#pragma unroll
      for (int g = 0; g < kMaxH; ++g) {
        acc[g][0] *= alpha_s[g];
        acc[g][1] *= alpha_s[g];
      }
      for (int r = 0; r < n; ++r) {
        const float2 v = *reinterpret_cast<const float2*>(rows + r * RS + cv);
        const float4* pr = reinterpret_cast<const float4*>(pt + r * kMaxH);
#pragma unroll
        for (int g4 = 0; g4 < kMaxH / 4; ++g4) {
          const float4 w = pr[g4];
          acc[4 * g4][0] += w.x * v.x;
          acc[4 * g4][1] += w.x * v.y;
          acc[4 * g4 + 1][0] += w.y * v.x;
          acc[4 * g4 + 1][1] += w.y * v.y;
          acc[4 * g4 + 2][0] += w.z * v.x;
          acc[4 * g4 + 2][1] += w.z * v.y;
          acc[4 * g4 + 3][0] += w.w * v.x;
          acc[4 * g4 + 3][1] += w.w * v.y;
        }
      }
    }
    __syncthreads();
  }

  if (a.splits == 1) {
    if (cv < a.dv) {
      float* out = a.out + (int64_t)b * H * a.dv + cv;
#pragma unroll
      for (int g = 0; g < kMaxH; ++g) {
        if (g < H) {
          const float l = fmaxf(l_s[g], 1e-30f);
          out[(int64_t)g * a.dv] = acc[g][0] / l;
          out[(int64_t)g * a.dv + 1] = acc[g][1] / l;
        }
      }
    }
    return;
  }
  const int64_t part = (int64_t)b * a.splits + split;
  float* ml = a.ws + part * H * 2;
  float* wacc = a.ws + acc_offset(gridDim.x, H) + part * H * a.dv + cv;
  if (tid < H) {
    ml[2 * tid] = m_s[tid];
    ml[2 * tid + 1] = l_s[tid];
  }
  if (cv < a.dv) {
#pragma unroll
    for (int g = 0; g < kMaxH; ++g) {
      if (g < H) {
        wacc[(int64_t)g * a.dv] = acc[g][0];
        wacc[(int64_t)g * a.dv + 1] = acc[g][1];
      }
    }
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
  for (int w = 1; w < kThreads / 32; ++w)
    v = kMax ? fmaxf(v, red[w]) : v + red[w];
  __syncthreads();
  return v;
}

// out[b, h, c0 : c0 + 128] from the splits of (b, h): a block per (b, h)
// and 128 value columns.  Its threads first read the splits' (m, l) at
// once and stage the weights exp(m_s - max m) in shared memory; then warp
// w sums splits w, w + 8, ... of its lane's four columns (16-byte loads),
// and the warps' sums are added in warp order: deterministic.
__global__ void __launch_bounds__(kThreads)
latent_attention_combine(const float* __restrict__ ws, float* __restrict__ out,
                         int splits, int H, int dv) {
  __shared__ float w_s[kMaxSplits];
  __shared__ float4 part[kThreads / 32][32];
  __shared__ float red[kThreads / 32];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t parts = (int64_t)gridDim.x / H * splits;
  const float* ml = ws + ((int64_t)b * splits * H + h) * 2;
  const float* acc = ws + acc_offset(parts, H) +
                     ((int64_t)b * splits * H + h) * dv;
  float m = kNegInf;
  for (int s = tid; s < splits; s += kThreads)
    m = fmaxf(m, ml[(int64_t)s * H * 2]);
  m = block_reduce<true>(m, red);
  float l = 0.f;
  for (int s = tid; s < splits; s += kThreads) {
    const float* e = ml + (int64_t)s * H * 2;
    const float w = expf(e[0] - m);
    w_s[s] = w;
    l += w * e[1];
  }
  l = block_reduce<false>(l, red);      // its barrier publishes w_s
  const int c = blockIdx.y * 128 + 4 * lane;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < dv) {
#pragma unroll 4
    for (int s = warp; s < splits; s += kThreads / 32) {
      const float4 a =
          *reinterpret_cast<const float4*>(acc + (int64_t)s * H * dv + c);
      const float w = w_s[s];
      o.x += w * a.x;
      o.y += w * a.y;
      o.z += w * a.z;
      o.w += w * a.w;
    }
  }
  part[warp][lane] = o;
  __syncthreads();
  if (warp == 0 && c < dv) {
    for (int w = 1; w < kThreads / 32; ++w) {
      o.x += part[w][lane].x;
      o.y += part[w][lane].y;
      o.z += part[w][lane].z;
      o.w += part[w][lane].w;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    *reinterpret_cast<float4*>(out + (int64_t)bh * dv + c) =
        make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
  }
}

}  // namespace

extern "C" {

// q (B, H, R), pool (F, Tp, R), out (B, H, dv): float32, 16-byte aligned;
// pt (B, P) and lengths (B,) int32.  splits, cols and tile come from
// paged_attention/plan.py; ws holds B * splits * H * (dv + 2) + 4 floats,
// 16-byte aligned, when splits > 1.
int latent_attention(const float* q, const float* pool, const int* pt,
                     const int* lengths, float* out, float* ws, int B, int H,
                     int R, int dv, int Tp, int P, int splits, int cols,
                     int tile, float scale, void* stream) {
  if (H < 1 || H > kMaxH || R < 4 || R > kMaxR || R % 4 || dv < 4 ||
      dv % 4 || dv > R || dv > kMaxDv || tile < 1 || tile > kMaxTile ||
      Tp % tile || P < 1 || cols < 1 || (int64_t)splits * cols < P ||
      (int64_t)(splits - 1) * cols >= P || splits > kMaxSplits ||
      (splits > 1 && (ws == nullptr || ((uintptr_t)ws & 15))) ||
      (((uintptr_t)q | (uintptr_t)pool | (uintptr_t)out) & 15))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        latent_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxH, kMaxR, kMaxTile));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  Args a{q, pool, pt, lengths, out, ws, H, R, dv, Tp, P, splits, cols, tile,
         scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  latent_attention_kernel<<<B * splits, kThreads, smem_bytes(H, R, tile), s>>>(
      a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  latent_attention_combine<<<dim3(B * H, (dv + 127) / 128), kThreads, 0, s>>>(
      ws, out, splits, H, dv);
  return (int)cudaGetLastError();
}

}  // extern "C"
