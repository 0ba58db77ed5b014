// The routed experts of a mixture-of-experts layer (models/moe.py: _moe),
// fp32: each (token, expert) row the router chose, computed once.
//
// Replaces no TPU kernel: the JAX package's MoE is jnp code, an (E, C, D)
// dispatch buffer multiplied against every expert.  Where no token can drop
// (the capacity is at least the call's tokens) that buffer is mostly
// padding: at batch 1 a Mixtral layer reads all 8 experts' weights, 5.6 GB,
// for the 2 its token chose.  Here only the chosen experts are read, and
// only the routed rows computed.
//
// Input: h (TK, D), the T*K routed rows sorted by expert (a stable sort of
// the router's choices), counts (E,) and starts (E,) int64, each expert's
// rows; weights wi, wg (E, D, F) and wd (E, F, D), row-major.  Output
// y (TK, D) in h's order; for row r of expert e:
//   y[r] = (silu(h[r] wg[e]) * (h[r] wi[e])) wd[e]      (gated)
//   y[r] = gelu_tanh(h[r] wi[e]) wd[e]                   (wg null)
// in fp32 FMA throughout (no tensor cores: TF32 would change the numbers).
//
// What bounds it: at decode (a few rows) the chosen experts' weight bytes,
// 3 D F floats each, read once for all their rows, at 3.35 TB/s; in prefill
// (hundreds of rows an expert) the routed flops, 6 TK D F, at 67 TFLOP/s.
// The design:
//   * a tile map built on the card (tile_map): tile i -> (expert, first row,
//     rows), at most ceil(TK / bm) + min(E, TK) tiles, the grid's bound from
//     host ints; a block past the real tiles exits.  Nothing is read back to
//     the host, so a CUDA graph captures the whole call as it is;
//   * an up pass over the columns [wi | wg] (2F wide; F without wg), an
//     elementwise pass that sums its partials and applies the activation,
//     the down pass against wd, and, where that was split, a pass summing
//     its partials.  Partials are summed in a fixed order and no atomics are
//     used, so two runs give the same bits;
//   * "gemv" tiles (the wrapper's plan: T*K <= 128 E, decode and prefills
//     of up to ~128 rows an expert): up to 8 rows; a thread streams a
//     4-column strip of its expert's weights with 16-byte loads, 8 in
//     flight, against the tile's rows staged in shared memory k-major (two
//     broadcast float4s a step).  The reduction is split over blocks until
//     the grid holds ~8 blocks an SM: the down pass of one Mixtral token has
//     only 2 experts x 8 column strips.  An expert's tiles of one strip are
//     neighbours in the grid, so they read its weights through L2 together;
//   * "tiled" tiles (longer prefills): a SIMT GEMM tile of 64 rows x 128
//     columns, 8-deep slabs double-buffered through registers into shared
//     memory, each of 128 threads computing 8 x 8 outputs, 4 blocks an SM;
//     the reduction split (at most 4) where the grid would hold under 8
//     waves.  A warp whose 16 rows lie past its tile's skips the products.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMapThreads = 256;
constexpr int kGemvThreads = 128;
constexpr int kGemvRows = 8;                    // moe_experts.py: GEMV_ROWS
constexpr int kGemvCols = 4 * kGemvThreads;     // moe_experts.py: GEMV_COLS
constexpr int kUnroll = 8;                      // moe_experts.py: UNROLL
constexpr int kTileRows = 64;                   // moe_experts.py: TILE_ROWS
constexpr int kTiledThreads = 2 * kTileRows;    // 16 x 8 threads, 8 x 8 each
constexpr int kTiledBlocks = 4;                 // an SM's: 128 registers
constexpr int kBN = 128;                        // moe_experts.py: TILED_COLS
constexpr int kBK = 8;                          // moe_experts.py: SLAB
constexpr int kEwThreads = 256;

// One pass: out (splits, TK, N) = x (TK, K) times the columns [w0 | w1] of
// each row's expert; w0 (E, K, n0), w1 (E, K, N - n0) or null (N == n0).
struct Pass {
  const float* x;
  const float* w0;
  const float* w1;
  float* out;
  const int4* map;
  int TK, K, N, n0, kchunk;
};

// The first weight of column c of expert e, and its row stride.
__device__ __forceinline__ const float* column(const Pass& p, int e, int c,
                                               int& ld) {
  if (c < p.n0) {
    ld = p.n0;
    return p.w0 + (int64_t)e * p.K * p.n0 + c;
  }
  ld = p.N - p.n0;
  return p.w1 + (int64_t)e * p.K * ld + (c - p.n0);
}

__global__ void __launch_bounds__(kMapThreads)
tile_map(const int64_t* __restrict__ counts,
         const int64_t* __restrict__ starts, int E, int bm, int tiles,
         int4* __restrict__ map) {
  extern __shared__ int first[];                 // E + 1 tile offsets
  for (int e = threadIdx.x; e < E; e += kMapThreads)
    first[e + 1] = (int)((counts[e] + bm - 1) / bm);
  __syncthreads();
  if (threadIdx.x == 0) {
    first[0] = 0;
    for (int e = 0; e < E; ++e) first[e + 1] += first[e];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += kMapThreads) {
    const int s = (int)starts[e], n = (int)counts[e];
    for (int i = first[e], r = 0; i < first[e + 1] && i < tiles;
         ++i, r += bm)
      map[i] = make_int4(e, s + r, n - r < bm ? n - r : bm, 0);
  }
  for (int i = first[E] + threadIdx.x; i < tiles; i += kMapThreads)
    map[i] = make_int4(0, 0, 0, 0);
}

__device__ __forceinline__ void fma_rows(float (&acc)[kGemvRows][4],
                                         const float4 w, const float* xk) {
  const float4 a = *reinterpret_cast<const float4*>(xk);
  const float4 b = *reinterpret_cast<const float4*>(xk + 4);
  const float xr[kGemvRows] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r) {
    acc[r][0] = fmaf(xr[r], w.x, acc[r][0]);
    acc[r][1] = fmaf(xr[r], w.y, acc[r][1]);
    acc[r][2] = fmaf(xr[r], w.z, acc[r][2]);
    acc[r][3] = fmaf(xr[r], w.w, acc[r][3]);
  }
}

// grid (tiles, ceil(N / kGemvCols), splits): split z sums k in
// [z kchunk, (z + 1) kchunk) into out[z].
__global__ void __launch_bounds__(kGemvThreads)
gemv_pass(const __grid_constant__ Pass p) {
  extern __shared__ __align__(16) float xs[];    // [kchunk][kGemvRows]
  const int4 t = p.map[blockIdx.x];
  if (t.z == 0) return;
  const int k0 = blockIdx.z * p.kchunk;
  const int len = p.K - k0 < p.kchunk ? p.K - k0 : p.kchunk;
  for (int i = threadIdx.x; i < kGemvRows * len; i += kGemvThreads) {
    const int r = i / len, k = i - r * len;
    xs[k * kGemvRows + r] =
        r < t.z ? p.x[(int64_t)(t.y + r) * p.K + k0 + k] : 0.f;
  }
  __syncthreads();
  const int c = (blockIdx.y * kGemvThreads + threadIdx.x) * 4;
  if (c >= p.N) return;
  int ld;
  const float* w = column(p, t.x, c, ld);
  w += (int64_t)k0 * ld;
  float acc[kGemvRows][4] = {};
  int k = 0;
  for (; k + kUnroll <= len; k += kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = __ldg(reinterpret_cast<const float4*>(w + (int64_t)(k + u) * ld));
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      fma_rows(acc, v[u], xs + (k + u) * kGemvRows);
  }
  for (; k < len; ++k)
    fma_rows(acc, __ldg(reinterpret_cast<const float4*>(w + (int64_t)k * ld)),
             xs + k * kGemvRows);
  float* o = p.out + ((int64_t)blockIdx.z * p.TK + t.y) * p.N + c;
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r)
    if (r < t.z)
      *reinterpret_cast<float4*>(o + (int64_t)r * p.N) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// grid (tiles, ceil(N / kBN), splits): split z sums k in [z kchunk,
// (z + 1) kchunk) of the tile's rows into out[z], 128 columns; each thread
// 8 rows x 8 columns.  A warp holds 16 rows of the tile; one whose rows all
// lie past the tile's (an expert's last tile, mostly padding) only loads,
// and leaves the FMA pipes to the warps that have rows.
__global__ void __launch_bounds__(kTiledThreads, kTiledBlocks)
tiled_pass(const __grid_constant__ Pass p) {
  constexpr int BM = kTileRows, TM = 8;
  constexpr int kA = BM * kBK / 4;             // float4s of an A slab
  constexpr int kAPer = (kA + kTiledThreads - 1) / kTiledThreads;
  constexpr int kBPer = kBK * kBN / 4 / kTiledThreads;
  __shared__ __align__(16) float As[2][kBK][BM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  const int4 t = p.map[blockIdx.x];
  if (t.z == 0) return;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const bool busy = (tid >> 5) * 2 * TM < t.z;
  const int nb = blockIdx.y * kBN;
  const int k0 = blockIdx.z * p.kchunk;
  const int kend = p.K - k0 < p.kchunk ? p.K : k0 + p.kchunk;
  // this thread's share of each slab: float4s of A along k, of B along n
  const int b_k = tid >> 5, b_col = (tid & 31) * 4;
  const bool b_ok = nb + b_col < p.N;
  int ldb = 0;
  const float* b_src = b_ok ? column(p, t.x, nb + b_col, ldb) : p.w0;
  b_src += (int64_t)b_k * ldb;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ra[kAPer], rb[kBPer];
  auto load = [&](int ks) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int idx = tid + i * kTiledThreads;
      const int row = idx / (kBK / 4), k = ks + idx % (kBK / 4) * 4;
      ra[i] = idx < kA && row < t.z && k < kend
                  ? *reinterpret_cast<const float4*>(
                        p.x + (int64_t)(t.y + row) * p.K + k)
                  : zero;
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int k = ks + b_k + i * (kTiledThreads / 32);
      rb[i] = b_ok && k < kend
                  ? __ldg(reinterpret_cast<const float4*>(
                        b_src + (int64_t)(ks + i * (kTiledThreads / 32)) *
                                    ldb))
                  : zero;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int idx = tid + i * kTiledThreads;
      if (idx >= kA) break;
      const int row = idx / (kBK / 4), k = idx % (kBK / 4) * 4;
      As[buf][k + 0][row] = ra[i].x;
      As[buf][k + 1][row] = ra[i].y;
      As[buf][k + 2][row] = ra[i].z;
      As[buf][k + 3][row] = ra[i].w;
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i)
      *reinterpret_cast<float4*>(
          &Bs[buf][b_k + i * (kTiledThreads / 32)][b_col]) = rb[i];
  };
  float acc[TM][8] = {};
  const int nk = (kend - k0 + kBK - 1) / kBK;
  load(k0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load(k0 + (kt + 1) * kBK);
    if (busy) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[TM], b[8];
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(&As[buf][kk][ty * TM + i]);
          a[i] = v.x;
          a[i + 1] = v.y;
          a[i + 2] = v.z;
          a[i + 3] = v.w;
        }
        const float4 b0 =
            *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = ty * TM + i;
    if (row >= t.z) continue;
    float* o = p.out + ((int64_t)blockIdx.z * p.TK + t.y + row) * p.N + nb;
    if (nb + tx * 4 < p.N)
      *reinterpret_cast<float4*>(o + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (nb + 64 + tx * 4 < p.N)
      *reinterpret_cast<float4*>(o + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

__device__ __forceinline__ float4 add4(float4 a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
  return a;
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// PyTorch's gelu(approximate="tanh"), jax.nn.gelu's default
__device__ __forceinline__ float gelu(float x) {
  const float kBeta = 0.7978845608028654f;      // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(kBeta * (x + 0.044715f * x * x * x)));
}

// act (TK, F) = the activation of the up pass's summed partials
// part (splits, TK, N): silu(columns F..2F) * columns 0..F where gated
// (N == 2F), else gelu(columns 0..F).
__global__ void __launch_bounds__(kEwThreads)
act_pass(const float* __restrict__ part, int splits, int TK, int N, int F,
         float* __restrict__ act) {
  const int f4 = F / 4;
  const int64_t n = (int64_t)TK * f4, plane = (int64_t)TK * N;
  for (int64_t i = blockIdx.x * (int64_t)kEwThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kEwThreads) {
    const int64_t row = i / f4;
    const int c = (int)(i - row * f4) * 4;
    const float* src = part + row * N + c;
    float4 a = *reinterpret_cast<const float4*>(src);
    for (int s = 1; s < splits; ++s)
      a = add4(a, *reinterpret_cast<const float4*>(src + s * plane));
    if (N == 2 * F) {
      float4 g = *reinterpret_cast<const float4*>(src + F);
      for (int s = 1; s < splits; ++s)
        g = add4(g, *reinterpret_cast<const float4*>(src + F + s * plane));
      a = make_float4(silu(g.x) * a.x, silu(g.y) * a.y, silu(g.z) * a.z,
                      silu(g.w) * a.w);
    } else {
      a = make_float4(gelu(a.x), gelu(a.y), gelu(a.z), gelu(a.w));
    }
    *reinterpret_cast<float4*>(act + row * F + c) = a;
  }
}

// out (n4 float4s) = the sum of part's splits planes, in order
__global__ void __launch_bounds__(kEwThreads)
sum_pass(const float4* __restrict__ part, int splits, int64_t n4,
         float4* __restrict__ out) {
  for (int64_t i = blockIdx.x * (int64_t)kEwThreads + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * kEwThreads) {
    float4 a = part[i];
    for (int s = 1; s < splits; ++s) a = add4(a, part[s * n4 + i]);
    out[i] = a;
  }
}

int ew_blocks(int64_t n) {
  const int64_t b = (n + kEwThreads - 1) / kEwThreads;
  return (int)(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

cudaError_t run_pass(const Pass& p, int tiled, int tiles, int splits,
                     cudaStream_t s) {
  if (!tiled) {
    const dim3 grid(tiles, (p.N + kGemvCols - 1) / kGemvCols, splits);
    gemv_pass<<<grid, kGemvThreads, p.kchunk * kGemvRows * sizeof(float), s>>>(
        p);
  } else {
    tiled_pass<<<dim3(tiles, (p.N + kBN - 1) / kBN, splits), kTiledThreads, 0,
                 s>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// The whole call on `stream`, no sync.  ws: the wrapper's workspace of
// moe_experts.py:Plan.ws_floats floats, laid out as the tile map (tiles
// int4s), the up pass's partials (up_splits, TK, N_up), the activations
// (TK, F) and, where dn_splits > 1, the down pass's partials
// (dn_splits, TK, D).  Returns the first launch error, or 0.
extern "C" int moe_experts(const float* h, const int64_t* counts,
                           const int64_t* starts, const float* wi,
                           const float* wg, const float* wd, float* y,
                           float* ws, int TK, int E, int D, int F, int tiled,
                           int bm, int tiles, int up_chunk, int up_splits,
                           int dn_chunk, int dn_splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_up = wg ? 2 * F : F;
  int4* map = reinterpret_cast<int4*>(ws);
  float* up = ws + 4 * (int64_t)tiles;
  float* act = up + (int64_t)up_splits * TK * n_up;
  float* dn = act + (int64_t)TK * F;
  tile_map<<<1, kMapThreads, (E + 1) * sizeof(int), s>>>(counts, starts, E,
                                                        bm, tiles, map);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = run_pass(Pass{h, wi, wg, up, map, TK, D, n_up, F, up_chunk}, tiled,
                 tiles, up_splits, s);
  if (err != cudaSuccess) return (int)err;
  act_pass<<<ew_blocks((int64_t)TK * F / 4), kEwThreads, 0, s>>>(
      up, up_splits, TK, n_up, F, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = run_pass(Pass{act, wd, nullptr, dn_splits > 1 ? dn : y, map, TK, F,
                      D, D, dn_chunk},
                 tiled, tiles, dn_splits, s);
  if (err != cudaSuccess || dn_splits == 1) return (int)err;
  const int64_t n4 = (int64_t)TK * D / 4;
  sum_pass<<<ew_blocks(n4), kEwThreads, 0, s>>>(
      reinterpret_cast<const float4*>(dn), dn_splits, n4,
      reinterpret_cast<float4*>(y));
  return (int)cudaGetLastError();
}
