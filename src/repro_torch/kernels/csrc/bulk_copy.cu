// Bulk page copies for Hopper: page_gather (and gather_assemble, which
// uses the same entry), page_gather_runs, cow_scatter (and scatter_patch)
// and cow_scatter_runs.
//
// Replaces the Pallas TPU kernels page_gather and page_gather_runs
// (src/repro/kernels/page_gather/kernel.py::page_gather, ::page_gather_runs)
// and cow_scatter and cow_scatter_runs
// (src/repro/kernels/cow_scatter/kernel.py::cow_scatter, ::cow_scatter_runs).
//
// What bounds it: bytes (each page read once and written once over the
// card's 3.35 TB/s; there is no arithmetic) and, for the small copies of
// the main path (one 128 KiB weight page, a 26-page KV column, a replay's
// 16-page 4 KiB run), the cost of getting a launch onto the card.  The
// design:
//   * the index table travels in the launch.  Up to kIdsMax ids or
//     kSpansMax spans are packed into a __grid_constant__ kernel parameter
//     (kernel parameters may take 32,764 bytes with CUDA >= 12.1, 4,096
//     before), so a call needs no allocation, no host-to-device copy and
//     no synchronisation.  Three size classes keep the parameter block of
//     a small table small.  The span tables of both run-table copies are
//     built here from the host runs (bulk_gather_runs, bulk_scatter_runs),
//     so their callers plan nothing; host ids are read from the caller's
//     bytes.  Larger tables, whose plans the caller builds in numpy
//     (page_gather/plan.py), and ids the caller already holds on the
//     device, are read from device memory by the same kernel;
//   * the body moves bytes with the Tensor Memory Accelerator's 1-D bulk
//     copies.  A persistent grid of kBlocksPerSm blocks per SM; in each
//     block one thread keeps a ring of kStages chunks of kChunk bytes in
//     flight: cp.async.bulk global -> shared completing on an mbarrier,
//     then cp.async.bulk shared -> global in a bulk group, whose reads are
//     waited for (wait_group.read) before the stage is loaded again;
//   * work is planned in bytes, not pages.  A run of contiguous frames is
//     one contiguous span on both sides; the spans are concatenated and
//     cut into equal chunks that the blocks take in grid-stride order, so
//     however skewed the runs, every block moves the same bytes.  A chunk
//     finds its first span by one binary search over the spans' cumulative
//     ends (ids: one division), not one search per page;
//   * the bytes of a span past its last multiple of 16 (the partial last
//     page of a scatter_patch or gather_assemble destination) are written
//     by the issuing thread itself.
// The PTX of the copies and barriers is in tma.cuh.
// Bulk copies need 16-byte aligned addresses and sizes.  Where the base
// pointers or the spans are not (odd row sizes, misaligned views) the entry
// points return kNotBulk and launch nothing; the caller then takes
// copy_rows (paging.cu).  Scatter destinations must be unique, as there;
// gather ids may repeat.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "tma.cuh"

namespace {

#if CUDART_VERSION >= 12010
constexpr int kParamBytes = 32764;   // kernel parameter limit, CUDA >= 12.1
#else
constexpr int kParamBytes = 4096;
#endif
constexpr int kHeadBytes = 256;      // room for the parameters besides a table
constexpr int kIdsMax = (kParamBytes - kHeadBytes) / 4 / 64 * 64;
constexpr int kSpansMax = (kParamBytes - kHeadBytes) / 24 / 64 * 64;
constexpr int kSmall = 64;
constexpr int kIdsMid = kIdsMax < 1024 ? kIdsMax : 1024;
constexpr int kSpansMid = kSpansMax < 256 ? kSpansMax : 256;

// The ring's shape.  Chunks of 8-64 KB, 2-8 stages and 1-4 blocks per SM
// all read within 1% of each other on an H100 at the main path's copies.
constexpr int kChunk = 16 << 10;     // bytes per stage
constexpr int kStages = 4;
constexpr int kBlocksPerSm = 2;
constexpr int kThreads = 32;         // lane 0 issues every copy
constexpr int kSmemBytes = kStages * kChunk + kStages * 8;
constexpr int kNotBulk = -1;

// ---- plans: which bytes go where -------------------------------------------
// A plan lays its spans end to end in a "plan space" of total() bytes.
// first(cs) is the span holding plan byte cs, and walk(i, cs, ce, f),
// from that span i, calls f(src, dst, lo, e, body, off) for each span
// piece overlapping plan bytes [cs, ce): bytes [lo, e) of the span, read
// at src + lo and written at dst + lo; bytes below `body` (the span's size
// rounded down to 16) move by bulk copy through stage offset `off`, the
// rest by the thread.

template <int N>
struct IdsValue {
  int id[N];
  __device__ __forceinline__ int at(int64_t i) const { return id[i]; }
};

struct IdsDevice {
  const int* id;
  __device__ __forceinline__ int at(int64_t i) const { return id[i]; }
};

// dst rows ids[i] <- src row i, rows of `row` bytes; destination bytes at
// or past `limit` are not written.  Plan space: the source rows, in order.
template <class Ids>
struct ScatterIds {
  const char* src;
  char* dst;
  int64_t n, row, limit;
  Ids ids;

  __host__ __device__ __forceinline__ int64_t total() const {
    return n * row;
  }
  __device__ __forceinline__ int64_t first(int64_t cs) const {
    return cs / row;
  }

  template <class F>
  __device__ __forceinline__ void walk(int64_t i, int64_t cs, int64_t ce,
                                       F&& f) const {
    for (; i < n && i * row < ce; ++i) {
      const int64_t b0 = i * row;
      const int64_t d = (int64_t)ids.at(i) * row;
      int64_t nb = limit - d;
      nb = nb < 0 ? 0 : (nb > row ? row : nb);
      const int64_t lo = (cs > b0 ? cs : b0) - b0;
      int64_t e = (ce < b0 + row ? ce : b0 + row) - b0;
      if (e > nb) e = nb;
      if (lo < e) f(src + b0, dst + d, lo, e, nb & ~int64_t(15), b0 + lo - cs);
    }
  }
};

// dst row i <- src row ids[i], rows of `row` bytes; destination bytes at
// or past `limit` are not written (a partial last page is written in the
// same pass).  Plan space: the destination bytes [0, min(n * row, limit)).
// Ids may repeat: they pick rows to read.
template <class Ids>
struct GatherIds {
  const char* src;
  char* dst;
  int64_t n, row, limit;
  Ids ids;

  __host__ __device__ __forceinline__ int64_t total() const {
    return n * row < limit ? n * row : limit;
  }
  __device__ __forceinline__ int64_t first(int64_t cs) const {
    return cs / row;
  }

  template <class F>
  __device__ __forceinline__ void walk(int64_t i, int64_t cs, int64_t ce,
                                       F&& f) const {
    for (; i < n && i * row < ce; ++i) {
      const int64_t b0 = i * row;
      const int64_t nb = limit - b0 < row ? limit - b0 : row;
      const int64_t lo = (cs > b0 ? cs : b0) - b0;
      const int64_t e = (ce < b0 + nb ? ce : b0 + nb) - b0;
      if (lo < e)
        f(src + (int64_t)ids.at(i) * row, dst + b0, lo, e,
          nb & ~int64_t(15), b0 + lo - cs);
    }
  }
};

template <int N>
struct SpansValue {
  int n;
  int64_t src[N], dst[N], end[N];
  __device__ __forceinline__ int64_t src_off(int i) const { return src[i]; }
  __device__ __forceinline__ int64_t dst_off(int i) const { return dst[i]; }
  __device__ __forceinline__ int64_t end_at(int i) const { return end[i]; }
};

struct SpansDevice {   // a (3, n) int64 table: src offsets, dst offsets, ends
  int n;
  const int64_t* t;
  __device__ __forceinline__ int64_t src_off(int i) const { return t[i]; }
  __device__ __forceinline__ int64_t dst_off(int i) const { return t[n + i]; }
  __device__ __forceinline__ int64_t end_at(int i) const {
    return t[2 * (int64_t)n + i];
  }
};

// dst[dst_off[i] + j] <- src[src_off[i] + j] for j < end[i] - end[i - 1].
// Plan space: the spans end to end (end[] is their cumulative size).
template <class Tab>
struct Spans {
  const char* src;
  char* dst;
  Tab tab;

  __device__ __forceinline__ int64_t total() const {
    return tab.end_at(tab.n - 1);
  }

  __device__ __forceinline__ int64_t first(int64_t cs) const {
    int lo = 0, hi = tab.n - 1;           // the first span ending past cs
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (tab.end_at(mid) > cs) hi = mid; else lo = mid + 1;
    }
    return lo;
  }

  template <class F>
  __device__ __forceinline__ void walk(int64_t i0, int64_t cs, int64_t ce,
                                       F&& f) const {
    for (int i = (int)i0; i < tab.n; ++i) {
      const int64_t b0 = i ? tab.end_at(i - 1) : 0, b1 = tab.end_at(i);
      if (b0 >= ce) break;
      const int64_t lo = (cs > b0 ? cs : b0) - b0;
      const int64_t e = (ce < b1 ? ce : b1) - b0;
      f(src + tab.src_off(i), dst + tab.dst_off(i), lo, e,
        (b1 - b0) & ~int64_t(15), b0 + lo - cs);
    }
  }
};

// ---- the kernel ----------------------------------------------------------------

template <class Plan>
__global__ void __launch_bounds__(kThreads)
bulk_copy(const __grid_constant__ Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  const uint32_t buf = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t bars = buf + kStages * kChunk;
  for (int s = 0; s < kStages; ++s) tma::mbar_init(bars + 8 * s, 1);
  tma::mbar_fence_init();

  const int64_t total = p.total();
  const int64_t nch = (total + kChunk - 1) / kChunk;
  const int64_t nk =
      blockIdx.x < nch ? (nch - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto chunk = [&](int64_t k, int64_t& cs, int64_t& ce) {
    cs = ((int64_t)blockIdx.x + k * gridDim.x) * kChunk;
    ce = cs + kChunk < total ? cs + kChunk : total;
  };
  int64_t first[kStages];   // each stage's first span: one search a chunk
  auto load = [&](int64_t k) {
    int64_t cs, ce;
    chunk(k, cs, ce);
    const uint32_t stage = buf + (uint32_t)(k % kStages) * kChunk;
    const uint32_t bar = bars + 8 * (uint32_t)(k % kStages);
    const int64_t i0 = first[k % kStages] = p.first(cs);
    uint32_t tx = 0;
    p.walk(i0, cs, ce, [&](const char*, char*, int64_t lo, int64_t e,
                           int64_t body, int64_t) {
      const int64_t be = e < body ? e : body;
      if (lo < be) tx += (uint32_t)(be - lo);
    });
    tma::mbar_arrive_expect_tx(bar, tx);
    p.walk(i0, cs, ce, [&](const char* s, char* d, int64_t lo, int64_t e,
                           int64_t body, int64_t off) {
      const int64_t be = e < body ? e : body;
      if (lo < be)
        tma::bulk_load(stage + (uint32_t)off, s + lo, (uint32_t)(be - lo), bar);
      for (int64_t j = lo > body ? lo : body; j < e; ++j) d[j] = s[j];
    });
  };

  for (int64_t k = 0; k < nk && k < kStages; ++k) load(k);
  for (int64_t k = 0; k < nk; ++k) {
    int64_t cs, ce;
    chunk(k, cs, ce);
    const uint32_t stage = buf + (uint32_t)(k % kStages) * kChunk;
    tma::mbar_wait(bars + 8 * (uint32_t)(k % kStages),
                   (uint32_t)(k / kStages) & 1);
    tma::fence_proxy_async();
    p.walk(first[k % kStages], cs, ce,
           [&](const char*, char* d, int64_t lo, int64_t e, int64_t body,
               int64_t off) {
      const int64_t be = e < body ? e : body;
      if (lo < be)
        tma::bulk_store(d + lo, stage + (uint32_t)off, (uint32_t)(be - lo));
    });
    tma::bulk_commit();
    // refill the stage chunk k - 1 was stored from, once that store has
    // finished reading it (chunk k's store may still be in flight)
    if (k >= 1 && k - 1 + kStages < nk) {
      tma::bulk_wait_read<1>();
      load(k - 1 + kStages);
    }
  }
  tma::bulk_wait_all();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n > 0 ? n : 1;
}

template <class Plan>
int launch(const Plan& p, int64_t total, cudaStream_t s) {
  static_assert(sizeof(Plan) <= kParamBytes, "table too large for a launch");
  if (total <= 0) return 0;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        bulk_copy<Plan>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int64_t nch = (total + kChunk - 1) / kChunk;
  const int64_t cap = (int64_t)sm_count() * kBlocksPerSm;
  const unsigned grid = (unsigned)(nch < cap ? nch : cap);
  bulk_copy<Plan><<<grid, kThreads, kSmemBytes, s>>>(p);
  return (int)cudaGetLastError();
}

// A row-id plan (ScatterIds or GatherIds) over `Ids`, its fields set.
template <template <class> class Plan, class Ids>
Plan<Ids> ids_plan(void* dst, const void* src, int64_t n, int64_t row,
                   int64_t limit) {
  Plan<Ids> p;
  p.src = static_cast<const char*>(src);
  p.dst = static_cast<char*>(dst);
  p.n = n;
  p.row = row;
  p.limit = limit;
  return p;
}

template <template <class> class Plan, int N>
int ids_by_value(void* dst, const void* src, const int* ids, int64_t n,
                 int64_t row, int64_t limit, cudaStream_t s) {
  auto p = ids_plan<Plan, IdsValue<N>>(dst, src, n, row, limit);
  memcpy(p.ids.id, ids, (size_t)n * sizeof(int));
  return launch(p, p.total(), s);
}

template <int N>
int spans_by_value(void* dst, const void* src, const int64_t* t, int n,
                   cudaStream_t s) {
  Spans<SpansValue<N>> p;
  p.src = static_cast<const char*>(src);
  p.dst = static_cast<char*>(dst);
  p.tab.n = n;
  memcpy(p.tab.src, t, (size_t)n * sizeof(int64_t));
  memcpy(p.tab.dst, t + n, (size_t)n * sizeof(int64_t));
  memcpy(p.tab.end, t + 2 * (int64_t)n, (size_t)n * sizeof(int64_t));
  return launch(p, t[3 * (int64_t)n - 1], s);
}

bool aligned(const void* a, const void* b) {
  return (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
}

// The span table of a run-table copy, built in the launch from the host
// runs (plan.py's run_spans and scatter_spans are the same plans in numpy,
// for the tables past kSpansMax that are uploaded).  Run i is one span
// between frame bytes starts[i] * row and packed bytes offs[i] * row (offs
// the exclusive cumsum of lens), lens[i] * row bytes long: a gather reads
// the frames and packs them, a scatter reads the packed payload.
// Zero-length runs are left out; destination bytes at or past `limit` are
// dropped (a span that crosses it is trimmed).  With row a multiple of 16,
// so is every offset and every size but a trimmed one.
template <int N, bool kGather>
int runs_by_value(void* dst, const void* src, const int64_t* starts,
                  const int64_t* lens, int n, int64_t row, int64_t limit,
                  cudaStream_t s) {
  Spans<SpansValue<N>> p;
  p.src = static_cast<const char*>(src);
  p.dst = static_cast<char*>(dst);
  int k = 0;
  int64_t off = 0, end = 0;
  for (int i = 0; i < n; ++i) {
    if (starts[i] < 0 || lens[i] < 0) return (int)cudaErrorInvalidValue;
    const int64_t f = starts[i] * row, o = off;
    const int64_t d = kGather ? o : f;
    int64_t nb = lens[i] * row;
    off += nb;
    if (nb > limit - d) nb = limit - d;
    if (nb <= 0) continue;
    p.tab.src[k] = kGather ? f : o;
    p.tab.dst[k] = d;
    p.tab.end[k] = end += nb;
    ++k;
  }
  p.tab.n = k;
  return launch(p, end, s);
}

// The entry of a run-table copy: up to kSpansMax host runs, their span
// table built in the launch (three size classes).
template <bool kGather>
int runs_entry(void* dst, const void* src, const int64_t* starts,
               const int64_t* lens, int n, int64_t row, int64_t limit,
               void* stream) {
  if (n <= 0 || row <= 0 || limit <= 0) return 0;
  if (!aligned(dst, src) || ((row | limit) & 15)) return kNotBulk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kSmall)
    return runs_by_value<kSmall, kGather>(dst, src, starts, lens, n, row,
                                          limit, s);
  if (n <= kSpansMid)
    return runs_by_value<kSpansMid, kGather>(dst, src, starts, lens, n, row,
                                             limit, s);
  if (n <= kSpansMax)
    return runs_by_value<kSpansMax, kGather>(dst, src, starts, lens, n, row,
                                             limit, s);
  return (int)cudaErrorInvalidValue;   // past spans_max: bulk_copy_spans
}

// The entry of a row-id plan: host ids of up to kIdsMax travel in the
// launch (three size classes), others are read from ids_dev.
template <template <class> class Plan>
int ids_entry(void* dst, const void* src, const int* ids_host,
              const int* ids_dev, int64_t n, int64_t row, int64_t limit,
              void* stream) {
  if (n <= 0 || row <= 0 || limit <= 0) return 0;
  if (!aligned(dst, src) || (row & 15)) return kNotBulk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids_host != nullptr && n <= kIdsMax) {
    if (n <= kSmall)
      return ids_by_value<Plan, kSmall>(dst, src, ids_host, n, row, limit, s);
    if (n <= kIdsMid)
      return ids_by_value<Plan, kIdsMid>(dst, src, ids_host, n, row, limit,
                                         s);
    return ids_by_value<Plan, kIdsMax>(dst, src, ids_host, n, row, limit, s);
  }
  if (ids_dev == nullptr) return (int)cudaErrorInvalidValue;
  auto p = ids_plan<Plan, IdsDevice>(dst, src, n, row, limit);
  p.ids.id = ids_dev;
  return launch(p, p.total(), s);
}

}  // namespace

extern "C" {

// The by-value capacities (ids, spans) and the parameter limit they assume.
int bulk_copy_limits(int* ids_max, int* spans_max, int* param_bytes) {
  *ids_max = kIdsMax;
  *spans_max = kSpansMax;
  *param_bytes = kParamBytes;
  return 0;
}

// dst rows ids[i] <- src row i (rows of row_bytes), in place, stopping at
// dst byte limit_bytes.  Host ids (ids_host, n <= ids_max) travel in the
// launch; otherwise the kernel reads ids_dev (device int32).  Returns
// kNotBulk, launching nothing, unless the pointers and rows are 16-byte
// multiples.
int bulk_scatter_ids(void* dst, const void* src, const int* ids_host,
                     const int* ids_dev, int64_t n, int64_t row_bytes,
                     int64_t limit_bytes, void* stream) {
  return ids_entry<ScatterIds>(dst, src, ids_host, ids_dev, n, row_bytes,
                               limit_bytes, stream);
}

// dst row i <- src row ids[i] (rows of row_bytes), writing dst bytes
// [0, min(n * row_bytes, limit_bytes)).  Ids, routes and alignment as for
// bulk_scatter_ids; ids may repeat.
int bulk_gather_ids(void* dst, const void* src, const int* ids_host,
                    const int* ids_dev, int64_t n, int64_t row_bytes,
                    int64_t limit_bytes, void* stream) {
  return ids_entry<GatherIds>(dst, src, ids_host, ids_dev, n, row_bytes,
                              limit_bytes, stream);
}

// dst[dst_off[i] + j] <- src[src_off[i] + j] for j < nbytes[i].  `spans`
// is the host (3, n) int64 table of source offsets, destination offsets
// and cumulative ends (end[i] = nbytes[0] + ... + nbytes[i]); it travels
// in the launch when n <= spans_max, and otherwise the kernel reads its
// device copy `spans_dev`.  Returns kNotBulk, launching nothing, unless the
// pointers, the offsets and every size but the last are 16-byte multiples.
int bulk_copy_spans(void* dst, const void* src, const int64_t* spans,
                    const int64_t* spans_dev, int n, void* stream) {
  if (n <= 0) return 0;
  if (!aligned(dst, src)) return kNotBulk;
  for (int i = 0; i < n; ++i) {
    const int64_t nb = spans[2 * (int64_t)n + i] -
                       (i ? spans[2 * (int64_t)n + i - 1] : 0);
    if (nb <= 0) return (int)cudaErrorInvalidValue;
    if (((spans[i] | spans[(int64_t)n + i]) & 15) || (i < n - 1 && (nb & 15)))
      return kNotBulk;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kSmall) return spans_by_value<kSmall>(dst, src, spans, n, s);
  if (n <= kSpansMid) return spans_by_value<kSpansMid>(dst, src, spans, n, s);
  if (n <= kSpansMax) return spans_by_value<kSpansMax>(dst, src, spans, n, s);
  if (spans_dev == nullptr) return (int)cudaErrorInvalidValue;
  Spans<SpansDevice> p;
  p.src = static_cast<const char*>(src);
  p.dst = static_cast<char*>(dst);
  p.tab.n = n;
  p.tab.t = spans_dev;
  return launch(p, spans[3 * (int64_t)n - 1], s);
}

// The run-table gather, out[offs[i] + j] <- frames[starts[i] + j] for
// j < lens[i] (rows of row_bytes, offs the exclusive cumsum of lens),
// writing out bytes [0, min(sum(lens) * row_bytes, limit_bytes)).  starts
// and lens are host int64 tables of n <= spans_max runs; their span table
// is built here and travels in the launch, so the call allocates nothing,
// copies nothing to the card and does not synchronise.  Returns kNotBulk,
// launching nothing, unless the pointers, the row and the limit are
// 16-byte multiples.
int bulk_gather_runs(void* dst, const void* src, const int64_t* starts,
                     const int64_t* lens, int n, int64_t row_bytes,
                     int64_t limit_bytes, void* stream) {
  return runs_entry<true>(dst, src, starts, lens, n, row_bytes, limit_bytes,
                          stream);
}

// The run-table scatter, frames[starts[i] + j] <- pages[offs[i] + j] for
// j < lens[i], stopping at frames byte limit_bytes.  Tables, routes and
// alignment as for bulk_gather_runs; runs must not overlap.
int bulk_scatter_runs(void* dst, const void* src, const int64_t* starts,
                      const int64_t* lens, int n, int64_t row_bytes,
                      int64_t limit_bytes, void* stream) {
  return runs_entry<false>(dst, src, starts, lens, n, row_bytes, limit_bytes,
                           stream);
}

}  // extern "C"
