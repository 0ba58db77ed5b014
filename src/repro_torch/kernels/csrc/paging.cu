// Page copies of the fork path's data plane: page_gather, page_gather_runs,
// cow_scatter and cow_scatter_runs.
//
// Replaces the Pallas TPU kernels page_gather / page_gather_runs
// (src/repro/kernels/page_gather/kernel.py) and cow_scatter /
// cow_scatter_runs (src/repro/kernels/cow_scatter/kernel.py).
//
// What bounds it: bytes.  Each copied page is read once and written once,
// 2 * n * E * itemsize bytes over the card's 3.35 TB/s; there is no
// arithmetic.  The design keeps every memory transaction wide and
// coalesced and leaves no block idle:
//   * all four entry points run one kernel, copy_rows: a page is a row of
//     `row_units` units of U bytes, U the widest of 16/8/4/2/1 bytes that
//     divides the row, the limit and every base address, so fp32 and bf16
//     pages move as 16-byte vectors;
//   * blockIdx.y walks rows, blockIdx.x and the threads walk the units of
//     a row, so neighbouring threads touch neighbouring addresses;
//   * per-id forms read the row's frame from `map`; run forms find the
//     row's run by a binary search over `offs` (exclusive cumsum of the
//     run lengths), so every block does the same amount of work however
//     skewed the runs are (the TPU grid of (runs, max_len) idled on short
//     runs);
//   * `limit_units` caps the destination's flat index: a gather lands
//     straight in a tensor whose last page is trimmed, a scatter patches
//     a tensor whose last page is partial, with no (n, E) intermediate.
// Gathers allow duplicate ids; scatters require unique destination rows
// (fresh frames from the allocator), so no two threads write one address.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct alignas(16) U16 { uint4 v; };
struct alignas(8) U8 { uint2 v; };

// row of the "mapped" side (source for gathers, destination for scatters)
template <bool RUNS>
__device__ __forceinline__ int64_t mapped_row(const int* __restrict__ map,
                                              const int* __restrict__ offs,
                                              int nmap, int64_t row) {
  if (!RUNS) return map[row];
  // largest i with offs[i] <= row; offs[0] == 0
  int lo = 0, hi = nmap - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (offs[mid] <= row) lo = mid; else hi = mid - 1;
  }
  return (int64_t)map[lo] + (row - offs[lo]);
}

template <typename U, bool RUNS, bool SCATTER>
__global__ void copy_rows(const U* __restrict__ src, U* __restrict__ dst,
                          const int* __restrict__ map,
                          const int* __restrict__ offs, int nmap,
                          int64_t n_rows, int64_t row_units,
                          int64_t limit_units) {
  for (int64_t row = blockIdx.y; row < n_rows; row += gridDim.y) {
    int64_t m = mapped_row<RUNS>(map, offs, nmap, row);
    int64_t s = (SCATTER ? row : m) * row_units;
    int64_t d = (SCATTER ? m : row) * row_units;
    int64_t n = row_units;
    if (d + n > limit_units) n = limit_units - d;
    for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < n;
         c += (int64_t)gridDim.x * blockDim.x) {
      dst[d + c] = src[s + c];
    }
  }
}

constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 4;

template <typename U, bool RUNS, bool SCATTER>
cudaError_t launch(const void* src, void* dst, const int* map,
                   const int* offs, int nmap, int64_t n_rows,
                   int64_t row_units, int64_t limit_units,
                   cudaStream_t stream) {
  int64_t bx = (row_units + kThreads * kUnitsPerThread - 1) /
               (kThreads * kUnitsPerThread);
  if (bx < 1) bx = 1;
  int64_t by = n_rows < 65535 ? n_rows : 65535;
  dim3 grid((unsigned)bx, (unsigned)by);
  copy_rows<U, RUNS, SCATTER><<<grid, kThreads, 0, stream>>>(
      static_cast<const U*>(src), static_cast<U*>(dst), map, offs, nmap,
      n_rows, row_units, limit_units);
  return cudaGetLastError();
}

template <bool RUNS, bool SCATTER>
int dispatch(const void* src, void* dst, const int* map, const int* offs,
             int nmap, int64_t n_rows, int64_t row_bytes,
             int64_t limit_bytes, int unit, void* stream) {
  if (n_rows <= 0 || row_bytes <= 0 || limit_bytes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t ru = row_bytes / unit, lu = limit_bytes / unit;
  switch (unit) {
    case 16: return launch<U16, RUNS, SCATTER>(src, dst, map, offs, nmap,
                                               n_rows, ru, lu, s);
    case 8: return launch<U8, RUNS, SCATTER>(src, dst, map, offs, nmap,
                                             n_rows, ru, lu, s);
    case 4: return launch<uint32_t, RUNS, SCATTER>(src, dst, map, offs, nmap,
                                                   n_rows, ru, lu, s);
    case 2: return launch<uint16_t, RUNS, SCATTER>(src, dst, map, offs, nmap,
                                                   n_rows, ru, lu, s);
    case 1: return launch<uint8_t, RUNS, SCATTER>(src, dst, map, offs, nmap,
                                                  n_rows, ru, lu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out[i] = frames[ids[i]] for i < n; stops at out flat byte `limit_bytes`.
int page_gather(const void* frames, const int* ids, void* out, int64_t n,
                int64_t row_bytes, int64_t limit_bytes, int unit,
                void* stream) {
  return dispatch<false, false>(frames, out, ids, nullptr, (int)n, n,
                                row_bytes, limit_bytes, unit, stream);
}

// out[offs[i] + j] = frames[starts[i] + j] for j < lens[i]; n_out = sum lens.
int page_gather_runs(const void* frames, const int* starts, const int* offs,
                     int nruns, void* out, int64_t n_out, int64_t row_bytes,
                     int64_t limit_bytes, int unit, void* stream) {
  return dispatch<true, false>(frames, out, starts, offs, nruns, n_out,
                               row_bytes, limit_bytes, unit, stream);
}

// frames[ids[i]] = pages[i] in place; stops at frames flat byte `limit_bytes`.
int cow_scatter(void* frames, const int* ids, const void* pages, int64_t n,
                int64_t row_bytes, int64_t limit_bytes, int unit,
                void* stream) {
  return dispatch<false, true>(pages, frames, ids, nullptr, (int)n, n,
                               row_bytes, limit_bytes, unit, stream);
}

// frames[starts[i] + j] = pages[offs[i] + j] in place for j < lens[i].
int cow_scatter_runs(void* frames, const int* starts, const int* offs,
                     int nruns, const void* pages, int64_t n_pages,
                     int64_t row_bytes, int64_t limit_bytes, int unit,
                     void* stream) {
  return dispatch<true, true>(pages, frames, starts, offs, nruns, n_pages,
                              row_bytes, limit_bytes, unit, stream);
}

}  // extern "C"
