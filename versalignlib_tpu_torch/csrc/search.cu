// One-vs-many best-score kernel: K query sequences (or position-specific
// profiles) against a pool of R sequences, Smith-Waterman or the
// reference's semi-global "Needleman-Wunsch", linear or affine (Gotoh) gaps,
// int32 cells, and for SW optionally each pair's argmax cell.
//
// Replaces versalignlib_tpu/ops/pallas_search.py::_search_kernel (the TPU's
// one-vs-many kernel: one query broadcast from SMEM against 1024
// lane-resident pool sequences), all branches. Semantics are the JAX
// kernel's:
// - DP rows are always the read (m) and columns always the ref (n); only
//   where the codes come from changes (pallas_search.py:57-60). With
//   query_is_read the K queries are reads and the pool holds refs; otherwise
//   the queries are refs and the pool holds reads;
// - the recurrence and the SW seed at 0 are score.cu's; NW is the score
//   path's overlap score: the maximum over the last column of every row and
//   over the whole final row, clamped at 0, with column -1 and row -1 at 0
//   (not the pointer fills' (i + 1) * gap_ref boundary);
// - with_coords (SW only): (end_row, end_col) by the row-major strict
//   first-win rule, (0, 0) where the best is 0 (pallas_search.py:183-245).
//
// What bounds it on an H100: integer operations (chip_smoke.ops_per_cell).
// The design keeps everything but the inputs and outputs on the chip:
// - a group of 16 lanes per (query, pool sequence) pair, 8 pairs a block of
//   four warps, all of one query (blockIdx.y walks the queries, blockIdx.x
//   the pool in blocks of 8), whose codes, S x S matrix or PSSM are copied
//   to shared memory once per block;
// - the step loop is stripe.cuh's group_best, which this kernel shares with
//   score.cu: lane l owns kCols consecutive ref columns (32 or 40, the
//   wrapper's choice per launch, ops/cuda_search.search_cols) and at step t
//   computes read row t - l of them, the H (and F) values in its registers,
//   H (and E) from lane l - 1 by one shuffle, cells through DPX; the
//   pair's boundary column between stripes is m int32 (2m affine) in shared
//   memory, or in device memory where a block's eight would not fit. The
//   integer ALU pipe sets the time: about 3.9 of a DNA linear SW cell's 5.5
//   instructions go to it (PERF.md, B4);
// - the pool is pair-major (R, len) uint8, each lane's column codes loaded
//   once a stripe, the read code once a step (from shared memory where the
//   queries are the reads, else from the pool);
// - substitution: DNA scores that fit a signed byte through byte tables and
//   one prmt a cell; an S x S matrix (or DNA scores past a byte, as their
//   6 x 6 matrix) or a PSSM one lookup a cell (kSub 1: in shared memory;
//   kSub 2: past 227 KB, through the read-only cache); codes >= S read as 0;
// - with coordinates the wrapper checks that the argmax keys (value << 5 or
//   6 | column) cannot overflow.

#include <cstdint>
#include <cuda_runtime.h>

#include "stripe.cuh"

namespace {

using val::kGroup;
using val::kPairs;
using val::kThreads;
using val::kMaxSmemBytes;
constexpr int kMaxGridY = 65535;

struct SearchArgs {
  const uint8_t *pool;   // (r, plen) codes: refs (query_is_read) or reads
  const uint8_t *query;  // (k, qlen) codes; null for PSSMs
  const int32_t *table;  // (s, s) matrix [read][ref], or (k, m, s) PSSMs;
                         // null for the DNA byte tables
  const uint2 *bytes;    // (8,) DNA byte tables (kSub 0)
  int32_t *edge;         // boundary columns in device memory, or null
  int32_t *out;          // (k, r) best score per pair
  int32_t *end_row;      // (k, r) SW argmax row (coords only)
  int32_t *end_col;      // (k, r) SW argmax column (coords only)
  int k, r, m, n, s, k0;
  int query_is_read, pssm;
  int gap_read, gap_ref, open_read, open_ref;
};

template <bool kLocal, bool kAffine, bool kCoords, int kSub, int kCols>
__global__ void __launch_bounds__(kThreads) search_kernel(SearchArgs a) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ uint2 bytes[8];
  constexpr int kEdge = kAffine ? 2 : 1;
  constexpr int kStripe = kGroup * kCols;
  const int k = a.k0 + blockIdx.y;
  const int m = a.m, n = a.n, s = a.s;
  const int stripes = (n + kStripe - 1) / kStripe;
  // Shared memory: the table (kSub 1), the boundary columns, the query's
  // codes.
  const int tab_words = kSub == 1 ? (a.pssm ? m * s : s * s) : 0;
  const bool edge_shared = a.edge == nullptr && stripes > 1;
  int32_t *edge_s = smem + tab_words;
  uint8_t *codes_s = reinterpret_cast<uint8_t *>(edge_s + (edge_shared ? kPairs * m * kEdge : 0));
  const int qlen = a.query_is_read ? m : n;
  const int32_t *tab = a.table;
  if (kSub != 0 && a.pssm) tab += (size_t)k * m * s;
  if (kSub == 1) {
    for (int t = threadIdx.x; t < tab_words; t += kThreads) smem[t] = tab[t];
    tab = smem;
  }
  if (kSub == 0 && threadIdx.x < 8) bytes[threadIdx.x] = a.bytes[threadIdx.x];
  const uint8_t *q = nullptr;
  if (a.query != nullptr) {
    const uint8_t *src = a.query + (size_t)k * qlen;
    for (int t = threadIdx.x; t < qlen; t += kThreads) codes_s[t] = src[t];
    q = codes_s;
  }
  __syncthreads();

  const int slot = threadIdx.x / kGroup, lane = threadIdx.x % kGroup;
  const int p_raw = blockIdx.x * kPairs + slot;
  const bool live = p_raw < a.r;
  const int p = live ? p_raw : a.r - 1;  // a group past R computes, stores nothing
  const uint8_t *ps = a.pool + (size_t)p * (a.query_is_read ? n : m);
  const uint8_t *rows = a.query_is_read ? q : ps;  // read codes (not for PSSMs)
  const uint8_t *cols = a.query_is_read ? ps : q;  // ref codes
  int32_t *edge = edge_shared ? edge_s + slot * m * kEdge
                 : a.edge == nullptr
                     ? nullptr
                     : a.edge + ((size_t)blockIdx.y * gridDim.x * kPairs + p_raw) * m * kEdge;
  const val::Score<kSub> sc{bytes, reinterpret_cast<const char *>(tab), s, a.pssm};
  const val::Best best = val::group_best<kLocal, kAffine, kCoords, kSub, kCols>(
      sc, rows, cols, edge, m, n, lane, a.gap_read, a.gap_ref, a.open_read, a.open_ref);
  if (lane == 0 && live) {
    const size_t pp = (size_t)k * a.r + p;
    a.out[pp] = best.v;
    if (kCoords) {
      a.end_row[pp] = best.row;
      a.end_col[pp] = best.col;
    }
  }
}

// Launches one instantiation over the k queries, kMaxGridY at a time, with
// `smem` bytes of dynamic shared memory; returns the first CUDA error.
template <bool kLocal, bool kAffine, bool kCoords, int kSub, int kCols>
cudaError_t launch(SearchArgs a, size_t smem, cudaStream_t stream) {
  const auto kernel = search_kernel<kLocal, kAffine, kCoords, kSub, kCols>;
  if (const cudaError_t err = val::allow_smem(kernel, smem); err != cudaSuccess) return err;
  for (int k0 = 0; k0 < a.k; k0 += kMaxGridY) {
    a.k0 = k0;
    const int ky = a.k - k0 < kMaxGridY ? a.k - k0 : kMaxGridY;
    const dim3 grid((a.r + kPairs - 1) / kPairs, ky);
    kernel<<<grid, kThreads, smem, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Launch on `stream`; k, r, m, n, s >= 1. `pool` is the (r, plen) uint8
// codes, plen = n when query_is_read else m. Scoring, one of:
// - `bytes` (8, 2) int32, the DNA byte tables of read codes 0..7 (table and
//   query codes as below, table null);
// - `table` (s, s) int32 [read code][ref code] with `query` (k, qlen) uint8
//   codes, qlen = m when query_is_read else n;
// - pssm: `table` (k, m, s) int32 profiles, query null, query_is_read 1.
// `edge` is null or, where a block's boundary columns do not fit shared
// memory, (min(k, 65535) * ceil(r / 8) * 8, m, affine ? 2 : 1) int32
// scratch. `cols` (32 or 40) is the ref columns per lane. `out` (k, r)
// int32; with coords (SW, table scoring only) `end_row`, `end_col` (k, r)
// int32. Returns the first CUDA error (0 on success).
extern "C" int val_search_launch(const void *pool, const void *query, const void *table,
                                 const void *bytes, void *edge, void *out,
                                 void *end_row, void *end_col, int k, int r, int m,
                                 int n, int s, int query_is_read, int pssm,
                                 int gap_read, int gap_ref, int open_read, int open_ref,
                                 int local, int affine, int coords, int cols,
                                 void *stream) {
  SearchArgs a{static_cast<const uint8_t *>(pool),
               static_cast<const uint8_t *>(query),
               static_cast<const int32_t *>(table),
               static_cast<const uint2 *>(bytes),
               static_cast<int32_t *>(edge),
               static_cast<int32_t *>(out),
               static_cast<int32_t *>(end_row),
               static_cast<int32_t *>(end_col),
               k, r, m, n, s, 0, query_is_read, pssm,
               gap_read, gap_ref, open_read, open_ref};
  if ((table == nullptr) == (bytes == nullptr) || (pssm && (!query_is_read || query)) ||
      (!pssm && query == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int stripes = (n + 16 * cols - 1) / (16 * cols);
  const size_t edge_bytes = edge == nullptr && stripes > 1
                                ? sizeof(int32_t) * kPairs * m * (affine ? 2 : 1)
                                : 0;
  const size_t code_bytes = query == nullptr ? 0 : (query_is_read ? m : n);
  const size_t tab_bytes =
      table == nullptr ? 0 : sizeof(int32_t) * static_cast<size_t>(pssm ? m : s) * s;
  const size_t rest = edge_bytes + code_bytes;
  if (rest > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int sub = table == nullptr ? 0 : tab_bytes + rest <= kMaxSmemBytes ? 1 : 2;
  // Coordinates come with SW and table scoring (kSub 1, 2) only.
  return static_cast<int>(val::dispatch_group(
      local, affine, local && coords, sub, cols,
      [&](auto kL, auto kA, auto kC, auto kS, auto kCo) {
        constexpr bool kNone = !decltype(kL)::value || decltype(kS)::value == 0;
        if constexpr (decltype(kC)::value && kNone) {
          return cudaErrorInvalidValue;
        } else {
          return launch<decltype(kL)::value, decltype(kA)::value, decltype(kC)::value,
                        decltype(kS)::value, decltype(kCo)::value>(
              a, sub == 1 ? tab_bytes + rest : rest, static_cast<cudaStream_t>(stream));
        }
      }));
}
