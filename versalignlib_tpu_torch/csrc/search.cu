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
// - a group of kGroup = 16 lanes per (query, pool sequence) pair, kPairs = 8
//   pairs a block of four warps, all of one query (blockIdx.y walks the
//   queries, blockIdx.x the pool in blocks of kPairs), whose codes, S x S
//   matrix or PSSM are copied to shared memory once per block;
// - lane l owns kCols consecutive ref columns (32 or 40, the wrapper's
//   choice per launch, ops/cuda_search.search_cols) of a stripe of
//   16 * kCols. At step t it computes read row t - l of its columns: the H
//   (and F) values of its previous row stay in its registers; H (and E) left
//   of its first column come from lane l - 1 by one __shfl_up_sync; the
//   diagonal is what it received the step before. Lane 0 reads column -1
//   (H 0, E -inf) or, past the first stripe, the right edge of the previous
//   one, which lane 15 left in the pair's boundary column: m int32 (2m
//   affine) in shared memory, or in device memory where a block's eight
//   would not fit. No rolling row ever leaves the registers;
// - the pool is pair-major (R, len) uint8, each lane's column codes loaded
//   once a stripe, the read code once a step;
// - cells are int32 through Hopper's DPX instructions, a row in two passes
//   that update the lane's registers in place: descending, the terms from
//   the row above, max(up + gap_ref, diag + sub [, 0]) as one
//   __viaddmax_s32(_relu) after the diagonal add, or affine F = max(up +
//   open_ref + gap_ref, F + gap_ref) and max(diag + sub, F), each an add
//   and a __viaddmax_s32 (the diagonal of a column is the old H of the one
//   on its left, not yet overwritten); ascending, the row's dependent
//   chain, max(left + gap_read, that) as one __viaddmax_s32, or affine E =
//   max(left + open_read + gap_read, E + gap_read) and H = max(that, E [,
//   0]). Written in one pass, the compiler put each diagonal add into the
//   old H's register and copied every new H back (25 moves a step of 32
//   cells). The integer ALU pipe sets the time: about 3.9 of a DNA linear
//   SW cell's 5.5 instructions go to it (PERF.md, B4);
// - substitution: default DNA scores that fit a signed byte come from an
//   8-byte table per read code (A/C/G/T 1..4, every other code 0; built by
//   the wrapper) and one prmt per cell that also sign-extends the byte. An
//   S x S matrix (or DNA scores past a byte, as their 6 x 6 matrix) or a
//   PSSM is one lookup a cell at the row's offset plus the column's (kSub
//   1: in shared memory; kSub 2: past 227 KB, through the read-only cache);
//   codes >= S read as code 0;
// - SW folds its cells with three-way maxima; with coordinates each cell's
//   key is value << kKeyBits | (kCols - 1 - column), one max per row keeps the
//   row's leftmost maximum, each lane its first strict maximum in row order
//   (a later stripe may tie it at a smaller row), and the group reduces by
//   (max, least row, least column). The wrapper checks that the keys cannot
//   overflow. NW takes the last column from the lane that owns it and the
//   final row from every lane;
// - a partial last lane computes its columns past n as copies of the last
//   real one (kPartial), so the last column, the keys and the final row
//   need no masks.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using val::kNegInf;
constexpr int kGroup = 16;                 // lanes per pair
constexpr int kThreads = 128;              // four warps
constexpr int kPairs = kThreads / kGroup;  // pairs per block
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kMaxGridY = 65535;
// The most dynamic shared memory a block of sm_90 may opt in to, less the
// byte tables' static 64 bytes.
constexpr size_t kMaxSmemBytes = (227 << 10) - 64;
constexpr size_t kDefaultSmemBytes = 48 << 10;

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

// The substitution score of a cell: a row state (found once a row) and a
// column key (found once a stripe).
template <int kSub>
struct Score {
  const uint2 *bytes;  // kSub 0: the byte tables of read codes 0..7
  const char *tab;     // kSub 1, 2: the matrix or the query's PSSM
  int s, pssm;

  // The key of ref code f: kSub 0 the prmt selector of its byte (code 0's
  // byte is 0 in every table); else its byte offset in a table row.
  __device__ __forceinline__ int col(int f) const {
    if (kSub == 0) {
      const int fs = f >= 1 && f <= 4 ? f : 0;
      return fs | ((fs | 8) * 0x1110);
    }
    return (f < s ? f : 0) * 4;
  }
  // The state of read row i, read code `code`: kSub 0 its byte table;
  // else the byte offset of its table row (a PSSM's row is i itself).
  __device__ __forceinline__ int2 row(int i, int code) const {
    if (kSub == 0) {
      const uint2 t = bytes[code < 8 ? code : 0];
      return {static_cast<int>(t.x), static_cast<int>(t.y)};
    }
    return {(pssm ? i : (code < s ? code : 0)) * s * 4, 0};
  }
  __device__ __forceinline__ int operator()(const int2 &r, int ck) const {
    if (kSub == 0) {
      int v;
      asm("prmt.b32 %0, %1, %2, %3;" : "=r"(v) : "r"(r.x), "r"(r.y), "r"(ck));
      return v;
    }
    const int32_t *p = reinterpret_cast<const int32_t *>(tab + (r.x + ck));
    return kSub == 2 ? __ldg(p) : *p;
  }
};

// The registers of a lane's columns: H and F of the previous row (then the
// current one), and the columns' substitution keys.
template <int kCols>
struct Lane {
  int h[kCols], f[kCols], ck[kCols];
};

// The pair's candidate: SW (value, row, column); NW the running maximum.
struct Best {
  int v = 0, row = 0, col = 0;
};

template <bool kLocal, bool kAffine, bool kCoords, int kSub, int kCols>
__global__ void __launch_bounds__(kThreads) search_kernel(SearchArgs a) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ uint2 bytes[8];
  constexpr int kEdge = kAffine ? 2 : 1;
  constexpr int kStripe = kGroup * kCols;
  constexpr int kKeyBits = kCols <= 32 ? 5 : 6;
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
  const Score<kSub> sc{bytes, reinterpret_cast<const char *>(tab), s, a.pssm};
  const int gl = a.gap_read, gu = a.gap_ref;
  const int eo = a.open_read + a.gap_read, fo = a.open_ref + a.gap_ref;

  Best best;
  Lane<kCols> L;
  for (int st = 0; st < stripes; ++st) {
    const int s0 = st * kStripe, c0 = s0 + lane * kCols;
    const int nl = min(kGroup, (n - s0 + kCols - 1) / kCols);  // busy lanes
    const int ncol = max(0, min(kCols, n - c0));               // real columns
    const bool last = st + 1 == stripes;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      L.ck[c] = sc.col(c < ncol ? cols[c0 + c] : 0);
      L.h[c] = 0;         // row -1: H 0,
      L.f[c] = kNegInf;   // F -inf
    }
    __syncwarp();  // the previous stripe's boundary column is written
    // The stripe's steps; kPartial (uniform): the last lane has columns
    // past n.
    auto steps = [&](auto kPartial) {
      int eh = 0, ee = kNegInf, diag = 0;
      int code_next = a.pssm ? 0 : rows[0];
      for (int t = 0; t < m + nl - 1; ++t) {
        const int i = t - lane;
        int ih = __shfl_up_sync(kAll, eh, 1, kGroup);
        int ie = kAffine ? __shfl_up_sync(kAll, ee, 1, kGroup) : 0;
        if (lane == 0) {
          if (st == 0) {
            ih = 0;
            ie = kNegInf;
          } else if (i < m) {
            ih = edge[i * kEdge];
            if (kAffine) ie = edge[i * kEdge + 1];
          }
        }
        const int code = code_next;
        if (!a.pssm) code_next = rows[min(max(i + 1, 0), m - 1)];
        if (i >= 0 && i < m && lane < nl) {
          const int2 r = sc.row(i, code);
          // Each register is updated in place. Descending, the terms from
          // the row above: F, and max(diag + sub, up + gap_ref) or, affine,
          // max(diag + sub, F); the diagonal of column c is column c - 1's
          // old H, not yet overwritten.
#pragma unroll
          for (int c = kCols - 1; c >= 0; --c) {
            const int up = L.h[c];
            const int dg = c > 0 ? L.h[c - 1] : diag;
            const int s_c = sc(r, L.ck[c]);
            if (kAffine) {
              L.f[c] = __viaddmax_s32(up, fo, L.f[c] + gu);
              L.h[c] = __viaddmax_s32(dg, s_c, L.f[c]);
            } else {
              L.h[c] = kLocal ? __viaddmax_s32_relu(up, gu, dg + s_c)
                              : __viaddmax_s32(up, gu, dg + s_c);
            }
          }
          // Ascending, the row's chain: H = max(that, left + gap_read) or,
          // affine, max(that, E [, 0]).
          int left = ih, e = ie, rk = 0, k_even = 0;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            int cur;
            if (kAffine) {
              e = __viaddmax_s32(left, eo, e + gl);
              cur = kLocal ? __vimax_s32_relu(L.h[c], e) : max(L.h[c], e);
            } else {
              cur = __viaddmax_s32(left, gl, L.h[c]);
            }
            if (decltype(kPartial)::value && c >= ncol) cur = left;
            if (kLocal) {
              // Two columns fold with one three-way max: SW's row maximum,
              // or with coordinates its key.
              const int kc = kCoords ? (cur << kKeyBits) + (kCols - 1 - c) : cur;
              if (c % 2 == 0) k_even = kc;
              else rk = __vimax3_s32(rk, k_even, kc);
            }
            L.h[c] = cur;
            left = cur;
          }
          eh = left;
          ee = e;
          if (!last && lane == kGroup - 1) {
            edge[i * kEdge] = eh;
            if (kAffine) edge[i * kEdge + 1] = ee;
          }
          if (kCoords) {
            // Rows come in order within a stripe; a later stripe's row can
            // tie the best at a smaller row.
            const int v = rk >> kKeyBits;
            if (v > best.v || (v == best.v && i < best.row)) {
              best.v = v;
              best.row = i;
              best.col = c0 + kCols - 1 - (rk & ((1 << kKeyBits) - 1));
            }
          } else if (kLocal) {
            best.v = max(best.v, rk);
          } else {
            // NW: the last column of every row, and the whole final row.
            if (last && lane == nl - 1) best.v = max(best.v, eh);
            if (i == m - 1) {
#pragma unroll
              for (int c = 0; c < kCols; ++c) best.v = max(best.v, L.h[c]);
            }
          }
        }
        diag = ih;
      }
    };
    if (last && (n - s0) % kCols != 0) steps(std::true_type{});
    else steps(std::false_type{});
  }
  // The group's reduction: (max, least row, least column).
#pragma unroll
  for (int d = kGroup / 2; d > 0; d /= 2) {
    const int ov = __shfl_xor_sync(kAll, best.v, d, kGroup);
    if (kCoords) {
      const int orow = __shfl_xor_sync(kAll, best.row, d, kGroup);
      const int ocol = __shfl_xor_sync(kAll, best.col, d, kGroup);
      if (ov > best.v || (ov == best.v && (orow < best.row ||
                                           (orow == best.row && ocol < best.col)))) {
        best.v = ov;
        best.row = orow;
        best.col = ocol;
      }
    } else {
      best.v = max(best.v, ov);
    }
  }
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
  if (smem > kDefaultSmemBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
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

template <bool kLocal, bool kCoords, int kSub>
cudaError_t with_gaps_and_cols(const SearchArgs &a, bool affine, int cols, size_t smem,
                               cudaStream_t st) {
  if (cols == 32) {
    return affine ? launch<kLocal, true, kCoords, kSub, 32>(a, smem, st)
                  : launch<kLocal, false, kCoords, kSub, 32>(a, smem, st);
  }
  if (cols == 40) {
    return affine ? launch<kLocal, true, kCoords, kSub, 40>(a, smem, st)
                  : launch<kLocal, false, kCoords, kSub, 40>(a, smem, st);
  }
  return cudaErrorInvalidValue;
}

template <int kSub>
cudaError_t with_algorithm(const SearchArgs &a, bool local, bool coords, bool affine,
                           int cols, size_t smem, cudaStream_t st) {
  if (!local) return with_gaps_and_cols<false, false, kSub>(a, affine, cols, smem, st);
  if (!coords) return with_gaps_and_cols<true, false, kSub>(a, affine, cols, smem, st);
  if constexpr (kSub == 0) return cudaErrorInvalidValue;  // coordinates come with PSSMs
  else return with_gaps_and_cols<true, true, kSub>(a, affine, cols, smem, st);
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (table == nullptr)
    err = with_algorithm<0>(a, local, coords, affine, cols, rest, st);
  else if (tab_bytes + rest <= kMaxSmemBytes)
    err = with_algorithm<1>(a, local, coords, affine, cols, tab_bytes + rest, st);
  else
    err = with_algorithm<2>(a, local, coords, affine, cols, rest, st);
  return static_cast<int>(err);
}
