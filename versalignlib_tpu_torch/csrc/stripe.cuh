// The lane-group step loop of the best-score kernels, search.cu (K queries
// against a pool) and score.cu (B pairs): the best-score recurrence of one
// pair, Smith-Waterman or the reference's semi-global "Needleman-Wunsch",
// linear or affine (Gotoh) gaps, int32 cells, and for SW optionally its
// argmax cell. A kernel sets up its block (shared tables, codes, boundary
// columns) and says where a group's row codes and column codes lie;
// group_best walks the pair and reduces the group's best, and both kernels
// launch through dispatch_group. The block prologues stay in each kernel:
// moved here as one function, they changed search.cu's SASS and made its
// profile_search SW launch 2.0% slower on an H100 (PERF.md, B4).
//
// The layout (the notes of search.cu and score.cu say why):
// - a group of kGroup = 16 lanes per pair, kPairs = 8 pairs a block of
//   kThreads = 128 threads;
// - lane l owns kCols consecutive ref columns (32 or 40, chosen per launch by
//   ops/cuda_search.search_cols) of a stripe of 16 * kCols. At step t it
//   computes read row t - l of its columns: the H (and F) values of its
//   previous row stay in its registers; H (and E) left of its first column
//   come from lane l - 1 by one __shfl_up_sync; the diagonal is what it
//   received the step before. Lane 0 reads column -1 (H 0, E -inf) or, past
//   the first stripe, the right edge of the previous one, which lane 15 left
//   in the pair's boundary column (m int32, 2m affine). No rolling row ever
//   leaves the registers;
// - each lane's column codes are loaded once a stripe, the read code once a
//   step (one step ahead);
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
//   cells);
// - substitution (Score): default DNA scores that fit a signed byte come
//   from an 8-byte table per read code (A/C/G/T 1..4, every other code 0;
//   built by the wrapper) and one prmt per cell that also sign-extends the
//   byte. An S x S matrix (or DNA scores past a byte, as their 6 x 6
//   matrix) or a PSSM is one lookup a cell at the row's offset plus the
//   column's (kSub 1: in shared memory; kSub 2: past 227 KB, through the
//   read-only cache); codes >= S read as code 0;
// - SW folds its cells with three-way maxima; with coordinates each cell's
//   key is value << kKeyBits | (kCols - 1 - column), one max per row keeps
//   the row's leftmost maximum, each lane its first strict maximum in row
//   order (a later stripe may tie it at a smaller row), and the group
//   reduces by (max, least row, least column). NW takes the last column
//   from the lane that owns it and the final row from every lane;
// - a partial last lane computes its columns past n as copies of the last
//   real one (kPartial), so the last column, the keys and the final row
//   need no masks.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "common.cuh"

namespace val {

constexpr int kGroup = 16;                 // lanes per pair
constexpr int kThreads = 128;              // four warps
constexpr int kPairs = kThreads / kGroup;  // pairs per block
constexpr unsigned kAll = 0xFFFFFFFFu;
// The most dynamic shared memory a block of sm_90 may opt in to, less the
// byte tables' static 64 bytes; past kDefaultSmemBytes a launch opts in.
constexpr size_t kMaxSmemBytes = (227 << 10) - 64;
constexpr size_t kDefaultSmemBytes = 48 << 10;

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

// Host side: opts `kernel` in to `smem` bytes of dynamic shared memory
// where they pass the 48 KB default.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmemBytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Host side: calls launch(kLocal, kAffine, kCoords, kSub, kCols), each a
// std::integral_constant, for the instantiation that the flags, `sub` (0,
// 1, 2) and `cols` (32, 40) select, and returns its error; an
// instantiation the kernel lacks is `launch`'s to refuse. Any other sub or
// cols is cudaErrorInvalidValue.
template <typename Launch>
cudaError_t dispatch_group(bool local, bool affine, bool coords, int sub, int cols,
                           Launch &&launch) {
  auto with_cols = [&](auto kL, auto kA, auto kC, auto kS) {
    if (cols == 32) return launch(kL, kA, kC, kS, std::integral_constant<int, 32>{});
    if (cols == 40) return launch(kL, kA, kC, kS, std::integral_constant<int, 40>{});
    return cudaErrorInvalidValue;
  };
  auto with_sub = [&](auto kL, auto kA, auto kC) {
    if (sub == 0) return with_cols(kL, kA, kC, std::integral_constant<int, 0>{});
    if (sub == 1) return with_cols(kL, kA, kC, std::integral_constant<int, 1>{});
    if (sub == 2) return with_cols(kL, kA, kC, std::integral_constant<int, 2>{});
    return cudaErrorInvalidValue;
  };
  auto with_coords = [&](auto kL, auto kA) {
    return coords ? with_sub(kL, kA, std::true_type{}) : with_sub(kL, kA, std::false_type{});
  };
  auto with_affine = [&](auto kL) {
    return affine ? with_coords(kL, std::true_type{}) : with_coords(kL, std::false_type{});
  };
  return local ? with_affine(std::true_type{}) : with_affine(std::false_type{});
}

// The best of one pair of m read rows and n ref columns, walked by the 16
// lanes of a group; `lane` is this thread's lane in it. `rows` points at the
// pair's m read codes (unread for PSSMs, sc.pssm), `cols` at its n ref codes;
// `edge` at its boundary column (m int32, 2m affine: H, E), used only when
// n spans more than one stripe. SW returns the local maximum seeded at 0
// (with kCoords its cell); NW the overlap score: the maximum over the last
// column of every row and over the whole final row, clamped at 0, with
// column -1 and row -1 at 0. Every lane of the group returns it.
template <bool kLocal, bool kAffine, bool kCoords, int kSub, int kCols>
__device__ __forceinline__ Best group_best(const Score<kSub> &sc, const uint8_t *rows,
                                           const uint8_t *cols, int32_t *edge, int m,
                                           int n, int lane, int gap_read, int gap_ref,
                                           int open_read, int open_ref) {
  constexpr int kEdge = kAffine ? 2 : 1;
  constexpr int kStripe = kGroup * kCols;
  constexpr int kKeyBits = kCols <= 32 ? 5 : 6;
  const int stripes = (n + kStripe - 1) / kStripe;
  const int gl = gap_read, gu = gap_ref;
  const int eo = open_read + gap_read, fo = open_ref + gap_ref;

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
      int code_next = sc.pssm ? 0 : rows[0];
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
        if (!sc.pssm) code_next = rows[min(max(i + 1, 0), m - 1)];
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
  return best;
}

}  // namespace val
