// Pieces shared by the banded kernels (banded_score.cu, banded_align.cu):
// one warp per pair, the band's rows staged per warp, the substitution of
// one cell, the first pass over a row and the warp scan that resolves the
// in-row gap dependency exactly.
//
// The band. Row i covers the band columns k = 0 .. band-1, DP column
// o(i) + 1 + k, o(i) = offsets[i]; consecutive rows step right by
// s = o(i) - o(i-1), 0 <= s <= d (banded.py band_offsets / max_band_step).
// Cells outside a row's band are -inf (kNeg), column 0 and row 0 are 0, as
// banded_score_oracle / banded_align_oracle define them.
//
// The rows. A warp keeps the previous and the current H row (and F row
// under affine gaps), each `row_len` int32: index 0 is DP column o(i), the
// boundary left of the band (0 when o(i) == 0, else kNeg), index 1 + k band
// column k, and d tail entries that stay kNeg, so that the cell above band
// column k of row i, at index k + s + 1 of row i - 1, reads -inf past that
// row's band. Row -1 (DP row 0) is all 0. The rows sit in shared memory or,
// where a band is too wide for it, in device memory (`scratch`).
//
// The lanes. Lane l owns the contiguous band columns [l*cols, (l+1)*cols),
// cols a multiple of 8 so that a lane's columns fill whole pointer words.
// A row takes three steps:
// 1. pass_a: each lane computes, for its columns, everything that does not
//    depend on the cell to the left: T = max(diag + sub, up + gap_ref
//    [or F], -inf [or 0 for SW]), and folds its columns into one aggregate;
// 2. scan_entry: a max-plus prefix scan over the lanes (5 __shfl_up_sync)
//    gives each lane the value entering its first column;
// 3. the kernel's own pass over its columns, from that value.
// Linear gaps: H[k] = max(T[k], H[k-1] + gap_read), so H[k] = max over
// j <= k of T[j] + (k-j)*gap_read, with T[-1] the boundary (plain.py
// _row_solve). Affine gaps: E[k] = max(-inf, U[k-1] + gap_read) with
// U[k] = max(T[k] + open_read, U[k-1] + gap_read), U[-1] = boundary +
// open_read, and H = max(T, E) (plain.py _row_solve_open; exact because
// open_read and gap_read are <= 0). Every step is an int32 add or max, so
// the values equal the oracle's and the move codes can be read off them by
// equality, as the oracle reads them.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace valb {

constexpr int kNeg = -(1 << 30);   // pallas_score.NEG_INF_I32
// Start of a lane's fold: below every candidate (>= kNeg minus a few gap
// scores per column), and far enough above INT_MIN for the adds.
constexpr int kSent = -(3 << 29);
constexpr int kWarps = 4;          // pairs per block, one warp each
constexpr unsigned kFull = 0xFFFFFFFFu;

struct BandArgs {
  const uint8_t *reads;    // (b, m) codes
  const uint8_t *refs;     // (b, n) codes
  const int32_t *offsets;  // (m,) band start of each row
  int32_t *scratch;        // (b, row words) rows in device memory, or null
  const int32_t *table;    // (s, s) matrix, or null for the DNA table
  const uint8_t *valid;    // (s,) SSE validity of each code (matrix only)
  int b, m, n, band, d, cols, s;
  int match, mismatch, gap_read, gap_ref, open_read, open_ref;
};

__host__ __device__ inline int row_len(int band, int d) { return band + d + 1; }

// int32 words of one warp's rows: H previous and current, and F both.
__host__ __device__ inline int row_words(int band, int d, bool affine) {
  return (affine ? 4 : 2) * row_len(band, d);
}

// Where shared memory holds an S x S matrix (kMat 1), in int32 words,
// rounded up to 16 bytes; the rows follow it.
__host__ __device__ inline int table_words(int s) {
  return (s * s * 4 + s + 15) / 16 * 4;
}

// A read code as the cells of its row use it: the row base of the matrix
// (or the DNA code, -1 when not A/C/G/T) and its validity.
struct ReadCode {
  int base;
  bool valid;
};

template <int kMat>
__device__ __forceinline__ ReadCode read_code(const BandArgs &a,
                                              const uint8_t *vtab, int c) {
  if (kMat) {
    const bool in = c < a.s;
    return {(in ? c : 0) * a.s, in && val::lookup<kMat>(vtab, c) != 0};
  }
  const bool v = c >= 1 && c <= 4;
  return {v ? c : -1, v};
}

// Substitution score of read code r against ref code f: matrix[r][f] with
// codes past S read as 0; DNA match / mismatch between A/C/G/T, else 0.
template <int kMat>
__device__ __forceinline__ int sub_score(const BandArgs &a, const int32_t *tab,
                                         ReadCode r, int f) {
  if (kMat) return val::lookup<kMat>(tab, r.base + (f < a.s ? f : 0));
  if (r.base < 0 || f < 1 || f > 4) return 0;
  return r.base == f ? a.match : a.mismatch;
}

template <int kMat>
__device__ __forceinline__ bool ref_valid(const BandArgs &a, const uint8_t *vtab,
                                          int f) {
  if (kMat) return f < a.s && val::lookup<kMat>(vtab, f) != 0;
  return f >= 1 && f <= 4;
}

struct Rows {
  int32_t *h_prev, *h_cur, *f_prev, *f_cur;

  __device__ __forceinline__ void swap() {
    int32_t *t = h_prev;
    h_prev = h_cur;
    h_cur = t;
    t = f_prev;
    f_prev = f_cur;
    f_cur = t;
  }
};

// The rows of pair p (warp `warp` of its block), set up for row 0: the
// previous row is DP row 0 (0 up to the band's end), every tail and every F
// entry -inf.
template <bool kAffine, int kMat>
__device__ __forceinline__ Rows init_rows(const BandArgs &a, int32_t *smem,
                                          int p, int warp, int lane) {
  const int len = row_len(a.band, a.d);
  const int words = row_words(a.band, a.d, kAffine);
  int32_t *buf = a.scratch != nullptr
                     ? a.scratch + (size_t)p * words
                     : smem + (kMat == 1 ? table_words(a.s) : 0) + warp * words;
  Rows r{buf, buf + len, buf + 2 * len, buf + 3 * len};
  for (int k = lane; k < len; k += 32) {
    r.h_prev[k] = k <= a.band ? 0 : kNeg;
    r.h_cur[k] = kNeg;
    if (kAffine) {
      r.f_prev[k] = kNeg;
      r.f_cur[k] = kNeg;
    }
  }
  __syncwarp();
  return r;
}

// Step 1 of row i (band start o, step s) over the lane's columns [k0, k1):
// writes T to h_cur[1 + k] (and F to f_cur[1 + k]) and returns the lane's
// fold of T (affine: T + open_read) under gap_read, from kSent.
template <bool kLocal, bool kAffine, int kMat>
__device__ __forceinline__ int pass_a(const BandArgs &a, const int32_t *tab,
                                      const Rows &r, const uint8_t *ref,
                                      ReadCode rc, int o, int s, int k0, int k1) {
  int acc = kSent;
  for (int k = k0; k < k1; ++k) {
    const int diag = r.h_prev[k + s] + sub_score<kMat>(a, tab, rc, ref[o + k]);
    int t;
    if (kAffine) {
      const int f = max(max(r.h_prev[k + s + 1] + a.open_ref, r.f_prev[k + s + 1]) +
                            a.gap_ref,
                        kNeg);
      r.f_cur[1 + k] = f;
      t = max(diag, f);
    } else {
      t = max(diag, r.h_prev[k + s + 1] + a.gap_ref);
    }
    t = max(t, kLocal ? 0 : kNeg);
    r.h_cur[1 + k] = t;
    acc = max(kAffine ? t + a.open_read : t, acc + a.gap_read);
  }
  return acc;
}

// Step 2: the value entering lane `lane`'s first column, given `entry`, the
// value at column -1, each lane's fold `acc` and `span` = cols * gap_read,
// the gap over one lane's columns. With z_j = acc_j - j*span and Z its
// inclusive prefix maximum, the value entering lane l is
// max(entry + l*span, Z_{l-1} + (l-1)*span). Every lane takes part.
__device__ __forceinline__ int scan_entry(int acc, int entry, int span, int lane) {
  int z = acc - lane * span;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, z, d);
    if (lane >= d) z = max(z, y);
  }
  const int prev = __shfl_up_sync(kFull, z, 1);
  int x = entry + lane * span;
  if (lane > 0) x = max(x, prev + (lane - 1) * span);
  return x;
}

// Host side: the dynamic shared memory of a launch (the matrix when it is
// copied there, the rows unless they are in device memory), and the
// attribute that allows more than 48 KB.
template <typename Kernel>
inline size_t shared_bytes(Kernel kernel, const BandArgs &a, bool affine,
                           bool table_in_shared) {
  size_t bytes = table_in_shared ? 4 * (size_t)table_words(a.s) : 0;
  if (a.scratch == nullptr)
    bytes += 4 * (size_t)kWarps * row_words(a.band, a.d, affine);
  if (bytes > (48 << 10))
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
  return bytes;
}

inline dim3 grid_for(int b) { return dim3((b + kWarps - 1) / kWarps); }

}  // namespace valb
