// Affine-gap (Gotoh) pointer fill: Smith-Waterman and the reference's
// semi-global "Needleman-Wunsch", default DNA scoring or an S x S
// substitution matrix, both tie-break flavors, int32 cells.
//
// Replaces versalignlib_tpu/ops/pallas_align.py::_affine_align_kernel and
// writes what that kernel writes, in the layout the host decoder reads:
// - ptr (b, m, ceil(n/8)) int32, pair-major: one 4-bit code per inner cell,
//   hptr | e_ext << 2 | f_ext << 3 (hptr 0 START, 1 UP = enter F, 2 LEFT =
//   enter E, 3 DIAG), 8 per word, code j in bits 4*(j % 8); the unfilled
//   fields of a partial last word read 0;
// - aux (b, 4) and hsel (b, n+1) exactly as csrc/align.cu writes them; the
//   NW column 0 here is the Gotoh boundary open_ref + (i+1)*gap_ref.
//
// Recurrences (pallas_align.py:753-922, gotoh.py):
//   F = max(up + open_ref, F_up) + gap_ref     (flows down each column)
//   E = max(left + open_read, E) + gap_read    (a register carry per row)
//   H = max(H_diag + sub, F, E [, 0 for SW])
// with E and F at -inf (NEG_INF_I32 = -(2**30)) where no gap exists. The
// extend bits compare the pre-add maxima: e_ext = (E_prev >= left +
// open_read), f_ext = (F_up >= up + open_ref), so extend wins ties.
//
// As in align.cu, the DP runs in the shifted domain: H, E and F carry
// value << 2 with a 2-bit move priority in H's low bits, and NEG_INF_I32
// itself is the shifted -inf.
// - Canonical flavor (DIAG > UP(F) > LEFT(E)): max(diag | 2, F | 1, E), and
//   SW takes a max with 3 = (value 0, priority 3), at once the clamp at 0
//   and the zero-force to START. The priority-to-code shuffle runs once per
//   word on the hptr bits alone, and a partial last word is masked to START.
// - SSE flavor (valid-gated DIAG > LEFT(E) > UP(F)): max(diag | (3 if both
//   codes are valid else 0), E | 2, F | 1), no zero-force, SW clamps with 0.
//
// What bounds it on an H100: integer operations (26 per SW cell and 25 per
// NW cell in the recurrence, chip_smoke.FILL_OPS) well ahead of bytes
// (the pointer words, 4 bits per cell, are the only output of size). The
// design is align.cu's, the wavefront of fill.cuh: one warp per pair, four
// pairs a block, each lane 16 columns (two pointer words a row) of a
// 512-column stripe, with its columns' H and F values in registers and E
// handed to the next lane with H, the substitution of fill::Sub, the
// pointer rows staged in shared memory. F and E are kept with their move
// priority added (F | 1; E | 2 in the SSE flavor), which leaves the extend
// comparisons unchanged and saves an add a cell; a cell's 4-bit code is
// packed by one funnel shift.

#include <cstdint>
#include <cuda_runtime.h>

#include "fill.cuh"

namespace {

using val::kNegInf;  // pallas_score.NEG_INF_I32, the shifted -inf

template <bool kLocal_, bool kCanon_, int kMat>
struct AffineCell {
  static constexpr bool kAffine = true, kLocal = kLocal_, kCanon = kCanon_;
  static constexpr int kBits = 4, kWords = 2, kCols = fill::kCols;
  static constexpr int kEPrio = kCanon ? 0 : 2;  // E's move priority
  using Sub = fill::Sub<kMat, kCanon>;

  // The lane's columns: H and F | 1 of the previous row (then the current
  // row), and their substitution state.
  struct Lane {
    int h[kCols], f[kCols];
    typename Sub::Cols cols;
  };

  const fill::Args &a;
  Sub sub;
  int fo, eo;  // open with the F / E priority

  __device__ AffineCell(const fill::Args &args, Sub s)
      : a(args), sub(s), fo(args.open_ref4 + 1), eo(args.open_read4 + kEPrio) {}

  __device__ __forceinline__ void begin(Lane &st, const uint8_t *ref, int c0,
                                        int n) const {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      sub.column(st.cols, c, c0 + c < n ? ref[c0 + c] : 0);
      st.h[c] = 0;            // row -1: H is 0,
      st.f[c] = kNegInf + 1;  // F is -inf
    }
  }

  // Column 0 on row i: 0 for SW; the Gotoh boundary H[k][0] = open_ref +
  // k*gap_ref for NW (k = i + 1; H[0][0] = 0), pallas_align.py:803-810. E
  // is -inf there.
  __device__ __forceinline__ fill::Edge boundary(int i) const {
    return {kLocal ? 0 : a.open_ref4 + (i + 1) * a.gap_ref4, kNegInf + kEPrio};
  }
  __device__ __forceinline__ int hsel0(int mrp) const {
    return a.open_ref + (mrp + 1) * a.gap_ref;
  }
  __device__ __forceinline__ int seed(int mrp) const {
    return a.open_ref4 + (mrp + 1) * a.gap_ref4;
  }

  template <bool kPartial>
  __device__ __forceinline__ void row(Lane &st, int code, const fill::Edge &in,
                                      int diag, fill::Edge &out,
                                      uint32_t (&word)[2], int &key,
                                      int ncol) const {
    const typename Sub::Row r = sub.row(code);
    int left = in.h, e = in.e, k = 0, k_even = 0;
    uint32_t w[2] = {0, 0};
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int up = st.h[c];
      const int diag_p = diag + sub(r, st.cols, c) + (kCanon ? 2 : 0);
      // F = max(up + open_ref, F_up) + gap_ref down the column, E = max(left
      // + open_read, E) + gap_read along the row; extend wins ties.
      const int f_pre = __viaddmax_s32(up, fo, st.f[c]);
      const uint32_t fbit = f_pre == st.f[c] ? 8u : 0u;
      const int f_new = f_pre + a.gap_ref4;
      const int e_pre = __viaddmax_s32(left, eo, e);
      const uint32_t ebit = e_pre == e ? 4u : 0u;
      const int e_new = e_pre + a.gap_read4;
      const int t = kLocal ? __vimax3_s32(diag_p, f_new, kCanon ? 3 : 0) : max(diag_p, f_new);
      const int cur_p = max(t, e_new);
      const int cur = cur_p & ~3;
      // The cell's code enters at the top of its word; after 8 columns
      // column c's field sits at bits 4 * (c % 8).
      w[c / 8] = __funnelshift_r(w[c / 8], (static_cast<uint32_t>(cur_p) & 3u) | ebit | fbit, 4);
      if (kLocal) {
        // The keys of two columns fold with one three-way max.
        const int kc = (kPartial && c >= ncol) ? 0 : cur * 4 + (kCols - 1 - c);
        if (c % 2 == 0) k_even = kc;
        else k = __vimax3_s32(k, k_even, kc);
      }
      diag = up;
      st.h[c] = cur;
      st.f[c] = f_new;
      e = e_new;
      left = cur;
    }
    out.h = left;
    out.e = e;
    word[0] = w[0];
    word[1] = w[1];
    key = k;
  }
};

template <bool kLocal, bool kCanon, int kMat>
__global__ void __launch_bounds__(fill::kWarps * fill::kLanes)
    affine_kernel(fill::Args a) {
  fill::fill_block<AffineCell<kLocal, kCanon, kMat>, kMat>(a);
}

}  // namespace

// Launch on `stream`; b >= 1, m >= 1, n >= 1; hsel may be null for SW.
// `edge` is (b, 2, m, 2) int32 scratch when n > fill::kStripe, else may be
// null. `table` is the (s, s) matrix already shifted << 2, with 3 added
// where both codes are valid for the SSE flavor (fill::Sub), or null for
// the default DNA scoring, whose scores must then fit fill::Sub's bytes
// (else cudaErrorInvalidValue). Returns cudaGetLastError().
extern "C" int val_align_affine_launch(
    const void *reads, const void *refs, const void *mrp, void *edge, void *ptr,
    void *aux, void *hsel, const void *table, int b, int m, int n, int s,
    int match, int mismatch, int gap_read, int gap_ref, int open_read,
    int open_ref, int local, int canonical, void *stream) {
  fill::Args a{static_cast<const uint8_t *>(reads),
               static_cast<const uint8_t *>(refs),
               static_cast<const int32_t *>(mrp),
               static_cast<int32_t *>(edge),
               static_cast<int32_t *>(ptr),
               static_cast<int32_t *>(aux),
               static_cast<int32_t *>(hsel),
               static_cast<const int32_t *>(table),
               b, m, n, (n + 7) / 8, s,
               match * 4, mismatch * 4, gap_read * 4, gap_ref * 4,
               open_read * 4, open_ref * 4, gap_ref, open_ref};
  const size_t table_bytes = sizeof(int32_t) * s * s;
  if (table == nullptr && !fill::dna_fits_bytes(match, mismatch))
    return static_cast<int>(cudaErrorInvalidValue);
  val::dispatch(local, canonical, table, table_bytes,
                [&](auto kLocal, auto kCanon, auto kMat) {
    fill::launch(affine_kernel<decltype(kLocal)::value, decltype(kCanon)::value,
                               decltype(kMat)::value>,
                 a, kMat == 1 ? table_bytes : 0, static_cast<cudaStream_t>(stream));
  });
  return static_cast<int>(cudaGetLastError());
}
