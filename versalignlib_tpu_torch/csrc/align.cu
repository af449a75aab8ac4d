// Linear-gap pointer fill: Smith-Waterman and the reference's semi-global
// "Needleman-Wunsch", default DNA scoring or an S x S substitution matrix,
// both tie-break flavors, int32 cells.
//
// Replaces versalignlib_tpu/ops/pallas_align.py::_align_kernel, all
// branches, and writes what that kernel writes, in the layout the host
// decoder reads:
// - ptr (b, m, ceil(n/16)) int32, pair-major: one 2-bit move code per inner
//   cell (0 START, 1 UP, 2 LEFT, 3 DIAG), 16 per word, code j in bits
//   2*(j % 16); the unfilled fields of a partial last word read START;
// - aux (b, 4) int32: SW [max, argmax_row, argmax_col, 0], the row-major
//   strict first-win scan seeded at 0 / (0, 0) (DefaultKernel.cpp:252-256);
//   NW [argmax of row mrp, 0, 0, 0], the leftmost strict argmax seeded by
//   the column-0 value at index 0 (DefaultKernel.cpp:317-318), 0 if mrp < 0;
// - hsel (b, n+1) int32, NW only: the H row of row mrp, column 0
//   ((mrp+1)*gap_ref) included; zeros if mrp < 0.
// mrp is each pair's last valid read row, computed on the host in the
// flavor's validity (pallas_align.py:508-522).
//
// The DP runs in the JAX kernel's shifted domain (pallas_align.py:147-234):
// every value carries value << 2 with a 2-bit move priority in the low bits,
// so one max picks (value, priority) lexicographically.
// - Canonical flavor (DIAG > UP > LEFT): priorities DIAG 2, UP 1, LEFT 0,
//   and SW takes a max with the constant 3 = (value 0, priority 3), which is
//   at once the clamp at 0 and the rule that a cell of value 0 is START.
//   Priorities become stored codes once per word by a 2-bit shuffle
//   (START 3->0, DIAG 2->3, UP 1->1, LEFT 0->2).
// - SSE flavor (DIAG > LEFT > UP): the priorities are the codes. DIAG counts
//   only when both symbols are valid (A/C/G/T, or under a matrix a code
//   whose row or column has a nonzero entry, alphabet.valid_code_mask): an
//   invalid DIAG gets priority 0, so if it is strictly best the cell is
//   START, and if it only ties it loses to LEFT or UP. SW clamps with 0 and
//   has no zero-force.
// The substitution (fill::Sub) carries the SSE DIAG priority: default DNA
// scores come from a per-row byte table (one prmt a cell), or as a 6 x 6
// matrix from the wrapper where they do not fit a byte; an S x S matrix,
// shifted << 2 with the SSE
// priority of both codes' validity added by the wrapper, sits in shared
// memory, one copy per block, or when past 48 KB is read through the
// read-only cache (kMat 2): one lookup a cell. Codes >= S read as code 0
// (score 0, invalid).
//
// What bounds it on an H100: integer operations (16 per SW cell in the
// recurrence, chip_smoke.FILL_OPS) well ahead of bytes (the pointer
// words, 2 bits per cell, are the only output of size). The design is the
// wavefront of fill.cuh: one warp per pair, four pairs a block, each lane
// 16 columns (one pointer word a row) of a 512-column stripe, pair-major
// (b, len) codes, the pointer rows staged in shared memory and stored
// whole. A launch of 4096 pairs is 1024 blocks, 31 warps for each of 132
// SMs, of which 16 to 28 are resident at once (registers; chip_smoke.py
// prints each instantiation's), so every scheduler of an SM has four or
// more warps to issue from; with one thread per pair the same launch was
// one warp per SM and ran at one warp's instruction latency (PERF.md). A
// cell is the substitution, an IADD3 for the diagonal with its priority, an
// add and a max for UP (a three-way max with the SW clamp), one
// __viaddmax_s32 for LEFT on the row's dependent chain, the clear of the
// priority and one funnel shift that packs it; SW adds a multiply-add and a
// max for its key.

#include <cstdint>
#include <cuda_runtime.h>

#include "fill.cuh"

namespace {

template <bool kLocal_, bool kCanon_, int kMat>
struct LinearCell {
  static constexpr bool kAffine = false, kLocal = kLocal_, kCanon = kCanon_;
  static constexpr int kBits = 2, kWords = 1, kCols = fill::kCols;
  using Sub = fill::Sub<kMat, kCanon>;

  // The lane's columns: the previous row's H values (then the current
  // row's), and their substitution state.
  struct Lane {
    int h[kCols];
    typename Sub::Cols cols;
  };

  const fill::Args &a;
  Sub sub;
  int gl, gu;  // LEFT and UP with their priorities

  __device__ LinearCell(const fill::Args &args, Sub s)
      : a(args), sub(s), gl(args.gap_read4 + (kCanon ? 0 : 2)), gu(args.gap_ref4 + 1) {}

  __device__ __forceinline__ void begin(Lane &st, const uint8_t *ref, int c0,
                                        int n) const {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      sub.column(st.cols, c, c0 + c < n ? ref[c0 + c] : 0);
      st.h[c] = 0;  // row -1
    }
  }

  // Column 0 on row i: 0 for SW; (i+1)*gap_ref for NW (DefaultKernel.cpp:305).
  __device__ __forceinline__ fill::Edge boundary(int i) const {
    return {kLocal ? 0 : (i + 1) * a.gap_ref4, 0};
  }
  __device__ __forceinline__ int hsel0(int mrp) const { return (mrp + 1) * a.gap_ref; }
  __device__ __forceinline__ int seed(int mrp) const { return (mrp + 1) * a.gap_ref4; }

  template <bool kPartial>
  __device__ __forceinline__ void row(Lane &st, int code, const fill::Edge &in,
                                      int diag, fill::Edge &out,
                                      uint32_t (&word)[1], int &key,
                                      int ncol) const {
    const typename Sub::Row r = sub.row(code);
    int left = in.h, k = 0, k_even = 0;
    uint32_t w = 0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int up = st.h[c];
      const int diag_p = diag + sub(r, st.cols, c) + (kCanon ? 2 : 0);
      const int up_p = up + gu;
      const int t = kLocal ? __vimax3_s32(diag_p, up_p, kCanon ? 3 : 0) : max(diag_p, up_p);
      const int cur_p = __viaddmax_s32(left, gl, t);
      const int cur = cur_p & ~3;
      // The move priority enters at the top; after kCols columns column
      // c's field sits at bits 2c.
      w = __funnelshift_r(w, static_cast<uint32_t>(cur_p), 2);
      if (kLocal) {
        // The keys of two columns fold with one three-way max.
        const int kc = (kPartial && c >= ncol) ? 0 : cur * 4 + (kCols - 1 - c);
        if (c % 2 == 0) k_even = kc;
        else k = __vimax3_s32(k, k_even, kc);
      }
      diag = up;
      st.h[c] = cur;
      left = cur;
    }
    out.h = left;
    word[0] = w;
    key = k;
  }
};

template <bool kLocal, bool kCanon, int kMat>
__global__ void __launch_bounds__(fill::kWarps * fill::kLanes)
    align_kernel(fill::Args a) {
  fill::fill_block<LinearCell<kLocal, kCanon, kMat>, kMat>(a);
}

}  // namespace

// Launch on `stream`; b >= 1, m >= 1, n >= 1; hsel may be null for SW.
// `edge` is (b, 2, m) int32 scratch when n > fill::kStripe, else may be
// null. `table` is the (s, s) matrix already shifted << 2, with 3 added
// where both codes are valid for the SSE flavor (fill::Sub), or null for
// the default DNA scoring, whose scores must then fit fill::Sub's bytes
// (else cudaErrorInvalidValue). Returns cudaGetLastError().
extern "C" int val_align_launch(const void *reads, const void *refs,
                                const void *mrp, void *edge, void *ptr,
                                void *aux, void *hsel, const void *table, int b,
                                int m, int n, int s, int match, int mismatch,
                                int gap_read, int gap_ref, int local,
                                int canonical, void *stream) {
  fill::Args a{static_cast<const uint8_t *>(reads),
               static_cast<const uint8_t *>(refs),
               static_cast<const int32_t *>(mrp),
               static_cast<int32_t *>(edge),
               static_cast<int32_t *>(ptr),
               static_cast<int32_t *>(aux),
               static_cast<int32_t *>(hsel),
               static_cast<const int32_t *>(table),
               b, m, n, (n + 15) / 16, s,
               match * 4, mismatch * 4, gap_read * 4, gap_ref * 4, 0, 0,
               gap_ref, 0};
  const size_t table_bytes = sizeof(int32_t) * s * s;
  if (table == nullptr && !fill::dna_fits_bytes(match, mismatch))
    return static_cast<int>(cudaErrorInvalidValue);
  val::dispatch(local, canonical, table, table_bytes,
                [&](auto kLocal, auto kCanon, auto kMat) {
    fill::launch(align_kernel<decltype(kLocal)::value, decltype(kCanon)::value,
                               decltype(kMat)::value>,
                 a, kMat == 1 ? table_bytes : 0, static_cast<cudaStream_t>(stream));
  });
  return static_cast<int>(cudaGetLastError());
}
