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
// A matrix (pre-shifted << 2 by the wrapper) and its per-code validity bytes
// sit in shared memory, as in score.cu: a cell pays one add and one shared
// load for its substitution, and the SSE gate one byte lookup per row and
// per column. Codes >= S read as code 0 (score 0, invalid). A table too
// large for 48 KB of static shared memory is read from device memory
// through the read-only cache (kMat 2).
//
// What bounds it on an H100: integer operations (16 per SW cell in the
// recurrence, chip_smoke.FILL_OPS) well ahead of bytes (the pointer
// words, 2 bits per cell, are the only output of size). The design is the
// score kernel's, with the scaffolding of common.cuh: one thread per pair,
// pair-interleaved (len, b) uint8 codes, kRows read rows advancing together
// with their state in registers, the rolling H row in an (n, b) int32
// scratch touched once per kRows cells, the next column's loads issued
// before the current column is computed. Each thread keeps one word per row
// in a register and stores it when its 16 columns are done, so every pointer
// word is written once. With one thread per pair, a batch of 4096 pairs is
// one warp per SM, and the time is one warp's instruction latency (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using val::lookup;
constexpr int kPack = 16;  // 2-bit codes per int32 word

struct AlignArgs {
  const uint8_t *reads;  // (m, b) codes
  const uint8_t *refs;   // (n, b) codes
  const int32_t *mrp;    // (b,) last valid read row
  int32_t *h;            // (n, b) rolling H row (shifted), columns 1..n
  int32_t *ptr;          // (b, m, nc)
  int32_t *aux;          // (b, 4)
  int32_t *hsel;         // (b, n + 1), NW only
  const int32_t *table;  // (s, s) matrix << 2 (matrix modes only)
  const uint8_t *valid;  // (s,) SSE validity per code (matrix modes only)
  int b, m, n, nc, s;
  int match4, mismatch4, gap_read4, gap_ref4;  // scores << 2
  int gap_ref;
};

// Per-row state of one sweep; arrays indexed by unrolled loops stay in
// registers. Under a matrix, rc is the row's base (code * S) in the table.
template <int R>
struct Rows {
  int rc[R], rmask[R], rv3[R];
  int left[R], diag[R], best[R], barg[R];
  uint32_t word[R];
};

// Column j (ref code f, H value above the sweep up) for all R rows; u is the
// field of j in its word. Returns the H value of the sweep's last row.
template <int R, bool kLocal, bool kCanon, int kMat>
__device__ __forceinline__ int column(const AlignArgs &a, const int32_t *tab,
                                      const uint8_t *vtab, Rows<R> &s, int j,
                                      int u, int cap_row, int32_t *hsel_row,
                                      int f, int up) {
  int fc, fbase = 0, fvm;
  if (kMat) {
    fc = f < a.s ? f : 0;
    fvm = (kCanon || lookup<kMat>(vtab, fc)) ? -1 : 0;
  } else {
    const bool fvalid = f >= 1 && f <= 4;
    fc = fvalid ? f : -1;
    fbase = fvalid ? a.mismatch4 : 0;
    fvm = fvalid ? -1 : 0;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int sub = kMat ? lookup<kMat>(tab, s.rc[r] + fc)
                         : (s.rc[r] == fc ? a.match4 : fbase) & s.rmask[r];
    int cur_p;
    if (kCanon) {
      const int diag_p = (s.diag[r] + sub) | 2;
      const int up_p = (up + a.gap_ref4) | 1;
      const int left_p = s.left[r] + a.gap_read4;  // priority 0
      cur_p = max(max(diag_p, up_p), left_p);
      if (kLocal) cur_p = max(cur_p, 3);
    } else {
      const int diag_p = (s.diag[r] + sub) | (s.rv3[r] & fvm);
      const int left_p = (s.left[r] + a.gap_read4) | 2;
      const int up_p = (up + a.gap_ref4) | 1;
      cur_p = max(max(diag_p, left_p), up_p);
      if (kLocal) cur_p = max(cur_p, 0);
    }
    const int cur = cur_p & ~3;
    s.word[r] |= static_cast<uint32_t>(cur_p & 3) << (2 * u);
    if (cur > s.best[r]) {  // strict: the leftmost maximum wins
      s.best[r] = cur;
      s.barg[r] = j;
    }
    if (!kLocal && r == cap_row) hsel_row[j + 1] = cur >> 2;
    s.diag[r] = up;
    s.left[r] = cur;
    up = cur;
  }
  return up;
}

// Sweep R read rows [i0, i0 + R) across all n columns for pair p, then fold
// the rows' maxima into the pair's running result in row order.
template <int R, bool kLocal, bool kCanon, int kMat>
__device__ __forceinline__ void sweep(const AlignArgs &a, const int32_t *tab,
                                      const uint8_t *vtab, int p, int i0,
                                      int mrp, val::FillResult &res) {
  Rows<R> s;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = a.reads[(size_t)(i0 + r) * a.b + p];
    if (kMat) {
      const int cm = c < a.s ? c : 0;
      s.rc[r] = cm * a.s;
      s.rv3[r] = (kCanon || lookup<kMat>(vtab, cm)) ? 3 : 0;
    } else {
      const bool valid = c >= 1 && c <= 4;
      s.rc[r] = valid ? c : -2;
      s.rmask[r] = valid ? -1 : 0;
      s.rv3[r] = valid ? 3 : 0;
    }
    // Column 0: 0 for SW; (i+1)*gap_ref for NW (DefaultKernel.cpp:305).
    s.left[r] = kLocal ? 0 : (i0 + r + 1) * a.gap_ref4;
    s.diag[r] = kLocal ? 0 : (i0 + r) * a.gap_ref4;
    s.best[r] = kLocal ? 0 : s.left[r];
    s.barg[r] = 0;
    s.word[r] = 0;
  }
  const int cap_row = (!kLocal && mrp >= i0 && mrp < i0 + R) ? mrp - i0 : -1;
  int32_t *hsel_row = kLocal ? nullptr : a.hsel + (size_t)p * (a.n + 1);
  if (cap_row >= 0) hsel_row[0] = (mrp + 1) * a.gap_ref;
  int32_t *prow = a.ptr + ((size_t)p * a.m + i0) * a.nc;
  // Column j + 1's ref code and H value are loaded before column j is
  // computed (and before its H store), so their latency overlaps the
  // arithmetic instead of stalling every column.
  const uint8_t *fcol = a.refs + p;
  int32_t *hcol = a.h + p;
  int f_next = fcol[0];
  int up_next = i0 == 0 ? 0 : hcol[0];  // row 0 is 0
  auto step = [&](int j, int u) {
    const int f = f_next, up = up_next;
    if (j + 1 < a.n) {
      f_next = fcol[(size_t)(j + 1) * a.b];
      if (i0 != 0) up_next = hcol[(size_t)(j + 1) * a.b];
    }
    hcol[(size_t)j * a.b] =
        column<R, kLocal, kCanon, kMat>(a, tab, vtab, s, j, u, cap_row,
                                        hsel_row, f, up);
  };
  val::for_words<kPack>(a.n, step, [&](int w, int fill) {
    val::store_words<R, 2, kCanon>(s.word, prow, a.nc, w, fill);
  });
  if (kLocal) {
    res.fold_rows(s.best, s.barg, i0);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r == cap_row) res.nw_arg = s.barg[r];
  }
}

template <bool kLocal, bool kCanon, int kMat>
__global__ void __launch_bounds__(val::kThreads) align_kernel(AlignArgs a) {
  extern __shared__ int32_t smem[];
  const int32_t *tab;
  const uint8_t *vtab;
  val::matrix_prologue<kMat>(a.table, a.valid, a.s, smem, tab, vtab);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.b) return;
  const int mrp = kLocal ? -1 : a.mrp[p];
  if (!kLocal && mrp < 0) {
    int32_t *hsel_row = a.hsel + (size_t)p * (a.n + 1);
    for (int j = 0; j <= a.n; ++j) hsel_row[j] = 0;
  }
  val::FillResult res;
  val::for_sweeps(a.m, [&](auto R, int i0) {
    sweep<decltype(R)::value, kLocal, kCanon, kMat>(a, tab, vtab, p, i0, mrp,
                                                    res);
  });
  res.write_aux(a.aux + (size_t)p * 4, kLocal);
}

}  // namespace

// Launch on `stream`; b >= 1, m >= 1, n >= 1; hsel may be null for SW.
// `table` is the (s, s) matrix already shifted << 2 and `valid` its (s,)
// validity bytes, or both null for the default DNA scoring. Returns
// cudaGetLastError().
extern "C" int val_align_launch(const void *reads, const void *refs,
                                const void *mrp, void *h, void *ptr, void *aux,
                                void *hsel, const void *table,
                                const void *valid, int b, int m, int n, int s,
                                int match, int mismatch, int gap_read,
                                int gap_ref, int local, int canonical,
                                void *stream) {
  AlignArgs a{static_cast<const uint8_t *>(reads),
              static_cast<const uint8_t *>(refs),
              static_cast<const int32_t *>(mrp),
              static_cast<int32_t *>(h),
              static_cast<int32_t *>(ptr),
              static_cast<int32_t *>(aux),
              static_cast<int32_t *>(hsel),
              static_cast<const int32_t *>(table),
              static_cast<const uint8_t *>(valid),
              b, m, n, (n + kPack - 1) / kPack, s,
              match * 4, mismatch * 4, gap_read * 4, gap_ref * 4,
              gap_ref};
  const size_t table_bytes = sizeof(int32_t) * s * s + s;
  val::dispatch(local, canonical, table, table_bytes,
                [&](auto kLocal, auto kCanon, auto kMat) {
    align_kernel<decltype(kLocal)::value, decltype(kCanon)::value,
                 decltype(kMat)::value>
        <<<val::grid_for(b), val::kThreads, kMat == 1 ? table_bytes : 0,
           static_cast<cudaStream_t>(stream)>>>(a);
  });
  return static_cast<int>(cudaGetLastError());
}
