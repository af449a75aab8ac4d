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
// design is align.cu's, with the scaffolding of common.cuh: one thread per
// pair, pair-interleaved (len, b) uint8 codes, kRows read rows advancing
// together with their state (left, diag, E) in registers, the rolling H and
// F rows in (n, b) int32 scratch touched once per kRows cells, the next
// column's loads issued before the current column is computed, one register
// word per row stored when its 8 columns are done, and a matrix with its
// validity bytes in shared memory (or, when too large, read through the read-only
// cache). E adds a register per row to align.cu's state, so two kinds of
// state are cut to keep 16 rows out of local memory (the first build of the
// NW SSE instantiation used 255 registers and spilled): NW keeps the running
// maximum of row mrp alone, the only row whose argmax it reports, instead of
// one per row; and with default scoring the SSE DIAG gate reuses the read
// row's validity mask instead of a register of its own.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using val::lookup;
constexpr int kPack = 8;  // 4-bit codes per int32 word
constexpr int kNegInf = -(1 << 30);  // pallas_score.NEG_INF_I32, shifted -inf

struct AffineArgs {
  const uint8_t *reads;  // (m, b) codes
  const uint8_t *refs;   // (n, b) codes
  const int32_t *mrp;    // (b,) last valid read row
  int32_t *h;            // (n, b) rolling H row (shifted), columns 1..n
  int32_t *f;            // (n, b) rolling F row (shifted), columns 1..n
  int32_t *ptr;          // (b, m, nc)
  int32_t *aux;          // (b, 4)
  int32_t *hsel;         // (b, n + 1), NW only
  const int32_t *table;  // (s, s) matrix << 2 (matrix modes only)
  const uint8_t *valid;  // (s,) SSE validity per code (matrix modes only)
  int b, m, n, nc, s;
  int match4, mismatch4;                   // scores << 2
  int ext_read4, ext_ref4, open_read4, open_ref4;
  int ext_ref, open_ref;
};

// Per-row state of one sweep; arrays indexed by unrolled loops stay in
// registers. Under a matrix, rc is the row's base (code * S) in the table
// and rv3 its SSE DIAG priority; with default scoring rmask serves both.
// best / barg: each row's running maximum (SW), or (NW, in cbest / carg)
// that of row mrp alone.
template <int R>
struct Rows {
  int rc[R], rmask[R], rv3[R];
  int left[R], diag[R], e[R], best[R], barg[R];
  int cbest, carg;
  uint32_t word[R];
};

// Column j (ref code f, H and F values above the sweep up, f_up) for all R
// rows; u is the field of j in its word. Returns the H value of the sweep's
// last row and leaves its F value in f_up.
template <int R, bool kLocal, bool kCanon, int kMat>
__device__ __forceinline__ int column(const AffineArgs &a, const int32_t *tab,
                                      const uint8_t *vtab, Rows<R> &s, int j,
                                      int u, int cap_row, int32_t *hsel_row,
                                      int f, int up, int &f_up) {
  int fc, fbase = 0, fvm;
  if (kMat) {
    fc = f < a.s ? f : 0;
    fvm = (kCanon || lookup<kMat>(vtab, fc)) ? -1 : 0;
  } else {
    const bool fvalid = f >= 1 && f <= 4;
    fc = fvalid ? f : -1;
    fbase = fvalid ? a.mismatch4 : 0;
    fvm = fvalid ? 3 : 0;  // with rmask: DIAG priority 3 when both are valid
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int sub = kMat ? lookup<kMat>(tab, s.rc[r] + fc)
                         : (s.rc[r] == fc ? a.match4 : fbase) & s.rmask[r];
    const int f_pre = max(up + a.open_ref4, f_up);
    const int f_val = f_pre + a.ext_ref4;
    const int e_pre = max(s.left[r] + a.open_read4, s.e[r]);
    const int e_val = e_pre + a.ext_read4;
    const int diag_v = s.diag[r] + sub;
    int cur_p;
    if (kCanon) {
      cur_p = max(max(diag_v | 2, f_val | 1), e_val);
      if (kLocal) cur_p = max(cur_p, 3);
    } else {
      const int dprio = (kMat ? s.rv3[r] : s.rmask[r]) & fvm;
      cur_p = max(max(diag_v | dprio, e_val | 2), f_val | 1);
      if (kLocal) cur_p = max(cur_p, 0);
    }
    const int cur = cur_p & ~3;
    const uint32_t code = static_cast<uint32_t>(cur_p & 3) |
                          (e_pre == s.e[r] ? 4u : 0u) |
                          (f_pre == f_up ? 8u : 0u);
    s.word[r] |= code << (4 * u);
    if (kLocal) {
      if (cur > s.best[r]) {  // strict: the leftmost maximum wins
        s.best[r] = cur;
        s.barg[r] = j;
      }
    } else if (r == cap_row) {
      if (cur > s.cbest) {
        s.cbest = cur;
        s.carg = j;
      }
      hsel_row[j + 1] = cur >> 2;
    }
    s.diag[r] = up;
    s.left[r] = cur;
    s.e[r] = e_val;
    up = cur;
    f_up = f_val;
  }
  return up;
}

// Sweep R read rows [i0, i0 + R) across all n columns for pair p, then fold
// the rows' maxima into the pair's running result in row order.
template <int R, bool kLocal, bool kCanon, int kMat>
__device__ __forceinline__ void sweep(const AffineArgs &a, const int32_t *tab,
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
    }
    // Column 0: 0 for SW; the Gotoh boundary H[k][0] = open_ref + k*gap_ref
    // for NW (k >= 1; H[0][0] = 0), pallas_align.py:803-810.
    const int k = i0 + r + 1;
    s.left[r] = kLocal ? 0 : a.open_ref4 + k * a.ext_ref4;
    s.diag[r] = (kLocal || k == 1) ? 0 : a.open_ref4 + (k - 1) * a.ext_ref4;
    s.e[r] = kNegInf;
    s.best[r] = 0;
    s.barg[r] = 0;
    s.word[r] = 0;
  }
  const int cap_row = (!kLocal && mrp >= i0 && mrp < i0 + R) ? mrp - i0 : -1;
  // NW: row mrp's maximum is seeded by its column-0 value at index 0.
  s.cbest = cap_row >= 0 ? a.open_ref4 + (mrp + 1) * a.ext_ref4 : 0;
  s.carg = 0;
  int32_t *hsel_row = kLocal ? nullptr : a.hsel + (size_t)p * (a.n + 1);
  if (cap_row >= 0) hsel_row[0] = a.open_ref + (mrp + 1) * a.ext_ref;
  int32_t *prow = a.ptr + ((size_t)p * a.m + i0) * a.nc;
  // Column j + 1's ref code, H and F values are loaded before column j is
  // computed (and before its stores), so their latency overlaps the
  // arithmetic instead of stalling every column.
  const uint8_t *fcol = a.refs + p;
  int32_t *hcol = a.h + p;
  int32_t *fscol = a.f + p;
  int f_next = fcol[0];
  int up_next = i0 == 0 ? 0 : hcol[0];  // row 0: H is 0, F is -inf
  int fup_next = i0 == 0 ? kNegInf : fscol[0];
  auto step = [&](int j, int u) {
    const int f = f_next, up = up_next;
    int f_up = fup_next;
    if (j + 1 < a.n) {
      f_next = fcol[(size_t)(j + 1) * a.b];
      if (i0 != 0) {
        up_next = hcol[(size_t)(j + 1) * a.b];
        fup_next = fscol[(size_t)(j + 1) * a.b];
      }
    }
    hcol[(size_t)j * a.b] = column<R, kLocal, kCanon, kMat>(
        a, tab, vtab, s, j, u, cap_row, hsel_row, f, up, f_up);
    fscol[(size_t)j * a.b] = f_up;
  };
  val::for_words<kPack>(a.n, step, [&](int w, int fill) {
    val::store_words<R, 4, kCanon>(s.word, prow, a.nc, w, fill);
  });
  if (kLocal) res.fold_rows(s.best, s.barg, i0);
  else if (cap_row >= 0) res.nw_arg = s.carg;
}

template <bool kLocal, bool kCanon, int kMat>
__global__ void __launch_bounds__(val::kThreads) affine_kernel(AffineArgs a) {
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
// `h` and `f` are (n, b) int32 scratch. `table` is the (s, s) matrix
// already shifted << 2 and `valid` its (s,) validity bytes, or both null for
// the default DNA scoring. Returns cudaGetLastError().
extern "C" int val_align_affine_launch(
    const void *reads, const void *refs, const void *mrp, void *h, void *f,
    void *ptr, void *aux, void *hsel, const void *table, const void *valid,
    int b, int m, int n, int s, int match, int mismatch, int gap_read,
    int gap_ref, int open_read, int open_ref, int local, int canonical,
    void *stream) {
  AffineArgs a{static_cast<const uint8_t *>(reads),
               static_cast<const uint8_t *>(refs),
               static_cast<const int32_t *>(mrp),
               static_cast<int32_t *>(h),
               static_cast<int32_t *>(f),
               static_cast<int32_t *>(ptr),
               static_cast<int32_t *>(aux),
               static_cast<int32_t *>(hsel),
               static_cast<const int32_t *>(table),
               static_cast<const uint8_t *>(valid),
               b, m, n, (n + kPack - 1) / kPack, s,
               match * 4, mismatch * 4,
               gap_read * 4, gap_ref * 4, open_read * 4, open_ref * 4,
               gap_ref, open_ref};
  const size_t table_bytes = sizeof(int32_t) * s * s + s;
  val::dispatch(local, canonical, table, table_bytes,
                [&](auto kLocal, auto kCanon, auto kMat) {
    affine_kernel<decltype(kLocal)::value, decltype(kCanon)::value,
                  decltype(kMat)::value>
        <<<val::grid_for(b), val::kThreads, kMat == 1 ? table_bytes : 0,
           static_cast<cudaStream_t>(stream)>>>(a);
  });
  return static_cast<int>(cudaGetLastError());
}
