// Linear-gap pointer fill: Smith-Waterman and the reference's semi-global
// "Needleman-Wunsch", default DNA scoring, both tie-break flavors, int32
// cells.
//
// Replaces versalignlib_tpu/ops/pallas_align.py::_align_kernel and writes
// what that kernel writes, in the layout the host decoder reads:
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
//   only when both symbols are A/C/G/T: an invalid DIAG gets priority 0, so
//   if it is strictly best the cell is START, and if it only ties it loses
//   to LEFT or UP. SW clamps with 0 and has no zero-force.
//
// What bounds it on an H100: integer operations (about sixteen per cell)
// well ahead of bytes (the pointer words, 2 bits per cell, are the only
// output of size). The design is the score kernel's: one thread per pair,
// pair-interleaved (len, b) uint8 codes, kRows read rows advancing together
// with their state in registers, the rolling H row in an (n, b) int32
// scratch touched once per kRows cells, the next column's loads issued
// before the current column is computed. Each thread keeps one word per row
// in a register and stores it when its 16 columns are done, so every pointer
// word is written once. With one thread per pair, a batch of 4096 pairs is
// one warp per SM, and the time is one warp's instruction latency (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;  // read rows per sweep (register wavefront)
constexpr int kThreads = 32;  // one warp per block
constexpr int kPack = 16;  // 2-bit codes per int32 word

struct AlignArgs {
  const uint8_t *reads;  // (m, b) codes
  const uint8_t *refs;   // (n, b) codes
  const int32_t *mrp;    // (b,) last valid read row
  int32_t *h;            // (n, b) rolling H row (shifted), columns 1..n
  int32_t *ptr;          // (b, m, nc)
  int32_t *aux;          // (b, 4)
  int32_t *hsel;         // (b, n + 1), NW only
  int b, m, n, nc;
  int match4, mismatch4, gap_read4, gap_ref4;  // scores << 2
  int gap_ref;
};

// Per-row state of one sweep; arrays indexed by unrolled loops stay in
// registers.
template <int R>
struct Rows {
  int rc[R], rmask[R], rv3[R];
  int left[R], diag[R], best[R], barg[R];
  uint32_t word[R];
};

// Column j (ref code f, H value above the sweep up) for all R rows; u is the
// field of j in its word. Returns the H value of the sweep's last row.
template <int R, bool kLocal, bool kCanon>
__device__ __forceinline__ int column(const AlignArgs &a, Rows<R> &s, int j,
                                      int u, int cap_row, int32_t *hsel_row,
                                      int f, int up) {
  const bool fvalid = f >= 1 && f <= 4;
  const int fc = fvalid ? f : -1;
  const int fbase = fvalid ? a.mismatch4 : 0;
  const int fvm = fvalid ? -1 : 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int sub = (s.rc[r] == fc ? a.match4 : fbase) & s.rmask[r];
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

template <int R, bool kCanon>
__device__ __forceinline__ void store_words(const AlignArgs &a, Rows<R> &s,
                                            int32_t *prow, int w, int fill) {
  const uint32_t even = 0x55555555u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t v = s.word[r];
    if (kCanon) {
      v = ((~v & even) << 1) | (((v >> 1) ^ v) & even);
      // Unfilled fields would read LEFT after the shuffle; they must be START.
      if (fill < kPack) v &= (1u << (2 * fill)) - 1u;
    }
    prow[(size_t)r * a.nc + w] = static_cast<int32_t>(v);
    s.word[r] = 0;
  }
}

// Sweep R read rows [i0, i0 + R) across all n columns for pair p, then fold
// the rows' maxima into the pair's running result in row order.
template <int R, bool kLocal, bool kCanon>
__device__ __forceinline__ void sweep(const AlignArgs &a, int p, int i0,
                                      int mrp, int &gbest, int &gi, int &gj,
                                      int &garg) {
  Rows<R> s;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = a.reads[(size_t)(i0 + r) * a.b + p];
    const bool valid = c >= 1 && c <= 4;
    s.rc[r] = valid ? c : -2;
    s.rmask[r] = valid ? -1 : 0;
    s.rv3[r] = valid ? 3 : 0;
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
        column<R, kLocal, kCanon>(a, s, j, u, cap_row, hsel_row, f, up);
  };
  const int full = a.n / kPack;
  for (int w = 0; w < full; ++w) {
#pragma unroll
    for (int u = 0; u < kPack; ++u) step(w * kPack + u, u);
    store_words<R, kCanon>(a, s, prow, w, kPack);
  }
  const int fill = a.n - full * kPack;
  if (fill) {
    for (int u = 0; u < fill; ++u) step(full * kPack + u, u);
    store_words<R, kCanon>(a, s, prow, full, fill);
  }
  if (kLocal) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (s.best[r] > gbest) {
        gbest = s.best[r];
        gi = i0 + r;
        gj = s.barg[r];
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r == cap_row) garg = s.barg[r];
  }
}

template <bool kLocal, bool kCanon>
__global__ void __launch_bounds__(kThreads) align_kernel(AlignArgs a) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.b) return;
  const int mrp = kLocal ? -1 : a.mrp[p];
  if (!kLocal && mrp < 0) {
    int32_t *hsel_row = a.hsel + (size_t)p * (a.n + 1);
    for (int j = 0; j <= a.n; ++j) hsel_row[j] = 0;
  }
  int gbest = 0, gi = 0, gj = 0, garg = 0;
  int i0 = 0;
  for (; i0 + kRows <= a.m; i0 += kRows)
    sweep<kRows, kLocal, kCanon>(a, p, i0, mrp, gbest, gi, gj, garg);
  for (; i0 < a.m; ++i0)
    sweep<1, kLocal, kCanon>(a, p, i0, mrp, gbest, gi, gj, garg);
  int32_t *aux = a.aux + (size_t)p * 4;
  if (kLocal) {
    aux[0] = gbest >> 2;
    aux[1] = gi;
    aux[2] = gj;
  } else {
    aux[0] = garg;
    aux[1] = 0;
    aux[2] = 0;
  }
  aux[3] = 0;
}

template <bool kLocal>
void launch(const AlignArgs &a, bool canonical, cudaStream_t s) {
  const dim3 grid((a.b + kThreads - 1) / kThreads);
  if (canonical)
    align_kernel<kLocal, true><<<grid, kThreads, 0, s>>>(a);
  else
    align_kernel<kLocal, false><<<grid, kThreads, 0, s>>>(a);
}

}  // namespace

// Launch on `stream`; b >= 1, m >= 1, n >= 1; hsel may be null for SW.
// Returns cudaGetLastError().
extern "C" int val_align_launch(const void *reads, const void *refs,
                                const void *mrp, void *h, void *ptr, void *aux,
                                void *hsel, int b, int m, int n, int match,
                                int mismatch, int gap_read, int gap_ref,
                                int local, int canonical, void *stream) {
  AlignArgs a{static_cast<const uint8_t *>(reads),
              static_cast<const uint8_t *>(refs),
              static_cast<const int32_t *>(mrp),
              static_cast<int32_t *>(h),
              static_cast<int32_t *>(ptr),
              static_cast<int32_t *>(aux),
              static_cast<int32_t *>(hsel),
              b, m, n, (n + kPack - 1) / kPack,
              match * 4, mismatch * 4, gap_read * 4, gap_ref * 4,
              gap_ref};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (local)
    launch<true>(a, canonical != 0, s);
  else
    launch<false>(a, canonical != 0, s);
  return static_cast<int>(cudaGetLastError());
}
