// Batched best-score kernel: Smith-Waterman and the reference's semi-global
// "Needleman-Wunsch", linear or affine (Gotoh) gaps, default DNA scoring or
// an S x S substitution matrix, int32 cells.
//
// Replaces versalignlib_tpu/ops/pallas_score.py::_score_kernel (the TPU's
// interpair kernel, 1024 pairs per (8, 128) register tile), all branches.
// Semantics are the JAX kernel's:
// - default scoring: codes 1..4 are A/T/C/G, and code 0 (padding) and 5 (N)
//   score 0 on either side (make_sub_fn, pallas_score.py:104-126);
// - matrix scoring: table[read][ref], codes >= S read as code 0, whose row
//   and column are 0 (pallas_score.py:128-212);
// - affine gaps: F = max(up + open_ref, F_up) + gap_ref flows down each
//   column, E = max(left + open_read, E) + gap_read along each row, both
//   starting at -inf (NEG_INF_I32 = -(2**30)), and SW folds its zero clamp
//   into E (pallas_score.py:294-316).
// SW returns the local maximum seeded at 0. NW returns the overlap score: the
// maximum over the last column of every row and over the whole final row,
// clamped at 0; on this score path column 0 is 0 (pallas_score.py:284,
// 349-368), unlike the traceback path's.
//
// What bounds it on an H100: integer operations. The recurrence costs 8
// int32 operations per SW cell with linear gaps and 12 with affine gaps
// (chip_smoke.OPS_PER_CELL), and a cell moves no bytes of its own: the
// inputs are m + n bytes per pair and the output 4 bytes. The design keeps
// the DP out of device memory:
// - one thread per pair; every dependency of the recurrence stays inside a
//   pair, so threads never talk to each other;
// - codes arrive pair-interleaved, (len, b) uint8, so a warp's 32 threads
//   read 32 neighbouring bytes;
// - kRows read rows advance together down each column with their left and
//   diagonal values (and E) in registers, so the rolling H row (and F row),
//   (n, b) int32 scratch in device memory that mostly stays in the 50 MB L2,
//   is read and written once per kRows cells instead of once per cell;
// - the next column's H (and F) value and ref code are loaded before the
//   current column is computed, so a warp does not wait out an L2 round trip
//   per column (with 16 rows and this prefetch, 2.4x faster than 8 rows
//   without it at 16384 pairs; PERF.md);
// - a matrix lives in shared memory, where a lookup is one load: each row's
//   base (code * S) is computed once per sweep and each column's code once,
//   so a cell pays one add and one shared load. A table too large for the
//   48 KB of static shared memory is read from device memory through the
//   read-only cache instead (kMat 2);
// - blocks are one warp, so a batch of b pairs gives b / 32 blocks to spread
//   over the 132 SMs (larger blocks measured no faster; PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using val::lookup;
constexpr int kNegInf = -(1 << 30);  // pallas_score.NEG_INF_I32

struct ScoreArgs {
  const uint8_t *reads;  // (m, b) codes
  const uint8_t *refs;   // (n, b) codes
  int32_t *h;            // (n, b) rolling H row, columns 1..n
  int32_t *f;            // (n, b) rolling Gotoh F row (affine only)
  int32_t *out;          // (b,) best score per pair
  const int32_t *table;  // (s, s) substitution matrix (matrix modes only)
  int b, m, n, s;
  int match, mismatch, gap_read, gap_ref, open_read, open_ref;
};

// One sweep of R read rows [i0, i0 + R) across all n columns for pair p.
template <int R, bool kLocal, bool kAffine, int kMat>
__device__ __forceinline__ void sweep(const ScoreArgs &a, const int32_t *tab,
                                      int p, int i0, int32_t &best) {
  int rc[R], rmask[R], left[R], diag[R], e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = a.reads[(size_t)(i0 + r) * a.b + p];
    if (kMat) {
      rc[r] = (c < a.s ? c : 0) * a.s;  // the row's base in the table
    } else {
      const bool valid = c >= 1 && c <= 4;
      rc[r] = valid ? c : -2;      // -2 never equals a ref sentinel (-1)
      rmask[r] = valid ? -1 : 0;   // zeroes the substitution of N / padding
    }
    left[r] = 0;                 // H[i0 + r + 1][0] = 0 on the score path
    diag[r] = 0;
    e[r] = kNegInf;
  }
  // Column j + 1's ref code and H (and F) value are loaded before column j
  // is computed (and before its stores), so their latency overlaps the
  // arithmetic instead of stalling every column.
  const uint8_t *fcol = a.refs + p;
  int32_t *hcol = a.h + p;
  int32_t *fscol = kAffine ? a.f + p : nullptr;
  int f_next = fcol[0];
  int up_next = i0 == 0 ? 0 : hcol[0];  // row 0 is 0
  int fup_next = kAffine ? (i0 == 0 ? kNegInf : fscol[0]) : 0;
  for (int j = 0; j < a.n; ++j) {
    const int f = f_next;
    int up = up_next;
    int f_up = fup_next;
    if (j + 1 < a.n) {
      f_next = fcol[(size_t)(j + 1) * a.b];
      if (i0 != 0) {
        up_next = hcol[(size_t)(j + 1) * a.b];
        if (kAffine) fup_next = fscol[(size_t)(j + 1) * a.b];
      }
    }
    int fc, fbase = 0;
    if (kMat) {
      fc = f < a.s ? f : 0;
    } else {
      const bool fvalid = f >= 1 && f <= 4;
      fc = fvalid ? f : -1;
      fbase = fvalid ? a.mismatch : 0;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = kMat ? lookup<kMat>(tab, rc[r] + fc)
                         : (rc[r] == fc ? a.match : fbase) & rmask[r];
      int cur;
      if (kAffine) {
        // max(a + c, b + c) == max(a, b) + c: one add per gap arm.
        const int f_val = max(up + a.open_ref, f_up) + a.gap_ref;
        const int e_val = max(left[r] + a.open_read, e[r]) + a.gap_read;
        const int e_in = kLocal ? max(e_val, 0) : e_val;
        cur = max(max(diag[r] + s, f_val), e_in);
        e[r] = e_val;
        f_up = f_val;
      } else {
        int l_in = left[r] + a.gap_read;
        if (kLocal) l_in = max(l_in, 0);
        cur = max(max(diag[r] + s, up + a.gap_ref), l_in);
      }
      if (kLocal) best = max(best, cur);
      diag[r] = up;
      left[r] = cur;
      up = cur;
    }
    hcol[(size_t)j * a.b] = up;
    if (kAffine) fscol[(size_t)j * a.b] = f_up;
  }
  if (!kLocal) {
    // NW: the last column of every row (DefaultKernel.cpp:177).
#pragma unroll
    for (int r = 0; r < R; ++r) best = max(best, left[r]);
  }
}

template <bool kLocal, bool kAffine, int kMat>
__global__ void __launch_bounds__(val::kThreads) score_kernel(ScoreArgs a) {
  extern __shared__ int32_t smem[];
  const int32_t *tab;
  const uint8_t *unused;
  val::matrix_prologue<kMat>(a.table, nullptr, a.s, smem, tab, unused);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.b) return;
  int32_t best = 0;  // the SW seed, and the NW clamp at 0
  val::for_sweeps(a.m, [&](auto R, int i0) {
    sweep<decltype(R)::value, kLocal, kAffine, kMat>(a, tab, p, i0, best);
  });
  if (!kLocal) {
    // NW: ... and the whole final row (DefaultKernel.cpp:189-191); its
    // column 0 is 0, which the seed covers.
    for (int j = 0; j < a.n; ++j) best = max(best, a.h[(size_t)j * a.b + p]);
  }
  a.out[p] = best;
}

}  // namespace

// Launch on `stream`; b >= 1, m >= 1, n >= 1. `f` is the (n, b) F scratch
// when affine, else unused; `table` is the (s, s) matrix, or null for the
// default DNA scoring. Returns cudaGetLastError().
extern "C" int val_score_launch(const void *reads, const void *refs, void *h,
                                void *f, void *out, const void *table, int b,
                                int m, int n, int s, int match, int mismatch,
                                int gap_read, int gap_ref, int open_read,
                                int open_ref, int local, int affine,
                                void *stream) {
  ScoreArgs a{static_cast<const uint8_t *>(reads),
              static_cast<const uint8_t *>(refs),
              static_cast<int32_t *>(h),
              static_cast<int32_t *>(f),
              static_cast<int32_t *>(out),
              static_cast<const int32_t *>(table),
              b, m, n, s, match, mismatch, gap_read, gap_ref, open_read,
              open_ref};
  const size_t table_bytes = sizeof(int32_t) * s * s;
  val::dispatch(local, affine, table, table_bytes,
                [&](auto kLocal, auto kAffine, auto kMat) {
    score_kernel<decltype(kLocal)::value, decltype(kAffine)::value,
                 decltype(kMat)::value>
        <<<val::grid_for(b), val::kThreads, kMat == 1 ? table_bytes : 0,
           static_cast<cudaStream_t>(stream)>>>(a);
  });
  return static_cast<int>(cudaGetLastError());
}
