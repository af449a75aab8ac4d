// Batched best-score kernel: Smith-Waterman and the reference's semi-global
// "Needleman-Wunsch", linear gaps, default DNA scoring, int32 cells.
//
// Replaces versalignlib_tpu/ops/pallas_score.py::_score_kernel (the TPU's
// interpair kernel, 1024 pairs per (8, 128) register tile) for the linear,
// default-scoring branch. Semantics are the JAX kernel's: codes 1..4 are
// A/T/C/G, and code 0 (padding) and 5 (N) score 0 on either side
// (make_sub_fn, pallas_score.py:104-126). SW returns the local maximum
// seeded at 0. NW returns the overlap score: the maximum over the last column
// of every row and over the whole final row, clamped at 0; on this score
// path column 0 is 0 (pallas_score.py:284,349-368), unlike the traceback
// path's (i+1)*gap_ref.
//
// What bounds it on an H100: integer operations. A cell costs about eight
// int32 operations (substitution select, three adds, three maxes, the
// running best) and moves no bytes of its own: the inputs are m + n bytes per
// pair and the output 4 bytes. The design keeps the DP out of device memory:
// - one thread per pair; every dependency of the recurrence stays inside a
//   pair, so threads never talk to each other;
// - codes arrive pair-interleaved, (len, b) uint8, so a warp's 32 threads
//   read 32 neighbouring bytes;
// - kRows read rows advance together down each column with their left and
//   diagonal values in registers, so the rolling H row, an (n, b) int32
//   scratch in device memory (it mostly stays in the 50 MB L2), is read and
//   written once per kRows cells instead of once per cell;
// - the next column's H value and ref code are loaded before the current
//   column is computed, so a warp does not wait out an L2 round trip per
//   column (with 16 rows and this prefetch, 2.4x faster than 8 rows without
//   it at 16384 pairs; PERF.md);
// - blocks are one warp, so a batch of b pairs gives b / 32 blocks to spread
//   over the 132 SMs (larger blocks measured no faster; PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;  // read rows per sweep (register wavefront)
constexpr int kThreads = 32;  // one warp per block

struct ScoreArgs {
  const uint8_t *reads;  // (m, b) codes
  const uint8_t *refs;   // (n, b) codes
  int32_t *h;            // (n, b) rolling H row, columns 1..n
  int32_t *out;          // (b,) best score per pair
  int b, m, n;
  int match, mismatch, gap_read, gap_ref;
};

// One sweep of R read rows [i0, i0 + R) across all n columns for pair p.
template <int R, bool kLocal>
__device__ __forceinline__ void sweep(const ScoreArgs &a, int p, int i0,
                                      int32_t &best) {
  int rc[R], rmask[R], left[R], diag[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = a.reads[(size_t)(i0 + r) * a.b + p];
    const bool valid = c >= 1 && c <= 4;
    rc[r] = valid ? c : -2;      // -2 never equals a ref sentinel (-1)
    rmask[r] = valid ? -1 : 0;   // zeroes the substitution of N / padding
    left[r] = 0;                 // H[i0 + r + 1][0] = 0 on the score path
    diag[r] = 0;
  }
  // Column j + 1's ref code and H value are loaded before column j is
  // computed (and before its H store), so their latency overlaps the
  // arithmetic instead of stalling every column.
  const uint8_t *fcol = a.refs + p;
  int32_t *hcol = a.h + p;
  int f_next = fcol[0];
  int up_next = i0 == 0 ? 0 : hcol[0];  // row 0 is 0
  for (int j = 0; j < a.n; ++j) {
    const int f = f_next;
    int up = up_next;
    if (j + 1 < a.n) {
      f_next = fcol[(size_t)(j + 1) * a.b];
      if (i0 != 0) up_next = hcol[(size_t)(j + 1) * a.b];
    }
    const bool fvalid = f >= 1 && f <= 4;
    const int fc = fvalid ? f : -1;
    const int fbase = fvalid ? a.mismatch : 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = (rc[r] == fc ? a.match : fbase) & rmask[r];
      int l_in = left[r] + a.gap_read;
      if (kLocal) l_in = max(l_in, 0);
      const int cur = max(max(diag[r] + s, up + a.gap_ref), l_in);
      if (kLocal) best = max(best, cur);
      diag[r] = up;
      left[r] = cur;
      up = cur;
    }
    hcol[(size_t)j * a.b] = up;
  }
  if (!kLocal) {
    // NW: the last column of every row (DefaultKernel.cpp:177).
#pragma unroll
    for (int r = 0; r < R; ++r) best = max(best, left[r]);
  }
}

template <bool kLocal>
__global__ void __launch_bounds__(kThreads) score_kernel(ScoreArgs a) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.b) return;
  int32_t best = 0;  // the SW seed, and the NW clamp at 0
  int i0 = 0;
  for (; i0 + kRows <= a.m; i0 += kRows) sweep<kRows, kLocal>(a, p, i0, best);
  for (; i0 < a.m; ++i0) sweep<1, kLocal>(a, p, i0, best);
  if (!kLocal) {
    // NW: ... and the whole final row (DefaultKernel.cpp:189-191); its
    // column 0 is 0, which the seed covers.
    for (int j = 0; j < a.n; ++j) best = max(best, a.h[(size_t)j * a.b + p]);
  }
  a.out[p] = best;
}

}  // namespace

// Launch on `stream`; b >= 1, m >= 1, n >= 1. Returns cudaGetLastError().
extern "C" int val_score_launch(const void *reads, const void *refs, void *h,
                                void *out, int b, int m, int n, int match,
                                int mismatch, int gap_read, int gap_ref,
                                int local, void *stream) {
  ScoreArgs a{static_cast<const uint8_t *>(reads),
              static_cast<const uint8_t *>(refs),
              static_cast<int32_t *>(h),
              static_cast<int32_t *>(out),
              b, m, n, match, mismatch, gap_read, gap_ref};
  const dim3 grid((b + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (local)
    score_kernel<true><<<grid, kThreads, 0, s>>>(a);
  else
    score_kernel<false><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
