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
// What bounds it on an H100: integer operations. The cell loop costs 10 /
// 8 int32 operations per SW / NW cell with linear gaps and DNA scoring, 14
// / 12 with affine gaps, two fewer with a matrix
// (chip_smoke.ops_per_cell), and a cell moves no bytes of its own: the
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
// The sweep and the recurrence are common.cuh's val::score_pair; this
// source keeps how a cell finds its substitution score (DnaSub,
// MatrixSub).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using val::lookup;

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

// Default DNA scoring for val::score_sweep: codes 1..4 match or mismatch,
// and 0 (padding) and 5 (N) score 0 on either side. `reads` and `refs`
// point at the pair's first code, stride b.
struct DnaSub {
  const uint8_t *reads, *refs;
  int b, match, mismatch;
  struct Row {
    int code, mask;
  };
  struct Col {
    int code, base;
  };
  __device__ Row row(int i) const {
    const int c = reads[(size_t)i * b];
    const bool valid = c >= 1 && c <= 4;
    // -2 never equals a ref sentinel (-1); the mask zeroes N / padding.
    return {valid ? c : -2, valid ? -1 : 0};
  }
  __device__ int load(int j) const { return refs[(size_t)j * b]; }
  __device__ Col col(int f) const {
    const bool valid = f >= 1 && f <= 4;
    return {valid ? f : -1, valid ? mismatch : 0};
  }
  __device__ int score(Row r, Col c) const {
    return (r.code == c.code ? match : c.base) & r.mask;
  }
};

// S x S matrix scoring for val::score_sweep, table[read][ref], codes >= S
// read as code 0: each row's base (code * S) is found once per sweep and
// each column's code once, so a cell pays one add and one lookup.
template <int kMat>
struct MatrixSub {
  const uint8_t *reads, *refs;
  const int32_t *tab;
  int b, s;
  using Row = int;
  using Col = int;
  __device__ int row(int i) const {
    const int c = reads[(size_t)i * b];
    return (c < s ? c : 0) * s;
  }
  __device__ int load(int j) const { return refs[(size_t)j * b]; }
  __device__ int col(int f) const { return f < s ? f : 0; }
  __device__ int score(int r, int c) const { return lookup<kMat>(tab, r + c); }
};

template <bool kLocal, bool kAffine, int kMat>
__global__ void __launch_bounds__(val::kThreads) score_kernel(ScoreArgs a) {
  extern __shared__ int32_t smem[];
  const int32_t *tab;
  const uint8_t *unused;
  val::matrix_prologue<kMat>(a.table, nullptr, a.s, smem, tab, unused);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.b) return;
  const val::Gaps g{a.gap_read, a.gap_ref, a.open_read, a.open_ref};
  const auto run = [&](const auto &sub) {
    return val::score_pair<kLocal, kAffine>(sub, g, a.m, a.n, a.h + p,
                                            kAffine ? a.f + p : nullptr, a.b);
  };
  if constexpr (kMat != 0) {
    a.out[p] = run(MatrixSub<kMat>{a.reads + p, a.refs + p, tab, a.b, a.s});
  } else {
    a.out[p] = run(DnaSub{a.reads + p, a.refs + p, a.b, a.match, a.mismatch});
  }
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
