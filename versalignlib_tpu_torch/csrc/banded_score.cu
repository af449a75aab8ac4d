// Banded best score: Smith-Waterman and the reference's semi-global
// "Needleman-Wunsch", linear or affine (Gotoh) gaps, the DNA table or an
// S x S matrix, int32 cells.
//
// Replaces versalignlib_tpu/ops/banded.py::_banded_tile_kernel and computes
// what banded_score_oracle defines over the rows it is given (the wrapper
// pads the reads to a multiple of its row tile with code 0, as
// banded_score_batch does, and those rows are part of the NW score):
// - SW: the largest cell of the band, at least 0;
// - NW: max(the last DP column over every row whose band reaches it, the
//   final row's band, 0) (banded.py:639-643).
//
// The TPU kernel packs 1024 pairs into the lanes of one block and walks a
// window of the ref in row tiles re-based through a bounce buffer. Here one
// warp takes one pair and addresses its band directly: the lanes split the
// band's columns, each row is three steps (csrc/banded.cuh), and the rows
// live in shared memory, or in device memory for a band too wide for it.
//
// What bounds it on an H100: integer operations. A cell costs its
// substitution, the recurrence and the two passes of banded.cuh, and its
// loads of the row above come from shared memory; the only bytes of size
// are the codes, read once per row and band column from the L1 cache.

#include <cstdint>
#include <cuda_runtime.h>

#include "banded.cuh"

namespace {

using valb::BandArgs;
using valb::kNeg;

template <bool kLocal, bool kAffine, int kMat>
__global__ void __launch_bounds__(valb::kWarps * 32)
    banded_score_kernel(BandArgs a, int32_t *out) {
  extern __shared__ int32_t smem[];
  const int32_t *tab;
  const uint8_t *vtab;
  val::matrix_prologue<kMat>(a.table, a.valid, a.s, smem, tab, vtab);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * valb::kWarps + warp;
  if (p >= a.b) return;
  valb::Rows r = valb::init_rows<kAffine, kMat>(a, smem, p, warp, lane);
  const uint8_t *read = a.reads + (size_t)p * a.m;
  const uint8_t *ref = a.refs + (size_t)p * a.n;
  const int k0 = min(lane * a.cols, a.band);
  const int k1 = min(k0 + a.cols, a.band);
  int best = kLocal ? 0 : kNeg;  // SW: the band maximum; NW: the last column
  int last_row = kNeg;           // NW: the final row's maximum
  int o_prev = a.offsets[0];
  for (int i = 0; i < a.m; ++i) {
    const int o = a.offsets[i];
    const int s = o - o_prev;
    o_prev = o;
    const valb::ReadCode rc = valb::read_code<kMat>(a, vtab, read[i]);
    const int acc = valb::pass_a<kLocal, kAffine, kMat>(a, tab, r, ref, rc, o, s, k0, k1);
    const int bnd = o == 0 ? 0 : kNeg;
    int x = valb::scan_entry(acc, kAffine ? bnd + a.open_read : bnd,
                             a.cols * a.gap_read, lane);
    if (lane == 0) r.h_cur[0] = bnd;
    const bool at_end = o + a.band == a.n, final_row = i == a.m - 1;
    for (int k = k0; k < k1; ++k) {
      const int t = r.h_cur[1 + k];
      int h;
      if (kAffine) {
        h = max(t, max(x + a.gap_read, kNeg));
        x = max(t + a.open_read, x + a.gap_read);
      } else {
        h = max(t, x + a.gap_read);
        x = h;
      }
      r.h_cur[1 + k] = h;
      if (kLocal) {
        best = max(best, h);
      } else {
        if (at_end && k == a.band - 1) best = max(best, h);
        if (final_row) last_row = max(last_row, h);
      }
    }
    __syncwarp();
    r.swap();
  }
  best = __reduce_max_sync(valb::kFull, best);
  if (!kLocal) best = max(max(best, __reduce_max_sync(valb::kFull, last_row)), 0);
  if (lane == 0) out[p] = best;
}

}  // namespace

// Launch on `stream`; b, m, n, band >= 1, band <= n, cols a multiple of 8
// with 32 * cols >= band, d >= the largest step of `offsets`. `scratch` is
// (b, row words) int32 or null for rows in shared memory; `table` the (s, s)
// matrix and `valid` its validity bytes, or both null for the DNA table.
// Returns cudaGetLastError().
extern "C" int val_banded_score_launch(
    const void *reads, const void *refs, const void *offsets, void *scratch,
    const void *table, const void *valid, void *out, int b, int m, int n,
    int band, int d, int cols, int s, int match, int mismatch, int gap_read,
    int gap_ref, int open_read, int open_ref, int local, int affine,
    void *stream) {
  BandArgs a{static_cast<const uint8_t *>(reads),
             static_cast<const uint8_t *>(refs),
             static_cast<const int32_t *>(offsets),
             static_cast<int32_t *>(scratch),
             static_cast<const int32_t *>(table),
             static_cast<const uint8_t *>(valid),
             b, m, n, band, d, cols, s,
             match, mismatch, gap_read, gap_ref, open_read, open_ref};
  const size_t table_bytes = sizeof(int32_t) * s * s + s;
  val::dispatch(local, affine, table, table_bytes,
                [&](auto kLocal, auto kAffine, auto kMat) {
    auto kernel = banded_score_kernel<decltype(kLocal)::value,
                                      decltype(kAffine)::value,
                                      decltype(kMat)::value>;
    const size_t smem = valb::shared_bytes(kernel, a, decltype(kAffine)::value,
                                           decltype(kMat)::value == 1);
    kernel<<<valb::grid_for(b), valb::kWarps * 32, smem,
             static_cast<cudaStream_t>(stream)>>>(a, static_cast<int32_t *>(out));
  });
  return static_cast<int>(cudaGetLastError());
}
