// Traceback walk over the banded fill's pointer words (banded_align.cu):
// linear gaps (2-bit codes) and Gotoh gaps (4-bit codes hptr | e_ext<<2 |
// f_ext<<3), 8 a word, band-relative: field k of row i is ref column
// offsets[i] + k. SW and the reference's semi-global NW.
//
// Replaces versalignlib_tpu/ops/walk.py::walk_blocks_banded (:324, linear)
// and ::walk_blocks_banded_affine (:413, Gotoh) with wbase = offsets (the
// port's rows are a window whose base is the band start, so the band's low
// edge is field 0), and writes what they return: records (b, m) int32, one
// left_count*4 | exit_code a row, 0 outside the walk; ends (3, b) int32,
// the start row, start column and score. The start cell is derived here
// (walk.py:297-320): SW the fill's best registers; NW row mrp and the first
// maximum of keep over the in-band window [o, min(o + band, n, mxp + 1))
// of that row, (-1, -1, 0) when mrp < 0 or the window is empty. Leaving
// the band on either edge is a hard stop with a START record: a row
// entered out of band stops before any LEFT, and a LEFT run (or E chain)
// that reaches the band's low edge emits down to it and stops. The Gotoh
// states are kept as in walk.cu.
//
// What bounds it on an H100: the latency of one dependent load a row (see
// walk.cu); at 16 kbp that is 16,000 loads in a chain a pair. The bytes are
// the records and one 32-byte sector of pointer words a visited row. The
// design is a thread per pair, as walk.cu; a launch of 1024 pairs is 32
// warps, so the card's latency is hidden only across pairs, not rows.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk.cuh"

namespace walk {

struct BandedArgs {
  const int32_t *ptr;      // (b, m, nw) band-relative pointer words
  const int32_t *best;     // (b, 4) SW [score, row, column, 0]
  const int32_t *keep;     // (b, band) NW: the H row of row mrp, band-relative
  const int32_t *mrp;      // (b,) last valid read row, NW only
  const int32_t *mxp;      // (b,) last valid ref column, NW only
  const int32_t *offsets;  // (m,) band start column of each row
  int32_t *records;        // (b, m)
  int32_t *ends;           // (3, b): start row, start column, score
  int b, m, n, band, nw;
};

}  // namespace walk

namespace {

template <bool kLocal, bool kAffine>
__global__ void __launch_bounds__(walk::kThreads) banded_walk_kernel(walk::BandedArgs a) {
  using namespace walk;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= a.b) return;
  int sr = -1, sf = -1, score = 0;
  if (kLocal) {
    score = a.best[4 * k];
    sr = a.best[4 * k + 1];
    sf = a.best[4 * k + 2];
  } else if (a.mrp[k] >= 0) {
    const int o = __ldg(a.offsets + a.mrp[k]);
    const int width = min(min(o + a.band, a.n), a.mxp[k] + 1) - o;
    if (width > 0) {
      const int32_t *keep = a.keep + static_cast<size_t>(k) * a.band;
      int arg = 0;
      score = keep[0];
      for (int c = 1; c < width; ++c) {
        if (keep[c] > score) {
          score = keep[c];
          arg = c;
        }
      }
      sr = a.mrp[k];
      sf = o + arg;
    }
  }
  a.ends[k] = sr;
  a.ends[a.b + k] = sf;
  a.ends[2 * a.b + k] = score;

  int32_t *rec = a.records + static_cast<size_t>(k) * a.m;
  const int32_t *ptr = a.ptr + static_cast<size_t>(k) * a.m * a.nw;
  int r = a.m - 1;
  const int first = sr < a.m ? sr : -1;
  for (; r > first; --r) rec[r] = 0;
  int fp = sf;
  bool in_f = false;
  for (; r >= 0; --r) {
    const int32_t *row = ptr + static_cast<size_t>(r) * a.nw;
    const int off = __ldg(a.offsets + r);
    const int kf = fp - off;  // the cursor's field
    int out, code;
    if (kf < 0 || kf >= a.band) {
      code = out = kStart;  // entered out of band
    } else if (kAffine && in_f) {
      code = out = kUp;
      in_f = (code4(row, kf) >> 3) & 1;
    } else {
      int j, at;
      if (kAffine) {
        at = affine_run(row, kf, a.nw, j);
      } else {
        j = linear_stop<8>(row, kf);
        at = j >= 0 ? code2<8>(row, j) : 0;
      }
      // A run to the band's low edge (j = -1) emits kf + 1 LEFTs.
      code = j >= 0 ? (at & 3) : kStart;
      out = (kf - j) * 4 + code;
      if (kAffine) in_f = code == kUp && ((at >> 3) & 1);
      if (code != kStart) fp = off + (code == kDiag ? j - 1 : j);
    }
    rec[r] = out;
    if (code == kStart) {
      --r;
      break;
    }
  }
  for (; r >= 0; --r) rec[r] = 0;
}

}  // namespace

// Launch on `stream`; b >= 1, m >= 1, 1 <= band <= n, nw = ceil(band / 8).
// best may be null for NW; keep, mrp and mxp for SW.
extern "C" int val_banded_walk_launch(const void *ptr, const void *best, const void *keep,
                                      const void *mrp, const void *mxp, const void *offsets,
                                      void *records, void *ends, int b, int m, int n,
                                      int band, int nw, int local, int affine,
                                      void *stream) {
  walk::BandedArgs a{static_cast<const int32_t *>(ptr), static_cast<const int32_t *>(best),
                     static_cast<const int32_t *>(keep), static_cast<const int32_t *>(mrp),
                     static_cast<const int32_t *>(mxp), static_cast<const int32_t *>(offsets),
                     static_cast<int32_t *>(records), static_cast<int32_t *>(ends),
                     b, m, n, band, nw};
  const dim3 grid((b + walk::kThreads - 1) / walk::kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  if (local && affine) banded_walk_kernel<true, true><<<grid, walk::kThreads, 0, s>>>(a);
  else if (local) banded_walk_kernel<true, false><<<grid, walk::kThreads, 0, s>>>(a);
  else if (affine) banded_walk_kernel<false, true><<<grid, walk::kThreads, 0, s>>>(a);
  else banded_walk_kernel<false, false><<<grid, walk::kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
