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
// states are kept as walk.cuh says.
//
// What bounds it on an H100, and the design: walk.cuh (walk_pair, a warp
// a pair, kWarps pairs a block, so that a launch of 1024 pairs fills every
// SM; the rows ahead of the cursor staged in shared memory, one aligned
// 32-byte window of 64 band fields a row; steps speculated 32 rows a
// round). At 1024 pairs of 16 kbp (about 28 rows a round) an H100 80GB
// HBM3 at 700 W fetched about 23 G windows a second; windows of twice the
// bytes, and twice or half the stages in flight, measured the same
// (PERF.md).

#include <climits>
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
  // Null, or (3,) counts added up: windows staged again, runs below a window, rounds.
  unsigned long long *stats;
  int b, m, n, band, nw;
};

}  // namespace walk

namespace {

template <bool kLocal, bool kAffine, int kVec>
__global__ void __launch_bounds__(walk::kWarps * 32) banded_walk_kernel(walk::BandedArgs a) {
  using namespace walk;
  __shared__ Ring<true> rings[kWarps];
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
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
      // The first maximum: each lane's own, then the warp's, lowest index
      // on ties.
      const int32_t *keep = a.keep + static_cast<size_t>(k) * a.band;
      int val = INT_MIN, arg = INT_MAX;
      for (int c = lane; c < width; c += 32) {
        const int v = keep[c];
        if (arg == INT_MAX || v > val) {
          val = v;
          arg = c;
        }
      }
      for (int d = 16; d > 0; d >>= 1) {
        const int ov = __shfl_xor_sync(~0u, val, d), oa = __shfl_xor_sync(~0u, arg, d);
        if (ov > val || (ov == val && oa < arg)) {
          val = ov;
          arg = oa;
        }
      }
      score = val;
      sr = a.mrp[k];
      sf = o + arg;
    }
  }
  if (lane == 0) {
    a.ends[k] = sr;
    a.ends[a.b + k] = sf;
    a.ends[2 * a.b + k] = score;
  }

  walk_pair<true, kLocal, kAffine, kVec>(
      rings[threadIdx.x >> 5], a.ptr + static_cast<size_t>(k) * a.m * a.nw, a.offsets,
      a.records + static_cast<size_t>(k) * a.m, a.stats, sr < a.m ? sr : -1, sf, a.m, a.nw,
      a.band, lane);
}

template <bool kLocal, bool kAffine, int kVec>
void launch(const walk::BandedArgs &a, cudaStream_t s) {
  const dim3 grid((a.b + walk::kWarps - 1) / walk::kWarps);
  banded_walk_kernel<kLocal, kAffine, kVec><<<grid, walk::kWarps * 32, 0, s>>>(a);
}

template <int kVec>
void dispatch(const walk::BandedArgs &a, bool local, bool affine, cudaStream_t s) {
  if (local && affine) launch<true, true, kVec>(a, s);
  else if (local) launch<true, false, kVec>(a, s);
  else if (affine) launch<false, true, kVec>(a, s);
  else launch<false, false, kVec>(a, s);
}

}  // namespace

// Launch on `stream`; b >= 1, m >= 1, 1 <= band <= n, nw = ceil(band / 8).
// best may be null for NW; keep, mrp and mxp for SW; stats may be null.
extern "C" int val_banded_walk_launch(const void *ptr, const void *best, const void *keep,
                                      const void *mrp, const void *mxp, const void *offsets,
                                      void *records, void *ends, void *stats, int b, int m,
                                      int n, int band, int nw, int local, int affine,
                                      void *stream) {
  walk::BandedArgs a{static_cast<const int32_t *>(ptr), static_cast<const int32_t *>(best),
                     static_cast<const int32_t *>(keep), static_cast<const int32_t *>(mrp),
                     static_cast<const int32_t *>(mxp), static_cast<const int32_t *>(offsets),
                     static_cast<int32_t *>(records), static_cast<int32_t *>(ends),
                     static_cast<unsigned long long *>(stats), b, m, n, band, nw};
  auto s = static_cast<cudaStream_t>(stream);
  // 16-byte copies where every row starts on a 16-byte boundary.
  if (nw % 4 == 0 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0) dispatch<4>(a, local, affine, s);
  else dispatch<1>(a, local, affine, s);
  return static_cast<int>(cudaGetLastError());
}
