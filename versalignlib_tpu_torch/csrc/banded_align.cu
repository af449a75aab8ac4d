// Banded pointer fill: Smith-Waterman and the reference's semi-global
// "Needleman-Wunsch", linear or affine (Gotoh) gaps, the DNA table or an
// S x S matrix, both tie-break flavors, int32 cells.
//
// Replaces versalignlib_tpu/ops/banded.py::_banded_align_kernel and computes
// what banded_align_oracle defines, in the layout the host decoder
// (native/src/traceback.cpp decode_pair_banded) reads with wbase = offsets:
// - ptr (b, m, ceil(band/8)) int32: row i's code of band column k (DP
//   column offsets[i] + 1 + k) in field k % 8 of word k / 8; 2-bit move
//   codes (0 START, 1 UP, 2 LEFT, 3 DIAG) with linear gaps, 4-bit
//   hptr | e_ext << 2 | f_ext << 3 with affine gaps; fields past the band
//   read 0. The TPU kernel writes window-relative rows of a row tile; this
//   layout has no window, so its words differ while every walk is the same;
// - best (b, 4), SW: [score, end row, end ref position, 0], the first
//   in-band cell in row-major order that holds the maximum, (0, 0) when it
//   is 0;
// - keep (b, band), NW: the H row of row mrp[p] (the last valid read row),
//   -inf throughout when mrp[p] < 0. The host takes its leftmost maximum
//   over the valid ref positions (banded.py:1359-1382).
//
// Moves, read off the final values by equality as the oracle reads them:
// canonical DIAG > UP > LEFT (affine: DIAG > UP(F) > LEFT(E)) with the SW
// zero-force to START; SSE DIAG (when both codes are valid) > LEFT > UP, no
// zero-force. A cell whose every candidate is below -inf reads START. An
// extend bit is set where extending the gap gives the cell's E (F) value.
//
// Design (csrc/banded.cuh): one warp per pair, the lanes across the band's
// columns, the in-row dependency by a warp scan, the rows in shared memory.
// A lane's columns fill whole pointer words, which it stores itself. Under
// affine gaps a lane's first E extend bit needs the E value of the column
// before, which the lane to its left computes in the same pass: the lane
// holds its first word back and completes it after one shuffle.
//
// What bounds it on an H100: integer operations, as banded_score.cu, plus
// the move selection and packing per cell; the pointer words (2 or 4 bits a
// cell) are the only output of size.

#include <cstdint>
#include <cuda_runtime.h>

#include "banded.cuh"

namespace {

using valb::BandArgs;
using valb::kNeg;

struct FillOut {
  const int32_t *mrp;  // (b,) NW end row
  int32_t *ptr;        // (b, m, nw)
  int32_t *best;       // (b, 4), SW
  int32_t *keep;       // (b, band), NW
};

template <bool kLocal, bool kAffine, bool kCanon, int kMat>
__global__ void __launch_bounds__(valb::kWarps * 32)
    banded_align_kernel(BandArgs a, FillOut out) {
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
  const int nw = (a.band + 7) / 8;
  const int k0 = min(lane * a.cols, a.band);
  const int k1 = min(k0 + a.cols, a.band);
  const int mrp = kLocal ? -1 : out.mrp[p];
  int32_t *keep = kLocal ? nullptr : out.keep + (size_t)p * a.band;
  if (!kLocal && (mrp < 0 || mrp >= a.m))
    for (int k = lane; k < a.band; k += 32) keep[k] = kNeg;
  constexpr int kBits = kAffine ? 4 : 2;
  int best = 0, best_row = 0, best_col = 0;  // SW, strict first-win
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
    int32_t *prow = out.ptr + ((size_t)p * a.m + i) * nw;
    uint32_t word = 0, first_word = 0;
    int e_prev = valb::kSent, e_first = kNeg;  // affine: E of the column before
    for (int k = k0; k < k1; ++k) {
      const int f_code = ref[o + k];
      const int diag = r.h_prev[k + s] + valb::sub_score<kMat>(a, tab, rc, f_code);
      const bool valid = !kCanon && rc.valid && valb::ref_valid<kMat>(a, vtab, f_code);
      const int t = r.h_cur[1 + k];
      int h, up, left;
      uint32_t ext_bits = 0;
      if (kAffine) {
        const int f_up = r.f_prev[k + s + 1];
        up = r.f_cur[1 + k];                 // F
        left = max(x + a.gap_read, kNeg);    // E
        h = max(t, left);
        x = max(t + a.open_read, x + a.gap_read);
        ext_bits = (left == e_prev + a.gap_read ? 4u : 0u) |
                   (up == f_up + a.gap_ref ? 8u : 0u);
        if (k == k0) e_first = left;
        e_prev = left;
      } else {
        up = r.h_prev[k + s + 1] + a.gap_ref;
        left = x + a.gap_read;
        h = max(t, left);
        x = h;
      }
      uint32_t hp;
      if (kCanon) {
        hp = h == diag ? 3u : (h == up ? 1u : (h == left ? 2u : 0u));
        if (kLocal && h == 0) hp = 0u;
      } else {
        hp = (h == diag && valid) ? 3u : (h == left ? 2u : (h == up ? 1u : 0u));
      }
      r.h_cur[1 + k] = h;
      word |= (hp | ext_bits) << (kBits * (k & 7));
      if (kLocal) {
        if (h > best) {
          best = h;
          best_row = i;
          best_col = o + k;
        }
      } else if (i == mrp) {
        keep[k] = h;
      }
      if ((k & 7) == 7 || k == k1 - 1) {
        if (kAffine && k - (k & 7) == k0) first_word = word;
        else prow[k >> 3] = static_cast<int32_t>(word);
        word = 0;
      }
    }
    if (kAffine) {
      // E of the column left of this lane's first: the last E of the lane
      // before (whose columns are all full), -inf left of the band.
      const int e_left = __shfl_up_sync(valb::kFull, e_prev, 1);
      if (k0 < k1) {
        if (e_first == (lane == 0 ? kNeg : e_left) + a.gap_read) first_word |= 4u;
        prow[k0 >> 3] = static_cast<int32_t>(first_word);
      }
    }
    __syncwarp();
    r.swap();
  }
  if (kLocal) {
    // Row-major first-win across lanes: the maximum, then the least row,
    // then the least column.
    const int top = __reduce_max_sync(valb::kFull, best);
    const int row = __reduce_min_sync(valb::kFull, best == top ? best_row : INT32_MAX);
    const int col = __reduce_min_sync(
        valb::kFull, best == top && best_row == row ? best_col : INT32_MAX);
    if (lane == 0) {
      int32_t *b4 = out.best + (size_t)p * 4;
      b4[0] = top;
      b4[1] = row;
      b4[2] = col;
      b4[3] = 0;
    }
  }
}

}  // namespace

// Launch on `stream`; as val_banded_score_launch for the shared arguments.
// `mrp` (b,) int32 is read for NW only, `best` (b, 4) is written for SW
// only and `keep` (b, band) for NW only (null otherwise). Returns
// cudaGetLastError().
extern "C" int val_banded_align_launch(
    const void *reads, const void *refs, const void *offsets, const void *mrp,
    void *scratch, const void *table, const void *valid, void *ptr, void *best,
    void *keep, int b, int m, int n, int band, int d, int cols, int s,
    int match, int mismatch, int gap_read, int gap_ref, int open_read,
    int open_ref, int local, int affine, int canonical, void *stream) {
  BandArgs a{static_cast<const uint8_t *>(reads),
             static_cast<const uint8_t *>(refs),
             static_cast<const int32_t *>(offsets),
             static_cast<int32_t *>(scratch),
             static_cast<const int32_t *>(table),
             static_cast<const uint8_t *>(valid),
             b, m, n, band, d, cols, s,
             match, mismatch, gap_read, gap_ref, open_read, open_ref};
  FillOut out{static_cast<const int32_t *>(mrp), static_cast<int32_t *>(ptr),
              static_cast<int32_t *>(best), static_cast<int32_t *>(keep)};
  const size_t table_bytes = sizeof(int32_t) * s * s + s;
  auto with_gaps = [&](auto kAffine) {
    val::dispatch(local, canonical, table, table_bytes,
                  [&](auto kLocal, auto kCanon, auto kMat) {
      auto kernel = banded_align_kernel<decltype(kLocal)::value,
                                        decltype(kAffine)::value,
                                        decltype(kCanon)::value,
                                        decltype(kMat)::value>;
      const size_t smem = valb::shared_bytes(kernel, a, decltype(kAffine)::value,
                                             decltype(kMat)::value == 1);
      kernel<<<valb::grid_for(b), valb::kWarps * 32, smem,
               static_cast<cudaStream_t>(stream)>>>(a, out);
    });
  };
  if (affine) with_gaps(std::true_type{});
  else with_gaps(std::false_type{});
  return static_cast<int>(cudaGetLastError());
}
