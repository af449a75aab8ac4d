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
// columns, the in-row dependency by a warp scan, the rows in shared memory
// (device memory for a band too wide for it) with a lane's columns 34 words
// apart. The first pass leaves T, the diagonal and the up candidate of the
// lane's columns in registers; the second reads nothing of the row above:
// H = max(T, left) equals the diagonal exactly when the diagonal is T and
// left <= T (the same for up), so comparing H with the kept values gives
// the codes the oracle reads by equality. A lane's pointer words leave as
// one vector store (two words at band 512), so a warp writes its row
// contiguously. Under affine gaps a lane's first E extend bit needs the E
// value of the column before, which the lane to its left computes in the
// same pass: the lane holds its words back and completes the first after
// one shuffle.
//
// What bounded the first version on an H100 was shared memory: a lane held
// a contiguous run of 16 band columns in a contiguous row, so each of a
// cell's 7 row accesses (10 affine) was a 16-way bank conflict, and pairs x
// rows x cols x accesses x 16 wavefronts, one wavefront per SM a clock,
// gave its 128 ms (177 affine) at 1024 x 16 kbp, band 512 within 1-12%
// (PERF.md). Now each access is one wavefront, and a cell reads the row
// above once and stores its H once (and F, affine), with one more shared
// load for its DNA substitution. What bounds it now is instruction issue
// and latency: some 50-80 instructions a cell (the substitution, T, the
// fold, the chain, the move selection and packing, the SW first-win test)
// from 2 warps a scheduler at 1024 pairs, 1 in the models' rounds of 528;
// the pointer words (2 or 4 bits a cell) are the only output of size.

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

// Stores a lane's n (<= 4) pointer words of one chunk at dst: one int4, or
// int2 pairs, where `vec4` / `vec2` say that dst is aligned for them.
__device__ __forceinline__ void store_words(int32_t *dst, const uint32_t (&wd)[4], int n,
                                            bool vec4, bool vec2) {
  if (vec4 && n == 4) {
    *reinterpret_cast<int4 *>(dst) = make_int4(wd[0], wd[1], wd[2], wd[3]);
    return;
  }
#pragma unroll
  for (int w = 0; w < 4; w += 2) {
    if (vec2 && w + 1 < n) {
      *reinterpret_cast<int2 *>(dst + w) = make_int2(wd[w], wd[w + 1]);
    } else {
      if (w < n) dst[w] = static_cast<int32_t>(wd[w]);
      if (w + 1 < n) dst[w + 1] = static_cast<int32_t>(wd[w + 1]);
    }
  }
}

template <bool kLocal, bool kAffine, bool kCanon, int kMat, bool kWide>
// Up to 255 registers a thread still fit the 2 blocks an SM of a launch of
// 1024 pairs; without the bound the wide instantiations were held to 168
// and spilled.
__global__ void __launch_bounds__(valb::kWarps * 32, 1)
    banded_align_kernel(BandArgs a, FillOut out) {
  extern __shared__ int32_t smem[];
  const int32_t *tab;
  const uint8_t *vtab;
  val::matrix_prologue<kMat>(a.table, a.valid, a.s, smem, tab, vtab);
  if (kMat == 0) {
    valb::dna_prologue(a, smem);
    tab = smem;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * valb::kWarps + warp;
  if (p >= a.b) return;
  valb::Rows r = valb::init_rows<kAffine, kMat>(a, smem, p, warp, lane);
  const uint8_t *read = a.reads + (size_t)p * a.m;
  const uint8_t *ref = a.refs + (size_t)p * a.n;
  const int nw = (a.band + 7) / 8;
  const int k0 = min(lane * a.cols, a.band);
  const int nc = min(a.cols, a.band - k0);       // the lane's band columns
  // kWide: more than kChunk columns a lane (band > 1024), walked in chunks.
  const int nchunks = kWide ? (a.cols + valb::kChunk - 1) / valb::kChunk : 1;
  const bool vec4 = (nw & 3) == 0 && (a.cols & 31) == 0;
  const bool vec2 = (nw & 1) == 0 && (a.cols & 15) == 0;
  const int mrp = kLocal ? -1 : out.mrp[p];
  int32_t *keep = kLocal ? nullptr : out.keep + (size_t)p * a.band;
  if (!kLocal && (mrp < 0 || mrp >= a.m))
    for (int k = lane; k < a.band; k += 32) keep[k] = kNeg;
  constexpr int kBits = kAffine ? 4 : 2;
  int best = 0, best_row = 0, best_col = 0;  // SW, strict first-win
  valb::Chunk ch;
  valb::set_pen(ch, 0, nc);
  int o_prev = a.offsets[0];
  for (int i = 0; i < a.m; ++i) {
    const int o = a.offsets[i];
    const valb::Step st(o - o_prev, a.cols, lane);
    o_prev = o;
    const valb::ReadCode rc = valb::read_code<kMat>(a, vtab, read[i]);
    const uint8_t *rrow = ref + o + k0;
    int32_t *fc = r.f_cur + lane + 1;
    int32_t *prow = out.ptr + ((size_t)p * a.m + i) * nw + k0 / 8;
    int32_t *hc = r.h_cur + lane + 1;
    uint32_t first[valb::kChunkWords];  // affine: chunk 0's words, held back
    int e_prev = valb::kSent, e_first = kNeg;  // affine: E of the column before
    const int row_best = best;
    int best_j = 0;
    int acc = valb::kSent, x = 0;
    // One chunk of 32 columns: its first pass, the scan after the last
    // chunk's, and its second pass. A lane of more chunks makes its first
    // passes, the scan, then each chunk's first pass again and its second.
    const int steps = kWide ? 2 * nchunks : 1;
    for (int k = 0; k < steps; ++k) {
      const int c = k < nchunks ? k : k - nchunks;
      const int nwc = valb::chunk_words(c, nc);
      if (kWide) valb::set_pen(ch, c, nc);
      acc = valb::pass1<kLocal, kAffine, kCanon, kMat>(a, tab, vtab, r, st, rrow, fc, rc, c,
                                                        nwc, ch, acc);
      if (k == nchunks - 1) {
        const int bnd = o == 0 ? 0 : kNeg;
        x = valb::scan_entry(acc, kAffine ? bnd + a.open_read : bnd, a.cols * a.gap_read,
                             lane);
        if (lane == 0) r.h_cur[valb::word_of(-1, a.cols - 1)] = bnd;
      }
      if (k < steps - nchunks) continue;
      int32_t *hw = hc + valb::kSlot * valb::kChunk * c;
      const int chunk_best = best;
      int j_best = 0;
      uint32_t wd[valb::kChunkWords];
#pragma unroll
      for (int w = 0; w < valb::kChunkWords; ++w) {
        wd[w] = 0;
        if (w < nwc) {
          uint32_t word = kAffine ? ch.fx[w] : 0u;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * w + jj;
            const int t = ch.t[j];
            int h, left;
            uint32_t ext = 0;
            if (kAffine) {
              left = __viaddmax_s32(x, a.gap_read, kNeg);   // E
              h = max(t, left);
              x = __viaddmax_s32(x, a.gap_read, t + a.open_read);
              if (left == e_prev + a.gap_read) ext = 4u;
              if (j == 0) e_first = c == 0 ? left : e_first;
              e_prev = left;
            } else {
              left = x + a.gap_read;
              h = max(t, left);
              x = h;
            }
            uint32_t hp;
            if (kCanon) {
              hp = h == ch.d[j] ? 3u : (h == ch.u[j] ? 1u : (h == left ? 2u : 0u));
              if (kLocal && h == 0) hp = 0u;   // SW: a cell of 0 reads START
            } else {
              hp = h == ch.d[j] ? 3u : (h == left ? 2u : (h == ch.u[j] ? 1u : 0u));
            }
            hw[valb::kSlot * j] = h;
            if (j == 0 && c == 0) hc[valb::kSlot * a.cols - 1] = h;  // lane - 1's slot cols
            word |= (hp | ext) << (kBits * jj);
            if (kLocal && h > best) {   // the first maximum stays
              best = h;
              j_best = j;
            }
            ch.t[j] = h;
          }
          // Fields past the band read 0.
          const int valid = nc - valb::kChunk * c - 8 * w;
          if ((a.band & 7) != 0 && valid < 8) word &= (1u << (kBits * valid)) - 1u;
          wd[w] = word;
        }
      }
      if (kLocal && best > chunk_best) best_j = valb::kChunk * c + j_best;
      if (!kLocal && i == mrp) {
#pragma unroll
        for (int j = 0; j < valb::kChunk; ++j)
          if (valb::kChunk * c + j < nc) keep[k0 + valb::kChunk * c + j] = ch.t[j];
      }
      if (kAffine && c == 0) {
#pragma unroll
        for (int w = 0; w < valb::kChunkWords; ++w) first[w] = wd[w];
      } else {
        store_words(prow + valb::kChunkWords * c, wd, nwc, vec4, vec2);
      }
    }
    if (kAffine) {
      // E of the column left of this lane's first: the last E of the lane
      // before (whose columns are all in the band), -inf left of the band.
      const int e_left = __shfl_up_sync(valb::kFull, e_prev, 1);
      if (nc > 0) {
        if (e_first == (lane == 0 ? kNeg : e_left) + a.gap_read) first[0] |= 4u;
        store_words(prow, first, valb::chunk_words(0, nc), vec4, vec2);
      }
    }
    if (kLocal && best > row_best) {
      best_row = i;
      best_col = o + k0 + best_j;
    }
    valb::clear_past_band(a, r.h_cur, lane, nc);
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
    void *keep, int b, int m, int n, int band, int cols, int s,
    int match, int mismatch, int gap_read, int gap_ref, int open_read,
    int open_ref, int local, int affine, int canonical, void *stream) {
  BandArgs a{static_cast<const uint8_t *>(reads),
             static_cast<const uint8_t *>(refs),
             static_cast<const int32_t *>(offsets),
             static_cast<int32_t *>(scratch),
             static_cast<const int32_t *>(table),
             static_cast<const uint8_t *>(valid),
             b, m, n, band, cols, s,
             match, mismatch, gap_read, gap_ref, open_read, open_ref};
  FillOut out{static_cast<const int32_t *>(mrp), static_cast<int32_t *>(ptr),
              static_cast<int32_t *>(best), static_cast<int32_t *>(keep)};
  const size_t table_bytes = sizeof(int32_t) * s * s + s;
  auto with_gaps = [&](auto kAffine) {
    val::dispatch(local, canonical, table, table_bytes,
                  [&](auto kLocal, auto kCanon, auto kMat) {
      auto run = [&](auto kWide) {
        auto kernel = banded_align_kernel<decltype(kLocal)::value, decltype(kAffine)::value,
                                          decltype(kCanon)::value, decltype(kMat)::value,
                                          decltype(kWide)::value>;
        const size_t smem =
            valb::shared_bytes<decltype(kMat)::value>(kernel, a, decltype(kAffine)::value);
        kernel<<<valb::grid_for(b), valb::kWarps * 32, smem,
                 static_cast<cudaStream_t>(stream)>>>(a, out);
      };
      if (cols > valb::kChunk) run(std::true_type{});
      else run(std::false_type{});
    });
  };
  if (affine) with_gaps(std::true_type{});
  else with_gaps(std::false_type{});
  return static_cast<int>(cudaGetLastError());
}
