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
// What bounded the first version on an H100 was shared memory: a lane held
// a contiguous run of 16 band columns in a contiguous row, so each of the 5
// row accesses of a cell was a 16-way bank conflict, and the model of
// pairs x rows x cols x 5 x 16 wavefronts, one wavefront per SM a clock,
// gave its 91 ms at 1024 x 16 kbp, band 512 within 1% (PERF.md).
// Now the rows hold a lane's columns 34 words apart (banded.cuh): each
// access is one wavefront, and a cell reads the row above once and stores
// its H once (and F, affine), with one more shared load for its DNA
// substitution. T stays in registers between the passes. What bounds it now
// is instruction issue and latency: some 25-40 instructions a cell (the
// substitution, T, the fold, the chain, the row's scan and bookkeeping)
// from 2 warps a scheduler at 1024 pairs, 1 in the models' rounds of 528.

#include <cstdint>
#include <cuda_runtime.h>

#include "banded.cuh"

namespace {

using valb::BandArgs;
using valb::kNeg;

template <bool kLocal, bool kAffine, int kMat, bool kWide>
// Up to 255 registers a thread still fit the 2 blocks an SM of a launch of
// 1024 pairs; without the bound the wide instantiations were held to 168
// and spilled.
__global__ void __launch_bounds__(valb::kWarps * 32, 1)
    banded_score_kernel(BandArgs a, int32_t *out) {
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
  const int k0 = min(lane * a.cols, a.band);
  const int nc = min(a.cols, a.band - k0);       // the lane's band columns
  // kWide: more than kChunk columns a lane (band > 1024), walked in chunks.
  const int nchunks = kWide ? (a.cols + valb::kChunk - 1) / valb::kChunk : 1;
  // Where band column band - 1 lies, for NW's last DP column.
  const int last_word = valb::word_of((a.band - 1) / a.cols, (a.band - 1) % a.cols);
  valb::Chunk ch;
  valb::set_pen(ch, 0, nc);
  int best = kLocal ? 0 : kNeg;  // SW: the band maximum; NW: the last column
  int last_row = kNeg;           // NW: the final row's maximum
  int o_prev = a.offsets[0];
  for (int i = 0; i < a.m; ++i) {
    const int o = a.offsets[i];
    const valb::Step st(o - o_prev, a.cols, lane);
    o_prev = o;
    const valb::ReadCode rc = valb::read_code<kMat>(a, vtab, read[i]);
    const uint8_t *rrow = ref + o + k0;
    int32_t *fc = r.f_cur + lane + 1;
    const bool final_row = i == a.m - 1;
    int32_t *hc = r.h_cur + lane + 1;
    int acc = valb::kSent, x = 0;
    // One chunk of 32 columns: its first pass, the scan after the last
    // chunk's, and its second pass. A lane of more chunks makes its first
    // passes, the scan, then each chunk's first pass again and its second.
    const int steps = kWide ? 2 * nchunks : 1;
    for (int k = 0; k < steps; ++k) {
      const int c = k < nchunks ? k : k - nchunks;
      const int nwc = valb::chunk_words(c, nc);
      if (kWide) valb::set_pen(ch, c, nc);
      acc = valb::pass1<kLocal, kAffine, true, kMat>(a, tab, vtab, r, st, rrow, fc, rc, c, nwc,
                                                      ch, acc);
      if (k == nchunks - 1) {
        const int bnd = o == 0 ? 0 : kNeg;
        x = valb::scan_entry(acc, kAffine ? bnd + a.open_read : bnd, a.cols * a.gap_read,
                             lane);
        if (lane == 0) r.h_cur[valb::word_of(-1, a.cols - 1)] = bnd;
      }
      if (k < steps - nchunks) continue;
      int32_t *hw = hc + valb::kSlot * valb::kChunk * c;
#pragma unroll
      for (int w = 0; w < valb::kChunkWords; ++w) {
        if (w < nwc) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * w + jj;
            const int t = ch.t[j];
            int h;
            if (kAffine) {
              h = max(t, __viaddmax_s32(x, a.gap_read, kNeg));
              x = __viaddmax_s32(x, a.gap_read, t + a.open_read);
            } else {
              h = __viaddmax_s32(x, a.gap_read, t);
              x = h;
            }
            hw[valb::kSlot * j] = h;
            if (j == 0 && c == 0) hc[valb::kSlot * a.cols - 1] = h;  // lane - 1's slot cols
            if (kLocal) best = max(best, h);
            ch.t[j] = h;
          }
        }
      }
      if (!kLocal && final_row) {
#pragma unroll
        for (int j = 0; j < valb::kChunk; ++j)
          if (valb::kChunk * c + j < nc) last_row = max(last_row, ch.t[j]);
      }
    }
    valb::clear_past_band(a, r.h_cur, lane, nc);
    __syncwarp();
    if (!kLocal && o + a.band == a.n) best = max(best, r.h_cur[last_word]);
    r.swap();
  }
  best = __reduce_max_sync(valb::kFull, best);
  if (!kLocal) best = max(max(best, __reduce_max_sync(valb::kFull, last_row)), 0);
  if (lane == 0) out[p] = best;
}

}  // namespace

// Launch on `stream`; b, m, n, band >= 1, band <= n, cols a multiple of 8
// with 32 * cols >= band, `offsets` non-decreasing with offsets[i] + band
// <= n. `refs` holds at least 16 bytes past its b * n codes. `scratch` is
// (b, row words) int32 or null for rows in shared memory; `table` the
// (s, s) matrix and `valid` its validity bytes, or both null for the DNA
// table. Returns cudaGetLastError().
extern "C" int val_banded_score_launch(
    const void *reads, const void *refs, const void *offsets, void *scratch,
    const void *table, const void *valid, void *out, int b, int m, int n,
    int band, int cols, int s, int match, int mismatch, int gap_read,
    int gap_ref, int open_read, int open_ref, int local, int affine,
    void *stream) {
  BandArgs a{static_cast<const uint8_t *>(reads),
             static_cast<const uint8_t *>(refs),
             static_cast<const int32_t *>(offsets),
             static_cast<int32_t *>(scratch),
             static_cast<const int32_t *>(table),
             static_cast<const uint8_t *>(valid),
             b, m, n, band, cols, s,
             match, mismatch, gap_read, gap_ref, open_read, open_ref};
  const size_t table_bytes = sizeof(int32_t) * s * s + s;
  val::dispatch(local, affine, table, table_bytes,
                [&](auto kLocal, auto kAffine, auto kMat) {
    auto run = [&](auto kWide) {
      auto kernel = banded_score_kernel<decltype(kLocal)::value, decltype(kAffine)::value,
                                        decltype(kMat)::value, decltype(kWide)::value>;
      const size_t smem =
          valb::shared_bytes<decltype(kMat)::value>(kernel, a, decltype(kAffine)::value);
      kernel<<<valb::grid_for(b), valb::kWarps * 32, smem,
               static_cast<cudaStream_t>(stream)>>>(a, static_cast<int32_t *>(out));
    };
    if (cols > valb::kChunk) run(std::true_type{});
    else run(std::false_type{});
  });
  return static_cast<int>(cudaGetLastError());
}
