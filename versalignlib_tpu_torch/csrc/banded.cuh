// Pieces shared by the banded kernels (banded_score.cu, banded_align.cu):
// one warp per pair, the band's rows staged per warp in a layout without
// bank conflicts, the substitution of one cell, the first pass over a row
// and the warp scan that resolves the in-row gap dependency exactly.
//
// The band. Row i covers the band columns k = 0 .. band-1, DP column
// o(i) + 1 + k, o(i) = offsets[i]; consecutive rows step right by
// s = o(i) - o(i-1), 0 <= s <= d (banded.py band_offsets / max_band_step).
// Cells outside a row's band are -inf (kNeg), column 0 and row 0 are 0, as
// banded_score_oracle / banded_align_oracle define them. Band column -1 of
// row i is DP column o(i), the boundary: 0 when o(i) == 0, else kNeg.
//
// The lanes. Lane l owns the contiguous band columns [l*cols, (l+1)*cols),
// cols a multiple of 8 so that a lane's columns fill whole pointer words.
// A row takes three steps:
// 1. pass1: each lane computes, for its columns, everything that does not
//    depend on the cell to the left: T = max(diag + sub, up + gap_ref
//    [or F], -inf [or 0 for SW]), and folds its columns into one aggregate;
// 2. scan_entry: a max-plus prefix scan over the lanes (5 __shfl_up_sync)
//    gives each lane the value entering its first column;
// 3. the kernel's own pass over its columns, from that value, on the chain
//    H[k] = max(T[k], H[k-1] + gap_read) (one __viaddmax_s32 a cell), or
//    with affine gaps E[k] = max(-inf, U[k-1] + gap_read), U[k] = max(T[k] +
//    open_read, U[k-1] + gap_read), U[-1] = boundary + open_read, H = max(T,
//    E) (plain.py _row_solve, _row_solve_open; exact because open_read and
//    gap_read are <= 0). Every step is an int32 add or max, so the values
//    equal the oracle's and the move codes can be read off them by equality,
//    as the oracle reads them.
//
// The rows. A warp keeps the previous and the current H row (and F row
// under affine gaps), each row_len(cols) = kSlot * (cols + 1) int32 words.
// Lane l's column j (band column l*cols + j) lies at word j*kSlot + l + 1
// (word_of; ops/cuda_banded.py row_word mirrors it): the 32 lanes' j-th
// columns are 32 neighbouring words, so a row access of the warp touches 32
// distinct banks of shared memory, and neighbouring words of device memory
// where the rows live there. Each slot row of kSlot = 34 words also holds
// "lane -1" (word j*kSlot), whose slot cols-1 is band column -1, the
// boundary, and "lane 32" (word j*kSlot + 33), -inf: the columns past 32 *
// cols, which are past the band. Slot cols of lane l repeats lane l+1's
// slot 0, band column (l+1)*cols: each lane stores its first H (and F)
// twice. The columns of [band, 32*cols) are kNeg too; no lane writes them.
// Row -1 (DP row 0) is 0 over the band.
//
// The row above. Row i reads row i-1 at band columns l*cols + s - 1 + t,
// t = 0 .. cols: P(j) is the diagonal of the lane's column j and P(j + 1)
// the cell above it, so a cell reads the row above once and carries the
// value on as its right neighbour's diagonal. With s - 1 = q*cols + r
// (0 <= r < cols), P(t) is lane l+q's slot r+t for t < wrap = cols - r + 1
// (its slot cols the repeat), then lane l+q+1's slot r+t-cols (Step;
// cuda_banded.read_word mirrors it), lanes past 31 reading lane 32's -inf;
// a step of 0 reads P(0) from lane l-1's last slot and the rest from lane
// l. At steps 0 and 1, every step of the models' square pairs, a lane's
// reads lie in one lane's slots: one base pointer serves each pointer word
// of 8 columns. At every step and every cols the warp's words of one read
// lie in 32 distinct banks (tests/test_torch_banded_layout.py).
//
// The DNA table. With the default DNA scoring a block keeps in shared
// memory, for each read class (0: not A/C/G/T; 1-4: A/C/G/T) and each ref
// code 0-255, the substitution score, then (the SSE flavor) INT_MAX where
// both codes are valid and INT_MIN where not: a cell's substitution is one
// shared load, its SSE validity a second and a min.
//
// Registers. pass1 keeps, for up to kChunk = 32 columns of a lane (band <=
// 1024, cols <= 32: every launch the models and the long-read mapping
// make), T, the diagonal and the up candidate in registers, and the second
// pass reads nothing of the row above: it takes the move codes off these
// values by equality. A lane of more columns walks them in chunks of 32 and
// its second pass computes each chunk's first pass again (ops/cuda_banded.py
// t_in_registers says which a launch takes).
//
// The band's last pointer word may be partial (band % 8 != 0). The lane
// that holds it computes the word's columns past the band too: their
// diagonal gets kPen, so that T is the clamp there (-inf-like for NW, 0 for
// SW: such a cell never beats the cell left of it, which is in the band, as
// the gaps are <= 0), their pointer fields are cleared and their H words
// set back to kNeg after the row. The codes read there lie within 16 bytes
// past the pair's ref; the wrapper pads the refs by that much.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace valb {

constexpr int kNeg = -(1 << 30);   // pallas_score.NEG_INF_I32
// Start of a lane's fold: below every candidate (>= kNeg minus a few gap
// scores per column), and far enough above INT_MIN for the adds.
constexpr int kSent = -(3 << 29);
// Added to the diagonal of a cell past the band (see above): a real H plus
// kPen lies below 0, kNeg plus kPen stays above INT_MIN.
constexpr int kPen = -(1 << 29);
constexpr int kWarps = 4;          // pairs per block, one warp each
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kSlot = 34;          // words per slot row: lanes -1 .. 32
constexpr int kChunk = 32;         // a lane's columns held in registers
constexpr int kChunkWords = kChunk / 8;
constexpr int kDnaCodes = 256 * 5;  // the DNA table: 5 read classes x 256 codes
constexpr int kDnaWords = 2 * kDnaCodes;  // scores, then SSE validity caps

struct BandArgs {
  const uint8_t *reads;    // (b, m) codes
  const uint8_t *refs;     // (b, n) codes, then at least 16 bytes of padding
  const int32_t *offsets;  // (m,) band start of each row
  int32_t *scratch;        // (b, row words) rows in device memory, or null
  const int32_t *table;    // (s, s) matrix, or null for the DNA table
  const uint8_t *valid;    // (s,) SSE validity of each code (matrix only)
  int b, m, n, band, cols, s;
  int match, mismatch, gap_read, gap_ref, open_read, open_ref;
};

__host__ __device__ inline int row_len(int cols) { return kSlot * (cols + 1); }

// int32 words of one warp's rows: H previous and current, and F both.
__host__ __device__ inline int row_words(int cols, bool affine) {
  return (affine ? 4 : 2) * row_len(cols);
}

// The word of lane `lane` (-1 .. 32) at slot `slot` of a row.
__host__ __device__ inline int word_of(int lane, int slot) {
  return slot * kSlot + lane + 1;
}

// Where shared memory holds an S x S matrix (kMat 1), in int32 words,
// rounded up to 16 bytes; the rows follow it.
__host__ __device__ inline int table_words(int s) {
  return (s * s * 4 + s + 15) / 16 * 4;
}

// Fills the DNA table (kMat 0) at smem; every thread of the block takes
// part.
__device__ __forceinline__ void dna_prologue(const BandArgs &a, int32_t *smem) {
  for (int k = threadIdx.x; k < kDnaCodes; k += blockDim.x) {
    const int cls = k >> 8, f = k & 255;
    const bool valid = cls > 0 && f >= 1 && f <= 4;
    smem[k] = valid ? (f == cls ? a.match : a.mismatch) : 0;
    smem[kDnaCodes + k] = valid ? INT_MAX : INT_MIN;
  }
  __syncthreads();
}

// Words of shared memory in front of the rows: the matrix (kMat 1) or the
// DNA table (kMat 0).
template <int kMat>
__host__ __device__ inline int table_words_of(int s) {
  return kMat == 1 ? table_words(s) : (kMat == 0 ? kDnaWords : 0);
}

// A read code as the cells of its row use it: the row base of the matrix
// or of the DNA table, and (matrix) its validity.
struct ReadCode {
  int base;
  bool valid;
};

template <int kMat>
__device__ __forceinline__ ReadCode read_code(const BandArgs &a,
                                              const uint8_t *vtab, int c) {
  if (kMat) {
    const bool in = c < a.s;
    return {(in ? c : 0) * a.s, in && val::lookup<kMat>(vtab, c) != 0};
  }
  const bool v = c >= 1 && c <= 4;
  return {(v ? c : 0) * 256, v};
}

// The substitution score of read code r against ref code f (matrix[r][f]
// with codes past S read as 0; DNA match / mismatch between A/C/G/T, else
// 0), and the SSE flavor's DIAG cap: INT_MAX where both codes are valid,
// INT_MIN where not (min(diag, cap) is then a diagonal no H equals).
struct Sub {
  int score, cap;
};

template <int kMat, bool kCanon>
__device__ __forceinline__ Sub sub_score(const BandArgs &a, const int32_t *tab,
                                         const uint8_t *vtab, ReadCode r, int f) {
  if (kMat) {
    const bool in = f < a.s;
    const bool valid = !kCanon && r.valid && in && val::lookup<kMat>(vtab, f) != 0;
    return {val::lookup<kMat>(tab, r.base + (in ? f : 0)), valid ? INT_MAX : INT_MIN};
  }
  return {tab[r.base + f], kCanon ? 0 : tab[kDnaCodes + r.base + f]};
}

struct Rows {
  int32_t *h_prev, *h_cur, *f_prev, *f_cur;

  __device__ __forceinline__ void swap() {
    int32_t *t = h_prev;
    h_prev = h_cur;
    h_cur = t;
    t = f_prev;
    f_prev = f_cur;
    f_cur = t;
  }
};

// The rows of pair p (warp `warp` of its block), set up for row 0: the
// previous row is DP row 0 (0 over the band and at the boundary), every
// other word -inf.
template <bool kAffine, int kMat>
__device__ __forceinline__ Rows init_rows(const BandArgs &a, int32_t *smem,
                                          int p, int warp, int lane) {
  const int len = row_len(a.cols);
  const int words = row_words(a.cols, kAffine);
  int32_t *buf = a.scratch != nullptr
                     ? a.scratch + (size_t)p * words
                     : smem + table_words_of<kMat>(a.s) + warp * words;
  Rows r{buf, buf + len, buf + 2 * len, buf + 3 * len};
  for (int w = lane; w < len; w += 32) {
    const int slot = w / kSlot, l = w - slot * kSlot - 1, g = l * a.cols + slot;
    const bool zero = l < 32 && g >= -1 && g < a.band;
    r.h_prev[w] = zero ? 0 : kNeg;
    r.h_cur[w] = kNeg;
    if (kAffine) {
      r.f_prev[w] = kNeg;
      r.f_cur[w] = kNeg;
    }
  }
  __syncwarp();
  return r;
}

// Where a lane reads the row above on a row of step s: P(t), band column
// lane*cols + s - 1 + t of that row, lies at word a + kSlot*t for t < wrap
// and at word b + kSlot*t from there on (the next lane's slots).
struct Step {
  int a, b, wrap;

  __device__ __forceinline__ Step(int s, int cols, int lane) {
    int q, r;
    if (s == 0) {
      q = -1;
      r = cols - 1;
    } else if (s <= cols) {
      q = 0;
      r = s - 1;
    } else {
      q = (s - 1) / cols;
      r = s - 1 - q * cols;
    }
    a = word_of(min(lane + q, 32), r);
    b = word_of(min(lane + q + 1, 32), r - cols);
    wrap = s == 0 ? 1 : cols - r + 1;
  }
};

// One chunk of a lane's columns in registers, filled by pass1: T, the
// diagonal candidate (diag + sub; the SSE flavor keeps INT_MIN where the
// cell's codes are not both valid, which no H equals) and the up candidate
// (H above + gap_ref, or F); the second pass overwrites T with H. `pen` is
// kPen on the columns past the band, else 0; `fx` holds the F extend bits
// (affine) of each pointer word.
struct Chunk {
  int t[kChunk], d[kChunk], u[kChunk], pen[kChunk];
  uint32_t fx[kChunkWords];
};

// pen of chunk c of a lane that holds nc band columns.
__device__ __forceinline__ void set_pen(Chunk &ch, int c, int nc) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) ch.pen[j] = kChunk * c + j < nc ? 0 : kPen;
}

// The lane's pointer words (8 columns each) in chunk c, when it holds nc
// band columns.
__device__ __forceinline__ int chunk_words(int c, int nc) {
  return min(max((nc - kChunk * c + 7) >> 3, 0), kChunkWords);
}

// Step 1 of a row on chunk c of the lane's columns (band start o, read
// code rc, `ref` the pair's codes from band column lane*cols on, `fc` the
// lane's word 0 of the current F row): fills `ch` over its nwc words,
// stores F (affine; the lane's first F twice, see the rows above), and
// returns the fold `acc` carried on over the chunk's T (affine: T +
// open_read) under gap_read. The 8 reads of the row above that a pointer
// word makes come from one base where they lie in one lane's slots (every
// word at steps 0 and 1), else each from its own.
template <bool kLocal, bool kAffine, bool kCanon, int kMat>
__device__ __forceinline__ int pass1(const BandArgs &a, const int32_t *tab,
                                     const uint8_t *vtab, const Rows &r,
                                     const Step &st, const uint8_t *ref,
                                     int32_t *fc, ReadCode rc, int c, int nwc,
                                     Chunk &ch, int acc) {
  const int t0 = kChunk * c;
  const int wa = st.a + kSlot * t0, wb = st.b + kSlot * t0, wrap = st.wrap - t0;
  const uint8_t *rf = ref + t0;
  int32_t *fw = fc + kSlot * t0;
  // The aligned words holding the chunk's codes, and the shift that takes
  // code j to byte j of the funnel of two of them.
  const uint32_t *rw = reinterpret_cast<const uint32_t *>(
      reinterpret_cast<uintptr_t>(rf) & ~static_cast<uintptr_t>(3));
  const unsigned rsh = 8u * static_cast<unsigned>(reinterpret_cast<uintptr_t>(rf) & 3);
  int ph = r.h_prev[(0 < wrap ? wa : wb)];
#pragma unroll
  for (int w = 0; w < kChunkWords; ++w) {
    if (w < nwc) {
      // The reads above the word's columns: t = 8w+1 .. 8w+8.
      const int t1 = 8 * w + 1;
      int hu[8], fu[8];
      if (t1 + 7 < wrap || t1 >= wrap) {
        const int base = (t1 < wrap ? wa : wb) + kSlot * t1;
        const int32_t *hp = r.h_prev + base;
        const int32_t *fp = r.f_prev + base;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          hu[jj] = hp[kSlot * jj];
          if (kAffine) fu[jj] = fp[kSlot * jj];
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int word = (t1 + jj < wrap ? wa : wb) + kSlot * (t1 + jj);
          hu[jj] = r.h_prev[word];
          if (kAffine) fu[jj] = r.f_prev[word];
        }
      }
      const uint32_t w0 = __ldg(rw + 2 * w), w1 = __ldg(rw + 2 * w + 1),
                     w2 = __ldg(rw + 2 * w + 2);
      const uint32_t codes[2] = {__funnelshift_r(w0, w1, rsh), __funnelshift_r(w1, w2, rsh)};
      uint32_t fx = 0;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * w + jj;
        const int f = static_cast<int>(__byte_perm(codes[jj >> 2], 0, 0x4440 | (jj & 3)));
        const Sub sb = sub_score<kMat, kCanon>(a, tab, vtab, rc, f);
        const int dg = ph + sb.score + ch.pen[j];
        int up;
        if (kAffine) {
          up = __viaddmax_s32(__viaddmax_s32(hu[jj], a.open_ref, fu[jj]), a.gap_ref, kNeg);
          fw[kSlot * j] = up;
          if (j == 0 && c == 0) fc[kSlot * a.cols - 1] = up;   // lane - 1's slot cols
          if (up == fu[jj] + a.gap_ref) fx |= 8u << (4 * jj);
        } else {
          up = hu[jj] + a.gap_ref;
        }
        const int t = __vimax3_s32(dg, up, kLocal ? 0 : kNeg);
        acc = __viaddmax_s32(acc, a.gap_read, kAffine ? t + a.open_read : t);
        ch.t[j] = t;
        ch.u[j] = up;
        ch.d[j] = kCanon ? dg : min(dg, sb.cap);
        ph = hu[jj];
      }
      if (kAffine) ch.fx[w] = fx;
    }
  }
  return acc;
}

// Step 2: the value entering lane `lane`'s first column, given `entry`, the
// value at column -1, each lane's fold `acc` and `span` = cols * gap_read,
// the gap over one lane's columns. With z_j = acc_j - j*span and Z its
// inclusive prefix maximum, the value entering lane l is
// max(entry + l*span, Z_{l-1} + (l-1)*span). Every lane takes part.
__device__ __forceinline__ int scan_entry(int acc, int entry, int span, int lane) {
  int z = acc - lane * span;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, z, d);
    if (lane >= d) z = max(z, y);
  }
  const int prev = __shfl_up_sync(kFull, z, 1);
  int x = entry + lane * span;
  if (lane > 0) x = max(x, prev + (lane - 1) * span);
  return x;
}

// After a row whose band ends inside a lane's last pointer word: that
// lane sets the H words past the band back to kNeg.
__device__ __forceinline__ void clear_past_band(const BandArgs &a, int32_t *h_cur,
                                                int lane, int nc) {
  if ((a.band & 7) == 0 || (nc & 7) == 0) return;
#pragma unroll
  for (int k = 0; k < 7; ++k)
    if (nc + k < ((nc + 7) & ~7)) h_cur[word_of(lane, nc + k)] = kNeg;
}

// Host side: the dynamic shared memory of a launch (the matrix or the DNA
// table, the rows unless they are in device memory), and the attribute that
// allows more than 48 KB.
template <int kMat, typename Kernel>
inline size_t shared_bytes(Kernel kernel, const BandArgs &a, bool affine) {
  size_t bytes = 4 * (size_t)table_words_of<kMat>(a.s);
  if (a.scratch == nullptr)
    bytes += 4 * (size_t)kWarps * row_words(a.cols, affine);
  if (bytes > (48 << 10))
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
  return bytes;
}

inline dim3 grid_for(int b) { return dim3((b + kWarps - 1) / kWarps); }

}  // namespace valb
