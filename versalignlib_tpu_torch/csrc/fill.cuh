// The wavefront shared by the pointer fills (align.cu, align_affine.cu): one
// warp per pair, its lanes pipelined along the read rows.
//
// Lane l owns kCols consecutive ref columns of a stripe of kStripe columns.
// At step t it computes row t - l of its columns: the H values of its
// previous row (and, with affine gaps, their F values) stay in its
// registers; the H value left of its first column (and that column's E)
// comes from lane l - 1, which computed the same row one step earlier, by
// one __shfl_up_sync a step; the diagonal is what it received the step
// before. Lane 0 reads column 0's boundary instead (the cell's own rule), or
// on a later stripe the right edge of the previous one, which that stripe's
// lane 31 left in a per-pair boundary column. A stripe takes m + lanes - 1
// steps; no step needs a scan or a second pass, and every pointer word is
// written once, by the lane that owns its columns.
//
// The orders that define the output:
// - SW: each lane keeps the first strict maximum of its cells in row-major
//   order (each row's maximum with its leftmost column, from one max over
//   keys that carry the column, taken when it beats the lane's best or
//   ties it at a smaller row of a later stripe); the warp reduces by (max,
//   least row, least column). Seeded at 0 / (0, 0).
// - NW: the lanes write their part of hsel when they compute row mrp and
//   keep its leftmost strict maximum; the warp reduces by (max, least
//   column), and column 0 (index 0) wins a tie. mrp < 0 writes a zero hsel
//   row and aux 0.
//
// A Cell (one per source) computes the cells; it provides:
//   kAffine, kLocal, kCanon, kBits (bits per pointer field), kWords (words
//   per lane), the per-lane state `Lane` (the registers of its columns),
//   begin(Lane&, ref codes, c0, n) at each stripe, boundary(i) (column 0's
//   Edge on row i), hsel0(mrp) and seed(mrp) (column 0 of row mrp, plain
//   and shifted), and row<kPartial>(Lane&, code, in, diag, out, word,
//   key, ncol), which computes one row of the lane's kCols columns from
//   the read code, the Edge on its left and the diagonal H; fills the raw
//   pointer words (move priority in each field's low 2 bits), leaves the
//   row's H values in Lane::h and, for SW, the row's key: the maximum over
//   the lane's first ncol columns (kPartial: fewer than kCols real
//   columns) of cur << 2 | (kCols - 1 - c), whose value is the row's
//   maximum (key >> 4) and whose low bits its leftmost column.

#pragma once

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "common.cuh"

namespace fill {

constexpr int kLanes = 32;
constexpr int kCols = 16;                  // ref columns per lane
constexpr int kStripe = kLanes * kCols;    // ref columns per stripe
constexpr int kWarps = 4;                  // pairs (warps) per block
constexpr unsigned kAll = 0xFFFFFFFFu;

// The launch arguments of both fills. Scores are shifted << 2; the open
// scores are 0 with linear gaps.
struct Args {
  const uint8_t *reads;  // (b, m) codes
  const uint8_t *refs;   // (b, n) codes
  const int32_t *mrp;    // (b,) last valid read row
  int32_t *edge;         // (b, 2, m, kEdge) boundary columns; null if n <= kStripe
  int32_t *ptr;          // (b, m, nc)
  int32_t *aux;          // (b, 4)
  int32_t *hsel;         // (b, n + 1), NW only
  const int32_t *table;  // (s, s) matrix << 2 with the DIAG priority (see Sub)
  int b, m, n, nc, s;
  int match4, mismatch4, gap_read4, gap_ref4, open_read4, open_ref4;
  int gap_ref, open_ref;
};

// What crosses a lane boundary on one row: H (shifted, priority cleared)
// and, with affine gaps, E (shifted, carrying the cell's E priority).
struct Edge {
  int h, e;
};

// The substitution score of a cell, shifted << 2, with the DIAG move
// priority of the SSE flavor added: 3 where both codes are valid, else 0
// (the canonical flavor adds its constant 2 itself). kMat:
// - 0, default DNA scoring, whose shifted scores must fit a byte (the
//   wrapper hands larger ones over as a matrix): each read code has an
//   8-byte table of its scores against ref codes 0..7 (A/C/G/T 1..4, every
//   other code 0), built once per block in shared memory (`bytes`), and a
//   cell is one prmt of its row's table by its column's selector, which
//   also sign-extends the byte;
// - 1, 2, an S x S matrix (in shared memory; through the read-only cache)
//   that the wrapper shifted and, for the SSE flavor, gave the priority
//   of both codes' validity: a cell is one lookup. Codes >= S read as 0.
template <int kMat, bool kCanon>
struct Sub {
  static constexpr int kPrio = kCanon ? 0 : 3;
  // A lane's columns: kMat 0 their selectors; 1, 2 their codes.
  struct Cols {
    int fc[kCols];
  };
  // A read row: kMat 0 its byte table (lo, hi); 1, 2 its offset in the
  // matrix.
  struct Row {
    int x, y;
  };
  const int32_t *tab;
  const uint2 *bytes;  // kMat 0: the tables of read codes 0..7
  int s;

  // The byte table of read code `code` (0..7), as `bytes` holds it.
  __device__ static uint2 byte_table(int code, int match4, int mismatch4) {
    if (code < 1 || code > 4) return {0u, 0u};
    const uint32_t mm = (mismatch4 + kPrio) & 0xFF, mt = (match4 + kPrio) & 0xFF;
    uint32_t lo = mm * 0x01010100u, hi = mm;
    if (code == 4) hi = mt;
    else lo = (lo & ~(0xFFu << (8 * code))) | (mt << (8 * code));
    return {lo, hi};
  }
  __device__ __forceinline__ void column(Cols &cs, int c, int f) const {
    if (kMat == 0) {
      const int fs = f >= 1 && f <= 4 ? f : 0;  // byte 0 of every row's table is 0
      cs.fc[c] = fs | ((fs | 8) * 0x1110);
    } else {
      cs.fc[c] = f < s ? f : 0;
    }
  }
  __device__ __forceinline__ Row row(int code) const {
    if (kMat == 0) {
      const uint2 t = bytes[code < 8 ? code : 0];
      return {static_cast<int>(t.x), static_cast<int>(t.y)};
    }
    return {(code < s ? code : 0) * s, 0};
  }
  __device__ __forceinline__ int operator()(const Row &r, const Cols &cs, int c) const {
    if (kMat == 0) {
      int v;
      asm("prmt.b32 %0, %1, %2, %3;" : "=r"(v) : "r"(r.x), "r"(r.y), "r"(cs.fc[c]));
      return v;
    }
    return val::lookup<kMat>(tab, r.x + cs.fc[c]);
  }
};

// Whether default DNA scores (unshifted) fit Sub's byte tables, in both
// flavors.
inline bool dna_fits_bytes(int match, int mismatch) {
  return match * 4 >= -128 && match * 4 + 3 <= 127 && mismatch * 4 >= -128 &&
         mismatch * 4 + 3 <= 127;
}

// One raw pointer word of kBits-bit fields, `fill` of them real, as the
// host reads it. Canonical flavor: each field's 2-bit move priority
// becomes its code (START 3->0, DIAG 2->3, UP 1->1, LEFT 0->2), the bits
// above it (the Gotoh extend bits) stay. Fields past `fill` read START.
// kPartial: the word may have fewer than its 32 / kBits fields.
template <int kBits, bool kCanon, bool kPartial>
__device__ __forceinline__ uint32_t finish_word(uint32_t v, int fill) {
  constexpr int kPack = 32 / kBits;
  constexpr uint32_t even = 0xFFFFFFFFu / ((1u << kBits) - 1u);
  constexpr uint32_t keep = ~(even | (even << 1));
  if (kCanon) v = (v & keep) | ((~v & even) << 1) | (((v >> 1) ^ v) & even);
  if (kPartial && fill < kPack) v &= (1u << (kBits * fill)) - 1u;
  return v;
}

// Fills pair p with the lanes of the calling warp (see above). `stage` is
// the warp's ring of kLanes pointer rows in shared memory: at each step the
// lanes leave their words of kLanes different rows there, and the warp
// stores the row that the last lane has just completed with coalesced
// stores (each lane storing its own words at once touched kLanes lines a
// store and took most of the fill's time).
template <typename Cell>
__device__ __forceinline__ void fill_pair(const Args &a, const Cell &cell, int p,
                                          uint32_t (*stage)[kLanes * Cell::kWords]) {
  constexpr int kPack = 32 / Cell::kBits;
  constexpr int kEdge = Cell::kAffine ? 2 : 1;
  const int lane = threadIdx.x % kLanes;
  const int m = a.m, n = a.n;
  const int mrp = Cell::kLocal ? -1 : a.mrp[p];
  const uint8_t *rd = a.reads + (size_t)p * m;
  int32_t *pp = a.ptr + (size_t)p * m * a.nc;
  int32_t *hs = Cell::kLocal ? nullptr : a.hsel + (size_t)p * (n + 1);
  if (!Cell::kLocal && mrp < 0)
    for (int j = lane; j <= n; j += kLanes) hs[j] = 0;
  // The lane's candidate: SW (value, row, column), NW (shifted value,
  // column).
  int best = Cell::kLocal ? 0 : INT_MIN, brow = 0, bcol = 0;
  typename Cell::Lane st;
  const int stripes = (n + kStripe - 1) / kStripe;
  for (int k = 0; k < stripes; ++k) {
    const int s0 = k * kStripe, c0 = s0 + lane * kCols;
    const int nl = min(kLanes, (n - s0 + kCols - 1) / kCols);
    const int ncol = max(0, min(kCols, n - c0));
    const int32_t *bin = k > 0 ? a.edge + ((size_t)p * 2 + (k & 1)) * m * kEdge : nullptr;
    int32_t *bout = k + 1 < stripes
                        ? a.edge + ((size_t)p * 2 + ((k + 1) & 1)) * m * kEdge
                        : nullptr;
    cell.begin(st, a.refs + (size_t)p * n, c0, n);
    // The stripe's steps; kPartial (warp-uniform): its last lane has fewer
    // than kCols real columns.
    auto steps = [&](auto kPartial) {
      Edge edge{0, 0}, in;
      int diag = 0;  // row -1's H
      int code_next = rd[0];
      for (int t = 0; t < m + nl - 1; ++t) {
        const int i = t - lane;
        in.h = __shfl_up_sync(kAll, edge.h, 1);
        if (Cell::kAffine) in.e = __shfl_up_sync(kAll, edge.e, 1);
        if (lane == 0) {
          if (bin == nullptr) {
            in = cell.boundary(i);
          } else if (i < m) {
            in.h = bin[(size_t)i * kEdge];
            if (Cell::kAffine) in.e = bin[(size_t)i * kEdge + 1];
          }
        }
        const int code = code_next;
        code_next = rd[min(max(i + 1, 0), m - 1)];
        if (i >= 0 && i < m && lane < nl) {
          uint32_t word[Cell::kWords];
          int key;
          cell.template row<decltype(kPartial)::value>(st, code, in, diag, edge, word, key,
                                                       ncol);
#pragma unroll
          for (int w = 0; w < Cell::kWords; ++w) {
            const int fill = max(0, min(kPack, n - (c0 + w * kPack)));
            stage[i % kLanes][lane * Cell::kWords + w] =
                finish_word<Cell::kBits, Cell::kCanon, decltype(kPartial)::value>(word[w],
                                                                              fill);
          }
          if (bout != nullptr && lane == kLanes - 1) {
            bout[(size_t)i * kEdge] = edge.h;
            if (Cell::kAffine) bout[(size_t)i * kEdge + 1] = edge.e;
          }
          if (Cell::kLocal) {
            // Rows come in order within a stripe; a later stripe's row can
            // tie the best at a smaller row.
            const int v = key >> 4;
            if (v > best || (v == best && i < brow)) {
              best = v;
              brow = i;
              bcol = c0 + kCols - 1 - (key & (kCols - 1));
            }
          } else if (i == mrp) {
            if (lane == 0 && k == 0) hs[0] = cell.hsel0(mrp);
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              if (c < ncol) {
                hs[c0 + c + 1] = st.h[c] >> 2;
                if (st.h[c] > best) {  // strict: the leftmost maximum wins
                  best = st.h[c];
                  bcol = c0 + c;
                }
              }
            }
          }
        }
        __syncwarp();
        // Row r's words are all staged once lane nl - 1 has computed it.
        const int r = t - nl + 1;
        if (r >= 0) {
          int32_t *prow = pp + (size_t)r * a.nc + s0 / kPack;
#pragma unroll
          for (int q = 0; q < Cell::kWords; ++q) {
            const int j = lane + q * kLanes;
            if (s0 + j * kPack < n) prow[j] = static_cast<int32_t>(stage[r % kLanes][j]);
          }
        }
        __syncwarp();
        diag = in.h;
      }
    };
    if (n - s0 < kStripe && (n - s0) % kCols != 0) steps(std::true_type{});
    else steps(std::false_type{});
  }
  // The warp's reduction.
#pragma unroll
  for (int d = kLanes / 2; d > 0; d /= 2) {
    const int ob = __shfl_xor_sync(kAll, best, d);
    const int orow = __shfl_xor_sync(kAll, brow, d);
    const int ocol = __shfl_xor_sync(kAll, bcol, d);
    if (ob > best || (ob == best && (orow < brow || (orow == brow && ocol < bcol)))) {
      best = ob;
      brow = orow;
      bcol = ocol;
    }
  }
  if (lane == 0) {
    int32_t *aux = a.aux + (size_t)p * 4;
    if (Cell::kLocal) {
      aux[0] = best;
      aux[1] = brow;
      aux[2] = bcol;
    } else {
      aux[0] = (mrp >= 0 && best > cell.seed(mrp)) ? bcol : 0;
      aux[1] = 0;
      aux[2] = 0;
    }
    aux[3] = 0;
  }
}

// The kernel of one Cell: the block's matrix prologue, then one pair per
// warp, each with its ring of staged pointer rows.
template <typename Cell, int kMat>
__device__ __forceinline__ void fill_block(const Args &a) {
  extern __shared__ int32_t smem[];
  __shared__ uint32_t stage[kWarps][kLanes][kLanes * Cell::kWords];
  __shared__ uint2 bytes[8];
  const int32_t *tab;
  const uint8_t *vtab;
  val::matrix_prologue<kMat>(a.table, nullptr, a.s, smem, tab, vtab);
  using Sub = typename Cell::Sub;
  if (kMat == 0) {
    if (threadIdx.x < 8) bytes[threadIdx.x] = Sub::byte_table(threadIdx.x, a.match4, a.mismatch4);
    __syncthreads();
  }
  const int warp = threadIdx.x / kLanes;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= a.b) return;
  fill_pair(a, Cell(a, Sub{tab, bytes, a.s}), p, stage[warp]);
}

// Launches kernel over the pairs of `a` on `stream` with `dynamic` bytes of
// dynamic shared memory (the matrix), opting in past the 48 KB that a
// block may hold with the staged rows by default.
template <typename Kernel>
void launch(Kernel kernel, const Args &a, size_t dynamic, cudaStream_t stream) {
  if (dynamic > 0)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(dynamic));
  kernel<<<(a.b + kWarps - 1) / kWarps, kWarps * kLanes, dynamic, stream>>>(a);
}

}  // namespace fill
