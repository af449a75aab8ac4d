// Pieces shared by the kernels of this directory: for score.cu, align.cu
// and align_affine.cu, where an S x S matrix lives and how a cell looks it
// up, and the host-side choice of template instantiation; for score.cu,
// the launch shape, the walk over read rows in sweeps, the SW argmax fold
// and the best-score recurrence, of which it keeps only how a cell finds
// its substitution score. The pointer fills keep their wavefront in
// fill.cuh, and search.cu its own (it takes kNegInf from here).

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace val {

constexpr int kRows = 16;     // read rows per sweep (register wavefront)
constexpr int kThreads = 32;  // one warp per block
constexpr int kNegInf = -(1 << 30);  // pallas_score.NEG_INF_I32
// A matrix whose table (and validity bytes) fit here is copied to shared
// memory (kMat 1); a larger one is read from device memory through the
// read-only cache (kMat 2). Shared memory measured 10-36% faster for
// BLOSUM62 in six of eight branches and equal in the other two
// (scripts/torch_matrix_table.py, PERF.md).
constexpr size_t kSmemTableBytes = 48 << 10;

// kMat: 0 default DNA scoring, 1 matrix in shared memory, 2 matrix read
// from device memory through the read-only cache.
template <int kMat, typename T>
__device__ __forceinline__ T lookup(const T *tab, int idx) {
  if (kMat == 2) return __ldg(tab + idx);
  return tab[idx];
}

// Where a kernel reads the (s, s) table and the (s,) validity bytes: for
// kMat 1 the block copies them to `smem` (table, then bytes) first;
// otherwise they are read where they are. `valid` may be null.
template <int kMat>
__device__ __forceinline__ void matrix_prologue(const int32_t *table,
                                                const uint8_t *valid, int s,
                                                int32_t *smem,
                                                const int32_t *&tab,
                                                const uint8_t *&vtab) {
  tab = table;
  vtab = valid;
  if (kMat != 1) return;
  for (int k = threadIdx.x; k < s * s; k += blockDim.x) smem[k] = table[k];
  uint8_t *v = reinterpret_cast<uint8_t *>(smem + s * s);
  if (valid != nullptr)
    for (int k = threadIdx.x; k < s; k += blockDim.x) v[k] = valid[k];
  __syncthreads();
  tab = smem;
  vtab = v;
}

// Runs sweep(R, i0) over the m read rows: sweeps of kRows rows, then one
// row at a time; R is a std::integral_constant.
template <typename Sweep>
__device__ __forceinline__ void for_sweeps(int m, Sweep &&sweep) {
  int i0 = 0;
  for (; i0 + kRows <= m; i0 += kRows)
    sweep(std::integral_constant<int, kRows>{}, i0);
  for (; i0 < m; ++i0) sweep(std::integral_constant<int, 1>{}, i0);
}

// The gap scores of the best-score recurrence (open_* with affine gaps only).
struct Gaps {
  int gap_read, gap_ref, open_read, open_ref;
};

// The state of one sweep of R read rows for score_sweep: each row's
// substitution state, its left and diagonal H values and its Gotoh E.
template <int R, typename Sub>
struct SweepRows {
  typename Sub::Row row[R];
  int left[R], diag[R], e[R];
};

// What score_column reads of one column before it computes: its input
// (sub.load) and row i0 - 1's H (and F) values.
struct ColumnLoads {
  int in, up, f_up;
};

// Loads column j's input and row i0 - 1's H (and F) values into `l`; row
// -1 is 0 (H) and -inf (F).
template <bool kAffine, typename Sub>
__device__ __forceinline__ void load_column(ColumnLoads &l, const Sub &sub, int j,
                                            int i0, const int32_t *h,
                                            const int32_t *f, size_t stride) {
  l.in = sub.load(j);
  l.up = i0 == 0 ? 0 : h[(size_t)j * stride];
  l.f_up = kAffine ? (i0 == 0 ? kNegInf : f[(size_t)j * stride]) : 0;
}

// Column j of a sweep, from its loads `l`, which it then refills for column
// j + 2 (column n - 1 again past the end, unused), and the store of row
// i0 + R - 1's H (and F) value.
template <int R, bool kLocal, bool kAffine, typename Sub>
__device__ __forceinline__ void score_column(SweepRows<R, Sub> &st, ColumnLoads &l,
                                             const Sub &sub, const Gaps &g,
                                             int j, int n, int i0, int32_t *h,
                                             int32_t *f, size_t stride,
                                             int32_t &best) {
  const typename Sub::Col col = sub.col(l.in);
  int up = l.up;
  int f_up = l.f_up;
  load_column<kAffine>(l, sub, min(j + 2, n - 1), i0, h, f, stride);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = sub.score(st.row[r], col);
    int cur;
    if (kAffine) {
      // max(a + c, b + c) == max(a, b) + c: one add per gap arm.
      const int f_val = max(up + g.open_ref, f_up) + g.gap_ref;
      const int e_val = max(st.left[r] + g.open_read, st.e[r]) + g.gap_read;
      const int e_in = kLocal ? max(e_val, 0) : e_val;
      cur = max(max(st.diag[r] + s, f_val), e_in);
      st.e[r] = e_val;
      f_up = f_val;
    } else {
      int l_in = st.left[r] + g.gap_read;
      if (kLocal) l_in = max(l_in, 0);
      cur = max(max(st.diag[r] + s, up + g.gap_ref), l_in);
    }
    if (kLocal) best = max(best, cur);
    st.diag[r] = up;
    st.left[r] = cur;
    up = cur;
  }
  h[(size_t)j * stride] = up;
  if (kAffine) f[(size_t)j * stride] = f_up;
}

// One sweep of R read rows [i0, i0 + R) across the n columns of one pair:
// the best-score recurrence (pallas_score.py:284-368, pallas_search.py:
// 183-250). Affine gaps: F = max(up + open_ref, F_up) + gap_ref flows down
// each column, E = max(left + open_read, E) + gap_read along each row, both
// from -inf, and SW folds its zero clamp into E. Row i0 - 1's H (and F)
// come from the rolling rows `h` (and `f`), column j at j * stride, and row
// i0 + R - 1's go back; row -1 is 0 (H) and -inf (F), column -1 is 0.
//
// `sub` gives the substitution score: sub.row(i) the state of read row i,
// found once per sweep; sub.load(j) column j's input; sub.col(input) the
// column's state; sub.score(row, col) the cell's. SW folds every cell into
// `best`; NW folds the last column of every row into `best`.
//
// A column's loads are issued two columns ahead, into one set of registers
// for the even columns and one for the odd: each set is refilled as soon as
// its column has read it, so a whole column of arithmetic hides every
// load's latency wherever the compiler places it, and no register move
// waits on a load. Loaded one column ahead, the loads sit where the
// compiler puts them, late in the loop body in some branches, which ran up
// to 47% slower (PERF.md).
template <int R, bool kLocal, bool kAffine, typename Sub>
__device__ __forceinline__ void score_sweep(const Sub &sub, const Gaps &g,
                                            int n, int i0, int32_t *h,
                                            int32_t *f, size_t stride,
                                            int32_t &best) {
  SweepRows<R, Sub> st;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    st.row[r] = sub.row(i0 + r);
    st.left[r] = 0;  // H[i0 + r + 1][0] = 0 on the score path
    st.diag[r] = 0;
    st.e[r] = kNegInf;
  }
  ColumnLoads even, odd;
  load_column<kAffine>(even, sub, 0, i0, h, f, stride);
  load_column<kAffine>(odd, sub, min(1, n - 1), i0, h, f, stride);
  for (int j = 0; j < n; j += 2) {
    score_column<R, kLocal, kAffine>(st, even, sub, g, j, n, i0, h, f, stride, best);
    if (j + 1 < n)
      score_column<R, kLocal, kAffine>(st, odd, sub, g, j + 1, n, i0, h, f, stride, best);
  }
  if (!kLocal) {
    // NW: the last column of every row (DefaultKernel.cpp:177).
#pragma unroll
    for (int r = 0; r < R; ++r) best = max(best, st.left[r]);
  }
}

// The best score of one pair of m read rows and n columns, through
// score_sweep (see there for `sub`, `h`, `f` and `stride`). SW returns the
// local maximum seeded at 0. NW returns the overlap score: the
// maximum over the last column of every row and over the whole final row,
// clamped at 0; on this score path column 0 is 0.
template <bool kLocal, bool kAffine, typename Sub>
__device__ __forceinline__ int32_t score_pair(const Sub &sub, const Gaps &g,
                                              int m, int n, int32_t *h,
                                              int32_t *f, size_t stride) {
  int32_t best = 0;  // the SW seed, and the NW clamp at 0
  for_sweeps(m, [&](auto R, int i0) {
    score_sweep<decltype(R)::value, kLocal, kAffine>(sub, g, n, i0, h, f, stride, best);
  });
  if (!kLocal) {
    // NW: ... and the whole final row (DefaultKernel.cpp:189-191); its
    // column 0 is 0, which the seed covers.
    for (int j = 0; j < n; ++j) best = max(best, h[(size_t)j * stride]);
  }
  return best;
}

// Host side: calls launch(kLocal, kFlag, kMat), each a
// std::integral_constant, for the instantiation that the run's algorithm,
// the source's own flag and the matrix (null for default DNA scoring;
// `table_bytes` of shared memory when copied there) select.
template <typename Launch>
void dispatch(bool local, bool flag, const void *table, size_t table_bytes,
              Launch &&launch) {
  auto with_mat = [&](auto kLocal, auto kFlag) {
    if (table == nullptr)
      launch(kLocal, kFlag, std::integral_constant<int, 0>{});
    else if (table_bytes <= kSmemTableBytes)
      launch(kLocal, kFlag, std::integral_constant<int, 1>{});
    else
      launch(kLocal, kFlag, std::integral_constant<int, 2>{});
  };
  auto with_flag = [&](auto kLocal) {
    if (flag) with_mat(kLocal, std::true_type{});
    else with_mat(kLocal, std::false_type{});
  };
  if (local) with_flag(std::true_type{});
  else with_flag(std::false_type{});
}

// Blocks of kThreads pairs covering b pairs.
inline dim3 grid_for(int b) { return dim3((b + kThreads - 1) / kThreads); }

}  // namespace val
