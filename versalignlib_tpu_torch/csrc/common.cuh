// Pieces shared by the kernels of this directory (score.cu, align.cu,
// align_affine.cu): the launch shape, where an S x S matrix lives and how a
// cell looks it up, the walk over read rows in sweeps, the walk over
// columns in pointer words and the store of those words, the SW argmax fold
// and the aux word, and the host-side choice of template instantiation.
// Each source keeps only its recurrence and its per-row state.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace val {

constexpr int kRows = 16;     // read rows per sweep (register wavefront)
constexpr int kThreads = 32;  // one warp per block
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

// Runs step(j, u) over the n ref columns, u the field of column j in its
// pointer word of kPack fields, and store(w, fill) once word w holds its
// `fill` fields (kPack, or fewer in a partial last word).
template <int kPack, typename Step, typename Store>
__device__ __forceinline__ void for_words(int n, Step &&step, Store &&store) {
  const int full = n / kPack;
  for (int w = 0; w < full; ++w) {
#pragma unroll
    for (int u = 0; u < kPack; ++u) step(w * kPack + u, u);
    store(w, kPack);
  }
  const int fill = n - full * kPack;
  if (fill) {
    for (int u = 0; u < fill; ++u) step(full * kPack + u, u);
    store(full, fill);
  }
}

// Stores the R words of a sweep (kBits-bit fields, 32 / kBits per word) at
// word w of each row of `prow` (row stride nc) and clears them. Canonical
// flavor: the 2-bit move priority in the low bits of each field becomes its
// stored code (START 3->0, DIAG 2->3, UP 1->1, LEFT 0->2), the field's other
// bits (the Gotoh extend bits) stay, and the unfilled fields of a partial
// word, which would read LEFT, are zeroed to START.
template <int R, int kBits, bool kCanon>
__device__ __forceinline__ void store_words(uint32_t (&word)[R], int32_t *prow,
                                            int nc, int w, int fill) {
  constexpr int kPack = 32 / kBits;
  // Bit 0 of every field, and the bits above a field's 2-bit priority.
  constexpr uint32_t even = 0xFFFFFFFFu / ((1u << kBits) - 1u);
  constexpr uint32_t keep = ~(even | (even << 1));
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t v = word[r];
    if (kCanon) {
      v = (v & keep) | ((~v & even) << 1) | (((v >> 1) ^ v) & even);
      if (fill < kPack) v &= (1u << (kBits * fill)) - 1u;
    }
    prow[(size_t)r * nc + w] = static_cast<int32_t>(v);
    word[r] = 0;
  }
}

// The pair's result of a pointer fill: SW folds each sweep's row maxima in
// row order with strict first-win; NW takes row mrp's argmax.
struct FillResult {
  int best = 0, row = 0, col = 0, nw_arg = 0;

  template <int R>
  __device__ __forceinline__ void fold_rows(const int (&best_r)[R],
                                            const int (&arg_r)[R], int i0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (best_r[r] > best) {
        best = best_r[r];
        row = i0 + r;
        col = arg_r[r];
      }
    }
  }

  // aux (4,): SW [max, argmax_row, argmax_col, 0] (best in the shifted
  // domain); NW [argmax of row mrp, 0, 0, 0].
  __device__ __forceinline__ void write_aux(int32_t *aux, bool local) const {
    aux[0] = local ? best >> 2 : nw_arg;
    aux[1] = local ? row : 0;
    aux[2] = local ? col : 0;
    aux[3] = 0;
  }
};

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
