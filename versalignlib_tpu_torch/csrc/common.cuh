// Pieces shared by the kernels of this directory: where an S x S matrix
// lives and how a cell looks it up, and the host-side choice of template
// instantiation, for align.cu, align_affine.cu and the banded kernels; the
// -inf of the recurrences. The pointer fills keep their wavefront in
// fill.cuh, the banded kernels theirs in banded.cuh, and the best-score
// kernels (score.cu, search.cu) their step loop in stripe.cuh.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace val {

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

}  // namespace val
