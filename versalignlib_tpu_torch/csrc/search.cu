// One-vs-many best-score kernel: K query sequences (or position-specific
// profiles) against a pool of R sequences, Smith-Waterman or the
// reference's semi-global "Needleman-Wunsch", linear or affine (Gotoh) gaps,
// int32 cells, and for SW optionally each pair's argmax cell.
//
// Replaces versalignlib_tpu/ops/pallas_search.py::_search_kernel (the TPU's
// one-vs-many kernel: one query broadcast from SMEM against 1024
// lane-resident pool sequences), all branches. Semantics are the JAX
// kernel's:
// - DP rows are always the read (m) and columns always the ref (n); only
//   where the codes come from changes (pallas_search.py:57-60). With
//   query_is_read the K queries are reads and the pool holds refs; otherwise
//   the queries are refs and the pool holds reads;
// - the recurrence, the SW seed at 0 and the NW overlap score (the last
//   column of every row, then the whole final row, column 0 = 0, clamped at
//   0) are score.cu's;
// - with_coords (SW only): (end_row, end_col) by the row-major strict
//   first-win rule, per-row leftmost strict maxima merged in ascending row
//   order, (0, 0) where the best is 0 (pallas_search.py:183-245).
//
// Scoring of every kind arrives as one table, the query profile: an
// (Lq, S) int32 table per query, Lq the query's length, with
// sub(query position q, pool code c) = prof[q][c < S ? c : 0] and column 0
// all zero, so codes past S score 0. The wrapper (ops/cuda_search.py)
// builds it from the default DNA table or an S x S matrix and the query's
// codes; a PSSM is already one (ops/pssm.py). A cell then pays one add and
// one lookup whatever the scoring, and a warp's 32 lookups of a cell fall
// on at most S consecutive words of one row, so shared memory serves them
// without bank conflicts.
//
// What bounds it on an H100: integer operations, counted from the cell
// loop (8 / 6 per SW / NW cell linear, 12 / 10 affine, +2 with coords;
// chip_smoke.ops_per_cell).
// What the design does about device memory, the reason this kernel exists
// (pallas_search.py:3-16): no (K*R, m + n) cross product of pair codes is
// ever made. The card holds the K + R sequences, the K query profiles, the
// (K, R) outputs and the rolling H row (and F row), (n, K*R) int32 scratch.
// - one thread per (query, pool sequence) pair; blockIdx.y walks the
//   queries and blockIdx.x blocks of kThreads pool sequences, so a block
//   shares one query: its profile is copied to shared memory once per block
//   (kTab 1, up to 227 KB with the opt-in), or read through the read-only
//   cache when it is larger (kTab 2);
// - pool codes arrive pair-interleaved, (len, R) uint8, as in score.cu;
// - the sweep and the recurrence are common.cuh's val::score_pair, shared
//   with score.cu: 16 read rows per sweep, each next column's loads started
//   before the current column is computed. This source keeps how a cell
//   finds its substitution score (ProfileSub).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using val::lookup;
constexpr int kThreads = 128;        // pool sequences per block
constexpr int kMaxGridY = 65535;
// The most dynamic shared memory a block of sm_90 may opt in to.
constexpr size_t kMaxSmemBytes = 227 << 10;
constexpr size_t kDefaultSmemBytes = 48 << 10;

struct SearchArgs {
  const uint8_t *pool;   // (pool_len, r) codes: refs (query_is_read) or reads
  const int32_t *prof;   // (k, qlen, s) query profiles
  int32_t *h;            // (n, k * r) rolling H row, columns 1..n
  int32_t *f;            // (n, k * r) rolling Gotoh F row (affine only)
  int32_t *out;          // (k, r) best score per pair
  int32_t *end_row;      // (k, r) SW argmax row (coords only)
  int32_t *end_col;      // (k, r) SW argmax column (coords only)
  int k, r, m, n, s, k0;
  int query_is_read;
  int gap_read, gap_ref, open_read, open_ref;
};

// The query profile as the substitution of val::score_sweep: row + col is
// the cell's index in the profile. With query_is_read a read row gives the
// profile row (q = i) and the pool's ref code the column; otherwise the
// pool's read code gives the column and the ref position the profile row
// (q = j). `pool` points at the pool sequence's first code, stride r.
template <int kTab>
struct ProfileSub {
  const uint8_t *pool;
  const int32_t *prof;
  int r, s, query_is_read;
  using Row = int;
  using Col = int;
  __device__ int code(int i) const {
    const int c = pool[(size_t)i * r];
    return c < s ? c : 0;  // codes past S read as 0, whose column is 0
  }
  __device__ int row(int i) const { return query_is_read ? i * s : code(i); }
  __device__ int load(int j) const { return query_is_read ? code(j) : j * s; }
  __device__ int col(int c) const { return c; }
  __device__ int score(int ro, int co) const { return lookup<kTab>(prof, ro + co); }
};

// One (query, pool sequence) pair per thread.
template <bool kLocal, bool kAffine, bool kCoords, int kTab>
__device__ __forceinline__ void search_pair(const SearchArgs &a) {
  extern __shared__ int32_t smem[];
  const int k = a.k0 + blockIdx.y;
  const int qlen = a.query_is_read ? a.m : a.n;
  const size_t words = (size_t)qlen * a.s;
  const int32_t *prof = a.prof + (size_t)k * words;
  if (kTab == 1) {
    for (size_t t = threadIdx.x; t < words; t += blockDim.x) smem[t] = prof[t];
    __syncthreads();
    prof = smem;
  }
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.r) return;
  const size_t np = (size_t)a.k * a.r;
  const size_t pp = (size_t)k * a.r + p;
  const val::Gaps g{a.gap_read, a.gap_ref, a.open_read, a.open_ref};
  const ProfileSub<kTab> sub{a.pool + p, prof, a.r, a.s, a.query_is_read};
  val::FillResult res;
  a.out[pp] = val::score_pair<kLocal, kAffine, kCoords>(
      sub, g, a.m, a.n, a.h + pp, kAffine ? a.f + pp : nullptr, np, res);
  if (kCoords) {
    a.end_row[pp] = res.row;
    a.end_col[pp] = res.col;
  }
}

// Where ptxas, given the block size alone, spilled (8-28 bytes: SW linear
// with either table, SW affine with the shared table, SW affine with
// coordinates through the read-only cache), a least number of blocks per
// SM lets it keep everything in registers: 80, 95 and 161 registers where
// it had used 72, 80 and 128 (the fewest that spill nothing, chip_smoke's
// register report). Every other instantiation keeps the block size alone.
template <bool kLocal, bool kAffine, bool kCoords, int kTab>
constexpr int kMinBlocks = !kLocal ? 0
                           : !kAffine ? (kCoords ? 0 : 6)
                           : kCoords ? (kTab == 2 ? 3 : 0)
                           : (kTab == 1 ? 5 : 0);

template <bool kLocal, bool kAffine, bool kCoords, int kTab>
__global__ void __launch_bounds__(kThreads) search_kernel(SearchArgs a) {
  search_pair<kLocal, kAffine, kCoords, kTab>(a);
}

template <bool kLocal, bool kAffine, bool kCoords, int kTab, int kMin>
__global__ void __launch_bounds__(kThreads, kMin) search_min_kernel(SearchArgs a) {
  search_pair<kLocal, kAffine, kCoords, kTab>(a);
}

// The kernel of one instantiation.
template <bool kLocal, bool kAffine, bool kCoords, int kTab>
constexpr auto kernel_of() {
  constexpr int kMin = kMinBlocks<kLocal, kAffine, kCoords, kTab>;
  if constexpr (kMin == 0) return search_kernel<kLocal, kAffine, kCoords, kTab>;
  else return search_min_kernel<kLocal, kAffine, kCoords, kTab, kMin>;
}

// Launches one instantiation over the k queries, kMaxGridY at a time;
// returns the first CUDA error.
template <bool kLocal, bool kAffine, bool kCoords, int kTab>
cudaError_t launch(SearchArgs a, size_t smem, cudaStream_t stream) {
  const auto kernel = kernel_of<kLocal, kAffine, kCoords, kTab>();
  if (smem > kDefaultSmemBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  for (int k0 = 0; k0 < a.k; k0 += kMaxGridY) {
    a.k0 = k0;
    const int ky = a.k - k0 < kMaxGridY ? a.k - k0 : kMaxGridY;
    const dim3 grid((a.r + kThreads - 1) / kThreads, ky);
    kernel<<<grid, kThreads, smem, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool kLocal, bool kCoords>
cudaError_t with_gaps_and_table(const SearchArgs &a, bool affine, size_t tab_bytes,
                                cudaStream_t stream) {
  const bool in_smem = tab_bytes <= kMaxSmemBytes;
  if (affine) {
    return in_smem ? launch<kLocal, true, kCoords, 1>(a, tab_bytes, stream)
                   : launch<kLocal, true, kCoords, 2>(a, 0, stream);
  }
  return in_smem ? launch<kLocal, false, kCoords, 1>(a, tab_bytes, stream)
                 : launch<kLocal, false, kCoords, 2>(a, 0, stream);
}

}  // namespace

// Launch on `stream`; k, r, m, n, s >= 1. `prof` is the (k, qlen, s) int32
// query profiles, qlen = m when query_is_read else n; `pool` the
// (pool_len, r) uint8 codes, pool_len = n when query_is_read else m; `h`
// (and `f` when affine) (n, k * r) int32 scratch; `out` (k, r) int32; and
// with coords (SW only) `end_row`, `end_col` (k, r) int32. Returns the first
// CUDA error (0 on success).
extern "C" int val_search_launch(const void *pool, const void *prof, void *h,
                                 void *f, void *out, void *end_row,
                                 void *end_col, int k, int r, int m, int n,
                                 int s, int query_is_read, int gap_read,
                                 int gap_ref, int open_read, int open_ref,
                                 int local, int affine, int coords,
                                 void *stream) {
  SearchArgs a{static_cast<const uint8_t *>(pool),
               static_cast<const int32_t *>(prof),
               static_cast<int32_t *>(h),
               static_cast<int32_t *>(f),
               static_cast<int32_t *>(out),
               static_cast<int32_t *>(end_row),
               static_cast<int32_t *>(end_col),
               k, r, m, n, s, 0, query_is_read,
               gap_read, gap_ref, open_read, open_ref};
  const size_t tab_bytes =
      sizeof(int32_t) * static_cast<size_t>(query_is_read ? m : n) * s;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!local) err = with_gaps_and_table<false, false>(a, affine, tab_bytes, st);
  else if (coords) err = with_gaps_and_table<true, true>(a, affine, tab_bytes, st);
  else err = with_gaps_and_table<true, false>(a, affine, tab_bytes, st);
  return static_cast<int>(err);
}
