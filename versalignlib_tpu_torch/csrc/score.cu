// Batched best-score kernel: Smith-Waterman and the reference's semi-global
// "Needleman-Wunsch", linear or affine (Gotoh) gaps, default DNA scoring or
// an S x S substitution matrix, int32 cells.
//
// Replaces versalignlib_tpu/ops/pallas_score.py::_score_kernel (the TPU's
// interpair kernel, 1024 pairs per (8, 128) register tile), all branches.
// Semantics are the JAX kernel's:
// - default scoring: codes 1..4 are A/T/C/G, and code 0 (padding) and 5 (N)
//   score 0 on either side (make_sub_fn, pallas_score.py:104-126);
// - matrix scoring: table[read][ref], codes >= S read as code 0, whose row
//   and column are 0 (pallas_score.py:128-212);
// - affine gaps: F = max(up + open_ref, F_up) + gap_ref flows down each
//   column, E = max(left + open_read, E) + gap_read along each row, both
//   starting at -inf (NEG_INF_I32 = -(2**30)), and SW folds its zero clamp
//   into E (pallas_score.py:294-316), which is max(H, E, 0) of the cell;
// SW returns the local maximum seeded at 0. NW returns the overlap score: the
// maximum over the last column of every row and over the whole final row,
// clamped at 0; on this score path row -1 and column -1 are 0
// (pallas_score.py:284, 349-368), unlike the traceback path's.
//
// What bounds it on an H100: integer operations. A cell costs 10 / 8 int32
// operations SW / NW with linear gaps and DNA scoring, 14 / 12 with affine
// gaps, two fewer with a matrix (chip_smoke.ops_per_cell), and moves no
// bytes of its own: the inputs are m + n bytes a pair, the output 4 bytes.
// So the card must stay busy and the DP must stay out of device memory. A
// thread per pair gives 16384 pairs only 512 warps, one a scheduler, so the
// latency of each instruction down a column's dependent chain shows, and
// its rolling (n, B) H (and F) row must live in device memory. The design
// is the one-vs-many kernel's (search.cu), on a pair's own read and ref:
// - a group of 16 lanes per pair, 8 pairs a block of four warps: 16384
//   pairs are 8192 warps;
// - the step loop is stripe.cuh's group_best: lane l owns kCols consecutive
//   ref columns (32 or 40, the wrapper's choice per launch,
//   ops/cuda_search.search_cols; at 512 columns and 32 a lane, one stripe)
//   and at step t computes read row t - l of them. H (and F) stay in the
//   lane's registers; the left H (and E) come from lane l - 1 by one
//   shuffle; cells go through DPX, a row in two in-place passes. Between
//   stripes the pair's boundary column (m int32, 2m affine) lives in shared
//   memory, or in device memory where a block's eight would not fit. No
//   (n, B) row remains;
// - codes are read pair-major, as the caller passes them, (B, m) and (B, n):
//   each lane loads its ref codes once a stripe and the read code once a
//   step, one step ahead, from the pair's read in device memory (through
//   L1: a 512-byte read serves 512 steps of 16 lanes). Staged in shared
//   memory by the block, the reads took 0.7% more to 3.3% less time across
//   the eight branches (PERF.md): not worth 8m bytes of shared
//   memory a block, which would cap the read length near 29 kbp;
// - substitution: DNA scores that fit a signed byte through byte tables and
//   one prmt a cell; other DNA scores as their 6 x 6 matrix and any S x S
//   matrix one lookup a cell, in shared memory up to 227 KB (kSub 1, opted
//   in past 48 KB), else through the read-only cache (kSub 2).

#include <cstdint>
#include <cuda_runtime.h>

#include "stripe.cuh"

namespace {

using val::kGroup;
using val::kMaxSmemBytes;
using val::kPairs;
using val::kThreads;

struct ScoreArgs {
  const uint8_t *reads;  // (b, m) codes
  const uint8_t *refs;   // (b, n) codes
  const int32_t *table;  // (s, s) matrix [read][ref]; null for the byte tables
  const uint2 *bytes;    // (8,) DNA byte tables (kSub 0)
  int32_t *edge;         // boundary columns in device memory, or null
  int32_t *out;          // (b,) best score per pair
  int b, m, n, s;
  int gap_read, gap_ref, open_read, open_ref;
};

template <bool kLocal, bool kAffine, int kSub, int kCols>
__global__ void __launch_bounds__(kThreads) score_kernel(ScoreArgs a) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ uint2 bytes[8];
  constexpr int kEdge = kAffine ? 2 : 1;
  constexpr int kStripe = kGroup * kCols;
  const int m = a.m, n = a.n, s = a.s;
  const int stripes = (n + kStripe - 1) / kStripe;
  // Shared memory: the table (kSub 1), then the boundary columns.
  const int tab_words = kSub == 1 ? s * s : 0;
  const bool edge_shared = a.edge == nullptr && stripes > 1;
  int32_t *edge_s = smem + tab_words;
  const int32_t *tab = a.table;
  if (kSub == 1) {
    for (int t = threadIdx.x; t < tab_words; t += kThreads) smem[t] = tab[t];
    tab = smem;
  }
  if (kSub == 0 && threadIdx.x < 8) bytes[threadIdx.x] = a.bytes[threadIdx.x];
  __syncthreads();

  const int slot = threadIdx.x / kGroup, lane = threadIdx.x % kGroup;
  const int p_raw = blockIdx.x * kPairs + slot;
  const bool live = p_raw < a.b;
  const int p = live ? p_raw : a.b - 1;  // a group past B computes, stores nothing
  const uint8_t *rows = a.reads + (size_t)p * m;
  const uint8_t *cols = a.refs + (size_t)p * n;
  int32_t *edge = edge_shared ? edge_s + slot * m * kEdge
                 : a.edge == nullptr ? nullptr
                                     : a.edge + (size_t)p_raw * m * kEdge;
  const val::Score<kSub> sc{bytes, reinterpret_cast<const char *>(tab), s, 0};
  const val::Best best = val::group_best<kLocal, kAffine, false, kSub, kCols>(
      sc, rows, cols, edge, m, n, lane, a.gap_read, a.gap_ref, a.open_read, a.open_ref);
  if (lane == 0 && live) a.out[p] = best.v;
}

}  // namespace

// Launch on `stream`; b, m, n, s >= 1. `reads` (b, m) and `refs` (b, n)
// uint8 codes, pair-major. Scoring, one of: `bytes` (8, 2) int32, the DNA
// byte tables of read codes 0..7 (table null, sub 0); `table` (s, s) int32
// [read code][ref code] (bytes null), copied to shared memory (sub 1) or
// read through the read-only cache (sub 2). `edge` is null or, where a
// block's boundary columns do not fit shared memory, (ceil(b / 8) * 8, m,
// affine ? 2 : 1) int32 scratch. `cols` (32 or 40) is the ref columns per
// lane; `smem` the dynamic shared memory of a block: the table (sub 1),
// then, where `edge` is null and n spans more than one stripe, 8 boundary
// columns. ops/cuda_score.launch_plan chooses cols, sub and smem. `out`
// (b,) int32. Returns the first CUDA error (0 on success).
extern "C" int val_score_launch(const void *reads, const void *refs, const void *table,
                                const void *bytes, void *edge, void *out, int b, int m,
                                int n, int s, int gap_read, int gap_ref, int open_read,
                                int open_ref, int local, int affine, int cols, int sub,
                                int smem, void *stream) {
  const ScoreArgs a{static_cast<const uint8_t *>(reads),
                    static_cast<const uint8_t *>(refs),
                    static_cast<const int32_t *>(table),
                    static_cast<const uint2 *>(bytes),
                    static_cast<int32_t *>(edge),
                    static_cast<int32_t *>(out),
                    b, m, n, s, gap_read, gap_ref, open_read, open_ref};
  if ((sub == 0) != (bytes != nullptr) || (sub == 0) != (table == nullptr) || cols <= 0 ||
      smem < 0 || static_cast<size_t>(smem) > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  // The layout must fit what the launch asks for.
  const bool edge_shared = edge == nullptr && n > kGroup * cols;
  const size_t need = (sub == 1 ? sizeof(int32_t) * static_cast<size_t>(s) * s : 0) +
                      (edge_shared ? sizeof(int32_t) * kPairs * m * (affine ? 2 : 1) : 0);
  if (need > static_cast<size_t>(smem)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(val::dispatch_group(
      local, affine, false, sub, cols, [&](auto kL, auto kA, auto kC, auto kS, auto kCo) {
        if constexpr (decltype(kC)::value) {
          return cudaErrorInvalidValue;
        } else {
          const auto kernel = score_kernel<decltype(kL)::value, decltype(kA)::value,
                                           decltype(kS)::value, decltype(kCo)::value>;
          if (const cudaError_t err = val::allow_smem(kernel, smem); err != cudaSuccess)
            return err;
          kernel<<<(b + kPairs - 1) / kPairs, kThreads, smem, st>>>(a);
          return cudaGetLastError();
        }
      }));
}

// The blocks of the instantiation that `local`, `affine`, `sub` and `cols`
// select that one SM holds at once with `smem` bytes of dynamic shared
// memory a block, into *blocks (ops/cuda_score.wave_pairs sizes the score
// path's chunks by it). Returns the first CUDA error (0 on success).
extern "C" int val_score_occupancy(int local, int affine, int cols, int sub, int smem,
                                   int *blocks) {
  if (smem < 0 || static_cast<size_t>(smem) > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(val::dispatch_group(
      local, affine, false, sub, cols, [&](auto kL, auto kA, auto kC, auto kS, auto kCo) {
        if constexpr (decltype(kC)::value) {
          return cudaErrorInvalidValue;
        } else {
          const auto kernel = score_kernel<decltype(kL)::value, decltype(kA)::value,
                                           decltype(kS)::value, decltype(kCo)::value>;
          if (const cudaError_t err = val::allow_smem(kernel, smem); err != cudaSuccess)
            return err;
          return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem);
        }
      }));
}
