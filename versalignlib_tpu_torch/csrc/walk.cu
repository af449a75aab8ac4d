// Traceback walk over the dense fills' pointer words: linear gaps (2-bit
// codes, 16 a word, from align.cu) and Gotoh gaps (4-bit codes hptr |
// e_ext<<2 | f_ext<<3, 8 a word, from align_affine.cu), SW and the
// reference's semi-global NW.
//
// Replaces versalignlib_tpu/ops/walk.py::walk_blocks (:78, linear) and
// ::walk_blocks_affine (:162, Gotoh), and writes what they return:
// - records (b, m) int32: row r's record left_count*4 | exit_code (START,
//   UP or DIAG), 0 on rows outside the walk;
// - ends (3, b) int32: the start row, the start column and the score.
// The start cell is derived here (walk.py:56-73): SW (aux[1], aux[2]) with
// score aux[0]; NW (mrp, min(mxp, aux[0])) with score hsel[clip(start_f,
// -1, n-1) + 1], 0 when mrp < 0, where the walk never starts. Row 0 above
// the matrix is START; column -1 is UP for NW and START for SW. The Gotoh
// states are kept as walk.cuh says.
//
// What bounds it on an H100, and the design: walk.cuh (walk_pair, a warp
// a pair with the rows ahead of the cursor staged in shared memory, steps
// speculated 32 rows a round). A dense row r of pair k starts at ptr + (k*m
// + r)*nc, and its staged window is the aligned 32-byte sector that holds
// the cursor's predicted column: 128 columns linear, 64 Gotoh; rows of at
// most 8 words are staged whole. Once an NW walk reaches column -1, the
// rows left are written UP in one strided run, without their words.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk.cuh"

namespace walk {

struct Args {
  const int32_t *ptr;   // (b, m, nc) pointer words
  const int32_t *aux;   // (b, 4)
  const int32_t *hsel;  // (b, n + 1), NW only
  const int32_t *mrp;   // (b,) last valid read row, NW only
  const int32_t *mxp;   // (b,) last valid ref column, NW only
  int32_t *records;     // (b, m)
  int32_t *ends;        // (3, b): start row, start column, score
  // Null, or (3,) counts added up: windows staged again, runs below a window, rounds.
  unsigned long long *stats;
  int b, m, n, nc;
};

}  // namespace walk

namespace {

template <bool kLocal, bool kAffine, int kVec>
__global__ void __launch_bounds__(walk::kWarps * 32) walk_kernel(walk::Args a) {
  using namespace walk;
  __shared__ Ring<false> rings[kWarps];
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= a.b) return;
  int sr, sf, score;
  if (kLocal) {
    sr = a.aux[4 * k + 1];
    sf = a.aux[4 * k + 2];
    score = a.aux[4 * k];
  } else {
    sr = a.mrp[k];
    sf = min(a.mxp[k], a.aux[4 * k]);
    score = sr >= 0 ? a.hsel[static_cast<size_t>(k) * (a.n + 1) + max(min(sf, a.n - 1), -1) + 1]
                    : 0;
  }
  if (lane == 0) {
    a.ends[k] = sr;
    a.ends[a.b + k] = sf;
    a.ends[2 * a.b + k] = score;
  }
  walk_pair<false, kLocal, kAffine, kVec>(
      rings[threadIdx.x >> 5], a.ptr + static_cast<size_t>(k) * a.m * a.nc, nullptr,
      a.records + static_cast<size_t>(k) * a.m, a.stats, sr < a.m ? sr : -1, sf, a.m, a.nc, 0,
      lane);
}

template <bool kLocal, bool kAffine, int kVec>
void launch(const walk::Args &a, cudaStream_t s) {
  const dim3 grid((a.b + walk::kWarps - 1) / walk::kWarps);
  walk_kernel<kLocal, kAffine, kVec><<<grid, walk::kWarps * 32, 0, s>>>(a);
}

template <int kVec>
void dispatch(const walk::Args &a, bool local, bool affine, cudaStream_t s) {
  if (local && affine) launch<true, true, kVec>(a, s);
  else if (local) launch<true, false, kVec>(a, s);
  else if (affine) launch<false, true, kVec>(a, s);
  else launch<false, false, kVec>(a, s);
}

}  // namespace

// Launch on `stream`; b >= 1, m >= 1, n >= 1, nc = ceil(n / 16) (linear)
// or ceil(n / 8) (affine). hsel, mrp and mxp may be null for SW; stats may
// be null.
extern "C" int val_walk_launch(const void *ptr, const void *aux, const void *hsel,
                               const void *mrp, const void *mxp, void *records, void *ends,
                               void *stats, int b, int m, int n, int nc, int local, int affine,
                               void *stream) {
  walk::Args a{static_cast<const int32_t *>(ptr), static_cast<const int32_t *>(aux),
               static_cast<const int32_t *>(hsel), static_cast<const int32_t *>(mrp),
               static_cast<const int32_t *>(mxp), static_cast<int32_t *>(records),
               static_cast<int32_t *>(ends), static_cast<unsigned long long *>(stats),
               b, m, n, nc};
  auto s = static_cast<cudaStream_t>(stream);
  // 16-byte copies where every row starts on a 16-byte boundary.
  if (nc % 4 == 0 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0) dispatch<4>(a, local, affine, s);
  else dispatch<1>(a, local, affine, s);
  return static_cast<int>(cudaGetLastError());
}
