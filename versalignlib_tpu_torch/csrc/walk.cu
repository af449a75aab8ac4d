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
// the matrix is START; column -1 is UP for NW and START for SW. A Gotoh
// walk keeps its three states as the JAX walk collapses them: a row entered
// in state H takes the E chain (walk.cuh affine_run) and exits by the hptr
// of the cell where the chain ends; an UP exit whose cell has f_ext set
// enters the next row in state F, which exits UP at once with no LEFT and
// chains on its own cell's f_ext.
//
// What bounds it on an H100: neither bytes nor operations but the latency
// of one dependent load a row: a thread cannot know the next row's cursor
// word before it has the current row's. The bytes are the records (4 a
// row) and one 32-byte sector of pointer words a visited row. The design is
// a thread per pair, which follows its path with data-dependent control
// flow where the TPU needed a branch-free lockstep scan over every word of
// every row: it reads only the cursor's word and, while a LEFT run or E
// chain continues, the words below it. A launch of 4096 pairs is 128 warps,
// one or two an SM.

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
  int b, m, n, nc;
};

}  // namespace walk

namespace {

template <bool kLocal, bool kAffine>
__global__ void __launch_bounds__(walk::kThreads) walk_kernel(walk::Args a) {
  using namespace walk;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
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
  a.ends[k] = sr;
  a.ends[a.b + k] = sf;
  a.ends[2 * a.b + k] = score;

  constexpr int kBoundary = kLocal ? kStart : kUp;  // column -1
  constexpr int kPack = kAffine ? 8 : 16;
  int32_t *rec = a.records + static_cast<size_t>(k) * a.m;
  const int32_t *ptr = a.ptr + static_cast<size_t>(k) * a.m * a.nc;
  int r = a.m - 1;
  const int first = sr < a.m ? sr : -1;
  for (; r > first; --r) rec[r] = 0;
  int fp = sf;
  bool in_f = false;
  for (; r >= 0; --r) {
    const int32_t *row = ptr + static_cast<size_t>(r) * a.nc;
    int out, code;
    if (fp < 0) {
      code = out = kBoundary;  // the run already left the matrix
    } else if (kAffine && in_f) {
      code = out = kUp;
      in_f = (code4(row, fp) >> 3) & 1;
    } else {
      int j, at;
      if (kAffine) {
        at = affine_run(row, fp, a.nc, j);
      } else {
        j = linear_stop<kPack>(row, fp);
        at = j >= 0 ? code2<kPack>(row, j) : 0;
      }
      code = j >= 0 ? (at & 3) : kBoundary;
      out = (fp - j) * 4 + code;
      if (kAffine) in_f = code == kUp && j >= 0 && ((at >> 3) & 1);
      if (code != kStart) fp = code == kDiag ? j - 1 : j;
    }
    rec[r] = out;
    if (code == kStart) {
      --r;
      break;
    }
  }
  for (; r >= 0; --r) rec[r] = 0;
}

}  // namespace

// Launch on `stream`; b >= 1, m >= 1, n >= 1, nc = ceil(n / 16) (linear)
// or ceil(n / 8) (affine). hsel, mrp and mxp may be null for SW.
extern "C" int val_walk_launch(const void *ptr, const void *aux, const void *hsel,
                               const void *mrp, const void *mxp, void *records,
                               void *ends, int b, int m, int n, int nc, int local,
                               int affine, void *stream) {
  walk::Args a{static_cast<const int32_t *>(ptr), static_cast<const int32_t *>(aux),
               static_cast<const int32_t *>(hsel), static_cast<const int32_t *>(mrp),
               static_cast<const int32_t *>(mxp), static_cast<int32_t *>(records),
               static_cast<int32_t *>(ends), b, m, n, nc};
  const dim3 grid((b + walk::kThreads - 1) / walk::kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  if (local && affine) walk_kernel<true, true><<<grid, walk::kThreads, 0, s>>>(a);
  else if (local) walk_kernel<true, false><<<grid, walk::kThreads, 0, s>>>(a);
  else if (affine) walk_kernel<false, true><<<grid, walk::kThreads, 0, s>>>(a);
  else walk_kernel<false, false><<<grid, walk::kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
