// Traceback walk over the banded fill's pointer words (banded_align.cu):
// linear gaps (2-bit codes) and Gotoh gaps (4-bit codes hptr | e_ext<<2 |
// f_ext<<3), 8 a word, band-relative: field k of row i is ref column
// offsets[i] + k. SW and the reference's semi-global NW.
//
// Replaces versalignlib_tpu/ops/walk.py::walk_blocks_banded (:324, linear)
// and ::walk_blocks_banded_affine (:413, Gotoh) with wbase = offsets (the
// port's rows are a window whose base is the band start, so the band's low
// edge is field 0), and writes what they return: records (b, m) int32, one
// left_count*4 | exit_code a row, 0 outside the walk; ends (3, b) int32,
// the start row, start column and score. The start cell is derived here
// (walk.py:297-320): SW the fill's best registers; NW row mrp and the first
// maximum of keep over the in-band window [o, min(o + band, n, mxp + 1))
// of that row, (-1, -1, 0) when mrp < 0 or the window is empty. Leaving
// the band on either edge is a hard stop with a START record: a row
// entered out of band stops before any LEFT, and a LEFT run (or E chain)
// that reaches the band's low edge emits down to it and stops. The Gotoh
// states are kept as in walk.cu.
//
// What bounds it on an H100: a row's step depends on where the previous
// row's path left it, so a pair is a chain of 16,000 steps at 16 kbp. Read
// from device memory, each step costs one load latency (about 1 us); the
// bytes (the records and one 32-byte sector a visited row) would take a
// hundredth of that. The design takes the loads off the chain and most
// steps out of it:
// - a warp walks one pair, kWarps pairs a block, so that a launch of 1024
//   pairs fills every SM;
// - a row's address does not depend on the cursor, and along a path the
//   cursor's band field drifts slowly (a DIAG move keeps it, an UP move
//   raises it by the band's step, a LEFT run lowers it), so the warp
//   copies the rows ahead of the cursor into a ring of kStages stages in
//   shared memory (cp.async, one commit group a stage, kAhead stages in
//   flight ahead of the one walked). A stage is 32 rows; of each row it
//   holds the aligned window of kWindow words (64 fields, a 32-byte
//   sector) that holds the field the cursor, carried down the diagonal,
//   is predicted to reach. Where the row has no more words than that, the
//   window is the whole row;
// - the steps are speculated a round at a time: lane l steps row r - l as
//   if the l rows above it were all DIAG with no LEFT, the move a path
//   takes on almost every row of a close pair, so it enters at column
//   fp - l. A ballot finds the first lane whose row made another move;
//   the rows up to it settle, its own too, since its cursor was right. A
//   run of DIAG rows costs a round (a shared-memory read, a row step, a
//   ballot and a shuffle) per 32 rows; any other move ends a round;
// - a miss stays inside the kernel: when the walk's own cursor has left
//   its row's window, the warp waits for the copies in flight and stages
//   the row and the rest of the ring again around the cursor (one load
//   latency); a LEFT run or E chain below a window reads those words from
//   device memory;
// - each round's records leave in one store of consecutive rows, and the
//   zeros outside the walk in coalesced runs.
// What bounds it now: the random accesses to device memory, one window a
// visited row. At 1024 pairs of 16 kbp (about 28 rows a round) an H100
// 80GB HBM3 at 700 W fetched about 23 G windows a second; windows of
// twice the bytes, and twice or half the stages in flight, measured the
// same (PERF.md).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "walk.cuh"

namespace walk {

constexpr int kWarps = 4;        // pairs a block, one warp each
constexpr int kStageRows = 32;   // rows a stage; a round steps one a lane
constexpr int kStages = 4;       // ring slots a warp
constexpr int kAhead = kStages - 1;  // stages in flight ahead of the one walked
// Words of a row a stage holds: one 32-byte sector, aligned. A row's
// window costs the walk one access to device memory, and the accesses,
// not their bytes, bound it (PERF.md).
constexpr int kWindow = 8;
// Words between two rows of a stage in shared memory: the lanes of a round
// read one word of 32 rows at a time, which a pitch of 8 words would put
// on 4 banks; 12 spreads them over 8, 16-byte aligned for the copies.
constexpr int kPitch = kWindow + 4;

struct BandedArgs {
  const int32_t *ptr;      // (b, m, nw) band-relative pointer words
  const int32_t *best;     // (b, 4) SW [score, row, column, 0]
  const int32_t *keep;     // (b, band) NW: the H row of row mrp, band-relative
  const int32_t *mrp;      // (b,) last valid read row, NW only
  const int32_t *mxp;      // (b,) last valid ref column, NW only
  const int32_t *offsets;  // (m,) band start column of each row
  int32_t *records;        // (b, m)
  int32_t *ends;           // (3, b): start row, start column, score
  // Null, or (3,) counts added up: windows staged again, runs below a window, rounds.
  unsigned long long *stats;
  int b, m, n, band, nw;
};

// One warp's ring: the staged words of each slot's rows, and each row's
// band start and first staged word.
struct Ring {
  uint32_t words[kStages][kStageRows][kPitch];
  int off[kStages][kStageRows];
  int ws[kStages][kStageRows];
};

// A word of shared memory at a 32-bit shared address.
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// A row as the banded walk reads it: words [ws, ws + kWindow) from the
// ring, the words below from device memory. The scans only read downward
// from the cursor's word, which is staged.
struct StagedRow {
  uint32_t win;        // shared address of the row's word 0: word ws is staged at win + 4 ws
  const int32_t *row;  // the whole row in device memory
  int ws;
};

__device__ __forceinline__ uint32_t word_at(const StagedRow &r, int w) {
  return w >= r.ws ? lds(r.win + 4 * w) : static_cast<uint32_t>(__ldg(r.row + w));
}

template <int kVec>
__device__ __forceinline__ void copy_async(uint32_t dst, const int32_t *src) {
  if (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void commit_stage() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage q (rows 32q .. 32q + 31, only those <= hi) into ring slot `slot`
// (words_s: the shared address of the ring's words): of each row the
// window that holds the field a cursor at column fp on row r_now reaches
// when carried down the diagonal; `off` is this lane's row's band start.
// Commits one group, empty when q < 0. kVec words a copy (4: 16-byte
// copies, when nw % 4 == 0 and the words are 16-byte aligned).
template <int kVec>
__device__ __forceinline__ void issue_stage(Ring &ring, uint32_t words_s, int slot, int q,
                                            int hi, int fp, int r_now, int off,
                                            const int32_t *ptr, int nw, int win, int lane) {
  if (q >= 0) {
    const int row = kStageRows * q + lane;
    if (row <= hi) {
      const int pw = (fp - (r_now - row) - off) >> 3;  // the predicted word
      // The aligned window that holds it, or the row's last, which holds
      // every word from nw - win up.
      const int ws = min(max(pw & -kWindow, 0), nw - win);
      ring.off[slot][lane] = off;
      ring.ws[slot][lane] = ws;
    }
    __syncwarp();
    constexpr int kChunks = kWindow / kVec;
#pragma unroll 4
    for (int t = 0; t < kChunks; ++t) {
      const int e = lane + 32 * t, i = e / kChunks, c = (e % kChunks) * kVec;
      const int r = kStageRows * q + i;
      if (r <= hi && c < win) {
        copy_async<kVec>(words_s + 4 * ((slot * kStageRows + i) * kPitch + c),
                         ptr + static_cast<size_t>(r) * nw + ring.ws[slot][i] + c);
      }
    }
  }
  commit_stage();
}

}  // namespace walk

namespace {

template <bool kLocal, bool kAffine, int kVec>
__global__ void __launch_bounds__(walk::kWarps * 32) banded_walk_kernel(walk::BandedArgs a) {
  using namespace walk;
  __shared__ __align__(16) Ring rings[kWarps];
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= a.b) return;
  Ring &ring = rings[threadIdx.x >> 5];

  int sr = -1, sf = -1, score = 0;
  if (kLocal) {
    score = a.best[4 * k];
    sr = a.best[4 * k + 1];
    sf = a.best[4 * k + 2];
  } else if (a.mrp[k] >= 0) {
    const int o = __ldg(a.offsets + a.mrp[k]);
    const int width = min(min(o + a.band, a.n), a.mxp[k] + 1) - o;
    if (width > 0) {
      // The first maximum: each lane's own, then the warp's, lowest index
      // on ties.
      const int32_t *keep = a.keep + static_cast<size_t>(k) * a.band;
      int val = INT_MIN, arg = INT_MAX;
      for (int c = lane; c < width; c += 32) {
        const int v = keep[c];
        if (arg == INT_MAX || v > val) {
          val = v;
          arg = c;
        }
      }
      for (int d = 16; d > 0; d >>= 1) {
        const int ov = __shfl_xor_sync(~0u, val, d), oa = __shfl_xor_sync(~0u, arg, d);
        if (ov > val || (ov == val && oa < arg)) {
          val = ov;
          arg = oa;
        }
      }
      score = val;
      sr = a.mrp[k];
      sf = o + arg;
    }
  }
  if (lane == 0) {
    a.ends[k] = sr;
    a.ends[a.b + k] = sf;
    a.ends[2 * a.b + k] = score;
  }

  int32_t *rec = a.records + static_cast<size_t>(k) * a.m;
  const int first = sr < a.m ? sr : -1;
  // The rows above the walk are 0.
  for (int r = first + 1 + lane; r < a.m; r += 32) rec[r] = 0;
  if (first < 0) return;

  const int32_t *ptr = a.ptr + static_cast<size_t>(k) * a.m * a.nw;
  const uint32_t words_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring.words));
  const int win = min(kWindow, a.nw);
  int fp = sf;
  bool in_f = false;
  int q = first / kStageRows;
#pragma unroll 1
  for (int d = 0; d <= kAhead; ++d) {
    const int row = kStageRows * (q - d) + lane;
    issue_stage<kVec>(ring, words_s, (q - d) & (kStages - 1), q - d, first, fp, first,
                      row >= 0 && row <= first ? __ldg(a.offsets + row) : 0, ptr, a.nw, win,
                      lane);
  }
  // The band starts of the next stage to issue, a row a lane.
  int next_row = kStageRows * (q - kAhead - 1) + lane;
  int next_off = next_row >= 0 ? __ldg(a.offsets + next_row) : 0;
  unsigned reissues = 0, deep = 0, rounds = 0;
  int r = first;
  for (;;) {
    wait_stages<kAhead>();
    __syncwarp();
    const int slot = q & (kStages - 1);
    const int lo = kStageRows * q;  // the stage's lowest row
    bool stopped = false;
    while (r >= lo) {
      // A round: lane l steps row r - l entered at column fp - l, where
      // the path enters it if the rows above it in the round are all DIAG
      // with no LEFT. Lane 0's cursor is the walk's own.
      const int row_l = r - lane;
      bool pure = false, miss = false, below = false, in_f_next = false;
      int out = 0, code = kStart, fp_next = 0;
      if (row_l >= lo) {
        const int i = row_l & (kStageRows - 1);
        const int off = ring.off[slot][i], ws = ring.ws[slot][i];
        const int kf = fp - lane - off;  // the cursor's field
        const int x = kf - 8 * ws;       // its field in the window
        const StagedRow row{words_s + 4 * ((slot * kStageRows + i) * kPitch - ws),
                            ptr + static_cast<size_t>(row_l) * a.nw, ws};
        // The cursor's word, read before the tests below; the index is
        // clamped into the window, and a lane that missed is not used.
        const uint32_t word = lds(row.win + 4 * (ws + min(static_cast<unsigned>(x) >> 3,
                                                          static_cast<unsigned>(win - 1))));
        if (static_cast<unsigned>(kf) >= static_cast<unsigned>(a.band)) {
          code = out = kStart;  // entered out of band
        } else if (static_cast<unsigned>(x) >= static_cast<unsigned>(8 * win)) {
          miss = true;  // the cursor left its row's window
        } else {
          int j = kf, at;
          if (kAffine) {
            at = static_cast<int>((word >> (4 * (kf & 7))) & 15u);
            if (in_f && lane == 0) {
              at = (at & 8) | kUp;  // state F: UP at once, chained on its own f_ext
            } else if ((at & 3) == kLeft) {
              // The E chain from field kf - 1: in the cursor's word, or the
              // word below with the cursor's word above it.
              if (kf == 0) j = -1;
              else if (kf & 7) j = chain_stop_from(row, kf - 1, word, 0u, at);
              else j = chain_stop_from(row, kf - 1, word_at(row, (kf >> 3) - 1), word, at);
            }
          } else {
            j = linear_stop_from<8>(row, kf, word, at);
          }
          // A run to the band's low edge (j = -1) emits kf + 1 LEFTs and stops.
          code = j >= 0 ? (at & 3) : kStart;
          out = (kf - j) * 4 + code;
          in_f_next = kAffine && code == kUp && ((at >> 3) & 1);
          fp_next = off + j - (code == kDiag);  // unused once the walk stops
          below = ws > 0 && j < 8 * ws;
          pure = out == kDiag;  // DIAG with no LEFT
        }
      }
      // Rows settle in order up to the first lane that is not pure, its
      // own row too if its cursor was right (a row of the stage, no miss).
      const unsigned impure = __ballot_sync(~0u, !pure);
      const unsigned stepped = __ballot_sync(~0u, row_l >= lo && !miss);
      const int last = impure ? __ffs(impure) - 1 : kStageRows;
      const bool counts = last < kStageRows && ((stepped >> last) & 1u);
      if (last == 0 && !counts) {
        // The walk's own cursor left its window: wait for the copies in
        // flight, stage this row and the rest of the ring again around the
        // cursor, and step the row again.
        ++reissues;
        wait_stages<0>();
        __syncwarp();
#pragma unroll 1
        for (int d = 0; d <= kAhead; ++d) {
          const int s = (q - d) & (kStages - 1);
          issue_stage<kVec>(ring, words_s, s, q - d, d == 0 ? r : kStageRows * (q - d) + 31,
                            fp, r, ring.off[s][lane], ptr, a.nw, win, lane);
        }
        wait_stages<kAhead>();
        __syncwarp();
        continue;
      }
      const int settled = last + counts;
      ++rounds;
      if (lane < settled) rec[row_l] = out;
      deep += __popc(__ballot_sync(~0u, below && lane < settled));
      if (counts) {
        fp = __shfl_sync(~0u, fp_next, last);
        in_f = __shfl_sync(~0u, in_f_next, last);
        r -= settled;
        if (__shfl_sync(~0u, code, last) == kStart) {
          stopped = true;
          break;
        }
      } else {
        fp -= last;
        in_f = false;
        r -= last;
      }
    }
    if (stopped || q == 0) break;
    // Stage q - 1 is next; the slot of stage q is free for stage q - 1 - kAhead.
    --q;
    __syncwarp();
    issue_stage<kVec>(ring, words_s, (q - kAhead) & (kStages - 1), q - kAhead,
                      kStageRows * q + 31, fp, r, next_off, ptr, a.nw, win, lane);
    next_row -= kStageRows;
    next_off = next_row >= 0 ? __ldg(a.offsets + next_row) : 0;
  }
  // The rows below the walk are 0.
  for (int rr = lane; rr <= r; rr += 32) rec[rr] = 0;
  wait_stages<0>();
  if (a.stats != nullptr && lane == 0) {
    atomicAdd(a.stats, static_cast<unsigned long long>(reissues));
    atomicAdd(a.stats + 1, static_cast<unsigned long long>(deep));
    atomicAdd(a.stats + 2, static_cast<unsigned long long>(rounds));
  }
}

template <bool kLocal, bool kAffine, int kVec>
void launch(const walk::BandedArgs &a, cudaStream_t s) {
  const dim3 grid((a.b + walk::kWarps - 1) / walk::kWarps);
  banded_walk_kernel<kLocal, kAffine, kVec><<<grid, walk::kWarps * 32, 0, s>>>(a);
}

template <int kVec>
void dispatch(const walk::BandedArgs &a, bool local, bool affine, cudaStream_t s) {
  if (local && affine) launch<true, true, kVec>(a, s);
  else if (local) launch<true, false, kVec>(a, s);
  else if (affine) launch<false, true, kVec>(a, s);
  else launch<false, false, kVec>(a, s);
}

}  // namespace

// Launch on `stream`; b >= 1, m >= 1, 1 <= band <= n, nw = ceil(band / 8).
// best may be null for NW; keep, mrp and mxp for SW; stats may be null.
extern "C" int val_banded_walk_launch(const void *ptr, const void *best, const void *keep,
                                      const void *mrp, const void *mxp, const void *offsets,
                                      void *records, void *ends, void *stats, int b, int m,
                                      int n, int band, int nw, int local, int affine,
                                      void *stream) {
  walk::BandedArgs a{static_cast<const int32_t *>(ptr), static_cast<const int32_t *>(best),
                     static_cast<const int32_t *>(keep), static_cast<const int32_t *>(mrp),
                     static_cast<const int32_t *>(mxp), static_cast<const int32_t *>(offsets),
                     static_cast<int32_t *>(records), static_cast<int32_t *>(ends),
                     static_cast<unsigned long long *>(stats), b, m, n, band, nw};
  auto s = static_cast<cudaStream_t>(stream);
  // 16-byte copies where every row starts on a 16-byte boundary.
  if (nw % 4 == 0 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0) dispatch<4>(a, local, affine, s);
  else dispatch<1>(a, local, affine, s);
  return static_cast<int>(cudaGetLastError());
}
