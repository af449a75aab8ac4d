// The traceback walks' design, shared by walk.cu (dense, B7 and B8) and
// banded_walk.cu (banded, B9 and B10): the move codes, the scans that end a
// row's LEFT run or E chain, and one warp's walk of one pair with the rows
// ahead of its cursor staged in shared memory.
//
// A walk follows one pair from its start cell up the read rows. On a row
// the path is k LEFT moves and one exit move (UP, DIAG or START), so the
// walk writes one record, k*4 | exit, per row (0 outside the walk), and the
// host replays the records without the pointer words
// (versalignlib_tpu/ops/walk.py). A run ends at the highest stop flag at or
// below the cursor, 31 - __clz of the flag bits, with __clz(0) = 32 kept
// out by a test for no flag. The flag arithmetic runs in uint32_t, where
// the JAX walks' int32 shifts would overflow or shift a negative value.
//
// What bounds a walk on an H100: a row's step depends on where the
// previous row's path left it, so a pair is a chain of dependent steps, one
// a row. Read from device memory, each step costs one load latency (about
// 1 us); the bytes (the records and one 32-byte sector a visited row) would
// take a hundredth of that. The design (walk_pair) takes the loads off the
// chain and most steps out of it:
// - a warp walks one pair, kWarps pairs a block, so that a launch of a
//   thousand pairs or more fills every SM;
// - a row's address does not depend on the cursor, and along a path the
//   cursor drifts slowly (a DIAG move takes it one column down, an UP move
//   keeps its column, a LEFT run takes it further down), so the warp copies
//   the rows ahead of the cursor into a ring of kStages stages in shared
//   memory (cp.async, one commit group a stage, kAhead stages in flight
//   ahead of the one walked). A stage is 32 rows; of each row it holds the
//   aligned window of kWindow words (a 32-byte sector) that holds the field
//   the cursor is predicted to reach if it repeats the speculated move
//   (below). Where the row has no more words than that, the window is the
//   whole row;
// - the steps are speculated a round at a time: lane l steps row r - l as
//   if the l rows above it had all made one move, so that it enters at a
//   column it can compute. The move is DIAG with no LEFT, which a path
//   takes on most rows of a close pair (the lane enters at column fp - l),
//   unless a dense walk is in a gap: in state F, or after two rows UP with
//   no LEFT, it is UP with no LEFT (the lane enters at fp), as on most
//   rows of an NW walk between unrelated sequences. A ballot finds the
//   first lane whose row made another move; the rows up to it settle, its
//   own too, since its cursor was right. A run of rows that repeat the
//   move costs a round (a shared-memory read, a row step, a ballot and a
//   shuffle) per 32 rows; any other move ends a round;
// - a miss stays inside the kernel: when the walk's own cursor has left its
//   row's window, the warp waits for the copies in flight and stages the
//   row and the rest of the ring again around the cursor (one load
//   latency); a LEFT run or E chain below a window reads those words from
//   device memory;
// - each round's records leave in one store of consecutive rows, and the
//   zeros outside the walk in coalesced runs.
// What bounds it then (PERF.md): on close pairs (the banded walks' long
// reads, 28 rows a round), the random accesses to device memory, one
// window a visited row; on unrelated pairs (the dense walks' random main
// path, whose rows alternate DIAG and UP), the rounds, 3.6-8.3 rows each.
//
// The two row layouts, a template argument of walk_pair:
// - dense (kBanded false): field j of a row is ref column j, 16 2-bit codes
//   a word (linear) or 8 4-bit Gotoh codes hptr | e_ext<<2 | f_ext<<3. A
//   run past column 0 reaches column -1, which is UP for NW (every row left
//   up to row 0 is then UP with no LEFT) and START for SW;
// - banded (kBanded true): field k of row i is ref column offsets[i] + k, 8
//   codes a word (2-bit codes in the low 16 bits). Leaving the band on
//   either edge is a hard stop with a START record: a row entered out of
//   band stops before any LEFT, and a run that reaches the band's low edge
//   emits down to it and stops.
// A Gotoh walk keeps its three states as the JAX walk collapses them: a row
// entered in state H takes the E chain and exits by the hptr of the cell
// where the chain ends; an UP exit whose cell has f_ext set enters the next
// row in state F, which exits UP at once with no LEFT and chains on its own
// cell's f_ext.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace walk {

constexpr int kStart = 0, kUp = 1, kLeft = 2, kDiag = 3;  // types.Trace

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

// A word of shared memory at a 32-bit shared address.
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// A row as a walk reads it: words [ws, ws + kWindow) from the ring, the
// words below from device memory. The scans only read downward from the
// cursor's word, which is staged.
struct StagedRow {
  uint32_t win;        // shared address of the row's word 0: word ws is staged at win + 4 ws
  const int32_t *row;  // the whole row in device memory
  int ws;
};

__device__ __forceinline__ uint32_t word_at(const StagedRow &r, int w) {
  return w >= r.ws ? lds(r.win + 4 * w) : static_cast<uint32_t>(__ldg(r.row + w));
}

// The highest field at or below `pos` (>= 0) whose 2-bit code is not LEFT,
// -1 if none: kPack codes a word (16 dense; 8 banded, in the low 16 bits).
// `word` is the word that holds `pos`, read by the caller; words below it
// are read only while the run continues. `code` gets the stop's code, taken
// from the word where the run stopped: its flag bit is the code's low bit.
template <int kPack>
__device__ __forceinline__ int linear_stop_from(const StagedRow &row, int pos, uint32_t word,
                                                int &code) {
  constexpr uint32_t kFlags = kPack == 16 ? 0x55555555u : 0x5555u;
  int w = static_cast<unsigned>(pos) / kPack;
  // Wraps to all ones at field 15.
  uint32_t mask = (2u << (2 * (static_cast<unsigned>(pos) % kPack))) - 1u;
  for (;;) {
    const uint32_t stops = ~((word >> 1) & ~word) & kFlags & mask;
    if (stops != 0u) {
      const int bit = 31 - __clz(static_cast<int>(stops));
      code = static_cast<int>((word >> bit) & 3u);
      return w * kPack + (bit >> 1);
    }
    if (--w < 0) return -1;
    word = word_at(row, w);
    mask = ~0u;
  }
}

// The end of a Gotoh E chain: the highest field j in [0, p] (p >= 0) where
// cont(j) = e_ext(j+1) | hptr(j) == LEFT is clear, -1 if none. `word` holds
// field p; `above` is the next word (its field 0 is field j+1 of p's word's
// last field), read only when p is a word's last field, else any value.
// `code` gets the 4-bit code of the field where the chain stopped.
__device__ __forceinline__ int chain_stop_from(const StagedRow &row, int p, uint32_t word,
                                               uint32_t above, int &code) {
  constexpr uint32_t kFlags = 0x11111111u;
  int w = p >> 3;
  uint32_t mask = (2u << (4 * (p & 7))) - 1u;
  for (;;) {
    const uint32_t is_left = (word >> 1) & ~word & kFlags;
    const uint32_t ext = (word >> 2) & kFlags;
    const uint32_t cont = (ext >> 4) | (((above >> 2) & 1u) << 28) | is_left;
    const uint32_t stops = ~cont & kFlags & mask;
    if (stops != 0u) {
      const int bit = 31 - __clz(static_cast<int>(stops));
      code = static_cast<int>((word >> bit) & 15u);
      return w * 8 + (bit >> 2);
    }
    if (--w < 0) return -1;
    above = word;
    word = word_at(row, w);
    mask = ~0u;
  }
}

// The band starts of a banded ring's rows; a dense ring has none.
template <bool kBanded>
struct RingOffsets {
  int off[kStages][kStageRows];
};
template <>
struct RingOffsets<false> {};

// One warp's ring: the staged words of each slot's rows, each row's first
// staged word and (banded) its band start. 16-byte aligned: the copies
// write 16 bytes at a time.
template <bool kBanded>
struct __align__(16) Ring : RingOffsets<kBanded> {
  uint32_t words[kStages][kStageRows][kPitch];
  int ws[kStages][kStageRows];
};

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
// when carried up at `slope` columns a row (1: down the diagonal, 0:
// straight up), 1 << kShift fields a word; `off` is this
// lane's row's band start (0 dense). Commits one group, empty when q < 0.
// kVec words a copy (4: 16-byte copies, when nw % 4 == 0 and the words are
// 16-byte aligned).
template <bool kBanded, int kShift, int kVec>
__device__ __forceinline__ void issue_stage(Ring<kBanded> &ring, uint32_t words_s, int slot,
                                            int q, int hi, int fp, int r_now, int slope,
                                            int off, const int32_t *ptr, int nw, int win,
                                            int lane) {
  if (q >= 0) {
    const int row = kStageRows * q + lane;
    if (row <= hi) {
      const int pw = (fp - slope * (r_now - row) - off) >> kShift;  // the predicted word
      // The aligned window that holds it, or the row's last, which holds
      // every word from nw - win up.
      const int ws = min(max(pw & -kWindow, 0), nw - win);
      if constexpr (kBanded) ring.off[slot][lane] = off;
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

// One warp's walk of one pair: rows `first` (the start row; -1 or less
// when the walk never starts) up to 0 of the pair's pointer rows `ptr` (m
// rows of nw words), from column `fp`, into its records `rec` (every row
// written: the walk's records, 0 above and below it). `offsets` (banded)
// are the rows' band starts, `band` the band's width. `stats`, if not
// null, gets the windows staged again, the runs read below a window and
// the rounds added.
template <bool kBanded, bool kLocal, bool kAffine, int kVec>
__device__ __forceinline__ void walk_pair(Ring<kBanded> &ring, const int32_t *ptr,
                                          const int32_t *offsets, int32_t *rec,
                                          unsigned long long *stats, int first, int fp, int m,
                                          int nw, int band, int lane) {
  constexpr int kShift = kBanded || kAffine ? 3 : 4;  // log2 of the fields a word
  constexpr int kFields = 1 << kShift;
  // The record of a run past field 0: the band's low edge, or the dense
  // column -1.
  constexpr int kBoundary = kBanded || kLocal ? kStart : kUp;
  // Whether a round may speculate UP (the dense walks). The banded walks'
  // pairs are close (reads against the window they came from), where two
  // UP rows in a row are mostly a short insertion's, and speculating UP
  // after them cost rounds and windows staged again (PERF.md).
  constexpr bool kGaps = !kBanded;
  // The rows above the walk are 0.
  for (int r = first + 1 + lane; r < m; r += 32) rec[r] = 0;
  if (first < 0) return;

  const uint32_t words_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring.words));
  const int win = min(kWindow, nw);
  // A start past a dense row's fields, which no fill gives, walks from its
  // last field, so that every cursor lies in some window.
  if constexpr (!kBanded) fp = min(fp, kFields * nw - 1);
  bool in_f = false;
  // The move each round speculates: DIAG with no LEFT (slope 1) unless
  // (kGaps) the walk is in state F or its last two rows were UP with no
  // LEFT, which most rows of a long gap are (slope 0, UP with no LEFT in
  // the walk's state). `ups` counts the UP rows with no LEFT that the
  // walk's last rows made in a row.
  int slope = 1, ups = 0;
  int q = first / kStageRows;
#pragma unroll 1
  for (int d = 0; d <= kAhead; ++d) {
    const int row = kStageRows * (q - d) + lane;
    int off = 0;
    if constexpr (kBanded) off = row >= 0 && row <= first ? __ldg(offsets + row) : 0;
    issue_stage<kBanded, kShift, kVec>(ring, words_s, (q - d) & (kStages - 1), q - d, first,
                                       fp, first, slope, off, ptr, nw, win, lane);
  }
  // The band starts of the next stage to issue, a row a lane.
  int next_row = kStageRows * (q - kAhead - 1) + lane;
  int next_off = 0;
  if constexpr (kBanded) next_off = next_row >= 0 ? __ldg(offsets + next_row) : 0;
  unsigned reissues = 0, deep = 0, rounds = 0;
  int r = first;
  for (;;) {
    wait_stages<kAhead>();
    __syncwarp();
    const int slot = q & (kStages - 1);
    const int lo = kStageRows * q;  // the stage's lowest row
    bool stopped = false;
    while (r >= lo) {
      if constexpr (!kBanded && !kLocal) {
        if (fp < 0) {
          // NW at column -1: every row left is UP with no LEFT.
          for (int rr = lane; rr <= r; rr += 32) rec[rr] = kUp;
          r = -1;
          stopped = true;
          break;
        }
      }
      // A round: lane l steps row r - l entered at column fp - slope * l
      // (in the walk's state where kGaps, else in state H), where the path
      // enters it if the rows above it in the round all made the
      // speculated move. Lane 0's cursor and state are the walk's own.
      const int row_l = r - lane;
      bool pure = false, miss = false, below = false, in_f_next = false;
      int out = 0, fp_next = 0;
      if (row_l >= lo) {
        const int i = row_l & (kStageRows - 1);
        int off = 0;
        if constexpr (kBanded) off = ring.off[slot][i];
        const int ws = ring.ws[slot][i];
        const int kf = fp - slope * lane - off;  // the cursor's field
        const int x = kf - kFields * ws;  // its field in the window
        const StagedRow row{words_s + 4 * ((slot * kStageRows + i) * kPitch - ws),
                            ptr + static_cast<size_t>(row_l) * nw, ws};
        // The cursor's word, read before the tests below; the index is
        // clamped into the window, and a lane that missed is not used.
        const uint32_t word = lds(row.win + 4 * (ws + min(static_cast<unsigned>(x) >> kShift,
                                                          static_cast<unsigned>(win - 1))));
        if (kBanded ? static_cast<unsigned>(kf) >= static_cast<unsigned>(band) : kf < 0) {
          // Banded: entered out of band. Dense: at column -1, past the
          // lanes above it, which were DIAG down to column 0.
          out = kBoundary;
          fp_next = -1;
        } else if (static_cast<unsigned>(x) >= static_cast<unsigned>(kFields * win)) {
          miss = true;  // the cursor left its row's window
        } else {
          int j = kf, at;
          if (kAffine) {
            at = static_cast<int>((word >> (4 * (kf & 7))) & 15u);
            if (in_f && (kGaps || lane == 0)) {
              at = (at & 8) | kUp;  // state F: UP at once, chained on its own f_ext
            } else if ((at & 3) == kLeft) {
              // The E chain from field kf - 1: in the cursor's word, or the
              // word below with the cursor's word above it.
              if (kf == 0) j = -1;
              else if (kf & 7) j = chain_stop_from(row, kf - 1, word, 0u, at);
              else j = chain_stop_from(row, kf - 1, word_at(row, (kf >> 3) - 1), word, at);
            }
          } else {
            j = linear_stop_from<kFields>(row, kf, word, at);
          }
          // A run past field 0 (j = -1) emits kf + 1 LEFTs and exits by the
          // boundary's code.
          const int code = j >= 0 ? (at & 3) : kBoundary;
          out = (kf - j) * 4 + code;
          in_f_next = kAffine && code == kUp && j >= 0 && ((at >> 3) & 1);
          fp_next = off + j - (code == kDiag);  // unused once the walk stops
          below = ws > 0 && j < kFields * ws;
          // The speculated move, leaving the next row in the same state.
          pure = out == (slope ? kDiag : kUp) && (!kGaps || in_f_next == in_f);
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
          int off = 0;
          if constexpr (kBanded) off = ring.off[s][lane];
          issue_stage<kBanded, kShift, kVec>(ring, words_s, s, q - d,
                                             d == 0 ? r : kStageRows * (q - d) + 31, fp, r,
                                             slope, off, ptr, nw, win, lane);
        }
        wait_stages<kAhead>();
        __syncwarp();
        continue;
      }
      const int settled = last + counts;
      ++rounds;
      if (lane < settled) rec[row_l] = out;
      deep += __popc(__ballot_sync(~0u, below && lane < settled));
      // The `last` rows before the first impure one made the speculated
      // move.
      if (!slope) ups += last;
      else if (last > 0) ups = 0;
      if (counts) {
        const int out_last = __shfl_sync(~0u, out, last);
        fp = __shfl_sync(~0u, fp_next, last);
        in_f = __shfl_sync(~0u, in_f_next, last);
        r -= settled;
        if ((out_last & 3) == kStart) {
          stopped = true;
          break;
        }
        ups = out_last == kUp ? ups + 1 : 0;
      } else {
        fp -= slope * last;
        if constexpr (!kGaps) in_f = false;
        r -= last;
      }
      if constexpr (kGaps) slope = (kAffine && in_f) || ups >= 2 ? 0 : 1;
    }
    if (stopped || q == 0) break;
    // Stage q - 1 is next; the slot of stage q is free for stage q - 1 - kAhead.
    --q;
    __syncwarp();
    issue_stage<kBanded, kShift, kVec>(ring, words_s, (q - kAhead) & (kStages - 1), q - kAhead,
                                       kStageRows * q + 31, fp, r, slope, next_off, ptr, nw, win,
                                       lane);
    if constexpr (kBanded) {
      next_row -= kStageRows;
      next_off = next_row >= 0 ? __ldg(offsets + next_row) : 0;
    }
  }
  // The rows below the walk are 0.
  for (int rr = lane; rr <= r; rr += 32) rec[rr] = 0;
  wait_stages<0>();
  if (stats != nullptr && lane == 0) {
    atomicAdd(stats, static_cast<unsigned long long>(reissues));
    atomicAdd(stats + 1, static_cast<unsigned long long>(deep));
    atomicAdd(stats + 2, static_cast<unsigned long long>(rounds));
  }
}

}  // namespace walk
