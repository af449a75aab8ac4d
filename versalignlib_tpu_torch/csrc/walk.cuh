// Pieces shared by the traceback walks, walk.cu (dense, B7 and B8) and
// banded_walk.cu (banded, B9 and B10): the move codes, the reads of one
// pointer row that a walk needs, and the scan that ends a row's LEFT run.
//
// A walk follows one pair from its start cell up the read rows. On a row
// the path is k LEFT moves and one exit move (UP, DIAG or START), so the
// walk writes one record, k*4 | exit, per row (0 outside the walk), and the
// host replays the records without the pointer words
// (versalignlib_tpu/ops/walk.py). Each row costs one read of the cursor's
// word, and more words only while the LEFT run (or the Gotoh E chain)
// continues below it: a run ends at the highest stop flag at or below the
// cursor, 31 - __clz of the flag bits, with __clz(0) = 32 kept out by a
// test for no flag. The flag arithmetic runs in uint32_t, where the JAX
// walks' int32 shifts would overflow or shift a negative value.
//
// The scans are templates on where a row's words come from: `word_at(row,
// w)` for a `const int32_t *` row reads device memory through the
// read-only cache (the dense walks); banded_walk.cu gives its own row type,
// whose words sit in shared memory around the cursor.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace walk {

constexpr int kStart = 0, kUp = 1, kLeft = 2, kDiag = 3;  // types.Trace
// Threads (pairs) a block of the dense walk: one warp, so that a launch of
// a few thousand pairs spreads over the SMs.
constexpr int kThreads = 32;

__device__ __forceinline__ uint32_t word_at(const int32_t *row, int w) {
  return static_cast<uint32_t>(__ldg(row + w));
}

// The 4-bit Gotoh code (hptr | e_ext<<2 | f_ext<<3) of field j; 8 a word.
template <class Row>
__device__ __forceinline__ int code4(const Row &row, int j) {
  return static_cast<int>((word_at(row, j >> 3) >> (4 * (j & 7))) & 15u);
}

// The 2-bit move code of field j, kPack fields a word.
template <int kPack, class Row>
__device__ __forceinline__ int code2(const Row &row, int j) {
  return static_cast<int>((word_at(row, j / kPack) >> (2 * (j % kPack))) & 3u);
}

// The highest field at or below `pos` (>= 0) whose 2-bit code is not LEFT,
// -1 if none: kPack codes a word (16 dense; 8 banded, in the low 16 bits).
// `word` is the word that holds `pos`, read by the caller; words below it
// are read only while the run continues. `code` gets the stop's code, taken
// from the word where the run stopped: its flag bit is the code's low bit.
template <int kPack, class Row>
__device__ __forceinline__ int linear_stop_from(const Row &row, int pos, uint32_t word,
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

template <int kPack, class Row>
__device__ __forceinline__ int linear_stop(const Row &row, int pos) {
  int code;
  return linear_stop_from<kPack>(row, pos, word_at(row, static_cast<unsigned>(pos) / kPack),
                                 code);
}

// The end of a Gotoh E chain: the highest field j in [0, p] (p >= 0) where
// cont(j) = e_ext(j+1) | hptr(j) == LEFT is clear, -1 if none. `word` holds
// field p; `above` is the next word (its field 0 is field j+1 of p's word's
// last field), read only when p is a word's last field, else any value.
// `code` gets the 4-bit code of the field where the chain stopped.
template <class Row>
__device__ __forceinline__ int chain_stop_from(const Row &row, int p, uint32_t word,
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

// chain_stop_from for p >= -1 on a row of `words` words, reading its own
// words (-1 if p < 0).
template <class Row>
__device__ __forceinline__ int chain_stop(const Row &row, int p, int words) {
  if (p < 0) return -1;
  const int w = p >> 3;
  const uint32_t above = ((p & 7) == 7 && w + 1 < words) ? word_at(row, w + 1) : 0u;
  int code;
  return chain_stop_from(row, p, word_at(row, w), above, code);
}

// One row of a Gotoh walk entered in state H at field k (>= 0): the E chain
// enters if hptr(k) is LEFT and runs down to chain_stop. Sets `jb`, the
// field after the run (-1 when it leaves the row's fields), and returns
// the code at max(jb, 0).
template <class Row>
__device__ __forceinline__ int affine_run(const Row &row, int k, int words, int &jb) {
  jb = (code4(row, k) & 3) == kLeft ? chain_stop(row, k - 1, words) : k;
  return code4(row, jb > 0 ? jb : 0);
}

}  // namespace walk
