// Native batch traceback decoder (the PyTorch port's copy of
// versalignlib_tpu/native/src/traceback.cpp; the walks are unchanged).
//
// The DP fill runs on the GPU (csrc/align.cu emits 2-bit-packed pointer
// words); the backtrack walk is inherently sequential and data-dependent, so
// it runs on host — the analogue of the reference's scalar per-lane
// backtracks (SSEKernel.cpp:785-860) and its OpenMP-parallel result
// collection (OpenCLKernel.cpp:613-645). Threaded over pairs with
// std::thread.
//
// Pointer codes match versalignlib_tpu_torch.types.Trace: 0 START, 1 UP,
// 2 LEFT, 3 DIAG. Boundary semantics (implied row/col 0): row 0 = START; col 0 =
// START for SW, UP for NW (DefaultKernel.cpp:304,395). Scores, when not
// supplied, are reconstructed by path telescoping plus the NW column-0
// boundary value (see ops/traceback.py).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int START = 0, UP = 1, LEFT = 2, DIAG = 3;

struct Args {
  const void *ptr_data;
  int ptr_kind;  // 0 = dense uint8 (b, m, n); 1 = packed int32 (b, m, nc);
                 // 2 = device-walk row records (b, m) int32 (ops/walk.py:
                 //     left_count*4 | exit_code per row)
  int pack;
  const uint8_t *reads;  // (b, m) codes
  const uint8_t *refs;   // (b, n) codes
  const char *read_texts;  // optional (b, m) original chars
  const char *ref_texts;   // optional (b, n)
  const int32_t *start_r;
  const int32_t *start_f;
  const int32_t *scores_in;  // optional
  int b, m, n;
  int match, mismatch, gap_read, gap_ref;
  int is_nw;
  int is_affine;  // 4-bit codes: hptr(2b) | e_ext<<2 | f_ext<<3
  char *read_gapped;  // (b, m+n); nullptr = CIGAR-only mode (skip gapped)
  char *ref_gapped;   // (b, m+n)
  char *cigar_out;    // (b, cigar_cap)
  int cigar_cap;
  int32_t *meta;  // (b, 8): score, read_start, read_end, ref_start, ref_end,
                  //          aln_len, buffer_start, cigar_len
};

const char kCodeChar[6] = {'\0', 'A', 'T', 'C', 'G', 'N'};

inline int sub_score(uint8_t a, uint8_t b, int match, int mismatch) {
  bool valid = (a >= 1 && a <= 4) && (b >= 1 && b <= 4);
  if (!valid) return 0;
  return a == b ? match : mismatch;
}

inline int load_ptr(const Args &A, int pair, int i, int j) {
  const int bits = A.is_affine ? 4 : 2;
  const int mask = A.is_affine ? 15 : 3;
  if (A.ptr_kind == 0) {
    const uint8_t *p = static_cast<const uint8_t *>(A.ptr_data);
    return p[(size_t)pair * A.m * A.n + (size_t)i * A.n + j];
  }
  int nc = (A.n + A.pack - 1) / A.pack;
  const int32_t *p = static_cast<const int32_t *>(A.ptr_data);
  int32_t word = p[(size_t)pair * A.m * nc + (size_t)i * nc + j / A.pack];
  return (word >> (bits * (j % A.pack))) & mask;
}

// CIGAR run scratch: walks emit (len << 2 | op) tokens in reverse order;
// per-thread to avoid per-pair allocation.
thread_local std::vector<uint32_t> tl_runs;

const char kOpChar[3] = {'M', 'I', 'D'};

// Format run tokens (reverse walk order) to "12M3I..." text. Returns length.
inline int format_cigar(const uint32_t *runs, int runs_n, char *cg, int cap) {
  int clen = 0;
  char tmp[12];
  for (int t = runs_n - 1; t >= 0; --t) {
    uint32_t len = runs[t] >> 2;
    int d = 0;
    do {
      tmp[d++] = '0' + (len % 10);
      len /= 10;
    } while (len);
    if (clen + d + 1 >= cap) break;
    while (d) cg[clen++] = tmp[--d];
    cg[clen++] = kOpChar[runs[t] & 3];
  }
  return clen;
}

// The linear walk, templated on pointer layout and gapped-string emission so
// the per-step loop carries no dead branches. kPtr: 0 dense codes, 1 packed
// 2-bit codes in int32 words (the Pallas kernels' native stream; pack is
// always a power of two, so word index / field shift are shifts and masks —
// the div/mod pair of the previous revision cost ~40 cycles per step),
// 2 device-walk row records (ops/walk.py): per row, ``left_count*4 | code``
// — the move at (rp, fp) is LEFT while fp is above the row's stop column
// (fp_at_row_entry - left_count), then the recorded exit code; no 2D
// pointer fetches at all. CIGAR runs are accumulated during the walk
// instead of re-scanning the gapped strings afterwards.
template <int kPtr, bool kGapped>
void decode_pair_impl(const Args &A, int k, int nc, int pshift) {
  const int m = A.m, n = A.n;
  const int aln_cap = m + n;
  char *rg = kGapped ? A.read_gapped + (size_t)k * aln_cap : nullptr;
  char *fg = kGapped ? A.ref_gapped + (size_t)k * aln_cap : nullptr;
  const uint8_t *read = A.reads + (size_t)k * m;
  const uint8_t *ref = A.refs + (size_t)k * n;
  const char *rt = A.read_texts ? A.read_texts + (size_t)k * m : nullptr;
  const char *ft = A.ref_texts ? A.ref_texts + (size_t)k * n : nullptr;
  const int32_t *pw =
      kPtr == 1 ? static_cast<const int32_t *>(A.ptr_data) + (size_t)k * m * nc
                : nullptr;
  const uint8_t *pd =
      kPtr == 0 ? static_cast<const uint8_t *>(A.ptr_data) + (size_t)k * m * n
                : nullptr;
  const int32_t *recs =
      kPtr == 2 ? static_cast<const int32_t *>(A.ptr_data) + (size_t)k * m
                : nullptr;
  const int jmask = A.pack - 1;
  const bool want_cost = A.scores_in == nullptr;

  int rp = A.start_r[k];
  int fp = A.start_f[k];
  const int start_rp = rp, start_fp = fp;
  int rec_row = -2, rec_stop = 0, rec_code = START;

  if ((size_t)tl_runs.size() < (size_t)aln_cap + 1) tl_runs.resize(aln_cap + 1);
  uint32_t *runs = tl_runs.data();
  int runs_n = 0;
  int cur_op = -1, cur_len = 0;

  // Emit backwards into the buffer tail, reference-style
  // (DefaultKernel.cpp:413-439), then shift to the front.
  int pos = aln_cap;  // one past last written
  int path_cost = 0;
  int steps = 0;
  while (steps <= aln_cap) {
    int bt;
    if (rp < 0) {
      bt = START;  // boundary row 0
    } else if (kPtr == 2) {
      // Records fully encode boundary behavior (dense NW col -1 UP chains
      // are recorded as UP rows; banded band-edge stops as START) — never
      // apply the 2D boundary shortcuts below to a record stream.
      if (rp != rec_row) {
        rec_row = rp;
        int32_t rec = recs[rp];
        rec_stop = fp - (rec >> 2);
        rec_code = rec & 3;
      }
      bt = fp > rec_stop ? LEFT : rec_code;
    } else if (fp < 0) {
      bt = A.is_nw ? UP : START;  // boundary col 0
    } else if (kPtr == 1) {
      bt = (pw[(size_t)rp * nc + (fp >> pshift)] >> (2 * (fp & jmask))) & 3;
    } else {
      bt = pd[(size_t)rp * n + fp];
    }
    if (bt == START) break;
    int op;
    if (bt == UP) {
      if (kGapped) {
        --pos;
        rg[pos] = rt ? rt[rp] : kCodeChar[read[rp] <= 5 ? read[rp] : 0];
        fg[pos] = '-';
      }
      if (want_cost) path_cost += A.gap_ref;
      --rp;
      op = 1;
    } else if (bt == LEFT) {
      if (kGapped) {
        --pos;
        rg[pos] = '-';
        fg[pos] = ft ? ft[fp] : kCodeChar[ref[fp] <= 5 ? ref[fp] : 0];
      }
      if (want_cost) path_cost += A.gap_read;
      --fp;
      op = 2;
    } else {  // DIAG
      if (kGapped) {
        --pos;
        rg[pos] = rt ? rt[rp] : kCodeChar[read[rp] <= 5 ? read[rp] : 0];
        fg[pos] = ft ? ft[fp] : kCodeChar[ref[fp] <= 5 ? ref[fp] : 0];
      }
      if (want_cost)
        path_cost += sub_score(read[rp], ref[fp], A.match, A.mismatch);
      --rp;
      --fp;
      op = 0;
    }
    if (op == cur_op) {
      ++cur_len;
    } else {
      if (cur_op >= 0) runs[runs_n++] = (uint32_t)(cur_len << 2) | cur_op;
      cur_op = op;
      cur_len = 1;
    }
    ++steps;
  }
  if (cur_op >= 0) runs[runs_n++] = (uint32_t)(cur_len << 2) | cur_op;

  const int aln_len = steps;
  if (kGapped) {
    // Shift to the front of the per-pair buffer.
    std::memmove(rg, rg + pos, aln_len);
    std::memmove(fg, fg + pos, aln_len);
  }

  int32_t score;
  if (A.scores_in) {
    score = A.scores_in[k];
  } else {
    int boundary = 0;
    if (A.is_nw && fp < 0 && rp >= 0) boundary = (rp + 1) * A.gap_ref;
    score = boundary + path_cost;
  }

  char *cg = A.cigar_out + (size_t)k * A.cigar_cap;
  int clen = format_cigar(runs, runs_n, cg, A.cigar_cap);

  int32_t *mt = A.meta + (size_t)k * 8;
  mt[0] = score;
  mt[1] = rp + 1;            // read_start
  mt[2] = start_rp + 1;      // read_end
  mt[3] = fp + 1;            // ref_start
  mt[4] = start_fp + 1;      // ref_end
  mt[5] = aln_len;
  mt[6] = aln_cap - 1 - steps;  // reference buffer_start (aln_pos + 1)
  mt[7] = clen;
}

void decode_pair(const Args &A, int k) {
  const int nc = (A.n + A.pack - 1) / A.pack;
  const int pshift = __builtin_ctz(A.pack);
  if (A.ptr_kind == 2) {
    if (A.read_gapped)
      decode_pair_impl<2, true>(A, k, nc, pshift);
    else
      decode_pair_impl<2, false>(A, k, nc, pshift);
  } else if (A.ptr_kind == 1) {
    if (A.read_gapped)
      decode_pair_impl<1, true>(A, k, nc, pshift);
    else
      decode_pair_impl<1, false>(A, k, nc, pshift);
  } else {
    if (A.read_gapped)
      decode_pair_impl<0, true>(A, k, nc, pshift);
    else
      decode_pair_impl<0, false>(A, k, nc, pshift);
  }
}

// Affine three-state (H/E/F) walk mirroring gotoh._affine_traceback: state H
// follows hptr; E/F emit LEFT/UP steps and return to H when the extend bit
// is clear. Scores must be supplied by the caller (the device kernels emit
// exact end-cell scores). 4-bit codes, pack a power of two (8 per word).
template <bool kPacked, bool kGapped>
void decode_pair_affine_impl(const Args &A, int k, int nc, int pshift) {
  const int m = A.m, n = A.n;
  const int aln_cap = m + n;
  char *rg = kGapped ? A.read_gapped + (size_t)k * aln_cap : nullptr;
  char *fg = kGapped ? A.ref_gapped + (size_t)k * aln_cap : nullptr;
  const uint8_t *read = A.reads + (size_t)k * m;
  const uint8_t *ref = A.refs + (size_t)k * n;
  const char *rt = A.read_texts ? A.read_texts + (size_t)k * m : nullptr;
  const char *ft = A.ref_texts ? A.ref_texts + (size_t)k * n : nullptr;
  const int32_t *pw =
      kPacked ? static_cast<const int32_t *>(A.ptr_data) + (size_t)k * m * nc
              : nullptr;
  const uint8_t *pd =
      kPacked ? nullptr
              : static_cast<const uint8_t *>(A.ptr_data) + (size_t)k * m * n;
  const int jmask = A.pack - 1;

  int rp = A.start_r[k];
  int fp = A.start_f[k];
  const int start_rp = rp, start_fp = fp;

  if ((size_t)tl_runs.size() < (size_t)aln_cap + 1) tl_runs.resize(aln_cap + 1);
  uint32_t *runs = tl_runs.data();
  int runs_n = 0;
  int cur_op = -1, cur_len = 0;
  auto push_op = [&](int op) {
    if (op == cur_op) {
      ++cur_len;
    } else {
      if (cur_op >= 0) runs[runs_n++] = (uint32_t)(cur_len << 2) | cur_op;
      cur_op = op;
      cur_len = 1;
    }
  };

  int pos = aln_cap;
  int steps = 0;
  int state = 0;  // 0=H, 1=F(up), 2=E(left)
  while (steps <= aln_cap) {
    if (rp < 0) break;  // boundary row 0
    if (fp < 0) {
      if (!A.is_nw) break;
      if (kGapped) {
        --pos;
        rg[pos] = rt ? rt[rp] : kCodeChar[read[rp] <= 5 ? read[rp] : 0];
        fg[pos] = '-';
      }
      push_op(1);
      --rp;
      ++steps;
      continue;
    }
    int code;
    if (kPacked) {
      code = (pw[(size_t)rp * nc + (fp >> pshift)] >> (4 * (fp & jmask))) & 15;
    } else {
      code = pd[(size_t)rp * n + fp];
    }
    int hptr = code & 3;
    if (state == 0) {
      if (hptr == START) break;
      if (hptr == DIAG) {
        if (kGapped) {
          --pos;
          rg[pos] = rt ? rt[rp] : kCodeChar[read[rp] <= 5 ? read[rp] : 0];
          fg[pos] = ft ? ft[fp] : kCodeChar[ref[fp] <= 5 ? ref[fp] : 0];
        }
        push_op(0);
        --rp;
        --fp;
        ++steps;
      } else if (hptr == UP) {
        state = 1;
      } else {
        state = 2;
      }
    } else if (state == 1) {
      if (kGapped) {
        --pos;
        rg[pos] = rt ? rt[rp] : kCodeChar[read[rp] <= 5 ? read[rp] : 0];
        fg[pos] = '-';
      }
      push_op(1);
      --rp;
      if (!((code >> 3) & 1)) state = 0;
      ++steps;
    } else {
      if (kGapped) {
        --pos;
        rg[pos] = '-';
        fg[pos] = ft ? ft[fp] : kCodeChar[ref[fp] <= 5 ? ref[fp] : 0];
      }
      push_op(2);
      --fp;
      if (!((code >> 2) & 1)) state = 0;
      ++steps;
    }
  }
  if (cur_op >= 0) runs[runs_n++] = (uint32_t)(cur_len << 2) | cur_op;

  const int aln_len = steps;
  if (kGapped) {
    std::memmove(rg, rg + pos, aln_len);
    std::memmove(fg, fg + pos, aln_len);
  }

  int32_t score = A.scores_in ? A.scores_in[k] : 0;

  char *cg = A.cigar_out + (size_t)k * A.cigar_cap;
  int clen = format_cigar(runs, runs_n, cg, A.cigar_cap);

  int32_t *mt = A.meta + (size_t)k * 8;
  mt[0] = score;
  mt[1] = rp + 1;
  mt[2] = start_rp + 1;
  mt[3] = fp + 1;
  mt[4] = start_fp + 1;
  mt[5] = aln_len;
  mt[6] = aln_cap - 1 - steps;
  mt[7] = clen;
}

void decode_pair_affine(const Args &A, int k) {
  const int nc = (A.n + A.pack - 1) / A.pack;
  const int pshift = __builtin_ctz(A.pack);
  if (A.ptr_kind == 1) {
    if (A.read_gapped)
      decode_pair_affine_impl<true, true>(A, k, nc, pshift);
    else
      decode_pair_affine_impl<true, false>(A, k, nc, pshift);
  } else {
    if (A.read_gapped)
      decode_pair_affine_impl<false, true>(A, k, nc, pshift);
    else
      decode_pair_affine_impl<false, false>(A, k, nc, pshift);
  }
}

void decode_pair_banded(const Args &A, const int32_t *offsets,
                        const int32_t *wbase, int band, int win, int m_rows,
                        int k) {
  // Window-relative pointer walk (canonical flavor, linear or affine):
  // pointer of cell (i, j) lives at window index j - wbase[i] (8 codes per
  // int32 word; 2-bit linear, 4-bit affine hptr|e_ext<<2|f_ext<<3); the
  // in-band check uses the per-row offsets. Leaving the band or reaching
  // the free row-0/col-0 boundary ends the walk. Traceback starts are
  // clamped to valid read rows by the caller (NW last-valid-row rule), so
  // padding rows are never visited and no NUL characters are emitted.
  const int m = A.m, n = A.n;
  const int aln_cap = m + n;
  char *rg = A.read_gapped + (size_t)k * aln_cap;
  char *fg = A.ref_gapped + (size_t)k * aln_cap;
  const uint8_t *read = A.reads + (size_t)k * m;
  const uint8_t *ref = A.refs + (size_t)k * n;
  const int bits = A.is_affine ? 4 : 2;
  const int mask = A.is_affine ? 15 : 3;
  const int wc = win / 8;
  const int32_t *words = static_cast<const int32_t *>(A.ptr_data) +
                         (size_t)k * m_rows * wc;

  int rp = A.start_r[k];
  int fp = A.start_f[k];
  const int start_rp = rp, start_fp = fp;
  int pos = aln_cap;
  int steps = 0;
  int state = 0;  // 0=H, 1=F(up), 2=E(left) — affine only
  while (steps <= aln_cap && rp >= 0 && fp >= 0 && rp < m) {
    int kb = fp - offsets[rp];
    if (kb < 0 || kb >= band) break;
    int kw = fp - wbase[rp];
    int32_t word = words[(size_t)rp * wc + kw / 8];
    int code = (word >> (bits * (kw % 8))) & mask;
    int hp = code & 3;
    char rc = kCodeChar[read[rp] <= 5 ? read[rp] : 0];
    char fc = kCodeChar[ref[fp] <= 5 ? ref[fp] : 0];
    if (!A.is_affine) {
      if (hp == START) break;
      --pos;
      if (hp == UP) {
        rg[pos] = rc;
        fg[pos] = '-';
        --rp;
      } else if (hp == LEFT) {
        rg[pos] = '-';
        fg[pos] = fc;
        --fp;
      } else {
        rg[pos] = rc;
        fg[pos] = fc;
        --rp;
        --fp;
      }
      ++steps;
      continue;
    }
    if (state == 0) {
      if (hp == START) break;
      if (hp == DIAG) {
        --pos;
        rg[pos] = rc;
        fg[pos] = fc;
        --rp;
        --fp;
        ++steps;
      } else if (hp == UP) {
        state = 1;
      } else {
        state = 2;
      }
    } else if (state == 1) {
      --pos;
      rg[pos] = rc;
      fg[pos] = '-';
      --rp;
      if (!((code >> 3) & 1)) state = 0;
      ++steps;
    } else {
      --pos;
      rg[pos] = '-';
      fg[pos] = fc;
      --fp;
      if (!((code >> 2) & 1)) state = 0;
      ++steps;
    }
  }

  const int aln_len = aln_cap - pos;
  std::memmove(rg, rg + pos, aln_len);
  std::memmove(fg, fg + pos, aln_len);

  char *cg = A.cigar_out + (size_t)k * A.cigar_cap;
  int clen = 0, run = 0;
  char op = 0;
  for (int t = 0; t < aln_len; ++t) {
    char cur_op = rg[t] == '-' ? 'D' : (fg[t] == '-' ? 'I' : 'M');
    if (cur_op == op) {
      ++run;
    } else {
      if (run > 0 && clen + 12 < A.cigar_cap)
        clen += std::snprintf(cg + clen, A.cigar_cap - clen, "%d%c", run, op);
      op = cur_op;
      run = 1;
    }
  }
  if (run > 0 && clen + 12 < A.cigar_cap)
    clen += std::snprintf(cg + clen, A.cigar_cap - clen, "%d%c", run, op);

  int32_t *mt = A.meta + (size_t)k * 8;
  mt[0] = A.scores_in ? A.scores_in[k] : 0;
  mt[1] = rp + 1;
  mt[2] = start_rp + 1;
  mt[3] = fp + 1;
  mt[4] = start_fp + 1;
  mt[5] = aln_len;
  mt[6] = aln_cap - 1 - steps;
  mt[7] = clen;
}

}  // namespace

extern "C" int val_decode_banded(
    const void *ptr_data, int band, int win, const int32_t *offsets,
    const int32_t *wbase, const uint8_t *reads, const uint8_t *refs,
    const int32_t *start_r, const int32_t *start_f, const int32_t *scores_in,
    int b, int m_rows, int m, int n, int is_affine, char *read_gapped,
    char *ref_gapped, char *cigar_out, int cigar_cap, int32_t *meta,
    int n_threads) {
  Args A{ptr_data, 1, 8, reads, refs, nullptr, nullptr, start_r, start_f,
         scores_in, b, m, n, 0, 0, 0, 0, 0, is_affine, read_gapped,
         ref_gapped, cigar_out, cigar_cap, meta};
  if (n_threads <= 1 || b < 64) {
    for (int kk = 0; kk < b; ++kk)
      decode_pair_banded(A, offsets, wbase, band, win, m_rows, kk);
    return 0;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        int kk = next.fetch_add(16);
        if (kk >= A.b) return;
        int end = kk + 16 < A.b ? kk + 16 : A.b;
        for (; kk < end; ++kk)
          decode_pair_banded(A, offsets, wbase, band, win, m_rows, kk);
      }
    });
  }
  for (auto &th : pool) th.join();
  return 0;
}

extern "C" int val_decode_batch(
    const void *ptr_data, int ptr_kind, int pack, const uint8_t *reads,
    const uint8_t *refs, const char *read_texts, const char *ref_texts,
    const int32_t *start_r, const int32_t *start_f, const int32_t *scores_in,
    int b, int m, int n, int match, int mismatch, int gap_read, int gap_ref,
    int is_nw, int is_affine, char *read_gapped, char *ref_gapped,
    char *cigar_out, int cigar_cap, int32_t *meta, int n_threads) {
  if (pack <= 0 || (pack & (pack - 1)) != 0) return -2;  // power of two only
  Args A{ptr_data, ptr_kind, pack, reads, refs, read_texts, ref_texts,
         start_r, start_f, scores_in, b, m, n, match, mismatch, gap_read,
         gap_ref, is_nw, is_affine, read_gapped, ref_gapped, cigar_out,
         cigar_cap, meta};
  auto decode = A.is_affine ? decode_pair_affine : decode_pair;
  if (n_threads <= 1 || b < 64) {
    for (int k = 0; k < b; ++k) decode(A, k);
    return 0;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([&A, &next, decode]() {
      for (;;) {
        int k = next.fetch_add(16);
        if (k >= A.b) return;
        int end = k + 16 < A.b ? k + 16 : A.b;
        for (; k < end; ++k) decode(A, k);
      }
    });
  }
  for (auto &th : pool) th.join();
  return 0;
}
