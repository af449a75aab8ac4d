// Native SAM record formatter: column-store alignments -> SAM text (the
// PyTorch port's copy of versalignlib_tpu/native/src/sam.cpp).
//
// Python's per-record formatting (io/sam.py sam_record) runs at ~18k
// records/s — 35x slower than the native traceback decode it consumes —
// so bulk SAM output formats here. Semantics are defined by io/sam.py
// (edge-op normalization, NM/MD over the trimmed window, AS/NM/MD tags);
// tests gate this formatter byte-for-byte against the Python writer.
//
// Single-end records only (flags/mate fields precomputed or defaulted by
// the caller); the paired writer stays in Python (cold path).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Cols {
  const uint8_t *read_g, *ref_g;  // (b, aln_cap) gapped strings
  int aln_cap;
  const uint8_t *cigar;           // (b, cigar_cap) text
  int cigar_cap;
  const int32_t *meta;            // (b, 8): score, rs, re, fs, fe, len,
                                  // buf_start, cigar_len
  const char *seqs; const int64_t *seq_off;
  const char *quals; const int64_t *qual_off;  // quals may be null
  const char *qnames; const int64_t *qname_off;
  const char *rnames; const int64_t *rname_off;
  const int32_t *flags_mapped;    // per-record FLAG when mapped (incl 0x10)
  const int32_t *flags_unmapped;  // per-record FLAG when unmapped
  const int32_t *mapqs;
};

struct Op { int64_t n; char op; };

// Format one record into buf; returns bytes written.
int64_t format_one(const Cols &C, int k, char *buf) {
  const int32_t *m = C.meta + 8 * k;
  const int32_t score = m[0], rs = m[1], re = m[2], fs = m[3];
  const int32_t aln_len = m[5], clen = m[7];
  const char *qname = C.qnames + C.qname_off[k];
  const int qname_len = int(C.qname_off[k + 1] - C.qname_off[k]);
  const char *rname = C.rnames + C.rname_off[k];
  const int rname_len = int(C.rname_off[k + 1] - C.rname_off[k]);
  const char *seq = C.seqs + C.seq_off[k];
  const int64_t seq_len = C.seq_off[k + 1] - C.seq_off[k];
  const char *qual = C.quals ? C.quals + C.qual_off[k] : nullptr;
  const int64_t qual_len = C.quals ? C.qual_off[k + 1] - C.qual_off[k] : 0;

  // Parse the CIGAR text into ops.
  std::vector<Op> ops;
  ops.reserve(16);
  const uint8_t *cg = C.cigar + int64_t(k) * C.cigar_cap;
  int64_t num = 0;
  for (int i = 0; i < clen; i++) {
    uint8_t ch = cg[i];
    if (ch >= '0' && ch <= '9') num = num * 10 + (ch - '0');
    else { ops.push_back({num, char(ch)}); num = 0; }
  }

  // Edge-op normalization (mirrors io/sam.py sam_record exactly).
  bool unmapped = (clen == 0) || (rs < 0) || (re <= rs);
  int64_t lead = rs, tail = seq_len - re, pos = fs;
  int64_t lead_cols = 0, tail_cols = 0;
  size_t first = 0, last = ops.size();
  if (!unmapped) {
    while (first < last && ops[first].op != 'M') {
      lead_cols += ops[first].n;
      if (ops[first].op == 'D') pos += ops[first].n;
      else lead += ops[first].n;
      first++;
    }
    while (last > first && ops[last - 1].op != 'M') {
      tail_cols += ops[last - 1].n;
      if (ops[last - 1].op == 'I') tail += ops[last - 1].n;
      last--;
    }
    unmapped = (first == last);
  }

  char *p = buf;
  auto put = [&](const char *s, int64_t n) { memcpy(p, s, n); p += n; };
  auto put_s = [&](const char *s) { size_t n = strlen(s); memcpy(p, s, n); p += n; };
  auto put_c = [&](char c) { *p++ = c; };
  auto put_i = [&](int64_t v) { p += sprintf(p, "%lld", (long long)v); };

  put(qname, qname_len); put_c('\t');
  if (unmapped) {
    put_i(C.flags_unmapped[k]);
    put_s("\t*\t0\t0\t*\t*\t0\t0\t");
    if (seq_len) put(seq, seq_len); else put_c('*');
    put_c('\t');
    if (qual && qual_len) put(qual, qual_len); else put_c('*');
    p += sprintf(p, "\tAS:i:%d\n", score);
    return p - buf;
  }
  put_i(C.flags_mapped[k]); put_c('\t');
  put(rname, rname_len); put_c('\t');
  put_i(pos + 1); put_c('\t');
  put_i(C.mapqs[k]); put_c('\t');
  if (lead) { put_i(lead); put_c('S'); }
  for (size_t i = first; i < last; i++) { put_i(ops[i].n); put_c(ops[i].op); }
  if (tail) { put_i(tail); put_c('S'); }
  put_s("\t*\t0\t0\t");
  put(seq, seq_len); put_c('\t');
  if (qual && qual_len) put(qual, qual_len); else put_c('*');

  // NM/MD over the trimmed gapped window (mirrors io/sam.py _nm_md).
  const uint8_t *rg = C.read_g + int64_t(k) * C.aln_cap;
  const uint8_t *fg = C.ref_g + int64_t(k) * C.aln_cap;
  int64_t i = lead_cols, end = aln_len - tail_cols;
  int64_t nm = 0, run = 0;
  // MD worst case: one digit-run + char per column (long banded windows
  // reach 100kbp+ — heap, not stack).
  std::vector<char> mdbuf(2 * (end - lead_cols) + 32);
  char *md = mdbuf.data();
  char *q = md;
  auto md_i = [&](int64_t v) { q += sprintf(q, "%lld", (long long)v); };
  auto up = [](uint8_t c) -> uint8_t {
    return (c >= 'a' && c <= 'z') ? c - 32 : c;  // match Python's .upper()
  };
  while (i < end) {
    uint8_t r = rg[i], f = fg[i];
    if (r != '-' && f != '-') {
      if (up(r) == up(f)) run++;
      else { md_i(run); *q++ = char(up(f)); run = 0; nm++; }
      i++;
    } else if (f == '-') { nm++; i++; }
    else {
      md_i(run); run = 0; *q++ = '^';
      while (i < end && rg[i] == '-') { *q++ = char(up(fg[i])); nm++; i++; }
    }
  }
  md_i(run);
  p += sprintf(p, "\tAS:i:%d\tNM:i:%lld\tMD:Z:", score, (long long)nm);
  put(md, q - md);
  put_c('\n');
  return p - buf;
}

}  // namespace

extern "C" int64_t val_format_sam(
    const uint8_t *read_g, const uint8_t *ref_g, int aln_cap,
    const uint8_t *cigar, int cigar_cap, const int32_t *meta,
    const char *seqs, const int64_t *seq_off,
    const char *quals, const int64_t *qual_off,
    const char *qnames, const int64_t *qname_off,
    const char *rnames, const int64_t *rname_off,
    const int32_t *flags_mapped, const int32_t *flags_unmapped,
    const int32_t *mapqs, int b,
    char *out, const int64_t *rec_cap,  // per-record output bounds (b+1
                                        // prefix offsets into `out`)
    int64_t *rec_len,                   // out: bytes written per record
    int threads) {
  Cols C{read_g, ref_g, aln_cap, cigar, cigar_cap, meta,
         seqs, seq_off, quals, qual_off, qnames, qname_off,
         rnames, rname_off, flags_mapped, flags_unmapped, mapqs};
  if (threads < 1) threads = 1;
  std::vector<std::thread> pool;
  std::vector<int64_t> status(threads, 0);
  auto work = [&](int t) {
    for (int k = t; k < b; k += threads) {
      int64_t n = format_one(C, k, out + rec_cap[k]);
      if (n > rec_cap[k + 1] - rec_cap[k]) { status[t] = -1; return; }
      rec_len[k] = n;
    }
  };
  for (int t = 1; t < threads; t++) pool.emplace_back(work, t);
  work(0);
  for (auto &th : pool) th.join();
  for (int t = 0; t < threads; t++)
    if (status[t] < 0) return -1;
  // Compact the per-record regions into one contiguous stream in place
  // (regions are ordered and non-overlapping; memmove is safe).
  int64_t total = 0;
  for (int k = 0; k < b; k++) {
    if (total != rec_cap[k])
      memmove(out + total, out + rec_cap[k], rec_len[k]);
    total += rec_len[k];
  }
  return total;
}
