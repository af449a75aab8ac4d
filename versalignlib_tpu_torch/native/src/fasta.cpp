// Native FASTA ingestion: parse + encode + pad in one pass (the PyTorch
// port's copy of versalignlib_tpu/native/src/fasta.cpp).
//
// Record semantics follow the reference's FastaProvider
// (src/util/versalignUtil.h:47-99): records start at '>',
// sequence lines concatenate, a line containing ' ' discards the record, an
// empty line terminates the record. Output is the framework's padded code
// matrix (A=1,T=2,C=3,G=4,N=5, other/pad=0 — DefaultKernel.h:43-60), i.e.
// the fused equivalent of parse_fasta + pad_and_encode for bulk pipelines.
//
// Two-call protocol: val_fasta_scan() sizes the batch; val_fasta_read()
// fills a caller-allocated (n, max_len) uint8 buffer.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Table {
  uint8_t code[256];
  Table() {
    std::memset(code, 0, sizeof(code));
    code['A'] = code['a'] = 1;
    code['T'] = code['t'] = 2;
    code['C'] = code['c'] = 3;
    code['G'] = code['g'] = 4;
    code['N'] = code['n'] = 5;
  }
};
const Table kTable;

// Walk the file once, invoking cb(seq_start, seq_len) per record. The
// callback receives the concatenated sequence bytes (we build them in a
// scratch string to honor multi-line records).
template <typename F>
bool walk(const char *path, F &&cb) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string data;
  data.resize((size_t)size);
  if (size > 0 && std::fread(&data[0], 1, (size_t)size, f) != (size_t)size) {
    std::fclose(f);
    return false;
  }
  std::fclose(f);

  std::string content;
  bool in_record = false;
  size_t pos = 0;
  const size_t len = data.size();
  while (pos <= len) {
    size_t eol = data.find('\n', pos);
    if (eol == std::string::npos) eol = len;
    size_t line_len = eol - pos;
    // Trim a trailing '\r' (CRLF files).
    if (line_len > 0 && data[pos + line_len - 1] == '\r') --line_len;
    const char *line = data.data() + pos;
    if (line_len == 0 || line[0] == '>') {
      if (in_record) {
        cb(content);
        in_record = false;
      }
      if (line_len > 0) in_record = true;
      content.clear();
    } else if (in_record) {
      if (std::memchr(line, ' ', line_len) != nullptr) {
        // Reference behavior: a space invalidates the record.
        in_record = false;
        content.clear();
      } else {
        content.append(line, line_len);
      }
    }
    if (eol >= len) break;
    pos = eol + 1;
  }
  if (in_record) cb(content);
  return true;
}

}  // namespace

extern "C" int val_fasta_scan(const char *path, int64_t *n_seqs,
                              int64_t *max_len) {
  int64_t n = 0, mx = 0;
  bool ok = walk(path, [&](const std::string &seq) {
    ++n;
    if ((int64_t)seq.size() > mx) mx = (int64_t)seq.size();
  });
  if (!ok) return 1;
  *n_seqs = n;
  *max_len = mx;
  return 0;
}

extern "C" int val_fasta_read(const char *path, uint8_t *out, int64_t n_seqs,
                              int64_t max_len, int64_t *lengths) {
  int64_t i = 0;
  bool ok = walk(path, [&](const std::string &seq) {
    if (i >= n_seqs) return;
    uint8_t *row = out + i * max_len;
    size_t L = seq.size() > (size_t)max_len ? (size_t)max_len : seq.size();
    for (size_t j = 0; j < L; ++j)
      row[j] = kTable.code[(uint8_t)seq[j]];
    // rest of the row stays 0 (padding) — caller pre-zeroes.
    if (lengths) lengths[i] = (int64_t)L;
    ++i;
  });
  return ok && i == n_seqs ? 0 : 1;
}
