// Native FASTQ/FASTA reader: parse + quality-segment + 2-bit encode.
//
// The TPU compute path consumes fixed-shape uint8 code batches; this module
// is the host-side feeder, replacing the Python parser at the stage-1 input
// boundary (the reference's io/FastqReader + filtered readers,
// FastqReader.java:66-171, with the Phred33/[ACGTU] segmenting of
// SeqUtils.java:1432-1438).  gzFile handles both plain and gzipped input.
//
// C ABI (ctypes):
//   void* fx_open(const char* path)
//   void  fx_close(void* handle)
//   long  fx_next_batch(void* h, int max_segments, int max_len, int min_qual,
//                       int min_len, unsigned char* out_codes,
//                       int* out_lens, long* out_reads_parsed)
//     -> number of segments written (row-major [max_segments, max_len],
//        padded with 4), or -1 on error.  0 => EOF.
//   Long segments are split into max_len chunks overlapping by (min_len-1).

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int BUF_SIZE = 1 << 20;

struct Reader {
  gzFile f = nullptr;
  std::string pending;   // pushed-back line (format sniffing)
  bool is_fastq = false;
  bool inited = false;
  char* buf = nullptr;
  // carry-over: chunks of the current read not yet emitted
  std::vector<std::vector<uint8_t>> carry;
  size_t carry_idx = 0;
  long reads_parsed = 0;
  // multi-process input partitioning (parallel/multihost.py):
  // byte-range limit for plain seekable files (records starting at or
  // past `limit` belong to the next partition; -1 = no limit), and
  // record-modulo stride (process stride_p keeps records p, p+n, ...)
  long limit = -1;
  int stride_n = 1;
  int stride_p = 0;
  long rec_index = 0;
  long line_start = 0;   // stream offset of the last line read
  long pending_pos = 0;  // stream offset of the pushed-back line
};

// Byte offset where the NEXT unconsumed line starts.
long next_line_pos(Reader* r) {
  return r->pending.empty() ? gztell(r->f) : r->pending_pos;
}

// True when the record about to be parsed is past this reader's byte range.
bool range_exhausted(Reader* r) {
  return r->limit >= 0 && next_line_pos(r) >= r->limit;
}

// Record-modulo stride: call exactly once per parsed record.
bool record_is_mine(Reader* r) {
  long idx = r->rec_index++;
  return r->stride_n <= 1 || (idx % r->stride_n) == r->stride_p;
}

// ASCII -> 2-bit code (A=0 C=1 G=2 T/U=3, else 4)
uint8_t kCode[256];
struct CodeInit {
  CodeInit() {
    memset(kCode, 4, sizeof(kCode));
    kCode['A'] = kCode['a'] = 0;
    kCode['C'] = kCode['c'] = 1;
    kCode['G'] = kCode['g'] = 2;
    kCode['T'] = kCode['t'] = 3;
    kCode['U'] = kCode['u'] = 3;
  }
} code_init;

bool read_line(Reader* r, std::string* out) {
  if (!r->pending.empty()) {
    *out = std::move(r->pending);
    r->pending.clear();
    r->line_start = r->pending_pos;
    return true;
  }
  out->clear();
  r->line_start = gztell(r->f);
  while (true) {
    if (gzgets(r->f, r->buf, BUF_SIZE) == nullptr) {
      return !out->empty();
    }
    size_t n = strlen(r->buf);
    bool eol = n > 0 && r->buf[n - 1] == '\n';
    if (eol) {
      r->buf[--n] = '\0';
      if (n > 0 && r->buf[n - 1] == '\r') r->buf[--n] = '\0';
    }
    out->append(r->buf, n);
    if (eol) return true;
  }
}

// Split one read into kept segments (quality >= min_qual, unambiguous base),
// chunking each into <= max_len windows overlapping by (min_len - 1).
void segment_read(const std::string& seq, const std::string& qual, int min_qual,
                  int min_len, int max_len,
                  std::vector<std::vector<uint8_t>>* out) {
  const char qmin = static_cast<char>(33 + min_qual);
  const size_t n = seq.size();
  const bool has_qual = !qual.empty() && qual.size() == n;
  size_t start = 0;
  bool in_run = false;
  auto flush = [&](size_t s, size_t e) {
    if (e - s < static_cast<size_t>(min_len)) return;
    const size_t overlap = static_cast<size_t>(min_len - 1);
    const size_t step = static_cast<size_t>(max_len) - overlap;
    for (size_t cs = s; cs < e; ) {
      size_t ce = cs + static_cast<size_t>(max_len);
      if (ce > e) ce = e;
      if (ce - cs >= static_cast<size_t>(min_len)) {
        std::vector<uint8_t> seg(ce - cs);
        for (size_t i = cs; i < ce; ++i) seg[i - cs] = kCode[(uint8_t)seq[i]];
        out->push_back(std::move(seg));
      }
      if (ce == e) break;
      cs += step;
    }
  };
  for (size_t i = 0; i < n; ++i) {
    bool ok = kCode[(uint8_t)seq[i]] < 4 && (!has_qual || qual[i] >= qmin);
    if (ok && !in_run) {
      start = i;
      in_run = true;
    } else if (!ok && in_run) {
      flush(start, i);
      in_run = false;
    }
  }
  if (in_run) flush(start, n);
}

}  // namespace

extern "C" {

void* fx_open(const char* path) {
  gzFile f = gzopen(path, "rb");
  if (!f) return nullptr;
  gzbuffer(f, BUF_SIZE);
  Reader* r = new Reader();
  r->f = f;
  r->buf = new char[BUF_SIZE];
  return r;
}

// Multi-process partitioning (parallel/multihost.py).  fx_set_range seeks
// a PLAIN (seekable) file to `start` and stops before the first record at
// or past `end` — callers compute record-aligned cuts (byte_ranges).
// Returns 0 on success, -1 when the stream cannot seek (gzip).
// fx_set_stride keeps records p, p+n, 2n+p, ... (works on any stream).
int fx_set_range(void* handle, long start, long end) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r) return -1;
  if (gzdirect(r->f) == 0) return -1;  // compressed: cannot byte-partition
  if (gzseek(r->f, start, SEEK_SET) < 0) return -1;
  r->pending.clear();
  r->limit = end;
  return 0;
}

void fx_set_stride(void* handle, int process_id, int num_processes) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r) return;
  r->stride_p = process_id;
  r->stride_n = num_processes;
  r->rec_index = 0;
}

void fx_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r) return;
  gzclose(r->f);
  delete[] r->buf;
  delete r;
}

long fx_next_batch(void* handle, int max_segments, int max_len, int min_qual,
                   int min_len, unsigned char* out_codes, int* out_lens,
                   long* out_reads_parsed) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r) return -1;
  long filled = 0;
  std::string line, seq, qual;

  auto emit_carry = [&]() {
    while (r->carry_idx < r->carry.size() && filled < max_segments) {
      const auto& seg = r->carry[r->carry_idx++];
      int len = static_cast<int>(seg.size());
      unsigned char* row = out_codes + static_cast<long>(filled) * max_len;
      memcpy(row, seg.data(), len);
      memset(row + len, 4, max_len - len);
      out_lens[filled] = len;
      ++filled;
    }
    if (r->carry_idx >= r->carry.size()) {
      r->carry.clear();
      r->carry_idx = 0;
    }
  };

  emit_carry();

  while (filled < max_segments) {
    if (range_exhausted(r)) break;
    if (!read_line(r, &line)) break;
    if (line.empty()) continue;
    if (!r->inited) {
      r->is_fastq = line[0] == '@';
      if (!r->is_fastq && line[0] != '>') return -1;
      r->inited = true;
    }
    seq.clear();
    qual.clear();
    if (r->is_fastq) {
      if (line[0] != '@') return -1;
      if (!read_line(r, &seq)) break;
      if (!read_line(r, &line) || line.empty() || line[0] != '+') return -1;
      if (!read_line(r, &qual)) return -1;
    } else {
      if (line[0] != '>') return -1;
      // multi-line FASTA: accumulate until next header
      while (read_line(r, &line)) {
        if (!line.empty() && line[0] == '>') {
          r->pending = std::move(line);
          r->pending_pos = r->line_start;
          break;
        }
        seq.append(line);
        line.clear();
      }
    }
    if (!record_is_mine(r)) continue;
    ++r->reads_parsed;
    r->carry.clear();
    r->carry_idx = 0;
    segment_read(seq, qual, min_qual, min_len, max_len, &r->carry);
    emit_carry();
  }

  if (out_reads_parsed) *out_reads_parsed = r->reads_parsed;
  return filled;
}

// Paired-stage feeder: ONE row per read (not per segment).  Bases failing
// the quality/ACGT gate become code 4, so quality segments are exactly the
// runs of codes < 4 — the Python side recovers them with vectorized run
// scans instead of a per-read loop (the reference's FastqFilteredReader
// segmenting, applied at stage 2, RNABloom.java:4465-4663).
//   long fx_next_masked_batch(void* h, int max_reads, int max_len,
//                             int min_qual, unsigned char* out_codes,
//                             int* out_lens, float* out_avg_qual)
//     -> number of reads written (row-major [max_reads, max_len], padded
//        with 4; out_lens = min(read length, max_len); out_avg_qual = mean
//        Phred score per read, 127 for FASTA).  0 => EOF, -1 => error.
long fx_next_masked_batch(void* handle, int max_reads, int max_len,
                          int min_qual, unsigned char* out_codes,
                          int* out_lens, float* out_avg_qual) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r) return -1;
  const char qmin = static_cast<char>(33 + min_qual);
  long filled = 0;
  std::string line, seq, qual;

  while (filled < max_reads) {
    if (range_exhausted(r)) break;
    if (!read_line(r, &line)) break;
    if (line.empty()) continue;
    if (!r->inited) {
      r->is_fastq = line[0] == '@';
      if (!r->is_fastq && line[0] != '>') return -1;
      r->inited = true;
    }
    seq.clear();
    qual.clear();
    if (r->is_fastq) {
      if (line[0] != '@') return -1;
      if (!read_line(r, &seq)) break;
      if (!read_line(r, &line) || line.empty() || line[0] != '+') return -1;
      if (!read_line(r, &qual)) return -1;
    } else {
      if (line[0] != '>') return -1;
      while (read_line(r, &line)) {
        if (!line.empty() && line[0] == '>') {
          r->pending = std::move(line);
          r->pending_pos = r->line_start;
          break;
        }
        seq.append(line);
        line.clear();
      }
    }
    if (!record_is_mine(r)) continue;
    ++r->reads_parsed;
    const size_t n = seq.size();
    const bool has_qual = !qual.empty() && qual.size() == n;
    const size_t keep = n < static_cast<size_t>(max_len) ? n : max_len;
    unsigned char* row = out_codes + static_cast<long>(filled) * max_len;
    long qsum = 0;
    for (size_t i = 0; i < keep; ++i) {
      uint8_t c = kCode[(uint8_t)seq[i]];
      if (has_qual && qual[i] < qmin) c = 4;
      row[i] = c;
    }
    if (has_qual) {
      for (size_t i = 0; i < n; ++i) qsum += qual[i] - 33;
    }
    memset(row + keep, 4, max_len - keep);
    out_lens[filled] = static_cast<int>(keep);
    out_avg_qual[filled] =
        has_qual ? static_cast<float>(qsum) / static_cast<float>(n) : 127.0f;
    ++filled;
  }
  return filled;
}

}  // extern "C"
