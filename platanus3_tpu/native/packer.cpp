// Native FASTA/FASTQ parser + 2-bit chunk packer.
//
// Host-side data loader for the device pipeline (ctypes API, no pybind).
// Replaces the reference's getline-per-line, std::string-append parser
// (reference src/Load.cpp:32-103) with a single mmap-style buffered scan
// and multithreaded packing into the framework's chunked layout
// (io/reads.py docstring): fixed-width chunks, stride = chunk_len - k + 1,
// 16 bases per uint32 lane, first base most significant.
//
// Contract matched with the Python fallback parser:
//  * format sniffed from first byte ('>' FASTA / '@' FASTQ)
//  * multi-line FASTA, 4-line FASTQ
//  * reads shorter than k dropped; all_bases counts kept reads only
//  * A/C/G/T (either case) -> 0/1/2/3, anything else -> 0
//
// Built on first use by native/__init__.py (g++ -O3 -shared -fPIC -pthread)
// into a source-digest-named library; falls back to numpy parsing when no
// compiler is available.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Read {
  size_t off;   // offset of first base in the concatenated base buffer
  uint32_t len;
};

struct Handle {
  std::vector<uint8_t> codes;   // all kept reads' base codes, concatenated
  std::vector<Read> reads;
  uint64_t all_bases = 0;
  int k = 0;
  int chunk_len = 0;
  uint64_t num_chunks = 0;
};

uint8_t g_code[256];
struct CodeInit {
  CodeInit() {
    memset(g_code, 0, sizeof(g_code));
    g_code[(int)'A'] = 0; g_code[(int)'a'] = 0;
    g_code[(int)'C'] = 1; g_code[(int)'c'] = 1;
    g_code[(int)'G'] = 2; g_code[(int)'g'] = 2;
    g_code[(int)'T'] = 3; g_code[(int)'t'] = 3;
  }
} g_code_init;

// Read the whole file into memory (reads are later 2-bit packed, so the
// peak is bounded by file size + codes).
bool slurp(const char* path, std::vector<char>& buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  buf.resize((size_t)n);
  size_t got = fread(buf.data(), 1, (size_t)n, f);
  fclose(f);
  return got == (size_t)n;
}

void finish_read(Handle* h, size_t start_off) {
  size_t len = h->codes.size() - start_off;
  if ((int64_t)len >= h->k) {
    h->reads.push_back({start_off, (uint32_t)len});
    h->all_bases += len;
  } else {
    h->codes.resize(start_off);  // drop short read
  }
}

void append_seq_line(Handle* h, const char* s, const char* e) {
  size_t old = h->codes.size();
  h->codes.resize(old + (size_t)(e - s));
  uint8_t* dst = h->codes.data() + old;
  for (const char* p = s; p < e; ++p) *dst++ = g_code[(uint8_t)*p];
}

}  // namespace

extern "C" {

// Parse the file; returns an opaque handle (nullptr on failure).
void* p3_open(const char* path, int k, int chunk_len) {
  std::vector<char> buf;
  if (!slurp(path, buf) || buf.empty()) return nullptr;
  Handle* h = new Handle();
  h->k = k;
  h->chunk_len = chunk_len;
  h->codes.reserve(buf.size() / 2);

  const char* p = buf.data();
  const char* end = p + buf.size();
  bool fastq = (*p == '@');
  if (!fastq && *p != '>') { delete h; return nullptr; }

  if (!fastq) {
    // FASTA: '>' header lines delimit records; sequence may span lines.
    size_t cur = 0;
    bool in_read = false;
    while (p < end) {
      const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
      const char* le = nl ? nl : end;
      if (*p == '>') {
        if (in_read) finish_read(h, cur);
        cur = h->codes.size();
        in_read = true;
      } else if (in_read) {
        append_seq_line(h, p, le);
      }
      p = nl ? nl + 1 : end;
    }
    if (in_read) finish_read(h, cur);
  } else {
    // FASTQ: strict 4-line records (header, seq, +, quality).
    int phase = 0;
    size_t cur = 0;
    while (p < end) {
      const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
      const char* le = nl ? nl : end;
      if (phase == 1) {
        cur = h->codes.size();
        append_seq_line(h, p, le);
        finish_read(h, cur);
      }
      phase = (phase + 1) & 3;
      p = nl ? nl + 1 : end;
    }
  }

  int stride = chunk_len - k + 1;
  uint64_t chunks = 0;
  for (const Read& r : h->reads)
    chunks += (uint64_t)((r.len - k) / stride) + 1;
  h->num_chunks = chunks;
  return h;
}

uint64_t p3_num_chunks(void* vh) { return ((Handle*)vh)->num_chunks; }
uint64_t p3_num_reads(void* vh) { return ((Handle*)vh)->reads.size(); }
uint64_t p3_all_bases(void* vh) { return ((Handle*)vh)->all_bases; }

// Fill caller-allocated arrays (shapes from p3_num_chunks):
//   packed     [num_chunks * chunk_len/16] u32
//   valid_len, read_id, start, read_len  [num_chunks] i32
//   prev_base, next_base                 [num_chunks] u8
void p3_fill(void* vh, uint32_t* packed, int32_t* valid_len,
             int32_t* read_id, int32_t* start, int32_t* read_len,
             uint8_t* prev_base, uint8_t* next_base, int num_threads) {
  Handle* h = (Handle*)vh;
  const int k = h->k, chunk_len = h->chunk_len;
  const int stride = chunk_len - k + 1;
  const int words = chunk_len / 16;

  // Per-read chunk row offsets (prefix sum).
  size_t n_reads = h->reads.size();
  std::vector<uint64_t> row0(n_reads + 1, 0);
  for (size_t i = 0; i < n_reads; ++i)
    row0[i + 1] = row0[i] + (h->reads[i].len - k) / stride + 1;

  auto work = [&](size_t r_lo, size_t r_hi) {
    for (size_t ri = r_lo; ri < r_hi; ++ri) {
      const Read& rd = h->reads[ri];
      const uint8_t* codes = h->codes.data() + rd.off;
      uint64_t row = row0[ri];
      uint32_t nchunks = (rd.len - k) / stride + 1;
      for (uint32_t ci = 0; ci < nchunks; ++ci, ++row) {
        uint32_t st = ci * (uint32_t)stride;
        uint32_t v = rd.len - st < (uint32_t)chunk_len ? rd.len - st
                                                       : (uint32_t)chunk_len;
        valid_len[row] = (int32_t)v;
        read_id[row] = (int32_t)ri;
        start[row] = (int32_t)st;
        read_len[row] = (int32_t)rd.len;
        prev_base[row] = st > 0 ? codes[st - 1] : (uint8_t)4;
        next_base[row] =
            st + chunk_len < rd.len ? codes[st + chunk_len] : (uint8_t)4;
        uint32_t* out = packed + row * (uint64_t)words;
        const uint8_t* src = codes + st;
        for (int w = 0; w < words; ++w) {
          uint32_t acc = 0;
          int base0 = w * 16;
          int lim = (int)v - base0;
          if (lim > 16) lim = 16;
          for (int t = 0; t < lim; ++t)
            acc |= (uint32_t)src[base0 + t] << (30 - 2 * t);
          out[w] = acc;
        }
      }
    }
  };

  int nt = num_threads > 0 ? num_threads : 1;
  if (nt == 1 || n_reads < 2) {
    work(0, n_reads);
  } else {
    std::vector<std::thread> ths;
    size_t per = (n_reads + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      size_t lo = (size_t)t * per;
      size_t hi = lo + per < n_reads ? lo + per : n_reads;
      if (lo >= hi) break;
      ths.emplace_back(work, lo, hi);
    }
    for (auto& t : ths) t.join();
  }
}

void p3_close(void* vh) { delete (Handle*)vh; }

}  // extern "C"
