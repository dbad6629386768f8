// Fast MatrixMarket coordinate reader on the host: the port's copy of the
// JAX package's native/mmio.cpp, the replacement for the reference's
// matrix-loading layer (MatrixMarket.mmread / MAT.matopen,
// Julia/benchmark.jl:21-28).  SuiteSparse benchmark matrices (ldoor, hood,
// audikw) run to hundreds of millions of text tokens; Python-side parsing
// (scipy.io.mmread) is the bottleneck of loading them, so the parse loop
// lives here: one buffered read, in-place tokenization, no per-line
// allocation.  rbl_tpu_torch/native.py builds it with g++ at first use.
//
// Supports: "%%MatrixMarket matrix coordinate real|integer|pattern
// general|symmetric|skew-symmetric".  Symmetric/skew expansion is left to
// the Python wrapper (scipy handles duplicate-free COO directly).
//
// C ABI (two-phase):
//   rbl_mm_open(path, &handle, &nrows, &ncols, &nnz, &symcode) -> 0/err
//   rbl_mm_read(handle, rows, cols, vals) -> 0/err   (arrays sized nnz)
//   rbl_mm_close(handle)
// symcode: 0 general, 1 symmetric, 2 skew-symmetric.

#include <cctype>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct MMFile {
  std::vector<char> buf;  // whole file, NUL-terminated
  size_t pos = 0;         // cursor at first data line
  int64_t nrows = 0, ncols = 0, nnz = 0;
  int symcode = 0;
  bool pattern = false;
};

bool line_starts(const char* p, const char* kw) {
  return std::strncmp(p, kw, std::strlen(kw)) == 0;
}

}  // namespace

extern "C" {

int rbl_mm_open(const char* path, void** handle, int64_t* nrows,
                int64_t* ncols, int64_t* nnz, int* symcode) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  auto* mm = new MMFile();
  mm->buf.resize((size_t)sz + 1);
  if (std::fread(mm->buf.data(), 1, (size_t)sz, f) != (size_t)sz) {
    std::fclose(f);
    delete mm;
    return -2;
  }
  std::fclose(f);
  mm->buf[(size_t)sz] = '\0';

  char* p = mm->buf.data();
  // header line
  if (!line_starts(p, "%%MatrixMarket")) { delete mm; return -3; }
  char* nl = std::strchr(p, '\n');
  if (!nl) { delete mm; return -3; }
  std::string header(p, nl - p);
  for (auto& c : header) c = (char)std::tolower((unsigned char)c);
  if (header.find("matrix") == std::string::npos ||
      header.find("coordinate") == std::string::npos) {
    delete mm;
    return -4;  // dense "array" format not handled natively
  }
  mm->pattern = header.find("pattern") != std::string::npos;
  if (header.find("complex") != std::string::npos) { delete mm; return -5; }
  if (header.find("skew-symmetric") != std::string::npos) mm->symcode = 2;
  else if (header.find("symmetric") != std::string::npos) mm->symcode = 1;
  else if (header.find("hermitian") != std::string::npos) mm->symcode = 1;

  p = nl + 1;
  // skip comments / blank lines
  while (*p == '%' || *p == '\n' || *p == '\r') {
    nl = std::strchr(p, '\n');
    if (!nl) { delete mm; return -3; }
    p = nl + 1;
  }
  char* end = nullptr;
  mm->nrows = std::strtoll(p, &end, 10);
  mm->ncols = std::strtoll(end, &end, 10);
  mm->nnz = std::strtoll(end, &end, 10);
  if (mm->nrows <= 0 || mm->ncols <= 0 || mm->nnz < 0) { delete mm; return -3; }
  nl = std::strchr(end, '\n');
  mm->pos = (nl ? nl + 1 : end) - mm->buf.data();

  *handle = mm;
  *nrows = mm->nrows;
  *ncols = mm->ncols;
  *nnz = mm->nnz;
  *symcode = mm->symcode;
  return 0;
}

namespace {

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
    p++;
  return p;
}

// std::from_chars rejects a leading '+', which is valid in MatrixMarket
// numeric fields — skip it explicitly.
inline const char* skip_plus(const char* p, const char* end) {
  return (p < end && *p == '+') ? p + 1 : p;
}

// Parse every "row col [val]" triple in [lo, hi) into the thread-local
// vectors.  std::from_chars: locale-free, no strtod erange overhead.
struct ParseOut {
  std::vector<int64_t> r, c;
  std::vector<double> v;
  bool bad = false;
};

void parse_range(const char* lo, const char* hi, bool pattern, ParseOut* out) {
  const char* p = lo;
  while (true) {
    p = skip_ws(p, hi);
    if (p >= hi) break;
    int64_t r = 0, c = 0;
    auto res = std::from_chars(skip_plus(p, hi), hi, r);
    if (res.ec != std::errc()) { out->bad = true; return; }
    p = skip_ws(res.ptr, hi);
    res = std::from_chars(skip_plus(p, hi), hi, c);
    if (res.ec != std::errc()) { out->bad = true; return; }
    p = res.ptr;
    double v = 1.0;
    if (!pattern) {
      p = skip_ws(p, hi);
      auto resd = std::from_chars(skip_plus(p, hi), hi, v);
      if (resd.ec != std::errc()) { out->bad = true; return; }
      p = resd.ptr;
    }
    out->r.push_back(r - 1);
    out->c.push_back(c - 1);
    out->v.push_back(v);
  }
}

}  // namespace

// rows/cols out are 0-based int64; vals filled with 1.0 for pattern files.
// Parallel: the data region splits at line boundaries across hardware
// threads; per-thread results concatenate in file order.
int rbl_mm_read(void* handle, int64_t* rows, int64_t* cols, double* vals) {
  auto* mm = (MMFile*)handle;
  const char* base = mm->buf.data() + mm->pos;
  const char* end = mm->buf.data() + mm->buf.size() - 1;  // before NUL
  size_t bytes = (size_t)(end - base);

  unsigned nt = std::thread::hardware_concurrency();
  if (nt == 0) nt = 1;
  if (bytes < (1u << 20)) nt = 1;  // small file: skip thread overhead
  if ((int64_t)nt > mm->nnz && mm->nnz > 0) nt = (unsigned)mm->nnz;

  std::vector<const char*> cut(nt + 1);
  cut[0] = base;
  cut[nt] = end;
  for (unsigned t = 1; t < nt; t++) {
    const char* p = base + bytes * t / nt;
    while (p < end && *p != '\n') p++;  // advance to a line boundary
    cut[t] = (p < end) ? p + 1 : end;
  }

  std::vector<ParseOut> outs(nt);
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < nt; t++) {
    outs[t].r.reserve(mm->nnz / nt + 16);
    outs[t].c.reserve(mm->nnz / nt + 16);
    outs[t].v.reserve(mm->nnz / nt + 16);
    threads.emplace_back(parse_range, cut[t], cut[t + 1], mm->pattern,
                         &outs[t]);
  }
  for (auto& th : threads) th.join();

  int64_t total = 0;
  for (auto& o : outs) {
    if (o.bad) return -6;
    total += (int64_t)o.r.size();
  }
  if (total != mm->nnz) return -7;  // truncated or malformed file

  size_t off = 0;
  for (auto& o : outs) {
    std::memcpy(rows + off, o.r.data(), o.r.size() * sizeof(int64_t));
    std::memcpy(cols + off, o.c.data(), o.c.size() * sizeof(int64_t));
    std::memcpy(vals + off, o.v.data(), o.v.size() * sizeof(double));
    off += o.r.size();
  }
  return 0;
}

void rbl_mm_close(void* handle) { delete (MMFile*)handle; }

}  // extern "C"
