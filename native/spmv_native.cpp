// Native ingestion backend: fast MatrixMarket parsing + COO normalization.
//
// Native equivalent of the reference's C ingestion layer (vendored NIST
// mmio src/lib/mmio.c + MM->COO parser src/lib/parser.c:30-153): banner and
// typecode validation, real/integer/pattern fields, symmetric expansion
// (off-diagonal mirroring), per-row length accumulation, and (row, col)
// sorting — implemented from scratch in C++17 with OpenMP-parallel sorting,
// exposed over a C ABI consumed via ctypes (io/native.py).
//
// Build: make -C native   ->  libspmv_native.so

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#include <parallel/algorithm>
#define SORT __gnu_parallel::sort
#else
#define SORT std::sort
#endif

extern "C" {

// Error codes
enum {
  SPMV_OK = 0,
  SPMV_ERR_BANNER = 1,
  SPMV_ERR_UNSUPPORTED = 2,
  SPMV_ERR_SIZE_LINE = 3,
  SPMV_ERR_ENTRY = 4,
  SPMV_ERR_COUNT_MISMATCH = 5,
  SPMV_ERR_OOB = 6,
  SPMV_ERR_ALLOC = 7,
};

struct SpmvCoo {
  int64_t m, n, nnz;
  int64_t* rows;
  int64_t* cols;
  double* vals;
  int64_t* row_lens;  // length m
};

void spmv_free_coo(SpmvCoo* c) {
  if (!c) return;
  std::free(c->rows);
  std::free(c->cols);
  std::free(c->vals);
  std::free(c->row_lens);
  c->rows = c->cols = c->row_lens = nullptr;
  c->vals = nullptr;
}

}  // extern "C"

namespace {

struct Cursor {
  const char* p;
  const char* end;
};

inline void skip_ws(Cursor& c) {
  while (c.p < c.end && (*c.p == ' ' || *c.p == '\t' || *c.p == '\r' ||
                         *c.p == '\n'))
    ++c.p;
}

inline bool read_line(Cursor& c, std::string& out) {
  if (c.p >= c.end) return false;
  const char* nl = static_cast<const char*>(
      memchr(c.p, '\n', static_cast<size_t>(c.end - c.p)));
  if (!nl) nl = c.end;
  out.assign(c.p, static_cast<size_t>(nl - c.p));
  while (!out.empty() && out.back() == '\r') out.pop_back();  // CRLF input
  c.p = (nl < c.end) ? nl + 1 : c.end;
  return true;
}

inline int64_t parse_i64(Cursor& c, bool* ok) {
  skip_ws(c);
  char* endp = nullptr;
  long long v = strtoll(c.p, &endp, 10);
  *ok = (endp != c.p);
  c.p = endp;
  return static_cast<int64_t>(v);
}

inline double parse_f64(Cursor& c, bool* ok) {
  skip_ws(c);
  char* endp = nullptr;
  double v = strtod(c.p, &endp);
  *ok = (endp != c.p);
  c.p = endp;
  return v;
}

std::string lower(const std::string& s) {
  std::string out(s);
  for (auto& ch : out) ch = static_cast<char>(tolower(ch));
  return out;
}

}  // namespace

extern "C" {

// Parse a MatrixMarket coordinate body held in memory (decompression happens
// on the Python side). Output entries are sorted by (row, col); symmetric
// matrices are expanded. Duplicate entries are NOT merged (matching the
// reference, which treats them as input errors downstream); callers can
// detect them because rows/cols are sorted.
int spmv_parse_mtx(const char* buf, int64_t len, SpmvCoo* out) {
  Cursor c{buf, buf + len};
  std::string line;
  if (!read_line(c, line)) return SPMV_ERR_BANNER;
  // banner: %%MatrixMarket matrix coordinate <field> <symmetry>
  {
    std::vector<std::string> toks;
    size_t pos = 0;
    while (pos < line.size()) {
      size_t sp = line.find_first_of(" \t", pos);
      if (sp == std::string::npos) sp = line.size();
      if (sp > pos) toks.push_back(line.substr(pos, sp - pos));
      pos = sp + 1;
    }
    if (toks.size() < 5 || toks[0] != "%%MatrixMarket") return SPMV_ERR_BANNER;
    if (lower(toks[1]) != "matrix") return SPMV_ERR_UNSUPPORTED;
    if (lower(toks[2]) != "coordinate") return SPMV_ERR_UNSUPPORTED;
    std::string field = lower(toks[3]), sym = lower(toks[4]);
    bool pattern = field == "pattern";
    bool numeric = field == "real" || field == "integer";
    if (!pattern && !numeric) return SPMV_ERR_UNSUPPORTED;
    bool symmetric = sym == "symmetric";
    if (!symmetric && sym != "general") return SPMV_ERR_UNSUPPORTED;

    // skip comments/blank to size line
    std::string sline;
    for (;;) {
      if (!read_line(c, sline)) return SPMV_ERR_SIZE_LINE;
      size_t i = sline.find_first_not_of(" \t\r");
      if (i == std::string::npos) continue;
      if (sline[i] == '%') continue;
      break;
    }
    Cursor sc{sline.c_str(), sline.c_str() + sline.size()};
    bool ok1, ok2, ok3;
    int64_t m = parse_i64(sc, &ok1);
    int64_t n = parse_i64(sc, &ok2);
    int64_t nz = parse_i64(sc, &ok3);
    if (!ok1 || !ok2 || !ok3 || m < 0 || n < 0 || nz < 0)
      return SPMV_ERR_SIZE_LINE;
    if (symmetric && m != n) return SPMV_ERR_UNSUPPORTED;  // must be square

    // reserve for worst case symmetric expansion (2*nz, parser.c:49-52 analog)
    size_t cap = symmetric ? static_cast<size_t>(2 * nz) : static_cast<size_t>(nz);
    std::vector<int64_t> rows, cols;
    std::vector<double> vals;
    rows.reserve(cap);
    cols.reserve(cap);
    vals.reserve(cap);

    int64_t parsed = 0;
    for (;;) {
      skip_ws(c);
      if (c.p >= c.end) break;
      bool okr, okc;
      int64_t r = parse_i64(c, &okr);
      int64_t col = parse_i64(c, &okc);
      if (!okr || !okc) return SPMV_ERR_ENTRY;
      double v = 1.0;  // pattern value (parser.c:60-61 analog)
      if (numeric) {
        bool okv;
        v = parse_f64(c, &okv);
        if (!okv) return SPMV_ERR_ENTRY;
      }
      --r;
      --col;  // 1-based -> 0-based
      if (r < 0 || r >= m || col < 0 || col >= n) return SPMV_ERR_OOB;
      rows.push_back(r);
      cols.push_back(col);
      vals.push_back(v);
      if (symmetric && r != col) {  // mirror off-diagonal (parser.c:85-91)
        rows.push_back(col);
        cols.push_back(r);
        vals.push_back(v);
      }
      ++parsed;
    }
    if (parsed != nz) return SPMV_ERR_COUNT_MISMATCH;

    // sort by (row, col)
    int64_t total = static_cast<int64_t>(rows.size());
    std::vector<int64_t> order(total);
    for (int64_t i = 0; i < total; ++i) order[i] = i;
    const int64_t* rp = rows.data();
    const int64_t* cp = cols.data();
    SORT(order.begin(), order.end(), [rp, cp](int64_t a, int64_t b) {
      if (rp[a] != rp[b]) return rp[a] < rp[b];
      return cp[a] < cp[b];
    });

    out->m = m;
    out->n = n;
    out->nnz = total;
    size_t alloc_n = total > 0 ? static_cast<size_t>(total) : 1;  // malloc(0)
    out->rows = static_cast<int64_t*>(std::malloc(sizeof(int64_t) * alloc_n));
    out->cols = static_cast<int64_t*>(std::malloc(sizeof(int64_t) * alloc_n));
    out->vals = static_cast<double*>(std::malloc(sizeof(double) * alloc_n));
    out->row_lens = static_cast<int64_t*>(std::calloc(m > 0 ? m : 1, sizeof(int64_t)));
    if (!out->rows || !out->cols || !out->vals || !out->row_lens) {
      spmv_free_coo(out);
      return SPMV_ERR_ALLOC;
    }
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < total; ++i) {
      int64_t o = order[i];
      out->rows[i] = rows[o];
      out->cols[i] = cols[o];
      out->vals[i] = vals[o];
    }
    for (int64_t i = 0; i < total; ++i) out->row_lens[out->rows[i]]++;
    return SPMV_OK;
  }
}

// COO (sorted) -> CSR scatter: fills caller-allocated indptr (m+1),
// indices (nnz), data (nnz). The COOtoCSR analog (parser.c:157-215) with the
// prefix-sum + scatter done natively.
int spmv_coo_to_csr(int64_t m, int64_t nnz, const int64_t* rows,
                    const int64_t* cols, const double* vals,
                    const int64_t* row_lens, int64_t* indptr, int64_t* indices,
                    double* data) {
  indptr[0] = 0;
  for (int64_t r = 0; r < m; ++r) indptr[r + 1] = indptr[r] + row_lens[r];
  if (indptr[m] != nnz) return SPMV_ERR_COUNT_MISMATCH;
  // entries sorted by (row, col): contiguous copy per row
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < nnz; ++i) {
    indices[i] = cols[i];
    data[i] = vals[i];
  }
  // consistency: per-row strictly increasing columns (parser.c:195-202)
  for (int64_t i = 1; i < nnz; ++i) {
    if (rows[i] < rows[i - 1]) return SPMV_ERR_ENTRY;  // rows must ascend
    if (rows[i] == rows[i - 1] && cols[i] <= cols[i - 1]) return SPMV_ERR_ENTRY;
  }
  return SPMV_OK;
}

// COO (sorted) -> ELL slabs: fills caller-allocated (m, width) ja/data
// (row-major, zero padded). The COOtoELL analog (parser.c:217-296); the
// 2*m*max_row_nz cap is enforced by the Python wrapper.
int spmv_coo_to_ell(int64_t m, int64_t nnz, const int64_t* rows,
                    const int64_t* cols, const double* vals, int64_t width,
                    int64_t* ja, double* data) {
  std::memset(ja, 0, sizeof(int64_t) * static_cast<size_t>(m * width));
  std::memset(data, 0, sizeof(double) * static_cast<size_t>(m * width));
  int64_t slot = 0;
  int64_t prev_row = -1;
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t r = rows[i];
    slot = (r == prev_row) ? slot + 1 : 0;
    prev_row = r;
    if (slot >= width) return SPMV_ERR_OOB;
    ja[r * width + slot] = cols[i];
    data[r * width + slot] = vals[i];
  }
  return SPMV_OK;
}

}  // extern "C"

extern "C" {

int spmv_native_abi_version() { return 5; }

}  // extern "C"
