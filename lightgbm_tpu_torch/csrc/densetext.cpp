// Native CSV/TSV tokenizer of the port's host data path.
//
// The JAX package reads dense text files with pandas' C tokenizer
// (lightgbm_tpu/core/parser.py _iter_dense_chunks); the port keeps to
// numpy and reads them here instead.  Two passes over the raw bytes, as
// src/native/textparse.cpp does for LibSVM: scan (rows and the width of
// the first row) then fill a row-major float64 matrix.  A token is a
// number in strtod's syntax, or missing (NaN): empty, or one of pandas'
// default NA strings.  The Python reader (core/parser.py _parse_dense)
// is the plain version; where a row's width differs from the first
// row's, or a token is neither, these return -1 and the Python reader
// decides (it pads ragged rows with NaN and raises on a bad token).
//
// Built on demand by lightgbm_tpu_torch/core/native.py with the system
// g++; host code, no CUDA.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline bool is_space(char c) { return c == ' ' || c == '\r' || c == '\t'; }

inline bool blank_line(const char* p, const char* end) {
  for (; p < end; ++p)
    if (!is_space(*p)) return false;
  return true;
}

// pandas' default missing-value strings (pandas/_libs/parsers.pyx
// STR_NA_VALUES) and the JAX reader's own (core/parser.py _NA_TOKENS)
const char* const kNa[] = {"na", "nan", "NaN", "NULL", "N/A", "NA", "null",
                           "-NaN", "-nan", "#N/A", "#N/A N/A", "#NA",
                           "-1.#IND", "-1.#QNAN", "1.#IND", "1.#QNAN",
                           "<NA>", "None", "n/a"};

bool is_na(const char* p, const char* end) {
  const size_t len = (size_t)(end - p);
  for (const char* na : kNa)
    if (std::strlen(na) == len && std::memcmp(na, p, len) == 0) return true;
  return false;
}

// One token [p, end) -> *out; false where it is not a number or NA.
// strtod reads the token in place: the byte after it is a separator, a
// line end or the buffer's terminating NUL (the caller passes a Python
// bytes object, which has one), none of which continues a number.
bool parse_token(const char* p, const char* end, double* out) {
  while (p < end && (*p == ' ' || *p == '\r')) ++p;
  while (end > p && (end[-1] == ' ' || end[-1] == '\r')) --end;
  if (p == end) {
    *out = __builtin_nan("");
    return true;
  }
  // strtod reads hex floats, which Python's float() refuses
  for (const char* q = p; q < end && q < p + 3; ++q)
    if (*q == 'x' || *q == 'X') return false;
  char* after = nullptr;
  *out = std::strtod(p, &after);
  if (after == end) return true;
  if (is_na(p, end)) {
    *out = __builtin_nan("");
    return true;
  }
  return false;
}

inline const char* line_end(const char* p, const char* end) {
  const void* nl = std::memchr(p, '\n', (size_t)(end - p));
  return nl ? static_cast<const char*>(nl) : end;
}

int64_t count_fields(const char* p, const char* end, char sep) {
  int64_t n = 1;
  for (; p < end; ++p) n += *p == sep;
  return n;
}

}  // namespace

extern "C" {

// Pass 1: the non-blank lines and the width of the first; -1 where a
// line's width differs.
int64_t lgbtt_dense_scan(const char* buf, int64_t len, char sep,
                         int64_t* n_rows, int64_t* n_cols) {
  const char* p = buf;
  const char* end = buf + len;
  *n_rows = 0;
  *n_cols = 0;
  while (p < end) {
    const char* le = line_end(p, end);
    if (!blank_line(p, le)) {
      const int64_t w = count_fields(p, le, sep);
      if (*n_rows == 0) *n_cols = w;
      else if (w != *n_cols) return -1;
      ++*n_rows;
    }
    p = le < end ? le + 1 : end;
  }
  return 0;
}

// Pass 2: out[n_rows, n_cols] row-major; returns the rows written, or -1
// on a token that is not a number or NA.
int64_t lgbtt_dense_fill(const char* buf, int64_t len, char sep,
                         double* out, int64_t n_rows, int64_t n_cols) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t row = 0;
  while (p < end && row < n_rows) {
    const char* le = line_end(p, end);
    if (!blank_line(p, le)) {
      double* r = out + row * n_cols;
      const char* t = p;
      for (int64_t c = 0; c < n_cols; ++c) {
        const char* te = t;
        while (te < le && *te != sep) ++te;
        if (!parse_token(t, te, r + c)) return -1;
        t = te + 1;
      }
      ++row;
    }
    p = le < end ? le + 1 : end;
  }
  return row;
}

}  // extern "C"
