// Parallel CSV -> row-major float32 matrix.
//
// The GBDT ingest fast path: the reference feeds LightGBM by converting
// Spark rows to dense C buffers per partition (LightGBMUtils.scala:192-222);
// here a delimited file is chunked on newline boundaries and parsed by a
// thread per chunk with a hand-rolled float scanner (strtod fallback for
// exotic forms), producing one contiguous matrix ready for jnp.asarray.

#include "mmltpu.h"

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Fast float parse over [p, end); advances *p to the first unconsumed char.
// Handles [+-]digits[.digits][eE[+-]digits], inf/nan; falls back to strtod
// when the fast path cannot represent the value exactly enough.
float parse_float(const char **pp, const char *end) {
  const char *p = *pp;
  const char *start = p;
  bool neg = false;
  if (p < end && (*p == '+' || *p == '-')) neg = (*p++ == '-');
  double mant = 0.0;
  int digits = 0, frac = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    mant = mant * 10.0 + (*p - '0');
    ++p; ++digits;
  }
  if (p < end && *p == '.') {
    ++p;
    while (p < end && *p >= '0' && *p <= '9') {
      mant = mant * 10.0 + (*p - '0');
      ++p; ++digits; ++frac;
    }
  }
  if (digits == 0) {  // inf / nan / garbage -> strtod
    char tmp[64];
    const size_t n = std::min<size_t>(end - start, sizeof(tmp) - 1);
    memcpy(tmp, start, n);
    tmp[n] = '\0';
    char *stop = nullptr;
    const double v = strtod(tmp, &stop);
    if (stop == tmp) { *pp = start; return NAN; }
    *pp = start + (stop - tmp);
    return static_cast<float>(v);
  }
  int exp = 0;
  if (p < end && (*p == 'e' || *p == 'E')) {
    const char *ep = p + 1;
    bool eneg = false;
    if (ep < end && (*ep == '+' || *ep == '-')) eneg = (*ep++ == '-');
    int ev = 0, edig = 0;
    while (ep < end && *ep >= '0' && *ep <= '9') {
      ev = ev * 10 + (*ep - '0');
      ++ep; ++edig;
    }
    if (edig) { exp = eneg ? -ev : ev; p = ep; }
  }
  const double v = mant * pow(10.0, exp - frac);
  *pp = p;
  return static_cast<float>(neg ? -v : v);
}

// Parse one line into out[0..cols); returns fields actually seen.
int parse_line(const char *p, const char *end, char delim,
               float *out, int64_t cols) {
  int64_t f = 0;
  while (p < end && f < cols) {
    while (p < end && *p == ' ') ++p;
    const char *before = p;
    const float v = parse_float(&p, end);
    out[f++] = (p == before) ? NAN : v;
    while (p < end && *p != delim) ++p;  // trailing junk in the field
    if (p < end) ++p;                    // skip delimiter
  }
  for (int64_t i = f; i < cols; ++i) out[i] = NAN;
  return static_cast<int>(f);
}

}  // namespace

extern "C" int mmltpu_csv_parse(const char *path, int skip_header, char delim,
                                int n_threads, float **out,
                                int64_t *out_rows, int64_t *out_cols) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  const long fsz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> text(static_cast<size_t>(std::max(0L, fsz)));
  if (fsz > 0 && fread(text.data(), 1, text.size(), f) != text.size()) {
    fclose(f);
    return -1;
  }
  fclose(f);
  const char *p = text.data();
  const char *end = p + text.size();

  if (skip_header) {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  if (p >= end) { *out = nullptr; *out_rows = 0; *out_cols = 0; return 0; }

  // column count from the first data row
  int64_t cols = 1;
  for (const char *q = p; q < end && *q != '\n'; ++q)
    if (*q == delim) ++cols;

  // newline-boundary chunking
  const int nt = std::max(1, n_threads);
  std::vector<const char *> cuts{p};
  for (int i = 1; i < nt; ++i) {
    const char *q = p + (end - p) * static_cast<int64_t>(i) / nt;
    while (q < end && *q != '\n') ++q;
    if (q < end) ++q;
    cuts.push_back(q);
  }
  cuts.push_back(end);

  std::vector<std::vector<float>> parts(nt);
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t] {
      const char *q = cuts[t];
      const char *stop = cuts[t + 1];
      auto &vals = parts[t];
      while (q < stop) {
        const char *eol = q;
        while (eol < stop && *eol != '\n') ++eol;
        const char *trim = eol;
        if (trim > q && trim[-1] == '\r') --trim;
        if (trim > q) {  // skip blank lines
          vals.resize(vals.size() + cols);
          parse_line(q, trim, delim, vals.data() + vals.size() - cols, cols);
        }
        q = (eol < stop) ? eol + 1 : stop;
      }
    });
  }
  for (auto &th : threads) th.join();

  int64_t total = 0;
  for (auto &v : parts) total += static_cast<int64_t>(v.size());
  float *mat = static_cast<float *>(malloc(sizeof(float) *
                                           std::max<int64_t>(total, 1)));
  if (!mat) return -1;
  int64_t off = 0;
  for (auto &v : parts) {
    memcpy(mat + off, v.data(), v.size() * sizeof(float));
    off += static_cast<int64_t>(v.size());
  }
  *out = mat;
  *out_rows = total / cols;
  *out_cols = cols;
  return 0;
}
