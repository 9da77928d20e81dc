// GBDT quantile binning: (n, d) float32 rows -> (n, d) uint8 bin ids.
//
// The numpy host path does d separate column-strided searchsorted passes;
// this kernel walks row-major memory once with a branchless lower_bound
// per cell (the per-feature edge tables are a few KB and stay in L1/L2)
// and threads over row ranges.
//
// Semantics are bit-identical to engine.bin_data: bin = count of edges
// strictly less than x (searchsorted side='left'), NaN -> bin 0,
// categorical columns bin by identity clipped to [0, max_bin-1].

#include "mmltpu.h"

#include <algorithm>
#include <cmath>
#include <thread>
#include <vector>

namespace {

// count of edges < v over an ascending edge array (branchless)
inline int lower_bound_count(const float *e, int len, float v) {
  int lo = 0;
  while (len > 1) {
    const int half = len / 2;
    lo += (e[lo + half - 1] < v) ? half : 0;
    len -= half;
  }
  return lo + ((len == 1 && e[lo] < v) ? 1 : 0);
}

void bin_rows(const float *x, int64_t row_lo, int64_t row_hi, int d,
              const float *edges, int n_edges, const uint8_t *cat_mask,
              int max_bin, uint8_t *out) {
  const float cat_hi = static_cast<float>(max_bin - 1);
  for (int64_t i = row_lo; i < row_hi; ++i) {
    const float *row = x + i * d;
    uint8_t *orow = out + i * d;
    for (int j = 0; j < d; ++j) {
      const float v = row[j];
      if (std::isnan(v)) {
        orow[j] = 0;
        continue;
      }
      if (cat_mask != nullptr && cat_mask[j]) {
        float c = v;
        if (c < 0.0f) c = 0.0f;
        if (c > cat_hi) c = cat_hi;
        orow[j] = static_cast<uint8_t>(c);   // truncation = numpy astype
        continue;
      }
      orow[j] = static_cast<uint8_t>(
          lower_bound_count(edges + static_cast<int64_t>(j) * n_edges,
                            n_edges, v));
    }
  }
}

}  // namespace

extern "C" void mmltpu_bin_data(const float *x, int64_t n, int d,
                                const float *edges, int n_edges,
                                const uint8_t *cat_mask, int max_bin,
                                uint8_t *out, int n_threads) {
  if (n <= 0 || d <= 0) return;
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  // no point spinning threads for small row counts
  const int64_t min_rows_per_thread = 1 << 15;
  n_threads = static_cast<int>(std::min<int64_t>(
      n_threads, std::max<int64_t>(1, n / min_rows_per_thread)));
  if (n_threads == 1) {
    bin_rows(x, 0, n, d, edges, n_edges, cat_mask, max_bin, out);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  const int64_t step = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t lo = t * step;
    const int64_t hi = std::min<int64_t>(lo + step, n);
    if (lo >= hi) break;
    workers.emplace_back(bin_rows, x, lo, hi, d, edges, n_edges, cat_mask,
                         max_bin, out);
  }
  for (auto &w : workers) w.join();
}
