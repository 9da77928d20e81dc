// Columnar -> row-major interleave for the Arrow ingest bridge.
//
// Arrow record batches arrive as per-column contiguous buffers; the device
// feed wants one row-major (n, d) float32 matrix in a persistent staging
// buffer (models consume feature ROWS). The reference crosses this gap with
// per-element JNI copies (cntk-model/.../CNTKModel.scala:67-74 builds
// FloatVectorVectors value by value); here it is a cache-blocked, threaded
// transpose-copy straight from the Arrow buffers into the staging matrix —
// no Python-object materialization anywhere on the path.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kBlock = 128;  // rows per cache block

void interleave_range(const float *const *cols, int d, int64_t row_lo,
                      int64_t row_hi, float *out) {
  for (int64_t blk = row_lo; blk < row_hi; blk += kBlock) {
    int64_t hi = blk + kBlock < row_hi ? blk + kBlock : row_hi;
    for (int j = 0; j < d; ++j) {
      const float *src = cols[j];
      for (int64_t i = blk; i < hi; ++i) out[i * d + j] = src[i];
    }
  }
}

}  // namespace

extern "C" void mmltpu_interleave_f32(const float *const *cols, int d,
                                      int64_t n, float *out, int threads) {
  if (threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    threads = hw ? static_cast<int>(hw) : 1;
  }
  if (threads <= 1 || n < 4 * kBlock) {
    interleave_range(cols, d, 0, n, out);
    return;
  }
  std::vector<std::thread> pool;
  int64_t per = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    pool.emplace_back(interleave_range, cols, d, lo, hi, out);
  }
  for (auto &th : pool) th.join();
}
