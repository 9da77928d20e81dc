// Threaded prefetching batch loader.
//
// Worker threads claim work units in order — runs of up to kChunk files of
// one batch, so every thread works even when an epoch is a few large
// batches — read + decode + resize each file into its slot of a contiguous
// [batch, H, W, 3] uint8 buffer, and hand the batch to a bounded reorder
// window once its last unit is done; the consumer pops batches in
// sequence. This is the host half of the ingest path: the Python side
// copies each batch into a pinned staging buffer and from there to the card
// without blocking, overlapping disk/decode with device compute — replacing
// the reference's per-element JNI copies (CNTKModel.scala:67-74) and
// scp/getmerge data movement (CommandBuilders.scala:200-228).

#include "mmltpu.h"

#include <algorithm>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kChunk = 256;  // files per work unit

struct Batch {
  // batch*H*W*3, left uninitialised: each unit writes all of its slots
  // (slots not decoded are zeroed)
  std::unique_ptr<uint8_t[]> data;
  size_t bytes = 0;
  std::vector<uint8_t> ok;    // per slot: 1 decoded, 0 failed, 2 not built
  int count = 0;              // valid rows (< batch only in the final batch)
  int units_left = 0;         // work units still filling it
};

struct Loader {
  std::vector<std::string> paths;
  int batch, out_h, out_w, n_batches, units_per_batch, max_prefetch;
  std::vector<std::thread> workers;

  std::mutex mu;
  std::condition_variable cv_produced, cv_space;
  std::map<int, std::unique_ptr<Batch>> filling;  // batches being decoded
  std::map<int, std::unique_ptr<Batch>> ready;    // reorder window
  int next_unit = 0;            // next work unit a worker takes
  int next_emit = 0;            // next batch index the consumer needs
  bool stopping = false;

  size_t slot_bytes() const { return static_cast<size_t>(out_h) * out_w * 3; }

  void fill_slot(const std::string &path, uint8_t *dst, uint8_t *ok) {
    *ok = 0;
    memset(dst, 0, slot_bytes());
    FILE *f = fopen(path.c_str(), "rb");
    if (!f) return;
    fseek(f, 0, SEEK_END);
    const long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (sz <= 0) { fclose(f); return; }
    std::vector<uint8_t> raw(static_cast<size_t>(sz));
    const size_t got = fread(raw.data(), 1, raw.size(), f);
    fclose(f);
    if (got != raw.size()) return;
    uint8_t *img = nullptr;
    int h, w, c;
    const int rc = mmltpu_decode_image(raw.data(), raw.size(), &img, &h, &w,
                                       &c);
    if (rc != 0) {
      if (rc == MMLTPU_NOT_BUILT) *ok = 2;
      return;
    }
    if (h == out_h && w == out_w)
      memcpy(dst, img, slot_bytes());
    else
      mmltpu_resize_bilinear(img, h, w, 3, dst, out_h, out_w);
    mmltpu_free(img);
    *ok = 1;
  }

  void work() {
    for (;;) {
      int bi, lo, hi;
      Batch *b;
      {
        std::unique_lock<std::mutex> lk(mu);
        // bound in-flight batches so memory stays O(prefetch window)
        cv_space.wait(lk, [&] {
          return stopping ||
                 (next_unit < n_batches * units_per_batch &&
                  next_unit / units_per_batch - next_emit < max_prefetch);
        });
        if (stopping || next_unit >= n_batches * units_per_batch) return;
        const int unit = next_unit++;
        bi = unit / units_per_batch;
        auto &slot = filling[bi];
        if (!slot) {  // the batch's first unit to be claimed creates it
          slot.reset(new Batch());
          slot->bytes = static_cast<size_t>(batch) * slot_bytes();
          slot->data.reset(new uint8_t[slot->bytes]);
          slot->ok.assign(batch, 0);
          slot->count = std::min<int>(batch, static_cast<int>(paths.size()) -
                                                 bi * batch);
          slot->units_left = units_per_batch;
        }
        b = slot.get();
        lo = (unit % units_per_batch) * kChunk;
        hi = std::min(lo + kChunk, batch);
      }
      // this unit's slots: disjoint from every other unit's, so no lock
      for (int i = lo; i < hi; ++i) {
        uint8_t *dst = b->data.get() + static_cast<size_t>(i) * slot_bytes();
        if (i < b->count)
          fill_slot(paths[static_cast<size_t>(bi) * batch + i], dst,
                    &b->ok[i]);
        else
          memset(dst, 0, slot_bytes());
      }
      bool done = false;
      {
        std::lock_guard<std::mutex> lk(mu);
        if (stopping) return;
        if (--b->units_left == 0) {
          ready[bi] = std::move(filling[bi]);
          filling.erase(bi);
          done = true;
        }
      }
      if (done) cv_produced.notify_all();
    }
  }
};

}  // namespace

extern "C" void *mmltpu_loader_create(const char *const *paths, int n_paths,
                                      int batch, int out_h, int out_w,
                                      int n_threads, int max_prefetch) {
  if (n_paths < 0 || batch <= 0 || out_h <= 0 || out_w <= 0) return nullptr;
  Loader *ld = new Loader();
  ld->paths.reserve(n_paths);
  for (int i = 0; i < n_paths; ++i) ld->paths.emplace_back(paths[i]);
  ld->batch = batch;
  ld->out_h = out_h;
  ld->out_w = out_w;
  ld->n_batches = (n_paths + batch - 1) / batch;
  ld->units_per_batch = (batch + kChunk - 1) / kChunk;
  ld->max_prefetch = std::max(1, max_prefetch);
  const int nt = std::max(1, n_threads);
  for (int i = 0; i < nt; ++i)
    ld->workers.emplace_back([ld] { ld->work(); });
  return ld;
}

extern "C" int mmltpu_loader_next(void *handle, uint8_t *out, uint8_t *ok,
                                  int *out_count) {
  Loader *ld = static_cast<Loader *>(handle);
  std::unique_ptr<Batch> b;
  {
    std::unique_lock<std::mutex> lk(ld->mu);
    if (ld->next_emit >= ld->n_batches) return 0;
    ld->cv_produced.wait(lk, [&] {
      return ld->ready.count(ld->next_emit) > 0;
    });
    auto it = ld->ready.find(ld->next_emit);
    b = std::move(it->second);
    ld->ready.erase(it);
    ld->next_emit++;
  }
  ld->cv_space.notify_all();  // window advanced: workers may claim again
  memcpy(out, b->data.get(), b->bytes);
  memcpy(ok, b->ok.data(), b->ok.size());
  *out_count = b->count;
  return 1;
}

extern "C" void mmltpu_loader_destroy(void *handle) {
  Loader *ld = static_cast<Loader *>(handle);
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    ld->stopping = true;
  }
  ld->cv_space.notify_all();
  ld->cv_produced.notify_all();
  for (auto &t : ld->workers) t.join();
  delete ld;
}
