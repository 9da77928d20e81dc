// mmltpu: the host-side native runtime of the PyTorch port (the port's own
// copy of mmlspark_tpu/native/csrc, the same C ABI).
//
// The reference ships all native code as prebuilt JNI/SWIG jars (OpenCV
// imdecode at io/image/src/main/scala/Image.scala:58-75, LightGBM SWIG,
// CNTK JNI — SURVEY.md L1). This library is the in-repo equivalent for the
// host-side runtime: image decode, resize, a threaded prefetching batch
// loader that fills contiguous staging buffers (pinned host memory, copied
// to the card without blocking), a parallel CSV->float32 parser for GBDT
// ingest, the Arrow columns->rows interleave and GBDT binning.
//
// Plain C ABI so Python binds via ctypes; mmlspark_tpu_torch/native builds
// it with g++.

#ifndef MMLTPU_H
#define MMLTPU_H

#include <cstddef>
#include <cstdint>

extern "C" {

// ---- memory ----
void mmltpu_free(void *p);

// ---- decode ----
// Decode an encoded image (JPEG/PNG/BMP/PPM, sniffed by magic bytes) into a
// malloc'd HWC uint8 buffer in BGR channel order (the reference's OpenCV
// contract, Image.scala:58-75). Returns 0 on success (*out must be released
// with mmltpu_free), MMLTPU_UNDECODABLE for bytes it cannot decode, and
// MMLTPU_NOT_BUILT for a JPEG or PNG when this build has no decoder for it
// (BMP and PPM are decoded by hand and always built).
#define MMLTPU_UNDECODABLE (-1)
#define MMLTPU_NOT_BUILT (-2)
int mmltpu_decode_image(const uint8_t *data, size_t len,
                        uint8_t **out, int *h, int *w, int *c);

// The formats this build decodes, a bitmask of MMLTPU_FORMAT_*.
#define MMLTPU_FORMAT_JPEG 1
#define MMLTPU_FORMAT_PNG 2
#define MMLTPU_FORMAT_BMP 4
#define MMLTPU_FORMAT_PPM 8
int mmltpu_formats(void);

// ---- resize ----
// Bilinear resize of an HWC uint8 image (any channel count) into a caller
// buffer of out_h*out_w*c bytes.
void mmltpu_resize_bilinear(const uint8_t *src, int h, int w, int c,
                            uint8_t *dst, int out_h, int out_w);

// ---- prefetching batch loader ----
// Reads files from disk, decodes, resizes to (out_h, out_w), and packs
// fixed-shape batches [batch, out_h, out_w, 3] uint8 BGR into an internal
// bounded queue from worker threads. The consumer copies each batch into a
// caller staging buffer (replaces the element-wise JNI copies at
// CNTKModel.scala:67-74).
void *mmltpu_loader_create(const char *const *paths, int n_paths,
                           int batch, int out_h, int out_w,
                           int n_threads, int max_prefetch);
// Copies the next batch into out (batch*out_h*out_w*3 bytes) and ok
// (batch bytes; 1 = decoded, 0 = failed/padding, 2 = a format this build
// does not decode; slots not decoded are zero-filled). *out_count = rows valid in this batch (< batch only on the
// final partial batch). Returns 1 if a batch was produced, 0 at end.
int mmltpu_loader_next(void *handle, uint8_t *out, uint8_t *ok,
                       int *out_count);
void mmltpu_loader_destroy(void *handle);

// ---- CSV ----
// Parse a delimited numeric file into a malloc'd row-major float32 matrix.
// Column count is fixed by the first (non-header) row; short/bad fields
// parse as NaN. Returns 0 on success; *out released with mmltpu_free.
int mmltpu_csv_parse(const char *path, int skip_header, char delim,
                     int n_threads, float **out, int64_t *out_rows,
                     int64_t *out_cols);

// ---- GBDT binning ----
// Quantile-bin an (n, d) row-major float32 matrix into uint8 bin ids in a
// caller buffer of n*d bytes: out[i,j] = count of edges[j,:] strictly less
// than x[i,j] (numpy searchsorted side='left'); NaN -> 0; columns flagged
// in cat_mask (d bytes, may be NULL) bin by identity clipped to
// [0, max_bin-1]. edges is (d, n_edges) ascending per row. Threads split
// rows; n_threads <= 0 means hardware concurrency.
void mmltpu_bin_data(const float *x, int64_t n, int d, const float *edges,
                     int n_edges, const uint8_t *cat_mask, int max_bin,
                     uint8_t *out, int n_threads);

}  // extern "C"

#endif  // MMLTPU_H
