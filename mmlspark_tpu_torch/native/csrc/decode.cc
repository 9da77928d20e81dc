// Image decode: JPEG via libjpeg, PNG via libpng simplified API, each only
// where its header is found (MMLTPU_NO_JPEG / MMLTPU_NO_PNG leave one out),
// BMP and PPM(P6) by hand, always. Output is HWC uint8, BGR channel order —
// the layout the reference gets from OpenCV Imgcodecs.imdecode
// (Image.scala:58-75), so the Python ImageSchema path is byte-compatible
// with cv2.

#include "mmltpu.h"

#include <cctype>
#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#if !defined(MMLTPU_NO_JPEG) && __has_include(<jpeglib.h>)
#define MMLTPU_HAVE_JPEG 1
#include <jpeglib.h>
#endif
#if !defined(MMLTPU_NO_PNG) && __has_include(<png.h>)
#define MMLTPU_HAVE_PNG 1
#include <png.h>
#endif

extern "C" void mmltpu_free(void *p) { free(p); }

namespace {

#ifdef MMLTPU_HAVE_JPEG

// ---- JPEG ----

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr *err = reinterpret_cast<JpegErr *>(cinfo->err);
  longjmp(err->jump, 1);
}

int decode_jpeg(const uint8_t *data, size_t len,
                uint8_t **out, int *h, int *w, int *c) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  // volatile: both are written after setjmp and read after the longjmp
  uint8_t *volatile buf = nullptr;
  uint8_t *volatile row = nullptr;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    free(buf);
    free(row);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char *>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;  // grayscale is upconverted for us
  jpeg_start_decompress(&cinfo);
  const int W = cinfo.output_width, H = cinfo.output_height;
  const int C = cinfo.output_components;  // 3 after JCS_RGB
  if (C != 3) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  buf = static_cast<uint8_t *>(malloc(static_cast<size_t>(H) * W * 3));
  row = static_cast<uint8_t *>(malloc(static_cast<size_t>(W) * 3));
  if (!buf || !row) {
    jpeg_destroy_decompress(&cinfo);
    free(buf);
    free(row);
    return -1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t *dst = buf + static_cast<size_t>(cinfo.output_scanline) * W * 3;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
    for (int x = 0; x < W; ++x) {  // RGB -> BGR
      dst[x * 3 + 0] = row[x * 3 + 2];
      dst[x * 3 + 1] = row[x * 3 + 1];
      dst[x * 3 + 2] = row[x * 3 + 0];
    }
  }
  free(row);
  row = nullptr;
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out = buf; *h = H; *w = W; *c = 3;
  return 0;
}

#endif  // MMLTPU_HAVE_JPEG

#ifdef MMLTPU_HAVE_PNG
// ---- PNG (simplified libpng 1.6 API) ----

int decode_png(const uint8_t *data, size_t len,
               uint8_t **out, int *h, int *w, int *c) {
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, data, len)) return -1;
  image.format = PNG_FORMAT_BGR;  // alpha composited onto black? no: dropped
  const size_t stride = PNG_IMAGE_ROW_STRIDE(image);
  const size_t size = PNG_IMAGE_BUFFER_SIZE(image, stride);
  uint8_t *buf = static_cast<uint8_t *>(malloc(size));
  if (!buf) {
    png_image_free(&image);
    return -1;
  }
  if (!png_image_finish_read(&image, nullptr, buf,
                             static_cast<png_int_32>(stride), nullptr)) {
    png_image_free(&image);
    free(buf);
    return -1;
  }
  *out = buf; *h = image.height; *w = image.width; *c = 3;
  return 0;
}

#endif  // MMLTPU_HAVE_PNG

// ---- BMP (uncompressed 24/32-bit BITMAPINFOHEADER) ----

uint32_t rd32(const uint8_t *p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
uint16_t rd16(const uint8_t *p) { return p[0] | (p[1] << 8); }

int decode_bmp(const uint8_t *data, size_t len,
               uint8_t **out, int *h, int *w, int *c) {
  if (len < 54) return -1;
  const uint32_t off = rd32(data + 10);
  const uint32_t hdr = rd32(data + 14);
  if (hdr < 40) return -1;
  const int32_t W = static_cast<int32_t>(rd32(data + 18));
  int32_t H = static_cast<int32_t>(rd32(data + 22));
  const uint16_t bpp = rd16(data + 28);
  const uint32_t comp = rd32(data + 30);
  if (W <= 0 || H == 0 || comp != 0 || (bpp != 24 && bpp != 32)) return -1;
  const bool flip = H > 0;  // positive height = bottom-up rows
  if (H < 0) H = -H;
  const size_t bytespp = bpp / 8;
  const size_t row_sz = (static_cast<size_t>(W) * bytespp + 3) & ~size_t(3);
  if (off + row_sz * H > len) return -1;
  uint8_t *buf = static_cast<uint8_t *>(malloc(static_cast<size_t>(H) * W * 3));
  if (!buf) return -1;
  for (int y = 0; y < H; ++y) {
    const uint8_t *src = data + off + row_sz * (flip ? (H - 1 - y) : y);
    uint8_t *dst = buf + static_cast<size_t>(y) * W * 3;
    for (int x = 0; x < W; ++x) {  // BMP pixels are already BGR(A)
      dst[x * 3 + 0] = src[x * bytespp + 0];
      dst[x * 3 + 1] = src[x * bytespp + 1];
      dst[x * 3 + 2] = src[x * bytespp + 2];
    }
  }
  *out = buf; *h = H; *w = W; *c = 3;
  return 0;
}

// ---- PPM P6 (maxval <= 255) ----

int decode_ppm(const uint8_t *data, size_t len,
               uint8_t **out, int *h, int *w, int *c) {
  size_t pos = 2;  // past "P6"
  long vals[3];
  for (int i = 0; i < 3; ++i) {
    while (pos < len &&
           (isspace(data[pos]) || data[pos] == '#')) {
      if (data[pos] == '#')
        while (pos < len && data[pos] != '\n') ++pos;
      else
        ++pos;
    }
    long v = 0;
    bool any = false;
    while (pos < len && data[pos] >= '0' && data[pos] <= '9') {
      v = v * 10 + (data[pos] - '0');
      ++pos;
      any = true;
    }
    if (!any) return -1;
    vals[i] = v;
  }
  if (pos >= len || !isspace(data[pos])) return -1;
  ++pos;  // single whitespace before raster
  const long W = vals[0], H = vals[1], maxv = vals[2];
  if (W <= 0 || H <= 0 || maxv <= 0 || maxv > 255) return -1;
  const size_t need = static_cast<size_t>(W) * H * 3;
  if (pos + need > len) return -1;
  uint8_t *buf = static_cast<uint8_t *>(malloc(need));
  if (!buf) return -1;
  const uint8_t *src = data + pos;
  for (size_t i = 0; i < static_cast<size_t>(W) * H; ++i) {  // RGB -> BGR
    buf[i * 3 + 0] = src[i * 3 + 2];
    buf[i * 3 + 1] = src[i * 3 + 1];
    buf[i * 3 + 2] = src[i * 3 + 0];
  }
  *out = buf; *h = static_cast<int>(H); *w = static_cast<int>(W); *c = 3;
  return 0;
}

}  // namespace

extern "C" int mmltpu_decode_image(const uint8_t *data, size_t len,
                                   uint8_t **out, int *h, int *w, int *c) {
  if (!data || len < 8) return MMLTPU_UNDECODABLE;
  if (data[0] == 0xFF && data[1] == 0xD8) {
#ifdef MMLTPU_HAVE_JPEG
    return decode_jpeg(data, len, out, h, w, c);
#else
    return MMLTPU_NOT_BUILT;
#endif
  }
  if (data[0] == 0x89 && data[1] == 'P' && data[2] == 'N' && data[3] == 'G') {
#ifdef MMLTPU_HAVE_PNG
    return decode_png(data, len, out, h, w, c);
#else
    return MMLTPU_NOT_BUILT;
#endif
  }
  if (data[0] == 'B' && data[1] == 'M') return decode_bmp(data, len, out, h, w, c);
  if (data[0] == 'P' && data[1] == '6') return decode_ppm(data, len, out, h, w, c);
  return MMLTPU_UNDECODABLE;
}

extern "C" int mmltpu_formats(void) {
  int f = MMLTPU_FORMAT_BMP | MMLTPU_FORMAT_PPM;
#ifdef MMLTPU_HAVE_JPEG
  f |= MMLTPU_FORMAT_JPEG;
#endif
#ifdef MMLTPU_HAVE_PNG
  f |= MMLTPU_FORMAT_PNG;
#endif
  return f;
}
