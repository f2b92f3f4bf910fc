// Native JPEG decode (libjpeg) for the host ingest path (the port's copy of
// radvlm_tpu/native/jpeg.cc, declared against jpeg62.h instead of the host's
// jpeglib.h).
//
// The reference's loader throughput comes from torch DataLoader C++ workers +
// PIL's C decoders; here the decode itself is a ctypes-callable C++ routine so
// the prefetch pool's worker threads decode outside the GIL with no PIL object
// churn. Grayscale sources (most CXR JPEGs) are expanded to RGB in-loop.
//
// Built by radvlm_tpu_torch/native/__init__.py: c++ -O3 -shared -fPIC jpeg.cc
// against the libjpeg that PIL loads (or the host's libjpeg.so.62).

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include "jpeg62.h"

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

}  // namespace

extern "C" {

// Reads the header only. Returns 0 on success, writing (h, w).
int jpeg_info(const uint8_t* data, int len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decodes into caller-allocated out [h * w * 3] RGB. Returns 0 on success.
int jpeg_decode_rgb(const uint8_t* data, int len, uint8_t* out, int out_cap) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  const bool gray = cinfo.jpeg_color_space == JCS_GRAYSCALE;
  cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int w = static_cast<int>(cinfo.output_width);
  const int h = static_cast<int>(cinfo.output_height);
  const int comps = static_cast<int>(cinfo.output_components);
  if (static_cast<long>(h) * w * 3 > out_cap) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  std::vector<uint8_t> row(static_cast<size_t>(w) * comps);
  uint8_t* rowp = row.data();
  while (cinfo.output_scanline < cinfo.output_height) {
    const int y = static_cast<int>(cinfo.output_scanline);
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    uint8_t* dst = out + static_cast<size_t>(y) * w * 3;
    if (comps == 1) {
      for (int x = 0; x < w; ++x) {
        dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = rowp[x];
      }
    } else {
      std::memcpy(dst, rowp, static_cast<size_t>(w) * 3);
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
