// Native JPEG decode for the image input pipeline: one image to its full
// size (the last link of mx.image's codec chain, image/__init__.py
// `decode_to_numpy`), and a batch decoded with a bilinear resize on a
// thread pool (`imdecode_resize_batch`).
//
// The port's copy of incubator_mxnet_tpu/src/io/image_decode_native.cc
// (MXNet's decode threads of src/io/iter_image_recordio_2.cc), with the
// decode-only entry point `mxtpu_img_decode` added. A plain C interface,
// loaded through ctypes (io/_native_image.py builds it with g++ -ljpeg on
// first use; without libjpeg's headers it does not build and the chain
// keeps its other links).

#include <cstddef>
#include <cstdio>  // jpeglib.h needs size_t/FILE declared first

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit_throw(j_common_ptr cinfo) {
  ErrMgr* mgr = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(mgr->jump, 1);  // libjpeg's default handler would exit()
}

// Decode one JPEG into an RGB buffer it allocates; returns true on
// success with (*w, *h) set.
bool DecodeOne(const uint8_t* buf, int64_t len, std::vector<uint8_t>* rgb,
               int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_throw;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  const int stride = *w * 3;
  rgb->resize(static_cast<size_t>(stride) * *h);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() +
                   static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Bilinear resize RGB uint8 (src_h, src_w) -> (dst_h, dst_w) into dst.
void ResizeBilinear(const uint8_t* src, int src_h, int src_w, uint8_t* dst,
                    int dst_h, int dst_w) {
  if (src_h == dst_h && src_w == dst_w) {
    std::memcpy(dst, src, static_cast<size_t>(src_h) * src_w * 3);
    return;
  }
  const float sy = static_cast<float>(src_h) / dst_h;
  const float sx = static_cast<float>(src_w) / dst_w;
  for (int y = 0; y < dst_h; ++y) {
    // pixel-center sampling (the cv2.resize INTER_LINEAR convention)
    float fy = (y + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(src_h - 1)));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, src_h - 1);
    const float wy = fy - y0;
    for (int x = 0; x < dst_w; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      fx = std::max(0.0f, std::min(fx, static_cast<float>(src_w - 1)));
      const int x0 = static_cast<int>(fx);
      const int x1 = std::min(x0 + 1, src_w - 1);
      const float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        const float v00 = src[(y0 * src_w + x0) * 3 + c];
        const float v01 = src[(y0 * src_w + x1) * 3 + c];
        const float v10 = src[(y1 * src_w + x0) * 3 + c];
        const float v11 = src[(y1 * src_w + x1) * 3 + c];
        const float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                        v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(y * dst_w + x) * 3 + c] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Dimensions of one JPEG without full decode. Returns 0 on success.
int mxtpu_img_dims(const uint8_t* buf, int64_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_throw;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode one JPEG at its full size into `out` (h * w * channels bytes,
// RGB, or one gray channel when `gray`); (*w, *h) receive its size.
// Returns 0 on success, -1 when it does not decode, -2 when the image
// needs more than `cap` bytes (nothing written).
int mxtpu_img_decode(const uint8_t* buf, int64_t len, int gray,
                     uint8_t* out, int64_t cap, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_throw;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  const int64_t stride =
      static_cast<int64_t>(*w) * cinfo.output_components;
  if (stride * *h > cap) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<int64_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode n JPEGs (blob + per-item offsets/lengths) to (n, out_h, out_w, 3)
// uint8 RGB with bilinear resize, on `n_threads` workers. Returns 0 on
// success, -(i+1) when item i failed to decode.
int mxtpu_img_decode_batch(const uint8_t* blob, const int64_t* offsets,
                           const int64_t* lengths, int64_t n, int out_h,
                           int out_w, uint8_t* out, int n_threads) {
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);
  const size_t item = static_cast<size_t>(out_h) * out_w * 3;
  auto worker = [&]() {
    std::vector<uint8_t> rgb;
    int w = 0, h = 0;
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n || err.load() != 0) return;
      if (!DecodeOne(blob + offsets[i], lengths[i], &rgb, &w, &h)) {
        int expected = 0;
        err.compare_exchange_strong(expected, static_cast<int>(-(i + 1)));
        return;
      }
      ResizeBilinear(rgb.data(), h, w, out + item * i, out_h, out_w);
    }
  };
  const int nt = std::max(1, std::min<int>(n_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return err.load();
}

}  // extern "C"
