// fast_loader: native host-side image pipeline for fdtpu_torch (a copy of
// the JAX package's loader, built and loaded by the port on its own).
//
// The reference's data path runs Albumentations/OpenCV inside torch
// DataLoader worker processes (datasets/WIDERFace/datamodule.py:169-176) —
// i.e. its "native data loader" is borrowed from its dependencies. The
// port's equivalent is this translation unit: JPEG decode
// via libjpeg-turbo with DCT scaling (the decoder downscales by 1/2,
// 1/4, 1/8 *inside* the inverse DCT, so a 1024px source headed for a 320px
// model decodes ~4-8x faster than full decode) followed by a fixed-point
// bilinear resize to the model input size, with a std::thread batch path for
// multi-core hosts. Exposed as a C ABI consumed through ctypes
// (fdtpu_torch/native/loader.py), with no pybind11.
//
// Build: g++ -O3 -march=native -shared -fPIC fast_loader.cpp -ljpeg
//        -o libfastloader.so   (see fdtpu_torch/native/loader.py:build())

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Bilinear uint8 RGB resize, 16.16 fixed point, edge-clamped — same
// semantics as PIL's BILINEAR for the downscale-free case we hit after DCT
// scaling (the decoder already brought us within 2x of the target).
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
    return;
  }
  const int64_t x_ratio = dw > 1 ? ((int64_t)(sw - 1) << 16) / (dw - 1) : 0;
  const int64_t y_ratio = dh > 1 ? ((int64_t)(sh - 1) << 16) / (dh - 1) : 0;
  for (int y = 0; y < dh; ++y) {
    const int64_t sy = y * y_ratio;
    const int y0 = static_cast<int>(sy >> 16);
    const int y1 = y0 + 1 < sh ? y0 + 1 : y0;
    const int fy = static_cast<int>(sy & 0xffff);
    const uint8_t* row0 = src + static_cast<size_t>(y0) * sw * 3;
    const uint8_t* row1 = src + static_cast<size_t>(y1) * sw * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const int64_t sx = x * x_ratio;
      const int x0 = static_cast<int>(sx >> 16);
      const int x1 = x0 + 1 < sw ? x0 + 1 : x0;
      const int fx = static_cast<int>(sx & 0xffff);
      for (int c = 0; c < 3; ++c) {
        const int p00 = row0[x0 * 3 + c], p01 = row0[x1 * 3 + c];
        const int p10 = row1[x0 * 3 + c], p11 = row1[x1 * 3 + c];
        const int top = p00 + (((p01 - p00) * fx) >> 16);
        const int bot = p10 + (((p11 - p10) * fx) >> 16);
        out[x * 3 + c] = static_cast<uint8_t>(top + (((bot - top) * fy) >> 16));
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode a JPEG from memory and resize to (out_h, out_w) RGB.
// Writes original dimensions to *src_w/*src_h (callers rescale boxes).
// Returns 0 on success, nonzero on decode error.
int fdtpu_decode_resize(const uint8_t* data, long size, int out_h, int out_w,
                        uint8_t* out, int* src_w, int* src_h) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);

  *src_w = static_cast<int>(cinfo.image_width);
  *src_h = static_cast<int>(cinfo.image_height);

  // DCT scaling: pick the largest denominator that keeps the decoded image
  // at least as large as the target on both axes.
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  for (int denom = 8; denom >= 2; denom /= 2) {
    if (static_cast<int>(cinfo.image_width) / denom >= out_w &&
        static_cast<int>(cinfo.image_height) / denom >= out_h) {
      cinfo.scale_denom = static_cast<unsigned>(denom);
      break;
    }
  }
  cinfo.out_color_space = JCS_RGB;  // grayscale/YCbCr sources -> RGB
  cinfo.dct_method = JDCT_IFAST;
  jpeg_start_decompress(&cinfo);

  const int dw = static_cast<int>(cinfo.output_width);
  const int dh = static_cast<int>(cinfo.output_height);
  std::vector<uint8_t> decoded(static_cast<size_t>(dw) * dh * 3);
  const int stride = dw * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowp = decoded.data() + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  resize_bilinear(decoded.data(), dh, dw, out, out_h, out_w);
  return 0;
}

// Batch variant: decode `n` JPEGs (concatenated in `data` with per-item
// offsets/sizes) into a contiguous (n, out_h, out_w, 3) buffer, threaded.
// Returns the number of failures (failed slots are zero-filled; their
// src dims are set to -1 so callers can substitute a neighbor, matching
// the reference's incorrect_indices fallback, dataset.py:148-150).
int fdtpu_decode_resize_batch(const uint8_t* data, const long* offsets,
                              const long* sizes, int n, int out_h, int out_w,
                              uint8_t* out, int* src_dims, int num_threads) {
  const size_t item = static_cast<size_t>(out_h) * out_w * 3;
  std::vector<int> failures(n, 0);
  if (num_threads <= 0) {
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 1;
  }
  auto worker = [&](int start, int step) {
    for (int i = start; i < n; i += step) {
      int rc = fdtpu_decode_resize(data + offsets[i], sizes[i], out_h, out_w,
                                   out + item * i, &src_dims[2 * i],
                                   &src_dims[2 * i + 1]);
      if (rc != 0) {
        std::memset(out + item * i, 0, item);
        src_dims[2 * i] = src_dims[2 * i + 1] = -1;
        failures[i] = 1;
      }
    }
  };
  if (num_threads == 1 || n == 1) {
    worker(0, 1);
  } else {
    std::vector<std::thread> threads;
    const int t = num_threads < n ? num_threads : n;
    threads.reserve(t);
    for (int i = 0; i < t; ++i) threads.emplace_back(worker, i, t);
    for (auto& th : threads) th.join();
  }
  int total = 0;
  for (int f : failures) total += f;
  return total;
}

}  // extern "C"
