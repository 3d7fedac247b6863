// The port's image-ingest fast path (its own copy of the JAX package's
// image_decode.cc, the arithmetic unchanged): JPEG/PNG file -> 64x64x3
// uint8, the CelebA preprocessing contract (Resize(shorter side -> 64) +
// CenterCrop(64), the reference's celeba/train.py:146-148; the reference
// decodes each JPEG through PIL in its Python loader,
// celeba/datasets.py:69-78). Built with g++ at first use by
// mvae_tpu_torch/data/native.py as the `decode` library.
//
// Uses the system libjpeg (with DCT-domain prescaling: the decoder itself
// downscales by N/8 before IDCT, so a 178x218 CelebA crop decodes at
// roughly 1/4 of full-resolution cost) and libpng, then a separable
// bilinear resample to the exact 64-crop. C ABI for ctypes.

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

constexpr int kOut = 64;

// bilinear resize (align_corners=false) HWC uint8 -> HWC uint8
void resize_rgb(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                int dw) {
  for (int y = 0; y < dh; y++) {
    double sy = (y + 0.5) * sh / dh - 0.5;
    int y0 = std::clamp((int)std::floor(sy), 0, sh - 1);
    int y1 = std::min(y0 + 1, sh - 1);
    double wy = std::clamp(sy - y0, 0.0, 1.0);
    for (int x = 0; x < dw; x++) {
      double sx = (x + 0.5) * sw / dw - 0.5;
      int x0 = std::clamp((int)std::floor(sx), 0, sw - 1);
      int x1 = std::min(x0 + 1, sw - 1);
      double wx = std::clamp(sx - x0, 0.0, 1.0);
      for (int c = 0; c < 3; c++) {
        double a = src[(y0 * sw + x0) * 3 + c];
        double b = src[(y0 * sw + x1) * 3 + c];
        double d = src[(y1 * sw + x0) * 3 + c];
        double e = src[(y1 * sw + x1) * 3 + c];
        double v = a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx +
                   d * wy * (1 - wx) + e * wy * wx;
        dst[(y * dw + x) * 3 + c] = (uint8_t)std::clamp(v + 0.5, 0.0, 255.0);
      }
    }
  }
}

// 2x2 area-average halving: the antialias prefilter for large downscales
// (PIL's BILINEAR resize is antialiased; plain 4-tap bilinear is not).
void box_halve(std::vector<uint8_t>& img, int& h, int& w) {
  int nh = h / 2, nw = w / 2;
  for (int y = 0; y < nh; y++) {
    for (int x = 0; x < nw; x++) {
      for (int c = 0; c < 3; c++) {
        int s = img[((2 * y) * w + 2 * x) * 3 + c]
              + img[((2 * y) * w + 2 * x + 1) * 3 + c]
              + img[((2 * y + 1) * w + 2 * x) * 3 + c]
              + img[((2 * y + 1) * w + 2 * x + 1) * 3 + c];
        img[(y * nw + x) * 3 + c] = (uint8_t)((s + 2) / 4);
      }
    }
  }
  h = nh;
  w = nw;
  img.resize((size_t)h * w * 3);
}

// Resize shorter side to 64, center-crop 64x64 (torchvision semantics:
// Resize(64) scales so min(h,w) == 64 keeping aspect, CenterCrop slices
// the middle).
void resize_center_crop(std::vector<uint8_t> img, int sh, int sw,
                        uint8_t* out) {
  while (std::min(sh, sw) >= 2 * kOut) box_halve(img, sh, sw);
  const uint8_t* src = img.data();
  double scale = (double)kOut / std::min(sh, sw);
  int rh = std::max(kOut, (int)std::lround(sh * scale));
  int rw = std::max(kOut, (int)std::lround(sw * scale));
  std::vector<uint8_t> tmp((size_t)rh * rw * 3);
  resize_rgb(src, sh, sw, tmp.data(), rh, rw);
  int top = (rh - kOut) / 2, left = (rw - kOut) / 2;
  for (int y = 0; y < kOut; y++) {
    std::memcpy(out + (size_t)y * kOut * 3,
                tmp.data() + ((size_t)(top + y) * rw + left) * 3, kOut * 3);
  }
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = (JpegErr*)cinfo->err;
  longjmp(err->jb, 1);
}

}  // namespace

extern "C" {

// Decode a JPEG file to 64x64x3 uint8 (resize+center-crop). Returns 0 on
// success, nonzero on error.
int decode_jpeg_64(const char* path, uint8_t* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  std::vector<uint8_t> img;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain prescale: largest N/8 (N in 1..8) with min side still >= 64
  int minside = std::min(cinfo.image_width, cinfo.image_height);
  int num = 8;
  while (num > 1 && (long)minside * (num - 1) / 8 >= kOut) num--;
  cinfo.scale_num = num;
  cinfo.scale_denom = 8;
  jpeg_start_decompress(&cinfo);
  int w = cinfo.output_width, h = cinfo.output_height;
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 3;
  }
  img.resize((size_t)w * h * 3);
  while ((int)cinfo.output_scanline < h) {
    uint8_t* rowp = img.data() + (size_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  resize_center_crop(std::move(img), h, w, out);
  return 0;
}

// Decode a PNG file to 64x64x3 uint8 (resize+center-crop). Returns 0 on
// success, nonzero on error.
int decode_png_64(const char* path, uint8_t* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    std::fclose(f);
    return 2;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  // normalize any input layout to 8-bit RGB
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  std::vector<uint8_t> img((size_t)w * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; y++) rows[y] = img.data() + (size_t)y * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(f);
  resize_center_crop(std::move(img), (int)h, (int)w, out);
  return 0;
}

}  // extern "C"
