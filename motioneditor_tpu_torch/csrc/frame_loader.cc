// Host frame loader: libpng / libjpeg decode + resize straight into
// caller-owned float32 buffers (a copy of the JAX package's
// native/frame_loader.cc, kept in this package so the port builds its own).
//
// One C call decodes a PNG (or a JPEG, sniffed by its magic bytes) and
// resizes it into the NHWC float layout the dataset returns: RGB bilinear
// with align_corners=false and no antialias, as the reference's
// F.interpolate, in [0, 255]; gray nearest (masks) in {0, 255}.
//
// Exposed via ctypes (motioneditor_tpu_torch/data/native_loader.py), which
// compiles it with the host C++ compiler at first use into build/host/.

#include <png.h>

#include <csetjmp>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {
#include <jpeglib.h>
}

namespace {

struct Image {
  int h = 0;
  int w = 0;
  int channels = 0;  // always expanded to 3 (RGB) or 1 (gray) below
  std::vector<uint8_t> data;
};

// Decode a PNG into 8-bit RGB (gray=false) or 8-bit gray (gray=true).
bool decode_png(const char* path, bool gray, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(fp);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  // drop alpha
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (gray) {
    if (!(color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA))
      png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  } else {
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
      png_set_gray_to_rgb(png);
  }
  png_read_update_info(png, info);

  const int ch = gray ? 1 : 3;
  out->h = static_cast<int>(h);
  out->w = static_cast<int>(w);
  out->channels = ch;
  out->data.resize(static_cast<size_t>(h) * w * ch);
  std::vector<png_bytep> rows(h);
  const size_t stride = png_get_rowbytes(png, info);
  std::vector<uint8_t> rowbuf(stride * h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = rowbuf.data() + y * stride;
  png_read_image(png, rows.data());
  for (png_uint_32 y = 0; y < h; ++y)
    std::memcpy(out->data.data() + static_cast<size_t>(y) * w * ch, rows[y],
                static_cast<size_t>(w) * ch);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

// Bilinear resize (align_corners=false convention, matching PIL/torch).
void resize_bilinear(const Image& src, int oh, int ow, float* dst) {
  const int ch = src.channels;
  const float sy = static_cast<float>(src.h) / oh;
  const float sx = static_cast<float>(src.w) / ow;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = y0 + 1;
    y0 = y0 < 0 ? 0 : (y0 >= src.h ? src.h - 1 : y0);
    y1 = y1 < 0 ? 0 : (y1 >= src.h ? src.h - 1 : y1);
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = x0 + 1;
      x0 = x0 < 0 ? 0 : (x0 >= src.w ? src.w - 1 : x0);
      x1 = x1 < 0 ? 0 : (x1 >= src.w ? src.w - 1 : x1);
      for (int c = 0; c < ch; ++c) {
        float v00 = src.data[(static_cast<size_t>(y0) * src.w + x0) * ch + c];
        float v01 = src.data[(static_cast<size_t>(y0) * src.w + x1) * ch + c];
        float v10 = src.data[(static_cast<size_t>(y1) * src.w + x0) * ch + c];
        float v11 = src.data[(static_cast<size_t>(y1) * src.w + x1) * ch + c];
        float top = v00 + (v01 - v00) * wx;
        float bot = v10 + (v11 - v10) * wx;
        dst[(static_cast<size_t>(y) * ow + x) * ch + c] = top + (bot - top) * wy;
      }
    }
  }
}

// Nearest resize with floor-index selection (torch F.interpolate "nearest").
void resize_nearest(const Image& src, int oh, int ow, float* dst) {
  const int ch = src.channels;
  for (int y = 0; y < oh; ++y) {
    int sy = static_cast<int>(static_cast<int64_t>(y) * src.h / oh);
    for (int x = 0; x < ow; ++x) {
      int sx = static_cast<int>(static_cast<int64_t>(x) * src.w / ow);
      for (int c = 0; c < ch; ++c)
        dst[(static_cast<size_t>(y) * ow + x) * ch + c] =
            src.data[(static_cast<size_t>(sy) * src.w + sx) * ch + c];
    }
  }
}

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  std::longjmp(err->jump, 1);
}

// Decode a JPEG into 8-bit RGB or gray.
bool decode_jpeg(const char* path, bool gray, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const int ch = cinfo.output_components;
  out->h = h;
  out->w = w;
  out->channels = ch;
  out->data.resize(static_cast<size_t>(h) * w * ch);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row =
        out->data.data() + static_cast<size_t>(cinfo.output_scanline) * w * ch;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  return true;
}

// Sniff the container by magic bytes (the reference dataset ships JPEG
// frames with .png extensions).
bool decode_image(const char* path, bool gray, Image* out) {
  uint8_t magic[4] = {0};
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  size_t got = std::fread(magic, 1, 4, fp);
  std::fclose(fp);
  if (got < 4) return false;
  if (magic[0] == 0x89 && magic[1] == 'P') return decode_png(path, gray, out);
  if (magic[0] == 0xFF && magic[1] == 0xD8) return decode_jpeg(path, gray, out);
  return false;
}

}  // namespace

extern "C" {

// mode 0: RGB bilinear, raw [0,255]
// mode 1: gray nearest, raw [0,255]  (masks)
// out must hold oh*ow*(mode==1 ? 1 : 3) floats. Returns 0 on success.
int me_load_frame(const char* path, int oh, int ow, int mode, float* out) {
  Image img;
  const bool gray = (mode == 1);
  if (!decode_image(path, gray, &img)) return 1;
  if (mode == 1) {
    resize_nearest(img, oh, ow, out);
  } else {
    resize_bilinear(img, oh, ow, out);
  }
  return 0;
}

// Batch: n paths (NUL-separated in `paths`, total length `paths_len`) into a
// contiguous [n, oh, ow, c] buffer. Returns number of successfully decoded
// frames.
int me_load_frames(const char* paths, int paths_len, int n, int oh, int ow,
                   int mode, float* out) {
  const int ch = (mode == 1) ? 1 : 3;
  const size_t frame = static_cast<size_t>(oh) * ow * ch;
  const char* p = paths;
  const char* end = paths + paths_len;
  int ok = 0;
  for (int i = 0; i < n && p < end; ++i) {
    if (me_load_frame(p, oh, ow, mode, out + frame * i) == 0) ++ok;
    p += std::strlen(p) + 1;
  }
  return ok;
}

}  // extern "C"
