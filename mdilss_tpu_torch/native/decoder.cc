// Native (C++) image decode + resize for the host input pipeline.
//
// The reference fed its GPUs from 4 forked PyTorch DataLoader workers doing
// PIL decode/resize per sample (train_RAPFT_step1.py:152-155). This module
// is the TPU build's native equivalent of that worker layer: fused
// decode+resize with no intermediate image objects, GIL released for the
// whole operation so the Python-side thread pool scales across cores.
//
// Semantics are pinned to PIL (the eval-parity requirement — see
// data/transforms.py):
//   * BILINEAR: Pillow's separable triangle-filter resample — filterscale =
//     max(in/out, 1), support = filterscale, span [int(center-support+.5),
//     int(center+support+.5)), normalized coefficients in 22-bit fixed point
//     (PRECISION_BITS = 32-8-2), horizontal pass then vertical pass with a
//     clipped uint8 intermediate. Verified bit-exact against Pillow in
//     tests/test_native_decoder.py.
//   * NEAREST (labels): src = floor((dst + 0.5) * in / out).
//   * Palette PNG labels decode to raw indices (PIL 'P' mode), never RGB.
//
// Python API (module mdilss_tpu.native._native_decoder):
//   decode_image(data: bytes, height: int, width: int) -> bytes  # RGB HxWx3
//   decode_label(data: bytes, height: int, width: int) -> bytes  # u8 HxW
//
// Built by native/__init__.py with the system libpng/libjpeg (no pybind11; the
// CPython C API keeps the toolchain dependency-free).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <jpeglib.h>
#include <png.h>

#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow's 8bpc fixed point

struct Decoded {
  std::vector<uint8_t> pixels;  // interleaved, `channels` per pixel
  int width = 0;
  int height = 0;
  int channels = 0;  // 3 = RGB image, 1 = label indices / gray
};

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

struct PngReadState {
  const uint8_t* data;
  size_t size;
  size_t offset;
};

void PngReadFn(png_structp png, png_bytep out, png_size_t count) {
  auto* st = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->offset + count > st->size) {
    png_error(png, "truncated PNG");
  }
  std::memcpy(out, st->data + st->offset, count);
  st->offset += count;
}

bool DecodePng(const uint8_t* data, size_t size, bool as_label, Decoded* out,
               std::string* err) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    *err = "png_create_read_struct failed";
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    *err = "png_create_info_struct failed";
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    *err = "libpng decode error";
    return false;
  }
  PngReadState st{data, size, 0};
  png_set_read_fn(png, &st, PngReadFn);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  if (depth == 16) {
    png_set_strip_16(png);
  }
  if (as_label) {
    // raw indices: palette stays unexpanded; sub-byte gray/palette unpacked
    if (color == PNG_COLOR_TYPE_PALETTE || color == PNG_COLOR_TYPE_GRAY) {
      if (depth < 8) {
        png_set_packing(png);
      }
    } else {
      png_destroy_read_struct(&png, &info, nullptr);
      *err = "label PNG is not palette/gray";
      return false;
    }
  } else {
    if (color == PNG_COLOR_TYPE_PALETTE) {
      png_set_palette_to_rgb(png);
    }
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA) {
      if (depth < 8) {
        png_set_expand_gray_1_2_4_to_8(png);
      }
      png_set_gray_to_rgb(png);
    }
    if (png_get_valid(png, info, PNG_INFO_tRNS)) {
      png_set_tRNS_to_alpha(png);
    }
    // PIL convert("RGB") drops alpha without blending
    png_set_strip_alpha(png);
  }
  png_read_update_info(png, info);

  int channels = png_get_channels(png, info);
  if ((as_label && channels != 1) || (!as_label && channels != 3)) {
    png_destroy_read_struct(&png, &info, nullptr);
    *err = "unexpected channel count " + std::to_string(channels);
    return false;
  }
  size_t rowbytes = png_get_rowbytes(png, info);
  out->pixels.resize(rowbytes * h);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 i = 0; i < h; ++i) {
    rows[i] = out->pixels.data() + i * rowbytes;
  }
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  out->width = static_cast<int>(w);
  out->height = static_cast<int>(h);
  out->channels = channels;
  return true;
}

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void JpegErrorExit(j_common_ptr cinfo) {
  auto* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool DecodeJpeg(const uint8_t* data, size_t size, Decoded* out,
                std::string* err) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = JpegErrorExit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    *err = "libjpeg decode error";
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->width = cinfo.output_width;
  out->height = cinfo.output_height;
  out->channels = 3;
  out->pixels.resize(static_cast<size_t>(out->width) * out->height * 3);
  size_t stride = static_cast<size_t>(out->width) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->pixels.data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------------
// Resize (Pillow-parity)
// ---------------------------------------------------------------------------

struct Coeffs {
  std::vector<int> bounds;  // per out-pixel: xmin
  std::vector<int> counts;  // per out-pixel: span length
  std::vector<int32_t> k;   // per out-pixel: ksize fixed-point coefficients
  int ksize = 0;
};

// Pillow's precompute_coeffs for the triangle (bilinear) filter.
Coeffs BilinearCoeffs(int in_size, int out_size) {
  Coeffs c;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.ksize = ksize;
  c.bounds.resize(out_size);
  c.counts.resize(out_size);
  c.k.assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> wd(ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    int count = xmax - xmin;
    double ww = 0.0;
    for (int x = 0; x < count; ++x) {
      double arg = (x + xmin - center + 0.5) / filterscale;
      double wv = arg < 0 ? 1.0 + arg : 1.0 - arg;  // triangle
      if (wv < 0) wv = 0;
      wd[x] = wv;
      ww += wv;
    }
    for (int x = 0; x < count; ++x) {
      double v = ww == 0.0 ? 0.0 : wd[x] / ww;
      // Pillow: int k = (int)(v * (1 << PRECISION_BITS) + (v < 0 ? -0.5 : 0.5))
      c.k[static_cast<size_t>(xx) * ksize + x] = static_cast<int32_t>(
          v * (1 << kPrecisionBits) + (v < 0 ? -0.5 : 0.5));
    }
    c.bounds[xx] = xmin;
    c.counts[xx] = count;
  }
  return c;
}

inline uint8_t Clip8(int64_t v) {
  v >>= kPrecisionBits;
  if (v < 0) return 0;
  if (v > 255) return 255;
  return static_cast<uint8_t>(v);
}

// Horizontal pass: [h, in_w, ch] -> [h, out_w, ch]
std::vector<uint8_t> ResampleH(const uint8_t* src, int h, int in_w, int ch,
                               int out_w, const Coeffs& c) {
  std::vector<uint8_t> dst(static_cast<size_t>(h) * out_w * ch);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * in_w * ch;
    uint8_t* orow = dst.data() + static_cast<size_t>(y) * out_w * ch;
    for (int xx = 0; xx < out_w; ++xx) {
      int xmin = c.bounds[xx];
      int count = c.counts[xx];
      const int32_t* k = &c.k[static_cast<size_t>(xx) * c.ksize];
      for (int b = 0; b < ch; ++b) {
        int64_t ss = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < count; ++x) {
          ss += static_cast<int64_t>(row[(xmin + x) * ch + b]) * k[x];
        }
        orow[xx * ch + b] = Clip8(ss);
      }
    }
  }
  return dst;
}

// Vertical pass: [in_h, w, ch] -> [out_h, w, ch]
std::vector<uint8_t> ResampleV(const uint8_t* src, int in_h, int w, int ch,
                               int out_h, const Coeffs& c) {
  std::vector<uint8_t> dst(static_cast<size_t>(out_h) * w * ch);
  size_t stride = static_cast<size_t>(w) * ch;
  for (int yy = 0; yy < out_h; ++yy) {
    int ymin = c.bounds[yy];
    int count = c.counts[yy];
    const int32_t* k = &c.k[static_cast<size_t>(yy) * c.ksize];
    uint8_t* orow = dst.data() + yy * stride;
    for (size_t i = 0; i < stride; ++i) {
      int64_t ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < count; ++y) {
        ss += static_cast<int64_t>(src[(ymin + y) * stride + i]) * k[y];
      }
      orow[i] = Clip8(ss);
    }
  }
  return dst;
}

std::vector<uint8_t> ResizeBilinear(const Decoded& img, int out_h, int out_w) {
  const uint8_t* cur = img.pixels.data();
  std::vector<uint8_t> tmp;
  int h = img.height;
  int w = img.width;
  if (w != out_w) {
    Coeffs ch = BilinearCoeffs(w, out_w);
    tmp = ResampleH(cur, h, w, img.channels, out_w, ch);
    cur = tmp.data();
    w = out_w;
  }
  if (h != out_h) {
    Coeffs cv = BilinearCoeffs(h, out_h);
    return ResampleV(cur, h, w, img.channels, out_h, cv);
  }
  if (!tmp.empty()) return tmp;
  return img.pixels;
}

std::vector<uint8_t> ResizeNearest(const Decoded& img, int out_h, int out_w) {
  std::vector<uint8_t> dst(static_cast<size_t>(out_h) * out_w * img.channels);
  int ch = img.channels;
  std::vector<int> xmap(out_w);
  for (int xx = 0; xx < out_w; ++xx) {
    int sx = static_cast<int>((xx + 0.5) * img.width / out_w);
    xmap[xx] = sx >= img.width ? img.width - 1 : sx;
  }
  for (int yy = 0; yy < out_h; ++yy) {
    int sy = static_cast<int>((yy + 0.5) * img.height / out_h);
    if (sy >= img.height) sy = img.height - 1;
    const uint8_t* row =
        img.pixels.data() + static_cast<size_t>(sy) * img.width * ch;
    uint8_t* orow = dst.data() + static_cast<size_t>(yy) * out_w * ch;
    for (int xx = 0; xx < out_w; ++xx) {
      std::memcpy(orow + xx * ch, row + xmap[xx] * ch, ch);
    }
  }
  return dst;
}

bool IsPng(const uint8_t* d, size_t n) {
  return n >= 8 && d[0] == 0x89 && d[1] == 'P' && d[2] == 'N' && d[3] == 'G';
}

bool IsJpeg(const uint8_t* d, size_t n) {
  return n >= 2 && d[0] == 0xFF && d[1] == 0xD8;
}

// ---------------------------------------------------------------------------
// Python bindings
// ---------------------------------------------------------------------------

PyObject* DecodeCommon(PyObject* args, bool as_label) {
  Py_buffer buf;
  int out_h, out_w;
  if (!PyArg_ParseTuple(args, "y*ii", &buf, &out_h, &out_w)) {
    return nullptr;
  }
  const uint8_t* data = static_cast<const uint8_t*>(buf.buf);
  size_t size = buf.len;

  Decoded img;
  std::string err;
  bool ok = false;
  std::vector<uint8_t> resized;
  Py_BEGIN_ALLOW_THREADS;
  if (IsPng(data, size)) {
    ok = DecodePng(data, size, as_label, &img, &err);
  } else if (!as_label && IsJpeg(data, size)) {
    ok = DecodeJpeg(data, size, &img, &err);
  } else {
    err = "unsupported format";
  }
  if (ok) {
    resized = as_label ? ResizeNearest(img, out_h, out_w)
                       : ResizeBilinear(img, out_h, out_w);
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&buf);
  if (!ok) {
    PyErr_SetString(PyExc_ValueError, err.c_str());
    return nullptr;
  }
  return PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(resized.data()),
      static_cast<Py_ssize_t>(resized.size()));
}

PyObject* DecodeImage(PyObject*, PyObject* args) {
  return DecodeCommon(args, /*as_label=*/false);
}

PyObject* DecodeLabel(PyObject*, PyObject* args) {
  return DecodeCommon(args, /*as_label=*/true);
}

PyMethodDef kMethods[] = {
    {"decode_image", DecodeImage, METH_VARARGS,
     "decode_image(data, height, width) -> RGB bytes (PIL-bilinear resize)"},
    {"decode_label", DecodeLabel, METH_VARARGS,
     "decode_label(data, height, width) -> index bytes (nearest resize)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_native_decoder",
    "Native PNG/JPEG decode + PIL-parity resize", -1, kMethods,
};

}  // namespace

extern "C" PyMODINIT_FUNC PyInit__native_decoder(void) {
  return PyModule_Create(&kModule);
}
