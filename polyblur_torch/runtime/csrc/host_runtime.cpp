// polyblur_torch native host runtime: the JAX package's
// (polyblur_tpu/runtime/csrc/host_runtime.cpp), its code unchanged.
//
// The device pipeline deblurs at hundreds of MP/s; at that rate the host
// side — image decode, overlapping-tile extraction, windowed overlap-add
// reassembly — becomes the bottleneck if left to single-threaded Python.
// This library provides those stages as OpenMP-parallel C++ with a plain C
// ABI (loaded via ctypes; no pybind11 dependency).
//
// Role-equivalent of the reference's native extension layer
// (polyblur/domain_transform/*.cpp,
//  separable_convolution/separable_gaussian2d.cpp) — but for the *host*
// data path; device compute is the CUDA kernels (csrc/).
//
// Build: see runtime/native.py (g++ -O3 -march=native -fopenmp -shared
//        -fPIC -lpng -ljpeg).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <png.h>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {
#include <jpeglib.h>
}

#include <setjmp.h>

extern "C" {

// ---------------------------------------------------------------------------
// Tile extraction: (B, C, H, W) f32 -> (T*B, C, ph, pw), replicate-padded
// tile grid identical to patches.plan_patch_grid / extract_patches.
// coords: T pairs (i0, j0) into the padded canvas of size (Hp, Wp);
// pad_top/pad_left place the image inside the padded canvas with replicate
// (edge) semantics.
// ---------------------------------------------------------------------------
void extract_tiles_f32(const float* img, float* out, int64_t b, int64_t c,
                       int64_t h, int64_t w, int64_t hp, int64_t wp,
                       int64_t pad_top, int64_t pad_left,
                       const int64_t* coords, int64_t n_tiles, int64_t ph,
                       int64_t pw) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t t = 0; t < n_tiles; ++t) {
    for (int64_t bc = 0; bc < b * c; ++bc) {
      const int64_t i0 = coords[2 * t];
      const int64_t j0 = coords[2 * t + 1];
      const float* src = img + bc * h * w;
      float* dst = out + (t * b * c + bc) * ph * pw;
      for (int64_t y = 0; y < ph; ++y) {
        // position in padded canvas -> clamped source row (replicate)
        int64_t sy = i0 + y - pad_top;
        sy = std::min<int64_t>(std::max<int64_t>(sy, 0), h - 1);
        const float* srow = src + sy * w;
        float* drow = dst + y * pw;
        int64_t x = 0;
        // left replicate region
        for (; x < pw && j0 + x < pad_left; ++x) drow[x] = srow[0];
        // interior contiguous copy
        int64_t sx0 = j0 + x - pad_left;
        int64_t n_mid = std::min<int64_t>(pw - x, w - sx0);
        if (n_mid > 0) {
          std::memcpy(drow + x, srow + sx0, sizeof(float) * n_mid);
          x += n_mid;
        }
        // right replicate region
        for (; x < pw; ++x) drow[x] = srow[w - 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Windowed overlap-add reassembly: (T*B, C, ph, pw) f32 tiles -> (B, C, h, w)
// restored image. window: (ph, pw). Matches patches.overlap_add (including
// the 1e-8 window-sum guard and [0,1] clamp, deblurring.py:338-340).
// ---------------------------------------------------------------------------
void overlap_add_f32(const float* tiles, const float* window, float* out,
                     int64_t b, int64_t c, int64_t h, int64_t w, int64_t hp,
                     int64_t wp, int64_t pad_top, int64_t pad_left,
                     const int64_t* coords, int64_t n_tiles, int64_t ph,
                     int64_t pw) {
  const int64_t bc_n = b * c;
  std::vector<float> acc((size_t)bc_n * hp * wp, 0.0f);
  std::vector<float> wsum((size_t)hp * wp, 0.0f);

  // window-sum canvas (shared across b, c)
  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t i0 = coords[2 * t];
    const int64_t j0 = coords[2 * t + 1];
    for (int64_t y = 0; y < ph; ++y) {
      float* wrow = wsum.data() + (i0 + y) * wp + j0;
      const float* win = window + y * pw;
      for (int64_t x = 0; x < pw; ++x) wrow[x] += win[x];
    }
  }

#pragma omp parallel for schedule(static)
  for (int64_t bc = 0; bc < bc_n; ++bc) {
    float* canvas = acc.data() + bc * hp * wp;
    for (int64_t t = 0; t < n_tiles; ++t) {
      const int64_t i0 = coords[2 * t];
      const int64_t j0 = coords[2 * t + 1];
      const float* tile = tiles + (t * bc_n + bc) * ph * pw;
      for (int64_t y = 0; y < ph; ++y) {
        float* crow = canvas + (i0 + y) * wp + j0;
        const float* trow = tile + y * pw;
        const float* win = window + y * pw;
        for (int64_t x = 0; x < pw; ++x) crow[x] += trow[x] * win[x];
      }
    }
    // normalize + clamp + crop
    float* dst = out + bc * h * w;
    for (int64_t y = 0; y < h; ++y) {
      const float* crow = canvas + (y + pad_top) * wp + pad_left;
      const float* wrow = wsum.data() + (y + pad_top) * wp + pad_left;
      for (int64_t x = 0; x < w; ++x) {
        float v = crow[x] / (wrow[x] + 1e-8f);
        dst[y * w + x] = std::min(1.0f, std::max(0.0f, v));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Image decode (PNG + JPEG) to float32 HWC in [0, 1]. Two-phase API:
// probe(path, &h, &w, &c) then decode(path, out).
// Returns 0 on success, negative error codes otherwise.
// ---------------------------------------------------------------------------

static int probe_png(FILE* fp, int64_t* h, int64_t* w, int64_t* c);
static int decode_png(FILE* fp, float* out, int64_t h, int64_t w, int64_t c);

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

static bool is_png(FILE* fp) {
  unsigned char sig[8];
  if (fread(sig, 1, 8, fp) != 8) return false;
  rewind(fp);
  return png_sig_cmp(sig, 0, 8) == 0;
}

int image_probe(const char* path, int64_t* h, int64_t* w, int64_t* c) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  int rc;
  if (is_png(fp)) {
    rc = probe_png(fp, h, w, c);
  } else {
    JpegErr jerr;
    jpeg_decompress_struct cinfo;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
      jpeg_destroy_decompress(&cinfo);
      fclose(fp);
      return -2;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, fp);
    jpeg_read_header(&cinfo, TRUE);
    *h = cinfo.image_height;
    *w = cinfo.image_width;
    *c = cinfo.num_components >= 3 ? 3 : 1;
    jpeg_destroy_decompress(&cinfo);
    rc = 0;
  }
  fclose(fp);
  return rc;
}

int image_decode(const char* path, float* out, int64_t h, int64_t w,
                 int64_t c) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  int rc;
  if (is_png(fp)) {
    rc = decode_png(fp, out, h, w, c);
    fclose(fp);
    return rc;
  }
  JpegErr jerr;
  jpeg_decompress_struct cinfo;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = c == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  std::vector<unsigned char> row((size_t)w * c);
  unsigned char* rowp = row.data();
  const float inv = 1.0f / 255.0f;
  for (int64_t y = 0; y < h && cinfo.output_scanline < cinfo.output_height;
       ++y) {
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    float* drow = out + y * w * c;
    for (int64_t i = 0; i < w * c; ++i) drow[i] = row[i] * inv;
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return 0;
}

static int probe_png(FILE* fp, int64_t* h, int64_t* w, int64_t* c) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -3;
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  *h = png_get_image_height(png, info);
  *w = png_get_image_width(png, info);
  int color = png_get_color_type(png, info);
  *c = (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
           ? 1
           : 3;
  png_destroy_read_struct(&png, &info, nullptr);
  rewind(fp);
  return 0;
}

static int decode_png(FILE* fp, float* out, int64_t h, int64_t w, int64_t c) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -3;
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  // normalize to 8-bit gray or RGB
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_packing(png);
  int color = png_get_color_type(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (c == 3 && (color == PNG_COLOR_TYPE_GRAY ||
                 color == PNG_COLOR_TYPE_GRAY_ALPHA))
    png_set_gray_to_rgb(png);
  if (c == 1 && color != PNG_COLOR_TYPE_GRAY &&
      color != PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_rgb_to_gray(png, 1, -1.0, -1.0);
  png_read_update_info(png, info);

  std::vector<unsigned char> row(png_get_rowbytes(png, info));
  const float inv = 1.0f / 255.0f;
  for (int64_t y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* drow = out + y * w * c;
    for (int64_t i = 0; i < w * c; ++i) drow[i] = row[i] * inv;
  }
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// Batch decode: n images into one (n, h, w, c) buffer (all same shape),
// parallel across images. Returns number of failures.
int batch_decode(const char** paths, int64_t n, float* out, int64_t h,
                 int64_t w, int64_t c) {
  std::atomic<int> failures{0};
#pragma omp parallel for schedule(dynamic)
  for (int64_t i = 0; i < n; ++i) {
    if (image_decode(paths[i], out + i * h * w * c, h, w, c) != 0)
      failures.fetch_add(1);
  }
  return failures.load();
}

int omp_max_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
