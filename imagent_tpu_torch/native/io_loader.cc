// Native batch image loader: threaded JPEG/PNG decode + triangle-filter
// resize + normalize, writing float32 NHWC directly into a caller buffer.
//
// TPU-native equivalent of the reference's multiprocess pinned-memory
// DataLoader (imagenet.py:350-359, 10 C-worker processes per rank): the
// input pipeline is the host-CPU hot path (SURVEY §7 "Input pipeline
// throughput"), so decode/resize runs in C++ with the GIL released —
// one process, N threads, zero IPC serialization.
//
// Exposed C ABI (consumed by imagent_tpu/native/loader.py via ctypes):
//   il_decode_resize_batch(paths, n, out_size, mean, std, out, ok, threads)
//     -> number of failed images (their `ok` flag is 0; rows untouched)
//
// Decode fast path: libjpeg DCT scaling (M/8) picks the smallest decode
// size that still covers the target, so a 2048px source headed for 448px
// is decoded at ~1/4 cost before the resampler ever sees it.
// Resampling: separable triangle (bilinear) filter with downscale-widened
// support — the same family PIL's Image.BILINEAR uses, so outputs match
// the pure-Python fallback path closely.

#include <cstddef>
#include <cstdio>
// jpeglib.h requires stdio/stddef types to be declared before inclusion.
#include <jpeglib.h>
#include <png.h>
#ifndef IL_NO_WEBP
#include <webp/decode.h>
#endif

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Crop rectangle in decoded-image coordinates (float: JPEG DCT scaling
// rescales a crop sampled in original coordinates) + horizontal flip.
struct Crop {
  float x = 0, y = 0, w = 0, h = 0;
  bool flip = false;
};

// RandomResizedCrop + flip parameters (torchvision defaults when enabled
// from Python: scale (0.08, 1.0), ratio (3/4, 4/3), hflip_prob 0.5).
struct Aug {
  float scale_min, scale_max, ratio_min, ratio_max, hflip_prob;
  // log(ratio_min/max), precomputed on the Python side: no libm call
  // participates in the sampled stream, so the PIL fallback's Python
  // port stays bit-exact (libm expf/logf differ from numpy by 1 ULP).
  float log_rmin, log_rmax;
};

// Shared exp: degree-6 Taylor of 2^f with bit-assembled exponent, basic
// fp32 ops only (no fma, no libm) — mirrored operation-for-operation in
// data/imagefolder.py::_exp_shared so both decode paths round
// identically on every platform.
float exp_shared(float x) {
  const float t = x * 1.4426950408889634f;  // log2(e)
  const float fn = std::floor(t);
  const float f = t - fn;
  float p = 1.5403530393381608e-4f;
  p = p * f + 1.3333558146428443e-3f;
  p = p * f + 9.618129107628477e-3f;
  p = p * f + 5.550410866482158e-2f;
  p = p * f + 2.402265069591007e-1f;
  p = p * f + 6.9314718056e-1f;
  p = p * f + 1.0f;
  const int n = static_cast<int>(fn);
  uint32_t bits = static_cast<uint32_t>(n + 127) << 23;
  float scale;
  std::memcpy(&scale, &bits, sizeof(scale));
  return p * scale;
}

// C lround rounds half away from zero; floor(x + 0.5) is cheaper to
// mirror exactly in Python and identical for the non-negative values
// sampled here.
int lround_shared(float x) { return static_cast<int>(std::floor(x + 0.5f)); }

// splitmix64: deterministic per-(seed, epoch, sample) stream, so an epoch's
// augmentation is reproducible across runs and across the native/PIL paths'
// shared seed derivation.
uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9E3779B97f4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

float uniform01(uint64_t* s) {
  return static_cast<float>(splitmix64(s) >> 11) * 0x1.0p-53f;
}

// torchvision RandomResizedCrop.get_params: 10 area/ratio attempts, then
// a ratio-clamped center-crop fallback.
Crop sample_crop(int w, int h, const Aug& aug, uint64_t seed) {
  uint64_t s = seed;
  Crop c;
  const float area = static_cast<float>(w) * h;
  const float log_rmin = aug.log_rmin;
  const float log_rmax = aug.log_rmax;
  for (int attempt = 0; attempt < 10; ++attempt) {
    const float target_area =
        area * (aug.scale_min +
                uniform01(&s) * (aug.scale_max - aug.scale_min));
    const float ar =
        exp_shared(log_rmin + uniform01(&s) * (log_rmax - log_rmin));
    const int cw = lround_shared(std::sqrt(target_area * ar));
    const int ch_ = lround_shared(std::sqrt(target_area / ar));
    if (cw > 0 && ch_ > 0 && cw <= w && ch_ <= h) {
      c.x = static_cast<float>(splitmix64(&s) % (w - cw + 1));
      c.y = static_cast<float>(splitmix64(&s) % (h - ch_ + 1));
      c.w = static_cast<float>(cw);
      c.h = static_cast<float>(ch_);
      c.flip = uniform01(&s) < aug.hflip_prob;
      return c;
    }
  }
  // Fallback: center crop at the nearest in-range aspect ratio.
  const float in_ratio = static_cast<float>(w) / h;
  int cw, ch_;
  if (in_ratio < aug.ratio_min) {
    cw = w;
    ch_ = lround_shared(w / aug.ratio_min);
  } else if (in_ratio > aug.ratio_max) {
    ch_ = h;
    cw = lround_shared(h * aug.ratio_max);
  } else {
    cw = w;
    ch_ = h;
  }
  c.w = static_cast<float>(cw);
  c.h = static_cast<float>(ch_);
  c.x = static_cast<float>((w - cw) / 2);
  c.y = static_cast<float>((h - ch_) / 2);
  c.flip = uniform01(&s) < aug.hflip_prob;
  return c;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void jpeg_silent(j_common_ptr, int) {}

// Decode a JPEG at >= target size using DCT scaling. RGB uint8 out.
// With `aug`, the crop is sampled in ORIGINAL coordinates from the header
// dims (so augmentation statistics don't depend on the decode scale), the
// DCT scale is chosen to keep the CROP at >= target size, and the crop is
// rescaled into decoded coordinates on return.
bool decode_jpeg(const char* path, int target, const Aug* aug, uint64_t seed,
                 std::vector<uint8_t>* pix, int* w, int* h, Crop* crop) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  // Declared BEFORE setjmp: longjmp back into this scope keeps `row`
  // alive (destructor runs at normal function exit) — declaring it after
  // the setjmp point would skip its destructor on error (UB + leak).
  std::vector<uint8_t> row;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  jerr.mgr.emit_message = jpeg_silent;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  const int ow = static_cast<int>(cinfo.image_width);
  const int oh = static_cast<int>(cinfo.image_height);
  Crop c;  // original coordinates
  if (aug) {
    c = sample_crop(ow, oh, *aug, seed);
  } else {
    c.w = static_cast<float>(ow);
    c.h = static_cast<float>(oh);
  }
  // Smallest M/8 scale whose decoded CROP still covers the target on both
  // axes (never upscale past the source).
  int m = 8;
  for (int cand = 1; cand <= 8; ++cand) {
    if (c.w * cand / 8 >= target && c.h * cand / 8 >= target) {
      m = cand;
      break;
    }
  }
  cinfo.scale_num = m;
  cinfo.scale_denom = 8;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  const float sx = static_cast<float>(*w) / ow;
  const float sy = static_cast<float>(*h) / oh;
  crop->x = c.x * sx;
  crop->y = c.y * sy;
  crop->w = c.w * sx;
  crop->h = c.h * sy;
  crop->flip = c.flip;
  const int ch = cinfo.output_components;  // 3 after JCS_RGB
  pix->resize(static_cast<size_t>(*w) * *h * 3);
  row.resize(static_cast<size_t>(*w) * ch);
  for (int y = 0; y < *h; ++y) {
    uint8_t* rp = row.data();
    jpeg_read_scanlines(&cinfo, &rp, 1);
    uint8_t* dst = pix->data() + static_cast<size_t>(y) * *w * 3;
    if (ch == 3) {
      memcpy(dst, rp, static_cast<size_t>(*w) * 3);
    } else {  // grayscale guard (JCS_RGB normally prevents this)
      for (int x = 0; x < *w; ++x)
        dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = rp[x * ch];
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// PNG via the libpng16 simplified API.
bool decode_png(const char* path, std::vector<uint8_t>* pix, int* w, int* h) {
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) return false;
  image.format = PNG_FORMAT_RGB;
  *w = image.width;
  *h = image.height;
  pix->resize(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, pix->data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  return true;
}

// WebP via libwebp. Reads the whole file (webp has no streaming-decode
// need at dataset-image sizes). Optional: built with -DIL_NO_WEBP when
// the libwebp headers are absent (imagent_tpu/native/loader.py retries
// the build without it) — webp members then fall to the per-file PIL
// rescue instead of costing the whole native path.
#ifdef IL_NO_WEBP
bool decode_webp(const char*, std::vector<uint8_t>*, int*, int*) {
  return false;  // unsupported in this build; PIL rescue handles it
}
#else
bool decode_webp(const char* path, std::vector<uint8_t>* pix, int* w,
                 int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz <= 0 || sz > (64L << 20)) { fclose(f); return false; }
  std::vector<uint8_t> buf(sz);
  const bool read_ok = fread(buf.data(), 1, sz, f) == static_cast<size_t>(sz);
  fclose(f);
  if (!read_ok) return false;
  int ww = 0, hh = 0;
  if (!WebPGetInfo(buf.data(), buf.size(), &ww, &hh)) return false;
  pix->resize(static_cast<size_t>(ww) * hh * 3);
  if (!WebPDecodeRGBInto(buf.data(), buf.size(), pix->data(), pix->size(),
                         ww * 3))
    return false;
  *w = ww;
  *h = hh;
  return true;
}
#endif  // IL_NO_WEBP

// Minimal BMP decoder: uncompressed (BI_RGB) 24/32-bit, the overwhelmingly
// common case for dataset BMPs; anything else falls to the PIL rescue.
bool decode_bmp(const char* path, std::vector<uint8_t>* pix, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t hdr[54];
  if (fread(hdr, 1, 54, f) != 54 || hdr[0] != 'B' || hdr[1] != 'M') {
    fclose(f);
    return false;
  }
  auto rd32 = [&](int off) {
    return static_cast<int32_t>(hdr[off] | hdr[off + 1] << 8 |
                                hdr[off + 2] << 16 |
                                static_cast<uint32_t>(hdr[off + 3]) << 24);
  };
  const uint32_t data_off = static_cast<uint32_t>(rd32(10));
  const int32_t width = rd32(18);
  int32_t height = rd32(22);
  const uint16_t bpp = static_cast<uint16_t>(hdr[28] | hdr[29] << 8);
  const int32_t compression = rd32(30);
  const bool top_down = height < 0;
  if (top_down) height = -height;
  if (width <= 0 || height <= 0 || width > 1 << 16 || height > 1 << 16 ||
      compression != 0 || (bpp != 24 && bpp != 32)) {
    fclose(f);
    return false;
  }
  const int ch = bpp / 8;
  const size_t stride = (static_cast<size_t>(width) * ch + 3) & ~size_t{3};
  std::vector<uint8_t> rowbuf(stride);
  pix->resize(static_cast<size_t>(width) * height * 3);
  if (fseek(f, static_cast<long>(data_off), SEEK_SET) != 0) {
    fclose(f);
    return false;
  }
  for (int32_t y = 0; y < height; ++y) {
    if (fread(rowbuf.data(), 1, stride, f) != stride) {
      fclose(f);
      return false;
    }
    const int32_t dy = top_down ? y : height - 1 - y;  // BMP is bottom-up
    uint8_t* dst = pix->data() + static_cast<size_t>(dy) * width * 3;
    for (int32_t x = 0; x < width; ++x) {
      const uint8_t* p = rowbuf.data() + static_cast<size_t>(x) * ch;
      dst[3 * x] = p[2];  // BGR(A) -> RGB
      dst[3 * x + 1] = p[1];
      dst[3 * x + 2] = p[0];
    }
  }
  fclose(f);
  *w = width;
  *h = height;
  return true;
}

bool has_magic(const char* path, const uint8_t* magic, int n) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t buf[8] = {0};
  size_t got = fread(buf, 1, n, f);
  fclose(f);
  return got == static_cast<size_t>(n) && memcmp(buf, magic, n) == 0;
}

// Triangle-filter weights for one output axis (PIL ImagingResampleHorizontal
// equivalent): support widens by the downscale factor so every source pixel
// contributes — plain point-sampled bilinear aliases badly at 8x downscale.
struct FilterTaps {
  std::vector<int> xmin, xlen;
  std::vector<float> weights;  // row-major [out, max_len]
  int max_len = 0;
};

// Taps mapping out_size output pixels onto the source span
// [offset, offset + span) of an axis with in_size pixels (offset/span are
// float: crops inherit fractional coordinates from JPEG DCT scaling).
FilterTaps triangle_taps(int in_size, int out_size, double offset,
                         double span) {
  FilterTaps t;
  const double scale = span / out_size;
  const double fscale = std::max(scale, 1.0);
  const double support = fscale;  // triangle support 1.0 * fscale
  t.max_len = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.xmin.resize(out_size);
  t.xlen.resize(out_size);
  t.weights.assign(static_cast<size_t>(out_size) * t.max_len, 0.f);
  for (int i = 0; i < out_size; ++i) {
    const double center = offset + (i + 0.5) * scale;
    int x0 = static_cast<int>(center - support + 0.5);
    int x1 = static_cast<int>(center + support + 0.5);
    x0 = std::max(x0, 0);
    x1 = std::min(x1, in_size);
    double sum = 0.0;
    std::vector<double> w(x1 - x0);
    for (int x = x0; x < x1; ++x) {
      double v = (x + 0.5 - center) / fscale;
      v = 1.0 - std::abs(v);
      w[x - x0] = v > 0 ? v : 0.0;
      sum += w[x - x0];
    }
    t.xmin[i] = x0;
    t.xlen[i] = x1 - x0;
    for (int k = 0; k < x1 - x0; ++k)
      t.weights[static_cast<size_t>(i) * t.max_len + k] =
          static_cast<float>(sum > 0 ? w[k] / sum : 0.0);
  }
  return t;
}

// (h, w, 3) uint8 -> crop -> (size, size, 3) float32, normalized; the
// horizontal flip folds into the horizontal tap order for free.
void resize_normalize(const uint8_t* pix, int w, int h, const Crop& crop,
                      int size, const float* mean, const float* stddev,
                      float* out) {
  FilterTaps hx = triangle_taps(w, size, crop.x, crop.w);
  FilterTaps vy = triangle_taps(h, size, crop.y, crop.h);
  if (crop.flip) {  // reverse the output-column order of the taps
    std::reverse(hx.xmin.begin(), hx.xmin.end());
    std::reverse(hx.xlen.begin(), hx.xlen.end());
    std::vector<float> rev(hx.weights.size());
    for (int i = 0; i < size; ++i)
      std::copy_n(&hx.weights[static_cast<size_t>(size - 1 - i) * hx.max_len],
                  hx.max_len, &rev[static_cast<size_t>(i) * hx.max_len]);
    hx.weights.swap(rev);
  }
  // Horizontal pass: (h, w, 3) -> (h, size, 3)
  std::vector<float> tmp(static_cast<size_t>(h) * size * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = pix + static_cast<size_t>(y) * w * 3;
    float* dst = tmp.data() + static_cast<size_t>(y) * size * 3;
    for (int i = 0; i < size; ++i) {
      const float* wt = &hx.weights[static_cast<size_t>(i) * hx.max_len];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
      const int x0 = hx.xmin[i];
      for (int k = 0; k < hx.xlen[i]; ++k) {
        const uint8_t* p = src + static_cast<size_t>(x0 + k) * 3;
        acc0 += wt[k] * p[0];
        acc1 += wt[k] * p[1];
        acc2 += wt[k] * p[2];
      }
      dst[3 * i] = acc0;
      dst[3 * i + 1] = acc1;
      dst[3 * i + 2] = acc2;
    }
  }
  // Vertical pass + scale to [0,1] + normalize: (h, size, 3) -> (size, size, 3)
  const float inv255 = 1.0f / 255.0f;
  float scale_c[3], bias_c[3];
  for (int c = 0; c < 3; ++c) {
    scale_c[c] = inv255 / stddev[c];
    bias_c[c] = -mean[c] / stddev[c];
  }
  for (int j = 0; j < size; ++j) {
    const float* wt = &vy.weights[static_cast<size_t>(j) * vy.max_len];
    const int y0 = vy.xmin[j];
    float* dst = out + static_cast<size_t>(j) * size * 3;
    for (int i = 0; i < size; ++i) {
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
      for (int k = 0; k < vy.xlen[j]; ++k) {
        const float* p =
            tmp.data() + (static_cast<size_t>(y0 + k) * size + i) * 3;
        acc0 += wt[k] * p[0];
        acc1 += wt[k] * p[1];
        acc2 += wt[k] * p[2];
      }
      dst[3 * i] = acc0 * scale_c[0] + bias_c[0];
      dst[3 * i + 1] = acc1 * scale_c[1] + bias_c[1];
      dst[3 * i + 2] = acc2 * scale_c[2] + bias_c[2];
    }
  }
}

const uint8_t kJpegMagic[] = {0xFF, 0xD8, 0xFF};
const uint8_t kPngMagic[] = {0x89, 'P', 'N', 'G'};
const uint8_t kRiffMagic[] = {'R', 'I', 'F', 'F'};
const uint8_t kBmpMagic[] = {'B', 'M'};

bool decode_one(const char* path, int size, const Aug* aug, uint64_t seed,
                const float* mean, const float* stddev, float* out) {
  std::vector<uint8_t> pix;
  int w = 0, h = 0;
  bool ok = false;
  Crop crop;
  bool have_crop = false;
  if (has_magic(path, kJpegMagic, 3)) {
    ok = decode_jpeg(path, size, aug, seed, &pix, &w, &h, &crop);
    have_crop = ok;
  } else if (has_magic(path, kPngMagic, 4)) {
    ok = decode_png(path, &pix, &w, &h);
  } else if (has_magic(path, kRiffMagic, 4)) {
    ok = decode_webp(path, &pix, &w, &h);
  } else if (has_magic(path, kBmpMagic, 2)) {
    ok = decode_bmp(path, &pix, &w, &h);
  }
  if (!ok || w <= 0 || h <= 0) return false;
  if (!have_crop) {
    if (aug) {
      crop = sample_crop(w, h, *aug, seed);
    } else {
      crop.w = static_cast<float>(w);
      crop.h = static_cast<float>(h);
    }
  }
  resize_normalize(pix.data(), w, h, crop, size, mean, stddev, out);
  return true;
}

}  // namespace

extern "C" {

// Returns the number of images that FAILED to decode (ok[i] == 0 for those;
// their output rows are left untouched for the Python fallback to fill).
// `aug_params` (7 floats: scale_min, scale_max, ratio_min, ratio_max,
// hflip_prob, log_ratio_min, log_ratio_max — logs precomputed caller-side) and `aug_seeds` (one uint64 per image) are both NULL for the
// plain resize path, both non-NULL for RandomResizedCrop + flip.
int64_t il_decode_resize_batch(const char* const* paths, int64_t n,
                               int out_size, const float* mean,
                               const float* stddev,
                               const float* aug_params,
                               const uint64_t* aug_seeds, float* out,
                               uint8_t* ok, int n_threads) {
  if (n <= 0) return 0;
  Aug aug_val{};
  const Aug* aug = nullptr;
  if (aug_params && aug_seeds) {
    aug_val = Aug{aug_params[0], aug_params[1], aug_params[2], aug_params[3],
                  aug_params[4], aug_params[5], aug_params[6]};
    aug = &aug_val;
  }
  const size_t row = static_cast<size_t>(out_size) * out_size * 3;
  std::atomic<int64_t> next(0), failed(0);
  auto work = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n) return;
      const bool good =
          decode_one(paths[i], out_size, aug, aug ? aug_seeds[i] : 0, mean,
                     stddev, out + i * row);
      ok[i] = good ? 1 : 0;
      if (!good) failed.fetch_add(1);
    }
  };
  const int hw = static_cast<int>(std::thread::hardware_concurrency());
  int nt = n_threads > 0 ? n_threads : std::max(1, hw);
  nt = static_cast<int>(std::min<int64_t>(nt, n));
  if (nt <= 1) {
    work();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  return failed.load();
}

// Expose the crop sampler for cross-path parity testing: the PIL
// fallback (data/imagefolder.py::_sample_crop) ports this bit-exactly
// so a (seed, epoch, row) triple augments identically on both paths.
// `out5` = {x, y, w, h, flip}.
void il_sample_crop(int w, int h, const float* aug_params, uint64_t seed,
                    float* out5) {
  const Aug aug{aug_params[0], aug_params[1], aug_params[2], aug_params[3],
                aug_params[4], aug_params[5], aug_params[6]};
  const Crop c = sample_crop(w, h, aug, seed);
  out5[0] = c.x;
  out5[1] = c.y;
  out5[2] = c.w;
  out5[3] = c.h;
  out5[4] = c.flip ? 1.0f : 0.0f;
}

int il_version() { return 4; }

// Which optional decoders this BUILD carries (a capability probe, not
// an ABI change: absent in pre-probe binaries, where webp was always
// compiled in — the Python side treats a missing symbol as "has it").
int il_has_webp() {
#ifdef IL_NO_WEBP
  return 0;
#else
  return 1;
#endif
}

}  // extern "C"
