// Native data-loader core: JPEG decode + bilinear letterbox resize + pad,
// the PyTorch port's own copy.
//
// libjpeg decode and a half-pixel-center bilinear resize into a
// zero-padded canvas, all outside the GIL so a host worker pool scales
// with cores. The port's pipeline (data/pipeline.py) and its serving
// ingest (serving.py:letterbox_jpeg) use it when built, and PIL otherwise.
//
// The anonymous namespace below is native/pipeline.cc's, statement for
// statement (tests/test_torch_native_build.py holds the two equal). In
// place of that file's CPython glue this copy has a plain C interface of
// pointers and sizes, loaded with ctypes by
// vision_transformer_detector_tpu_torch/_native/_native_pipeline.py, which
// releases the GIL for the call. Built at first use with the host C++
// compiler and -ljpeg (_native/__init__.py); a host without jpeglib.h
// builds the other two cores and decodes with PIL.

// jpeglib.h uses size_t and FILE without including their headers.
#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <setjmp.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void ErrorExit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

struct Decoded {
  std::vector<unsigned char> rgb;  // oh * ow * 3 (decoded-buffer dims)
  int oh = 0;       // decoded buffer height (== full_h unless DCT-scaled)
  int ow = 0;       // decoded buffer width
  int full_h = 0;   // pre-scaling image dims from the JPEG header —
  int full_w = 0;   // letterbox geometry and labels key off these
  bool ok = false;
  std::string error;
};

// Letterbox resize target for a (full_h, full_w) source into a (th, tw)
// canvas — double math + ties-to-even, the exact twin of the Python
// fallback's round() (see DecodeLetterbox below).
void LetterboxResizeDims(int full_h, int full_w, int th, int tw,
                         int* rh, int* rw) {
  const double scale = std::max(static_cast<double>(full_h) / th,
                                static_cast<double>(full_w) / tw);
  *rh = std::max(1, static_cast<int>(std::nearbyint(full_h / scale)));
  *rw = std::max(1, static_cast<int>(std::nearbyint(full_w / scale)));
}

// letterbox_th/letterbox_tw > 0 enables DCT-domain scaled decode: after
// the header reveals the full dims, the exact letterbox resize target
// (rh, rw) is derived and libjpeg decodes at the smallest M/8 (M in
// 1..8) whose output still covers it — skipping most of the IDCT +
// color-convert work when the canvas is much smaller than the source.
// The subsequent bilinear step then only ever downscales.
Decoded DecodeJpeg(const unsigned char* data, size_t size,
                   int letterbox_th = 0, int letterbox_tw = 0) {
  Decoded out;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = ErrorExit;
  if (setjmp(jerr.setjmp_buffer)) {
    char msg[JMSG_LENGTH_MAX];
    (*cinfo.err->format_message)(
        reinterpret_cast<j_common_ptr>(&cinfo), msg);
    out.error = msg;
    jpeg_destroy_decompress(&cinfo);
    return out;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  out.full_h = static_cast<int>(cinfo.image_height);
  out.full_w = static_cast<int>(cinfo.image_width);
  // Sanity-cap the FULL header dims before anything else: the scaled
  // path shrinks the decode buffer up to 64x, which would otherwise
  // let a crafted 65500x65500 header (rejected in exact mode) through
  // to a ~200 MB allocation + full-image Huffman pass per call.
  if (static_cast<size_t>(out.full_h) * out.full_w > (1u << 27)) {
    out.error = "image dimensions too large (" + std::to_string(out.full_w)
        + "x" + std::to_string(out.full_h) + ")";
    jpeg_destroy_decompress(&cinfo);
    return out;
  }
  if (letterbox_th > 0 && letterbox_tw > 0) {
    int rh = 0, rw = 0;
    LetterboxResizeDims(out.full_h, out.full_w, letterbox_th, letterbox_tw,
                        &rh, &rw);
    for (int m = 1; m <= 8; ++m) {
      // libjpeg's scaled output dims are ceil(dim * m / 8).
      const long sh = (static_cast<long>(out.full_h) * m + 7) / 8;
      const long sw = (static_cast<long>(out.full_w) * m + 7) / 8;
      if (sh >= rh && sw >= rw) {
        cinfo.scale_num = m;
        cinfo.scale_denom = 8;
        break;
      }
    }
  }
  jpeg_start_decompress(&cinfo);

  out.oh = static_cast<int>(cinfo.output_height);
  out.ow = static_cast<int>(cinfo.output_width);
  // Sanity-cap the decoded size BEFORE allocating: a corrupt/adversarial
  // header can declare 65500x65500 (~12.8 GB RGB) and the resulting
  // bad_alloc would escape worker threads into std::terminate.
  if (static_cast<size_t>(out.oh) * out.ow > (1u << 27)) {
    out.error = "image dimensions too large (" + std::to_string(out.ow)
        + "x" + std::to_string(out.oh) + ")";
    jpeg_destroy_decompress(&cinfo);
    return out;
  }
  out.rgb.resize(static_cast<size_t>(out.oh) * out.ow * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out.rgb.data()
        + static_cast<size_t>(cinfo.output_scanline) * out.ow * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  out.ok = true;
  return out;
}

// Half-pixel-center bilinear resize of an RGB buffer (the classic
// tf.image.resize / jax.image.resize convention). Horizontal coefficients
// are precomputed per destination column and each source row pair is
// horizontally resampled once into float rows, so the inner loops are
// tight multiply-adds the compiler can vectorise.
void ResizeBilinear(const unsigned char* src, int sh, int sw,
                    unsigned char* dst, int dh, int dw) {
  const float scale_y = static_cast<float>(sh) / dh;
  const float scale_x = static_cast<float>(sw) / dw;

  std::vector<int> x0s(dw), x1s(dw);
  std::vector<float> fxs(dw);
  for (int x = 0; x < dw; ++x) {
    float sx = (x + 0.5f) * scale_x - 0.5f;
    sx = std::max(0.0f, std::min(sx, static_cast<float>(sw - 1)));
    x0s[x] = static_cast<int>(sx);
    x1s[x] = std::min(x0s[x] + 1, sw - 1);
    fxs[x] = sx - x0s[x];
  }

  // Horizontally-resampled rows, cached by source row index.
  std::vector<float> row_a(dw * 3), row_b(dw * 3);
  int cached_a = -1, cached_b = -1;

  auto hresample = [&](int sy, std::vector<float>& out) {
    const unsigned char* row = src + static_cast<size_t>(sy) * sw * 3;
    for (int x = 0; x < dw; ++x) {
      const unsigned char* p0 = row + x0s[x] * 3;
      const unsigned char* p1 = row + x1s[x] * 3;
      const float fx = fxs[x];
      float* o = out.data() + x * 3;
      o[0] = p0[0] + (p1[0] - p0[0]) * fx;
      o[1] = p0[1] + (p1[1] - p0[1]) * fx;
      o[2] = p0[2] + (p1[2] - p0[2]) * fx;
    }
  };

  for (int y = 0; y < dh; ++y) {
    float sy = (y + 0.5f) * scale_y - 0.5f;
    sy = std::max(0.0f, std::min(sy, static_cast<float>(sh - 1)));
    const int y0 = static_cast<int>(sy);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float fy = sy - y0;

    if (cached_a != y0) {
      if (cached_b == y0) {
        std::swap(row_a, row_b);
        std::swap(cached_a, cached_b);
      } else {
        hresample(y0, row_a);
        cached_a = y0;
      }
    }
    if (cached_b != y1) {
      hresample(y1, row_b);
      cached_b = y1;
    }

    unsigned char* out = dst + static_cast<size_t>(y) * dw * 3;
    const float* a = row_a.data();
    const float* b = row_b.data();
    const int n = dw * 3;
    for (int i = 0; i < n; ++i) {
      // Convex combination of uint8 values stays in [0, 255].
      out[i] = static_cast<unsigned char>(a[i] + (b[i] - a[i]) * fy + 0.5f);
    }
  }
}

// Decode + aspect-preserving resize + center pad into (th, tw, 3) zeros —
// the letterbox geometry of data/annotations.py:letterbox_params
// (vtu.py:305-323 semantics).
Decoded DecodeLetterbox(const unsigned char* data, size_t size,
                        int th, int tw, bool scaled) {
  // With `scaled`, libjpeg stops IDCT at the smallest M/8 covering the
  // resize target (decided inside DecodeJpeg, right after the header).
  // The geometry (rh, rw, pad offsets, returned original dims) is
  // computed from the FULL header dims either way, so labels and box
  // mapping are bit-identical between the two modes; only the
  // resampling path differs (DCT box-filter prescale + short bilinear
  // vs one long bilinear), a bounded pixel-value difference that the
  // fast mode's callers opt into (tests/test_native_pipeline.py pins it).
  Decoded decoded = scaled ? DecodeJpeg(data, size, th, tw)
                           : DecodeJpeg(data, size);
  if (!decoded.ok) return decoded;
  // Double math + ties-to-even (nearbyint under the default rounding
  // mode), matching Python's round() in the PIL fallback — lround's
  // half-away-from-zero placed the resize 1px off at exact .5 sizes,
  // skewing native-vs-PIL hosts against each other.
  int rh = 0, rw = 0;
  LetterboxResizeDims(decoded.full_h, decoded.full_w, th, tw, &rh, &rw);
  const int oh = decoded.oh;
  const int ow = decoded.ow;

  std::vector<unsigned char> resized(static_cast<size_t>(rh) * rw * 3);
  ResizeBilinear(decoded.rgb.data(), oh, ow, resized.data(), rh, rw);

  Decoded out;
  out.oh = decoded.full_h;
  out.ow = decoded.full_w;
  out.ok = true;
  out.rgb.assign(static_cast<size_t>(th) * tw * 3, 0);
  const int top = (th - rh) / 2;
  const int left = (tw - rw) / 2;
  for (int y = 0; y < rh; ++y) {
    std::memcpy(out.rgb.data()
                    + ((static_cast<size_t>(top) + y) * tw + left) * 3,
                resized.data() + static_cast<size_t>(y) * rw * 3,
                static_cast<size_t>(rw) * 3);
  }
  return out;
}

// noexcept wrapper: a std::bad_alloc (or any exception) escaping a
// worker thread or a Py_BEGIN_ALLOW_THREADS region calls std::terminate;
// convert it into the same error-Decoded path as libjpeg failures.
Decoded DecodeLetterboxSafe(const unsigned char* data, size_t size,
                            int th, int tw, bool scaled) noexcept {
  try {
    return DecodeLetterbox(data, size, th, tw, scaled);
  } catch (const std::exception& e) {
    Decoded d;
    d.error = e.what();
    return d;
  } catch (...) {
    Decoded d;
    d.error = "unknown native decode failure";
    return d;
  }
}

}  // namespace

#define VTD_EXPORT __attribute__((visibility("default")))

namespace {

// Copies `message` into the caller's NUL-terminated buffer.
void CopyError(const std::string& message, char* error, int error_size) {
  if (error == nullptr || error_size <= 0) return;
  const size_t n = std::min(message.size(),
                            static_cast<size_t>(error_size) - 1);
  std::memcpy(error, message.data(), n);
  error[n] = '\0';
}

// One image into its canvas (th * tw * 3 bytes) and (orig_h, orig_w);
// false with the message in `message` when it cannot be decoded.
bool DecodeInto(const unsigned char* data, size_t size, int th, int tw,
                bool scaled, unsigned char* canvas, int* orig_hw,
                std::string* message) noexcept {
  const Decoded d = DecodeLetterboxSafe(data, size, th, tw, scaled);
  if (!d.ok) {
    try {
      *message = "jpeg decode failed: " + d.error;
    } catch (...) {
    }
    return false;
  }
  std::memcpy(canvas, d.rgb.data(), d.rgb.size());
  orig_hw[0] = d.oh;
  orig_hw[1] = d.ow;
  return true;
}

}  // namespace

extern "C" {

// Decodes `size` bytes of one JPEG and letterboxes it into `canvas`, uint8
// (th, tw, 3); orig_hw gets the image's (height, width). scaled != 0
// decodes at the smallest libjpeg M/8 scale that covers the resize target.
// Returns 0, or 1 with the message in `error` (error_size bytes at most,
// NUL-terminated) when the bytes cannot be decoded, 3 on invalid
// arguments.
VTD_EXPORT int vtd_decode_letterbox(const unsigned char* data,
                                    long long size, int th, int tw,
                                    int scaled, unsigned char* canvas,
                                    int* orig_hw, char* error,
                                    int error_size) {
  if (th <= 0 || tw <= 0 || size < 0) {
    CopyError("target size must be positive", error, error_size);
    return 3;
  }
  std::string message;
  if (!DecodeInto(data, static_cast<size_t>(size), th, tw, scaled != 0,
                  canvas, orig_hw, &message)) {
    CopyError(message, error, error_size);
    return 1;
  }
  return 0;
}

// decode_letterbox of n images on min(num_threads, n) threads (num_threads
// <= 0: one per hardware thread): image i from data[i] (sizes[i] bytes)
// into canvases + i * th * tw * 3 and orig_hw + 2 * i. Returns 0, or 1 with
// the message of the lowest-numbered image that failed in `error` and its
// index in *failed; 3 on invalid arguments.
VTD_EXPORT int vtd_decode_letterbox_batch(
    const unsigned char* const* data, const long long* sizes, long long n,
    int th, int tw, int num_threads, int scaled, unsigned char* canvases,
    int* orig_hw, long long* failed, char* error, int error_size) {
  if (th <= 0 || tw <= 0 || n < 0) {
    CopyError("target size must be positive", error, error_size);
    return 3;
  }
  const size_t canvas_bytes = static_cast<size_t>(th) * tw * 3;
  std::vector<std::string> messages;
  std::vector<unsigned char> ok;
  try {
    messages.resize(static_cast<size_t>(n));
    ok.assign(static_cast<size_t>(n), 0);
  } catch (const std::bad_alloc&) {
    CopyError("out of memory", error, error_size);
    return 2;
  }
  const int workers = std::max(
      1, std::min<int>(num_threads > 0
                           ? num_threads
                           : static_cast<int>(
                                 std::thread::hardware_concurrency()),
                       static_cast<int>(std::min<long long>(n, 1 << 20))));
  std::atomic<long long> next{0};
  auto work = [&]() {
    while (true) {
      const long long i = next.fetch_add(1);
      if (i >= n) break;
      ok[i] = DecodeInto(data[i], static_cast<size_t>(sizes[i]), th, tw,
                         scaled != 0, canvases + i * canvas_bytes,
                         orig_hw + 2 * i, &messages[i]);
    }
  };
  std::vector<std::thread> pool;
  try {
    for (int t = 1; t < workers; ++t) pool.emplace_back(work);
  } catch (...) {
    // Fewer threads than asked: the ones started and this one finish.
  }
  work();
  for (auto& t : pool) t.join();
  for (long long i = 0; i < n; ++i) {
    if (!ok[i]) {
      if (failed != nullptr) *failed = i;
      CopyError(messages[i], error, error_size);
      return 1;
    }
  }
  return 0;
}

}  // extern "C"
