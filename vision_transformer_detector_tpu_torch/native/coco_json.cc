// Native COCO instances-JSON parser: the PyTorch port's own copy.
//
// Python's json module takes minutes to read the ~450 MB
// instances_train2017.json. This core is a single-pass scanner that
// extracts ONLY the fields the annotation dict needs
// (annotations[i].{image_id, category_id, bbox}) and skips everything else
// (segmentation polygons are the bulk of the file).
//
// The anonymous namespace below is native/coco_json.cc's, statement for
// statement (tests/test_torch_native_build.py holds the two equal). In
// place of that file's CPython glue this copy has a plain C interface of
// pointers and sizes, loaded with ctypes by
// vision_transformer_detector_tpu_torch/_native/_native_coco_json.py,
// which releases the GIL for the call. The Python side
// (data/annotations.py:build_annotations_from_instances) applies the
// reference's transforms (center format, degenerate-box fixes, area sort)
// to the returned flat arrays, so the output dict is bit-identical to the
// pure-Python path (tests/test_torch_native_coco_json.py).
//
// Built at first use with the host C++ compiler (_native/__init__.py); no
// Python headers, no third-party library.

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct Parsed {
  std::vector<long long> image_ids;
  std::vector<long long> category_ids;
  std::vector<double> bboxes;  // 4 per annotation (x, y, w, h)
  bool ok = false;
  std::string error;
};

class Scanner {
 public:
  Scanner(const char* data, size_t size) : p_(data), end_(data + size) {}

  bool ok() const { return error_.empty(); }
  const std::string& error() const { return error_; }

  void Fail(const char* msg) {
    if (error_.empty()) {
      error_ = std::string(msg) + " at byte " + std::to_string(Offset());
    }
    p_ = end_;
  }

  size_t Offset() const { return static_cast<size_t>(p_ - start_); }

  void SetStart(const char* s) { start_ = s; }

  void SkipWs() {
    while (p_ < end_ && (*p_ == ' ' || *p_ == '\t' || *p_ == '\n' ||
                         *p_ == '\r'))
      ++p_;
  }

  bool Peek(char c) {
    SkipWs();
    return p_ < end_ && *p_ == c;
  }

  bool Consume(char c) {
    SkipWs();
    if (p_ < end_ && *p_ == c) {
      ++p_;
      return true;
    }
    Fail("expected punctuation");
    return false;
  }

  // Parses a JSON string; when out != nullptr the (unescaped-enough) raw
  // contents are copied — keys never contain escapes in COCO files, and
  // escaped keys simply won't match our field names, which is correct
  // behaviour for a skip-everything-else parser.
  bool String(std::string* out) {
    SkipWs();
    if (p_ >= end_ || *p_ != '"') {
      Fail("expected string");
      return false;
    }
    ++p_;
    const char* begin = p_;
    while (p_ < end_) {
      if (*p_ == '\\') {
        if (p_ + 2 > end_) break;  // dangling escape -> unterminated
        p_ += 2;  // skip the escaped character (incl. \" and \\)
        continue;
      }
      if (*p_ == '"') {
        if (out != nullptr) out->assign(begin, p_ - begin);
        ++p_;
        return true;
      }
      ++p_;
    }
    Fail("unterminated string");
    return false;
  }

  bool Number(double* out) {
    SkipWs();
    // Python's json accepts the non-standard Infinity / -Infinity / NaN
    // literals by default; match it so a skipped field holding one does
    // not fail the whole parse where the pure-Python path succeeds.
    if (ConsumeLiteral("Infinity")) {
      *out = HUGE_VAL;
      return true;
    }
    if (ConsumeLiteral("-Infinity")) {
      *out = -HUGE_VAL;
      return true;
    }
    if (ConsumeLiteral("NaN")) {
      *out = std::nan("");
      return true;
    }
    // std::from_chars is locale-independent (strtod honors LC_NUMERIC, so a
    // host process that setlocale()s to a comma-decimal locale would stop
    // parsing "12.5" at the dot — ADVICE round 2). It also never reads past
    // end_, so the PyBytes null terminator is no longer load-bearing.
    double value = 0.0;
    const auto result = std::from_chars(p_, end_, value);
    if (result.ec == std::errc::result_out_of_range) {
      // Python's json (and strtod) accept overflowing literals like
      // 1e400 as +/-inf; keep that behaviour for path parity.
      value = (*p_ == '-') ? -HUGE_VAL : HUGE_VAL;
    } else if (result.ec != std::errc() || result.ptr == p_) {
      Fail("expected number");
      return false;
    }
    p_ = result.ptr;
    *out = value;
    return true;
  }

  bool ConsumeLiteral(const char* lit) {
    const size_t len = std::strlen(lit);
    if (static_cast<size_t>(end_ - p_) < len) return false;
    if (std::memcmp(p_, lit, len) != 0) return false;
    p_ += len;
    return true;
  }

  // Skips any JSON value (nested arrays/objects included).
  bool SkipValue() {
    SkipWs();
    if (p_ >= end_) {
      Fail("unexpected end of input");
      return false;
    }
    const char c = *p_;
    if (c == '"') return String(nullptr);
    if (c == '{' || c == '[') {
      const char open = c;
      const char close = (c == '{') ? '}' : ']';
      int depth = 0;
      while (p_ < end_) {
        const char ch = *p_;
        if (ch == '"') {
          if (!String(nullptr)) return false;
          continue;
        }
        if (ch == open) ++depth;
        if (ch == close && --depth == 0) {
          ++p_;
          return true;
        }
        ++p_;
      }
      Fail("unterminated array/object");
      return false;
    }
    if (c == 't' || c == 'f' || c == 'n') {  // true / false / null
      while (p_ < end_ &&
             ((*p_ >= 'a' && *p_ <= 'z')))
        ++p_;
      return true;
    }
    double ignored;
    return Number(&ignored);
  }

  const char* p_;
  const char* end_;

 private:
  const char* start_ = nullptr;
  std::string error_;
};

// double -> int64 with an explicit range check: static_cast of an
// out-of-range double is undefined behaviour in C++, and the Python path
// (arbitrary-precision int) would diverge silently anyway.
bool ToInt64(Scanner& s, double v, long long* out) {
  // 2^63 as a double is exact; NaN fails both comparisons (Python's
  // int(float('nan')) raises too).
  if (!(v >= -9223372036854775808.0 && v < 9223372036854775808.0)) {
    s.Fail("integer field out of int64 range");
    return false;
  }
  *out = static_cast<long long>(v);
  return true;
}

// Parses one annotation object, appending to the output arrays.
bool ParseAnnotation(Scanner& s, Parsed& out) {
  if (!s.Consume('{')) return false;
  double image_id = 0, category_id = 0;
  double bbox[4] = {0, 0, 0, 0};
  bool has_image_id = false, has_category_id = false, has_bbox = false;
  if (!s.Peek('}')) {
    std::string key;
    while (true) {
      if (!s.String(&key)) return false;
      if (!s.Consume(':')) return false;
      if (key == "image_id") {
        if (!s.Number(&image_id)) return false;
        has_image_id = true;
      } else if (key == "category_id") {
        if (!s.Number(&category_id)) return false;
        has_category_id = true;
      } else if (key == "bbox") {
        if (!s.Consume('[')) return false;
        int i = 0;
        if (!s.Peek(']')) {
          while (true) {
            double v;
            if (!s.Number(&v)) return false;
            if (i < 4) bbox[i] = v;
            ++i;
            if (s.Peek(',')) {
              s.Consume(',');
              continue;
            }
            break;
          }
        }
        if (!s.Consume(']')) return false;
        // The pure-Python path raises on unpacking a malformed bbox; match
        // it instead of silently zero-filling (ADVICE round 2).
        if (i != 4) {
          s.Fail("bbox array must contain exactly 4 numbers");
          return false;
        }
        has_bbox = true;
      } else {
        if (!s.SkipValue()) return false;
      }
      if (s.Peek(',')) {
        s.Consume(',');
        continue;
      }
      break;
    }
  }
  if (!s.Consume('}')) return false;
  // The pure-Python path raises KeyError on a missing field; a silent
  // zero-fill would diverge (same class of bug as the short-bbox
  // zero-fill the round-2 advisor flagged).
  if (!has_image_id || !has_category_id || !has_bbox) {
    s.Fail("annotation missing image_id/category_id/bbox");
    return false;
  }
  long long image_id_i = 0, category_id_i = 0;
  if (!ToInt64(s, image_id, &image_id_i)) return false;
  if (!ToInt64(s, category_id, &category_id_i)) return false;
  out.image_ids.push_back(image_id_i);
  out.category_ids.push_back(category_id_i);
  out.bboxes.insert(out.bboxes.end(), bbox, bbox + 4);
  return true;
}

Parsed ParseInstances(const char* data, size_t size) {
  Parsed out;
  Scanner s(data, size);
  s.SetStart(data);
  if (!s.Consume('{')) {
    out.error = s.error();
    return out;
  }
  if (!s.Peek('}')) {
    std::string key;
    while (true) {
      if (!s.String(&key) || !s.Consume(':')) break;
      if (key == "annotations") {
        if (!s.Consume('[')) break;
        if (!s.Peek(']')) {
          while (true) {
            if (!ParseAnnotation(s, out)) break;
            if (s.Peek(',')) {
              s.Consume(',');
              continue;
            }
            break;
          }
        }
        if (!s.ok() || !s.Consume(']')) break;
      } else {
        if (!s.SkipValue()) break;
      }
      if (s.Peek(',')) {
        s.Consume(',');
        continue;
      }
      break;
    }
  }
  if (s.ok()) s.Consume('}');
  if (!s.ok()) {
    out.error = s.error();
    return out;
  }
  out.ok = true;
  return out;
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

}  // namespace

extern "C" {

// Parses `size` bytes of a COCO instances file. Returns 0 with *handle
// holding the parsed arrays of *count annotations (copied out and freed by
// vtd_coco_json_take, or freed by vtd_coco_json_free), or an error code
// with its message in `error` (error_size bytes at most, NUL-terminated)
// and *handle null: 1 = malformed JSON or annotation, 2 = out of memory,
// 3 = invalid arguments.
VTD_EXPORT int vtd_coco_json_parse(const char* data, long long size,
                                   void** handle, long long* count,
                                   char* error, int error_size) {
  if (handle == nullptr || count == nullptr) return 3;
  *handle = nullptr;
  *count = 0;
  if (size < 0 || (data == nullptr && size > 0)) {
    CopyError("invalid arguments", error, error_size);
    return 3;
  }
  try {
    Parsed* parsed = new Parsed(ParseInstances(
        size > 0 ? data : "", static_cast<size_t>(size)));
    if (!parsed->ok) {
      CopyError(parsed->error, error, error_size);
      delete parsed;
      return 1;
    }
    *count = static_cast<long long>(parsed->image_ids.size());
    *handle = parsed;
    return 0;
  } catch (const std::bad_alloc&) {
    CopyError("out of memory", error, error_size);
    return 2;
  }
}

// Copies the parsed arrays (int64 image ids and category ids of *count
// entries, float64 (x, y, w, h) boxes of 4 * *count) and frees the handle.
VTD_EXPORT void vtd_coco_json_take(void* handle, long long* image_ids,
                                   long long* category_ids,
                                   double* bboxes) {
  Parsed* parsed = static_cast<Parsed*>(handle);
  if (parsed == nullptr) return;
  const size_t n = parsed->image_ids.size();
  if (n > 0) {
    std::memcpy(image_ids, parsed->image_ids.data(), n * sizeof(long long));
    std::memcpy(category_ids, parsed->category_ids.data(),
                n * sizeof(long long));
    std::memcpy(bboxes, parsed->bboxes.data(), 4 * n * sizeof(double));
  }
  delete parsed;
}

// Frees a handle without copying.
VTD_EXPORT void vtd_coco_json_free(void* handle) {
  delete static_cast<Parsed*>(handle);
}

}  // extern "C"
