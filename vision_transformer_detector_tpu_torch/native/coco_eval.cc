// Native core of the official-protocol COCO evaluator: the PyTorch port's
// own copy.
//
// metrics/coco_eval.py implements pycocotools-COCOeval semantics in
// NumPy; its cost at scale is per-call Python overhead, tens of thousands
// of (image, category) calls of a few dozen tiny-array NumPy ops each.
// This core replaces the per-(image, category) inner work (the IoU
// matrix, the per-area-range ignore / stable reorder, and the greedy COCO
// matcher over all IoU thresholds) with ONE C call that fills the match /
// ignore masks of every area range at once.
//
// Bit parity: all arithmetic is IEEE double in the same operation order as
// the NumPy path (iou_xywh / _match_image in metrics/coco_eval.py), so the
// results are exactly equal (tests/test_torch_coco_eval.py,
// tests/test_torch_native_coco_json.py).
//
// The anonymous namespace below is native/coco_eval.cc's, statement for
// statement (tests/test_torch_native_build.py holds the two equal). In
// place of that file's CPython glue this copy has a plain C interface of
// pointers and sizes, loaded with ctypes by
// vision_transformer_detector_tpu_torch/_native/_native_coco_eval.py.
// Built at first use with the host C++ compiler (_native/__init__.py).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

// The copied core counts in CPython's signed size type, which is ptrdiff_t.
using Py_ssize_t = std::ptrdiff_t;

namespace {

// Greedy COCO match for one (image, category): fills matched/ignored
// masks of shape (A, T, M) and n_positive of shape (A,).
void MatchImage(const double* det_boxes, Py_ssize_t num_dt,
                const double* gt_boxes, const unsigned char* gt_iscrowd,
                const double* gt_areas, Py_ssize_t num_gt,
                const double* area_ranges, Py_ssize_t num_a,
                const double* thresholds, Py_ssize_t num_t,
                unsigned char* matched_out, unsigned char* ignored_out,
                int64_t* npos_out) {
  // IoU matrix in the ORIGINAL ground-truth order (crowd columns use
  // intersection / detection-area, the maskUtils.iou convention).
  std::vector<double> ious(static_cast<size_t>(num_dt * num_gt), 0.0);
  std::vector<double> det_areas(static_cast<size_t>(num_dt), 0.0);
  for (Py_ssize_t d = 0; d < num_dt; ++d) {
    const double dx0 = det_boxes[d * 4 + 0];
    const double dy0 = det_boxes[d * 4 + 1];
    const double dw = det_boxes[d * 4 + 2];
    const double dh = det_boxes[d * 4 + 3];
    const double dx1 = dx0 + dw;
    const double dy1 = dy0 + dh;
    const double det_area = dw * dh;
    det_areas[d] = det_area;
    for (Py_ssize_t g = 0; g < num_gt; ++g) {
      const double gx0 = gt_boxes[g * 4 + 0];
      const double gy0 = gt_boxes[g * 4 + 1];
      const double gw = gt_boxes[g * 4 + 2];
      const double gh = gt_boxes[g * 4 + 3];
      const double iw =
          std::max(std::min(dx1, gx0 + gw) - std::max(dx0, gx0), 0.0);
      const double ih =
          std::max(std::min(dy1, gy0 + gh) - std::max(dy0, gy0), 0.0);
      const double inter = iw * ih;
      const double gt_area = gw * gh;
      const double uni =
          gt_iscrowd[g] ? det_area : det_area + gt_area - inter;
      ious[d * num_gt + g] = uni > 0.0 ? inter / uni : 0.0;
    }
  }

  std::vector<unsigned char> gt_ignore(static_cast<size_t>(num_gt), 0);
  std::vector<Py_ssize_t> order(static_cast<size_t>(num_gt), 0);
  std::vector<unsigned char> gt_matched(static_cast<size_t>(num_t * num_gt),
                                        0);
  for (Py_ssize_t a = 0; a < num_a; ++a) {
    const double lo = area_ranges[a * 2 + 0];
    const double hi = area_ranges[a * 2 + 1];
    int64_t npos = 0;
    for (Py_ssize_t g = 0; g < num_gt; ++g) {
      gt_ignore[g] =
          gt_iscrowd[g] || gt_areas[g] < lo || gt_areas[g] > hi ? 1 : 0;
      if (!gt_ignore[g]) ++npos;
    }
    npos_out[a] = npos;
    // Stable non-ignored-first order (np.argsort(gt_ignore, stable)).
    Py_ssize_t pos = 0;
    for (Py_ssize_t g = 0; g < num_gt; ++g)
      if (!gt_ignore[g]) order[pos++] = g;
    for (Py_ssize_t g = 0; g < num_gt; ++g)
      if (gt_ignore[g]) order[pos++] = g;

    std::fill(gt_matched.begin(), gt_matched.end(), 0);
    unsigned char* matched_a = matched_out + a * num_t * num_dt;
    unsigned char* ignored_a = ignored_out + a * num_t * num_dt;
    for (Py_ssize_t t = 0; t < num_t; ++t) {
      for (Py_ssize_t d = 0; d < num_dt; ++d) {
        double best = std::min(thresholds[t], 1.0 - 1e-10);
        Py_ssize_t match = -1;  // index into `order`
        for (Py_ssize_t oi = 0; oi < num_gt; ++oi) {
          const Py_ssize_t g = order[oi];
          if (gt_matched[t * num_gt + oi] && !gt_iscrowd[g]) continue;
          // Once a real (non-ignored) match is held, ignored candidates
          // cannot improve it — and they are sorted last.
          if (match > -1 && !gt_ignore[order[match]] && gt_ignore[g]) break;
          const double iou = ious[d * num_gt + g];
          if (iou < best) continue;
          best = iou;
          match = oi;
        }
        if (match == -1) continue;
        matched_a[t * num_dt + d] = 1;
        ignored_a[t * num_dt + d] = gt_ignore[order[match]];
        gt_matched[t * num_gt + match] = 1;
      }
    }
    // Unmatched detections whose own area falls outside the range are
    // ignored (they would be matched under a different range).
    for (Py_ssize_t d = 0; d < num_dt; ++d) {
      const bool out = det_areas[d] < lo || det_areas[d] > hi;
      if (!out) continue;
      for (Py_ssize_t t = 0; t < num_t; ++t)
        if (!matched_a[t * num_dt + d]) ignored_a[t * num_dt + d] = 1;
    }
  }
}

}  // namespace

#define VTD_EXPORT __attribute__((visibility("default")))

extern "C" {

// Greedy COCO match for one (image, category) across all area ranges and
// IoU thresholds. det_boxes float64 (num_dt, 4) score-sorted descending
// (the caller sorts and caps); gt_boxes float64 (num_gt, 4); gt_iscrowd
// uint8 (num_gt,); gt_areas float64 (num_gt,); area_ranges float64
// (num_a, 2); thresholds float64 (num_t,). Fills matched and ignored, uint8
// (num_a, num_t, num_dt), zeroed here first, and n_positive, int64
// (num_a,). Returns 0, 2 when out of memory, 3 on a negative count.
VTD_EXPORT int vtd_coco_match_image(
    const double* det_boxes, long long num_dt, const double* gt_boxes,
    const unsigned char* gt_iscrowd, const double* gt_areas,
    long long num_gt, const double* area_ranges, long long num_a,
    const double* thresholds, long long num_t, unsigned char* matched,
    unsigned char* ignored, int64_t* n_positive) {
  if (num_dt < 0 || num_gt < 0 || num_a < 0 || num_t < 0) return 3;
  const size_t mask_len =
      static_cast<size_t>(num_a) * static_cast<size_t>(num_t) *
      static_cast<size_t>(num_dt);
  if (mask_len > 0) {
    std::memset(matched, 0, mask_len);
    std::memset(ignored, 0, mask_len);
  }
  try {
    MatchImage(det_boxes, num_dt, gt_boxes, gt_iscrowd, gt_areas, num_gt,
               area_ranges, num_a, thresholds, num_t, matched, ignored,
               n_positive);
  } catch (const std::bad_alloc&) {
    return 2;
  }
  return 0;
}

}  // extern "C"
