"""``match_image``: the native COCO matcher (native/coco_eval.cc of this
package), numpy in and numpy out.

The counterpart of the JAX package's ``_native_coco_eval`` extension, over
the core's C interface; the core builds at its first use
(``_native/__init__.py``) and ``ctypes`` releases the GIL for the call.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import load

_F64 = 8


def _library():
    lib = load("coco_eval")
    if lib is None:
        return None
    if not getattr(lib, "_vtd_typed", False):
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.vtd_coco_match_image.argtypes = [
            ptr, i64, ptr, ptr, ptr, i64, ptr, i64, ptr, i64, ptr, ptr, ptr]
        lib.vtd_coco_match_image.restype = ctypes.c_int
        lib._vtd_typed = True
    return lib


def available() -> bool:
    """True when the core is built (building it at the first call)."""
    return _library() is not None


def match_image(det_boxes, gt_boxes, gt_iscrowd, gt_areas, area_ranges,
                thresholds):
    """Greedy COCO matching for one (image, category) across all area
    ranges and IoU thresholds -> ``(matched, ignored, n_positive)``: uint8
    ``(A * T * M,)`` masks, (area range, threshold, detection) in C order,
    and int64 ``(A,)``.

    C-contiguous buffers: det_boxes float64 (M, 4) score-sorted descending
    (the caller sorts and caps); gt_boxes float64 (G, 4); gt_iscrowd
    uint8 / bool (G,); gt_areas float64 (G,); area_ranges float64 (A, 2);
    thresholds float64 (T,)."""
    lib = _library()
    if lib is None:
        raise RuntimeError("the native COCO matcher core is not built")
    raw = [np.frombuffer(b, np.uint8) for b in (
        det_boxes, gt_boxes, gt_iscrowd, gt_areas, area_ranges, thresholds)]
    lens = [r.nbytes for r in raw]
    if (lens[0] % (4 * _F64) or lens[1] % (4 * _F64) or lens[3] % _F64
            or lens[4] % (2 * _F64) or lens[5] % _F64):
        raise ValueError("buffer sizes are not multiples of their element "
                         "layouts")
    num_dt, num_gt = lens[0] // (4 * _F64), lens[1] // (4 * _F64)
    num_a, num_t = lens[4] // (2 * _F64), lens[5] // _F64
    if lens[2] != num_gt or lens[3] != num_gt * _F64:
        raise ValueError("ground-truth buffers disagree on length")
    matched = np.empty(num_a * num_t * num_dt, np.uint8)
    ignored = np.empty_like(matched)
    n_positive = np.empty(num_a, np.int64)
    p = [r.ctypes.data for r in raw]
    code = lib.vtd_coco_match_image(
        p[0], num_dt, p[1], p[2], p[3], num_gt, p[4], num_a, p[5], num_t,
        matched.ctypes.data, ignored.ctypes.data, n_positive.ctypes.data)
    if code == 2:
        raise MemoryError("native COCO matcher: out of memory")
    if code != 0:
        raise ValueError(f"native COCO matcher: invalid arguments ({code})")
    return matched, ignored, n_positive
