"""``parse_instances``: the native COCO instances-JSON parser
(native/coco_json.cc of this package), numpy out.

The counterpart of the JAX package's ``_native_coco_json`` extension, over
the core's C interface; the core builds at its first use
(``_native/__init__.py``) and ``ctypes`` releases the GIL for the parse.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import load

_ERROR_BYTES = 512
_CODES = {2: MemoryError, 3: ValueError}


def _library():
    lib = load("coco_json")
    if lib is None:
        return None
    if not getattr(lib, "_vtd_typed", False):
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.vtd_coco_json_parse.argtypes = [
            ctypes.c_char_p, i64, ctypes.POINTER(ptr),
            ctypes.POINTER(i64), ctypes.c_char_p, ctypes.c_int]
        lib.vtd_coco_json_parse.restype = ctypes.c_int
        lib.vtd_coco_json_take.argtypes = [ptr, ptr, ptr, ptr]
        lib.vtd_coco_json_take.restype = None
        lib.vtd_coco_json_free.argtypes = [ptr]
        lib.vtd_coco_json_free.restype = None
        lib._vtd_typed = True
    return lib


def available() -> bool:
    """True when the core is built (building it at the first call)."""
    return _library() is not None


def parse_instances(data: bytes):
    """COCO instances JSON bytes -> ``(image_ids, category_ids, bboxes,
    n)``: int64 ``(n,)``, int64 ``(n,)`` and float64 ``(4 n,)`` (x, y, w, h
    per annotation) arrays of the file's annotations, in file order.
    Raises ValueError on malformed JSON, a short bbox, a missing field or
    an id outside the int64 range, and RuntimeError when the core is not
    built."""
    if not isinstance(data, bytes):
        raise TypeError(f"parse_instances takes bytes, got "
                        f"{type(data).__name__}")
    lib = _library()
    if lib is None:
        raise RuntimeError("the native COCO JSON core is not built")
    handle = ctypes.c_void_p()
    count = ctypes.c_longlong()
    error = ctypes.create_string_buffer(_ERROR_BYTES)
    code = lib.vtd_coco_json_parse(data, len(data), ctypes.byref(handle),
                                   ctypes.byref(count), error, _ERROR_BYTES)
    message = error.value.decode(errors="replace")
    if code != 0:
        raise _CODES.get(code, ValueError)(
            f"COCO JSON parse failed: {message}")
    n = count.value
    try:
        image_ids = np.empty(n, np.int64)
        category_ids = np.empty(n, np.int64)
        bboxes = np.empty(4 * n, np.float64)
    except BaseException:
        lib.vtd_coco_json_free(handle)
        raise
    lib.vtd_coco_json_take(handle, image_ids.ctypes.data,
                           category_ids.ctypes.data, bboxes.ctypes.data)
    return image_ids, category_ids, bboxes, n
