"""``decode_letterbox`` and ``decode_letterbox_batch``: the native JPEG
decode + letterbox core (native/pipeline.cc of this package), numpy out.

The counterpart of the JAX package's ``_native_pipeline`` extension, over
the core's C interface; the core builds at its first use
(``_native/__init__.py``; it needs libjpeg's ``jpeglib.h``) and ``ctypes``
releases the GIL for the decode, so a pool of Python threads decodes in
parallel.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import load

_ERROR_BYTES = 512


def _library():
    lib = load("pipeline")
    if lib is None:
        return None
    if not getattr(lib, "_vtd_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vtd_decode_letterbox.argtypes = [
            ptr, i64, i32, i32, i32, ptr, ptr, ctypes.c_char_p, i32]
        lib.vtd_decode_letterbox.restype = i32
        lib.vtd_decode_letterbox_batch.argtypes = [
            ptr, ptr, i64, i32, i32, i32, i32, ptr, ptr,
            ctypes.POINTER(i64), ctypes.c_char_p, i32]
        lib.vtd_decode_letterbox_batch.restype = i32
        lib._vtd_typed = True
    return lib


def available() -> bool:
    """True when the core is built (building it at the first call)."""
    return _library() is not None


def _built_library():
    lib = _library()
    if lib is None:
        raise RuntimeError("the native JPEG decode core is not built")
    return lib


def _check_target(target_h: int, target_w: int) -> None:
    if target_h <= 0 or target_w <= 0:
        raise ValueError("target size must be positive")


def decode_letterbox(data, target_h: int, target_w: int,
                     scaled: bool = False):
    """JPEG bytes -> ``(canvas, orig_h, orig_w)``: the uint8 ``(target_h,
    target_w, 3)`` letterboxed canvas and the image's size. ``scaled``
    decodes at the smallest libjpeg M/8 scale that covers the resize
    target. Raises ValueError on bytes libjpeg cannot decode."""
    _check_target(target_h, target_w)
    lib = _built_library()
    src = np.frombuffer(data, np.uint8)
    canvas = np.empty((target_h, target_w, 3), np.uint8)
    orig = np.empty(2, np.intc)
    error = ctypes.create_string_buffer(_ERROR_BYTES)
    code = lib.vtd_decode_letterbox(
        src.ctypes.data, src.size, target_h, target_w, int(bool(scaled)),
        canvas.ctypes.data, orig.ctypes.data, error, _ERROR_BYTES)
    if code != 0:
        raise ValueError(error.value.decode(errors="replace"))
    return canvas, int(orig[0]), int(orig[1])


def decode_letterbox_batch(images, target_h: int, target_w: int,
                           num_threads: int, scaled: bool = False):
    """decode_letterbox of each of ``images`` (a sequence of bytes) on
    ``num_threads`` native threads (0: one per hardware thread) -> a list
    of ``(canvas, orig_h, orig_w)``. Raises ValueError for the first image,
    in order, that cannot be decoded."""
    _check_target(target_h, target_w)
    lib = _built_library()
    for item in images:
        if not isinstance(item, bytes):
            raise TypeError(f"expected a sequence of bytes, got "
                            f"{type(item).__name__}")
    srcs = [np.frombuffer(item, np.uint8) for item in images]
    n = len(srcs)
    pointers = (ctypes.c_void_p * max(n, 1))(*[s.ctypes.data for s in srcs])
    sizes = np.array([s.size for s in srcs] or [0], np.int64)
    canvases = np.empty((n, target_h, target_w, 3), np.uint8)
    orig = np.empty((max(n, 1), 2), np.intc)
    failed = ctypes.c_longlong(-1)
    error = ctypes.create_string_buffer(_ERROR_BYTES)
    code = lib.vtd_decode_letterbox_batch(
        pointers, sizes.ctypes.data, n, target_h, target_w, num_threads,
        int(bool(scaled)), canvases.ctypes.data, orig.ctypes.data,
        ctypes.byref(failed), error, _ERROR_BYTES)
    if code != 0:
        raise ValueError(error.value.decode(errors="replace"))
    return [(canvases[i], int(orig[i, 0]), int(orig[i, 1]))
            for i in range(n)]
