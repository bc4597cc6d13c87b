"""Builds and loads the port's native host cores at first use.

The three cores are the port's own copies of the JAX package's
native/*.cc: ``coco_json`` (the single-pass COCO instances-JSON parser),
``coco_eval`` (the COCO matcher, bit-equal to the NumPy one) and
``pipeline`` (libjpeg decode + letterbox). Their sources are
``vision_transformer_detector_tpu_torch/native/*.cc``, with a plain C
interface of pointers and sizes; the thin wrappers ``_native_coco_json``,
``_native_coco_eval`` and ``_native_pipeline`` of this package call them
through ``ctypes`` (which releases the GIL for the call). They are
performance cores: each caller has a Python path for a host where a core
does not build (the decode core needs libjpeg's ``jpeglib.h``).

Nothing is built when a module is imported. ``load(core)`` builds the
core with the host C++ compiler the first time it is needed, into
``vision_transformer_detector_tpu_torch/build/`` (beside the CUDA
libraries of kernels/_build.py), under a name that carries a digest of the
source, the compiler and the flags, so an edited source is never served
from a stale library. The library is written under a private name and
renamed into place, so a process building at the same time never loads a
half-written file.

A build that fails is tried once per process and source digest, never
again per call or per decode worker thread: the failure is kept in this
process, and a stamp beside the build (``lib<core>-<digest>.failed``,
when the directory is writable) keeps later processes from trying again.
Each attempt prints one line on stderr, whether it built or failed.
``build(force=True)`` (``vtd-torch doctor --build-native``) clears the
stamps and builds every core again.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(PACKAGE_DIR, "native")
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")

CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-fvisibility=hidden",
             "-pthread")
# core -> (source, libraries it links)
CORES = {
    "coco_json": ("coco_json.cc", ()),
    "coco_eval": ("coco_eval.cc", ()),
    "pipeline": ("pipeline.cc", ("-ljpeg",)),
}

_lock = threading.Lock()
_resolved: dict = {}   # core -> loaded CDLL, or None once it failed
_errors: dict = {}     # core -> one-line reason of the failure
_UNSET = object()


def find_compiler() -> str | None:
    """The host C++ compiler: $CXX, else c++, g++ or clang++ on PATH."""
    candidates = [os.environ.get("CXX")] if os.environ.get("CXX") else []
    for name in candidates + ["c++", "g++", "clang++"]:
        found = shutil.which(name)
        if found:
            return found
    return None


def _command(core: str, compiler: str, output: str) -> list:
    source, libs = CORES[core]
    return [compiler, *CXX_FLAGS, "-o", output,
            os.path.join(SOURCE_DIR, source), *libs]


def _digest(core: str, compiler: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(SOURCE_DIR, CORES[core][0]), "rb") as f:
        h.update(f.read())
    h.update(" ".join(_command(core, compiler, "")).encode())
    return h.hexdigest()[:16]


def _paths(core: str, digest: str) -> tuple:
    """(library, failure stamp) of one core at one digest."""
    base = os.path.join(BUILD_DIR, f"lib{core}-{digest}")
    return base + ".so", base + ".failed"


def _announce(message: str) -> None:
    print(f"vision_transformer_detector_tpu_torch: {message}",
          file=sys.stderr, flush=True)


def _compile(core: str, compiler: str, library: str) -> str | None:
    """Compile one core into ``library``; None on success, else the reason
    (one line)."""
    tmp = os.path.join(BUILD_DIR, f".{core}-{os.getpid()}-"
                                  f"{threading.get_ident()}.so")
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        proc = subprocess.run(_command(core, compiler, tmp),
                              capture_output=True, text=True, timeout=600)
        if proc.returncode == 0:
            os.replace(tmp, library)
            return None
        lines = [line for line in (proc.stderr or proc.stdout).splitlines()
                 if "error" in line] or (proc.stderr or proc.stdout
                                         ).splitlines() or ["no output"]
        return f"{os.path.basename(compiler)} exit {proc.returncode}: " \
               f"{lines[0].strip()}"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"{type(exc).__name__}: {exc}"
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def load(core: str) -> ctypes.CDLL | None:
    """The loaded library of ``core``, built at its first use in this
    process; None when it cannot be built (``error(core)`` says why). The
    first call settles it for the process: a failure is not tried again,
    nor, through its stamp, by later processes at the same digest."""
    lib = _resolved.get(core, _UNSET)
    if lib is not _UNSET:
        return lib
    if core not in CORES:
        raise KeyError(f"unknown native core {core!r}; one of "
                       f"{sorted(CORES)}")
    with _lock:
        if core not in _resolved:
            lib, reason = _resolve(core)
            _resolved[core] = lib
            if reason is not None:
                _errors[core] = reason
        return _resolved[core]


def _resolve(core: str) -> tuple:
    """(library, None) or (None, reason): load the built library of the
    current digest, else build it unless a stamp says it failed."""
    if not os.path.exists(os.path.join(SOURCE_DIR, CORES[core][0])):
        return None, "C++ source not present"
    compiler = find_compiler()
    if compiler is None:
        return None, "no C++ compiler ($CXX, c++, g++ or clang++)"
    library, stamp = _paths(core, _digest(core, compiler))
    if not os.path.exists(library):
        if os.path.exists(stamp):
            with open(stamp) as f:
                return None, ("previous build failed: "
                              + (f.read().strip() or "no reason kept"))
        reason = _compile(core, compiler, library)
        if reason is not None:
            try:
                with open(stamp, "w") as f:
                    f.write(reason + "\n")
            except OSError:
                pass    # a read-only build directory: this process only
            _announce(f"native core {core} not built ({reason}); the "
                      "Python path runs instead")
            return None, reason
        _announce(f"native core {core} built: {library}")
    try:
        return ctypes.CDLL(library), None
    except OSError as exc:
        return None, f"cannot load {library}: {exc}"


def error(core: str) -> str | None:
    """Why ``core`` is not loaded, once ``load`` tried; else None."""
    return _errors.get(core)


def status() -> dict:
    """{core: {"built": bool, "error": reason or None}}, building each core
    that was not tried yet."""
    return {core: {"built": load(core) is not None, "error": error(core)}
            for core in CORES}


def build(force: bool = False) -> dict:
    """Build every core that is not built and return ``status()``;
    ``force`` removes the built libraries and the stamps, forgets this
    process's record and builds them all again."""
    if force:
        with _lock:
            _resolved.clear()
            _errors.clear()
            names = (os.listdir(BUILD_DIR) if os.path.isdir(BUILD_DIR)
                     else [])
            for name in names:
                if name.startswith(tuple(f"lib{core}-" for core in CORES)):
                    try:
                        os.remove(os.path.join(BUILD_DIR, name))
                    except OSError:
                        pass
    return status()
