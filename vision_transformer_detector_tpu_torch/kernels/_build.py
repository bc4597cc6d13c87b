"""Builds the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file is compiled on its own by ``nvcc`` for Hopper
(``sm_90a``) into a library with a plain C interface, which the kernel
wrappers load with ``ctypes``. Nothing is built when a module is imported:
the first CUDA call of a wrapper builds its library. The output lands in
``vision_transformer_detector_tpu_torch/build/`` under a name that carries
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so a changed source or header is never served from a stale library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")

# -Xptxas -v reports registers, shared memory and spills per kernel; the
# report is kept in BUILD_LOGS.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()          # guards the dicts below
_source_locks: dict = {}          # one lock per source: builds overlap
_libraries: dict = {}
BUILD_LOGS: dict = {}


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin; "
        "the CUDA kernels are built from csrc/ at first use")


def _digest(source: str) -> str:
    h = hashlib.sha256()
    headers = sorted(os.path.join(CSRC_DIR, name)
                     for name in os.listdir(CSRC_DIR) if name.endswith(".cuh"))
    for path in [source, *headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(source_name: str) -> str:
    """Where ``csrc/<source_name>``'s library is (or will be) built: the name
    carries the digest of the source, the headers and the flags."""
    stem = os.path.splitext(source_name)[0]
    digest = _digest(os.path.join(CSRC_DIR, source_name))
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def load_library(source_name: str) -> ctypes.CDLL:
    """Compile ``csrc/<source_name>`` once and return the loaded library."""
    with _lock:
        source_lock = _source_locks.setdefault(source_name, threading.Lock())
    with source_lock:
        lib = _libraries.get(source_name)
        if lib is not None:
            return lib
        source = os.path.join(CSRC_DIR, source_name)
        stem = os.path.splitext(source_name)[0]
        path = library_path(source_name)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            # Build under a private name, then rename: another process
            # building at the same time never loads a half-written file.
            tmp = os.path.join(BUILD_DIR, f".{stem}-{os.getpid()}.so")
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {source} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
            with _lock:
                BUILD_LOGS[source_name] = proc.stdout + proc.stderr
        lib = ctypes.CDLL(path)
        with _lock:
            _libraries[source_name] = lib
        return lib


def raise_on_error(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.vtd_cuda_error_string(err).decode()} (cudaError {err})")


def load_libraries(source_names) -> list:
    """``load_library`` for each source, all nvcc runs started together."""
    names = list(source_names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(load_library, names))
