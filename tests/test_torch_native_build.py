"""The port's loader of its native host cores (_native/__init__.py): built
at first use, not at import, into the build directory under a digest of
source, compiler and flags; a failed build tried once per process and
digest (a stamp keeps later processes from trying again); ``build(force=
True)`` clears the stamp and rebuilds; a changed source is never served
from a stale library.

The counterpart of tests/test_native_autobuild.py. Each test builds into
its own temporary directory with the loader's process record emptied, so
the shared build directory of the other tests is never touched.
"""

import json
import os
import shutil
import stat
import subprocess
import sys
import threading

import pytest

from vision_transformer_detector_tpu_torch import _native
from vision_transformer_detector_tpu_torch._native import (
    _native_coco_eval, _native_pipeline)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def loader(tmp_path, monkeypatch):
    """The loader on a fresh build directory and an empty process record
    (a new process, as far as the loader can tell)."""
    build = tmp_path / "build"
    monkeypatch.setattr(_native, "BUILD_DIR", str(build))
    monkeypatch.setattr(_native, "_resolved", {})
    monkeypatch.setattr(_native, "_errors", {})
    return build


def _new_process(monkeypatch):
    monkeypatch.setattr(_native, "_resolved", {})
    monkeypatch.setattr(_native, "_errors", {})


@pytest.fixture
def failing_compiler(tmp_path, monkeypatch):
    """A compiler that fails the way a host without jpeglib.h does and
    counts its runs in a file."""
    count = tmp_path / "runs"
    script = tmp_path / "c++"
    script.write_text(
        "#!/bin/sh\n"
        f"echo run >> {count}\n"
        "echo 'pipeline.cc:18:10: fatal error: jpeglib.h: No such file or "
        "directory' >&2\n"
        "exit 1\n")
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_native, "find_compiler", lambda: str(script))

    def runs():
        return len(count.read_text().split()) if count.exists() else 0
    return runs


def test_nothing_builds_at_import():
    """Importing the consumers (and the whole package's native wrappers)
    loads no core and runs no compiler."""
    script = (
        "import json\n"
        "from vision_transformer_detector_tpu_torch import _native\n"
        "from vision_transformer_detector_tpu_torch.data import "
        "annotations, pipeline\n"
        "from vision_transformer_detector_tpu_torch.metrics import "
        "coco_eval\n"
        "from vision_transformer_detector_tpu_torch import cli, serving\n"
        "print(json.dumps(sorted(_native._resolved)))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert "native core" not in proc.stderr


def test_first_use_builds_into_the_build_dir(loader, capfd):
    lib = _native.load("coco_eval")
    assert lib is not None and _native.error("coco_eval") is None
    names = os.listdir(loader)
    assert len(names) == 1
    assert names[0].startswith("libcoco_eval-") and names[0].endswith(".so")
    assert len(names[0][len("libcoco_eval-"):-len(".so")]) == 16
    err = capfd.readouterr().err
    assert err.count("native core coco_eval built") == 1
    # Loaded once: the next calls neither build nor print.
    assert _native.load("coco_eval") is lib and _native_coco_eval.available()
    assert capfd.readouterr().err == ""


def test_a_built_core_loads_in_a_new_process_without_building(
        loader, monkeypatch):
    assert _native.load("coco_eval") is not None
    _new_process(monkeypatch)
    monkeypatch.setattr(_native, "_compile", lambda *a: pytest.fail(
        "a built core was compiled again"))
    assert _native.load("coco_eval") is not None


def test_a_failed_build_is_tried_once_per_process(loader, failing_compiler,
                                                  capfd):
    """Decode worker threads asking for a core that does not build: one
    compiler run, one line on stderr, and the reason kept."""
    results = []
    threads = [threading.Thread(target=lambda: results.append(
        _native_pipeline.available())) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == [False] * 8
    assert not _native_pipeline.available()
    assert failing_compiler() == 1
    assert "jpeglib.h" in _native.error("pipeline")
    lines = [line for line in capfd.readouterr().err.splitlines()
             if "native core" in line]
    assert len(lines) == 1 and "not built" in lines[0]
    with pytest.raises(RuntimeError, match="not built"):
        _native_pipeline.decode_letterbox(b"", 8, 8)


def test_the_stamp_stops_later_processes(loader, failing_compiler,
                                         monkeypatch):
    assert _native.load("pipeline") is None
    stamps = [n for n in os.listdir(loader) if n.endswith(".failed")]
    assert len(stamps) == 1 and stamps[0].startswith("libpipeline-")
    _new_process(monkeypatch)
    assert _native.load("pipeline") is None
    assert failing_compiler() == 1
    assert _native.error("pipeline").startswith("previous build failed")
    assert "jpeglib.h" in _native.error("pipeline")


def test_a_read_only_build_dir_is_tried_once_per_process(
        tmp_path, monkeypatch, capfd):
    """A build directory that cannot be written (here: below a file):
    the build fails, no stamp can be left, and this process does not try
    again; a new process tries once more."""
    blocker = tmp_path / "checkout"
    blocker.write_text("a file, not a directory")
    monkeypatch.setattr(_native, "BUILD_DIR", str(blocker / "build"))
    _new_process(monkeypatch)
    calls = []
    compile_once = _native._compile
    monkeypatch.setattr(_native, "_compile", lambda *a: calls.append(1)
                        or compile_once(*a))
    assert _native.load("coco_json") is None
    assert _native.load("coco_json") is None
    assert len(calls) == 1 and _native.error("coco_json")
    assert capfd.readouterr().err.count("native core coco_json not built") \
        == 1
    _new_process(monkeypatch)
    assert _native.load("coco_json") is None and len(calls) == 2


def test_force_clears_the_stamp_and_rebuilds(loader, failing_compiler,
                                             monkeypatch):
    assert _native.load("coco_json") is None
    assert any(n.endswith(".failed") for n in os.listdir(loader))
    monkeypatch.setattr(_native, "find_compiler",
                        lambda: shutil.which("c++") or shutil.which("g++"))
    report = _native.build(force=True)
    assert report == {core: {"built": True, "error": None}
                      for core in ("coco_json", "coco_eval", "pipeline")}
    assert not any(n.endswith(".failed") for n in os.listdir(loader))
    # Without force, a second build() builds nothing more.
    before = sorted(os.listdir(loader))
    assert _native.build() == report and sorted(os.listdir(loader)) == before


def test_a_changed_source_is_never_served_from_a_stale_library(
        loader, tmp_path, monkeypatch, failing_compiler):
    """The library's name carries the digest of its source: an edited
    source builds anew (and a stamp of the old digest does not stop it)."""
    sources = tmp_path / "native"
    shutil.copytree(_native.SOURCE_DIR, sources)
    monkeypatch.setattr(_native, "SOURCE_DIR", str(sources))
    assert _native.load("coco_eval") is None        # the failing compiler
    monkeypatch.setattr(_native, "find_compiler",
                        lambda: shutil.which("c++") or shutil.which("g++"))
    _new_process(monkeypatch)
    assert _native.load("coco_eval") is not None
    first = {n for n in os.listdir(loader) if n.endswith(".so")}
    with open(sources / "coco_eval.cc", "a") as f:
        f.write("\n// edited\n")
    _new_process(monkeypatch)
    assert _native.load("coco_eval") is not None
    libraries = {n for n in os.listdir(loader) if n.endswith(".so")}
    assert len(first) == 1 and len(libraries) == 2 and first < libraries


@pytest.mark.parametrize("missing", ["source", "compiler"])
def test_a_missing_source_or_compiler_is_a_reason(loader, tmp_path,
                                                  monkeypatch, missing):
    if missing == "source":
        monkeypatch.setattr(_native, "SOURCE_DIR", str(tmp_path / "none"))
    else:
        monkeypatch.setattr(_native, "find_compiler", lambda: None)
    assert _native.load("coco_json") is None
    assert missing in _native.error("coco_json")
    assert not os.path.exists(loader)
    with pytest.raises(KeyError):
        _native.load("no_such_core")
