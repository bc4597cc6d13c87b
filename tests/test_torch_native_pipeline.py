"""The port's native JPEG decode + letterbox core (native/pipeline.cc of
vision_transformer_detector_tpu_torch) against the PIL path and against
the JAX package's built core, on the same seeded JPEGs.

The counterpart of tests/test_native_pipeline.py: the same contract
(letterbox geometry, PIL fallback for CMYK, the scaled decode, the
decode-bomb cap), and the port's canvases and original sizes byte for
byte those of the JAX package's core. The core builds on this host (it
has jpeglib.h) at its first use.
"""

import io

import numpy as np
import pytest

from vision_transformer_detector_tpu._native import (
    _native_pipeline as jax_native)
from vision_transformer_detector_tpu.data import pipeline as jax_pipeline
from vision_transformer_detector_tpu_torch.config import DetectorConfig
from vision_transformer_detector_tpu_torch._native import (
    _native_pipeline as native)
from vision_transformer_detector_tpu_torch.data import pipeline


def _gradient(shape, rng=None):
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([yy * 255 // h, xx * 255 // w,
                    ((yy + xx) * 255) // (h + w)], axis=-1).astype(np.uint8)
    if rng is not None:
        img[h // 5:h // 2, w // 3:w // 2] = rng.integers(0, 255, 3,
                                                         np.uint8)
    return img


def _make_jpeg(tmp_path, shape=(48, 64), name="000000000042.jpg",
               quality=95):
    from PIL import Image

    path = tmp_path / name
    Image.fromarray(_gradient(shape, np.random.default_rng(0))).save(
        path, quality=quality)
    return str(path)


def _jpeg_bytes(shape, seed, quality=90):
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = _gradient(shape, rng)
    img = np.clip(img.astype(int) + rng.integers(-20, 20, img.shape), 0,
                  255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def test_native_decode_shapes(tmp_path):
    assert pipeline.native_available()
    path = _make_jpeg(tmp_path)
    cfg = DetectorConfig(image_size=(64, 64))
    canvas, (oh, ow) = pipeline.load_and_letterbox_image(
        path, cfg, normalize=False, use_native=True)
    assert canvas.shape == (64, 64, 3)
    assert canvas.dtype == np.uint8
    assert (oh, ow) == (48, 64)
    # Letterbox: 48x64 -> 48x64 resized, pad rows (64-48)//2=8 top/bottom.
    assert canvas[:8].max() == 0 and canvas[-8:].max() == 0
    assert canvas[8:-8].max() > 0


def test_native_close_to_pil(tmp_path):
    path = _make_jpeg(tmp_path)
    cfg = DetectorConfig(image_size=(96, 96))
    native_img, native_size = pipeline.load_and_letterbox_image(
        path, cfg, normalize=False, use_native=True)
    pil_img, pil_size = pipeline.load_and_letterbox_image(
        path, cfg, normalize=False, use_native=False)
    assert native_size == pil_size
    # Same decode (both libjpeg); the resize filters differ (half-pixel
    # bilinear against PIL's triangle): a bounded pixel difference.
    diff = np.abs(native_img.astype(int) - pil_img.astype(int))
    assert float(np.mean(diff)) < 8.0
    assert np.mean(diff > 32) < 0.05


@pytest.mark.parametrize("target", [(64, 64), (96, 128), (608, 608),
                                    (1024, 1024)])
@pytest.mark.parametrize("scaled", [False, True])
def test_native_canvas_equals_the_jax_core(target, scaled):
    """Seeded JPEGs of several sizes, letterboxed by both packages' cores:
    the same canvas bytes and original size."""
    th, tw = target
    for seed, shape in enumerate(((48, 64), (480, 640), (333, 211),
                                  (17, 300))):
        data = _jpeg_bytes(shape, seed)
        canvas, oh, ow = native.decode_letterbox(data, th, tw, scaled)
        ref, rh, rw = jax_native.decode_letterbox(data, th, tw, scaled)
        assert (oh, ow) == (rh, rw) == shape
        assert canvas.shape == (th, tw, 3) and canvas.dtype == np.uint8
        assert canvas.tobytes() == ref


@pytest.mark.parametrize("threads", [1, 3, 0])
def test_native_batch_equals_the_jax_core(threads):
    blobs = [_jpeg_bytes((48 + 16 * i, 64 + 8 * i), i) for i in range(7)]
    for scaled in (False, True):
        got = native.decode_letterbox_batch(blobs, 96, 96, threads, scaled)
        want = jax_native.decode_letterbox_batch(blobs, 96, 96, threads,
                                                 scaled)
        assert len(got) == len(want) == 7
        for (canvas, oh, ow), (ref, rh, rw) in zip(got, want):
            assert (oh, ow) == (rh, rw)
            assert canvas.tobytes() == ref
        single = [native.decode_letterbox(b, 96, 96, scaled)
                  for b in blobs]
        assert all(a[0].tobytes() == b[0].tobytes() and a[1:] == b[1:]
                   for a, b in zip(got, single))
    assert native.decode_letterbox_batch([], 96, 96, threads) == []


def test_native_batch_decode(tmp_path):
    paths = [_make_jpeg(tmp_path, name=f"{i:012d}.jpg") for i in range(4)]
    blobs = [open(p, "rb").read() for p in paths]
    results = native.decode_letterbox_batch(blobs, 64, 64, 2)
    assert len(results) == 4
    for canvas, oh, ow in results:
        assert (oh, ow) == (48, 64)
        assert canvas[8:-8].max() > 0


def test_native_invalid_jpeg_raises_as_the_jax_core():
    messages = []
    for core in (native, jax_native):
        with pytest.raises(ValueError) as exc:
            core.decode_letterbox(b"not a jpeg", 64, 64)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]
    # The batch names the first image, in order, that fails.
    good = _jpeg_bytes((40, 40), 0)
    batch = []
    for core in (native, jax_native):
        with pytest.raises(ValueError) as exc:
            core.decode_letterbox_batch([good, b"\xff\xd8 bad", b"bad"],
                                        32, 32, 2)
        batch.append(str(exc.value))
    assert batch[0] == batch[1]


def test_native_refuses_a_target_that_is_not_positive():
    with pytest.raises(ValueError, match="target size must be positive"):
        native.decode_letterbox(_jpeg_bytes((40, 40), 0), 0, 64)
    with pytest.raises(ValueError, match="target size must be positive"):
        native.decode_letterbox_batch([_jpeg_bytes((40, 40), 0)], 64, -1, 1)
    with pytest.raises(TypeError):
        native.decode_letterbox_batch(["not bytes"], 64, 64, 1)


def test_dataset_uses_native(tmp_path):
    """The file pipeline end-to-end with the native decoder."""
    path = _make_jpeg(tmp_path)
    cfg = DetectorConfig(image_size=(64, 64))
    annotations = {"42": [[1, 32.0, 24.0, 10.0, 10.0, 100.0]]}
    ds = pipeline.CocoDetectionDataset([path], annotations, cfg,
                                       batch_size=1)
    images, labels = next(iter(ds))
    assert images.shape == (1, 64, 64, 3)
    assert labels[0, 0, 0] == 1


def test_pipeline_equals_the_jax_pipeline_on_the_native_cores(tmp_path):
    """load_and_letterbox_image of both packages, each on its own core:
    the same canvas (normalized and not) and original size."""
    from vision_transformer_detector_tpu.config import (
        DetectorConfig as JaxConfig)

    path = _make_jpeg(tmp_path, shape=(120, 90))
    for size in ((96, 96), (64, 128)):
        for normalize in (False, True):
            got = pipeline.load_and_letterbox_image(
                path, DetectorConfig(image_size=size), normalize=normalize,
                use_native=True)
            want = jax_pipeline.load_and_letterbox_image(
                path, JaxConfig(image_size=size), normalize=normalize,
                use_native=True)
            assert got[1] == want[1]
            np.testing.assert_array_equal(got[0], want[0])


def test_native_letterbox_geometry_random_sizes(tmp_path):
    """Randomized source / target sizes: the native resize and pad land
    where the Python path computes them (nearbyint ties-to-even == Python
    round; offsets (t - r) // 2): pads zero, content inside."""
    from PIL import Image

    rng = np.random.default_rng(3)
    for trial in range(12):
        oh, ow = int(rng.integers(8, 200)), int(rng.integers(8, 200))
        th, tw = int(rng.integers(32, 128)), int(rng.integers(32, 128))
        path = tmp_path / f"geom{trial}.jpg"
        Image.fromarray(np.full((oh, ow, 3), 255, np.uint8)).save(
            path, quality=100)
        cfg = DetectorConfig(image_size=(th, tw))
        canvas, size = pipeline.load_and_letterbox_image(
            str(path), cfg, normalize=False, use_native=True)
        assert size == (oh, ow)
        scale = max(oh / th, ow / tw)
        rh = max(1, round(oh / scale))
        rw = max(1, round(ow / scale))
        top, left = (th - rh) // 2, (tw - rw) // 2
        nz_rows = np.where(canvas.max(axis=(1, 2)) > 0)[0]
        nz_cols = np.where(canvas.max(axis=(0, 2)) > 0)[0]
        msg = f"trial {trial}: {oh}x{ow} -> {th}x{tw} (r {rh}x{rw})"
        assert nz_rows[0] == top and nz_rows[-1] == top + rh - 1, msg
        assert nz_cols[0] == left and nz_cols[-1] == left + rw - 1, msg


def test_cmyk_jpeg_falls_back_to_pil(tmp_path):
    """libjpeg cannot color-convert CMYK scans to RGB: the loader falls
    back to PIL instead of raising, and corrupt bytes still raise."""
    from PIL import Image

    path = tmp_path / "cmyk.jpg"
    Image.new("CMYK", (40, 30), (10, 200, 30, 5)).save(path, format="JPEG")
    cfg = DetectorConfig(image_size=(32, 32))
    with pytest.raises(ValueError):
        native.decode_letterbox(path.read_bytes(), 32, 32)
    canvas, (oh, ow) = pipeline.load_and_letterbox_image(
        str(path), cfg, use_native=True)
    assert (oh, ow) == (30, 40)
    assert canvas.shape == (32, 32, 3)
    corrupt = tmp_path / "bad.jpg"
    corrupt.write_bytes(b"\xff\xd8 definitely not a jpeg")
    with pytest.raises(pipeline.CorruptImageError):
        pipeline.load_and_letterbox_image(str(corrupt), cfg,
                                          use_native=True)


def test_use_native_without_the_core_takes_pil(tmp_path, monkeypatch):
    """As in the JAX pipeline, a missing decode core means PIL, whatever
    ``use_native`` asks."""
    path = _make_jpeg(tmp_path)
    cfg = DetectorConfig(image_size=(96, 96))
    pil = pipeline.load_and_letterbox_image(path, cfg, normalize=False,
                                            use_native=False)
    monkeypatch.setattr(native, "available", lambda: False)
    for flag in (None, True):
        got = pipeline.load_and_letterbox_image(path, cfg, normalize=False,
                                                use_native=flag)
        assert got[1] == pil[1]
        np.testing.assert_array_equal(got[0], pil[0])


def _make_big_jpeg(tmp_path, shape=(480, 640), name="000000000777.jpg"):
    from PIL import Image

    path = tmp_path / name
    Image.fromarray(_gradient(shape)).save(path, quality=92)
    return str(path)


def test_fast_decode_noop_when_no_scaling_engages(tmp_path):
    """A target within 8/8 of the source (608 px from 480 x 640): the
    scaled path is bit-identical to the exact one."""
    path = _make_big_jpeg(tmp_path)
    cfg = DetectorConfig(image_size=(608, 608))
    exact, size_e = pipeline.load_and_letterbox_image(
        path, cfg, normalize=False, use_native=True)
    fast, size_f = pipeline.load_and_letterbox_image(
        path, cfg, normalize=False, use_native=True, fast_decode=True)
    assert size_e == size_f == (480, 640)
    assert np.array_equal(exact, fast)


@pytest.mark.parametrize("target", [96, 224])
def test_fast_decode_geometry_exact_pixels_close(tmp_path, target):
    """A small canvas from a large source: scaling engages; the geometry
    keys off the full header dims, so it matches the exact path, and the
    pixel values drift only by the resampling chain."""
    path = _make_big_jpeg(tmp_path)
    cfg = DetectorConfig(image_size=(target, target))
    exact, size_e = pipeline.load_and_letterbox_image(
        path, cfg, normalize=False, use_native=True)
    fast, size_f = pipeline.load_and_letterbox_image(
        path, cfg, normalize=False, use_native=True, fast_decode=True)
    assert size_e == size_f == (480, 640)
    assert np.array_equal(exact.max(axis=(1, 2)) > 0,
                          fast.max(axis=(1, 2)) > 0)
    assert np.array_equal(exact.max(axis=(0, 2)) > 0,
                          fast.max(axis=(0, 2)) > 0)
    diff = np.abs(exact.astype(int) - fast.astype(int))
    assert float(diff.mean()) < 2.0
    assert int(diff.max()) <= 24


def test_fast_decode_rejects_huge_header_bomb():
    """The decoded-size cap keys off the full header dims in scaled mode
    too: a crafted 65500 x 65500 header is refused either way."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(buf, "JPEG")
    data = bytearray(buf.getvalue())
    i = data.find(b"\xff\xc0")
    assert i > 0, "no SOF0 marker in the fixture JPEG"
    data[i + 5:i + 7] = (65500).to_bytes(2, "big")   # height
    data[i + 7:i + 9] = (65500).to_bytes(2, "big")   # width
    bomb = bytes(data)
    for scaled in (False, True):
        with pytest.raises(ValueError, match="dimensions too large"):
            native.decode_letterbox(bomb, 224, 224, scaled)
        with pytest.raises(ValueError, match="dimensions too large"):
            native.decode_letterbox_batch([bomb], 224, 224, 1, scaled)
