"""torch.export artifacts of the port (vision_transformer_detector_tpu_torch/
export.py) against the live model and against the JAX package's StableHLO
artifacts, on the CPU: the twins of tests/test_export.py, the same weights
through params.npz, a loader that never imports the model code, and the
kernels' custom operators (kernels/ops.py) as far as a machine without a
card can hold them: their fake implementations on meta tensors and their
refusal of CPU tensors."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu import config as jax_config
from vision_transformer_detector_tpu import export as jax_export
from vision_transformer_detector_tpu.models.vit_detector import (
    init_params as jax_init)
from vision_transformer_detector_tpu.utils.checkpoint import (
    save_params_npz as jax_save_npz)
from vision_transformer_detector_tpu_torch import config as port_config
from vision_transformer_detector_tpu_torch import export as port_export
from vision_transformer_detector_tpu_torch.models.vit_detector import forward
from vision_transformer_detector_tpu_torch.ops.decode import (
    transform_predictions)
from vision_transformer_detector_tpu_torch.ops.nms import (
    postprocess_detections)
from vision_transformer_detector_tpu_torch.utils.checkpoint import (
    load_params_npz)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_FIELDS = dict(
    image_size=(34, 34), embedding_dim=8, num_heads=2, key_dim=4,
    encoder_blocks=2, encoder_mlp_layers=2, head_last_units=8, head_layers=2)
TINY = port_config.DetectorConfig(**TINY_FIELDS)
JAX_TINY = jax_config.DetectorConfig(**TINY_FIELDS)
TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_export.py's tolerance


def _bridge(tmp_path, jax_cfg, port_cfg, seed=0):
    """JAX-initialised weights and the same weights in the port."""
    params = jax_init(jax.random.PRNGKey(seed), jax_cfg)
    path = str(tmp_path / f"bridge_{seed}.npz")
    jax_save_npz(path, params)
    return params, load_params_npz(path, port_cfg)


def _images(shape, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _live(model, images, config):
    with torch.no_grad():
        return transform_predictions(
            forward(model, torch.from_numpy(images), config), config)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return _bridge(tmp_path_factory.mktemp("weights"), JAX_TINY, TINY)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory, weights):
    path = str(tmp_path_factory.mktemp("export") / "model")
    port_export.save_exported(path, weights[1], TINY, batch_size=2,
                              device="cpu")
    return path, weights[1]


BAKED_SPEC = {"k": 6, "score_threshold": -1.0}


@pytest.fixture(scope="module")
def bundle(tmp_path_factory, weights):
    """A [1, 4] bundle of plain graphs and one with a baked postprocess,
    shared by the tests below."""
    root = tmp_path_factory.mktemp("bundles")
    plain, baked = str(root / "plain"), str(root / "baked")
    port_export.save_exported(plain, weights[1], TINY, batch_size=[1, 4],
                              device="cpu")
    port_export.save_exported(baked, weights[1], TINY, batch_size=[1, 4],
                              device="cpu", postprocess=BAKED_SPEC)
    return {"plain": plain, "baked": baked}


def test_export_roundtrip_exact(artifact):
    path, model = artifact
    detector = port_export.load_exported(path)
    assert detector.batch_size == 2
    assert detector.config == TINY
    assert detector.device == torch.device("cpu")
    images = _images((2, 34, 34, 3))
    np.testing.assert_allclose(detector(images).numpy(),
                               _live(model, images, TINY).numpy(), **TOL)


def test_export_rejects_wrong_batch(artifact):
    detector = port_export.load_exported(artifact[0])
    with pytest.raises(ValueError, match="exceeds the largest"):
        detector(np.zeros((3, 34, 34, 3), np.float32))


def test_export_multi_scale_head_params_roundtrip(tmp_path):
    fields = dict(image_size=(64, 64), patch_size=16, embedding_dim=8,
                  num_heads=2, key_dim=4, encoder_blocks=1,
                  encoder_mlp_layers=1, head_last_units=8, head_layers=1,
                  head_scales=(1, 2))
    cfg = port_config.DetectorConfig(**fields)
    _, model = _bridge(tmp_path, jax_config.DetectorConfig(**fields), cfg)
    path = str(tmp_path / "model")
    port_export.save_exported(path, model, cfg, batch_size=1, device="cpu")
    images = _images((1, 64, 64, 3))
    np.testing.assert_allclose(
        port_export.load_exported(path)(images).numpy(),
        _live(model, images, cfg).numpy(), **TOL)


def test_export_bundle_routes_by_request_size(bundle, weights):
    path = bundle["plain"]
    detector = port_export.load_exported(path)
    assert detector.batch_sizes == (1, 4)
    assert sorted(os.listdir(path)) == ["config.json", "model_b1.pt2",
                                        "model_b4.pt2", "params.npz"]
    images = _images((3, 34, 34, 3))
    want = _live(weights[1], images, TINY).numpy()
    got = detector(images)          # request 3 -> padded to graph 4
    assert got.shape == (3, TINY.max_objects, 6)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(detector(images[:1]).numpy(), want[:1],
                               **TOL)
    with pytest.raises(ValueError):
        detector(np.zeros((5, 34, 34, 3), np.float32))


def test_export_baked_postprocess_roundtrip(bundle, weights):
    detector = port_export.load_exported(bundle["baked"])
    assert detector.postprocess == port_export.normalize_postprocess(
        BAKED_SPEC)
    images = _images((3, 34, 34, 3))
    want = postprocess_detections(_live(weights[1], images, TINY), k=6,
                                  score_threshold=-1.0)
    got = detector(images)          # request 3 -> padded to graph 4
    assert isinstance(got, tuple) and len(got) == 4
    assert [tuple(t.shape) for t in got] == [(3, 6), (3, 6), (3, 6, 4),
                                             (3, 6)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   **TOL)


def test_normalize_postprocess_rejects_unknown_keys():
    assert port_export.normalize_postprocess(None) is None
    assert port_export.normalize_postprocess({}) == {
        "k": 17, "iou_threshold": 0.5, "score_threshold": 0.0,
        "per_class": True}
    with pytest.raises(ValueError, match="unknown postprocess"):
        port_export.normalize_postprocess({"topk": 5})


def test_reexport_clears_stale_graphs(tmp_path, weights):
    path = str(tmp_path / "reuse")
    model = weights[1]
    port_export.save_exported(path, model, TINY, batch_size=[1],
                              device="cpu")
    assert port_export.load_exported(path).batch_sizes == (1,)
    port_export.save_exported(path, model, TINY, batch_size=2, device="cpu")
    assert port_export.load_exported(path).batch_sizes == (2,)
    port_export.save_exported(path, model, TINY, batch_size=[8],
                              device="cpu")
    assert port_export.load_exported(path).batch_sizes == (8,)
    assert sorted(os.listdir(path)) == ["config.json", "model_b8.pt2",
                                        "params.npz"]


def test_export_crash_before_swap_preserves_old_artifact(tmp_path,
                                                         monkeypatch,
                                                         weights):
    from vision_transformer_detector_tpu_torch.utils import checkpoint

    path = str(tmp_path / "artifact")
    port_export.save_exported(path, weights[1], TINY, batch_size=1,
                              device="cpu")
    before = {name: os.path.getmtime(os.path.join(path, name))
              for name in os.listdir(path)}

    def boom(path_, params_):
        raise RuntimeError("disk full")

    monkeypatch.setattr(checkpoint, "save_params_npz", boom)
    _, other = _bridge(tmp_path, JAX_TINY, TINY, seed=1)
    with pytest.raises(RuntimeError, match="disk full"):
        port_export.save_exported(path, other, TINY, batch_size=1,
                                  device="cpu")
    for name, mtime in before.items():
        assert os.path.getmtime(os.path.join(path, name)) == mtime
    x = np.zeros((1, 34, 34, 3), np.float32)
    np.testing.assert_allclose(port_export.load_exported(path)(x).numpy(),
                               _live(weights[1], x, TINY).numpy(), atol=1e-4)


def test_exported_detector_normalizes_any_integer_dtype(artifact):
    detector = port_export.load_exported(artifact[0])
    pixels = np.random.default_rng(3).integers(0, 255, (2, 34, 34, 3))
    out_u8 = detector(pixels.astype(np.uint8)).numpy()
    np.testing.assert_allclose(detector(pixels.astype(np.int32)).numpy(),
                               out_u8, atol=1e-6)
    np.testing.assert_allclose(detector(pixels).numpy(), out_u8, atol=1e-6)
    np.testing.assert_allclose(
        out_u8, detector(pixels.astype(np.float32) / 127.5 - 1.0).numpy(),
        atol=1e-5)


# ---------------------------------------------------------------------------
# The port's artifact against the JAX package's


@pytest.mark.parametrize("baked", [False, True])
def test_port_artifact_matches_the_jax_artifact(tmp_path, weights, bundle,
                                                baked):
    """The same weights exported by both packages: decoded outputs within
    1e-4; with a baked postprocess, class ids and valid equal and scores
    and boxes within 1e-4. And params.npz equal key for key."""
    jax_params, model = weights
    spec = BAKED_SPEC if baked else None
    jax_dir = str(tmp_path / "jax")
    port_dir = bundle["baked" if baked else "plain"]
    jax_export.save_exported(jax_dir, jax_params, JAX_TINY,
                             batch_size=[1, 4], postprocess=spec)
    images = _images((3, 34, 34, 3), seed=7)
    want = jax_export.load_exported(jax_dir)(jnp.asarray(images))
    got = port_export.load_exported(port_dir)(images)
    if not baked:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        scores, classes, boxes, valid = got
        np.testing.assert_array_equal(classes.numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(want[3]))
        np.testing.assert_allclose(scores.numpy(), np.asarray(want[0]), **TOL)
        np.testing.assert_allclose(boxes.numpy(), np.asarray(want[2]), **TOL)
    with np.load(os.path.join(jax_dir, "params.npz")) as a, \
            np.load(os.path.join(port_dir, "params.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    with open(os.path.join(port_dir, "config.json")) as f:
        payload = json.load(f)
    assert payload["device"] == "cpu"
    assert payload.get("postprocess") == (
        port_export.normalize_postprocess(spec))


def test_loader_refuses_another_device_type(artifact, tmp_path):
    with pytest.raises(ValueError, match="exported on cpu"):
        port_export.load_exported(artifact[0], device="cuda")
    with pytest.raises(ValueError, match="traced on one of"):
        port_export.save_exported(str(tmp_path / "x"), artifact[1], TINY,
                                  batch_size=1, device="meta")


def test_int8_model_is_not_exported(weights):
    from vision_transformer_detector_tpu_torch.kernels.quantization import (
        quantize_params)

    with pytest.raises(ValueError, match="int8"):
        port_export.export_inference(quantize_params(weights[1]), TINY, 1,
                                     device="cpu")


def test_serving_from_an_artifact_never_imports_the_model_code(
        tmp_path, weights, bundle):
    """A process that serves an artifact (ExportedDetectionService, baked
    or not) loads no ``models`` module, and its detections are the live
    service's."""
    from vision_transformer_detector_tpu_torch.serving import (
        DetectionService)

    baked, plain = bundle["baked"], bundle["plain"]
    canvases = np.random.default_rng(2).integers(0, 256, (2, 34, 34, 3),
                                                 dtype=np.uint8)
    np.save(tmp_path / "canvases.npy", canvases)
    script = (
        "import json, sys, warnings\n"
        "import numpy as np\n"
        "from vision_transformer_detector_tpu_torch.serving import "
        "ExportedDetectionService\n"
        f"canvases = np.load({str(tmp_path / 'canvases.npy')!r})\n"
        "out = {}\n"
        f"for name, path in (('baked', {baked!r}), ('plain', {plain!r})):\n"
        "    with warnings.catch_warnings(record=True) as caught:\n"
        "        warnings.simplefilter('always')\n"
        "        service = ExportedDetectionService(path, k=6, "
        "score_threshold=-1.0)\n"
        "    out[name] = {'dets': service.detect_array(canvases),\n"
        "                 'max_batch': service.max_batch_size,\n"
        "                 'warned': len(caught)}\n"
        "out['models'] = sorted(m for m in sys.modules if '.models' in m)\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["models"] == []
    assert result["baked"]["max_batch"] == result["plain"]["max_batch"] == 4
    assert result["baked"]["warned"] == 0
    live = DetectionService(TINY, weights[1], device="cpu", k=6,
                            score_threshold=-1.0).detect_array(canvases)
    for name in ("baked", "plain"):
        dets = result[name]["dets"]
        assert [len(d) for d in dets] == [len(d) for d in live]
        for got_image, want_image in zip(dets, live):
            for g, w in zip(got_image, want_image):
                assert g["class_id"] == w["class_id"]
                assert g["score"] == pytest.approx(w["score"], abs=1e-4)
                for key in ("cx", "cy", "h", "w"):
                    assert g["box"][key] == pytest.approx(w["box"][key],
                                                          abs=1e-3)


def test_baked_artifact_warns_on_other_serve_settings(bundle):
    from vision_transformer_detector_tpu_torch.serving import (
        ExportedDetectionService)

    with pytest.warns(UserWarning, match="baked postprocess"):
        service = ExportedDetectionService(bundle["baked"], k=17)
    assert service.predict_raw(np.zeros((1, 34, 34, 3), np.uint8)).shape == (
        1, 6, 7)


# ---------------------------------------------------------------------------
# The custom operators (kernels/ops.py)

def _op_cases(size):
    """(op name, meta args, plain version's output(s) on CPU tensors)."""
    from vision_transformer_detector_tpu_torch.kernels import (
        flash_attention as fa, fused_ffn, fused_ln, quantization as qz)

    b, h, n, k = size
    m, d, out = b * n, 128 * h, 3 * h + 5
    gen = torch.Generator().manual_seed(0)

    def cpu(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dtype)

    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        q, kk, v, g = (cpu(b, h, n, k, dtype=dtype) for _ in range(4))
        lse = cpu(b, h, n)
        plain_fwd = (fa.reference_attention(q, kk, v, "bhnk"),
                     fa.reference_attention_lse(q, kk, "bhnk"))
        # The dropout seed is a one-element uint32 tensor, which the kernel
        # reads on the device; None without dropout.
        seed = torch.empty(1, dtype=torch.uint32, device="meta")
        # The last two outputs are a ring attention block's suspended
        # state, empty otherwise.
        no_state = (torch.empty(0), torch.empty(0))
        cases.append(("flash_attention_fwd",
                      (meta(q), meta(kk), meta(v), "bhnk", True, None, 0.0),
                      plain_fwd + no_state))
        cases.append(("flash_attention_fwd",
                      (meta(q), meta(kk), meta(v), "bhnk", False, seed, 0.1),
                      (plain_fwd[0], torch.empty(0)) + no_state))
        dq, dk, dv = fa.reference_attention_backward(q, kk, v, g, "bhnk")
        # By default (dq_fp32) the operator hands dq over in its fp32
        # accumulator; the wrapper asks for q's dtype instead.
        cases.append(("flash_attention_bwd",
                      tuple(map(meta, (q, kk, v, g, lse, lse)))
                      + ("bhnk", None, 0.0), (dq.float(), dk, dv)))
        x, gamma, beta = cpu(m, d, dtype=dtype), cpu(d), cpu(d)
        cases.append(("layer_norm", (meta(x), meta(gamma), meta(beta), 1e-3),
                      fused_ln.layer_norm_reference(x, gamma, beta)))
        x, w, bias = cpu(m, d, dtype=dtype), cpu(d, out, dtype=dtype), \
            cpu(out, dtype=dtype)
        cases.append(("dense_mish", (meta(x), meta(w), meta(bias), True, 0),
                      fused_ffn.dense_mish_reference(x, w, bias)))
    codes = torch.randint(-127, 128, (d, out), generator=gen,
                          dtype=torch.int8)
    scale, bias, x = cpu(out).abs(), cpu(out), cpu(m, d,
                                                   dtype=torch.bfloat16)
    for name, out_dtype in (("fused_int8_dense", torch.bfloat16),
                            ("int8_dense", torch.float32)):
        cases.append((name, (meta(x), meta(codes), None, meta(scale),
                             meta(bias), False, 0),
                      qz.int8_dense_reference(x, codes, scale, bias,
                                              out_dtype=out_dtype)))
    return cases


@pytest.mark.parametrize("size", [(1, 2, 17, 64), (2, 3, 65, 48)])
def test_fake_implementations_give_the_plain_versions_shapes(size):
    for name, args, plain in _op_cases(size):
        got = getattr(torch.ops.vtd_torch, name)(*args)
        got = got if isinstance(got, tuple) else (got,)
        plain = plain if isinstance(plain, tuple) else (plain,)
        assert len(got) == len(plain), name
        for g, p in zip(got, plain):
            assert g.device.type == "meta", name
            assert (tuple(g.shape), g.dtype) == (tuple(p.shape), p.dtype), (
                name, tuple(g.shape), g.dtype, tuple(p.shape), p.dtype)


def test_every_operator_refuses_cpu_tensors():
    """No CPU implementation is registered, so nothing falls back: the
    wrappers choose the plain version for CPU tensors before an operator
    is reached."""
    cases = _op_cases((1, 2, 17, 64))
    assert {name for name, _, _ in cases} == {
        "flash_attention_fwd", "flash_attention_bwd", "layer_norm",
        "dense_mish", "fused_int8_dense", "int8_dense"}
    for name, args, _ in cases:
        cpu_args = tuple(
            torch.zeros(a.shape, dtype=a.dtype) if torch.is_tensor(a) else a
            for a in args)
        with pytest.raises(NotImplementedError):
            getattr(torch.ops.vtd_torch, name)(*cpu_args)
