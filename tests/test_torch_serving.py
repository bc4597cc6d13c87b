"""PyTorch DetectionService vs the JAX one, behind the shared HTTP server.

Both services get the same weights (JAX params -> save_params_npz -> the
port's bridge) and the same JPEG bytes, and run on the CPU: the JAX one
with the flash kernel in interpret mode, the port with its plain
attention version.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
import textwrap
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from vision_transformer_detector_tpu.config import DetectorConfig
from vision_transformer_detector_tpu.models.vit_detector import init_params
from vision_transformer_detector_tpu.serving import (
    DetectionService as JaxDetectionService)
from vision_transformer_detector_tpu.utils.checkpoint import save_params_npz
from vision_transformer_detector_tpu_torch import cli
from vision_transformer_detector_tpu_torch.models import vit_detector as model
from vision_transformer_detector_tpu_torch.serving import (
    BatchingDetectionService, DetectionServer, DetectionService)
from vision_transformer_detector_tpu_torch.utils.checkpoint import (
    load_params_npz)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = DetectorConfig(
    image_size=(64, 64), patch_size=16, embedding_dim=32, num_heads=2,
    key_dim=64, encoder_blocks=2, encoder_mlp_layers=2, head_last_units=16,
    head_layers=2, use_flash_attention=True)
# Scores and boxes (pixels) after an fp32 forward whose sums run in
# another order on each side.
TOL = 1e-4


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    params = init_params(jax.random.PRNGKey(0), CFG)
    path = str(tmp_path_factory.mktemp("weights") / "params.npz")
    save_params_npz(path, params)
    port = DetectionService(CFG, load_params_npz(path, CFG), device="cpu",
                            score_threshold=-1.0)
    reference = JaxDetectionService(CFG, params, score_threshold=-1.0)
    return port, reference


def _jpeg(shape, seed):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, shape, np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("shape,seed", [((48, 96, 3), 0), ((80, 64, 3), 1)])
def test_detect_jpeg_matches_jax_service(services, shape, seed, monkeypatch):
    """Both services are held to the PIL decode core (the native cores
    are held bit-equal in tests/test_torch_native_pipeline.py)."""
    from vision_transformer_detector_tpu.data import pipeline as jax_pipeline
    from vision_transformer_detector_tpu_torch.data import (
        pipeline as port_pipeline)

    monkeypatch.setattr(jax_pipeline, "_native_pipeline", None)
    monkeypatch.setattr(port_pipeline, "native_available", lambda: False)
    port, reference = services
    data = _jpeg(shape, seed)
    np.testing.assert_array_equal(port.letterbox_jpeg(data)[0],
                                  reference.letterbox_jpeg(data)[0])
    got = port.detect_jpeg(data)
    want = reference.detect_jpeg(data)
    assert got["image_size"] == want["image_size"]
    assert want["detections"]
    _assert_same_detections(got["detections"], want["detections"])


def _assert_same_detections(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["class_id"] == w["class_id"]
        assert g["class_name"] == w["class_name"]
        assert abs(g["score"] - w["score"]) <= TOL
        for key in ("cx", "cy", "h", "w"):
            assert abs(g["box"][key] - w["box"][key]) <= TOL


def test_packed_output_is_one_device_tensor(services):
    port, _ = services
    images = np.random.default_rng(3).integers(0, 256, (3, 64, 64, 3),
                                               np.uint8)
    packed = port.predict_raw(images)
    assert isinstance(packed, torch.Tensor)
    assert tuple(packed.shape) == (3, 17, 7) and packed.dtype == torch.float32
    via_tensor = port.raw_to_detections(packed)
    array = packed.numpy()
    via_tuple = port.raw_to_detections(
        (array[..., 0], array[..., 1].astype(np.int32), array[..., 2:6],
         array[..., 6] > 0.5))
    assert via_tensor == via_tuple


def test_http_round_trip_and_batching(services):
    port, _ = services
    server = DetectionServer(port, port=0)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}
        req = urllib.request.Request(f"{base}/predict",
                                     data=_jpeg((32, 40, 3), 4),
                                     headers={"Content-Type": "image/jpeg"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            result = json.loads(r.read())
        assert result["image_size"] == {"height": 32, "width": 40}
        assert result["detections"]
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            assert json.loads(r.read())["requests"]["ok"] == 1
    finally:
        server.stop()

    batcher = BatchingDetectionService(port, max_batch=4, max_wait_ms=50)
    try:
        canvases = [np.full((64, 64, 3), 40 * i, np.uint8) for i in range(4)]
        results = [None] * 4

        def submit(i):
            results[i] = batcher.submit(canvases[i], timeout=60)

        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        # A batch of 4 and a batch of 1 block their matmuls differently.
        for canvas, dets in zip(canvases, results):
            _assert_same_detections(dets, port.detect_array(canvas[None])[0])
    finally:
        batcher.stop()


def test_cuda_request_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = model.init_params(CFG, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="is_available"):
        DetectionService(CFG, params, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        model.init_params(CFG, torch.Generator().manual_seed(0),
                          device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["serve", "--preset", "tiny_96", "--device", "cuda"])


@pytest.mark.parametrize("flag", [["--from-export", "dir", "--int8"],
                                  ["--from-export", "dir", "--params-npz",
                                   "params.npz"]])
def test_cli_refuses_unported_flags(flag):
    """`serve --from-export` serves the artifact's own weights: the model
    flags of `serve` that it cannot honour are refused, as in the JAX CLI,
    before anything is loaded."""
    with pytest.raises(SystemExit, match="cannot honour"):
        cli.main(["serve", "--device", "cpu", *flag])


def test_cli_serve_int8_quantizes_after_loading(tmp_path, monkeypatch):
    """`serve --int8 --fused-ffn` quantizes the loaded weights (as the JAX
    CLI does) and sets the fused dense+mish flag; the service answers."""
    from vision_transformer_detector_tpu.kernels.quantization import (
        quantize_params)
    from vision_transformer_detector_tpu_torch.kernels import quantization

    params = init_params(jax.random.PRNGKey(6), CFG)
    path = str(tmp_path / "params.npz")
    save_params_npz(path, params)
    served = {}
    monkeypatch.setattr(cli, "_serve", lambda args, service: served.update(
        args=args, service=service))
    monkeypatch.setattr(cli, "get_config", lambda name: CFG)
    cli.main(["serve", "--params-npz", path, "--device", "cpu", "--int8",
              "--fused-ffn"])
    service = served["service"]
    assert service.config == CFG.replace(use_fused_ffn=True)
    assert quantization.is_quantized(service.params.encoder[0].mha.query)
    np.testing.assert_array_equal(
        service.params.head_output.kernel_q.numpy(),
        np.asarray(quantize_params(params)["head_output"]["kernel_q"]))
    assert len(service.detect_array(np.zeros((1, 64, 64, 3), np.uint8))[0]
               ) <= service.k


def test_cli_serve_loads_params_npz(tmp_path, monkeypatch):
    """`serve --params-npz` builds a service on the carried-over weights
    and hands it to the port's HTTP loop (stubbed here)."""
    config = DetectorConfig(
        image_size=(96, 96), patch_size=16, embedding_dim=16, num_heads=2,
        key_dim=8, encoder_blocks=2, encoder_mlp_layers=3,
        head_last_units=16, head_layers=2)          # the tiny_96 preset
    params = init_params(jax.random.PRNGKey(5), config)
    path = str(tmp_path / "params.npz")
    save_params_npz(path, params)
    served = {}
    monkeypatch.setattr(cli, "_serve",
                        lambda args, service: served.update(
                            args=args, service=service))
    cli.main(["serve", "--preset", "tiny_96", "--params-npz", path,
              "--device", "cpu", "--port", "0", "--score-threshold", "0.1"])
    service = served["service"]
    assert isinstance(service, DetectionService)
    # The port's own DetectorConfig, field for field the JAX one.
    assert dataclasses.asdict(service.config) == dataclasses.asdict(config)
    assert service.score_threshold == 0.1
    assert served["args"].port == 0
    np.testing.assert_array_equal(
        service.params.head_output.kernel.detach().numpy(),
        np.asarray(params["head_output"]["kernel"]))


def test_cli_config_flags():
    parse = cli.build_parser().parse_args
    config = cli._build_config(parse(
        ["serve", "--preset", "vit_b16_384", "--no-flash-attention"]))
    assert config.compute_dtype == "bfloat16"
    assert not config.use_flash_attention
    config = cli._build_config(parse(["serve", "--bf16", "--flash-attention"]))
    assert config.compute_dtype == "bfloat16" and config.use_flash_attention
    assert parse(["serve"]).device == "cuda"
    with pytest.raises(SystemExit):
        cli._build_config(parse(
            ["serve", "--flash-attention", "--no-flash-attention"]))


def test_port_serves_without_importing_jax():
    script = textwrap.dedent("""
        import io, json, sys
        import numpy as np, torch
        from PIL import Image
        from vision_transformer_detector_tpu_torch import DetectorConfig
        from vision_transformer_detector_tpu_torch.models.vit_detector \\
            import init_params
        from vision_transformer_detector_tpu_torch.serving import (
            DetectionServer, DetectionService)
        cfg = DetectorConfig(image_size=(64, 64), patch_size=16,
                             embedding_dim=16, num_heads=2, key_dim=8,
                             encoder_blocks=1, encoder_mlp_layers=2,
                             head_last_units=16, head_layers=2,
                             use_flash_attention=True)
        service = DetectionService(
            cfg, init_params(cfg, torch.Generator().manual_seed(0)),
            device="cpu", score_threshold=-1.0)
        buf = io.BytesIO()
        Image.fromarray(np.zeros((20, 30, 3), np.uint8)).save(buf, "JPEG")
        result = service.detect_jpeg(buf.getvalue())
        print(json.dumps({"jax": "jax" in sys.modules,
                          "detections": len(result["detections"])}))
    """)
    # The child decodes with the port's native core when it builds, else
    # PIL.
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"jax": False, "detections": 17}
