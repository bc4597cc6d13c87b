"""The port's .keras converter (tools/convert_tf_checkpoint_torch.py)
against the JAX package's (tools/convert_tf_checkpoint.py).

On tests/test_convert.py's synthetic reference-named archives (every
variant that test_convert_roundtrip runs, with constant-scale and glorot
weights) the port's tool, which builds its target from the port's model
and imports no JAX, writes the .npz that the JAX tool writes: the same
names, dtypes, shapes and bits. It refuses a Keras 3 archive and the
multi-scale head, and converts ``head_scales=[1]`` (a list, as a JSON
config gives it), which the JAX tool's tuple comparison refuses.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import convert_tf_checkpoint as jax_tool  # noqa: E402
import convert_tf_checkpoint_torch as port_tool  # noqa: E402
from test_convert import CFG, CFG_VARIANTS, _write_fake_keras  # noqa: E402

from vision_transformer_detector_tpu.utils.checkpoint import (  # noqa: E402
    save_params_npz)
from vision_transformer_detector_tpu_torch import (  # noqa: E402
    config as port_config)
from vision_transformer_detector_tpu_torch.utils import (  # noqa: E402
    checkpoint as port_checkpoint)


def _port_config(cfg):
    """The port's DetectorConfig with the JAX one's fields."""
    return port_config.DetectorConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _npz(path):
    with np.load(path) as data:
        return {name: data[name] for name in data.files}


def _assert_same_npz(got_path, want_path):
    got, want = _npz(got_path), _npz(want_path)
    assert sorted(got) == sorted(want)
    for name, array in want.items():
        assert got[name].dtype == array.dtype, name
        assert got[name].shape == array.shape, name
        assert got[name].tobytes() == array.tobytes(), name


@pytest.mark.parametrize("glorot", [False, True])
@pytest.mark.parametrize("variant", sorted(CFG_VARIANTS))
def test_npz_is_the_jax_tools_bit_for_bit(tmp_path, variant, glorot):
    cfg = CFG_VARIANTS[variant]
    fake = _write_fake_keras(tmp_path, cfg, glorot=glorot)
    want = os.path.join(str(tmp_path), "jax.npz")
    save_params_npz(want, jax_tool.convert(
        jax_tool.read_keras_weights(fake["path"]), cfg))
    got = os.path.join(str(tmp_path), "port.npz")
    weights = port_tool.read_keras_weights(fake["path"])
    assert len(weights) == len(fake["entries"])
    port_tool.save_npz(got, port_tool.convert(weights, _port_config(cfg)))
    _assert_same_npz(got, want)
    # The port loads it into its model, each array in its place.
    model = port_checkpoint.load_params_npz(got, _port_config(cfg))
    root = fake["root"]
    np.testing.assert_array_equal(
        model.encoder[1].mha.out.kernel.detach().numpy(),
        fake["entries"][
            f"{root}/multi_head_attention_1/attention_output/kernel:0"])


def test_command_line_writes_the_same_npz(tmp_path):
    """The tool's command line (the reference's architecture at the
    given size) against the JAX tool's, in a process of its own that
    cannot load JAX."""
    # The reference's architecture, as the command line builds it, at 68
    # px.
    cfg = type(CFG)(image_size=(68, 68), patch_size=17, embedding_dim=28)
    fake = _write_fake_keras(tmp_path, cfg)
    got = os.path.join(str(tmp_path), "port.npz")
    tool = os.path.join(REPO, "tools", "convert_tf_checkpoint_torch.py")
    script = (
        "import runpy, sys\n"
        f"sys.argv = ['convert', {fake['path']!r}, {got!r}, "
        "'--image-size', '68', '--patch-size', '17', "
        "'--embedding-dim', '28']\n"
        "sys.modules['jax'] = None\n"
        f"runpy.run_path({tool!r}, run_name='__main__')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert f"wrote {got}" in proc.stdout
    want = os.path.join(str(tmp_path), "jax.npz")
    save_params_npz(want, jax_tool.convert(
        jax_tool.read_keras_weights(fake["path"]), cfg))
    _assert_same_npz(got, want)


def test_keras3_archive_is_refused(tmp_path):
    path = tmp_path / "model.weights.h5"
    with h5py.File(path, "w") as f:
        for i in range(3):
            f.create_dataset(f"layers/{i}/vars/0", data=np.zeros(4))
    weights = port_tool.read_keras_weights(str(path))
    with pytest.raises(ValueError, match="Keras 3"):
        port_tool.convert(weights, _port_config(CFG))


def test_head_scales_list_of_one_converts(tmp_path):
    """``head_scales=[1]`` is the single-scale head: it converts to what
    ``(1,)`` converts to (the JAX tool compares with ``(1,)`` and refuses
    the list); a real multi-scale head is refused."""
    fake = _write_fake_keras(tmp_path, CFG)
    weights = port_tool.read_keras_weights(fake["path"])
    as_tuple = port_tool.convert(weights, _port_config(CFG))
    as_list = port_tool.convert(
        weights, _port_config(CFG).replace(head_scales=[1]))
    assert sorted(as_list) == sorted(as_tuple)
    for name, array in as_tuple.items():
        assert as_list[name].tobytes() == array.tobytes(), name
    with pytest.raises(ValueError, match="head_scales"):
        port_tool.convert(weights,
                          _port_config(CFG).replace(head_scales=(1, 2)))


def test_missing_layer_is_named(tmp_path):
    """An archive without a layer the model needs raises ValueError that
    names it, not an assertion."""
    fake = _write_fake_keras(tmp_path, CFG)
    weights = port_tool.read_keras_weights(fake["path"])
    weights = {k: v for k, v in weights.items() if "MLP_2_2" not in k}
    with pytest.raises(ValueError, match="MLP_2_2"):
        port_tool.convert(weights, _port_config(CFG))
