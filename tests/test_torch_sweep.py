"""The port's run_sweep (train/sweep.py) on the CPU: the twins of
tests/test_sweep.py, and the grid routing of tests/test_cli.py's
unknown-parameter test. The CLI sweeps are in test_torch_cli.py."""

import json

import numpy as np
import pytest

from vision_transformer_detector_tpu_torch.config import (
    DetectorConfig, TrainConfig)
from vision_transformer_detector_tpu_torch.train.sweep import (
    expand_grid, format_records, run_sweep, split_overrides)

TINY = DetectorConfig(
    image_size=(34, 34), embedding_dim=8, num_heads=2, key_dim=4,
    encoder_blocks=1, encoder_mlp_layers=2, head_last_units=8, head_layers=1)


def _make_data(config, train_config):
    rng = np.random.default_rng(0)
    h, w = config.image_size
    images = rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32)
    labels = np.full((2, config.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    labels[0, 0] = (1, 5, 17.0, 17.0, 10.0, 10.0)
    return [(images, labels)], [(images, labels)]


def test_run_sweep_rejects_unsized_dataset(tmp_path):
    """A dataset without __len__ would give steps_per_epoch 1 and a
    schedule counted in steps, not epochs: refused."""
    def gen_data(config, train_config):
        return (b for b in _make_data(config, train_config)[0]), None

    with pytest.raises(TypeError, match="sized train dataset"):
        run_sweep({}, gen_data, base_config=TINY, epochs=1,
                  out_dir=str(tmp_path / "s"), device="cpu", plot=False)


def test_run_sweep_truncates_stale_records(tmp_path):
    out = str(tmp_path / "sweep")
    tc = TrainConfig(learning_rate=1e-4, epochs_warm_up=10_000,
                     skip_epochs=10_000)
    for _ in range(2):
        records = run_sweep({}, _make_data, base_config=TINY,
                            base_train_config=tc, epochs=1, out_dir=out,
                            device="cpu", plot=False)
    lines = [json.loads(line) for line in open(f"{out}/records.jsonl")]
    assert len(lines) == len(records) == 1
    assert lines[0]["run"] == 0
    assert expand_grid({}) == [{}]


def test_grid_routes_each_field_and_rejects_unknown_ones(tmp_path):
    """Keys go to the config that owns them (an int image_size becomes a
    square), each point trains, and a name no config has raises."""
    assert split_overrides({"image_size": 34, "learning_rate": 1e-3,
                            "weight_ciou": 2.0}) == (
        {"image_size": (34, 34)}, {"learning_rate": 1e-3},
        {"weight_ciou": 2.0})
    with pytest.raises(KeyError, match="not a field"):
        split_overrides({"nonexistent_param": 1})
    records = run_sweep({"embedding_dim": [8, 16]}, _make_data,
                        base_config=TINY, epochs=1,
                        out_dir=str(tmp_path / "g"), device="cpu",
                        plot=False)
    assert [r["embedding_dim"] for r in records] == [8, 16]
    assert all(np.isfinite(r["final_loss"]) for r in records)
    table = format_records(records)
    assert table.splitlines()[0].split()[:2] == ["embedding_dim", "run"]
