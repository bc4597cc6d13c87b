"""The seeded generators: the same seed gives the same inputs."""

import numpy as np
import pytest
import torch

from perfbench import inputs

SEEDS = [0, 7, 2 ** 31 + 5, 2 ** 40 + 3]
CFG = {"image_size": [64, 48], "max_objects": 17, "num_classes": 80,
       "patch_size": 16, "embedding_dim": 32, "num_heads": 2, "key_dim": 16,
       "encoder_blocks": 1, "encoder_mlp_layers": 2, "head_last_units": 16,
       "head_layers": 2, "head_block_repeats": 1, "attention_window": None,
       "head_scales": [1], "dropout": None, "use_mish": True,
       "ring_attention": False}


@pytest.mark.parametrize("seed", SEEDS)
def test_arrivals_fixed_count_and_deterministic(seed):
    a = inputs.arrivals(520.0, 30.0, seed)
    assert len(a) == 15600
    assert np.all(np.diff(a) >= 0) and 0 < a[0] and a[-1] < 30.0
    assert np.array_equal(a, inputs.arrivals(520.0, 30.0, seed))
    assert not np.array_equal(a, inputs.arrivals(520.0, 30.0, seed + 1))
    assert not np.array_equal(a, inputs.arrivals(520.0, 30.0, seed,
                                                 "serve.trace"))


@pytest.mark.parametrize("seed", SEEDS)
def test_images_labels_weights_deterministic(seed):
    for make in (inputs.make_images, inputs.make_labels):
        a = make(3, CFG, seed, "x", "cpu")
        assert torch.equal(a, make(3, CFG, seed, "x", "cpu"))
        assert not torch.equal(a, make(3, CFG, seed + 1, "x", "cpu"))
    w1 = inputs.make_weights(CFG, seed, "cpu")
    w2 = inputs.make_weights(CFG, seed, "cpu")
    assert all(torch.equal(w1[n], w2[n]) for n in w1)


def test_labels_as_the_pipeline_writes_them():
    labels = inputs.make_labels(64, CFG, 11, "labels", "cpu")
    positive = labels[..., 0] == 1.0
    counts = positive.sum(1)
    assert counts.min() >= 1 and counts.max() <= 17
    # Positives first, -8 in every other slot's class and box.
    for row, n in zip(labels, counts):
        assert torch.all(row[:n, 0] == 1.0) and torch.all(row[n:, 0] == 0.0)
        assert torch.all(row[n:, 1:] == -8.0)
    h, w = CFG["image_size"]
    box = labels[positive][:, 2:]
    assert torch.all(box[:, 0] - box[:, 3] / 2 >= -1e-4)
    assert torch.all(box[:, 0] + box[:, 3] / 2 <= w + 1e-4)
    assert torch.all(box[:, 1] - box[:, 2] / 2 >= -1e-4)
    assert torch.all(box[:, 1] + box[:, 2] / 2 <= h + 1e-4)


def test_weights_follow_keras_defaults():
    from perfbench.reference import vit_detector as ref

    w = inputs.make_weights(CFG, 3, "cpu")
    for name, shape in ref.param_shapes(CFG):
        assert tuple(w[name].shape) == shape
        if name.endswith(".kernel"):
            limit = ref.glorot_limit(shape)
            assert w[name].abs().max() <= limit
            assert w[name].abs().max() > 0.5 * limit
        elif name == "position_embedding":
            assert w[name].abs().max() <= 0.05
        elif name.endswith(".gamma"):
            assert torch.all(w[name] == 1.0)
        else:
            assert torch.all(w[name] == 0.0)


def test_samples_deterministic():
    a = inputs.choice(64, 1000, 9, "check")
    assert len(set(a.tolist())) == 64
    assert np.array_equal(a, inputs.choice(64, 1000, 9, "check"))
    assert len(inputs.choice(64, 10, 9, "check")) == 10
    assert np.array_equal(inputs.pick(5, 8, 9, "w"), inputs.pick(5, 8, 9, "w"))
