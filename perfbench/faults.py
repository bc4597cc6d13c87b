"""Faults planted underneath the timed path, for the checks' own tests and
for reading what each fault does to the compared numbers on the card.

Each fault patches the port for the length of a ``with`` block:
  * ``unchanged``: the optimiser step leaves parameters and state as
    they are (a step that returns its state unchanged);
  * ``half_batch``: the train step sees only the first half of each
    batch, its loss the mean over that half;
  * ``half_answers``: the service computes only the first half of each
    batch and answers the second half with the first half's detections;
  * ``altered``: each image's first detection moves by 10 pixels where
    the service produces it.
The card's cells run on one chip, so no fault leaves out an exchange
between chips.
"""

from __future__ import annotations

import contextlib

import torch

@contextlib.contextmanager
def planted(name: str):
    from vision_transformer_detector_tpu_torch import serving
    from vision_transformer_detector_tpu_torch.train import optimizer, trainer

    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "unchanged":
        patch(optimizer.Adam, "step", lambda self, *a, **k: None)
    elif name == "half_batch":
        make = trainer.make_train_step

        def make_half(*args, **kwargs):
            step = make(*args, **kwargs)

            def half(state, images, labels):
                n = images.shape[0] // 2
                return step(state, images[:n], labels[:n])
            return half
        patch(trainer, "make_train_step", make_half)
    elif name == "half_answers":
        predict = serving.DetectionService.predict_raw

        def half(self, images):
            n = max(1, images.shape[0] // 2)
            raw = predict(self, images[:n])
            return torch.cat([raw, raw])[:images.shape[0]]
        patch(serving.DetectionService, "predict_raw", half)
    elif name == "altered":
        predict = serving.DetectionService.predict_raw

        def altered(self, images):
            raw = predict(self, images).clone()
            raw[:, 0, 2] += 10.0
            return raw
        patch(serving.DetectionService, "predict_raw", altered)
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
