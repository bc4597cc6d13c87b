"""The reference mAP metric, on the device, and the shared NumPy oracle
(the JAX package's metrics/mean_average_precision.py, which imports no
JAX) that it is held to."""

from vision_transformer_detector_tpu.metrics.mean_average_precision import (  # noqa: F401
    MeanAveragePrecision,
)

from .fast_map import DeviceMeanAveragePrecision  # noqa: F401
