"""The reference mAP metric, on the device, and the NumPy oracle
(mean_average_precision.py, the port's copy of the JAX package's) that it
is held to."""

from .fast_map import DeviceMeanAveragePrecision  # noqa: F401
from .mean_average_precision import MeanAveragePrecision  # noqa: F401
