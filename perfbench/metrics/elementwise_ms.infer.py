"""Device ms per traced call in kernels that are neither matrix products
nor flash attention (``kernel_groups``)."""

from perfbench import layer_math


def read(run):
    return layer_math.group_ms_per_unit(run, "elementwise")
