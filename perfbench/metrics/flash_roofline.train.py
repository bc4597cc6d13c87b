"""The flash forward (with lse) and backward bounds over their kernels'
device time in the trace."""

from perfbench import layer_math


def read(run):
    return layer_math.flash_roofline_pct(run, backward=True)
