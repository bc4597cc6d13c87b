"""The flash forward's bound over its device time in the trace."""

from perfbench import layer_math


def read(run):
    return layer_math.flash_roofline_pct(run, backward=False)
