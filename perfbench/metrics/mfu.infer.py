"""The forward FLOPs of every image answered in the window over the
window, as a share of the bf16 peak."""

from perfbench import layer_math


def read(run):
    return layer_math.mfu_pct(run, 1.0)
