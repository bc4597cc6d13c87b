"""Three forward passes' FLOPs (forward and backward; no recompute) of
every image trained in the window over the window, as a share of the bf16
peak."""

from perfbench import layer_math


def read(run):
    return layer_math.mfu_pct(run, 3.0)
