"""Share of the traced window with no device activity."""

from perfbench import layer_math


def read(run):
    return layer_math.idle_pct(run)
