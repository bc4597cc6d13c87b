"""Host ms per ``train_step`` call, until it returns, from the
benchmark's span around the call."""

from perfbench import layer_math


def read(run):
    return layer_math.mean_span_ms(run, "train_step")
