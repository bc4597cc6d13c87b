"""Host ms per ``predict_raw`` call, until it returns (the device work
is not waited for), from the benchmark's span around the call."""

from perfbench import layer_math


def read(run):
    return layer_math.mean_span_ms(run, "predict_raw")
