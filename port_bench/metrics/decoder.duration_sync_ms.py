"""Host ms a batch spends on its frame bound (the program's span
``decoder.duration_bound``: the duration predictor and the host's wait for
its totals), averaged over the window's batches; duration-predicting models
only. Moves audio_s_per_s."""

from port_bench.metrics import _recorded


def read(run):
    return _recorded.mean_ms(run, "decoder.duration_bound")
