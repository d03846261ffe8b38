"""Padding in the server's batches counted by the program where each batch is
drained: 1 - ``serve.samples_needed`` (the requests' delivered samples) over
``serve.samples_computed`` (rows, fillers included, times the padded
length), in %: the in-program twin of ``serve.pad_share``. Moves
audio_s_per_s."""

from port_bench.metrics import _recorded


def read(run):
    return _recorded.pad_share(run, "serve.samples_needed", "serve.samples_computed")
