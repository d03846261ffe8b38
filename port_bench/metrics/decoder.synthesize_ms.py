"""Host ms a batch spends in ``decoder.synthesize`` by the program's own span
of that name (the enqueue of its kernels, and any wait in it), averaged over
the window's batches: the in-program twin of ``serve.dispatch_ms``. Moves
audio_s_per_s."""

from port_bench.metrics import _recorded


def read(run):
    return _recorded.mean_ms(run, "decoder.synthesize")
