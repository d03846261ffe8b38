"""Host ms a batch spends putting its unit ids on the card (the program's span
``decoder.input``): a copy from pageable host memory first waits for the
card's queue, so this is the served batch's wait for the batches before it.
Averaged over the window's batches. Moves audio_s_per_s."""

from port_bench.metrics import _recorded


def read(run):
    return _recorded.mean_ms(run, "decoder.input")
