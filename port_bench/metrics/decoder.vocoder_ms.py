"""Host ms a batch spends in the vocoder and its wire-format conversion (the
program's span ``decoder.vocoder``), averaged over the window's batches.
Moves audio_s_per_s."""

from port_bench.metrics import _recorded


def read(run):
    return _recorded.mean_ms(run, "decoder.vocoder")
