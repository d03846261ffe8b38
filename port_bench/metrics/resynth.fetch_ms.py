"""Host ms a resynthesized batch waits for its waveforms on the card (the
program's span ``resynth.fetch``, the copy to the host), averaged over the
window's batches. Moves audio_s_per_s.resynth."""

from port_bench.metrics import _recorded


def read(run):
    return _recorded.mean_ms(run, "resynth.fetch")
