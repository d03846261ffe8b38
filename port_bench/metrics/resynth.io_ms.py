"""Host ms a resynthesized batch spends reading its WAVs and writing its
outputs (the program's spans ``resynth.read`` and ``resynth.write``), over the
window's batches (its ``resynth.decode`` spans): the in-program twin of
``io.host_ms``. Moves audio_s_per_s.resynth."""

from port_bench.metrics import _recorded


def read(run):
    batches = len(_recorded.spans(run, "resynth.decode"))
    io = _recorded.spans(run, "resynth.read", "resynth.write")
    return 1e3 * sum(b - a for a, b in io) / batches if batches else None
