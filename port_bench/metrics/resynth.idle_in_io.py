"""Share of the resynthesis cell's traced window in which no operation runs on
the card while the host is inside the program's ``resynth.read`` or
``resynth.write`` span, in %. Moves audio_s_per_s.resynth."""

from port_bench.metrics import _recorded


def read(run):
    return _recorded.idle_inside(run, "resynth.read", "resynth.write")
