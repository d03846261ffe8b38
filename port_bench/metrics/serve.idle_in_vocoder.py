"""Share of the serving cells' traced window in which no operation runs on
the card while the server's thread is inside the program's ``decoder.vocoder``
span, in %. Moves audio_s_per_s."""

from port_bench.metrics import _recorded


def read(run):
    return _recorded.idle_inside(run, "decoder.vocoder")
