"""Share of the serving cells' traced window in which no operation runs on
the card while the server's thread is inside the program's ``decoder.ode``
span, in % (idle as ``device.idle.serve`` takes it: the union of operation
intervals, clipped to the window). Moves audio_s_per_s."""

from port_bench.metrics import _recorded


def read(run):
    return _recorded.idle_inside(run, "decoder.ode")
