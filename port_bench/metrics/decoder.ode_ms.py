"""Host ms a batch spends in the decoder's ODE (the program's span
``decoder.ode``: the launches of its steps, and any wait on a full launch
queue), averaged over the window's batches. Moves audio_s_per_s."""

from port_bench.metrics import _recorded


def read(run):
    return _recorded.mean_ms(run, "decoder.ode")
