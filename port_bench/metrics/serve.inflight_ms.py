"""Ms a served batch waits behind the card (the program's span
``serve.inflight``: from the end of its enqueue to its samples on the host),
averaged over the window's batches. Moves request_p95_ms."""

from port_bench.metrics import _recorded


def read(run):
    return _recorded.mean_ms(run, "serve.inflight")
