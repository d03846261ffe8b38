"""Share of the velocity transformer's feed-forward frame rows that ran on
K5, the channels-last conv feed-forward kernel: the program's counter
``decoder.ff_kernel_rows`` over it plus ``decoder.ff_plain_rows`` (the
plain route's rows), in %. The program counts both in
``ConvFeedForward.forward``; a program that counts neither gives nothing.
Moves audio_s_per_s."""

from port_bench.metrics import _recorded
from port_bench.yardstick import readers


def read(run):
    kernel, plain = _recorded.total(run, "decoder.ff_kernel_rows"), _recorded.total(run, "decoder.ff_plain_rows")
    if kernel is None and plain is None:
        return None
    return readers.share(kernel or 0, (kernel or 0) + (plain or 0))
