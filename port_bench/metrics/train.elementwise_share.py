"""Share of the training window's device time spent in elementwise kernels
and copies (every operation that is no matmul, conv or hand-written kernel,
by the frozen grouping of kernel names), in %. Moves train_frames_per_s."""

from port_bench.yardstick import kernels, readers


def read(run):
    total = sum(readers.by_name(run).values())
    return readers.share(readers.device_time(run, (kernels.ELEMENTWISE,)), total) if total else None
