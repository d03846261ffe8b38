"""Share of the traced window in which no operation ran on the card (the
union of operation intervals, not a sum), in %. Moves train_frames_per_s."""

from port_bench.yardstick import readers


def read(run):
    if run.window is None or not run.ops:
        return None
    return readers.share(run.window_s - run.busy_s, run.window_s)
