"""The training step's share of the card's bf16 peak: the model FLOPs of the
window's steps (forward and backward, matmuls and convs) over the traced
window and the peak, in %: the loop's train/MFU quantity. Moves
train_frames_per_s."""

from port_bench.yardstick import flops, peaks, readers


def read(run):
    if run.window is None or not run.ops:
        return None
    tr = run.traffic
    total = run.records["steps"] * flops.cfm_step_flops(run.config["flow_matching"], tr["batch_size"], tr["frames_per_seg"])
    return readers.share(total / peaks.PEAK_BF16_FLOPS, run.window_s)
