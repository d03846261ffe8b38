"""The narrow MRF stages' share of their roofline (C = 64, 32, 16; 12 K C^2 T B
operations a stage, its input and output once), whichever of K2 or K3 ran
them, over those kernels' device time, in %. Moves audio_s_per_s."""

from port_bench.yardstick import kernels, readers


def read(run):
    bound = sum(readers.mrf_bound_s(run, len(b["rows"]), b["frames"]) for b in readers.served_batches(run) if b["frames"])
    return readers.roofline(run, bound, (kernels.K2, kernels.K3))
