"""The whole serving step's share of the card's bf16 peak: the model FLOPs
the delivered requests need on their own lengths (the ODE's velocity
evaluations, the vocoder, the duration conv) over the traced window and
the peak, in %. Moves audio_s_per_s."""

from port_bench.yardstick import peaks, readers


def read(run):
    if run.window is None or not run.ops:
        return None
    rec = run.records
    total = sum(readers.decoder_flops(run, rec["frames"][i], rec["units"][i]) for i in rec["frames"])
    return readers.share(total / peaks.PEAK_BF16_FLOPS, run.window_s)
