"""The whole wav -> units -> wav flow's share of the card's bf16 peak: the
model FLOPs each file needs on its own length (mHuBERT to the codebook's
layer, the k-means assignment, the ODE's velocity evaluations, the vocoder)
over the traced window and the peak, in %. Moves audio_s_per_s.resynth."""

from port_bench.yardstick import flops, peaks, readers


def read(run):
    if run.window is None or not run.ops:
        return None
    enc = run.config["encoder"]
    h = enc["hubert"]
    total = 0.0
    for samples in run.records["file_samples"] * run.records["passes"]:
        frames = flops.hubert_frames(h, samples)
        total += flops.hubert_flops(h, samples, enc["output_layer"]) + flops.kmeans_flops(frames, h["hidden_size"], enc["vocab_size"])
        total += readers.decoder_flops(run, frames, frames)
    return readers.share(total / peaks.PEAK_BF16_FLOPS, run.window_s)
