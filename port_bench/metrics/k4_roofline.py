"""K4's share of its roofline: each encoder batch's assignment of its (B x
frames) x 768 features to 2 000 centres in 3xTF32, bound over K4's device
time, in %. Moves audio_s_per_s.resynth."""

from port_bench.yardstick import flops, kernels, readers


def read(run):
    enc = run.config["encoder"]
    bound = sum(kernels.k4_bound_s(b * flops.hubert_frames(enc["hubert"], t), enc["hubert"]["hidden_size"], enc["vocab_size"])
                for b, t, _, _ in run.records.get("encoder_shapes", []))
    return readers.roofline(run, bound, (kernels.K4,))
