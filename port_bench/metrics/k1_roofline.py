"""K1's share of its roofline: the sum of its launches' bounds (operations or
bytes, at the shapes and key masks the window's batches had) over its device
time in the trace, in %: the decoder's launches (one a layer a velocity
evaluation) and, in the resynthesis cell (read there as
``k1_roofline.resynth``), the encoder's (one a layer up to the codebook's).
Moves audio_s_per_s."""

from port_bench.yardstick import flops, kernels, readers


def read(run):
    fm = run.config["flow_matching"]
    per_batch = fm["depth"] * round(1.0 / fm["dt"])
    heads, head_dim = fm["heads"], fm["hidden_size"] // fm["heads"]
    bound = sum(per_batch * kernels.k1_bound_s(len(b["rows"]), heads, b["frames"], head_dim, b["rows"])
                for b in readers.served_batches(run) if b["frames"])
    if "encoder" in run.config:
        enc = run.config["encoder"]
        h = enc["hubert"]
        d = h["hidden_size"] // h["num_attention_heads"]
        for b, t, _, valid_frames in run.records.get("encoder_shapes", []):
            n = flops.hubert_frames(h, t)
            bound += enc["output_layer"] * kernels.k1_bound_s(b, h["num_attention_heads"], n, d, [valid_frames])
    return readers.roofline(run, bound, (kernels.K1,))
