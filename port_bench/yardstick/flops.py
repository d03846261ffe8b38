"""Analytic model FLOPs: matmuls and convolutions only, 2 FLOPs a multiply-add.

Frozen copies of the program's counts (``speech_resynth_torch/core/metrics.py``:
``cfm_forward_flops``, ``cfm_step_flops``, ``hifigan_generator_flops``) so
that a later change to the program cannot move the yardstick, plus the
counts the program has none of: the duration predictor's conv, mHuBERT's
forward and the k-means assignment. Configurations are the dicts of
``port_bench/configs/<name>.json``.
"""

from __future__ import annotations


def cfm_forward_flops(fm: dict, batch_size: int, frames: int) -> float:
    """One velocity-field forward on (batch_size, frames):

        per frame  2 (dim_in + dim_cond_emb) h + 2 h k_pos h / groups
                   + depth (8 h^2 + 18 h F + 4 N h) + 2 h dim_in
        per row    2 (h + 1) h + depth 4 h^2

    (qkv, out, the feed-forward's two k = 3 convs, QK^T and PV over the N
    frames; the time MLP and the adaptive norms' gains per row)."""
    h, f, n = fm["hidden_size"], fm["intermediate_size"], frames
    if fm.get("use_unet_skip_connection"):
        raise ValueError("the U-Net skip combiner is not counted")
    per_layer = 8 * h * h + 18 * h * f + 4 * n * h
    per_frame = (
        2 * (fm["dim_in"] + fm["dim_cond_emb"]) * h
        + 2 * h * fm["conv_pos_embed_kernel_size"] * (h // fm["conv_pos_embed_groups"])
        + fm["depth"] * per_layer
        + 2 * h * fm["dim_in"]
    )
    per_row = 2 * (h + 1) * h + fm["depth"] * 4 * h * h
    return float(batch_size * (n * per_frame + per_row))


def cfm_step_flops(fm: dict, batch_size: int, frames: int) -> float:
    """One CFM training step: forward + backward = 3 forwards."""
    return 3.0 * cfm_forward_flops(fm, batch_size, frames)


def duration_flops(fm: dict, tokens: int) -> float:
    """The duration predictor's Conv1d(dim_cond_emb -> 1, k = 3) on ``tokens`` tokens."""
    return 2.0 * 3 * fm["dim_cond_emb"] * tokens


def waveform_length(hg: dict, frames: int) -> int:
    """Samples of ``frames`` mel frames: ConvTranspose length propagation."""
    out = frames
    for k, s in zip(hg["upsample_kernel_sizes"], hg["upsample_rates"]):
        out = (out - 1) * s - 2 * ((k - s) // 2) + k
    return out


def hifigan_generator_flops(hg: dict, batch_size: int, frames: int) -> float:
    """One generator forward on (batch_size, frames) mel frames: conv_pre
    (k 7), each stage's transposed conv and its MRF branches (per dilation
    two convs of 2 T C^2 k), conv_post (k 7)."""
    c, t = hg["upsample_initial_channel"], frames
    total = 2 * t * hg["model_in_dim"] * c * 7
    for rate, kernel in zip(hg["upsample_rates"], hg["upsample_kernel_sizes"]):
        total += 2 * t * c * (c // 2) * kernel
        t = (t - 1) * rate - 2 * ((kernel - rate) // 2) + kernel
        c //= 2
        for k, dilations in zip(hg["resblock_kernel_sizes"], hg["resblock_dilation_sizes"]):
            total += len(dilations) * 2 * 2 * t * c * c * k
    total += 2 * t * c * 7
    return float(batch_size * total)


def mrf_stages(hg: dict, frames: int):
    """(C, T) of every MRF stage narrow enough for the fused kernels (C <= 64)
    in one generator call on ``frames`` frames."""
    stages, c, t = [], hg["upsample_initial_channel"], frames
    for rate, kernel in zip(hg["upsample_rates"], hg["upsample_kernel_sizes"]):
        t = (t - 1) * rate - 2 * ((kernel - rate) // 2) + kernel
        c //= 2
        if c <= 64:
            stages.append((c, t))
    return stages


def hubert_frames(enc: dict, samples: int) -> int:
    """Frames of the conv feature extractor on ``samples`` samples."""
    n = samples
    for k, s in zip(enc["conv_kernel"], enc["conv_stride"]):
        n = (n - k) // s + 1
    return max(n, 0)


def hubert_flops(enc: dict, samples: int, layers: int) -> float:
    """mHuBERT's forward on one waveform of ``samples`` samples up to
    ``layers`` transformer layers: the conv feature extractor (every conv at
    2 T_out C_out C_in k), the feature projection, the grouped positional
    conv, and per layer qkv + out (8 D^2), the feed-forward (4 D F) and
    QK^T + PV (4 N D) per frame."""
    total, n, c_in = 0, samples, 1
    for c_out, k, s in zip(enc["conv_dim"], enc["conv_kernel"], enc["conv_stride"]):
        n = (n - k) // s + 1
        total += 2 * n * c_out * c_in * k
        c_in = c_out
    d, f = enc["hidden_size"], enc["intermediate_size"]
    total += 2 * n * c_in * d
    total += 2 * n * d * (d // enc["num_conv_pos_embedding_groups"]) * enc["num_conv_pos_embeddings"]
    total += layers * n * (8 * d * d + 4 * d * f + 4 * n * d)
    return float(total)


def kmeans_flops(frames: int, dim: int, centers: int) -> float:
    """The assignment's scores: one (frames, dim) x (dim, centers) product."""
    return 2.0 * frames * dim * centers
