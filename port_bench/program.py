"""The harness's side of the program: its configuration objects built from a
configuration file's dicts, and the seeded weights both the program and the
reference are given."""

from __future__ import annotations

from port_bench.harness import sub_seed
from port_bench.reference import resynth as ref
from port_bench.yardstick import weights as W


def cfm_config(fm: dict):
    from speech_resynth_torch.models.cfm import CFMConfig

    keys = ("vocab_size", "dim_in", "dim_cond_emb", "hidden_size", "depth", "heads", "intermediate_size", "ff_dropout",
            "use_unet_skip_connection", "conv_pos_embed_kernel_size", "conv_pos_embed_groups", "attn_dropout", "mean",
            "std", "predict_duration")
    return CFMConfig(**{k: fm[k] for k in keys})


def vocoder_config(hg: dict):
    from speech_resynth_torch.models.hifigan import HifiGanConfig

    return HifiGanConfig(
        model_in_dim=hg["model_in_dim"], upsample_initial_channel=hg["upsample_initial_channel"],
        upsample_rates=tuple(hg["upsample_rates"]), upsample_kernel_sizes=tuple(hg["upsample_kernel_sizes"]),
        resblock_kernel_sizes=tuple(hg["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in hg["resblock_dilation_sizes"]),
    )


def decoder_weights(torch, config: dict, seed: int, device: str, dtype) -> tuple:
    """The CFM's and the vocoder's weights from the seed, drawn on ``device``,
    conv_post times the configuration's wire gain."""
    init = config["assumed"]["weights"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    cfm = W.draw(torch, ref.cfm_spec(config["flow_matching"], init), gen, dtype)
    voc = W.draw(torch, ref.hifigan_spec(config["hifigan"], init), gen, dtype)
    voc["conv_post.weight"] = voc["conv_post.weight"] * init["wire_gain"]
    return cfm, voc


def cfm_weights(torch, config: dict, seed: int, device: str, dtype) -> dict:
    """The CFM's weights alone, the same draw as ``decoder_weights``'s first part;
    the unit table's pad row 0 (the trainer's table has a zero pad row)."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    w = W.draw(torch, ref.cfm_spec(config["flow_matching"], config["assumed"]["weights"]), gen, dtype)
    w["to_cond_emb.weight"][0] = 0
    return w
