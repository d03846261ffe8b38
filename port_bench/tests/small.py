"""Small versions of the cells' configurations and mixes, for the CPU tests:
the same files with narrow widths, short utterances and few ODE steps."""

from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def config(name: str) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg["flow_matching"].update(vocab_size=50, dim_cond_emb=32, hidden_size=64, depth=2, heads=2, intermediate_size=96,
                                conv_pos_embed_kernel_size=7, conv_pos_embed_groups=64, dt=0.25)
    cfg["hifigan"].update(upsample_initial_channel=32)
    cfg["flow_matching_with_hifigan"]["batch_size"] = 4
    w = cfg["assumed"]["weights"]
    w["wire_gain"] = 2.0**24  # a narrower random vocoder is quieter still
    if "encoder" in cfg:
        cfg["encoder"].update(vocab_size=50, output_layer=2)
        cfg["encoder"]["hubert"].update(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=48,
                                        conv_dim=[16] * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2)
    if "duration_std" in w:
        w["duration_std"] = 0.25 / (32 * 3 * 0.25) ** 0.5
    return cfg


def traffic(name: str) -> dict:
    tr = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    tr = copy.deepcopy(tr)
    if tr["runner"] == "serve":
        tr.update(length_s={"median": 0.4, "sigma": 0.6, "min": 0.1, "max": 1.0}, block=16, length_multiple=16,
                  checked_batches=2, checked_from=3, min_checked_rows=4, warm_batches=4, group=4)
    if tr["runner"] == "resynth":
        tr.update(length_s={"median": 0.4, "sigma": 0.6, "min": 0.1, "max": 1.0}, files=8, min_checked_rows=8)
    if tr["runner"] == "train_cfm":
        tr.update(batch_size=32, frames_per_seg=16, min_frames=4, reference_rows=32)
    return tr
