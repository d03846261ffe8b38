"""Weights carried across: the JAX package's Flax trees -> the port's state_dicts.

The port's own copy of the mapping that speech_resynth_tpu/models/export.py
applies when it writes an HF-format checkpoint. The trees hold numpy arrays
(or anything ``np.asarray`` reads); the result loads with
``module.load_state_dict`` into ``ConditionalFlowMatchingModel`` or
``HifiGanGenerator``, whose parameter names are the HF keys.

Layouts (Flax -> torch):
  Conv1d kernel   (K, I, O) -> (O, I, K)
  ConvT1d kernel  (K, I, O) -> (I, O, K)
  Dense kernel    (I, O)    -> (O, I)
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv1d_w(k) -> torch.Tensor:
    return _t(np.asarray(k, np.float32).transpose(2, 1, 0))


def _convt1d_w(k) -> torch.Tensor:
    return _t(np.asarray(k, np.float32).transpose(1, 2, 0))


def _dense_w(k) -> torch.Tensor:
    return _t(np.asarray(k, np.float32).T)


def hifigan_generator_state_dict(params: Mapping, buffers: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """Generator params (and, with ``normalize_before``, its ``buffers``
    collection) -> ``HifiGanGenerator`` state_dict."""
    sd: Dict[str, torch.Tensor] = {
        "conv_pre.weight": _conv1d_w(params["conv_pre"]["kernel"]),
        "conv_pre.bias": _t(params["conv_pre"]["bias"]),
        "conv_post.weight": _conv1d_w(params["conv_post"]["kernel"]),
        "conv_post.bias": _t(params["conv_post"]["bias"]),
    }
    i = 0
    while f"upsampler_{i}" in params:
        sd[f"upsampler.{i}.weight"] = _convt1d_w(params[f"upsampler_{i}"]["kernel"])
        sd[f"upsampler.{i}.bias"] = _t(params[f"upsampler_{i}"]["bias"])
        i += 1
    n = 0
    while f"resblocks_{n}" in params:
        block = params[f"resblocks_{n}"]
        j = 0
        while f"convs1_{j}" in block:
            for conv in ("convs1", "convs2"):
                sd[f"resblocks.{n}.{conv}.{j}.weight"] = _conv1d_w(block[f"{conv}_{j}"]["kernel"])
                sd[f"resblocks.{n}.{conv}.{j}.bias"] = _t(block[f"{conv}_{j}"]["bias"])
            j += 1
        n += 1
    in_dim = sd["conv_pre.weight"].shape[1]
    if buffers and "mean" in buffers:
        sd["mean"], sd["scale"] = _t(buffers["mean"]), _t(buffers["scale"])
    else:
        sd["mean"], sd["scale"] = torch.zeros(in_dim), torch.ones(in_dim)
    return sd


def cfm_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """CFM variables ({"params", "buffers"}) -> ``ConditionalFlowMatchingModel``
    state_dict, the Fourier buffer ``time_cond_mlp.0.weights`` included."""
    params = variables["params"]
    buffers = variables.get("buffers", {})
    if "duration_predictor" in params:
        raise NotImplementedError("duration predictor weights are not ported yet (ROADMAP.md queue 1)")
    sd: Dict[str, torch.Tensor] = {
        "to_cond_emb.weight": _t(params["to_cond_emb"]["embedding"]),
        "time_cond_mlp.0.weights": _t(buffers["time_cond_mlp"]["fourier"]["weights"]),
        "time_cond_mlp.1.weight": _dense_w(params["time_cond_mlp"]["proj"]["kernel"]),
        "time_cond_mlp.1.bias": _t(params["time_cond_mlp"]["proj"]["bias"]),
        "to_embed.weight": _dense_w(params["to_embed"]["kernel"]),
        "to_embed.bias": _t(params["to_embed"]["bias"]),
        "conv_embed.dw_conv1d.0.weight": _conv1d_w(params["conv_embed"]["kernel"]),
        "conv_embed.dw_conv1d.0.bias": _t(params["conv_embed"]["bias"]),
        "to_pred.weight": _dense_w(params["to_pred"]["kernel"]),
    }
    tr = params["transformer"]
    ind = 0
    while f"layers_{ind}_attn_norm" in tr:
        p = f"transformer.layers.{ind}"
        if f"layers_{ind}_skip_combiner" in tr:
            sd[f"{p}.0.weight"] = _dense_w(tr[f"layers_{ind}_skip_combiner"]["kernel"])
        sd[f"{p}.1.to_weight.weight"] = _t(tr[f"layers_{ind}_attn_norm"]["to_weight"])
        sd[f"{p}.2.to_qkv.weight"] = _dense_w(tr[f"layers_{ind}_attn"]["to_qkv"]["kernel"])
        sd[f"{p}.2.to_out.weight"] = _dense_w(tr[f"layers_{ind}_attn"]["to_out"]["kernel"])
        sd[f"{p}.3.to_weight.weight"] = _t(tr[f"layers_{ind}_ff_norm"]["to_weight"])
        ff = tr[f"layers_{ind}_ff"]
        sd[f"{p}.4.conv1.weight"] = _conv1d_w(ff["conv1_kernel"])
        sd[f"{p}.4.conv1.bias"] = _t(ff["conv1_bias"])
        sd[f"{p}.4.conv2.weight"] = _conv1d_w(ff["conv2_kernel"])
        sd[f"{p}.4.conv2.bias"] = _t(ff["conv2_bias"])
        ind += 1
    sd["transformer.final_norm.weight"] = _t(tr["final_norm"]["weight"])
    return sd


def load_checkpoint(model_dir: Path) -> Dict[str, torch.Tensor]:
    """Read an HF checkpoint directory: ``model.safetensors`` (read with the
    ``safetensors`` package, imported only here) or ``pytorch_model.bin``."""
    st = model_dir / "model.safetensors"
    if st.is_file():
        from safetensors.torch import load_file

        return load_file(str(st))
    bin_path = model_dir / "pytorch_model.bin"
    if bin_path.is_file():
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model weights (model.safetensors or pytorch_model.bin) in {model_dir}")
