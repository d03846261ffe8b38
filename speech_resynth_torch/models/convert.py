"""Weights carried across: the JAX package's Flax trees -> the port's state_dicts.

The port's own copy of the mapping that speech_resynth_tpu/models/export.py
applies when it writes an HF-format checkpoint. The trees hold numpy arrays
(or anything ``np.asarray`` reads); the result loads with
``module.load_state_dict`` into ``ConditionalFlowMatchingModel``,
``HifiGanGenerator``, ``HubertEncoder`` or ``LlamaLM``, whose parameter
names are the HF keys, or into the training discriminators
``MultiPeriodDiscriminator`` / ``MultiScaleDiscriminator``
(``mpd_state_dict`` / ``msd_state_dict``: weight norm's ``v`` and ``g`` and
the spectral norm's ``u`` kept as they are). ``hubert_state_dict_from_hf`` and
``llama_state_dict_from_hf`` read HF ``HubertModel`` and ``LlamaForCausalLM``
state_dicts (the port's copies of speech_resynth_tpu/models/convert.py:
hubert_params and llama_params). The eval stack's: ``whisper_state_dict``
and ``utmos_state_dict`` (the JAX trees, for the tests),
``utmos_state_dict_from_lightning`` and ``fairseq_wav2vec2_state_dict``
(the published UTMOS checkpoint); ``save_composite_pretrained`` writes the
composite directory both packages' ``from_pretrained`` read.

Layouts (Flax -> torch):
  Conv2d kernel   (kh, kw, I, O) -> (O, I, kh, kw)
  Conv1d kernel   (K, I, O) -> (O, I, K)
  ConvT1d kernel  (K, I, O) -> (I, O, K)
  Dense kernel    (I, O)    -> (O, I)
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..core.safetensors import load_hf_state_dict, save_file


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


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


def _conv2d_w(k) -> torch.Tensor:
    return _t(np.asarray(k, np.float32).transpose(3, 2, 0, 1))


def _discriminator_state_dict(params: Mapping, conv_w, spectral: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    i = 0
    while f"discriminators_{i}" in params:
        disc, stats = params[f"discriminators_{i}"], (spectral or {}).get(f"discriminators_{i}", {})
        convs = [(f"convs_{j}", f"convs.{j}") for j in range(len(disc)) if f"convs_{j}" in disc] + [("conv_post", "conv_post")]
        for theirs, ours in convs:
            p, base = disc[theirs], f"discriminators.{i}.{ours}"
            if "kernel" in p:  # spectral-normed
                sd[f"{base}.weight"] = conv_w(p["kernel"])
                sd[f"{base}.u"] = _t(stats[theirs]["u"])
            else:
                sd[f"{base}.v"] = conv_w(p["v"])
                sd[f"{base}.g"] = _t(p["g"])
            sd[f"{base}.bias"] = _t(p["bias"])
        i += 1
    return sd


def mpd_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``MultiPeriodDiscriminator`` params -> the port's state_dict."""
    return _discriminator_state_dict(params, _conv2d_w)


def msd_state_dict(params: Mapping, spectral: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``MultiScaleDiscriminator`` params and its ``spectral`` collection
    (the power iteration's ``u``) -> the port's state_dict."""
    return _discriminator_state_dict(params, _conv1d_w, spectral)


def cfm_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """CFM variables ({"params", "buffers"}) -> ``ConditionalFlowMatchingModel``
    state_dict, the Fourier buffer ``time_cond_mlp.0.weights`` included."""
    params = variables["params"]
    buffers = variables.get("buffers", {})
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
    if "duration_predictor" in params:
        sd["duration_predictor.conv.weight"] = _conv1d_w(params["duration_predictor"]["kernel"])  # (3, D, 1) -> (1, D, 3)
        sd["duration_predictor.conv.bias"] = _t(params["duration_predictor"]["bias"])
    return sd


def _ln(p: Mapping) -> Dict[str, torch.Tensor]:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def _dense(p: Mapping) -> Dict[str, torch.Tensor]:
    return {"weight": _dense_w(p["kernel"]), "bias": _t(p["bias"])}


def hubert_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``HubertEncoder`` params -> the port's ``HubertEncoder`` state_dict."""
    parts: Dict[str, Dict[str, torch.Tensor]] = {}
    fe = params["feature_extractor"]
    i = 0
    while f"conv_layers_{i}" in fe:
        layer = fe[f"conv_layers_{i}"]
        parts[f"feature_extractor.conv_layers.{i}.conv"] = {"weight": _conv1d_w(layer["kernel"])}
        if "norm_scale" in layer:
            parts[f"feature_extractor.conv_layers.{i}.layer_norm"] = {
                "weight": _t(layer["norm_scale"]),
                "bias": _t(layer["norm_bias"]),
            }
        i += 1
    parts["feature_projection.layer_norm"] = _ln(params["feature_projection_norm"])
    parts["feature_projection.projection"] = _dense(params["feature_projection_dense"])
    parts["encoder.pos_conv_embed.conv"] = {
        "weight": _conv1d_w(params["pos_conv_kernel"]),
        "bias": _t(params["pos_conv_bias"]),
    }
    parts["encoder.layer_norm"] = _ln(params["encoder_norm"])
    i = 0
    while f"layers_{i}" in params:
        layer, p = params[f"layers_{i}"], f"encoder.layers.{i}"
        for ours, theirs in (("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"), ("out_proj", "o_proj")):
            parts[f"{p}.attention.{ours}"] = _dense(layer[theirs])
        parts[f"{p}.layer_norm"] = _ln(layer["attn_norm"])
        parts[f"{p}.feed_forward.intermediate_dense"] = _dense(layer["ff_in"])
        parts[f"{p}.feed_forward.output_dense"] = _dense(layer["ff_out"])
        parts[f"{p}.final_layer_norm"] = _ln(layer["ff_norm"])
        i += 1
    return {f"{prefix}.{name}": t for prefix, tensors in parts.items() for name, t in tensors.items()}


LLAMA_LAYER_KEYS = (
    ("q_proj", "self_attn.q_proj"),
    ("k_proj", "self_attn.k_proj"),
    ("v_proj", "self_attn.v_proj"),
    ("o_proj", "self_attn.o_proj"),
    ("gate_proj", "mlp.gate_proj"),
    ("up_proj", "mlp.up_proj"),
    ("down_proj", "mlp.down_proj"),
)


def _map_tree(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def unstack_llama_layers(params: Mapping) -> Dict:
    """The scan layout (one ``layers`` subtree with a leading layer axis) ->
    the unrolled ``layers_{i}`` layout."""
    out = {k: v for k, v in params.items() if k != "layers"}
    stacked = params["layers"]
    n = len(np.asarray(stacked["q_proj"]["kernel"]))
    for i in range(n):
        out[f"layers_{i}"] = _map_tree(lambda x, i=i: np.asarray(x)[i], stacked)
    return out


def llama_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``LlamaLM`` params (unrolled ``layers_{i}`` or the stacked scan
    layout) -> the port's ``LlamaLM`` state_dict, which has the HF keys."""
    if "layers" in params:
        params = unstack_llama_layers(params)
    sd: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": _t(params["embed_tokens"]["embedding"]),
        "model.norm.weight": _t(params["final_norm"]["weight"]),
        "lm_head.weight": _dense_w(params["lm_head"]["kernel"]),
    }
    i = 0
    while f"layers_{i}" in params:
        layer, p = params[f"layers_{i}"], f"model.layers.{i}"
        sd[f"{p}.input_layernorm.weight"] = _t(layer["input_norm"]["weight"])
        sd[f"{p}.post_attention_layernorm.weight"] = _t(layer["post_attn_norm"]["weight"])
        for ours, theirs in LLAMA_LAYER_KEYS:
            sd[f"{p}.{theirs}.weight"] = _dense_w(layer[ours]["kernel"])
        i += 1
    return sd


def llama_state_dict_from_hf(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """HF ``LlamaForCausalLM`` state_dict -> the port's ``LlamaLM`` state_dict:
    the embedding, the final norm, the LM head and each layer's norms and
    projections, in f32; other keys (rotary buffers) are dropped."""
    sd = dict(state_dict)
    out = {k: _t(_np(sd[k])) for k in ("model.embed_tokens.weight", "model.norm.weight", "lm_head.weight")}
    i = 0
    while f"model.layers.{i}.self_attn.q_proj.weight" in sd:
        p = f"model.layers.{i}"
        names = ["input_layernorm", "post_attention_layernorm", *(theirs for _, theirs in LLAMA_LAYER_KEYS)]
        for name in names:
            out[f"{p}.{name}.weight"] = _t(_np(sd[f"{p}.{name}.weight"]))
        i += 1
    return out


POS_CONV = "encoder.pos_conv_embed.conv"


def _weight_normed_conv1d(sd: Mapping, base: str) -> torch.Tensor:
    """One Conv1d weight from a torch ``weight_norm(conv, dim=2)``: the legacy
    ``weight_g``/``weight_v`` names or the torch>=2.1
    ``parametrizations.weight.original{0,1}`` names."""
    if f"{base}.weight_g" in sd:
        g, v = _t(_np(sd[f"{base}.weight_g"])), _t(_np(sd[f"{base}.weight_v"]))
    else:
        g = _t(_np(sd[f"{base}.parametrizations.weight.original0"]))
        v = _t(_np(sd[f"{base}.parametrizations.weight.original1"]))
    norm = torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True))  # over (O, I) per tap
    return g * v / norm


def hubert_state_dict_from_hf(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """HF ``HubertModel`` (or ``Wav2Vec2Model``) state_dict -> the port's
    ``HubertEncoder`` state_dict: the same keys, in f32, with the weight-normed
    positional conv folded into ``encoder.pos_conv_embed.conv.weight`` and the
    pre-training-only ``masked_spec_embed`` dropped."""
    sd = dict(state_dict)
    out = {
        k: _t(_np(v))
        for k, v in sd.items()
        if not k.startswith(POS_CONV + ".") and k != "masked_spec_embed"
    }
    out[POS_CONV + ".weight"] = _weight_normed_conv1d(sd, POS_CONV)
    out[POS_CONV + ".bias"] = _t(_np(sd[POS_CONV + ".bias"]))
    return out


def save_pretrained(model_dir, state_dict: Mapping[str, torch.Tensor], config: dict) -> None:
    """Write ``config.json`` and ``model.safetensors`` (f32 CPU tensors,
    ``core.safetensors``), the layout of the JAX package's
    ``models/export.py:save_pretrained``, each through a temporary file
    renamed into place, so a reader never sees a half-written file."""
    import json
    import os

    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    tmp = model_dir / "config.json.tmp"
    tmp.write_text(json.dumps(config, indent=2))
    os.replace(tmp, model_dir / "config.json")
    tmp = model_dir / "model.safetensors.tmp"
    save_file({k: v.detach().float().cpu().contiguous() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, model_dir / "model.safetensors")


def load_checkpoint(model_dir: Path) -> Dict[str, torch.Tensor]:
    """Read an HF checkpoint directory: ``model.safetensors`` or its sharded
    index (``core.safetensors``), else ``pytorch_model.bin``."""
    model_dir = Path(model_dir)
    if (model_dir / "model.safetensors").is_file() or (model_dir / "model.safetensors.index.json").is_file():
        return load_hf_state_dict(model_dir)
    bin_path = model_dir / "pytorch_model.bin"
    if bin_path.is_file():
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model weights (model.safetensors or pytorch_model.bin) in {model_dir}")


def _attn(p: Mapping) -> Dict[str, torch.Tensor]:
    """A Flax Whisper attention's projections -> HF names (k has no bias)."""
    out = {}
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        out[f"{proj}.weight"] = _dense_w(p[proj]["kernel"])
        if "bias" in p[proj]:
            out[f"{proj}.bias"] = _t(p[proj]["bias"])
    return out


def whisper_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``WhisperForASR`` params (unrolled ``layers_{i}``) -> the port's
    ``WhisperForASR`` state_dict, which has the HF keys."""
    enc, dec = params["encoder"], params["decoder"]
    parts: Dict[str, Dict[str, torch.Tensor]] = {
        "model.encoder.conv1": {"weight": _conv1d_w(enc["conv1_kernel"]), "bias": _t(enc["conv1_bias"])},
        "model.encoder.conv2": {"weight": _conv1d_w(enc["conv2_kernel"]), "bias": _t(enc["conv2_bias"])},
        "model.encoder.embed_positions": {"weight": _t(enc["embed_positions"])},
        "model.encoder.layer_norm": _ln(enc["layer_norm"]),
        "model.decoder.embed_tokens": {"weight": _t(dec["embed_tokens"]["embedding"])},
        "model.decoder.embed_positions": {"weight": _t(dec["embed_positions"])},
        "model.decoder.layer_norm": _ln(dec["layer_norm"]),
        "proj_out": {"weight": _dense_w(dec["proj_out"]["kernel"])},
    }
    for side, tree, attns in (("encoder", enc, ("self_attn",)), ("decoder", dec, ("self_attn", "encoder_attn"))):
        i = 0
        while f"layers_{i}" in tree:
            layer, p = tree[f"layers_{i}"], f"model.{side}.layers.{i}"
            for name in attns:
                parts[f"{p}.{name}"] = _attn(layer[name])
                parts[f"{p}.{name}_layer_norm"] = _ln(layer[f"{name}_layer_norm"])
            parts[f"{p}.final_layer_norm"] = _ln(layer["final_layer_norm"])
            parts[f"{p}.fc1"] = _dense(layer["mlp"]["fc1"])
            parts[f"{p}.fc2"] = _dense(layer["mlp"]["fc2"])
            i += 1
    return {f"{prefix}.{name}": t for prefix, tensors in parts.items() for name, t in tensors.items()}


def _lstm_dirs(params: Mapping) -> Dict[str, torch.Tensor]:
    """The Flax ``BiLSTM`` (gates [i, f, g, o], one summed bias a direction)
    -> ``nn.LSTM(bidirectional=True)`` names; the sum goes to ``bias_ih``."""
    sd = {}
    for ours, suffix in (("fwd", ""), ("bwd", "_reverse")):
        sd[f"weight_ih_l0{suffix}"] = _dense_w(params[f"w_ih_{ours}"])
        sd[f"weight_hh_l0{suffix}"] = _dense_w(params[f"w_hh_{ours}"])
        sd[f"bias_ih_l0{suffix}"] = _t(params[f"bias_{ours}"])
        sd[f"bias_hh_l0{suffix}"] = torch.zeros_like(sd[f"bias_ih_l0{suffix}"])
    return sd


def utmos_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``UTMOSPredictor`` params -> the port's ``UTMOSPredictor`` state_dict."""
    sd = {f"ssl.{k}": v for k, v in hubert_state_dict(params["ssl"]).items()}
    sd.update({f"decoder_rnn.{k}": v for k, v in _lstm_dirs(params["decoder_rnn"]).items()})
    sd["domain_embedding.weight"] = _t(params["domain_embedding"]["embedding"])
    sd["judge_embedding.weight"] = _t(params["judge_embedding"]["embedding"])
    for name in ("proj_in", "proj_out"):
        sd[f"{name}.weight"] = _dense_w(params[name]["kernel"])
        sd[f"{name}.bias"] = _t(params[name]["bias"])
    return sd


# fairseq wav2vec2 (the SSL tower inside the UTMOS checkpoint) -> HF / the port's HubertEncoder
FAIRSEQ_LAYER_KEYS = (
    ("self_attn.q_proj", "attention.q_proj"),
    ("self_attn.k_proj", "attention.k_proj"),
    ("self_attn.v_proj", "attention.v_proj"),
    ("self_attn.out_proj", "attention.out_proj"),
    ("self_attn_layer_norm", "layer_norm"),
    ("fc1", "feed_forward.intermediate_dense"),
    ("fc2", "feed_forward.output_dense"),
    ("final_layer_norm", "final_layer_norm"),
)


def fairseq_wav2vec2_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """fairseq ``Wav2Vec2Model`` (wav2vec_small) state_dict -> the port's
    ``HubertEncoder`` state_dict (the base layouts are the same network):
    conv blocks ``Sequential(conv, dropout, [GroupNorm], GELU)``, the
    feature norm and ``post_extract_proj``, the weight-normed positional
    conv folded, post-LN blocks. Pre-training keys (quantizer, ``mask_emb``,
    ``final_proj``) are dropped."""
    out: Dict[str, torch.Tensor] = {}
    i = 0
    while f"feature_extractor.conv_layers.{i}.0.weight" in sd:
        base = f"feature_extractor.conv_layers.{i}"
        out[f"{base}.conv.weight"] = _t(_np(sd[f"{base}.0.weight"]))
        if f"{base}.2.weight" in sd:
            out[f"{base}.layer_norm.weight"] = _t(_np(sd[f"{base}.2.weight"]))
            out[f"{base}.layer_norm.bias"] = _t(_np(sd[f"{base}.2.bias"]))
        i += 1
    for theirs, ours in (("layer_norm", "feature_projection.layer_norm"), ("post_extract_proj", "feature_projection.projection"),
                         ("encoder.layer_norm", "encoder.layer_norm")):
        out[f"{ours}.weight"], out[f"{ours}.bias"] = _t(_np(sd[f"{theirs}.weight"])), _t(_np(sd[f"{theirs}.bias"]))
    out[POS_CONV + ".weight"] = _weight_normed_conv1d(sd, "encoder.pos_conv.0")
    out[POS_CONV + ".bias"] = _t(_np(sd["encoder.pos_conv.0.bias"]))
    i = 0
    while f"encoder.layers.{i}.self_attn.q_proj.weight" in sd:
        for theirs, ours in FAIRSEQ_LAYER_KEYS:
            for part in ("weight", "bias"):
                out[f"encoder.layers.{i}.{ours}.{part}"] = _t(_np(sd[f"encoder.layers.{i}.{theirs}.{part}"]))
        i += 1
    return out


def utmos_state_dict_from_lightning(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """The UTMOS demo's lightning state_dict (a leading ``model.`` optional):
    ``feature_extractors.0.ssl_model.*`` (fairseq wav2vec2),
    ``feature_extractors.1.embedding`` (domain),
    ``output_layers.0.{judge_embedding,decoder_rnn}``,
    ``output_layers.1.net.{0,3}`` (Linear, ReLU, Dropout, Linear) -> the
    port's ``UTMOSPredictor`` state_dict, f32."""
    sd = {(k[len("model."):] if k.startswith("model.") else k): v for k, v in state_dict.items()}
    ssl = "feature_extractors.0.ssl_model."
    out = {f"ssl.{k}": v for k, v in fairseq_wav2vec2_state_dict({k[len(ssl):]: v for k, v in sd.items() if k.startswith(ssl)}).items()}
    rnn = "output_layers.0.decoder_rnn."
    out.update({f"decoder_rnn.{k[len(rnn):]}": _t(_np(v)) for k, v in sd.items() if k.startswith(rnn)})
    out["domain_embedding.weight"] = _t(_np(sd["feature_extractors.1.embedding.weight"]))
    out["judge_embedding.weight"] = _t(_np(sd["output_layers.0.judge_embedding.weight"]))
    for ours, theirs in (("proj_in", "output_layers.1.net.0"), ("proj_out", "output_layers.1.net.3")):
        out[f"{ours}.weight"], out[f"{ours}.bias"] = _t(_np(sd[f"{theirs}.weight"])), _t(_np(sd[f"{theirs}.bias"]))
    return out


def save_composite_pretrained(model_dir, model, vocoder) -> None:
    """The composite checkpoint directory that both packages'
    ``ConditionalFlowMatchingWithHifiGan.from_pretrained`` read, as the JAX
    ``save_composite_pretrained`` writes it: ``config.json`` with
    ``model_config`` (the CFM config's fields) and ``vocoder_config``, and
    ``model.safetensors`` (f32) with the CFM's keys under ``model.`` and the
    generator's (its input statistics included) under ``vocoder.``."""
    import dataclasses

    sd = {f"model.{k}": v for k, v in model.state_dict().items()}
    sd.update({f"vocoder.{k}": v for k, v in vocoder.state_dict().items()})
    config = {"model_config": dataclasses.asdict(model.config), "vocoder_config": dataclasses.asdict(vocoder.config)}
    save_pretrained(model_dir, sd, config)
