"""Plain PyTorch reference of the speech encoder: HuBERT (the wav2vec 2.0
feature extractor: a strided conv stack, the first conv instance-normed,
exact GELU; a LayerNorm'd feature projection; a grouped conv positional
embedding; post-LN transformer layers) up to the codebook's layer, then the
nearest k-means centre, written from the HuBERT paper and the HF
``HubertModel`` it is published as. Imports nothing of the program; f32
unless a lower ``Precision`` is given (the control)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .resynth import F32, Precision

GROUP_NORM_EPS = 1e-5


def hubert_spec(enc: dict) -> list:
    """(name, shape, init, is_buffer) of the encoder's tensors (HF names):
    convs N(0, 2 / fan_in), dense layers N(0, 1 / fan_in), norm gains 1,
    biases 0."""
    d, f, c = enc["hidden_size"], enc["intermediate_size"], enc["conv_dim"]

    def w(name, *shape, gain=1.0):
        return (name, shape, ("normal", math.sqrt(gain / math.prod(shape[1:]))), False)

    def const(name, n, kind):
        return (name, (n,), (kind,), False)

    spec, c_in = [], 1
    for i, (c_out, k) in enumerate(zip(c, enc["conv_kernel"])):
        spec.append(w(f"feature_extractor.conv_layers.{i}.conv.weight", c_out, c_in, k, gain=2.0))
        if i == 0:
            spec += [const("feature_extractor.conv_layers.0.layer_norm.weight", c_out, "ones"),
                     const("feature_extractor.conv_layers.0.layer_norm.bias", c_out, "zeros")]
        c_in = c_out
    spec += [const("feature_projection.layer_norm.weight", c_in, "ones"), const("feature_projection.layer_norm.bias", c_in, "zeros"),
             w("feature_projection.projection.weight", d, c_in), const("feature_projection.projection.bias", d, "zeros"),
             w("encoder.pos_conv_embed.conv.weight", d, d // enc["num_conv_pos_embedding_groups"], enc["num_conv_pos_embeddings"], gain=2.0),
             const("encoder.pos_conv_embed.conv.bias", d, "zeros"),
             const("encoder.layer_norm.weight", d, "ones"), const("encoder.layer_norm.bias", d, "zeros")]
    for i in range(enc["num_hidden_layers"]):
        p = f"encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            spec += [w(p + f"attention.{proj}.weight", d, d), const(p + f"attention.{proj}.bias", d, "zeros")]
        spec += [const(p + "layer_norm.weight", d, "ones"), const(p + "layer_norm.bias", d, "zeros"),
                 w(p + "feed_forward.intermediate_dense.weight", f, d), const(p + "feed_forward.intermediate_dense.bias", f, "zeros"),
                 w(p + "feed_forward.output_dense.weight", d, f), const(p + "feed_forward.output_dense.bias", d, "zeros"),
                 const(p + "final_layer_norm.weight", d, "ones"), const(p + "final_layer_norm.bias", d, "zeros")]
    return spec


def num_frames(enc: dict, samples):
    n = samples
    for k, s in zip(enc["conv_kernel"], enc["conv_stride"]):
        n = (n - k) // s + 1
    return n


def _ln(x, w, prefix, eps):
    return F.layer_norm(x, x.shape[-1:], w[prefix + ".weight"], w[prefix + ".bias"], eps)


def _linear(p, x, w, prefix):
    return F.linear(p(x), p(w[prefix + ".weight"]), w[prefix + ".bias"])


def features(w: dict, enc: dict, wav, samples, layers: int, p: Precision = F32):
    """Hidden states (B, T', D) after ``layers`` layers of a right-padded
    waveform batch (B, T) with ``samples`` (B,) valid samples a row; pad
    frames are zero after every conv and before the positional conv."""
    x, lengths = wav[:, None, :], samples
    for i, (k, s) in enumerate(zip(enc["conv_kernel"], enc["conv_stride"])):
        lengths = (lengths - k) // s + 1
        x = F.conv1d(p(x), p(w[f"feature_extractor.conv_layers.{i}.conv.weight"]), stride=s)
        mask = (torch.arange(x.shape[-1], device=x.device)[None, :] < lengths[:, None])[:, None, :]
        if i == 0:
            m = mask.float()
            count = m.sum(dim=-1, keepdim=True).clamp(min=1.0)
            mean = (x * m).sum(dim=-1, keepdim=True) / count
            var = (torch.square(x - mean) * m).sum(dim=-1, keepdim=True) / count
            x = (x - mean) * torch.rsqrt(var + GROUP_NORM_EPS)
            x = x * w["feature_extractor.conv_layers.0.layer_norm.weight"][:, None] + w["feature_extractor.conv_layers.0.layer_norm.bias"][:, None]
        x = F.gelu(x).masked_fill(~mask, 0.0)
    eps = enc["layer_norm_eps"]
    frame_mask = mask[:, 0, :]
    x = _linear(p, _ln(x.transpose(1, 2), w, "feature_projection.layer_norm", eps), w, "feature_projection.projection")
    x = x.masked_fill(~frame_mask[..., None], 0.0)
    k = enc["num_conv_pos_embeddings"]
    pos = F.conv1d(p(x.transpose(1, 2)), p(w["encoder.pos_conv_embed.conv.weight"]), w["encoder.pos_conv_embed.conv.bias"],
                   padding=k // 2, groups=enc["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[..., :-1]
    x = _ln(x + F.gelu(pos).transpose(1, 2), w, "encoder.layer_norm", eps)
    b, n, d = x.shape
    heads = enc["num_attention_heads"]
    for i in range(layers):
        pre = f"encoder.layers.{i}."

        def split(t):
            return t.view(b, n, heads, d // heads).transpose(1, 2)

        q, kk, v = (split(_linear(p, x, w, pre + f"attention.{proj}")) for proj in ("q_proj", "k_proj", "v_proj"))
        logits = torch.einsum("bhqd,bhkd->bhqk", p(q), p(kk)) / math.sqrt(d // heads)
        probs = torch.softmax(logits.masked_fill(~frame_mask[:, None, None, :], -0.7 * float(torch.finfo(torch.float32).max)), dim=-1)
        att = torch.einsum("bhqk,bhkd->bhqd", p(probs), p(v)).transpose(1, 2).reshape(b, n, d)
        x = _ln(x + _linear(p, att, w, pre + "attention.out_proj"), w, pre + "layer_norm", eps)
        ff = _linear(p, F.gelu(_linear(p, x, w, pre + "feed_forward.intermediate_dense")), w, pre + "feed_forward.output_dense")
        x = _ln(x + ff, w, pre + "final_layer_norm", eps)
    return x, frame_mask


def assign(x, centers, p: Precision = F32):
    """The nearest centre of each frame: argmax_c (x.c - |c|^2 / 2), the lowest id on a tie."""
    score = torch.einsum("...d,kd->...k", p(x), p(centers)) - 0.5 * torch.sum(centers * centers, dim=-1)
    return torch.argmax(score, dim=-1)
