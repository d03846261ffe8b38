"""Plain PyTorch reference of the resynthesis decoder.

The conditional-flow-matching mel decoder (unit embedding, Fourier time
MLP, depthwise positional conv, rotary attention with a key mask, adaptive
RMSNorm, conv SiGLU feed-forward, final RMSNorm), its fixed-step Euler ODE,
the duration predictor and length regulator, the CFM training loss, and the
HiFi-GAN generator, written from the published description of the
reference repository's models (misternasty/speech_resynth, after Matcha-TTS
and HiFi-GAN) in plain ``torch`` operations. It imports nothing of the
program and takes its weights as a dict of tensors keyed as the program's
checkpoints are.

Everything is computed in f32 (the caller turns TF32 off around it). A
``Precision`` other than f32 rounds both operands of every product
(linear, conv, attention) to a narrower format first, with a per-tensor
scale: the control that computes the same thing one precision step lower.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

LOG_PAD = math.log(1e-5)  # a pad frame's log-mel
NEG = -0.7 * float(torch.finfo(torch.float32).max)  # a masked logit
RMS_EPS = float(torch.finfo(torch.float32).eps)
LRELU = 0.1
FP8_MAX = 448.0  # largest float8 e4m3 value


class Precision:
    """The format the operands of every product are rounded to: "f32" (none)
    or "fp8" (float8 e4m3 with a per-tensor scale, as fp8 inference runs).
    The rounding passes the gradient straight through."""

    def __init__(self, fmt: str = "f32"):
        if fmt not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {fmt!r}")
        self.fmt = fmt

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.fmt == "f32":
            return t
        scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return t + (q - t.detach())


F32 = Precision("f32")


# -- weights -----------------------------------------------------------------


def cfm_spec(fm: dict, init: dict) -> list:
    """(name, shape, init, is_buffer) of every tensor of the CFM decoder.
    ``init``: the configuration's assumed draw (``unit_table_std``,
    ``duration_std``, ``duration_bias``); every other matrix N(0, 1 / fan_in),
    biases 0, norm gains 1, the Fourier frequencies N(0, 1)."""
    if fm.get("use_unet_skip_connection"):
        raise ValueError("the reference has no U-Net skip combiner")
    h, f, e, d_in = fm["hidden_size"], fm["intermediate_size"], fm["dim_cond_emb"], fm["dim_in"]
    k_pos, groups = fm["conv_pos_embed_kernel_size"], fm["conv_pos_embed_groups"]

    def mat(name, *shape):
        fan_in = math.prod(shape[1:])
        return (name, shape, ("normal", 1.0 / math.sqrt(fan_in)), False)

    def zeros(name, *shape):
        return (name, shape, ("zeros",), False)

    spec = [
        ("to_cond_emb.weight", (fm["vocab_size"] + 1, e), ("normal", init["unit_table_std"]), False),
        ("time_cond_mlp.0.weights", (h // 2,), ("normal", 1.0), True),
        mat("time_cond_mlp.1.weight", h, h + 1),
        zeros("time_cond_mlp.1.bias", h),
        mat("to_embed.weight", h, d_in + e),
        zeros("to_embed.bias", h),
        mat("conv_embed.dw_conv1d.0.weight", h, h // groups, k_pos),
        zeros("conv_embed.dw_conv1d.0.bias", h),
    ]
    for i in range(fm["depth"]):
        p = f"transformer.layers.{i}."
        spec += [
            mat(p + "1.to_weight.weight", h, h),
            mat(p + "2.to_qkv.weight", 3 * h, h),
            mat(p + "2.to_out.weight", h, h),
            mat(p + "3.to_weight.weight", h, h),
            mat(p + "4.conv1.weight", 2 * f, h, 3),
            zeros(p + "4.conv1.bias", 2 * f),
            mat(p + "4.conv2.weight", h, f, 3),
            zeros(p + "4.conv2.bias", h),
        ]
    spec += [("transformer.final_norm.weight", (h,), ("ones",), False), mat("to_pred.weight", d_in, h)]
    if fm["predict_duration"]:
        spec += [
            ("duration_predictor.conv.weight", (1, e, 3), ("normal", init["duration_std"]), False),
            ("duration_predictor.conv.bias", (1,), ("const", init["duration_bias"]), False),
        ]
    return spec


def hifigan_spec(hg: dict, init: dict) -> list:
    """(name, shape, init, is_buffer) of every tensor of the generator: conv
    weights N(0, ``vocoder_std``^2), biases 0, the input statistics the
    identity (mean 0, scale 1)."""
    std = ("normal", init["vocoder_std"])
    c = hg["upsample_initial_channel"]
    spec = [("mean", (hg["model_in_dim"],), ("zeros",), True), ("scale", (hg["model_in_dim"],), ("ones",), True)]
    spec += [("conv_pre.weight", (c, hg["model_in_dim"], 7), std, False), ("conv_pre.bias", (c,), ("zeros",), False)]
    block = 0
    for i, k in enumerate(hg["upsample_kernel_sizes"]):
        c_in, c_out = c // 2**i, c // 2 ** (i + 1)
        spec += [(f"upsampler.{i}.weight", (c_in, c_out, k), std, False), (f"upsampler.{i}.bias", (c_out,), ("zeros",), False)]
        for rk, rd in zip(hg["resblock_kernel_sizes"], hg["resblock_dilation_sizes"]):
            for conv in ("convs1", "convs2"):
                for j in range(len(rd)):
                    p = f"resblocks.{block}.{conv}.{j}."
                    spec += [(p + "weight", (c_out, c_out, rk), std, False), (p + "bias", (c_out,), ("zeros",), False)]
            block += 1
    c_last = c // 2 ** len(hg["upsample_kernel_sizes"])
    spec += [("conv_post.weight", (1, c_last, 7), std, False), ("conv_post.bias", (1,), ("zeros",), False)]
    return spec


# -- the CFM decoder -----------------------------------------------------------


def _linear(p: Precision, x, w, b=None):
    return F.linear(p(x), p(w), b)


def _conv_same(p: Precision, x, w, b, groups: int = 1):
    """SAME conv of (B, N, C) by a torch-layout (C_out, C_in / groups, k) weight."""
    k = w.shape[-1]
    lo = (k - 1) // 2
    h = F.pad(p(x).transpose(1, 2), (lo, k - 1 - lo))
    return F.conv1d(h, p(w), b, groups=groups).transpose(1, 2)


def _rotate(pos, t):
    d = t.shape[-1]
    t1, t2 = t[..., : d // 2], t[..., d // 2 :]
    return t * torch.cos(pos) + torch.cat([-t2, t1], dim=-1) * torch.sin(pos)


def _rotary(n: int, dim: int, device) -> torch.Tensor:
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    freqs = torch.outer(torch.arange(n, dtype=torch.float32, device=device), inv)
    return torch.cat([freqs, freqs], dim=-1)


def _ada_norm(p, x, cond, w):
    normed = x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-24)
    return normed * x.shape[-1] ** 0.5 * (_linear(p, cond, w)[:, None, :] + 1.0)


def _attention(p, x, mask, pos, w, prefix, heads):
    b, n, c = x.shape
    qkv = _linear(p, x, w[prefix + "to_qkv.weight"]).view(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = _rotate(pos, qkv[0]), _rotate(pos, qkv[1]), qkv[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", p(q), p(k)) / math.sqrt(c // heads)
    probs = torch.softmax(logits.masked_fill(~mask[:, None, None, :], NEG), dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p(probs), p(v)).transpose(1, 2).reshape(b, n, c)
    return _linear(p, out, w[prefix + "to_out.weight"])


def _feed_forward(p, x, mask, w, prefix):
    x = x.masked_fill(~mask[..., None], 0)
    value, gate = _conv_same(p, x, w[prefix + "conv1.weight"], w[prefix + "conv1.bias"]).chunk(2, dim=-1)
    h = (F.silu(gate) * value).masked_fill(~mask[..., None], 0)
    return _conv_same(p, h, w[prefix + "conv2.weight"], w[prefix + "conv2.bias"])


def velocity(w: dict, fm: dict, xt, cond, times, mask, p: Precision = F32):
    """v(x_t, cond, t): (B, N, dim_in) from the noisy mel, the frame
    conditions (B, N, dim_cond_emb), the flow times (B,) and the frame mask."""
    x = _linear(p, torch.cat([xt, cond], dim=-1), w["to_embed.weight"], w["to_embed.bias"])
    xm = x.masked_fill(~mask[..., None], 0)
    pos_emb = F.gelu(_conv_same(p, xm, w["conv_embed.dw_conv1d.0.weight"], w["conv_embed.dw_conv1d.0.bias"],
                                groups=fm["conv_pos_embed_groups"]))
    x = pos_emb.masked_fill(~mask[..., None], 0) + x
    t = times[:, None]
    freqs = t * w["time_cond_mlp.0.weights"][None, :] * 2 * math.pi
    t_emb = F.silu(_linear(p, torch.cat([t, torch.sin(freqs), torch.cos(freqs)], dim=-1),
                           w["time_cond_mlp.1.weight"], w["time_cond_mlp.1.bias"]))
    heads = fm["heads"]
    pos = _rotary(x.shape[1], fm["hidden_size"] // heads, x.device)
    for i in range(fm["depth"]):
        pre = f"transformer.layers.{i}."
        x = _attention(p, _ada_norm(p, x, t_emb, w[pre + "1.to_weight.weight"]), mask, pos, w, pre + "2.", heads) + x
        x = _feed_forward(p, _ada_norm(p, x, t_emb, w[pre + "3.to_weight.weight"]), mask, w, pre + "4.") + x
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + RMS_EPS) * w["transformer.final_norm.weight"]
    return _linear(p, x, w["to_pred.weight"])


def embed_units(w: dict, ids):
    return w["to_cond_emb.weight"][ids].masked_fill((ids == 0)[..., None], 0)


def durations(w: dict, cond, token_mask, p: Precision = F32):
    """Frames per token: round(exp(conv(cond)) - 1), at least 0, 0 at pads (int64)."""
    out = F.conv1d(p(cond.transpose(1, 2)), p(w["duration_predictor.conv.weight"]), w["duration_predictor.conv.bias"], padding=1)[:, 0]
    d = torch.clamp(torch.round(torch.exp(out) - 1.0), min=0.0).long()
    return d.masked_fill(~token_mask, 0)


def frame_bound(totals) -> int:
    """A duration batch's frame count: its largest total, rounded up to a
    multiple of 64 (at least 64)."""
    needed = max(int(totals.max()), 1)
    return max(64, -(-needed // 64) * 64)


def regulate(cond, d, frames: int):
    """Repeat each token's condition by its duration: (B, frames, C) and the frame mask."""
    ends = torch.cumsum(d, dim=-1)
    t = torch.arange(frames, device=cond.device)[None, :].expand(cond.shape[0], frames).contiguous()
    src = torch.searchsorted(ends, t, right=True).clamp(max=cond.shape[1] - 1)
    out = torch.gather(cond, 1, src[..., None].expand(-1, -1, cond.shape[-1]))
    mask = t < ends[:, -1:]
    return out.masked_fill(~mask[..., None], 0), mask


def conditions(w: dict, fm: dict, ids, p: Precision = F32):
    """(frame conditions, frame mask, per-row frames) of a unit batch: the
    embedded units, or with duration prediction the regulated ones at the
    batch's frame bound."""
    token_mask = ids != 0
    cond = embed_units(w, ids)
    if not fm["predict_duration"]:
        return cond, token_mask, token_mask.sum(dim=1)
    d = durations(w, cond, token_mask, p)
    totals = d.sum(dim=1)
    cond, mask = regulate(cond, d, frame_bound(totals))
    return cond, mask, totals


def ode(w: dict, fm: dict, cond, mask, x0, dt: float, truncation: Optional[float], p: Precision = F32):
    """Euler steps from the noise x0 (B, N, dim_in) to t = 1; returns the
    normalized mel x1 (pad frames 0)."""
    steps = round(1.0 / dt)
    xt = x0 if truncation is None else x0.clamp(-truncation, truncation)
    for s in range(steps):
        t = torch.full((xt.shape[0],), s * dt, device=xt.device)
        xt = xt + velocity(w, fm, xt, cond, t, mask, p) * dt
    return xt.masked_fill(~mask[..., None], 0)


def log_mel(fm: dict, x1, mask):
    """The normalized mel as a log-mel, pad frames at log(1e-5)."""
    return (x1 * fm["std"] + fm["mean"]).masked_fill(~mask[..., None], LOG_PAD)


def cfm_loss_terms(w: dict, fm: dict, ids, labels, x0, times, p: Precision = F32):
    """(squared velocity error summed over valid frames, their count x
    dim_in) of the CFM objective on the straight path from x0 to the
    normalized labels (frames whose labels are all -100 are padding)."""
    mask = torch.any(labels != -100, dim=-1)
    x1 = (labels - fm["mean"]) / fm["std"]
    t = times[:, None, None]
    xt = (1 - t) * x0 + t * x1
    pred = velocity(w, fm, xt, embed_units(w, ids), times, mask, p)
    sq = torch.where(mask[..., None], (pred - (x1 - x0)) ** 2, 0.0)
    return sq.sum(), mask.sum() * fm["dim_in"]


# -- the HiFi-GAN generator ------------------------------------------------------


def vocoder(w: dict, hg: dict, mel, p: Precision = F32):
    """log-mel (B, T, mel) -> waveform (B, samples) in [-1, 1]."""
    x = F.conv1d(p(mel.transpose(1, 2)), p(w["conv_pre.weight"]), w["conv_pre.bias"], padding=3)
    kernels, dilations = hg["resblock_kernel_sizes"], hg["resblock_dilation_sizes"]
    block = 0
    for i, (rate, k) in enumerate(zip(hg["upsample_rates"], hg["upsample_kernel_sizes"])):
        x = F.leaky_relu(x, LRELU)
        x = F.conv_transpose1d(p(x), p(w[f"upsampler.{i}.weight"]), w[f"upsampler.{i}.bias"], stride=rate, padding=(k - rate) // 2)
        acc = None
        for rk, rd in zip(kernels, dilations):
            xb = x
            for j, d in enumerate(rd):
                pre1, pre2 = f"resblocks.{block}.convs1.{j}.", f"resblocks.{block}.convs2.{j}."
                h = F.conv1d(p(F.leaky_relu(xb, LRELU)), p(w[pre1 + "weight"]), w[pre1 + "bias"], padding=(rk * d - d) // 2, dilation=d)
                h = F.conv1d(p(F.leaky_relu(h, LRELU)), p(w[pre2 + "weight"]), w[pre2 + "bias"], padding=(rk - 1) // 2)
                xb = h + xb
            acc = xb if acc is None else acc + xb
            block += 1
        x = acc / len(kernels)
    x = F.conv1d(p(F.leaky_relu(x, LRELU)), p(w["conv_post.weight"]), w["conv_post.bias"], padding=3)
    return torch.tanh(x)[:, 0]


def pcm16(wave):
    return torch.round(wave.clamp(-1.0, 1.0) * 32767.0)


def waveform_lengths(hg: dict, frames):
    out = frames
    for k, s in zip(hg["upsample_kernel_sizes"], hg["upsample_rates"]):
        out = (out - 1) * s - 2 * ((k - s) // 2) + k
    return out


def synthesize(w: dict, fm: dict, hg: dict, ids, noise: Callable, dt: float, truncation, p: Precision = F32, rows: int = 8):
    """The decoder on a unit batch (B, L) as one padded batch: (normalized
    mel (B, N, dim_in), frame mask, per-row frames, PCM16 codes (B, samples)
    as f32). ``noise(shape)`` gives the ODE's x0 for the whole batch; the
    vocoder runs ``rows`` rows at a time."""
    cond, mask, frames = conditions(w, fm, ids, p)
    x0 = noise((ids.shape[0], cond.shape[1], fm["dim_in"]))
    x1 = ode(w, fm, cond, mask, x0, dt, truncation, p)
    mel = log_mel(fm, x1, mask)
    codes = torch.cat([pcm16(vocoder(w, hg, mel[i : i + rows], p)) for i in range(0, mel.shape[0], rows)])
    return x1, mask, frames, codes
