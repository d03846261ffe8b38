"""Velocity-field transformer for conditional flow matching.

Counterpart of speech_resynth_tpu/models/transformer.py: rotary attention
with key-padding masks, a depthwise conv positional embedding, adaptive
RMSNorm conditioned on the flow time, a convolutional SiGLU feed-forward,
optional U-Net skip combiners on the back half and a final RMSNorm.

Activations are (B, N, C) as in the JAX package. Module and parameter names
follow the HF-format checkpoint keys (``transformer.layers.{i}.{0..4}``), so
a checkpoint loads with ``load_state_dict``. Attention goes through
``ops.attention.dot_product_attention``, routed by ``attn_implementation``
("auto": the flash kernel on the card, with the plain version's gradient
when training; "xla": the plain version). The feed-forward takes K5
(``ops.conv_ff``) on the card where no gradient is recorded
(``ConvFeedForward.route``).

Training (a ``dropout_seed`` given): attention dropout takes the JAX
package's explicit path (f32 scores, -1e30 on masked keys, softmax, dropout
on the probabilities), never the kernel; the feed-forward drops out after
its SiGLU. Each dropout site draws its mask from a generator seeded by the
step's seed, the layer and the site, so a recompute draws the same mask.
``remat`` recomputes each layer's attention and feed-forward in the backward
pass (``torch.utils.checkpoint``) instead of keeping their activations.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.precision import DEFAULT, Policy
from ..core.tracing import trace_count
from ..ops import conv_ff
from ..ops.attention import dot_product_attention
from ..ops.build import kernel_route, records_grad

RMS_EPS = float(torch.finfo(torch.float32).eps)  # torch nn.RMSNorm eps=None


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    hidden_size: int = 256
    depth: int = 4
    heads: int = 2
    intermediate_size: int = 896
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    use_unet_skip_connection: bool = False
    remat: bool = False  # recompute attention and feed-forward in the backward pass


def rotary_frequencies(seq_len: int, dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """(seq_len, dim) f32 rotary angle table, frequencies duplicated across halves."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cat([freqs, freqs], dim=-1)


def apply_rotary(pos: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotate (..., N, D) by the angle table (N, D), half-split, in f32."""
    t32 = t.float()
    d = t32.shape[-1]
    t1, t2 = t32[..., : d // 2], t32[..., d // 2 :]
    rotated = torch.cat([-t2, t1], dim=-1)
    return (t32 * torch.cos(pos) + rotated * torch.sin(pos)).to(t.dtype)


def site_seed(seed: int, site: int) -> int:
    """The seed of one dropout site, a pure function of the step's seed and the site."""
    return (seed * 1_000_003 + site) % 2**63


def draw_rows(draw, shape, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``draw(shape)``, or with ``rows = (first, total)`` (a data replica's
    rows of a global batch of ``total``) ``draw`` over the global batch and
    this replica's rows of it: the replicas together draw what one process
    draws for the whole batch."""
    if rows is None:
        return draw(tuple(shape))
    first, total = rows
    return draw((total, *shape[1:]))[first : first + shape[0]]


def dropout(x: torch.Tensor, rate: float, seed: int, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout: x / (1 - rate) where a uniform draw from a generator
    seeded with ``seed`` is at least ``rate``, else 0 (``rows``: see
    ``draw_rows``)."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = draw_rows(lambda shape: torch.rand(shape, generator=gen, device=x.device), x.shape, rows) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _conv_same(x: torch.Tensor, conv: nn.Conv1d, dtype: torch.dtype) -> torch.Tensor:
    """SAME conv of (B, N, C) through ``conv`` (torch layout), in ``dtype``."""
    k = conv.kernel_size[0]
    lo = (k - 1) // 2
    h = F.pad(x.to(dtype).transpose(1, 2), (lo, k - 1 - lo))
    out = F.conv1d(h, conv.weight.to(dtype), conv.bias.to(dtype), groups=conv.groups)
    return out.transpose(1, 2)


class AdaptiveRMSNorm(nn.Module):
    """L2-normalize * sqrt(d) * (W @ cond + 1), with 1e-24 inside the rsqrt."""

    def __init__(self, hidden_size: int, policy: Policy = DEFAULT):
        super().__init__()
        self.policy = policy
        self.hidden_size = hidden_size
        self.to_weight = nn.Linear(hidden_size, hidden_size, bias=False, dtype=policy.param_dtype)

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        normed = x32 * torch.rsqrt(torch.sum(x32 * x32, dim=-1, keepdim=True) + 1e-24)
        gamma = F.linear(condition.float(), self.to_weight.weight.float())  # (B, d)
        out = normed * self.hidden_size**0.5 * (gamma[:, None, :] + 1.0)
        return out.to(self.policy.compute_dtype)


class RMSNorm(nn.Module):
    """Final learned RMSNorm (mean square, eps = finfo(f32).eps)."""

    def __init__(self, hidden_size: int, policy: Policy = DEFAULT, eps: float = RMS_EPS):
        super().__init__()
        self.policy = policy
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden_size, dtype=policy.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        normed = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + self.eps)
        return (normed * self.weight.float()).to(self.policy.compute_dtype)


class RandomFourierEmbed(nn.Module):
    """Frozen random Fourier features [x, sin(2 pi x w), cos(2 pi x w)] in f32."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.register_buffer("weights", torch.zeros(hidden_size // 2, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, None].float()
        freqs = x * self.weights[None, :] * 2 * math.pi
        return torch.cat([x, torch.sin(freqs), torch.cos(freqs)], dim=-1)


class TimeConditionEmbed(nn.Sequential):
    """Fourier features -> Linear(d+1 -> d) -> SiLU, in f32 (keys ``0``, ``1``)."""

    def __init__(self, hidden_size: int, policy: Policy = DEFAULT):
        super().__init__(
            RandomFourierEmbed(hidden_size),
            nn.Linear(hidden_size + 1, hidden_size, dtype=policy.param_dtype),
            nn.SiLU(),
        )

    def forward(self, times: torch.Tensor) -> torch.Tensor:
        return F.silu(_linear(self[0](times), self[1], torch.float32))


class ConvPositionEmbed(nn.Module):
    """Depthwise conv1d + exact GELU; masks its input and its output."""

    def __init__(self, hidden_size: int, kernel_size: int = 31, groups: int = 256, policy: Policy = DEFAULT):
        super().__init__()
        self.policy = policy
        self.dw_conv1d = nn.Sequential(
            nn.Conv1d(hidden_size, hidden_size, kernel_size, groups=groups, dtype=policy.param_dtype), nn.GELU()
        )

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is not None:
            x = x.masked_fill(~mask[..., None], 0)
        out = F.gelu(_conv_same(x, self.dw_conv1d[0], self.policy.compute_dtype))
        if mask is not None:
            out = out.masked_fill(~mask[..., None], 0)
        return out


class Attention(nn.Module):
    """Fused-QKV rotary attention."""

    def __init__(self, hidden_size: int, heads: int, policy: Policy = DEFAULT, dropout: float = 0.0,
                 attn_implementation: str = "auto"):
        super().__init__()
        self.policy = policy
        self.heads = heads
        self.dropout = dropout
        self.attn_implementation = attn_implementation
        self.to_qkv = nn.Linear(hidden_size, 3 * hidden_size, bias=False, dtype=policy.param_dtype)
        self.to_out = nn.Linear(hidden_size, hidden_size, bias=False, dtype=policy.param_dtype)

    def forward(self, x, mask=None, rotary_pos=None, dropout_seed=None, dropout_rows=None):
        b, n, c = x.shape
        cd = self.policy.compute_dtype
        qkv = _linear(x, self.to_qkv, cd).view(b, n, 3, self.heads, c // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # each (B, H, N, D)
        if rotary_pos is not None:
            q, k = apply_rotary(rotary_pos, q), apply_rotary(rotary_pos, k)
        if self.dropout > 0 and dropout_seed is not None:
            scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / q.shape[-1] ** 0.5
            if mask is not None:
                scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
            probs = dropout(torch.softmax(scores, dim=-1), self.dropout, dropout_seed, dropout_rows)
            out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
        else:
            out = dot_product_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), mask=mask, implementation=self.attn_implementation
            )
        out = out.transpose(1, 2).reshape(b, n, c)
        return _linear(out, self.to_out, cd)


class ConvFeedForward(nn.Module):
    """Conv1d(k=3) -> SiGLU (gate = second channel half) -> Conv1d(k=3); masks
    its input and the hidden activation.

    The route, decided from what each call shows (``route``, by the rule the
    vocoder's kernels follow, ``ops.build.kernel_route``): ``"kernel"`` (K5,
    ``ops.conv_ff``: two channels-last launches, no layout copies) for a CUDA
    tensor in a bf16 compute dtype with no gradient recorded, no dropout, C a
    multiple of 256 and I of 128; ``"reference"`` (K5's plain version) for the same call on the CPU;
    ``"plain chain"`` (the torch convs) for everything else: every training
    step and the FLOAT32 policy. The kernel's weights are laid out once and
    again only when a parameter moves, is replaced or changes in place. While
    a profiler session records, each call counts its B * N frame rows as
    ``decoder.ff_kernel_rows`` on the kernel route and ``decoder.ff_plain_rows``
    on the others."""

    def __init__(self, hidden_size: int, intermediate_size: int, kernel_size: int = 3, policy: Policy = DEFAULT,
                 dropout: float = 0.0):
        super().__init__()
        self.policy = policy
        self.dropout = dropout
        self.conv1 = nn.Conv1d(hidden_size, 2 * intermediate_size, kernel_size, dtype=policy.param_dtype)
        self.conv2 = nn.Conv1d(intermediate_size, hidden_size, kernel_size, dtype=policy.param_dtype)
        self.kernel_fits = (
            conv_ff.ff_kernel_fits(hidden_size, intermediate_size, kernel_size) and policy.compute_dtype == torch.bfloat16
        )
        self._ops = None  # (parameter key, the weights laid out for K5)

    def route(self, x: torch.Tensor, dropout_on: bool = False) -> str:
        return kernel_route(self.kernel_fits and not dropout_on, x.is_cuda, records_grad(x, self))

    def operands(self) -> conv_ff.FFOperands:
        """The weights laid out for K5, kept until a parameter moves, is
        replaced or changes in place."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._ops is None or self._ops[0] != key:
            with torch.no_grad():
                ops = conv_ff.ff_operands(self.conv1.weight, self.conv1.bias, self.conv2.weight, self.conv2.bias,
                                          self.policy.compute_dtype)
            self._ops = key, ops
        return self._ops[1]

    def forward(self, x, mask=None, dropout_seed=None, dropout_rows=None):
        cd = self.policy.compute_dtype
        dropout_on = self.dropout > 0 and dropout_seed is not None
        route = self.route(x, dropout_on)
        trace_count("decoder.ff_kernel_rows" if route == "kernel" else "decoder.ff_plain_rows", x.shape[0] * x.shape[1])
        if mask is not None:
            x = x.masked_fill(~mask[..., None], 0)
        if route != "plain chain":
            return conv_ff.conv_ff(x.to(cd).contiguous(), self.operands(), mask)
        value, gate = _conv_same(x, self.conv1, cd).chunk(2, dim=-1)
        h = F.silu(gate) * value
        if dropout_on:
            h = dropout(h, self.dropout, dropout_seed, dropout_rows)
        if mask is not None:
            h = h.masked_fill(~mask[..., None], 0)
        return _conv_same(h, self.conv2, cd)


class Transformer(nn.Module):
    """depth x (AdaRMSNorm -> Attn -> AdaRMSNorm -> ConvFF) pre-norm residual
    stack with optional U-Net skips, then a final RMSNorm."""

    def __init__(self, config: TransformerConfig, policy: Policy = DEFAULT, attn_implementation: str = "auto"):
        super().__init__()
        if config.depth % 2:
            raise ValueError(f"depth must be even, got {config.depth}")
        self.config = config
        self.policy = policy
        h = config.hidden_size
        layers = []
        for ind in range(config.depth):
            has_skip = config.use_unet_skip_connection and ind + 1 > config.depth // 2
            layers.append(
                nn.ModuleList(
                    [
                        nn.Linear(2 * h, h, bias=False, dtype=policy.param_dtype) if has_skip else None,
                        AdaptiveRMSNorm(h, policy),
                        Attention(h, config.heads, policy, config.attn_dropout, attn_implementation),
                        AdaptiveRMSNorm(h, policy),
                        ConvFeedForward(h, config.intermediate_size, policy=policy, dropout=config.ff_dropout),
                    ]
                )
            )
        self.layers = nn.ModuleList(layers)
        self.final_norm = RMSNorm(h, policy)

    def forward(self, x, mask=None, time_cond=None, dropout_seed=None, dropout_rows=None):
        """``dropout_seed``: training mode (dropout on, seeded per layer and
        site); None at inference. ``dropout_rows``: see ``draw_rows``."""
        cfg = self.config
        rotary_pos = rotary_frequencies(x.shape[1], cfg.hidden_size // cfg.heads, device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()

        def run(block, *args):
            return checkpoint(block, *args, use_reentrant=False) if remat else block(*args)

        def seed(site):
            return None if dropout_seed is None else site_seed(dropout_seed, site)

        skips = []
        for ind, (skip_combiner, attn_norm, attn, ff_norm, ff) in enumerate(self.layers):
            if skip_combiner is None:
                skips.append(x)
            else:
                x = _linear(torch.cat([x, skips.pop()], dim=-1), skip_combiner, self.policy.compute_dtype)
            x = run(attn, attn_norm(x, time_cond), mask, rotary_pos, seed(2 * ind), dropout_rows) + x
            x = run(ff, ff_norm(x, time_cond), mask, seed(2 * ind + 1), dropout_rows) + x
        return self.final_norm(x)
