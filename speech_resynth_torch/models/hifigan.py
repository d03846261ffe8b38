"""HiFi-GAN generator, inference path.

Counterpart of speech_resynth_tpu/models/hifigan.py (``HifiGanConfig``,
``ResidualBlock``, ``HifiGanGenerator``, and the stage routing of
``generator_apply_fused``). Activations are (B, C, T) inside, as torch convs
want them; the public input is the JAX package's (B, T, mel) log-mel and
the output a (B, (T-1)*320 + 400) waveform at the default config.

The narrow MRF stages whose branches K2 takes (``mrf_branch_fits``: C in
16, 32, 64, odd kernel size) run each branch through
``ops.fused_mrf.mrf_branch``, which is the hand-written kernel K2 on the card,
and the mean of the branches in PyTorch; other stages run the plain conv
chain. Neither kernel has a backward, so a call that records a gradient
(``records_grad``) runs the plain conv chain everywhere, as the JAX package
trains the flax generator and keeps its kernels to inference
(``mrf_route``). While ``ops.fused_mrf.MRF_STAGE_FUSION`` is set (``mrf_stage_fusion``),
a stage that K3 takes (``stage_fusion_eligible``: its widest branch fits
K2's block) runs whole through ``ops.fused_mrf.mrf_stage`` instead: one
launch of K2's block that loops over the branches and keeps their f32 sum,
rounded once after the mean. The generator lays each such stage's weights
out for K3 once (``ops.fused_mrf.stage_operands``) and again only when a
parameter changes. Module names follow the HF
``FastSpeech2ConformerHifiGan`` checkpoint keys.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import DEFAULT, Policy
from ..ops import fused_mrf
from ..ops.fused_mrf import LRELU_SLOPE, mrf_branch, mrf_branch_fits, mrf_stage, mrf_stage_fits

FUSED_MAX_CHANNELS = 64


@dataclasses.dataclass(frozen=True)
class HifiGanConfig:
    model_in_dim: int = 80
    upsample_initial_channel: int = 512
    upsample_rates: Tuple[int, ...] = (5, 4, 4, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (10, 9, 8, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    leaky_relu_slope: float = LRELU_SLOPE
    normalize_before: bool = False

    @classmethod
    def from_dict(cls, v: dict) -> "HifiGanConfig":
        """Parse an HF-format vocoder config dict (missing keys take defaults)."""
        d = cls()
        return cls(
            model_in_dim=v.get("model_in_dim", d.model_in_dim),
            upsample_initial_channel=v.get("upsample_initial_channel", d.upsample_initial_channel),
            upsample_rates=tuple(v.get("upsample_rates", d.upsample_rates)),
            upsample_kernel_sizes=tuple(v.get("upsample_kernel_sizes", d.upsample_kernel_sizes)),
            resblock_kernel_sizes=tuple(v.get("resblock_kernel_sizes", d.resblock_kernel_sizes)),
            resblock_dilation_sizes=tuple(tuple(x) for x in v.get("resblock_dilation_sizes", d.resblock_dilation_sizes)),
            leaky_relu_slope=v.get("leaky_relu_slope", d.leaky_relu_slope),
            normalize_before=v.get("normalize_before", d.normalize_before),
        )

    @property
    def total_upsample(self) -> int:
        return int(np.prod(self.upsample_rates))

    def waveform_lengths(self, spectrogram_lengths):
        """ConvTranspose length propagation: (L-1)*stride - 2*pad + kernel per
        stage; (L-1)*320 + 400 at the default config. Takes ints, arrays or tensors."""
        out = spectrogram_lengths
        for k, s in zip(self.upsample_kernel_sizes, self.upsample_rates):
            out = (out - 1) * s - 2 * ((k - s) // 2) + k
        return out


def stage_fusion_eligible(channels: int, kernel_sizes, dilation_sizes, itemsize: int) -> bool:
    """The stage gate of ``generator_apply_fused``: C <= 64, every branch
    kernel odd, and K3 takes the stage."""
    shapes = [(k, tuple(d)) for k, d in zip(kernel_sizes, dilation_sizes)]
    return (
        channels <= FUSED_MAX_CHANNELS
        and all(k % 2 == 1 for k in kernel_sizes)
        and mrf_stage_fits(channels, shapes, itemsize)
    )


def records_grad(x: torch.Tensor, module: nn.Module) -> bool:
    """Whether autograd records a call of ``module`` on ``x``: grad mode is on
    and the input or one of the module's parameters requires grad."""
    return torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in module.parameters()))


def mrf_route(fits: bool, on_card: bool, grad: bool) -> str:
    """How a branch or a stage runs: ``"kernel"`` (K2 or K3) where the kernel
    takes it, on the card, with no gradient recorded; ``"reference"`` (the
    kernel's plain version) for the same call on the CPU; ``"plain chain"``
    (the conv chain) otherwise. Decided before any launch."""
    if not fits or grad:
        return "plain chain"
    return "kernel" if on_card else "reference"


def _conv(x: torch.Tensor, conv: nn.Conv1d, dtype: torch.dtype) -> torch.Tensor:
    return F.conv1d(
        x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype), padding=conv.padding, dilation=conv.dilation
    )


class ResidualBlock(nn.Module):
    """One multi-receptive-field branch (HifiGanResidualBlock): for each
    dilation d, x += conv(lrelu(conv_d(lrelu(x)))) with SAME padding."""

    def __init__(self, channels: int, kernel_size: int, dilations: Tuple[int, ...], slope: float = LRELU_SLOPE,
                 policy: Policy = DEFAULT):
        super().__init__()
        self.policy = policy
        self.slope = slope
        self.dilations = tuple(dilations)
        pd = policy.param_dtype
        itemsize = torch.empty((), dtype=policy.compute_dtype).element_size()
        # the branch gate of generator_apply_fused: K2 takes the branch (C <= 64 and an odd kernel among it)
        self.fused = mrf_branch_fits(channels, kernel_size, self.dilations, itemsize)
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d, padding=(kernel_size * d - d) // 2, dtype=pd)
            for d in self.dilations
        )
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2, dtype=pd) for _ in self.dilations
        )

    def operands(self):
        """(w1, b1, w2, b2, dilations) in the compute dtype, stacked over the
        conv pairs: a branch as the fused MRF kernels take it."""
        cd = self.policy.compute_dtype
        w1 = torch.stack([c.weight for c in self.convs1]).to(cd)
        b1 = torch.stack([c.bias for c in self.convs1]).to(cd)
        w2 = torch.stack([c.weight for c in self.convs2]).to(cd)
        b2 = torch.stack([c.bias for c in self.convs2]).to(cd)
        return w1, b1, w2, b2, self.dilations

    def route(self, x: torch.Tensor) -> str:
        return mrf_route(self.fused, x.is_cuda, records_grad(x, self))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        if self.route(x) != "plain chain":
            return mrf_branch(x.to(cd).contiguous(), *self.operands(), self.slope)
        for c1, c2 in zip(self.convs1, self.convs2):
            h = _conv(F.leaky_relu(x, self.slope), c1, cd)
            h = _conv(F.leaky_relu(h, self.slope), c2, cd)
            x = h + x
        return x


class HifiGanGenerator(nn.Module):
    """log-mel (B, T, mel) -> waveform (B, (T-1)*320 + 400)."""

    def __init__(self, config: HifiGanConfig = HifiGanConfig(), policy: Policy = DEFAULT):
        super().__init__()
        cfg = config
        self.config = config
        self.policy = policy
        pd = policy.param_dtype
        self.conv_pre = nn.Conv1d(cfg.model_in_dim, cfg.upsample_initial_channel, 7, padding=3, dtype=pd)
        self.upsampler = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        itemsize = torch.empty((), dtype=policy.compute_dtype).element_size()
        stage_eligible = []
        for i, (rate, kernel) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            c_in, c_out = cfg.upsample_initial_channel // 2**i, cfg.upsample_initial_channel // 2 ** (i + 1)
            stage_eligible.append(
                stage_fusion_eligible(c_out, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes, itemsize)
            )
            self.upsampler.append(nn.ConvTranspose1d(c_in, c_out, kernel, rate, padding=(kernel - rate) // 2, dtype=pd))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(ResidualBlock(c_out, rk, tuple(rd), cfg.leaky_relu_slope, policy))
        self.stage_eligible = tuple(stage_eligible)  # per upsampling stage: K3 may run it
        self._stage_ops = {}  # stage -> (parameter key, its weights laid out for K3)
        self.conv_post = nn.Conv1d(c_out, 1, 7, padding=3, dtype=pd)
        self.register_buffer("mean", torch.zeros(cfg.model_in_dim, dtype=torch.float32))
        self.register_buffer("scale", torch.ones(cfg.model_in_dim, dtype=torch.float32))

    def _stage_operands(self, stage: int, blocks) -> fused_mrf.StageOperands:
        """The stage's branches laid out for K3, kept until one of its
        parameters moves, is replaced or changes in place."""
        key = tuple((p.data_ptr(), p._version) for p in blocks.parameters())
        hit = self._stage_ops.get(stage)
        if hit is None or hit[0] != key:
            hit = key, fused_mrf.stage_operands([blk.operands() for blk in blocks])
            self._stage_ops[stage] = hit
        return hit[1]

    def forward(self, spectrogram: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        cd = self.policy.compute_dtype
        slope = cfg.leaky_relu_slope
        if cfg.normalize_before:
            spectrogram = (spectrogram - self.mean) / self.scale
        x = _conv(spectrogram.transpose(1, 2), self.conv_pre, cd)
        num_kernels = len(cfg.resblock_kernel_sizes)
        for i, up in enumerate(self.upsampler):
            x = F.leaky_relu(x, slope)
            x = F.conv_transpose1d(x, up.weight.to(cd), up.bias.to(cd), stride=up.stride, padding=up.padding)
            blocks = self.resblocks[i * num_kernels : (i + 1) * num_kernels]
            fits = fused_mrf.MRF_STAGE_FUSION and self.stage_eligible[i]
            if mrf_route(fits, x.is_cuda, records_grad(x, self)) != "plain chain":
                x = mrf_stage(x.to(cd).contiguous(), self._stage_operands(i, blocks), slope)
                continue
            res = None
            for blk in blocks:
                out = blk(x)
                res = out if res is None else res + out
            x = res / num_kernels
        x = _conv(F.leaky_relu(x, slope), self.conv_post, cd)
        return torch.tanh(x)[:, 0, :].to(self.policy.output_dtype)


# ---------------------------------------------------------------------------
# discriminators and GAN losses (training only)
# ---------------------------------------------------------------------------


def _weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """w = g * v / |v|, the norm over every axis but the output channels (axis
    0 here), 1e-24 inside the root, in f32 and back to v's dtype."""
    v32 = v.float()
    norm = torch.sqrt(torch.sum(v32 * v32, dim=tuple(range(1, v.ndim)), keepdim=True) + 1e-24)
    return (g.float().view(-1, *[1] * (v.ndim - 1)) * v32 / norm).to(v.dtype)


class WNConv2d(nn.Module):
    """Weight-normed Conv2d on (B, C, H, W): parameters ``v`` (O, I, kh, kw),
    ``g`` (O,) and ``bias``."""

    def __init__(self, c_in: int, c_out: int, kernel_size, stride=(1, 1), padding=(0, 0), policy: Policy = DEFAULT):
        super().__init__()
        self.policy, self.stride, self.padding = policy, tuple(stride), tuple(padding)
        pd = policy.param_dtype
        self.v = nn.Parameter(torch.empty(c_out, c_in, *kernel_size, dtype=pd))
        self.g = nn.Parameter(torch.ones(c_out, dtype=pd))
        self.bias = nn.Parameter(torch.zeros(c_out, dtype=pd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        w = _weight_norm(self.v, self.g)
        return F.conv2d(x.to(cd), w.to(cd), self.bias.to(cd), self.stride, self.padding)


class WNConv1d(nn.Module):
    """Weight-normed Conv1d on (B, C, T) (``v``, ``g``, ``bias``), or with
    ``spectral`` spectral-normed (``weight``, ``bias`` and the power
    iteration's ``u`` buffer). The spectral norm runs one power-iteration
    step on W viewed as (O, K*I) every call: v = W^T u / |.|, u' = W v / |.|
    (1e-12 under each norm), sigma = u'^T W v with u' and v held constant,
    W / sigma; ``u`` takes u' only when ``update_stats``."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int = 1, padding: int = 0, groups: int = 1,
                 spectral: bool = False, policy: Policy = DEFAULT):
        super().__init__()
        self.policy, self.stride, self.padding, self.groups, self.spectral = policy, stride, padding, groups, spectral
        pd = policy.param_dtype
        shape = (c_out, c_in // groups, kernel_size)
        if spectral:
            self.weight = nn.Parameter(torch.empty(shape, dtype=pd))
            self.register_buffer("u", torch.zeros(c_out, dtype=torch.float32))
        else:
            self.v = nn.Parameter(torch.empty(shape, dtype=pd))
            self.g = nn.Parameter(torch.ones(c_out, dtype=pd))
        self.bias = nn.Parameter(torch.zeros(c_out, dtype=pd))

    def _spectral_weight(self, update_stats: bool) -> torch.Tensor:
        w_mat = self.weight.float().reshape(self.weight.shape[0], -1)  # (O, I*K): sigma is the same in any column order
        with torch.no_grad():
            v = w_mat.T @ self.u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = w_mat @ v
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
            if update_stats:
                self.u.copy_(u)
        sigma = torch.einsum("i,ij,j->", u, w_mat, v)
        return (self.weight.float() / sigma).to(self.weight.dtype)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        cd = self.policy.compute_dtype
        w = self._spectral_weight(update_stats) if self.spectral else _weight_norm(self.v, self.g)
        return F.conv1d(x.to(cd), w.to(cd), self.bias.to(cd), self.stride, self.padding, 1, self.groups)


def _reflect_pad_right(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``pad`` samples of (B, T) mirrored about the last one (numpy's
    ``reflect``), by a flip: its backward is deterministic on the card, where
    ``F.pad(mode="reflect")``'s is not."""
    return torch.cat([x, x[:, -pad - 1 : -1].flip(-1)], dim=-1)


# output channels of DiscriminatorP's strided convs; its fifth conv keeps the last
PERIOD_CHANNELS = (32, 128, 512, 1024)


class DiscriminatorP(nn.Module):
    """Period discriminator: the wave (B, T), reflect-padded to a multiple of
    the period, as (B, 1, T / p, p), through (5, 1) convs strided (3, 1)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3, policy: Policy = DEFAULT):
        super().__init__()
        self.period = period
        pad = (5 * 1 - 1) // 2  # get_padding(5, 1) for every strided layer, as the reference
        chans = (1, *PERIOD_CHANNELS)
        self.convs = nn.ModuleList(
            WNConv2d(chans[i], chans[i + 1], (kernel_size, 1), (stride, 1), (pad, 0), policy) for i in range(4)
        )
        self.convs.append(WNConv2d(chans[-1], chans[-1], (kernel_size, 1), (1, 1), (2, 0), policy))
        self.conv_post = WNConv2d(chans[-1], 1, (3, 1), (1, 1), (1, 0), policy)

    def forward(self, x: torch.Tensor):
        b, t = x.shape
        pad = -t % self.period
        if pad:
            x = _reflect_pad_right(x, pad)
        h = x.reshape(b, 1, -1, self.period)
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(b, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods=(2, 3, 5, 7, 11), policy: Policy = DEFAULT):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p, policy=policy) for p in periods)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """(outs_r, outs_g, fmaps_r, fmaps_g), one entry per period."""
        outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
        for d in self.discriminators:
            o_r, f_r = d(y)
            o_g, f_g = d(y_hat)
            outs_r.append(o_r)
            outs_g.append(o_g)
            fmaps_r.append(f_r)
            fmaps_g.append(f_g)
        return outs_r, outs_g, fmaps_r, fmaps_g


# (channels, kernel, stride, padding, groups) of DiscriminatorS's convs
SCALE_SPECS = (
    (128, 15, 1, 7, 1),
    (128, 41, 2, 20, 4),
    (256, 41, 2, 20, 16),
    (512, 41, 4, 20, 16),
    (1024, 41, 4, 20, 16),
    (1024, 41, 1, 20, 16),
    (1024, 5, 1, 2, 1),
)


class DiscriminatorS(nn.Module):
    """Scale discriminator on the wave (B, T) as (B, 1, T)."""

    def __init__(self, spectral: bool = False, policy: Policy = DEFAULT):
        super().__init__()
        c_in = 1
        self.convs = nn.ModuleList()
        for ch, k, s, p, g in SCALE_SPECS:
            self.convs.append(WNConv1d(c_in, ch, k, s, p, g, spectral, policy))
            c_in = ch
        self.conv_post = WNConv1d(c_in, 1, 3, 1, 1, 1, spectral, policy)

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        h = x[:, None, :]
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h, update_stats), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h, update_stats)
        fmap.append(h)
        return h.reshape(h.shape[0], -1), fmap


class MultiScaleDiscriminator(nn.Module):
    """Three scale discriminators (spectral norm on the first), the wave
    average-pooled (4, stride 2, padding 2, pads counted) between them."""

    def __init__(self, policy: Policy = DEFAULT):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorS(spectral=(i == 0), policy=policy) for i in range(3))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor, update_stats: bool = False):
        """(outs_r, outs_g, fmaps_r, fmaps_g); with ``update_stats`` the first
        scale's ``u`` advances on y, then again on y_hat."""
        outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
        for i, d in enumerate(self.discriminators):
            if i:
                y, y_hat = (F.avg_pool1d(w[:, None], 4, 2, 2, count_include_pad=True)[:, 0] for w in (y, y_hat))
            o_r, f_r = d(y, update_stats)
            o_g, f_g = d(y_hat, update_stats)
            outs_r.append(o_r)
            outs_g.append(o_g)
            fmaps_r.append(f_r)
            fmaps_g.append(f_g)
        return outs_r, outs_g, fmaps_r, fmaps_g


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """2 * sum of mean |real - generated| over every feature map, in f32."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.float() - gl.float()))
    return loss * 2


def discriminator_loss(real_outputs, generated_outputs) -> torch.Tensor:
    """LSGAN: sum of mean (1 - D(y))^2 + mean D(y_hat)^2, in f32."""
    loss = 0.0
    for dr, dg in zip(real_outputs, generated_outputs):
        loss = loss + torch.mean((1 - dr.float()) ** 2) + torch.mean(dg.float() ** 2)
    return loss


def generator_loss(generated_outputs) -> torch.Tensor:
    """LSGAN: sum of mean (1 - D(y_hat))^2, in f32."""
    loss = 0.0
    for dg in generated_outputs:
        loss = loss + torch.mean((1 - dg.float()) ** 2)
    return loss
