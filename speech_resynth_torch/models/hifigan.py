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
chain. While ``ops.fused_mrf.MRF_STAGE_FUSION`` is set (``mrf_stage_fusion``),
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        if self.fused:
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
            if fused_mrf.MRF_STAGE_FUSION and self.stage_eligible[i]:
                x = mrf_stage(x.to(cd).contiguous(), self._stage_operands(i, blocks), slope)
                continue
            res = None
            for blk in blocks:
                out = blk(x)
                res = out if res is None else res + out
            x = res / num_kernels
        x = _conv(F.leaky_relu(x, slope), self.conv_post, cd)
        return torch.tanh(x)[:, 0, :].to(self.policy.output_dtype)
