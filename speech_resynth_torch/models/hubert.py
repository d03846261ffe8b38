"""HuBERT / mHuBERT dense speech encoder, inference path.

Counterpart of speech_resynth_tpu/models/hubert.py: a 16 kHz waveform goes
through a strided conv feature extractor (x320, 50 Hz frames), a feature
projection, a grouped conv positional embedding and a post-LN transformer;
the output is the hidden state of one layer (768-d), which the k-means
quantizer reads.

Parameter names are HF ``HubertModel``'s, so a converted checkpoint loads
with ``load_state_dict`` (``models/convert.py:hubert_state_dict_from_hf``
folds the weight-normed positional conv into one weight).

Numerics, as in the JAX package: the conv stack, the feature projection and
the positional conv run in f32; the transformer layers in the policy's
compute dtype, with LayerNorm statistics in f32; the output is f32. With
``num_samples`` (right-padded ragged batches) the first conv's instance norm
takes its statistics from valid frames only and pad frames are zeroed after
every conv layer and before the positional conv, so a padded row's valid
frames equal the unpadded run of that row. Attention goes through
``ops.attention.dot_product_attention``, routed by ``attn_implementation``
(default "auto": the flash kernel K1, d=64, bidirectional, key-padding mask,
on the card; "xla": the plain version).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import DEFAULT, Policy
from ..ops.attention import dot_product_attention
from .transformer import _linear

GROUP_NORM_EPS = 1e-5
WAV_NORM_EPS = 1e-7


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    do_normalize: bool = False  # wav zero-mean / unit-variance (False for the base checkpoints)

    @property
    def total_stride(self) -> int:
        out = 1
        for s in self.conv_stride:
            out *= s
        return out

    def num_frames(self, num_samples):
        """Frames of the VALID conv stack; takes ints, arrays or tensors."""
        n = num_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            n = (n - k) // s + 1
        return n


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with f32 statistics; the result takes the wider of x's and
    the parameters' dtypes (Flax's LayerNorm promotion)."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps)
    return y.to(torch.promote_types(x.dtype, ln.weight.dtype))


class _ConvLayer(nn.Module):
    """VALID strided conv (no bias) -> [instance norm] -> exact GELU, on (B, C, T) f32."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int, use_group_norm: bool, policy: Policy):
        super().__init__()
        self.conv = nn.Conv1d(in_ch, out_ch, kernel_size, stride=stride, bias=False, dtype=policy.param_dtype)
        if use_group_norm:
            # GroupNorm(groups = channels): per-channel instance norm over time
            self.layer_norm = nn.GroupNorm(out_ch, out_ch, eps=GROUP_NORM_EPS, dtype=policy.param_dtype)
        else:
            self.layer_norm = None

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = F.conv1d(x.float(), self.conv.weight.float(), stride=self.conv.stride)
        mask = None
        if lengths is not None:
            mask = (torch.arange(x.shape[-1], device=x.device)[None, :] < lengths[:, None])[:, None, :]  # (B, 1, T)
        if self.layer_norm is not None:
            if mask is None:
                mean = x.mean(dim=-1, keepdim=True)
                var = torch.square(x - mean).mean(dim=-1, keepdim=True)
            else:
                m = mask.float()
                count = m.sum(dim=-1, keepdim=True).clamp(min=1.0)
                mean = (x * m).sum(dim=-1, keepdim=True) / count
                var = (torch.square(x - mean) * m).sum(dim=-1, keepdim=True) / count
            x = (x - mean) * torch.rsqrt(var + GROUP_NORM_EPS)
            x = x * self.layer_norm.weight.float()[:, None] + self.layer_norm.bias.float()[:, None]
        x = F.gelu(x)
        if mask is not None:
            x = x.masked_fill(~mask, 0.0)
        return x


class ConvFeatureExtractor(nn.Module):
    """Strided conv stack, the first layer instance-normed: (B, T) wav -> (B, C, T') f32."""

    def __init__(self, config: HubertConfig, policy: Policy = DEFAULT):
        super().__init__()
        cfg = config
        self.config = config
        in_dims = (1,) + tuple(cfg.conv_dim[:-1])
        self.conv_layers = nn.ModuleList(
            _ConvLayer(i, o, k, s, use_group_norm=(n == 0), policy=policy)
            for n, (i, o, k, s) in enumerate(zip(in_dims, cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride))
        )

    def forward(self, wav: torch.Tensor, num_samples: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = wav.float()[:, None, :]
        lengths = num_samples
        for layer in self.conv_layers:
            if lengths is not None:
                k, s = layer.conv.kernel_size[0], layer.conv.stride[0]
                lengths = torch.div(lengths - k, s, rounding_mode="floor") + 1
            x = layer(x, lengths)
        return x


class FeatureProjection(nn.Module):
    def __init__(self, config: HubertConfig, policy: Policy = DEFAULT):
        super().__init__()
        self.layer_norm = nn.LayerNorm(config.conv_dim[-1], eps=config.layer_norm_eps, dtype=policy.param_dtype)
        self.projection = nn.Linear(config.conv_dim[-1], config.hidden_size, dtype=policy.param_dtype)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return _linear(_layer_norm(feats, self.layer_norm), self.projection, torch.float32)


class PositionalConvEmbedding(nn.Module):
    """Grouped conv (k=128, pad k//2, 16 groups) + exact GELU in f32; an even
    kernel drops the last output frame."""

    def __init__(self, config: HubertConfig, policy: Policy = DEFAULT):
        super().__init__()
        k = config.num_conv_pos_embeddings
        self.conv = nn.Conv1d(
            config.hidden_size, config.hidden_size, k, padding=k // 2,
            groups=config.num_conv_pos_embedding_groups, dtype=policy.param_dtype,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, C) f32 -> (B, N, C) f32."""
        pos = F.conv1d(
            x.float().transpose(1, 2), self.conv.weight.float(), self.conv.bias.float(),
            padding=self.conv.padding, groups=self.conv.groups,
        )
        if self.conv.kernel_size[0] % 2 == 0:
            pos = pos[..., :-1]
        return F.gelu(pos).transpose(1, 2)


class SelfAttention(nn.Module):
    def __init__(self, config: HubertConfig, policy: Policy = DEFAULT, attn_implementation: str = "auto"):
        super().__init__()
        h = config.hidden_size
        self.heads = config.num_attention_heads
        self.policy = policy
        self.attn_implementation = attn_implementation
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(h, h, dtype=policy.param_dtype) for _ in range(4)
        )

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, c = x.shape
        cd = self.policy.compute_dtype

        def heads(proj):
            return _linear(x, proj, cd).view(b, n, self.heads, c // self.heads).transpose(1, 2).contiguous()

        out = dot_product_attention(
            heads(self.q_proj), heads(self.k_proj), heads(self.v_proj), mask=mask, implementation=self.attn_implementation
        )
        return _linear(out.transpose(1, 2).reshape(b, n, c), self.out_proj, cd)


class FeedForward(nn.Module):
    def __init__(self, config: HubertConfig, policy: Policy = DEFAULT):
        super().__init__()
        self.policy = policy
        self.intermediate_dense = nn.Linear(config.hidden_size, config.intermediate_size, dtype=policy.param_dtype)
        self.output_dense = nn.Linear(config.intermediate_size, config.hidden_size, dtype=policy.param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        return _linear(F.gelu(_linear(x, self.intermediate_dense, cd)), self.output_dense, cd)


class HubertLayer(nn.Module):
    """Post-LN transformer block (HF do_stable_layer_norm=False)."""

    def __init__(self, config: HubertConfig, policy: Policy = DEFAULT, attn_implementation: str = "auto"):
        super().__init__()
        pd = policy.param_dtype
        self.attention = SelfAttention(config, policy, attn_implementation)
        self.layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps, dtype=pd)
        self.feed_forward = FeedForward(config, policy)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps, dtype=pd)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = _layer_norm(x + self.attention(x, mask), self.layer_norm)
        return _layer_norm(x + self.feed_forward(x), self.final_layer_norm)


class TransformerEncoder(nn.Module):
    def __init__(self, config: HubertConfig, policy: Policy = DEFAULT, attn_implementation: str = "auto"):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(config, policy)
        self.layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps, dtype=policy.param_dtype)
        self.layers = nn.ModuleList(
            HubertLayer(config, policy, attn_implementation) for _ in range(config.num_hidden_layers)
        )


class HubertEncoder(nn.Module):
    """``attn_implementation`` routes every layer's attention
    (``ops.attention.dot_product_attention``: "auto", "pallas" or "xla")."""

    def __init__(self, config: HubertConfig = HubertConfig(), policy: Policy = DEFAULT, attn_implementation: str = "auto"):
        super().__init__()
        self.config = config
        self.policy = policy
        self.feature_extractor = ConvFeatureExtractor(config, policy)
        self.feature_projection = FeatureProjection(config, policy)
        self.encoder = TransformerEncoder(config, policy, attn_implementation)

    def forward(
        self,
        wav: torch.Tensor,
        frame_mask: Optional[torch.Tensor] = None,
        output_layer: Optional[int] = None,
        num_samples: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(B, T) 16 kHz waveform -> (B, T', hidden) hidden states in the
        policy's output dtype.

        ``output_layer``: 1-indexed layer whose output to return (11 for the
        mhubert kmeans-expresso codebook); only that many layers run. None runs
        them all. ``num_samples`` (B,): valid samples per row of a right-padded
        batch; it also gives ``frame_mask`` when that is not passed."""
        cfg = self.config
        sample_mask = None
        if num_samples is not None:
            num_samples = torch.as_tensor(num_samples, device=wav.device).long()
            sample_mask = torch.arange(wav.shape[-1], device=wav.device)[None, :] < num_samples[:, None]
            if frame_mask is None:
                n_frames = cfg.num_frames(num_samples)
                frame_mask = torch.arange(cfg.num_frames(wav.shape[-1]), device=wav.device)[None, :] < n_frames[:, None]
        if cfg.do_normalize:
            wav = wav.float()
            if sample_mask is None:
                mean = wav.mean(dim=-1, keepdim=True)
                var = torch.square(wav - mean).mean(dim=-1, keepdim=True)
            else:
                m = sample_mask.float()
                count = m.sum(dim=-1, keepdim=True).clamp(min=1.0)
                mean = (wav * m).sum(dim=-1, keepdim=True) / count
                var = (torch.square(wav - mean) * m).sum(dim=-1, keepdim=True) / count
            wav = (wav - mean) * torch.rsqrt(var + WAV_NORM_EPS)
            if sample_mask is not None:
                wav = wav.masked_fill(~sample_mask, 0.0)

        feats = self.feature_extractor(wav, num_samples).transpose(1, 2)  # (B, T', C) f32
        x = self.feature_projection(feats)
        if frame_mask is not None:
            # pad frames are zero, so the zero-padded positional conv sees what an unpadded run sees
            x = x.masked_fill(~frame_mask[..., None], 0.0)
        x = x + self.encoder.pos_conv_embed(x)
        x = _layer_norm(x, self.encoder.layer_norm).to(self.policy.compute_dtype)

        num_layers = output_layer if output_layer is not None else cfg.num_hidden_layers
        for layer in self.encoder.layers[:num_layers]:
            x = layer(x, frame_mask)
        return x.to(self.policy.output_dtype)
