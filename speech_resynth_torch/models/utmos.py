"""UTMOS MOS predictor (the UTMOS demo's strong learner).

Counterpart of speech_resynth_tpu/models/utmos.py: a wav2vec2-base SSL
tower (the port's ``HubertEncoder``, whose layout is the same network; its
attention through ``ops.attention.dot_product_attention``, so K1 takes it on
the card at (B, 12, T, 64) with the frames' mask), a data-domain and a
listener ("judge") embedding concatenated onto every frame, one
bidirectional LSTM and a ReLU projection head to a score a frame. The
utterance MOS is the masked frame mean, times 2, plus 3, with domain 0 and
the mean-listener judge 288 by default.

The LSTM is ``nn.LSTM`` over a packed sequence, so each row's backward
direction starts at its last valid frame; pad frames come out zero (the
JAX model leaves garbage there), so only valid frames compare. The LSTM and
the head run in f32 whatever the tower's policy, as the JAX model declares
their parameters f32.

Loaders: ``models.convert.utmos_state_dict_from_lightning`` (the published
checkpoint, fairseq names) and ``models.convert.utmos_state_dict`` (the JAX
tree); ``config_from_state_dict`` reads every width from the shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ..core.precision import DEFAULT, Policy
from .hubert import HubertConfig, HubertEncoder


@dataclasses.dataclass(frozen=True)
class UTMOSConfig:
    ssl: HubertConfig = HubertConfig()  # wav2vec2-base has HuBERT-base's layout
    num_domains: int = 3
    domain_dim: int = 128
    num_judges: int = 3280
    judge_dim: int = 128
    lstm_hidden: int = 512
    projection_hidden: int = 2048
    # the demo's inference ids: domain 0, the mean listener
    default_domain_id: int = 0
    default_judge_id: int = 288


class UTMOSPredictor(nn.Module):
    """(B, T) 16 kHz waveform -> (B, T') frame scores (before the MOS scale)."""

    def __init__(self, config: UTMOSConfig = UTMOSConfig(), policy: Policy = DEFAULT, attn_implementation: str = "auto"):
        super().__init__()
        cfg = self.config = config
        self.ssl = HubertEncoder(cfg.ssl, policy, attn_implementation)
        self.domain_embedding = nn.Embedding(cfg.num_domains, cfg.domain_dim)
        self.judge_embedding = nn.Embedding(cfg.num_judges, cfg.judge_dim)
        self.decoder_rnn = nn.LSTM(
            cfg.ssl.hidden_size + cfg.domain_dim + cfg.judge_dim, cfg.lstm_hidden, batch_first=True, bidirectional=True
        )
        self.proj_in = nn.Linear(2 * cfg.lstm_hidden, cfg.projection_hidden)
        self.proj_out = nn.Linear(cfg.projection_hidden, 1)

    def forward(
        self,
        wav: torch.Tensor,
        domain_id: torch.Tensor,
        judge_id: torch.Tensor,
        num_samples: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``num_samples`` (B,): valid samples per row of a right-padded
        batch; it masks the tower and packs the LSTM, so a row's valid
        frames equal its unpadded run."""
        cfg = self.config
        ssl = self.ssl(wav, num_samples=num_samples).float()
        b, t, _ = ssl.shape
        dom = self.domain_embedding(domain_id)[:, None, :].expand(b, t, cfg.domain_dim)
        judge = self.judge_embedding(judge_id)[:, None, :].expand(b, t, cfg.judge_dim)
        x = torch.cat([ssl, dom, judge], dim=-1)
        if num_samples is None:
            h, _ = self.decoder_rnn(x)
        else:
            frames = cfg.ssl.num_frames(torch.as_tensor(num_samples).long()).cpu()
            packed = pack_padded_sequence(x, frames, batch_first=True, enforce_sorted=False)
            h, _ = pad_packed_sequence(self.decoder_rnn(packed)[0], batch_first=True, total_length=t)
        return self.proj_out(F.relu(self.proj_in(h)))[..., 0]

    @staticmethod
    def score_from_frames(frame_scores: torch.Tensor, num_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Masked frame mean -> MOS on the 1-5 scale (the demo's mean * 2 + 3)."""
        if num_frames is None:
            mean = frame_scores.mean(dim=-1)
        else:
            mask = torch.arange(frame_scores.shape[-1], device=frame_scores.device)[None, :] < num_frames[:, None]
            mean = (frame_scores * mask).sum(dim=-1) / mask.sum(dim=-1).clamp(min=1)
        return mean * 2.0 + 3.0


def config_from_state_dict(sd: Mapping[str, torch.Tensor], conv_stride=None) -> UTMOSConfig:
    """A ``UTMOSConfig`` from the port's state_dict shapes. Strides default
    to wav2vec2-base's schedule and heads to hidden / 64, both true of every
    published UTMOS checkpoint."""
    n_conv = len({k.split(".")[3] for k in sd if k.startswith("ssl.feature_extractor.conv_layers.")})
    convs = [sd[f"ssl.feature_extractor.conv_layers.{i}.conv.weight"].shape for i in range(n_conv)]
    hidden = sd["ssl.feature_projection.projection.weight"].shape[0]
    pos_out, pos_in, pos_k = sd["ssl.encoder.pos_conv_embed.conv.weight"].shape
    ssl = HubertConfig(
        hidden_size=hidden,
        num_hidden_layers=len({k.split(".")[3] for k in sd if k.startswith("ssl.encoder.layers.")}),
        num_attention_heads=max(1, hidden // 64),
        intermediate_size=sd["ssl.encoder.layers.0.feed_forward.intermediate_dense.weight"].shape[0],
        conv_dim=tuple(s[0] for s in convs),
        conv_kernel=tuple(s[2] for s in convs),
        conv_stride=tuple(conv_stride) if conv_stride is not None else (5,) + (2,) * (n_conv - 1),
        num_conv_pos_embeddings=pos_k,
        num_conv_pos_embedding_groups=hidden // pos_in,
        do_normalize=False,  # wav2vec_small: normalize=False
    )
    return UTMOSConfig(
        ssl=ssl,
        num_domains=sd["domain_embedding.weight"].shape[0],
        domain_dim=sd["domain_embedding.weight"].shape[1],
        num_judges=sd["judge_embedding.weight"].shape[0],
        judge_dim=sd["judge_embedding.weight"].shape[1],
        lstm_hidden=sd["decoder_rnn.weight_hh_l0"].shape[1],
        projection_hidden=sd["proj_in.weight"].shape[0],
    )
