"""Conditional flow matching mel decoder, inference path.

Counterpart of speech_resynth_tpu/models/cfm.py (``CFMConfig``,
``DurationPredictor`` and ``ConditionalFlowMatchingModel``: ``_embed_units``,
``_velocity``, ``predict_durations``, ``sample``). ``sample`` integrates the
flow from noise to a log-mel with a fixed-step Euler or midpoint ODE; the ODE
state and the velocity are f32, and pad frames hold log(1e-5). With
``predict_duration`` the unit embeddings are first repeated by the predicted
durations (``ops.length_regulator``) up to a frame bound ``max_frames``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import DEFAULT, Policy
from ..dsp.mel import MEL_PAD_VALUE
from ..ops.length_regulator import regulate_length
from .transformer import ConvPositionEmbed, TimeConditionEmbed, Transformer, TransformerConfig, _linear

LOG_DOMAIN_OFFSET = 1.0  # durations are predicted as log(d + 1)


@dataclasses.dataclass(frozen=True)
class CFMConfig:
    """Inference fields of the JAX CFMConfig; training-only fields (dropout,
    remat) are not ported, and from_pretrained skips them."""

    vocab_size: int = 2000
    dim_in: int = 80
    dim_cond_emb: int = 768
    hidden_size: int = 256
    depth: int = 4
    heads: int = 2
    intermediate_size: int = 896
    use_unet_skip_connection: bool = False
    conv_pos_embed_kernel_size: int = 31
    conv_pos_embed_groups: int = 256
    mean: float = -5.8843
    std: float = 2.2615
    predict_duration: bool = False

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            hidden_size=self.hidden_size,
            depth=self.depth,
            heads=self.heads,
            intermediate_size=self.intermediate_size,
            use_unet_skip_connection=self.use_unet_skip_connection,
        )


class DurationPredictor(nn.Module):
    """Conv1d(dim_cond_emb -> 1, k=3, SAME) in f32; at inference the
    log-domain output becomes round(exp(out) - 1), clamped at 0, as int32
    (torch.round, like jnp.round, rounds half to even)."""

    def __init__(self, dim_cond_emb: int, policy: Policy = DEFAULT):
        super().__init__()
        self.conv = nn.Conv1d(dim_cond_emb, 1, 3, padding=1, dtype=policy.param_dtype)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        """(B, L, D) -> (B, L) int32 durations."""
        out = F.conv1d(
            hidden_states.float().transpose(1, 2), self.conv.weight.float(), self.conv.bias.float(), padding=1
        )[:, 0]
        return torch.clamp(torch.round(torch.exp(out) - LOG_DOMAIN_OFFSET), min=0.0).to(torch.int32)


def ode_num_steps(dt: float) -> int:
    """Steps of a fixed-step ODE over [0, 1]; ``dt`` must tile it exactly."""
    num_steps = int(np.ceil(round(1.0 / dt, 9)))
    if abs(num_steps * dt - 1.0) > 1e-6:
        # a non-divisor would integrate past t=1 (and midpoint would evaluate the
        # velocity net at t>1, out of distribution)
        raise ValueError(
            f"dt={dt} does not divide the unit time interval "
            f"({num_steps} steps would end at t={num_steps * dt:g}); "
            "use dt=1/n for integer n (reference inference uses 0.0625)"
        )
    return num_steps


class ConditionalFlowMatchingModel(nn.Module):
    def __init__(self, config: CFMConfig, policy: Policy = DEFAULT):
        super().__init__()
        cfg = config
        self.config = config
        self.policy = policy
        pd = policy.param_dtype
        self.to_cond_emb = nn.Embedding(cfg.vocab_size + 1, cfg.dim_cond_emb, dtype=pd)
        self.time_cond_mlp = TimeConditionEmbed(cfg.hidden_size, policy)
        self.to_embed = nn.Linear(cfg.dim_in + cfg.dim_cond_emb, cfg.hidden_size, dtype=pd)
        self.conv_embed = ConvPositionEmbed(
            cfg.hidden_size, cfg.conv_pos_embed_kernel_size, cfg.conv_pos_embed_groups, policy
        )
        self.transformer = Transformer(cfg.transformer(), policy)
        self.to_pred = nn.Linear(cfg.hidden_size, cfg.dim_in, bias=False, dtype=pd)
        if cfg.predict_duration:
            self.duration_predictor = DurationPredictor(cfg.dim_cond_emb, policy)

    def _embed_units(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Unit embedding with padding_idx=0 semantics (the pad row reads as zero)."""
        emb = F.embedding(input_ids, self.to_cond_emb.weight)
        return emb.masked_fill((input_ids == 0)[..., None], 0)

    def _velocity(self, xt, cond, times, mask) -> torch.Tensor:
        """One velocity-field evaluation v(x_t, cond, t), returned in f32."""
        cd = self.policy.compute_dtype
        x = _linear(torch.cat([xt.to(cd), cond.to(cd)], dim=-1), self.to_embed, cd)
        x = self.conv_embed(x, mask=mask) + x
        time_emb = self.time_cond_mlp(times)
        x = self.transformer(x, mask=mask, time_cond=time_emb)
        return _linear(x, self.to_pred, cd).float()

    @torch.inference_mode()
    def predict_durations(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Rounded durations per token (B, L) int32, zero at pad tokens: the
        pre-pass that picks the frame bound of ``sample``."""
        durations = self.duration_predictor(self._embed_units(input_ids))
        return durations.masked_fill(input_ids == 0, 0)

    @torch.inference_mode()
    def sample(
        self,
        input_ids: torch.Tensor,
        dt: float = 0.1,
        truncation_value: Optional[float] = None,
        *,
        generator: Optional[torch.Generator] = None,
        x0: Optional[torch.Tensor] = None,
        ode_method: str = "euler",
        max_frames: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fixed-step ODE mel synthesis: (log_mels (B, N, dim_in) f32, frame mask (B, N)).

        N is the input length, or with ``predict_duration`` the frame bound
        ``max_frames`` (the largest predicted total when omitted: exact, never
        cut). The noise is ``x0`` (B, N, dim_in) when given, else drawn from
        ``generator``. ``ode_method``: ``"euler"`` (one velocity evaluation
        per step) or ``"midpoint"`` (two per step, second order)."""
        cfg = self.config
        if ode_method not in ("euler", "midpoint"):
            raise ValueError(f"unknown ode_method {ode_method!r} (euler|midpoint)")
        num_steps = ode_num_steps(dt)
        token_mask = input_ids != 0
        cond = self._embed_units(input_ids)
        if cfg.predict_duration:
            durations = self.duration_predictor(cond).masked_fill(~token_mask, 0)
            if max_frames is None:
                max_frames = max(int(durations.sum(dim=-1).max()), 1)
            cond, mask = regulate_length(cond, durations, max_frames)
        else:
            mask = token_mask
            if max_frames is not None and max_frames != input_ids.shape[1]:
                raise ValueError("max_frames must equal input length when predict_duration=False")
        bsz, seq_len, _ = cond.shape
        if x0 is None:
            if generator is None:
                raise ValueError("sample() needs a generator (or an explicit x0)")
            x0 = torch.randn((bsz, seq_len, cfg.dim_in), generator=generator, device=cond.device, dtype=torch.float32)
        xt = x0.to(cond.device, torch.float32)
        if truncation_value is not None:
            xt = xt.clamp(-truncation_value, truncation_value)

        for step in range(num_steps):
            t = torch.full((bsz,), step, dtype=torch.float32, device=xt.device) * dt
            v1 = self._velocity(xt, cond, t, mask)
            if ode_method == "midpoint":
                v1 = self._velocity(xt + v1 * (0.5 * dt), cond, t + 0.5 * dt, mask)
            xt = xt + v1 * dt

        x1 = xt * cfg.std + cfg.mean
        return x1.masked_fill(~mask[..., None], MEL_PAD_VALUE), mask
