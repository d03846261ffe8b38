"""Conditional flow matching mel decoder.

Counterpart of speech_resynth_tpu/models/cfm.py (``CFMConfig``,
``DurationPredictor`` and ``ConditionalFlowMatchingModel``: ``_embed_units``,
``_velocity``, ``loss`` (the JAX ``__call__``), ``predict_durations``,
``sample``). ``sample`` integrates the flow from noise to a log-mel with a
fixed-step Euler or midpoint ODE; the ODE state and the velocity are f32,
and pad frames hold log(1e-5). With ``predict_duration`` the unit embeddings
are first repeated by the predicted durations (``ops.length_regulator``) up
to a frame bound ``max_frames``. ``loss`` is the training objective: the
masked MSE of the predicted velocity against x1 - x0 on the straight path
from noise x0 to the normalized mel x1, plus the log-domain duration loss.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import initializers as I
from ..core.precision import DEFAULT, Policy
from ..dsp.mel import MEL_PAD_VALUE
from ..ops.length_regulator import regulate_length
from .transformer import ConvPositionEmbed, TimeConditionEmbed, Transformer, TransformerConfig, _linear, draw_rows

LOG_DOMAIN_OFFSET = 1.0  # durations are predicted as log(d + 1)


@dataclasses.dataclass(frozen=True)
class CFMConfig:
    """The JAX CFMConfig's fields, in its order (``config.json`` keys)."""

    vocab_size: int = 2000
    dim_in: int = 80
    dim_cond_emb: int = 768
    hidden_size: int = 256
    depth: int = 4
    heads: int = 2
    intermediate_size: int = 896
    ff_dropout: float = 0.0
    use_unet_skip_connection: bool = False
    conv_pos_embed_kernel_size: int = 31
    conv_pos_embed_groups: int = 256
    attn_dropout: float = 0.0
    mean: float = -5.8843
    std: float = 2.2615
    predict_duration: bool = False
    remat: bool = False  # training memory knob: recompute attention and feed-forward in the backward pass

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            hidden_size=self.hidden_size,
            depth=self.depth,
            heads=self.heads,
            intermediate_size=self.intermediate_size,
            attn_dropout=self.attn_dropout,
            ff_dropout=self.ff_dropout,
            use_unet_skip_connection=self.use_unet_skip_connection,
            remat=self.remat,
        )


class DurationPredictor(nn.Module):
    """Conv1d(dim_cond_emb -> 1, k=3, SAME) in f32: the log-domain output in
    training; at inference round(exp(out) - 1), clamped at 0, as int32
    (torch.round, like jnp.round, rounds half to even)."""

    def __init__(self, dim_cond_emb: int, policy: Policy = DEFAULT):
        super().__init__()
        self.conv = nn.Conv1d(dim_cond_emb, 1, 3, padding=1, dtype=policy.param_dtype)

    def forward(self, hidden_states: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, L, D) -> (B, L): f32 log-domain durations (``train``) or int32 durations."""
        out = F.conv1d(
            hidden_states.float().transpose(1, 2), self.conv.weight.float(), self.conv.bias.float(), padding=1
        )[:, 0]
        if train:
            return out
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


_CFM_DENSE = r"(to_embed|to_pred|time_cond_mlp\.1|transformer\.layers\.\d+\.(0|2\.to_qkv|2\.to_out))"
_CFM_CONVS = r"(conv_embed\.dw_conv1d\.0|transformer\.layers\.\d+\.4\.conv[12]|duration_predictor\.conv)"
# the JAX model's initializers: nn.Embed's default for the unit table; lecun_normal
# for every dense and conv kernel (the positional conv grouped, the conv
# feed-forward, the duration predictor); the adaptive norms' projections 0, the
# final norm's gain 1, the Fourier frequencies N(0, 1), biases 0
CFM_INIT_RULES = (
    (r"to_cond_emb\.weight", I.embed_normal()),
    (r"time_cond_mlp\.0\.weights", I.normal(1.0)),
    (r"transformer\.layers\.\d+\.[13]\.to_weight\.weight", I.zeros),
    (r"transformer\.final_norm\.weight", I.ones),
    (rf"({_CFM_DENSE}|{_CFM_CONVS})\.weight", I.lecun_normal()),
    (rf"({_CFM_DENSE}|{_CFM_CONVS})\.bias", I.zeros),
)


class ConditionalFlowMatchingModel(nn.Module):
    def __init__(self, config: CFMConfig, policy: Policy = DEFAULT, attn_implementation: str = "auto"):
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
        self.transformer = Transformer(cfg.transformer(), policy, attn_implementation)
        self.to_pred = nn.Linear(cfg.hidden_size, cfg.dim_in, bias=False, dtype=pd)
        if cfg.predict_duration:
            self.duration_predictor = DurationPredictor(cfg.dim_cond_emb, policy)

    def init_rules(self) -> I.Rules:
        return CFM_INIT_RULES

    def _embed_units(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Unit embedding with padding_idx=0 semantics (the pad row reads as zero)."""
        emb = F.embedding(input_ids, self.to_cond_emb.weight)
        return emb.masked_fill((input_ids == 0)[..., None], 0)

    def _velocity(self, xt, cond, times, mask, dropout_seed=None, rows=None) -> torch.Tensor:
        """One velocity-field evaluation v(x_t, cond, t), returned in f32;
        ``dropout_seed`` turns the transformer's dropout on (training)."""
        cd = self.policy.compute_dtype
        x = _linear(torch.cat([xt.to(cd), cond.to(cd)], dim=-1), self.to_embed, cd)
        x = self.conv_embed(x, mask=mask) + x
        time_emb = self.time_cond_mlp(times)
        x = self.transformer(x, mask=mask, time_cond=time_emb, dropout_seed=dropout_seed, dropout_rows=rows)
        return _linear(x, self.to_pred, cd).float()

    def loss(
        self,
        input_ids: torch.Tensor,
        spectrogram_labels: torch.Tensor,
        duration_labels: Optional[torch.Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
        x0: Optional[torch.Tensor] = None,
        times: Optional[torch.Tensor] = None,
        dropout_seed: Optional[int] = None,
    ) -> Tuple[torch.Tensor, dict]:
        """Training loss (the JAX ``__call__``): (loss, {"mse", "duration_loss"}),
        the terms of ``loss_terms`` over their counts."""
        terms = self.loss_terms(
            input_ids, spectrogram_labels, duration_labels, generator=generator, x0=x0, times=times, dropout_seed=dropout_seed
        )
        mse = terms["sq"] / terms["frames"].clamp(min=1)
        duration_loss = terms["duration_sq"] / terms["tokens"].clamp(min=1)
        return mse + duration_loss, {"mse": mse, "duration_loss": duration_loss}

    def loss_terms(
        self,
        input_ids: torch.Tensor,
        spectrogram_labels: torch.Tensor,
        duration_labels: Optional[torch.Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
        x0: Optional[torch.Tensor] = None,
        times: Optional[torch.Tensor] = None,
        dropout_seed: Optional[int] = None,
        rows: Optional[Tuple[int, int]] = None,
    ) -> dict:
        """The loss's sums and their counts: "sq", the squared velocity error
        summed over the valid frames, over "frames", their count x dim_in;
        "duration_sq", the squared log-duration error summed over the valid
        tokens, over "tokens", their count (0 and 0 without a duration
        predictor). Counts are int64.

        Frames whose labels are all -100 are padding. The noise ``x0`` (B, N,
        dim_in) and the flow times ``times`` (B,) are drawn from ``generator``
        (on the model's device) unless given. ``dropout_seed`` turns dropout
        on (training mode; a pure function of it seeds every site). With
        ``rows = (first, total)`` the batch is a data replica's rows of a
        global batch of ``total`` rows, and the noise, the flow times and the
        dropout masks are those rows of the global batch's draws
        (``transformer.draw_rows``)."""
        cfg = self.config
        mask = torch.any(spectrogram_labels != -100, dim=-1)  # (B, N)
        batch, seq_len, _ = spectrogram_labels.shape
        x1 = (spectrogram_labels.float() - cfg.mean) / cfg.std
        if x0 is None or times is None:
            if generator is None:
                raise ValueError("loss() needs a generator (or explicit x0 and times)")
            if x0 is None:
                x0 = draw_rows(lambda shape: torch.randn(shape, generator=generator, device=x1.device), x1.shape, rows)
            if times is None:
                times = draw_rows(lambda shape: torch.rand(shape, generator=generator, device=x1.device), (batch,), rows)
        x0, times = x0.to(x1.device, torch.float32), times.to(x1.device, torch.float32)
        t = times[:, None, None]
        xt = (1 - t) * x0 + t * x1
        ut = x1 - x0

        cond = self._embed_units(input_ids)
        zero = torch.zeros((), device=x1.device)
        terms = {"duration_sq": zero, "tokens": zero.long()}
        if cfg.predict_duration:
            if duration_labels is None:
                raise ValueError("a duration-predicting model needs duration_labels")
            dur_pred = self.duration_predictor(cond, train=True)  # (B, L) log-domain
            cond, _ = regulate_length(cond, duration_labels, seq_len)
            token_mask = input_ids != 0
            dur_target = torch.log(duration_labels.float() + LOG_DOMAIN_OFFSET)
            sq = torch.where(token_mask, (dur_pred - dur_target) ** 2, 0.0)
            terms = {"duration_sq": sq.sum(), "tokens": token_mask.sum()}

        pred = self._velocity(xt, cond, times, mask, dropout_seed, rows)
        sq = torch.where(mask[..., None], (pred - ut) ** 2, 0.0)
        return {"sq": sq.sum(), "frames": mask.sum() * cfg.dim_in, **terms}

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
