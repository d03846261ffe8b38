"""Whisper encoder-decoder ASR.

Counterpart of speech_resynth_tpu/models/whisper.py. The encoder is two
convs (GELU, the second of stride 2), the stored sinusoid table and a pre-LN
bidirectional transformer; the decoder is a pre-LN transformer with causal
self-attention, cross-attention over the encoder states and an LM head tied
to the token embedding. Module and parameter names are HF
``WhisperForConditionalGeneration``'s, so an HF state_dict loads through
``whisper_state_dict_from_hf`` (which fills the tied ``proj_out``).

Attention routes, as in the JAX package:
* the encoder's self-attention, the uncached decoder's causal
  self-attention and every cross-attention go through
  ``ops.attention.dot_product_attention`` (``attn_implementation``), so the
  flash kernel K1 takes them on the card (d = 64): the encoder at
  (B, H, 1 500, 64), the cross-attention at q_len 1 (a decode step) or the
  prompt's length (the prefill) against the 1 500 encoder keys;
* the cached self-attention of a decode step is an einsum over the whole
  static cache with f32 scores, -1e30 past the current position and the
  probabilities cast to V's dtype.

``cross_kv`` computes each layer's cross-attention K/V once per utterance,
contiguous, so no decode step copies them. ``greedy_decode`` prefills the
forced prompt, then takes one token a step into a static KV cache, fills
eos past each row's end and stops once every row has ended (one host check
a step).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import initializers as I
from ..core.precision import DEFAULT, Policy
from ..ops.attention import dot_product_attention
from .transformer import _linear

LN_EPS = 1e-5
CACHE_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Defaults: openai/whisper-large-v3 (its HF config)."""

    vocab_size: int = 51866
    num_mel_bins: int = 128
    d_model: int = 1280
    encoder_layers: int = 32
    encoder_attention_heads: int = 20
    decoder_layers: int = 32
    decoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    decoder_ffn_dim: int = 5120
    max_source_positions: int = 1500
    max_target_positions: int = 448
    decoder_start_token_id: int = 50258
    eos_token_id: int = 50257

    @classmethod
    def from_hf(cls, hf: Mapping) -> "WhisperConfig":
        """From an HF ``config.json``'s fields."""
        names = [f.name for f in dataclasses.fields(cls) if f.name not in ("decoder_start_token_id", "eos_token_id")]
        return cls(
            **{k: hf[k] for k in names},
            decoder_start_token_id=hf.get("decoder_start_token_id", 50258),
            eos_token_id=hf.get("eos_token_id", 50257),
        )


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """openai-whisper's sinusoid table (the stored HF buffer), f32."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32))


def _ln(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm in f32 (statistics and output), as the JAX model's f32 norms."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps)


class WhisperAttention(nn.Module):
    """HF Whisper attention: q, v and out projections carry biases, k does not."""

    def __init__(self, d_model: int, heads: int, policy: Policy = DEFAULT, attn_implementation: str = "auto"):
        super().__init__()
        pd = policy.param_dtype
        self.d_model, self.heads, self.policy = d_model, heads, policy
        self.attn_implementation = attn_implementation
        self.q_proj = nn.Linear(d_model, d_model, bias=True, dtype=pd)
        self.k_proj = nn.Linear(d_model, d_model, bias=False, dtype=pd)
        self.v_proj = nn.Linear(d_model, d_model, bias=True, dtype=pd)
        self.out_proj = nn.Linear(d_model, d_model, bias=True, dtype=pd)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        return x.view(b, n, self.heads, self.d_model // self.heads).transpose(1, 2).contiguous()

    def kv_for(self, states: torch.Tensor) -> Dict[str, torch.Tensor]:
        """K/V of ``states`` (B, T, d), each (B, H, T, d_head) and contiguous."""
        cd = self.policy.compute_dtype
        return {"k": self._split(_linear(states, self.k_proj, cd)), "v": self._split(_linear(states, self.v_proj, cd))}

    def forward(
        self,
        x: torch.Tensor,
        kv_states: Optional[torch.Tensor] = None,
        causal: bool = False,
        cache: Optional[Dict[str, torch.Tensor]] = None,
        cache_index: int = 0,
        precomputed_kv: Optional[Dict[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """``cache``: this layer's static K/V buffers (B, H, L, d_head),
        written in place at ``cache_index``."""
        b, n, _ = x.shape
        cd = self.policy.compute_dtype
        q = self._split(_linear(x, self.q_proj, cd))
        kv = precomputed_kv if precomputed_kv is not None else self.kv_for(x if kv_states is None else kv_states)
        k, v = kv["k"], kv["v"]
        if cache is not None:
            cache["k"][:, :, cache_index : cache_index + n] = k
            cache["v"][:, :, cache_index : cache_index + n] = v
            k, v = cache["k"], cache["v"]
            q_pos = cache_index + torch.arange(n, device=x.device)
            allowed = torch.arange(k.shape[2], device=x.device)[None, :] <= q_pos[:, None]
            s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
            p = torch.softmax(s.masked_fill(~allowed, CACHE_NEG), dim=-1).to(v.dtype)
            attn = torch.einsum("bhqk,bhkd->bhqd", p, v)
        else:
            attn = dot_product_attention(q, k, v, causal=causal, implementation=self.attn_implementation)
        return _linear(attn.transpose(1, 2).reshape(b, n, self.d_model), self.out_proj, cd)


class _Layer(nn.Module):
    """Pre-LN block: self-attention, [cross-attention,] GELU MLP."""

    def __init__(self, d_model: int, heads: int, ffn_dim: int, cross: bool, policy: Policy, attn_implementation: str):
        super().__init__()
        pd = policy.param_dtype
        self.policy = policy
        self.self_attn = WhisperAttention(d_model, heads, policy, attn_implementation)
        self.self_attn_layer_norm = nn.LayerNorm(d_model, eps=LN_EPS, dtype=pd)
        if cross:
            self.encoder_attn = WhisperAttention(d_model, heads, policy, attn_implementation)
            self.encoder_attn_layer_norm = nn.LayerNorm(d_model, eps=LN_EPS, dtype=pd)
        self.fc1 = nn.Linear(d_model, ffn_dim, dtype=pd)
        self.fc2 = nn.Linear(ffn_dim, d_model, dtype=pd)
        self.final_layer_norm = nn.LayerNorm(d_model, eps=LN_EPS, dtype=pd)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        return _linear(F.gelu(_linear(_ln(x, self.final_layer_norm).to(cd), self.fc1, cd)), self.fc2, cd)


class WhisperEncoderLayer(_Layer):
    def __init__(self, config: WhisperConfig, policy: Policy = DEFAULT, attn_implementation: str = "auto"):
        super().__init__(config.d_model, config.encoder_attention_heads, config.encoder_ffn_dim, False, policy,
                         attn_implementation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(_ln(x, self.self_attn_layer_norm).to(self.policy.compute_dtype))
        return x + self._mlp(x)


class WhisperDecoderLayer(_Layer):
    def __init__(self, config: WhisperConfig, policy: Policy = DEFAULT, attn_implementation: str = "auto"):
        super().__init__(config.d_model, config.decoder_attention_heads, config.decoder_ffn_dim, True, policy,
                         attn_implementation)

    def forward(self, x, enc=None, cache=None, cache_index: int = 0, cross_kv=None) -> torch.Tensor:
        cd = self.policy.compute_dtype
        x = x + self.self_attn(_ln(x, self.self_attn_layer_norm).to(cd), causal=True, cache=cache, cache_index=cache_index)
        x = x + self.encoder_attn(_ln(x, self.encoder_attn_layer_norm).to(cd), kv_states=enc, precomputed_kv=cross_kv)
        return x + self._mlp(x)


class WhisperEncoder(nn.Module):
    """log-mel (B, T, mels) -> states (B, T // 2, d_model) in the compute dtype."""

    def __init__(self, config: WhisperConfig, policy: Policy = DEFAULT, attn_implementation: str = "auto"):
        super().__init__()
        pd = policy.param_dtype
        self.config, self.policy = config, policy
        self.conv1 = nn.Conv1d(config.num_mel_bins, config.d_model, 3, padding=1, dtype=pd)
        self.conv2 = nn.Conv1d(config.d_model, config.d_model, 3, stride=2, padding=1, dtype=pd)
        self.embed_positions = nn.Embedding(config.max_source_positions, config.d_model, dtype=pd)
        self.layers = nn.ModuleList(
            WhisperEncoderLayer(config, policy, attn_implementation) for _ in range(config.encoder_layers)
        )
        self.layer_norm = nn.LayerNorm(config.d_model, eps=LN_EPS, dtype=pd)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        x = mel.to(cd).transpose(1, 2)
        x = F.gelu(F.conv1d(x, self.conv1.weight.to(cd), self.conv1.bias.to(cd), padding=1))
        x = F.gelu(F.conv1d(x, self.conv2.weight.to(cd), self.conv2.bias.to(cd), stride=2, padding=1))
        x = x.transpose(1, 2)
        x = x + self.embed_positions.weight[: x.shape[1]].to(cd)
        for layer in self.layers:
            x = layer(x)
        return _ln(x, self.layer_norm).to(cd)


class WhisperDecoder(nn.Module):
    def __init__(self, config: WhisperConfig, policy: Policy = DEFAULT, attn_implementation: str = "auto"):
        super().__init__()
        pd = policy.param_dtype
        self.config, self.policy = config, policy
        self.embed_tokens = nn.Embedding(config.vocab_size, config.d_model, dtype=pd)
        self.embed_positions = nn.Embedding(config.max_target_positions, config.d_model, dtype=pd)
        self.layers = nn.ModuleList(
            WhisperDecoderLayer(config, policy, attn_implementation) for _ in range(config.decoder_layers)
        )
        self.layer_norm = nn.LayerNorm(config.d_model, eps=LN_EPS, dtype=pd)

    def forward(self, input_ids, enc=None, cache=None, cache_index: int = 0, cross_kv=None) -> torch.Tensor:
        """Final states (B, N, d_model), f32."""
        cd = self.policy.compute_dtype
        n = input_ids.shape[1]
        x = self.embed_tokens(input_ids).to(cd) + self.embed_positions.weight[cache_index : cache_index + n].to(cd)
        for i, layer in enumerate(self.layers):
            x = layer(x, enc, None if cache is None else cache[i], cache_index, None if cross_kv is None else cross_kv[i])
        return _ln(x, self.layer_norm)


class WhisperModel(nn.Module):
    def __init__(self, config: WhisperConfig, policy: Policy = DEFAULT, attn_implementation: str = "auto"):
        super().__init__()
        self.encoder = WhisperEncoder(config, policy, attn_implementation)
        self.decoder = WhisperDecoder(config, policy, attn_implementation)


class WhisperForASR(nn.Module):
    """Encoder-decoder with the teacher-forced forward and the pieces of
    ``greedy_decode``. The LM head computes in f32 from the final states
    rounded to the compute dtype."""

    def __init__(self, config: WhisperConfig = WhisperConfig(), policy: Policy = DEFAULT,
                 attn_implementation: str = "auto"):
        super().__init__()
        self.config, self.policy = config, policy
        self.model = WhisperModel(config, policy, attn_implementation)
        self.proj_out = nn.Linear(config.d_model, config.vocab_size, bias=False, dtype=policy.param_dtype)

    def init_rules(self) -> I.Rules:
        """The encoder's positions the sinusoid table (the JAX model's
        declaration); every other tensor the port's own seeded draw."""
        return (("model.encoder.embed_positions.weight", lambda shape, gen: sinusoids(*shape).to(gen.device)),
                *I.FAN_IN_RULES)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.policy.compute_dtype).float(), self.proj_out.weight.float())

    def forward(self, mel: torch.Tensor, decoder_input_ids: torch.Tensor) -> torch.Tensor:
        return self._logits(self.model.decoder(decoder_input_ids, self.encode(mel)))

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        return self.model.encoder(mel)

    def cross_kv(self, enc: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """Each decoder layer's cross-attention K/V, computed once per utterance."""
        return [layer.encoder_attn.kv_for(enc) for layer in self.model.decoder.layers]

    def init_cache(self, batch_size: int, max_len: int, device=None) -> List[Dict[str, torch.Tensor]]:
        cfg = self.config
        h = cfg.decoder_attention_heads
        shape = (batch_size, h, max_len, cfg.d_model // h)
        device = device if device is not None else self.proj_out.weight.device
        dtype = self.policy.compute_dtype
        return [
            {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.decoder_layers)
        ]

    def decode_step(self, input_ids, cross_kv, cache, cache_index: int) -> Tuple[torch.Tensor, list]:
        """Logits (B, N, vocab) f32 of ``input_ids`` at positions
        ``cache_index`` ..., writing their K/V into ``cache``."""
        x = self.model.decoder(input_ids, cache=cache, cache_index=cache_index, cross_kv=cross_kv)
        return self._logits(x), cache


@torch.inference_mode()
def greedy_decode(model: WhisperForASR, mel: torch.Tensor, max_new_tokens: int, prompt_ids: torch.Tensor) -> torch.Tensor:
    """Batched greedy transcription: (B, T, mels) and a (B, P) forced prompt
    -> (B, P + max_new_tokens) token ids, eos past each row's end. The loop
    stops once every row has produced eos; the rest stays eos, so the result
    equals the full unroll."""
    eos = model.config.eos_token_id
    b, p = prompt_ids.shape
    prompt_ids = prompt_ids.to(mel.device, torch.long)
    cross_kv = model.cross_kv(model.encode(mel))
    cache = model.init_cache(b, p + max_new_tokens, mel.device)
    logits, cache = model.decode_step(prompt_ids, cross_kv, cache, 0)
    nxt = logits[:, -1].argmax(dim=-1)
    done = nxt == eos
    tokens = torch.cat([prompt_ids, torch.full((b, max_new_tokens), eos, dtype=torch.long, device=mel.device)], dim=1)
    tokens[:, p] = nxt
    i = 0
    while i < max_new_tokens - 1 and not bool(done.all()):
        # the token at sequence position p + i takes cache slot and position p + i
        logits, cache = model.decode_step(tokens[:, p + i : p + i + 1], cross_kv, cache, p + i)
        nxt = torch.where(done, eos, logits[:, -1].argmax(dim=-1))
        done = done | (nxt == eos)
        tokens[:, p + 1 + i] = nxt
        i += 1
    return tokens


def whisper_state_dict_from_hf(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """HF ``WhisperForConditionalGeneration`` state_dict -> the port's (the
    same keys, dtypes kept): ``proj_out.weight`` from the token embedding
    where a safetensors export dropped the tied copy."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items() if k.startswith("model.") or k == "proj_out.weight"}
    sd.setdefault("proj_out.weight", sd["model.decoder.embed_tokens.weight"])
    return sd

