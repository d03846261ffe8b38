"""Llama-architecture causal LM over speech units: inference and decoding.

Counterpart of speech_resynth_tpu/models/llama.py (configs/speechlm/
hubert.yaml: vocab 16 384 + 2 specials, hidden 768, intermediate 3072, 12
layers, 12 heads): rotary position embedding over the full head (theta 1e4,
half-split), RMSNorm (eps 1e-6), SwiGLU MLP, causal attention, an untied LM
head, no biases. Parameter names are the HF ``LlamaForCausalLM`` keys.

Two attention paths, as in the JAX package:
- the full forward (scoring, no cache) calls ``ops.attention.
  dot_product_attention(causal=True, mask=...)``, which is the flash kernel
  K1 on the card;
- the KV-cache path (prefill at ``cache_index = 0`` and every decode step)
  computes the scores inline, masking keys past each query's absolute
  position with -1e30, and never calls K1. The cache is updated in place.

The logits come out in f32. ``greedy_decode`` and ``sample_decode`` run
the prefill and then one cache step per token; ``temperature == 0`` is
greedy; after EOS a row keeps emitting EOS. Sampling draws from a
``torch.Generator`` where the JAX package splits a key, so the two sample
different sequences from one seed. ``scan_layers``, ``remat`` and
``hidden_sharding`` are XLA compile and sharding devices with no
counterpart here; the layers are unrolled.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import DEFAULT, Policy
from ..ops.attention import dot_product_attention
from .transformer import apply_rotary

Cache = List[Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 16386
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    pad_token_id: int = 0
    bos_token_id: Optional[int] = None
    eos_token_id: Optional[int] = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def _rope_tables(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """(..., L) int positions -> (..., L, head_dim) f32 angle table."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim))
    freqs = positions.float()[..., None] * inv_freq
    return torch.cat([freqs, freqs], dim=-1)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype))


class LlamaRMSNorm(nn.Module):
    def __init__(self, hidden_size: int, eps: float, policy: Policy = DEFAULT):
        super().__init__()
        self.eps = eps
        self.policy = policy
        self.weight = nn.Parameter(torch.ones(hidden_size, dtype=policy.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        normed = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + self.eps)
        # HF Llama multiplies the weight in f32, then casts
        return (self.weight.float() * normed).to(self.policy.compute_dtype)


def _projection(n_in: int, n_out: int, policy: Policy) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False, dtype=policy.param_dtype)


class LlamaAttention(nn.Module):
    """The projections of one layer's attention (HF ``self_attn``)."""

    def __init__(self, config: LlamaConfig, policy: Policy):
        super().__init__()
        d = config.hidden_size
        self.q_proj, self.k_proj, self.v_proj, self.o_proj = (_projection(d, d, policy) for _ in range(4))


class LlamaMLP(nn.Module):
    """The SwiGLU MLP's projections (HF ``mlp``)."""

    def __init__(self, config: LlamaConfig, policy: Policy):
        super().__init__()
        d, f = config.hidden_size, config.intermediate_size
        self.gate_proj, self.up_proj = _projection(d, f, policy), _projection(d, f, policy)
        self.down_proj = _projection(f, d, policy)


class LlamaLayer(nn.Module):
    def __init__(self, config: LlamaConfig, policy: Policy = DEFAULT):
        super().__init__()
        self.config = config
        self.policy = policy
        self.input_layernorm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps, policy)
        self.self_attn = LlamaAttention(config, policy)
        self.post_attention_layernorm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps, policy)
        self.mlp = LlamaMLP(config, policy)

    def forward(
        self,
        x: torch.Tensor,
        rope: torch.Tensor,
        mask: Optional[torch.Tensor],
        cache: Optional[Dict[str, torch.Tensor]] = None,
        cache_index: Optional[int] = None,
    ) -> torch.Tensor:
        cfg, cd = self.config, self.policy.compute_dtype
        b, n, _ = x.shape
        h, d = cfg.num_attention_heads, cfg.head_dim
        attn_mod = self.self_attn

        residual = x
        hs = self.input_layernorm(x)
        q, k, v = (
            _linear(hs, proj, cd).view(b, n, h, d).transpose(1, 2)
            for proj in (attn_mod.q_proj, attn_mod.k_proj, attn_mod.v_proj)
        )
        q, k = apply_rotary(rope, q), apply_rotary(rope, k)

        if cache is not None:
            # prefill and decode: write this chunk's keys and values at
            # cache_index (in place) and attend by absolute position
            cache["k"][:, :, cache_index : cache_index + n] = k
            cache["v"][:, :, cache_index : cache_index + n] = v
            max_len = cache["k"].shape[2]
            q_pos = cache_index + torch.arange(n, device=x.device)
            allowed = torch.arange(max_len, device=x.device)[None, :] <= q_pos[:, None]
            s = torch.einsum("bhqd,bhkd->bhqk", q.float(), cache["k"].float()) * (1.0 / math.sqrt(d))
            s = s.masked_fill(~allowed, -1e30)
            p = torch.softmax(s, dim=-1).to(cache["v"].dtype)
            attn = torch.einsum("bhqk,bhkd->bhqd", p, cache["v"])
        else:
            attn = dot_product_attention(q.contiguous(), k.contiguous(), v.contiguous(), mask=mask, causal=True)

        attn = attn.transpose(1, 2).reshape(b, n, cfg.hidden_size)
        x = residual + _linear(attn, attn_mod.o_proj, cd)

        residual = x
        hs = self.post_attention_layernorm(x)
        mlp = self.mlp
        act = F.silu(_linear(hs, mlp.gate_proj, cd)) * _linear(hs, mlp.up_proj, cd)
        return residual + _linear(act, mlp.down_proj, cd)


class LlamaBackbone(nn.Module):
    """Embedding, layers and final norm (HF ``model``)."""

    def __init__(self, config: LlamaConfig, policy: Policy):
        super().__init__()
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size, dtype=policy.param_dtype)
        self.layers = nn.ModuleList(LlamaLayer(config, policy) for _ in range(config.num_hidden_layers))
        self.norm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps, policy)


class LlamaLM(nn.Module):
    """(B, L) token ids -> (f32 logits (B, L, vocab), cache or None)."""

    def __init__(self, config: LlamaConfig = LlamaConfig(), policy: Policy = DEFAULT):
        super().__init__()
        self.config = config
        self.policy = policy
        self.model = LlamaBackbone(config, policy)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size, bias=False, dtype=policy.param_dtype)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        cache: Optional[Cache] = None,
        cache_index: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """Scoring: (B, L) ids and an optional (B, L) attention mask. Prefill
        and decode: ids, the cache from ``init_cache`` and the write index,
        which is also the first token's position."""
        cfg = self.config
        x = self.model.embed_tokens(input_ids).to(self.policy.compute_dtype)
        positions = torch.arange(input_ids.shape[1], device=input_ids.device) + (cache_index or 0)
        rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)  # (L, head_dim), broadcast over batch and heads
        mask = attention_mask.bool() if attention_mask is not None else None
        for i, layer in enumerate(self.model.layers):
            x = layer(x, rope, mask, None if cache is None else cache[i], cache_index)
        x = self.model.norm(x)
        logits = F.linear(x.float(), self.lm_head.weight.float())
        return logits, cache

    def init_cache(self, batch_size: int, max_len: int) -> Cache:
        """One zeroed {"k", "v"} pair of (B, heads, max_len, head_dim) per layer."""
        cfg = self.config
        shape = (batch_size, cfg.num_attention_heads, max_len, cfg.head_dim)

        def zeros():
            return torch.zeros(shape, dtype=self.policy.compute_dtype, device=self.device)

        return [{"k": zeros(), "v": zeros()} for _ in range(cfg.num_hidden_layers)]


def sequence_pseudo_log_prob(logits: torch.Tensor, input_ids: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """Length-normalized pseudo-log-prob of each row: the log-probs of the
    next tokens (pad labels ignored), summed and divided by the count of
    nonzero terms, as the reference's scorer divides."""
    labels = torch.where(input_ids == pad_id, -100, input_ids)
    shift_labels = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -100)], dim=1)
    valid = shift_labels != -100
    safe = torch.where(valid, shift_labels, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_scores = torch.gather(logp, -1, safe[..., None].long())[..., 0]
    tok_scores = torch.where(valid, tok_scores, 0.0)
    nonzero = (tok_scores != 0.0).float().sum(dim=1)
    return tok_scores.sum(dim=1) / torch.clamp(nonzero, min=1.0)


def _filter_logits(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """HF-order filtering of (B, V) f32 logits: top-k, then nucleus (top-p).
    Ties at either threshold are kept (HF's >= comparisons)."""
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # the smallest prefix whose mass reaches top_p (at least one token)
        k_keep = torch.clamp(((cum - probs) < top_p).sum(dim=-1, keepdim=True), min=1)
        thresh = torch.gather(sorted_desc, -1, k_keep - 1)
        logits = logits.masked_fill(logits < thresh, -math.inf)
    return logits


@torch.inference_mode()
def _decode(model: LlamaLM, prompt_ids, max_new_tokens: int, eos_token_id: int, select) -> torch.Tensor:
    """Prefill through the cache path, then one cache step per new token;
    ``select`` maps (B, V) f32 logits to (B,) ids. Returns (B, prompt + new)."""
    prompt = torch.as_tensor(prompt_ids).to(model.device, torch.long)
    b, p = prompt.shape
    cache = model.init_cache(b, p + max_new_tokens)
    logits, cache = model(prompt, cache=cache, cache_index=0)
    tok = select(logits[:, -1])
    done = tok == eos_token_id
    out = [tok]
    for i in range(max_new_tokens - 1):
        logits, cache = model(tok[:, None], cache=cache, cache_index=p + i)
        tok = torch.where(done, eos_token_id, select(logits[:, -1]))
        done = done | (tok == eos_token_id)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


def greedy_decode(model: LlamaLM, prompt_ids, max_new_tokens: int, eos_token_id: int = 1) -> torch.Tensor:
    """KV-cached greedy generation: (B, prompt + max_new_tokens) ids."""
    return _decode(model, prompt_ids, max_new_tokens, eos_token_id, lambda logits: torch.argmax(logits, dim=-1))


def sample_decode(
    model: LlamaLM,
    prompt_ids,
    max_new_tokens: int,
    eos_token_id: int = 1,
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """KV-cached ancestral sampling with temperature, top-k and nucleus
    filtering (HF order): (B, prompt + max_new_tokens) ids. Tokens are drawn
    by the Gumbel-max rule with uniforms from ``generator`` (on the model's
    device; seed 0 when omitted). ``temperature=0`` is greedy."""
    if temperature == 0.0:
        return greedy_decode(model, prompt_ids, max_new_tokens, eos_token_id)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)

    def select(logits):
        filtered = _filter_logits(logits / temperature, top_k, top_p)
        u = torch.rand(filtered.shape, generator=generator, device=filtered.device)
        return torch.argmax(filtered - torch.log(-torch.log(u)), dim=-1)

    return _decode(model, prompt_ids, max_new_tokens, eos_token_id, select)
