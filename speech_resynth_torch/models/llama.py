"""Llama-architecture causal LM over speech units: inference and decoding.

Counterpart of speech_resynth_tpu/models/llama.py (configs/speechlm/
hubert.yaml: vocab 16 384 + 2 specials, hidden 768, intermediate 3072, 12
layers, 12 heads): rotary position embedding over the full head (theta 1e4,
half-split), RMSNorm (eps 1e-6), SwiGLU MLP, causal attention, an untied LM
head, no biases. Parameter names are the HF ``LlamaForCausalLM`` keys.

Two attention paths, as in the JAX package:
- the full forward (training and scoring, no cache) calls ``ops.attention.
  dot_product_attention(causal=True, mask=..., implementation=...)`` with the
  model's ``attn_implementation``: ``"auto"`` is the flash kernel K1 on the
  card where it takes the shape, ``"pallas"`` K1 or an error, ``"xla"`` the
  plain version (the trainer's default, as in the JAX package);
- the KV-cache path (prefill at ``cache_index = 0`` and every decode step)
  computes the scores inline, masking keys past each query's absolute
  position with -1e30, and never calls K1. The cache is updated in place.

The logits come out in f32. ``greedy_decode`` and ``sample_decode`` run
the prefill and then one cache step per token; ``temperature == 0`` is
greedy; after EOS a row keeps emitting EOS. Sampling draws from a
``torch.Generator`` where the JAX package splits a key, so the two sample
different sequences from one seed.

The speculative decoders ``lookup_decode`` (greedy, the same ids as
``greedy_decode``) and ``lookup_sample_decode`` (the same distribution as
``sample_decode``) verify the last committed token and S prompt-lookup
drafts in one cache-path forward of 1 + S tokens per iteration, which never
calls K1. They are a Python loop over that cache path; ``buf`` stays on the
device and the host reads the commit length once per iteration.

Training: ``causal_lm_loss`` is the JAX loss (shift, -100 ignored, f32
log-softmax, mean over valid tokens); ``remat=True`` recomputes each layer
in the backward pass (``torch.utils.checkpoint``, the same numerics). Every
projection is a module call (``Projection``), so ``parallel.sharding``'s
tensor-parallel plan reaches it; with the heads split over a model axis each
rank sees its own heads (``-1`` in the head reshape). The JAX
``hidden_sharding`` is ``parallel.sharding``'s sequence-parallel plan here,
and ``scan_layers`` (an XLA compile device) has no counterpart: the layers
are unrolled.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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


class Projection(nn.Linear):
    """A bias-free linear layer that casts its input and weight to
    ``compute_dtype`` (the policy's, f32 for the LM head) before the product."""

    def __init__(self, n_in: int, n_out: int, param_dtype: torch.dtype, compute_dtype: torch.dtype):
        super().__init__(n_in, n_out, bias=False, dtype=param_dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype))


def _projection(n_in: int, n_out: int, policy: Policy) -> Projection:
    return Projection(n_in, n_out, policy.param_dtype, policy.compute_dtype)


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
    def __init__(self, config: LlamaConfig, policy: Policy = DEFAULT, attn_implementation: str = "auto"):
        super().__init__()
        self.config = config
        self.policy = policy
        self.attn_implementation = attn_implementation
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
        d = self.config.head_dim
        attn_mod = self.self_attn

        residual = x
        hs = self.input_layernorm(x)
        # (B, N, -1 heads, d): all heads, or this rank's under tensor parallelism (where N is the
        # whole sequence even when the hidden states between the layers hold a sequence shard)
        q, k, v = (proj(hs).unflatten(-1, (-1, d)).transpose(1, 2) for proj in (attn_mod.q_proj, attn_mod.k_proj, attn_mod.v_proj))
        q, k = apply_rotary(rope, q), apply_rotary(rope, k)

        if cache is not None:
            # prefill and decode: write this chunk's keys and values at
            # cache_index (in place) and attend by absolute position
            n = q.shape[2]
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
            attn = dot_product_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), mask=mask, causal=True, implementation=self.attn_implementation
            )

        attn = attn.transpose(1, 2).flatten(2)
        x = residual + attn_mod.o_proj(attn)

        residual = x
        hs = self.post_attention_layernorm(x)
        mlp = self.mlp
        return residual + mlp.down_proj(F.silu(mlp.gate_proj(hs)) * mlp.up_proj(hs))


class LlamaBackbone(nn.Module):
    """Embedding, layers and final norm (HF ``model``)."""

    def __init__(self, config: LlamaConfig, policy: Policy, attn_implementation: str = "auto"):
        super().__init__()
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size, dtype=policy.param_dtype)
        self.layers = nn.ModuleList(LlamaLayer(config, policy, attn_implementation) for _ in range(config.num_hidden_layers))
        self.norm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps, policy)


class LlamaLM(nn.Module):
    """(B, L) token ids -> (f32 logits (B, L, vocab), cache or None).
    ``attn_implementation`` routes the full forward's attention (see the
    module doc); ``remat`` recomputes each layer in the backward pass."""

    def __init__(
        self, config: LlamaConfig = LlamaConfig(), policy: Policy = DEFAULT, attn_implementation: str = "auto", remat: bool = False
    ):
        super().__init__()
        self.config = config
        self.policy = policy
        self.remat = remat
        self.model = LlamaBackbone(config, policy, attn_implementation)
        self.lm_head = Projection(config.hidden_size, config.vocab_size, policy.param_dtype, torch.float32)


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
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.model.layers):
            if remat:
                x = checkpoint(layer, x, rope, mask, use_reentrant=False)
            else:
                x = layer(x, rope, mask, None if cache is None else cache[i], cache_index)
        return self.lm_head(self.model.norm(x)), cache

    def init_cache(self, batch_size: int, max_len: int) -> Cache:
        """One zeroed {"k", "v"} pair of (B, heads, max_len, head_dim) per layer."""
        cfg = self.config
        shape = (batch_size, cfg.num_attention_heads, max_len, cfg.head_dim)

        def zeros():
            return torch.zeros(shape, dtype=self.policy.compute_dtype, device=self.device)

        return [{"k": zeros(), "v": zeros()} for _ in range(cfg.num_hidden_layers)]


def causal_lm_loss_terms(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the next-token negative log-likelihoods over valid labels, the
    number of valid labels): labels shifted by one, -100 ignored, f32
    log-softmax. Data-parallel steps reduce both over ranks before dividing."""
    shift_labels = labels[:, 1:]
    valid = shift_labels != -100
    safe = torch.where(valid, shift_labels, 0).long()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum(), valid.sum()


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy with -100 ignored (the JAX
    ``causal_lm_loss``, HF ``.loss``)."""
    total, count = causal_lm_loss_terms(logits, labels)
    return total / torch.clamp(count, min=1)


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


def _propose_drafts(buf: torch.Tensor, n: int, *, p: int, ngram: int, spec_tokens: int) -> torch.Tensor:
    """(b, S) prompt-lookup drafts: the continuation of the last earlier
    occurrence of the trailing ``ngram``, else the last committed token
    repeated. ``buf`` is the (b, cap) id buffer, ``n`` the number of tokens
    generated so far (the last committed one is at ``p + n - 1``). Drafts at
    or past that frontier repeat the last committed token."""
    b, cap = buf.shape
    frontier = p + n - 1
    window = cap - ngram + 1  # candidate start positions of the n-gram match
    ctx = buf[:, max(p + n - ngram, 0) :][:, :ngram]
    match = torch.ones((b, window), dtype=torch.bool, device=buf.device)
    for g in range(ngram):
        match &= buf[:, g : g + window] == ctx[:, g : g + 1]
    t_idx = torch.arange(window, device=buf.device)
    # strictly before the trailing occurrence itself; windows past the
    # frontier hold stale bytes and are excluded
    valid = match & (t_idx[None, :] < p + n - ngram)
    m = torch.where(valid, t_idx[None, :], -1).amax(dim=-1)
    start = torch.where(m >= 0, m + ngram, max(frontier, 0))
    idx = (start[:, None] + torch.arange(spec_tokens, device=buf.device)[None, :]).clamp(0, cap - 1)
    return torch.where(idx <= frontier, torch.gather(buf, 1, idx), buf[:, frontier : frontier + 1])


def _force_eos(out: torch.Tensor, done: torch.Tensor, eos: int) -> torch.Tensor:
    """EOS from the first EOS of each row onward, and everywhere in rows already done."""
    hit = (out == eos).long()
    prior = (torch.cumsum(hit, dim=1) - hit) > 0
    return torch.where(done[:, None] | prior, eos, out)


@torch.inference_mode()
def _lookup(model: LlamaLM, prompt_ids, max_new_tokens: int, eos_token_id: int, ngram: int, spec_tokens: int, first, verify):
    """The shared loop of the speculative decoders. ``first`` maps the
    prefill's last (b, V) logits to the first ids; ``verify(logits, drafts,
    done)`` maps the (b, 1 + S, V) verify logits to the (b, 1 + S) block to
    write and the (b,) per-row acceptance. Rows commit in lockstep at the
    minimum acceptance, plus one. Returns (ids, generated, iterations)."""
    prompt = torch.as_tensor(prompt_ids).to(model.device, torch.long)
    b, p = prompt.shape
    S = int(spec_tokens)
    total = p + max_new_tokens
    cap = total + S + 1  # a commit block may overshoot max_new_tokens; sliced off below
    cache = model.init_cache(b, cap)
    buf = torch.zeros((b, cap), dtype=torch.long, device=model.device)
    buf[:, :p] = prompt
    logits, cache = model(prompt, cache=cache, cache_index=0)
    buf[:, p] = first(logits[:, -1])
    done = buf[:, p] == eos_token_id
    slot = torch.arange(1 + S, device=model.device)[None, :]
    n, iters, all_done = 1, 0, bool(done.all())
    while n < max_new_tokens and not all_done:
        drafts = _propose_drafts(buf, n, p=p, ngram=ngram, spec_tokens=S)
        x = torch.cat([buf[:, p + n - 1 : p + n], drafts], dim=1)
        logits, cache = model(x, cache=cache, cache_index=p + n - 1)
        out, acc_row = verify(logits, drafts, done)
        acc = acc_row.amin()
        buf[:, p + n : p + n + 1 + S] = out
        done = done | ((slot <= acc) & (out == eos_token_id)).any(dim=1)
        acc, all_done = torch.stack([acc, done.all().long()]).tolist()  # the loop's one host read
        n, iters = n + acc + 1, iters + 1
    # an all-done early exit leaves an uncommitted tail: greedy emits EOS forever
    buf[:, p + n :] = eos_token_id
    return buf[:, :total], n, iters


def _stats(n: int, iters: int, max_new_tokens: int) -> dict:
    # the last commit block may overshoot max_new_tokens: count emitted tokens only
    n = min(n, max_new_tokens)
    return {"iterations": iters, "generated": n, "tokens_per_iteration": round(n / max(iters, 1), 3)}


def _lookup_greedy(model, prompt_ids, max_new_tokens, eos_token_id, ngram, spec_tokens):
    S = int(spec_tokens)

    def verify(logits, drafts, done):
        out = _force_eos(torch.argmax(logits, dim=-1), done, eos_token_id)
        ok = torch.cumprod((drafts == out[:, :S]).long(), dim=1)
        return out, torch.where(done, S, ok.sum(dim=1))  # done rows place no constraint

    return _lookup(model, prompt_ids, max_new_tokens, eos_token_id, ngram, S, lambda lg: torch.argmax(lg, dim=-1), verify)


def lookup_decode(
    model: LlamaLM,
    prompt_ids,
    max_new_tokens: int,
    eos_token_id: int = 1,
    ngram: int = 2,
    spec_tokens: int = 7,
    return_stats: bool = False,
):
    """Prompt-lookup speculative greedy generation: the ids of
    ``greedy_decode``, (B, prompt + max_new_tokens), in fewer sequential
    forwards when the stream repeats. Rows commit in lockstep at the minimum
    acceptance over the batch, so this is a single-stream (B = 1) tool.
    ``return_stats=True`` also returns {"iterations", "generated",
    "tokens_per_iteration"}."""
    ids, n, iters = _lookup_greedy(model, prompt_ids, max_new_tokens, eos_token_id, ngram, spec_tokens)
    return (ids, _stats(n, iters, max_new_tokens)) if return_stats else ids


def lookup_sample_decode(
    model: LlamaLM,
    prompt_ids,
    max_new_tokens: int,
    eos_token_id: int = 1,
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    ngram: int = 2,
    spec_tokens: int = 7,
    return_stats: bool = False,
):
    """Prompt-lookup speculative sampling, with every committed token drawn
    from the filtered distribution of ``sample_decode`` (deterministic-draft
    rejection sampling): draft j is accepted with probability p_j(d_j); at
    the first rejection a replacement is drawn from p with the draft's mass
    removed; when all S drafts pass, a bonus token from the next position's
    p. Uniforms and Gumbel-max draws come from ``generator`` (on the model's
    device; seed 0 when omitted), so sequences differ from
    ``sample_decode``'s for one seed: equality is in distribution.
    ``temperature=0`` is ``lookup_decode``. ``return_stats`` as there."""
    if temperature == 0.0:
        return lookup_decode(model, prompt_ids, max_new_tokens, eos_token_id, ngram, spec_tokens, return_stats)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    S = int(spec_tokens)

    def gumbel_max(logp):
        u = torch.rand(logp.shape, generator=generator, device=logp.device)
        return torch.argmax(logp - torch.log(-torch.log(u)), dim=-1)

    def filtered(logits):
        shape = logits.shape
        return _filter_logits(logits.reshape(-1, shape[-1]) / temperature, top_k, top_p).reshape(shape)

    def verify(logits, drafts, done):
        b = drafts.shape[0]
        probs = torch.softmax(filtered(logits), dim=-1)  # (b, 1 + S, V)
        p_draft = torch.gather(probs[:, :S], -1, drafts[..., None])[..., 0]
        u = torch.rand((b, S), generator=generator, device=logits.device)
        ok = torch.cumprod((u < p_draft).long(), dim=1)  # leading accepts
        acc_row = torch.where(done, S, ok.sum(dim=1))
        # a fresh token at acc_row: the residual (the draft's mass removed) on a
        # rejection, the full distribution at the bonus position acc_row == S
        p_sel = probs[torch.arange(b, device=logits.device), acc_row]
        drafts_ext = torch.cat([drafts, drafts[:, -1:]], dim=1)
        draft_at = torch.gather(drafts_ext, 1, acc_row[:, None])
        vocab = torch.arange(probs.shape[-1], device=logits.device)[None, :]
        residual = torch.where((acc_row[:, None] < S) & (vocab == draft_at), 0.0, p_sel)
        repl = gumbel_max(torch.log(residual))  # log(0) = -inf: a removed draft is never drawn
        out = torch.where(torch.arange(1 + S, device=logits.device)[None, :] == acc_row[:, None], repl[:, None], drafts_ext)
        return _force_eos(out, done, eos_token_id), acc_row

    ids, n, iters = _lookup(
        model, prompt_ids, max_new_tokens, eos_token_id, ngram, S, lambda lg: gumbel_max(filtered(lg)), verify
    )
    return (ids, _stats(n, iters, max_new_tokens)) if return_stats else ids
