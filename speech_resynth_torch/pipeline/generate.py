"""Textless speech continuation: units -> LM sampling -> units -> waveform.

Counterpart of speech_resynth_tpu/pipeline/generate.py. Deduplicated unit
ids map to printable unicode (text/units.py), BPE-encode to LM tokens
(shifted by the number of special tokens, as in training), continue with the
KV-cached decoders of models/llama.py, map back, and vocode through the
duration-predicting CFM + HiFi-GAN decoder.

Plain decoding is the default; ``speculative=True`` takes the prompt-lookup
decoders (``lookup_decode`` when greedy, ``lookup_sample_decode`` when
sampling), which give the same ids, or the same distribution.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..models.llama import LlamaLM, greedy_decode, lookup_decode, lookup_sample_decode, sample_decode
from ..text.units import unicode_to_units, units_to_unicode


def generate_unit_continuation(
    units: Sequence[int],
    tokenizer,
    model: LlamaLM,
    *,
    max_new_tokens: int = 64,
    eos_token_id: int = 1,
    num_special_tokens: int = 2,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
    speculative: bool = False,
) -> np.ndarray:
    """Continue a deduplicated unit sequence; returns the generated units.

    ``units`` are 0-based unit ids as ``SpeechEncoder(deduplicate=True)``
    gives them. The prompt maps as training data does: unicode, then BPE,
    then +``num_special_tokens``. The sampled ids are cut at EOS, un-shifted,
    stripped of special ids and of ids past the tokenizer's vocabulary (the
    LM head may be wider), and mapped back through the token strings.
    ``generator`` (on the model's device) drives the sampling;
    ``speculative`` picks the prompt-lookup decoders.
    """
    bpe_ids = tokenizer.encode(units_to_unicode([int(u) for u in units]))
    if not bpe_ids:
        raise ValueError("prompt produced no BPE tokens (empty unit sequence?)")
    prompt = torch.tensor([[t + num_special_tokens for t in bpe_ids]], dtype=torch.long)
    if speculative and temperature == 0.0:
        seq = lookup_decode(model, prompt, max_new_tokens, eos_token_id)
    elif speculative:
        seq = lookup_sample_decode(model, prompt, max_new_tokens, eos_token_id, generator, temperature, top_k, top_p)
    elif temperature == 0.0:
        seq = greedy_decode(model, prompt, max_new_tokens, eos_token_id)
    else:
        seq = sample_decode(model, prompt, max_new_tokens, eos_token_id, generator, temperature, top_k, top_p)
    seq = seq[0, prompt.shape[1] :].cpu().numpy()

    hits = np.where(seq == eos_token_id)[0]
    if hits.size:
        seq = seq[: hits[0]]
    vocab = tokenizer.vocab_size
    gen_bpe = [int(t) - num_special_tokens for t in seq if num_special_tokens <= int(t) < vocab + num_special_tokens]
    return np.asarray(unicode_to_units("".join(tokenizer.token(t) for t in gen_bpe)), np.int32)


def synthesize_units(
    decoder,
    units: Sequence[int],
    *,
    dt: float = 0.0625,
    truncation_value: float = 1.0,
    generator: Optional[torch.Generator] = None,
    x0: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """Vocode a unit sequence through the composite decoder: the +1 shift of
    the decoder's vocabulary (pad is 0), then the trimmed 1-D waveform. The
    ODE noise is ``x0`` when given, else drawn from ``generator``."""
    ids = np.asarray(units, np.int64)[None, :] + 1
    return decoder(ids, dt=dt, truncation_value=truncation_value, generator=generator, x0=x0)[0][0]


def continue_speech(
    units: Sequence[int],
    tokenizer,
    model: LlamaLM,
    decoder,
    *,
    include_prompt: bool = True,
    x0: Optional[torch.Tensor] = None,
    **sample_kwargs,
) -> dict:
    """units -> LM continuation -> waveform, in one call.

    Returns {"units": the whole unit sequence, "generated_units",
    "waveform": trimmed 1-D f32}. ``sample_kwargs`` go to
    ``generate_unit_continuation``; ``x0`` is the decoder's ODE noise.
    """
    gen = generate_unit_continuation(units, tokenizer, model, **sample_kwargs)
    full = np.concatenate([np.asarray(units, np.int32), gen]) if include_prompt else gen
    if full.size == 0:
        raise ValueError("nothing to synthesize: empty continuation and include_prompt=False")
    return {"units": full, "generated_units": gen, "waveform": synthesize_units(decoder, full, x0=x0)}
