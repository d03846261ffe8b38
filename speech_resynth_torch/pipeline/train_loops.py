"""Stage functions of the speech-LM CLI.

Only ``generate_speechlm`` is ported so far, the counterpart of the function
of that name in speech_resynth_tpu/pipeline/train_loops.py; the trainers
wait for ROADMAP.md queue 1 item 9.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..dsp import audio_io
from ..models.composite import ConditionalFlowMatchingWithHifiGan
from ..tokenizers.bpe import BpeTokenizer
from .generate import continue_speech, generate_unit_continuation
from .speechlm import _make_encoder, load_lm_from_hf

SAMPLE_RATE = 16000


def generate_speechlm(
    config,
    prompt_wav: str,
    out_wav: Optional[str] = None,
    decoder_dir: Optional[str] = None,
    max_new_tokens: int = 128,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int = 0,
    device: DeviceLike = None,
) -> dict:
    """Textless continuation: prompt wav -> units -> LM sampling -> units,
    and -> waveform when a resynthesis decoder directory is given.

    The tokenizer comes from ``config.s2u.tokenizer_path``, the encoder from
    ``config.s2u`` (deduplicating), and the special-token count from the pad,
    bos and eos ids of ``config.model``. The port has no reader for the JAX
    trainer's checkpoint yet, so the LM loads from ``<model.path>/hf``, the
    HF directory that trainer exports, through ``load_lm_from_hf``. Returns
    the ``continue_speech`` result and writes ``out_wav`` (16 kHz) when
    asked. Everything runs on ``device``, the card unless ``"cpu"``; the
    sampling generator is seeded with ``seed`` there.
    """
    device = resolve_device(device)
    tokenizer = BpeTokenizer.from_file(config.s2u.tokenizer_path)
    special = {config.model.get(k) for k in ("pad_token_id", "bos_token_id", "eos_token_id")}
    num_special = len(special - {None})
    model = load_lm_from_hf(Path(config.model.path) / "hf", device=device)
    eos = config.model.get("eos_token_id")

    encoder = _make_encoder(config, device=device)
    wav, _ = audio_io.read(prompt_wav)
    units = encoder(wav.astype(np.float32))["units"].cpu().numpy()  # a 1-D input gives 1-D units

    kwargs = dict(
        max_new_tokens=max_new_tokens,
        eos_token_id=eos if eos is not None else 1,
        num_special_tokens=num_special,
        temperature=temperature,
        top_k=top_k,
        top_p=top_p,
        generator=torch.Generator(device=device).manual_seed(seed),
    )
    if decoder_dir is None:
        generated = generate_unit_continuation(units, tokenizer, model, **kwargs)
        return {"units": np.concatenate([units, generated]), "generated_units": generated, "waveform": None}

    decoder = ConditionalFlowMatchingWithHifiGan.from_pretrained(decoder_dir, device=device)
    result = continue_speech(units, tokenizer, model, decoder, **kwargs)
    if out_wav:
        audio_io.write(out_wav, result["waveform"], SAMPLE_RATE)
    return result
