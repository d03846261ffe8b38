"""Speech-LM pipeline pieces the continuation path needs.

The port's counterparts of ``_make_encoder`` and ``load_lm_from_hf`` in
speech_resynth_tpu/pipeline/speechlm.py. The other stages there (``encode``,
``tokenize``, ``tokenize_slm21``, ``evaluate`` and ``write_scores``) are not
ported yet.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Union

from ..core.device import DeviceLike, resolve_device
from ..core.precision import BF16_INFERENCE, Policy
from ..models.convert import llama_state_dict_from_hf, load_checkpoint
from ..models.llama import LlamaConfig, LlamaLM
from ..models.speech_encoder import SpeechEncoder


def _make_encoder(config, device: DeviceLike = None) -> SpeechEncoder:
    """The deduplicating encoder named by ``config.s2u``."""
    return SpeechEncoder.by_name(
        config.s2u.dense_model_name,
        config.s2u.quantizer_model_name,
        config.s2u.vocab_size,
        deduplicate=True,
        device=device,
    )


def load_lm_from_hf(
    model_dir: Union[str, Path], policy: Optional[Policy] = None, device: DeviceLike = None
) -> LlamaLM:
    """Load a local HF ``LlamaForCausalLM`` directory (``config.json`` and
    ``model.safetensors`` or ``pytorch_model.bin``; the layout the JAX
    trainer's export writes) into a ``LlamaLM`` on ``device`` (the card unless
    ``"cpu"``), in ``BF16_INFERENCE`` unless ``policy`` says otherwise."""
    device = resolve_device(device)
    model_dir = Path(model_dir)
    if not model_dir.is_dir():
        raise FileNotFoundError(f"{model_dir} is not a local checkpoint directory")
    with open(model_dir / "config.json") as f:
        hf = json.load(f)
    config = LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 10000.0),
        pad_token_id=hf.get("pad_token_id") or 0,
        bos_token_id=hf.get("bos_token_id"),
        eos_token_id=hf.get("eos_token_id"),
    )
    model = LlamaLM(config, policy or BF16_INFERENCE)
    model.load_state_dict(llama_state_dict_from_hf(load_checkpoint(model_dir)))
    return model.to(device).eval().requires_grad_(False)
