"""Decoder loading for the resynthesis stages.

Counterpart of ``_load_decoder`` in speech_resynth_tpu/pipeline/evaluate.py;
the rest of that module (ASR and MOS scoring) is not ported yet.
"""

from __future__ import annotations

from pathlib import Path

from ..core.device import DeviceLike
from ..models.composite import ConditionalFlowMatchingWithHifiGan


def _load_decoder(config, device: DeviceLike = None) -> ConditionalFlowMatchingWithHifiGan:
    """The composite checkpoint directory ``flow_matching_with_hifigan.name``
    when it exists, else the two training-export directories
    (``<flow_matching.path>/hf`` and ``hifigan.path``)."""
    name = None
    try:
        name = config.flow_matching_with_hifigan.get("name")
    except (AttributeError, KeyError):
        pass
    name_error = None
    if name:
        try:
            return ConditionalFlowMatchingWithHifiGan.from_pretrained(str(name), device=device)
        except FileNotFoundError as exc:  # fall back to the training exports
            name_error = str(exc)
    fm_dir = Path(str(config.flow_matching.path)) / "hf"
    voc_dir = Path(str(config.hifigan.path))
    if (fm_dir / "config.json").is_file() and (voc_dir / "config.json").is_file():
        return ConditionalFlowMatchingWithHifiGan.load_pretrained(fm_dir, voc_dir, device=device)
    raise FileNotFoundError(
        "no decoder checkpoint found: flow_matching_with_hifigan.name "
        f"({name!r}) did not resolve"
        + (f" ({name_error})" if name_error else "")
        + f" and the training-export dirs are incomplete ({fm_dir}/config.json "
        f"and {voc_dir}/config.json must both exist)"
    )
