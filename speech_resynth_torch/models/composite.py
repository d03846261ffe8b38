"""ConditionalFlowMatchingWithHifiGan: the unit-to-waveform decoder.

Counterpart of speech_resynth_tpu/models/composite.py. ``synthesize`` runs
the CFM ODE to a log-mel and the HiFi-GAN generator to a padded waveform
batch with per-row lengths, all on the decoder's device and without a host
sync, so a caller can queue several batches; ``__call__`` returns the
reference's list of trimmed numpy waveforms. A duration-predicting model
first runs its duration predictor to pick the frame bound (``_duration_bound``,
a multiple of 64 as in the JAX package, so the padded vocoder input and the
tail samples of each row are the same): that pre-pass waits for the card.
While a profiler session records, ``synthesize`` records the spans
``decoder.synthesize`` and, inside it, ``decoder.input``,
``decoder.duration_bound``, ``decoder.ode`` and ``decoder.vocoder``
(``core.tracing``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from ..core.initializers import init_by_rules
from ..core.precision import BF16_INFERENCE, Policy
from ..core.tracing import trace_span
from ..dsp.mulaw import mulaw_encode
from .cfm import CFMConfig, ConditionalFlowMatchingModel
from .convert import load_checkpoint
from .hifigan import HifiGanConfig, HifiGanGenerator
from .hub import resolve_pretrained_dir


def init_random_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights from ``generator`` (a CPU one, or a CUDA one to
    draw on the card), each parameter and buffer by the initializer the
    module's model declares (``module.init_rules()``: the JAX package's, see
    ``core.initializers``). A module without rules, or a tensor its rules do
    not name, raises."""
    rules = getattr(module, "init_rules", None)
    if rules is None:
        raise TypeError(f"{type(module).__name__} declares no init_rules")
    init_by_rules(module, rules(), generator)


def pcm16_encode(waveform: torch.Tensor) -> torch.Tensor:
    """float waveform -> int16 PCM samples, on the waveform's device."""
    return torch.round(waveform.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)


def _to_device(module: nn.Module, device: torch.device) -> nn.Module:
    return module.to(device).eval().requires_grad_(False)


def _cfm_config(m: dict) -> CFMConfig:
    return CFMConfig(**{k: m[k] for k in dataclasses.asdict(CFMConfig()) if k in m})


def load_vocoder(voc_dir: Path, policy: Policy) -> HifiGanGenerator:
    """The generator a trainer exported to ``voc_dir`` (``config.json`` holding
    the HiFi-GAN config, and weights), on the CPU."""
    with open(Path(voc_dir) / "config.json") as f:
        vocoder = HifiGanGenerator(HifiGanConfig.from_dict(json.load(f)), policy)
    sd = load_checkpoint(Path(voc_dir))
    for name, identity in (("mean", vocoder.mean), ("scale", vocoder.scale)):
        sd.setdefault(name, identity)  # a checkpoint without input stats normalizes by identity
    vocoder.load_state_dict(sd)
    return vocoder


class ConditionalFlowMatchingWithHifiGan:
    def __init__(self, model: ConditionalFlowMatchingModel, vocoder: HifiGanGenerator, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = _to_device(model, self.device)
        self.vocoder = _to_device(vocoder, self.device)

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_config(
        cls,
        model_config: CFMConfig,
        vocoder_config: HifiGanConfig = HifiGanConfig(),
        policy: Policy = BF16_INFERENCE,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ) -> "ConditionalFlowMatchingWithHifiGan":
        """Random weights from ``generator`` (a CPU ``torch.Generator``; seed 0
        when omitted)."""
        device = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        model = ConditionalFlowMatchingModel(model_config, policy)
        init_random_weights(model, gen)
        vocoder = HifiGanGenerator(vocoder_config, policy)
        init_random_weights(vocoder, gen)
        return cls(model, vocoder, device)

    @classmethod
    def from_pretrained(
        cls, model_dir: Union[str, Path], policy: Policy = BF16_INFERENCE, device: DeviceLike = None
    ) -> "ConditionalFlowMatchingWithHifiGan":
        """Load a composite checkpoint directory, local or an ``org/name``
        hub id in the HF cache (``models.hub.resolve_pretrained_dir``; nothing
        is downloaded): ``config.json`` with ``model_config`` and
        ``vocoder_config``, and weights keyed ``model.*`` and ``vocoder.*``
        (the layout ``models.convert.save_composite_pretrained`` and the JAX
        package's writer give). Parameters take ``policy.param_dtype``;
        buffers stay f32."""
        device = resolve_device(device)
        model_dir = resolve_pretrained_dir(model_dir)
        with open(model_dir / "config.json") as f:
            cfg = json.load(f)
        model_config = _cfm_config(cfg["model_config"])
        vocoder_config = HifiGanConfig.from_dict(cfg["vocoder_config"])

        sd = load_checkpoint(model_dir)
        model = ConditionalFlowMatchingModel(model_config, policy)
        model.load_state_dict({k[len("model.") :]: v for k, v in sd.items() if k.startswith("model.")})
        vocoder = HifiGanGenerator(vocoder_config, policy)
        vocoder.load_state_dict({k[len("vocoder.") :]: v for k, v in sd.items() if k.startswith("vocoder.")})
        return cls(model, vocoder, device)

    @classmethod
    def load_pretrained(
        cls,
        model_path: Union[str, Path],
        vocoder_path: Union[str, Path],
        policy: Policy = BF16_INFERENCE,
        device: DeviceLike = None,
    ) -> "ConditionalFlowMatchingWithHifiGan":
        """Two local directories, as the trainers export them: the CFM model's
        (``config.json`` holding the CFM config, un-prefixed weights) and the
        vocoder's (``config.json`` holding the HiFi-GAN config)."""
        device = resolve_device(device)
        model_dir, voc_dir = Path(model_path), Path(vocoder_path)
        for d in (model_dir, voc_dir):
            if not d.is_dir():
                raise FileNotFoundError(f"{d} is not a local checkpoint directory")
        with open(model_dir / "config.json") as f:
            model_config = _cfm_config(json.load(f))
        model = ConditionalFlowMatchingModel(model_config, policy)
        model.load_state_dict(load_checkpoint(model_dir))
        return cls(model, load_vocoder(voc_dir, policy), device)

    # -- inference --------------------------------------------------------------

    def _duration_bound(self, ids: torch.Tensor) -> int:
        """Frame bound of a duration-predicting batch: the largest predicted
        total, rounded up to a multiple of 64 (at least 64)."""
        with trace_span("decoder.duration_bound"):  # the predictor and the host's wait for its totals
            needed = int(self.model.predict_durations(ids).sum(dim=-1).max())
        return max(64, -(-max(needed, 1) // 64) * 64)

    @torch.inference_mode()
    def synthesize(
        self,
        input_ids,
        dt: float = 0.1,
        truncation_value: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        x0: Optional[torch.Tensor] = None,
        pcm16: bool = False,
        mulaw: bool = False,
        ode_method: str = "euler",
        max_frames: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(padded waveforms (B, T_max), lengths (B,)), both on the device.

        ``pcm16=True`` gives int16 samples, ``mulaw=True`` uint8 mu-law codes
        (both converted on the device); the two are exclusive. The ODE noise
        is ``x0`` when given, else drawn from ``generator`` (a generator on
        the decoder's device; seed 0 when omitted)."""
        if pcm16 and mulaw:
            raise ValueError("pcm16 and mulaw are mutually exclusive wire formats")
        with trace_span("decoder.synthesize"):  # host time of the whole call: the enqueue, and any wait in it
            with trace_span("decoder.input"):  # from pageable host memory the copy first waits for the card's queue
                ids = torch.as_tensor(np.asarray(input_ids) if not torch.is_tensor(input_ids) else input_ids)
                ids = ids.to(self.device, torch.long, non_blocking=True)
            if x0 is None and generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            if max_frames is None and self.model.config.predict_duration:
                max_frames = self._duration_bound(ids)
            with trace_span("decoder.ode"):  # the ODE's launches, and the host's wait on a full launch queue
                spectrogram, frame_mask = self.model.sample(
                    ids, dt, truncation_value, generator=generator, x0=x0, ode_method=ode_method, max_frames=max_frames
                )
            lengths = self.vocoder.config.waveform_lengths(frame_mask.sum(dim=1))
            with trace_span("decoder.vocoder"):  # the generator and the wire format's conversion
                waveform = self.vocoder(spectrogram)
                if mulaw:
                    waveform = mulaw_encode(waveform)
                elif pcm16:
                    waveform = pcm16_encode(waveform)
        return waveform, lengths

    def __call__(
        self,
        input_ids,
        dt: float = 0.1,
        truncation_value: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        x0: Optional[torch.Tensor] = None,
        ode_method: str = "euler",
        max_frames: Optional[int] = None,
    ) -> List[np.ndarray]:
        """Reference-signature path: a list of (1, T_i) trimmed f32 waveforms."""
        waveform, lengths = self.synthesize(
            input_ids, dt, truncation_value, generator, x0, ode_method=ode_method, max_frames=max_frames
        )
        waveform, lengths = waveform.cpu().numpy(), lengths.cpu().numpy()
        return [w[None, :n] for w, n in zip(waveform, lengths)]
