"""Speech-to-unit encoder: HuBERT tower + k-means quantizer + deduplication.

Counterpart of speech_resynth_tpu/models/speech_encoder.py: named
(dense model, quantizer, vocab size) combinations, a ``deduplicate`` flag,
and a call on (B, T) padded waveforms with lengths that returns padded unit
arrays, durations and unit counts (a 1-D waveform gives 1-D trimmed
outputs). On the card the tower's attention runs the flash kernel (K1) and
the quantizer the assignment kernel (K4). While a profiler session records
(``core.tracing``), each call counts ``encoder.samples_given`` (B times the
padded length) and ``encoder.samples_valid`` (the sum of ``lengths``).

Weights load from a local directory; when a file is missing ``by_name``
warns and falls back to seeded random weights and centers (smoke-test mode).
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..core.precision import BF16_INFERENCE, Policy
from ..core.safetensors import load_file
from ..core.tracing import trace_count
from ..ops.dedup import deduplicate_batch
from .composite import init_random_weights
from .convert import hubert_state_dict_from_hf
from .hubert import HubertConfig, HubertEncoder
from .kmeans import KMeansQuantizer

# name -> HuBERT config and the (1-indexed) layer the k-means codebook was fit on
DENSE_MODELS: Dict[str, Dict] = {
    "hubert-base-ls960": {"config": HubertConfig(), "output_layer": 6},
    "mhubert-base-vp_mls_cv_8lang": {"config": HubertConfig(), "output_layer": 11},
    "mhubert-base-25hz": {"config": HubertConfig(), "output_layer": 11},
}

QUANTIZERS = {
    ("hubert-base-ls960", "kmeans", 50),
    ("hubert-base-ls960", "kmeans", 100),
    ("hubert-base-ls960", "kmeans", 200),
    ("mhubert-base-vp_mls_cv_8lang", "kmeans", 1000),
    ("mhubert-base-vp_mls_cv_8lang", "kmeans-expresso", 2000),
}


@dataclasses.dataclass
class SpeechEncoder:
    """waveform -> discrete units (+ durations when ``deduplicate``). The
    tower and the centers live on one device, where the call runs."""

    encoder: HubertEncoder
    quantizer: KMeansQuantizer
    output_layer: int
    deduplicate: bool = False
    dense_model_name: str = ""
    quantizer_model_name: str = ""

    @property
    def vocab_size(self) -> int:
        return self.quantizer.vocab_size

    @property
    def device(self) -> torch.device:
        return self.quantizer.centers.device

    @torch.inference_mode()
    def _encode(self, wav: torch.Tensor, num_samples: Optional[torch.Tensor] = None) -> torch.Tensor:
        feats = self.encoder(wav, output_layer=self.output_layer, num_samples=num_samples)
        return self.quantizer(feats)

    @torch.inference_mode()
    def __call__(self, wav, lengths=None) -> Dict[str, torch.Tensor]:
        """wav: (T,) or (B, T) 16 kHz waveform; lengths: optional (B,) valid samples.

        Returns {"units", "durations", "num_units"} as tensors on the
        encoder's device: (B, N) int32 units (dedup: runs, zero past
        num_units), (B, N) int32 durations (ones without dedup), (B,) int32
        counts. A 1-D input gives 1-D outputs trimmed to its count, which is
        then an int."""
        wav = torch.as_tensor(np.asarray(wav) if not torch.is_tensor(wav) else wav)
        wav = wav.to(self.device, torch.float32)
        squeeze = wav.ndim == 1
        if squeeze:
            wav = wav[None]
        ns = None if lengths is None else torch.as_tensor(np.asarray(lengths), device=self.device).long()
        trace_count("encoder.samples_given", wav.numel())  # the batch's padded samples
        trace_count("encoder.samples_valid", wav.numel() if lengths is None else np.sum(lengths))
        units = self._encode(wav, ns)  # (B, N) frame-rate units

        cfg = self.encoder.config
        if lengths is not None:
            frame_lengths = torch.tensor(
                [cfg.num_frames(int(n)) for n in np.asarray(lengths)], dtype=torch.int32, device=self.device
            )
        else:
            frame_lengths = torch.full((wav.shape[0],), units.shape[1], dtype=torch.int32, device=self.device)

        if self.deduplicate:
            deduped, durations, num = deduplicate_batch(units, frame_lengths)
            out = {"units": deduped, "durations": durations, "num_units": num}
        else:
            out = {"units": units, "durations": torch.ones_like(units), "num_units": frame_lengths}

        if squeeze:
            n = int(out["num_units"][0])
            out = {"units": out["units"][0, :n], "durations": out["durations"][0, :n], "num_units": n}
        return out

    # -- construction --------------------------------------------------------

    @classmethod
    def by_name(
        cls,
        dense_model_name: str = "mhubert-base-vp_mls_cv_8lang",
        quantizer_model_name: str = "kmeans-expresso",
        vocab_size: int = 2000,
        deduplicate: bool = False,
        need_f0: bool = False,
        checkpoint_dir: Optional[str] = None,
        policy: Policy = BF16_INFERENCE,
        rng_seed: int = 0,
        device: DeviceLike = None,
    ) -> "SpeechEncoder":
        """Named encoder on ``device`` (the card unless ``"cpu"``).

        ``checkpoint_dir`` (default ``$SPEECH_RESYNTH_MODELS`` or
        ``models/encoders``) holds ``<dense_model_name>.safetensors`` (an HF
        ``HubertModel`` state_dict) and
        ``<dense_model_name>-<quantizer_model_name>-<vocab_size>.npz``
        (k-means centers). A missing file falls back, with a warning, to
        random weights or centers from a CPU ``torch.Generator`` seeded with
        ``rng_seed`` (weights) and ``rng_seed + 1`` (centers)."""
        if need_f0:
            raise NotImplementedError("f0 extraction is not part of the reference capability set")
        if dense_model_name not in DENSE_MODELS:
            raise KeyError(f"unknown dense model {dense_model_name!r}; have {sorted(DENSE_MODELS)}")
        device = resolve_device(device)
        spec = DENSE_MODELS[dense_model_name]
        config: HubertConfig = spec["config"]
        encoder = HubertEncoder(config, policy)

        ckpt_dir = Path(checkpoint_dir or os.environ.get("SPEECH_RESYNTH_MODELS", "models/encoders"))
        dense_path = ckpt_dir / f"{dense_model_name}.safetensors"
        km_path = ckpt_dir / f"{dense_model_name}-{quantizer_model_name}-{vocab_size}.npz"

        if dense_path.is_file():
            encoder.load_state_dict(hubert_state_dict_from_hf(load_file(str(dense_path))))
        else:
            warnings.warn(
                f"no converted weights at {dense_path}; {dense_model_name} is RANDOMLY initialized (smoke-test mode).",
                stacklevel=2,
            )
            init_random_weights(encoder, torch.Generator().manual_seed(rng_seed))

        if km_path.is_file():
            quantizer = KMeansQuantizer.load(km_path)
        else:
            warnings.warn(f"no k-means centers at {km_path}; using random centers (smoke-test mode).", stacklevel=2)
            gen = torch.Generator().manual_seed(rng_seed + 1)
            quantizer = KMeansQuantizer(torch.randn((vocab_size, config.hidden_size), generator=gen))

        return cls(
            encoder=encoder.to(device).eval().requires_grad_(False),
            quantizer=quantizer.to(device),
            output_layer=spec["output_layer"],
            deduplicate=deduplicate,
            dense_model_name=dense_model_name,
            quantizer_model_name=quantizer_model_name,
        )


def load_encoder(
    dense_model_name: str = "mhubert-base-vp_mls_cv_8lang",
    quantizer_model_name: str = "kmeans-expresso",
    vocab_size: int = 2000,
    deduplicate: bool = False,
    **kwargs,
) -> SpeechEncoder:
    """The textlesslib-style loader signature."""
    return SpeechEncoder.by_name(
        dense_model_name=dense_model_name,
        quantizer_model_name=quantizer_model_name,
        vocab_size=vocab_size,
        deduplicate=deduplicate,
        need_f0=False,
        **kwargs,
    )


def embedding(
    dense_model_name: str = "mhubert-base-vp_mls_cv_8lang",
    quantizer_model_name: str = "kmeans-expresso",
    vocab_size: int = 2000,
    checkpoint_dir: Optional[str] = None,
    rng_seed: int = 0,
    device: DeviceLike = None,
) -> np.ndarray:
    """Frozen unit-embedding table (vocab + 1, 768): a zero pad row, then the centers."""
    enc = SpeechEncoder.by_name(
        dense_model_name, quantizer_model_name, vocab_size, checkpoint_dir=checkpoint_dir, rng_seed=rng_seed,
        device=device,
    )
    return enc.quantizer.embedding_table()
