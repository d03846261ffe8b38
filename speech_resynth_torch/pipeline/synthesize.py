"""Batch resynthesis: wav tree -> units -> decoder -> wav tree.

Counterpart of speech_resynth_tpu/pipeline/synthesize.py: each batch of
source waveforms is encoded to units (+1 shift, 0 = pad; deduplicated when
the decoder predicts durations), the composite decoder turns the units into
waveforms, and the trimmed 16 kHz waveforms are written to ``tgt_dir`` with
the source tree's relative paths.

While a profiler session records (``core.tracing``), each batch records the
spans ``resynth.read`` (the next batch from the dataset), ``resynth.encode``,
``resynth.decode`` (``decoder.synthesize``), ``resynth.fetch`` (the host
waiting for the waveforms) and ``resynth.write``, in that order, each with
the batch's index.
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.device import DeviceLike
from ..core.tracing import trace_span
from ..dsp import audio_io
from ..models.composite import ConditionalFlowMatchingWithHifiGan
from ..models.speech_encoder import SpeechEncoder
from .data import SpeechDataset


def synthesize(
    config,
    encoder: Optional[SpeechEncoder] = None,
    decoder: Optional[ConditionalFlowMatchingWithHifiGan] = None,
    device: DeviceLike = None,
) -> None:
    """Resynthesize ``config.synthesis.src_dir`` into ``config.synthesis.tgt_dir``.
    Without ``encoder`` / ``decoder`` they are loaded from the config on
    ``device`` (the card unless ``"cpu"``)."""
    dataset = SpeechDataset(
        config.synthesis.src_dir,
        split=config.synthesis.split,
        ext_audio=config.synthesis.ext_audio,
    )
    if encoder is None:
        encoder = SpeechEncoder.by_name(
            config.flow_matching.dense_model_name,
            config.flow_matching.quantizer_model_name,
            config.flow_matching.vocab_size,
            deduplicate=bool(config.flow_matching.get("predict_duration", False)),
            device=device,
        )
    if decoder is None:
        from .evaluate import _load_decoder

        decoder = _load_decoder(config, device=device)

    tgt_dir = Path(config.synthesis.tgt_dir)
    dt = float(config.flow_matching.dt)
    trunc = config.flow_matching.get("truncation_value")
    batch_size = int(config.flow_matching_with_hifigan.batch_size)

    generator = torch.Generator(device=decoder.device).manual_seed(int(config.get("common", {}).get("seed", 0) or 0))
    batches = dataset.batches(batch_size)
    for index in itertools.count():
        with trace_span("resynth.read", batch=index):
            batch = next(batches, None)
        if batch is None:
            break
        valid = batch["wavs_len"] >= 0
        with trace_span("resynth.encode", batch=index):
            enc = encoder(batch["input_values"], lengths=np.maximum(batch["wavs_len"], 0))
        units, counts = enc["units"] + 1, enc["num_units"]  # 0: pad
        pos = torch.arange(units.shape[1], device=units.device)[None, :]
        input_ids = torch.where(pos < counts[:, None], units, torch.zeros_like(units))

        with trace_span("resynth.decode", batch=index):
            wavs, lengths = decoder.synthesize(input_ids, dt=dt, truncation_value=trunc, generator=generator)
        with trace_span("resynth.fetch", batch=index):
            wavs, lengths = wavs.cpu().numpy(), lengths.cpu().numpy()
        with trace_span("resynth.write", batch=index):
            for name, wav, n, ok in zip(batch["names"], wavs, lengths, valid):
                if ok:
                    audio_io.write((tgt_dir / name).with_suffix(config.synthesis.ext_audio), wav[: int(n)], 16000)
