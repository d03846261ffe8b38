"""Preprocessing stages of a resynthesis corpus: resample, tokenize, extract_features.

Counterpart of speech_resynth_tpu/pipeline/preprocess.py. Each stage reads
whole batches with the threaded WAV loader, pads them to a length bucket and
runs one batched pass on ``device`` (the card unless ``"cpu"``):
- ``resample``: every wav under ``dataset.wav_dir_orig`` -> 16 kHz under
  ``dataset.wav_dir``, grouped by source rate, with an optional VAD trim
  (``dataset.vad``);
- ``tokenize``: the train, dev and test splits -> ``{name: {units,
  durations, transcript}}`` JSONs through the ``flow_matching`` encoder
  (deduplicating when ``predict_duration``);
- ``extract_features``: each wav, peak-normalized to 0.95 -> its log-mel
  (frames, 80) as ``.npy`` under ``dataset.spectrogram_dir``; files that
  exist are skipped.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..dsp import audio_io
from ..dsp.mel import log_mel_spectrogram
from ..dsp.resample import resample as resample_op
from ..dsp.vad import trim
from ..models.speech_encoder import SpeechEncoder
from .data import LibriTTS_R

SAMPLE_RATE = 16000
BUCKETS = (SAMPLE_RATE * 5, SAMPLE_RATE * 10, SAMPLE_RATE * 20, SAMPLE_RATE * 40)  # padded lengths at 16 kHz


def _bucket(n: int, sizes: Sequence[int]) -> int:
    """The first size that holds ``n``, else the last."""
    return next((s for s in sizes if n <= s), sizes[-1])


def resample(config, device: DeviceLike = None) -> None:
    """Every wav under ``dataset.wav_dir_orig`` -> 16 kHz under ``dataset.wav_dir``
    (same relative paths), trimmed by the VAD when ``dataset.vad``."""
    device = resolve_device(device)
    wav_dir_orig, wav_dir = Path(config.dataset.wav_dir_orig), Path(config.dataset.wav_dir)
    vad = bool(config.dataset.get("vad", False))
    by_sr: Dict[int, List[Path]] = {}  # one batched pass per source rate
    for p in sorted(wav_dir_orig.glob(f"**/*{config.dataset.ext_audio}")):
        try:
            sr, _, _ = audio_io.info(p)
        except IOError:
            continue
        by_sr.setdefault(sr, []).append(p)

    batch_size = int(config.dataset.get("preprocess_batch_size", 32))
    for sr, group in by_sr.items():
        for i in range(0, len(group), batch_size):
            chunk = group[i : i + batch_size]
            max_len = max(audio_io.info(p)[2] for p in chunk)
            wavs, lengths, _ = audio_io.read_batch(chunk, _bucket(max_len, [int(b * sr / SAMPLE_RATE) for b in BUCKETS]))
            if sr != SAMPLE_RATE:
                wavs = resample_op(torch.from_numpy(wavs).to(device), sr, SAMPLE_RATE).cpu().numpy()
                lengths = (lengths * SAMPLE_RATE + sr - 1) // sr
            for p, wav, n in zip(chunk, wavs, lengths):
                if n < 0:
                    continue
                y = wav[: int(n)]
                if vad:
                    y, _ = trim(y, top_db=20)
                audio_io.write(wav_dir / p.relative_to(wav_dir_orig), y, SAMPLE_RATE)


def tokenize(config, encoder: Optional[SpeechEncoder] = None, device: DeviceLike = None) -> None:
    """The train (``train-*`` under ``dataset.wav_dir``), dev (``dev-clean``)
    and test (``test-*``) splits -> unit JSONs (``dataset.train_file``,
    ``dev_file``, ``test_file``); dev and test transcripts resolve against
    ``dataset.wav_dir_orig``. Without ``encoder`` the ``flow_matching`` one
    is loaded on ``device``."""
    if encoder is None:
        encoder = SpeechEncoder.by_name(
            config.flow_matching.dense_model_name,
            config.flow_matching.quantizer_model_name,
            config.flow_matching.vocab_size,
            deduplicate=bool(config.flow_matching.get("predict_duration", False)),
            device=device,
        )
    wav_dir, ext, txt_dir = config.dataset.wav_dir, config.dataset.ext_audio, config.dataset.get("wav_dir_orig")
    splits = [
        (LibriTTS_R(wav_dir, split="train-*", ext_audio=ext), config.dataset.train_file),
        (LibriTTS_R(wav_dir, txt_dir, split="dev-clean", ext_audio=ext), config.dataset.dev_file),
        (LibriTTS_R(wav_dir, txt_dir, split="test-*", ext_audio=ext), config.dataset.test_file),
    ]
    batch_size = int(config.dataset.get("preprocess_batch_size", 16))
    for dataset, out_file in splits:
        _tokenize(encoder, out_file, dataset, batch_size)


def _tokenize(encoder: SpeechEncoder, out_file: str, dataset, batch_size: int) -> None:
    result: Dict[str, Dict] = {}
    for batch in dataset.batches(batch_size):
        out = encoder(batch["input_values"], lengths=np.maximum(batch["wavs_len"], 0))
        units, durations, counts = (out[k].cpu().numpy() for k in ("units", "durations", "num_units"))
        for j, name in enumerate(batch["names"]):
            if batch["wavs_len"][j] < 0:
                continue
            n = int(counts[j])
            result[name] = {
                "units": units[j, :n].tolist(),
                "durations": durations[j, :n].tolist(),
                "transcript": batch["transcripts"][j],
            }
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    with open(out_file, "w") as f:
        json.dump(result, f)


def extract_features(config, device: DeviceLike = None) -> None:
    """The log-mel of every wav under ``dataset.wav_dir`` that has no
    ``.npy`` under ``dataset.spectrogram_dir`` yet: peak-normalized to 0.95,
    1 + (n - 400) // 320 frames of a file of n samples."""
    device = resolve_device(device)
    wav_dir, spectrogram_dir = Path(config.dataset.wav_dir), Path(config.dataset.spectrogram_dir)
    todo = []
    for p in sorted(wav_dir.glob(f"**/*{config.dataset.ext_audio}")):
        out_path = spectrogram_dir / p.relative_to(wav_dir).with_suffix(".npy")
        if not out_path.is_file():
            todo.append((p, out_path))

    batch_size = int(config.dataset.get("preprocess_batch_size", 16))
    hop, n_fft = 320, 400
    for i in range(0, len(todo), batch_size):
        chunk = todo[i : i + batch_size]
        bucket = _bucket(max(audio_io.info(p)[2] for p, _ in chunk), BUCKETS)
        wavs, lengths, _ = audio_io.read_batch([p for p, _ in chunk], bucket)
        wavs = wavs / np.maximum(np.abs(wavs).max(axis=1, keepdims=True), 1e-9) * 0.95
        mels = log_mel_spectrogram(torch.from_numpy(wavs).to(device)).cpu().numpy()  # (B, frames, 80)
        for (p, out_path), mel, n in zip(chunk, mels, lengths):
            if n < 0:
                continue
            out_path.parent.mkdir(parents=True, exist_ok=True)
            np.save(out_path, mel[: max(1 + (int(n) - n_fft) // hop, 0)])


def preprocess(config, device: DeviceLike = None) -> None:
    """resample, tokenize, extract_features."""
    resample(config, device)
    tokenize(config, device=device)
    extract_features(config, device)
