"""Datasets and batch shaping (counterpart of speech_resynth_tpu/pipeline/data.py)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from ..dsp import audio_io


def bucket_length(n: int, multiple: int = 64, minimum: int = 64) -> int:
    """Round a padded dimension up to a bucket boundary, so a variable-length
    request stream produces few distinct batch shapes."""
    return max(minimum, -(-n // multiple) * multiple)


class SpeechDataset:
    """Glob a wav tree (``<wav_dir>/<split>/**/*<ext_audio>``, sorted) and
    iterate padded waveform batches. Transcripts resolve against ``txt_dir``
    (default ``wav_dir``); the base class has none."""

    def __init__(
        self,
        wav_dir: str,
        txt_dir: Optional[str] = None,
        split: str = "train-*",
        ext_audio: str = ".wav",
        ext_txt: Optional[str] = None,
    ):
        self.wav_dir = Path(wav_dir)
        self.txt_dir = Path(txt_dir) if txt_dir is not None else self.wav_dir
        self.wav_paths = sorted(self.wav_dir.glob(f"{split}/**/*{ext_audio}"))
        self.ext_audio = ext_audio
        self.ext_txt = ext_txt

    def __len__(self) -> int:
        return len(self.wav_paths)

    def name_of(self, path: Path) -> str:
        return str(path.relative_to(self.wav_dir).with_suffix(""))

    def transcript_of(self, path: Path) -> str:
        return ""

    def batches(self, batch_size: int, max_seconds: float = 30.0, sample_rate: int = 16000) -> Iterator[Dict]:
        """Batches of ``batch_size`` files (the last may be smaller), each read
        into a (n, max_seconds * sample_rate) f32 array; ``wavs_len`` is -1
        for a file that could not be read. Also each file's sample rate,
        name, transcript and path."""
        max_frames = int(max_seconds * sample_rate)
        for i in range(0, len(self.wav_paths), batch_size):
            chunk = self.wav_paths[i : i + batch_size]
            wavs, lengths, srs = audio_io.read_batch(chunk, max_frames)
            yield {
                "input_values": wavs,
                "wavs_len": lengths,
                "sample_rates": srs,
                "names": [self.name_of(p) for p in chunk],
                "transcripts": [self.transcript_of(p) for p in chunk],
                "paths": chunk,
            }


class LibriTTS_R(SpeechDataset):
    """LibriTTS-R: each wav's transcript in ``<name>.normalized.txt`` under ``txt_dir``."""

    def __init__(self, wav_dir, txt_dir=None, split="train-*", ext_audio=".wav", ext_txt=".normalized.txt"):
        super().__init__(wav_dir, txt_dir, split, ext_audio, ext_txt)

    def transcript_of(self, path: Path) -> str:
        txt = (self.txt_dir / path.relative_to(self.wav_dir)).with_suffix("").with_suffix(".normalized.txt")
        return txt.read_text().rstrip() if txt.is_file() else ""


class LibriSpeech(SpeechDataset):
    """LibriSpeech: transcripts in ``<split>/<speaker>/<chapter>/<speaker>-<chapter>.trans.txt``."""

    def transcript_of(self, path: Path) -> str:
        split, speaker, chap, utt = self.name_of(path).split("/")
        trans = self.txt_dir / split / speaker / chap / f"{speaker}-{chap}.trans.txt"
        if trans.is_file():
            for line in trans.read_text().splitlines():
                utt_id, _, text = line.partition(" ")
                if utt_id == utt:
                    return text
        return ""


def load_named_units_from_json(file: str, batch_size: int, num_special_tokens: int = 2) -> Iterator[Dict]:
    """sWUGGY / sBLIMP scoring batches from a ``{name: [BPE ids]}`` JSON, in
    its order: ids shifted by ``num_special_tokens``, right-padded with 0 to
    ``bucket_length(longest, 32, 32)``."""
    with open(file) as f:
        items = list(json.load(f).items())
    for i in range(0, len(items), batch_size):
        chunk = items[i : i + batch_size]
        seqs = [np.asarray(v, np.int64) + num_special_tokens for _, v in chunk]
        ids = np.zeros((len(seqs), bucket_length(max(len(s) for s in seqs), multiple=32, minimum=32)), np.int32)
        for j, s in enumerate(seqs):
            ids[j, : len(s)] = s
        yield {"names": [k for k, _ in chunk], "input_ids": ids}
