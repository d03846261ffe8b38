"""Datasets and batch shaping (counterpart of speech_resynth_tpu/pipeline/data.py)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator

from ..dsp import audio_io


def bucket_length(n: int, multiple: int = 64, minimum: int = 64) -> int:
    """Round a padded dimension up to a bucket boundary, so a variable-length
    request stream produces few distinct batch shapes."""
    return max(minimum, -(-n // multiple) * multiple)


class SpeechDataset:
    """Glob a wav tree (``<wav_dir>/<split>/**/*<ext_audio>``, sorted) and
    iterate padded waveform batches."""

    def __init__(self, wav_dir: str, split: str = "train-*", ext_audio: str = ".wav"):
        self.wav_dir = Path(wav_dir)
        self.wav_paths = sorted(self.wav_dir.glob(f"{split}/**/*{ext_audio}"))

    def __len__(self) -> int:
        return len(self.wav_paths)

    def name_of(self, path: Path) -> str:
        return str(path.relative_to(self.wav_dir).with_suffix(""))

    def batches(self, batch_size: int, max_seconds: float = 30.0, sample_rate: int = 16000) -> Iterator[Dict]:
        """Batches of ``batch_size`` files (the last may be smaller), each read
        into a (n, max_seconds * sample_rate) f32 array; ``wavs_len`` is -1
        for a file that could not be read."""
        max_frames = int(max_seconds * sample_rate)
        for i in range(0, len(self.wav_paths), batch_size):
            chunk = self.wav_paths[i : i + batch_size]
            wavs, lengths, _ = audio_io.read_batch(chunk, max_frames)
            yield {"input_values": wavs, "wavs_len": lengths, "names": [self.name_of(p) for p in chunk]}
