"""Datasets and batch shaping (counterpart of speech_resynth_tpu/pipeline/data.py).

The training datasets (``UnitDataset`` for CFM, ``MelDataset`` for HiFi-GAN,
``UnitTextDataset`` for the speech LM) are copies of the JAX package's: the
same shuffles and crops from numpy's ``default_rng((seed, epoch))`` and
``default_rng((seed, epoch, process_index))``, so their batches are
byte-equal to the JAX package's.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..dsp import audio_io
from ..dsp.mel import MEL_PAD_VALUE


def _global_batch_plan(
    n: int,
    batch_size: int,
    shuffle: bool,
    seed: int,
    epoch: int,
    drop_last: bool,
    process_index: int,
    process_count: int,
):
    """Partition a globally-shuffled order into global batches and yield
    (global_indices, local_indices) per step.

    ``batch_size`` is the GLOBAL batch: every host walks the same global
    batches (same count, same shuffle) and materializes only its contiguous
    ``batch_size/process_count`` slice — the multi-host equivalent of
    DistributedSampler (speechlm/train.py:96) that keeps steps_per_epoch =
    len(dataset)//batch_size consistent on every host and in the LR
    schedule.  Pad dims must be derived from the *global* indices so the
    per-process shards of one global batch agree in shape.
    """
    if batch_size % process_count:
        raise ValueError(f"global batch {batch_size} not divisible by {process_count} processes")
    rng = np.random.default_rng((seed, epoch))
    order = np.arange(n)
    if shuffle:
        rng.shuffle(order)
    per = batch_size // process_count
    n_batches = n // batch_size if drop_last else -(-n // batch_size)
    for b in range(n_batches):
        gidx = order[b * batch_size : (b + 1) * batch_size]
        if len(gidx) == batch_size:
            lidx = gidx[process_index * per : (process_index + 1) * per]
        else:  # ragged tail (drop_last=False): stride so every host gets work
            lidx = gidx[process_index::process_count]
        yield gidx, lidx


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


# ---------------------------------------------------------------------------
# resynthesis unit dataset
# ---------------------------------------------------------------------------


class UnitDataset:
    """Unit JSON + cached mel features for CFM training/eval.

    Parity: flow_matching/data.py:110-216 — JSON schema
    {name: {units, durations, transcript}}; ids shifted +1 (0 = pad); random
    ``frames_per_seg`` crop; mel pad -100; features live as .npy files under
    ``spectrogram_dir`` (the torch reference uses .pt).
    """

    def __init__(
        self,
        file: str,
        wav_dir: Optional[str] = None,
        spectrogram_dir: Optional[str] = None,
        frames_per_seg: Optional[int] = None,
        ext_audio: str = ".wav",
    ):
        with open(file) as f:
            dataset = json.load(f)
        self.names: List[str] = list(dataset.keys())
        self.units = [np.asarray(v["units"], np.int32) + 1 for v in dataset.values()]
        self.durations = [np.asarray(v["durations"], np.int32) for v in dataset.values()]
        self.transcripts = [v.get("transcript", "") for v in dataset.values()]
        self.wav_dir = Path(wav_dir) if wav_dir else None
        self.spectrogram_dir = Path(spectrogram_dir) if spectrogram_dir else None
        self.frames_per_seg = frames_per_seg
        self.ext_audio = ext_audio

    def __len__(self) -> int:
        return len(self.names)

    def _load_mel(self, idx: int) -> np.ndarray:
        if self.spectrogram_dir is None:
            return np.zeros((1, 80), np.float32)
        path = self.spectrogram_dir / (self.names[idx] + ".npy")
        return np.load(path).astype(np.float32).reshape(-1, 80)

    def _example(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        ids = self.units[idx]
        durs = self.durations[idx]
        mel = self._load_mel(idx)
        if self.frames_per_seg is not None:
            fps = self.frames_per_seg
            diff = len(ids) - fps
            if diff > 0:
                start = int(rng.integers(diff))
                ids = ids[start : start + fps]
                durs = durs[start : start + fps]
                mel = mel[start : start + fps]
            else:
                ids = np.pad(ids, (0, -diff))
                durs = np.pad(durs, (0, -diff))
                mel = np.pad(mel, ((0, fps - len(mel)), (0, 0)), constant_values=-100.0)
        return {"input_ids": ids, "duration_labels": durs, "spectrogram_labels": mel}

    def _mel_len(self, idx: int) -> int:
        """Frame count without materializing the mel (for cross-host pad
        dims): sum(durations) in dedup/duration mode, else the cached file's
        shape via mmap."""
        if self.durations[idx].size:
            return int(self.durations[idx].sum())
        if self.spectrogram_dir is None:
            return 1
        path = self.spectrogram_dir / (self.names[idx] + ".npy")
        return int(np.load(path, mmap_mode="r").size) // 80

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        epoch: int = 0,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
    ) -> Iterator[Dict]:
        """Padded-collated batches (pad ids/durs 0, mel -100).

        ``batch_size`` is the GLOBAL batch; this host materializes its
        1/process_count slice of every global batch (_global_batch_plan)."""
        rng = np.random.default_rng((seed, epoch, process_index))
        for gidx, idxs in _global_batch_plan(
            len(self.names), batch_size, shuffle, seed, epoch, drop_last, process_index, process_count
        ):
            examples = [self._example(i, rng) for i in idxs]
            if self.frames_per_seg is not None:
                # crops collapse every example to exactly frames_per_seg —
                # static dims keep every process's shard of one global batch in
                # agreement (a process-local max would desync on any mismatch)
                L = N = self.frames_per_seg
            else:
                # variable-length mode: pad dims from GLOBAL metadata (so all
                # hosts agree), bucketed to bound recompiles
                L = bucket_length(max(len(self.units[i]) for i in gidx))
                N = bucket_length(max(self._mel_len(i) for i in gidx))
            B = len(examples)
            ids = np.zeros((B, L), np.int32)
            durs = np.zeros((B, L), np.int32)
            mel = np.full((B, N, 80), -100.0, np.float32)
            for j, e in enumerate(examples):
                ids[j, : len(e["input_ids"])] = e["input_ids"]
                durs[j, : len(e["duration_labels"])] = e["duration_labels"]
                mel[j, : e["spectrogram_labels"].shape[0]] = e["spectrogram_labels"]
            yield {
                "input_ids": ids,
                "duration_labels": durs,
                "spectrogram_labels": mel,
                "names": [self.names[i] for i in idxs],
                "transcripts": [self.transcripts[i] for i in idxs],
            }

    def wav_batch(self, names: Sequence[str], max_seconds: float = 30.0) -> Tuple[np.ndarray, np.ndarray]:
        """Load reference waveforms for eval (data.py:144-150 capability)."""
        assert self.wav_dir is not None
        paths = [self.wav_dir / (n + self.ext_audio) for n in names]
        wavs, lengths, _ = audio_io.read_batch(paths, int(max_seconds * 16000))
        return wavs, lengths


# ---------------------------------------------------------------------------
# HiFi-GAN mel/wav cropping dataset
# ---------------------------------------------------------------------------


class MelDataset:
    """Aligned random (mel, wav) crops for GAN training
    (hifigan/data.py:56-115 semantics; time-major mel)."""

    def __init__(
        self,
        input_wavs_dir: str,
        input_mels_dir: str,
        training_files: str,
        segment_size: int = 16080,
        n_fft: int = 400,
        hop_size: int = 320,
        split: bool = True,
        ext_audio: str = ".wav",
    ):
        self.wav_dir = Path(input_wavs_dir)
        self.mel_dir = Path(input_mels_dir)
        self.segment_size = segment_size
        self.n_fft = n_fft
        self.hop_size = hop_size
        self.split = split
        self.frames_per_seg = (segment_size - n_fft) // hop_size + 1
        self.names: List[str] = []
        with open(training_files) as f:
            for line in f:
                name = line.split("\t")[0].strip()
                if name:
                    self.names.append(name)
        self.ext_audio = ext_audio

    def __len__(self) -> int:
        return len(self.names)

    def _example(self, name: str, rng: np.random.Generator):
        wav, _ = audio_io.read(self.wav_dir / (name + self.ext_audio))
        if wav.ndim > 1:
            wav = wav[:, 0]
        peak = np.abs(wav).max()
        wav = wav / max(peak, 1e-9) * 0.95
        mel = np.load(self.mel_dir / (name + ".npy")).astype(np.float32).reshape(-1, 80)

        if self.split:
            diff = mel.shape[0] - self.frames_per_seg
            if diff > 0:
                start = int(rng.integers(diff))
                mel_seg = mel[start : start + self.frames_per_seg]
                wav_seg = wav[start * self.hop_size : start * self.hop_size + self.segment_size]
                mask = np.ones(self.frames_per_seg, bool)
            else:
                mel_seg = np.pad(mel, ((0, -diff), (0, 0)), constant_values=MEL_PAD_VALUE)
                wav_seg = np.pad(wav, (0, self.segment_size - len(wav)))
                mask = np.pad(np.ones(mel.shape[0], bool), (0, -diff))
            if len(wav_seg) < self.segment_size:
                wav_seg = np.pad(wav_seg, (0, self.segment_size - len(wav_seg)))
            return mel_seg, wav_seg.astype(np.float32), mask
        return mel, wav.astype(np.float32), np.ones(mel.shape[0], bool)

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        epoch: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        drop_last: bool = True,
    ) -> Iterator[Dict]:
        """``batch_size`` is the GLOBAL batch (see _global_batch_plan); crop
        shapes are static (frames_per_seg/segment_size) so per-host collation
        needs no cross-host metadata.  ``drop_last=False`` (validation) keeps
        the ragged tail and small dev sets instead of silently yielding
        nothing."""
        rng = np.random.default_rng((seed, epoch, process_index))
        for _, idxs in _global_batch_plan(
            len(self.names), batch_size, shuffle, seed, epoch, drop_last, process_index, process_count
        ):
            if len(idxs) == 0:
                continue
            mels, wavs, masks = zip(*(self._example(self.names[i], rng) for i in idxs))
            yield {
                "mel": np.stack(mels),
                "wav": np.stack(wavs),
                "mel_mask": np.stack(masks),
                "names": [self.names[i] for i in idxs],
            }

    def padded_batches(
        self, batch_size: int, multiple: int = 128, max_utts: Optional[int] = None, with_wav: bool = True
    ) -> Iterator[Dict]:
        """Full-length validation batches (requires ``split=False``).

        The reference validates FULL utterances, not training-style crops
        (hifigan/train.py:225-252, split=False) — cropped validation mel-L1
        is not comparable with reference-produced curves.  Utterances are
        bucketed by mel length padded to a multiple of ``multiple`` frames so
        each (batch, length) shape compiles once; mel pads with
        MEL_PAD_VALUE, wav with zeros, ``mel_mask`` marks real frames.  Wav
        is trimmed/padded to (L_pad-1)*hop + n_fft so the generator-output
        invariant (its mel has exactly L_pad frames) holds; callers that only
        need the mels (mel-L1 validation) pass ``with_wav=False`` to skip
        audio decoding entirely.

        Bucketing reads only the mel-file headers (mmap) up front; each
        bucket group is loaded lazily as it is yielded, so a large dev set is
        never resident in memory at once."""
        assert not self.split, "padded_batches needs a split=False (full-length) dataset"
        rng = np.random.default_rng(0)
        names = self.names if max_utts is None else self.names[: int(max_utts)]
        frames = [np.load(self.mel_dir / (n + ".npy"), mmap_mode="r").size // 80 for n in names]

        def bucket(n: int) -> int:
            return max(multiple, -(-n // multiple) * multiple)

        order = sorted(range(len(names)), key=lambda i: frames[i])
        i = 0
        while i < len(order):
            L_pad = bucket(frames[order[i]])
            group = []
            while i < len(order) and len(group) < batch_size and bucket(frames[order[i]]) == L_pad:
                group.append(order[i])
                i += 1
            wav_len = (L_pad - 1) * self.hop_size + self.n_fft
            mel = np.full((len(group), L_pad, 80), MEL_PAD_VALUE, np.float32)
            wav = np.zeros((len(group), wav_len), np.float32) if with_wav else None
            mask = np.zeros((len(group), L_pad), bool)
            for j, idx in enumerate(group):
                if with_wav:
                    m, w, _ = self._example(names[idx], rng)
                    w = w[:wav_len]
                    wav[j, : len(w)] = w
                else:
                    m = np.load(self.mel_dir / (names[idx] + ".npy")).astype(np.float32).reshape(-1, 80)
                mel[j, : m.shape[0]] = m
                mask[j, : m.shape[0]] = True
            batch = {
                "mel": mel,
                "mel_mask": mask,
                "names": [names[idx] for idx in group],
            }
            if with_wav:
                batch["wav"] = wav
            yield batch


# ---------------------------------------------------------------------------
# speech LM token dataset
# ---------------------------------------------------------------------------


class UnitTextDataset:
    """Lines of BPE ids for LM training: each id shifted by
    ``num_special_tokens``, EOS appended, a random crop of
    ``units_per_sample`` tokens (shorter lines right-padded with id 0); the
    attention mask is ``ids != 0`` and the labels are -100 at pads."""

    def __init__(self, path: str, units_per_sample: int = 128, num_special_tokens: int = 2, eos_token_id: int = 1):
        self.sequences: List[np.ndarray] = []
        with open(path) as f:
            for line in f:
                toks = line.split()
                if toks:
                    self.sequences.append(np.asarray([int(t) + num_special_tokens for t in toks] + [eos_token_id], np.int32))
        self.units_per_sample = units_per_sample

    def __len__(self) -> int:
        return len(self.sequences)

    def _example(self, idx: int, rng: np.random.Generator) -> np.ndarray:
        seq = self.sequences[idx]
        n = self.units_per_sample
        diff = len(seq) - n
        if diff > 0:
            start = int(rng.integers(diff))
            return seq[start : start + n]
        return np.pad(seq, (0, -diff))

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        epoch: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ) -> Iterator[Dict]:
        """``batch_size`` is the global batch (see ``_global_batch_plan``);
        the crops draw from ``default_rng((seed, epoch, process_index))``."""
        rng = np.random.default_rng((seed, epoch, process_index))
        for _, idxs in _global_batch_plan(len(self.sequences), batch_size, shuffle, seed, epoch, True, process_index, process_count):
            ids = np.stack([self._example(i, rng) for i in idxs])
            yield {
                "input_ids": ids,
                "attention_mask": (ids != 0).astype(np.int32),
                "labels": np.where(ids == 0, -100, ids).astype(np.int32),
            }
