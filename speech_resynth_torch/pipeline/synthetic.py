"""Synthetic multi-speaker formant corpus for end-to-end quality runs.

Counterpart of speech_resynth_tpu/pipeline/synthetic.py: the same corpora
from the same seeds, written through the port's ``dsp.audio_io`` with the
mels of the port's ``dsp.mel.log_mel_spectrogram`` (on the CPU). The
quality run needs no downloaded corpus: this is a controlled stand-in with
the file layout the pipeline consumes (wav tree + unit JSON + mel .npy
cache + filelist):

* K discrete "phoneme" units, each a fixed pair of formant sinusoids;
* multiple "speakers" = global F0/formant scale factors;
* each utterance: a random unit sequence, one unit per ``frames_per_unit``
  mel frames, phase-continuous synthesis at 16 kHz, hop 320;
* wav length = (T-1)*320+400 so the mel has exactly T frames (the HiFi-GAN
  length invariant the tests depend on).

Because the unit→spectrum mapping is deterministic per (unit, speaker), a
correctly-learning CFM + vocoder stack must reconstruct the audio up to
phase; mel-space distances measure exactly that. ``make_unit_grammar_corpus``
writes a token corpus with word structure and minimal pairs for the speech
LM (an sWUGGY analog).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..dsp import audio_io
from ..dsp.mel import log_mel_spectrogram

SR = 16000
HOP = 320
N_FFT = 400


def _unit_formants(n_units: int) -> np.ndarray:
    """(n_units, 2) formant frequencies in Hz, spread over the mel band.

    Deterministic in ``n_units`` alone so train/eval corpora generated with
    different utterance seeds share the same unit→spectrum mapping."""
    rng = np.random.default_rng(1234)
    f1 = np.linspace(300.0, 1100.0, n_units)
    f2 = np.linspace(1500.0, 3500.0, n_units)
    rng.shuffle(f2)
    return np.stack([f1, f2], axis=1)


def synth_utterance(
    units: np.ndarray,
    formants: np.ndarray,
    speaker_scale: float,
    frames_per_unit: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Phase-continuous formant synthesis; returns ((T-1)*HOP+N_FFT,) f32."""
    frame_units = np.repeat(units, frames_per_unit)
    T = len(frame_units)
    n_samples = (T - 1) * HOP + N_FFT
    wav = np.zeros(n_samples, np.float64)
    phase = np.zeros(2)
    amp = np.array([0.45, 0.3])
    pos = 0
    for i, u in enumerate(frame_units):
        seg_len = HOP if i < T - 1 else (n_samples - pos)
        freqs = formants[u] * speaker_scale
        tt = np.arange(seg_len) / SR
        for j in range(2):
            wav[pos : pos + seg_len] += amp[j] * np.sin(2 * np.pi * freqs[j] * tt + phase[j])
            phase[j] = (phase[j] + 2 * np.pi * freqs[j] * seg_len / SR) % (2 * np.pi)
        pos += seg_len
    # gentle utterance-level envelope + tiny noise floor for D robustness
    env = 0.7 + 0.25 * np.sin(np.linspace(0, np.pi, n_samples))
    wav = wav * env / np.max(np.abs(wav) * env + 1e-9) * 0.8
    wav += rng.standard_normal(n_samples) * 1e-4
    return wav.astype(np.float32)


def make_formant_corpus(
    out_dir: str | Path,
    n_utts: int = 48,
    n_units: int = 8,
    n_speakers: int = 3,
    units_per_utt: Tuple[int, int] = (6, 12),
    frames_per_unit: int = 4,
    seed: int = 0,
) -> Dict[str, Path]:
    """Write wavs + unit JSON + mel cache + filelist; return the paths.

    Unit ids in the JSON are 0-based (the UnitDataset shifts +1, pad=0),
    durations are per-frame 1s (non-dedup resynthesis mode).
    """
    out_dir = Path(out_dir)
    wav_dir = out_dir / "wavs"
    spec_dir = out_dir / "spec"
    rng = np.random.default_rng(seed)
    formants = _unit_formants(n_units)
    speaker_scales = 1.0 + 0.12 * np.arange(n_speakers) - 0.12

    dataset = {}
    names: List[str] = []
    for i in range(n_utts):
        n_u = int(rng.integers(units_per_utt[0], units_per_utt[1] + 1))
        units = rng.integers(0, n_units, n_u)
        spk = i % n_speakers
        wav = synth_utterance(units, formants, float(speaker_scales[spk]), frames_per_unit, rng)
        name = f"train/s{spk}/u{i:04d}"
        path = wav_dir / (name + ".wav")
        path.parent.mkdir(parents=True, exist_ok=True)
        audio_io.write(path, wav, SR)

        mel = log_mel_spectrogram(torch.from_numpy(wav[None]), n_fft=N_FFT, hop_size=HOP)[0].numpy()
        frame_units = np.repeat(units, frames_per_unit)
        assert mel.shape[0] == len(frame_units), (mel.shape, len(frame_units))
        spec_path = spec_dir / (name + ".npy")
        spec_path.parent.mkdir(parents=True, exist_ok=True)
        np.save(spec_path, mel.astype(np.float32))

        dataset[name] = {
            "units": frame_units.tolist(),
            "durations": [1] * len(frame_units),
            "transcript": " ".join(map(str, units.tolist())),
        }
        names.append(name)

    train_file = out_dir / "train.json"
    train_file.write_text(json.dumps(dataset))
    filelist = out_dir / "train.filelist"
    filelist.write_text("\n".join(names) + "\n")
    return {
        "wav_dir": wav_dir,
        "spec_dir": spec_dir,
        "train_file": train_file,
        "filelist": filelist,
        "formants": formants,
    }


# ---------------------------------------------------------------------------
# unit-grammar corpus for speech-LM quality (native sLM21 analog)
# ---------------------------------------------------------------------------


def make_unit_grammar_corpus(
    out_dir: str | Path,
    n_sentences: int = 2000,
    n_units: int = 10,
    lexicon_size: int = 12,
    word_len: int = 3,
    words_per_sentence: int = 4,
    seed: int = 0,
) -> Dict[str, Path]:
    """Token corpus with word structure + minimal pairs (sWUGGY analog).

    'Words' are fixed unit trigrams from a lexicon; sentences concatenate
    random words.  Minimal pairs corrupt one word by swapping a token to one
    that never occurs in that lexicon position — a trained LM must assign the
    real variant higher pseudo-log-prob (the sLM21 scoring of ``write_scores``).
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    lexicon = [rng.integers(0, n_units, word_len).tolist() for _ in range(lexicon_size)]

    train_file = out_dir / "lm_train.txt"
    with open(train_file, "w") as f:
        for _ in range(n_sentences):
            words = [lexicon[int(rng.integers(lexicon_size))] for _ in range(words_per_sentence)]
            toks = [t for w in words for t in w]
            f.write(" ".join(map(str, toks)) + "\n")

    pairs = {}
    for i in range(200):
        words = [lexicon[int(rng.integers(lexicon_size))] for _ in range(words_per_sentence)]
        toks = [t for w in words for t in w]
        bad = list(toks)
        # corrupt the middle token of a random word with a unit that breaks it
        w = int(rng.integers(words_per_sentence))
        pos = w * word_len + 1
        choices = [u for u in range(n_units) if all(lex[1] != u for lex in lexicon)]
        if not choices:
            choices = [u for u in range(n_units) if u != bad[pos]]
        bad[pos] = int(rng.choice(choices))
        pairs[f"real_{i:04d}"] = toks
        pairs[f"fake_{i:04d}"] = bad
    pairs_file = out_dir / "lm_pairs.json"
    pairs_file.write_text(json.dumps(pairs))
    return {"train_file": train_file, "pairs_file": pairs_file}
