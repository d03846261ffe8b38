"""Energy-threshold VAD trim (counterpart of speech_resynth_tpu/dsp/vad.py).

As ``librosa.effects.trim(wav, top_db=20)``: frame RMS power in dB against
the loudest frame; leading and trailing frames quieter than -top_db are
cut. ``trim`` is host numpy (the output length depends on the data);
``trim_mask`` is the batched torch form, a keep-mask of static shape.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _frame_rms_db(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    n = 1 + max(len(y) - frame_length, 0) // hop_length
    if len(y) < frame_length:
        n = 1
        y = np.pad(y, (0, frame_length - len(y)))
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
    rms = np.sqrt(np.mean(y[np.minimum(idx, len(y) - 1)] ** 2, axis=1))
    power = np.maximum(rms, 1e-10) ** 2
    return 10.0 * np.log10(power / max(np.max(power), 1e-20))


def trim(y: np.ndarray, top_db: float = 20.0, frame_length: int = 2048, hop_length: int = 512) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Trim leading and trailing silence; returns (trimmed, (start, end))."""
    y = np.asarray(y)
    mono = y if y.ndim == 1 else y.mean(axis=0)
    loud = np.nonzero(_frame_rms_db(mono.astype(np.float64), frame_length, hop_length) > -top_db)[0]
    if len(loud) == 0:
        return y[..., :0], (0, 0)
    start = int(loud[0]) * hop_length
    end = min(int(loud[-1] + 1) * hop_length + frame_length, y.shape[-1])
    return y[..., start:end], (start, end)


def trim_mask(y: torch.Tensor, top_db: float = 20.0, frame_length: int = 2048, hop_length: int = 512) -> torch.Tensor:
    """(B, T) -> (B, T) bool keep-mask; all False for a silent row."""
    B, T = y.shape
    n = 1 + max(T - frame_length, 0) // hop_length
    idx = torch.arange(n, device=y.device)[:, None] * hop_length + torch.arange(frame_length, device=y.device)[None, :]
    power = torch.clamp(torch.mean(y[:, idx.clamp(max=T - 1)] ** 2, dim=-1), min=1e-20)  # (B, n)
    loud = 10.0 * torch.log10(power / power.amax(dim=1, keepdim=True)) > -top_db
    frame_pos = torch.arange(n, device=y.device)
    first = torch.where(loud, frame_pos, n).amin(dim=1)
    last = torch.where(loud, frame_pos, -1).amax(dim=1)
    t = torch.arange(T, device=y.device)[None, :]
    end = torch.clamp((last + 1) * hop_length + frame_length, max=T)
    return (t >= (first * hop_length)[:, None]) & (t < end[:, None]) & (last[:, None] >= 0)
