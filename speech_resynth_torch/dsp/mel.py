"""Log-mel spectrogram front end (counterpart of speech_resynth_tpu/dsp/mel.py).

The HiFi-GAN mel: an STFT with n_fft 400, hop 320, a periodic Hann window,
no centering, one-sided magnitude, times a Slaney-scale, Slaney-normalized
filterbank (16 kHz, 80 mels, 0-8 kHz), then log with a 1e-5 floor. The STFT
is the JAX package's formulation, a matmul of the (frames, 400) windows by a
window-folded real-DFT basis (400, 201) for each of cos and sin; the
filterbank and bases are numpy constants built once. A waveform shorter than
400 samples gives 0 frames. ``whisper_log_mel`` is Whisper's front end on
the same STFT.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

MEL_PAD_VALUE = float(np.log(1e-5))  # log-compression of silence; the pad-frame sentinel


def dynamic_range_compression(x: torch.Tensor, C: float = 1.0, clip_val: float = 1e-5) -> torch.Tensor:
    """log(clip(x, clip_val) * C)."""
    return torch.log(torch.clamp(x, min=clip_val) * C)


def hz_to_mel_slaney(f) -> np.ndarray:
    """Slaney mel scale (librosa's default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep, f / f_sp)


def mel_to_hz_slaney(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (np.maximum(m, min_log_mel) - min_log_mel)), m * f_sp)


@lru_cache(maxsize=8)
def mel_filterbank(sr: int = 16000, n_fft: int = 400, n_mels: int = 80, fmin: float = 0.0, fmax: float = 8000.0) -> np.ndarray:
    """Slaney-normalized triangular filterbank, (n_mels, n_fft // 2 + 1) f32,
    as ``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)`` gives it."""
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1, dtype=np.float64)
    hz_pts = mel_to_hz_slaney(np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    fb = np.maximum(0.0, np.minimum(lower, upper))
    fb *= (2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])).reshape(-1, 1)  # Slaney: area ~ 2 / bandwidth
    return fb.astype(np.float32)


@lru_cache(maxsize=8)
def _stft_basis(n_fft: int):
    """Window-folded real-DFT bases (cos, -sin), each (n_fft, n_fft // 2 + 1) f32."""
    n = np.arange(n_fft, dtype=np.float64).reshape(-1, 1)
    k = np.arange(n_fft // 2 + 1, dtype=np.float64).reshape(1, -1)
    ang = 2.0 * np.pi * n * k / n_fft
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)  # periodic Hann
    return (np.cos(ang) * window.reshape(-1, 1)).astype(np.float32), (-np.sin(ang) * window.reshape(-1, 1)).astype(np.float32)


def frame_signal(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., 1 + (T - n_fft) // hop, n_fft) windows, without
    centering; no frame when T < n_fft."""
    if y.shape[-1] < n_fft:
        return y.new_zeros((*y.shape[:-1], 0, n_fft))
    return y.unfold(-1, n_fft, hop)


def stft_magnitude(y: torch.Tensor, n_fft: int = 400, hop: int = 320) -> torch.Tensor:
    """(..., T) -> (..., frames, n_fft // 2 + 1) one-sided magnitude."""
    frames = frame_signal(y.float(), n_fft, hop)
    cos_b, sin_b = (torch.from_numpy(b).to(y.device) for b in _stft_basis(n_fft))
    re, im = frames @ cos_b, frames @ sin_b
    return torch.sqrt(re * re + im * im + 1e-24)


def log_mel_spectrogram(
    y: torch.Tensor,
    n_fft: int = 400,
    num_mels: int = 80,
    sampling_rate: int = 16000,
    hop_size: int = 320,
    fmin: float = 0.0,
    fmax: float = 8000.0,
) -> torch.Tensor:
    """(..., T) waveform -> (..., frames, num_mels) log-mel, time-major."""
    fb = torch.from_numpy(mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax)).to(y.device)
    return dynamic_range_compression(stft_magnitude(y, n_fft, hop_size) @ fb.T)


def whisper_log_mel(
    y: torch.Tensor, num_mels: int = 128, n_fft: int = 400, hop_size: int = 160, sampling_rate: int = 16000
) -> torch.Tensor:
    """Whisper's log-mel: (..., T) -> (..., frames, num_mels). Reflect
    padding of n_fft // 2 on both sides, the power spectrum without its last
    frame, Slaney filters up to Nyquist, log10 floored at 1e-10 and at
    (max - 8) per input, then (x + 4) / 4."""
    pad = n_fft // 2
    lead = y.shape[:-1]
    y = F.pad(y.float().reshape(-1, 1, y.shape[-1]), (pad, pad), mode="reflect").reshape(*lead, -1)
    mag = stft_magnitude(y, n_fft, hop_size)
    fb = torch.from_numpy(mel_filterbank(sampling_rate, n_fft, num_mels, 0.0, sampling_rate / 2)).to(y.device)
    log_spec = torch.log10(torch.clamp((mag * mag)[..., :-1, :] @ fb.T, min=1e-10))
    peak = log_spec.amax(dim=(-2, -1), keepdim=True)
    return (torch.maximum(log_spec, peak - 8.0) + 4.0) / 4.0


def mel_spectrogram(y: torch.Tensor, **kwargs) -> torch.Tensor:
    """The reference's layout, (..., T) -> (..., num_mels, frames)."""
    return log_mel_spectrogram(y, **kwargs).transpose(-1, -2)
