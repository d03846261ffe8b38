"""Windowed-sinc resampler in polyphase form.

Counterpart of speech_resynth_tpu/dsp/resample.py (any rate -> any rate,
Hann-windowed sinc, lowpass_filter_width 6, rolloff 0.99, output length
ceil(T * L / M) for L / M = new / orig in lowest terms). The JAX package runs
one convolution over the input zero-stuffed by L; here the zeros are never
made, which at 44.1 kHz -> 16 kHz (L = 160, M = 441) would be an input 160
times larger. Output o takes the taps of phase (half_width - o * M) mod L of
the filter, about ceil(K / L) of them, at input start t0(o); outputs
o = c + L * m of one residue class c share the phase and step the start by
M. So every output row m is one product of a length-W window of the input,
taken every M samples (a strided view), with a (W, L) matrix of the L
phases, each shifted to its own start inside the window: memory stays O(T).
The padding matches the JAX convolution's (half_width, half_width + M) in
the zero-stuffed domain.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=16)
def _sinc_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int, rolloff: float) -> np.ndarray:
    """Hann-windowed sinc low-pass at the upsampled rate, (K, 1, 1) f32, with
    gain L for the zeros between upsampled samples."""
    g = math.gcd(orig_freq, new_freq)
    L, M = new_freq // g, orig_freq // g
    cutoff = rolloff * 0.5 / max(L, M)  # of the upsampled Nyquist
    half_width = lowpass_filter_width * max(L, M)
    t = np.arange(-half_width, half_width + 1, dtype=np.float64)
    kernel = 2 * cutoff * np.sinc(2 * cutoff * t) * np.hanning(2 * half_width + 1) * L
    return kernel.astype(np.float32).reshape(-1, 1, 1)


@lru_cache(maxsize=16)
def _polyphase(orig_freq: int, new_freq: int, lowpass_filter_width: int, rolloff: float):
    """The (W, L) phase matrix and the offset of window 0's first input
    sample: H[t0(c) - t0_min + j, c] = kernel[k0(c) + j * L], with
    k0(c) = (half_width - c * M) mod L and t0(c) = (c * M - half_width + k0(c)) / L."""
    g = math.gcd(orig_freq, new_freq)
    L, M = new_freq // g, orig_freq // g
    kernel = _sinc_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)[:, 0, 0]
    half_width = (kernel.shape[0] - 1) // 2
    k0 = [(half_width - c * M) % L for c in range(L)]
    t0 = [(c * M - half_width + k0[c]) // L for c in range(L)]
    taps = [kernel[k0[c] :: L] for c in range(L)]
    t0_min = min(t0)
    width = max(t0[c] - t0_min + len(taps[c]) for c in range(L))
    H = np.zeros((width, L), np.float32)
    for c in range(L):
        H[t0[c] - t0_min : t0[c] - t0_min + len(taps[c]), c] = taps[c]
    return H, t0_min


def resample(
    waveform: torch.Tensor, orig_freq: int, new_freq: int, lowpass_filter_width: int = 6, rolloff: float = 0.99
) -> torch.Tensor:
    """(..., T) -> (..., ceil(T * new_freq / orig_freq)) f32, on the input's device."""
    x = torch.as_tensor(waveform).float()
    if orig_freq == new_freq:
        return x
    g = math.gcd(orig_freq, new_freq)
    L, M = new_freq // g, orig_freq // g
    H, t0_min = _polyphase(orig_freq, new_freq, lowpass_filter_width, rolloff)
    width = H.shape[0]
    lead, T = x.shape[:-1], x.shape[-1]
    out_len = -(-T * L // M)
    rows = -(-out_len // L)  # output rows m, each the L outputs c + L * m
    # window m starts at input sample t0_min + m * M; zeros outside [0, T)
    pad_left = max(0, -t0_min)
    pad_right = max(0, t0_min + (rows - 1) * M + width - T)
    xp = F.pad(x.reshape(-1, T), (pad_left, pad_right))[:, t0_min + pad_left :]
    windows = xp.unfold(-1, width, M)[:, :rows]  # (N, rows, W), a strided view
    y = windows @ torch.from_numpy(H).to(x.device)  # (N, rows, L)
    return y.reshape(-1, rows * L)[:, :out_len].reshape(*lead, out_len)
