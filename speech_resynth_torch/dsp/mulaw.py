"""mu-law 8-bit companding for the serving wire format (mu = 255).

    F(x)  = sign(x) * log(1 + mu*|x|) / log(1 + mu)        x in [-1, 1]
    code  = round((F(x) + 1) / 2 * mu)                     uint8 in [0, 255]

``mulaw_encode`` runs on the waveform's device, so one byte per sample
crosses to the host; ``mulaw_decode`` is the host-side numpy inverse.
"""

from __future__ import annotations

import numpy as np
import torch

MU = 255.0
_LOG1P_MU = float(np.log1p(MU))


def mulaw_encode(waveform: torch.Tensor) -> torch.Tensor:
    """float waveform in [-1, 1] -> uint8 mu-law codes (on the input's device)."""
    x = waveform.float().clamp(-1.0, 1.0)
    f = torch.sign(x) * torch.log1p(MU * x.abs()) / _LOG1P_MU
    return torch.round((f + 1.0) / 2.0 * MU).to(torch.uint8)


def mulaw_decode(codes: np.ndarray) -> np.ndarray:
    """uint8 mu-law codes -> float32 waveform in [-1, 1] (numpy, host-side)."""
    f = np.asarray(codes, np.float32) * (2.0 / MU) - 1.0
    return np.sign(f) * (np.expm1(np.abs(f) * np.log1p(MU))) / MU
