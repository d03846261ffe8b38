"""Device resolution for the port's entry points.

The card is the default: an entry point runs on ``cuda`` unless the caller
asks for ``"cpu"``. When CUDA is missing and the CPU was not asked for, it
raises instead of carrying on silently on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to run the port's plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!r} (cuda|cpu)")
    return dev

