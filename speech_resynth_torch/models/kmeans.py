"""Framewise k-means quantizer (inference).

Counterpart of ``KMeansQuantizer`` in speech_resynth_tpu/models/kmeans.py:
frames (..., D) -> nearest-center ids through ``ops.codebook.assign`` (the K4
kernel on the card). Fitting (``kmeans_fit``) belongs to the trainers and is
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.codebook import Operands, assign, codebook_operands


@dataclasses.dataclass
class KMeansQuantizer:
    """Nearest-center quantizer over (..., D) features; ``centers`` (K, D) f32,
    fixed once the quantizer is built (``to`` builds a new one)."""

    centers: torch.Tensor
    # on the card: the kernel's TF32 codebook halves and half squared norms, made once
    _operands: Optional[Operands] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    def __post_init__(self):
        if self.centers.is_cuda:
            self._operands = codebook_operands(self.centers)

    @property
    def vocab_size(self) -> int:
        return self.centers.shape[0]

    def __call__(self, features: torch.Tensor) -> torch.Tensor:
        return assign(features, self.centers, self._operands)

    def to(self, device) -> "KMeansQuantizer":
        return KMeansQuantizer(self.centers.to(device))

    def embedding_table(self) -> np.ndarray:
        """Frozen unit embedding: a zero pad row, then the centers (unit u is row
        u + 1, padding id 0 the zero row)."""
        c = self.centers.detach().float().cpu().numpy()
        return np.concatenate([np.zeros((1, c.shape[1]), np.float32), c], axis=0)

    @classmethod
    def load(cls, path) -> "KMeansQuantizer":
        """Centers from an ``.npz`` (key ``centers``) or an ``.npy`` file."""
        arr = np.load(path)
        centers = arr["centers"] if hasattr(arr, "files") else arr
        return cls(torch.from_numpy(np.asarray(centers, np.float32)))

    def save(self, path) -> None:
        np.savez(path, centers=self.centers.detach().float().cpu().numpy())
