"""k-means: Lloyd's fit and the framewise quantizer.

Counterpart of speech_resynth_tpu/models/kmeans.py. ``KMeansQuantizer`` maps
frames (..., D) to nearest-center ids through ``ops.codebook.assign`` (the
K4 kernel on the card). ``kmeans_fit`` seeds with k-means++ from a
``torch.Generator`` and runs Lloyd's iterations (``lloyd``), assigning with
the plain version ``assign_reference`` as the JAX package's fit does (the
lower id wins ties); a center that loses all its frames stays where it was.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.codebook import Operands, assign, assign_reference, codebook_operands


def _plusplus_init(generator: torch.Generator, data: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding: the first center uniformly, each next one drawn with
    probability proportional to its squared distance from the nearest center
    so far (sklearn's strategy; the draws differ from the JAX package's).
    ``generator`` lives on ``data``'s device."""
    n = data.shape[0]
    centers = torch.empty((k, data.shape[1]), dtype=data.dtype, device=data.device)
    centers[0] = data[torch.randint(n, (1,), generator=generator, device=data.device)[0]]
    d2 = torch.sum((data - centers[0]) ** 2, dim=-1)
    for i in range(1, k):
        total = d2.sum()
        # every frame on a center already: draw uniformly, as a zero distribution cannot be sampled
        probs = torch.where(total > 0, d2 / total.clamp(min=1e-12), torch.full_like(d2, 1.0 / n))
        centers[i] = data[torch.multinomial(probs, 1, generator=generator)[0]]
        d2 = torch.minimum(d2, torch.sum((data - centers[i]) ** 2, dim=-1))
    return centers


def lloyd(data: torch.Tensor, centers: torch.Tensor, iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` Lloyd steps from ``centers``: assign, then move each center
    to the mean of its frames (a center without frames stays). Returns the
    centers and the inertia, the f32 sum of squared distances of every frame
    to its center."""
    data = data.float()
    k = centers.shape[0]
    for _ in range(iters):
        ids = assign_reference(data, centers).long()
        sums = torch.zeros_like(centers).index_add_(0, ids, data)
        counts = torch.bincount(ids, minlength=k).to(data.dtype)[:, None]
        centers = torch.where(counts > 0, sums / counts.clamp(min=1), centers)
    ids = assign_reference(data, centers).long()
    return centers, torch.sum((data - centers[ids]) ** 2)


def kmeans_fit(
    data: torch.Tensor, k: int, iters: int = 50, init: str = "k-means++", generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm on (N, D) frames; returns (centers (k, D), inertia).
    ``init``: "k-means++", or k distinct frames drawn uniformly. The
    ``generator`` (on ``data``'s device; seed 0 when omitted) drives both."""
    data = data.float()
    if generator is None:
        generator = torch.Generator(device=data.device).manual_seed(0)
    if init == "k-means++":
        centers = _plusplus_init(generator, data, k)
    else:
        centers = data[torch.randperm(data.shape[0], generator=generator, device=data.device)[:k]]
    return lloyd(data, centers, iters)


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
