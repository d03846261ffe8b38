"""Mixed-precision policy (counterpart of speech_resynth_tpu/core/precision.py).

Every model takes a ``Policy``: parameters are stored in ``param_dtype``,
activations are computed in ``compute_dtype`` and results leave in
``output_dtype``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32


# f32 master params, bf16 compute (training default).
DEFAULT = Policy()

# Full f32: the numerics tests against the JAX package.
FLOAT32 = Policy(compute_dtype=torch.float32)

# Pure bf16 inference: weights cast once, output f32 (the card's serving policy).
BF16_INFERENCE = Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, output_dtype=torch.float32)
