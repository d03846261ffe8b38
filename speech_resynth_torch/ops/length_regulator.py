"""Duration-based length regulation (FastSpeech-style repeat).

Counterpart of speech_resynth_tpu/ops/length_regulator.py: output frame t
takes the first token whose cumulative duration exceeds t (a searchsorted
gather over the cumulative durations); frames past a row's total duration are
zero and masked out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def regulate_length(hidden_states: torch.Tensor, durations: torch.Tensor, out_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand (B, L, D) by integer durations (B, L) to (B, out_len, D).

    Returns (expanded, frame_mask (B, out_len)), the mask marking frames inside
    each row's total duration. ``out_len`` should be at least the largest total,
    or the rows are cut."""
    ends = torch.cumsum(durations.long(), dim=-1)  # (B, L)
    total = ends[:, -1:]
    t = torch.arange(out_len, dtype=torch.long, device=ends.device)[None, :].expand(ends.shape[0], out_len)
    src = torch.searchsorted(ends, t.contiguous(), right=True)  # first end > t
    src = src.clamp(max=hidden_states.shape[1] - 1)
    expanded = torch.gather(hidden_states, 1, src[..., None].expand(-1, -1, hidden_states.shape[-1]))
    mask = t < total
    return expanded.masked_fill(~mask[..., None], 0), mask


def regulated_lengths(durations: torch.Tensor, token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Total expanded length per row, (B,) int32."""
    durations = durations.to(torch.int32)
    if token_mask is not None:
        durations = durations.masked_fill(~token_mask, 0)
    return durations.sum(dim=-1, dtype=torch.int32)
