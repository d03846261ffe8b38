"""Run-length deduplication of unit sequences.

Counterpart of speech_resynth_tpu/ops/dedup.py, with the same fixed-shape
outputs: a row of T units becomes (units, durations) of length T, zero past
``num_units``. Positions at or past a row's ``length`` are ignored; the last
run's duration is ``length - start``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def deduplicate_batch(units: torch.Tensor, lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run-length encode each row of (B, T) units with valid lengths (B,).

    Returns (deduped (B, T) in units' dtype, durations (B, T) int32,
    num_units (B,) int32)."""
    b, t = units.shape
    dev = units.device
    pos = torch.arange(t, dtype=torch.int32, device=dev)[None, :].expand(b, t)
    valid = pos < torch.as_tensor(lengths, device=dev).to(torch.int32)[:, None]

    prev = torch.cat([torch.full((b, 1), -1, dtype=units.dtype, device=dev), units[:, :-1]], dim=1)
    is_start = (units != prev) & valid  # first frame of each run
    rank = torch.cumsum(is_start.to(torch.int32), dim=1) - 1  # run index per frame
    num_units = is_start.sum(dim=1, dtype=torch.int32)

    # run starts scatter to their rank; every other frame to an overflow slot T
    slot = torch.where(is_start, rank, torch.full_like(rank, t)).long()
    deduped = torch.zeros(b, t + 1, dtype=units.dtype, device=dev)
    deduped.scatter_(1, slot, torch.where(valid, units, torch.zeros_like(units)))
    starts = torch.zeros(b, t + 1, dtype=torch.int32, device=dev)
    starts.scatter_(1, slot, pos.contiguous())
    deduped, starts = deduped[:, :t], starts[:, :t]

    # duration of run r = (start of run r+1) - (start of run r); the last run ends at the length
    total = valid.sum(dim=1, keepdim=True, dtype=torch.int32)
    next_starts = torch.cat([starts[:, 1:], torch.zeros(b, 1, dtype=torch.int32, device=dev)], dim=1)
    run_slot = torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    last_run = (num_units - 1)[:, None]
    durations = torch.where(run_slot == last_run, total - starts, next_starts - starts)
    durations = torch.where(run_slot < num_units[:, None], durations, torch.zeros_like(durations))
    return deduped, durations, num_units


def deduplicate(
    units: torch.Tensor, length: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run-length encode a 1-D unit sequence (T,); ``length`` (<= T) bounds the
    valid prefix. Returns (deduped (T,), durations (T,), num_units scalar)."""
    t = units.shape[0]
    lengths = torch.tensor([t if length is None else int(length)], device=units.device)
    deduped, durations, num = deduplicate_batch(units[None], lengths)
    return deduped[0], durations[0], num[0]
