"""Batch shaping helpers (counterpart of speech_resynth_tpu/pipeline/data.py)."""

from __future__ import annotations


def bucket_length(n: int, multiple: int = 64, minimum: int = 64) -> int:
    """Round a padded dimension up to a bucket boundary, so a variable-length
    request stream produces few distinct batch shapes."""
    return max(minimum, -(-n // multiple) * multiple)
