"""The device's timeline from a profiler trace: busy time as the union of
operation intervals (never a sum of kernel times, which double-counts
overlapping kernels and can read busy above wall), idle gaps named by the
host span that covered them, and device time by operation name."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Sorted, merged intervals covering exactly what the inputs cover."""
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def clip(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def busy(intervals: Sequence[Interval], lo: float, hi: float) -> float:
    """Time in [lo, hi] during which at least one interval is open."""
    return sum(b - a for a, b in union(clip(intervals, lo, hi)))


def gaps(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cursor = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > cursor:
            out.append((cursor, a))
        cursor = max(cursor, b)
    if hi > cursor:
        out.append((cursor, hi))
    return out


def name_gap(gap: Interval, spans: Sequence[Tuple[str, float, float]]) -> str:
    """The host span that covers most of ``gap``; among equal covers the
    innermost (shortest). "none" where no span touches it."""
    best: Optional[Tuple[float, float, str]] = None
    for name, a, b in spans:
        cover = min(b, gap[1]) - max(a, gap[0])
        if cover <= 0:
            continue
        key = (cover, -(b - a), name)
        if best is None or key > best:
            best = key
    return "none" if best is None else best[2]


def idle_gaps(kernels: Sequence[Interval], spans, lo: float, hi: float, top: int = 10) -> List[list]:
    """The ``top`` longest idle gaps as [host span, seconds], longest first."""
    found = sorted(gaps(kernels, lo, hi), key=lambda g: g[1] - g[0], reverse=True)[:top]
    return [[name_gap(g, spans), g[1] - g[0]] for g in found]


def time_by_name(ops: Sequence[Tuple[str, float, float]], lo: float, hi: float) -> Dict[str, float]:
    """Device time inside [lo, hi] summed by operation name."""
    out: Dict[str, float] = {}
    for name, a, b in ops:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out[name] = out.get(name, 0.0) + (b - a)
    return out
