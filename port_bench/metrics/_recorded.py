"""What the readers of the program's own spans and counters share: the
program's recording of the traced window (``speech_resynth_torch.core.tracing``,
stamped on the trace's clock), clipped to the window. A program without that
recording, or a run without a trace, gives nothing (None), never 0."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from port_bench.yardstick import readers, timeline


def recording():
    """The program's recording of its latest profiler session, or None where the program keeps none."""
    try:
        from speech_resynth_torch.core.tracing import recorded
    except ImportError:
        return None
    return recorded()


def spans(run, *names: str) -> List[Tuple[float, float]]:
    """(start s, end s) of each recorded span named one of ``names`` that overlaps the traced window."""
    rec = recording()
    if rec is None or run.window is None:
        return []
    lo, hi = run.window
    found = [(s.start_ns / 1e9, s.end_ns / 1e9) for s in rec.spans if s.name in names]
    return [(a, b) for a, b in found if b > lo and a < hi]


def mean_ms(run, name: str) -> Optional[float]:
    """Mean host ms of the window's ``name`` spans, one a batch."""
    found = spans(run, name)
    return 1e3 * sum(b - a for a, b in found) / len(found) if found else None


def total(run, name: str) -> Optional[int]:
    """The sum of the window's ``name`` counts, or None where none was counted."""
    rec = recording()
    if rec is None or run.window is None:
        return None
    lo, hi = run.window
    counts = [c.n for c in rec.counts if c.name == name and lo <= c.time_ns / 1e9 <= hi]
    return sum(counts) if counts else None


def pad_share(run, needed: str, computed: str) -> Optional[float]:
    """1 - the ``needed`` count over the ``computed`` count, in %."""
    n, c = total(run, needed), total(run, computed)
    return None if n is None or not c else readers.share(c - n, c)


def overlap(xs: Sequence[Tuple[float, float]], ys: Sequence[Tuple[float, float]]) -> float:
    """The time two sorted lists of disjoint intervals share."""
    out, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        out += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_inside(run, *names: str) -> Optional[float]:
    """Share of the traced window in which no device operation runs while
    the host is inside a span named one of ``names``, in %: the device's idle
    gaps (the complement of the union of its operations) met with the union
    of those spans, each clipped to the window."""
    if run.window is None or not run.ops:
        return None
    inside = spans(run, *names)
    if not inside:
        return None
    idle = timeline.gaps([(a, b) for _, a, b in run.ops], *run.window)
    return readers.share(overlap(idle, timeline.union(timeline.clip(inside, *run.window))), run.window_s)
