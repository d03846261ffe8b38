"""Spans and counters of the port's own paths, recorded only while a
``torch.profiler`` session records.

* ``trace_span(name, **attrs)``: a context manager around one piece of host
  work. It is a ``record_function`` range, so an operator's own profiler
  trace shows it, and it is recorded here with its start and end in
  ``time.time_ns()`` (the clock of the profiler's events, host and device
  alike), its thread, the enclosing span on that thread and a few small
  attributes (a batch index, request ids).
* ``begin_span`` / ``end_span``: a span whose two ends are stamped apart,
  possibly on different threads (the server's batch in flight opens on the
  thread that queued it and closes on the thread that copied it back).
* ``trace_count(name, n)``: a named count, stamped with the time it was
  added.
* ``recorded()``: what the latest profiler session recorded so far, in
  memory: its spans and counts, and how many were dropped past the cap.

With no profiler session, each call checks one flag and records nothing. A
session is seen to start when a call finds the profiler on after a call or a
read-out found it off; the recording then starts afresh. It holds at most
``cap`` spans and counts together, and counts the ones it drops beyond that.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled  # true while a torch.profiler (or autograd.profiler) session records


@dataclasses.dataclass(frozen=True)
class Span:
    """One span: ``start_ns`` and ``end_ns`` on ``time.time_ns()``'s clock;
    ``parent`` the ``id`` of the span that enclosed it on ``thread`` (None
    at the top); ``end_thread`` the thread that closed it. ``begin_span``
    returns one not yet ended (``end_ns`` None)."""

    id: int
    name: str
    start_ns: int
    parent: Optional[int]
    thread: int
    attrs: Dict[str, object]
    end_ns: Optional[int] = None
    end_thread: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Count:
    name: str
    time_ns: int
    n: int


@dataclasses.dataclass(frozen=True)
class Recording:
    spans: List[Span]
    counts: List[Count]
    dropped: int

    def total(self, name: str) -> int:
        return sum(c.n for c in self.counts if c.name == name)


class Recorder:
    """The spans and counts of one process's profiler sessions, safe to add
    to from several threads."""

    def __init__(self, cap: int = 1 << 16):
        self.cap = cap
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._local = threading.local()  # each thread's stack of open span ids
        self._on = False
        self._spans: List[Span] = []
        self._counts: List[Count] = []
        self._dropped = 0

    def recording(self) -> bool:
        """Whether a profiler session records; a session newly begun clears
        what the previous one left."""
        on = _profiling()
        if on != self._on:
            with self._lock:
                if on and not self._on:
                    self._spans, self._counts, self._dropped = [], [], 0
                self._on = on
        return on

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, items: list, item) -> None:
        with self._lock:
            if len(self._spans) + len(self._counts) < self.cap:
                items.append(item)
            else:
                self._dropped += 1

    def begin(self, name: str, **attrs) -> Optional[Span]:
        if not self.recording():
            return None
        stack = self._stack()
        return Span(next(self._ids), name, time.time_ns(), stack[-1] if stack else None, threading.get_ident(), attrs)

    def end(self, span: Optional[Span]) -> None:
        if span is not None:
            self._add(self._spans, dataclasses.replace(span, end_ns=time.time_ns(), end_thread=threading.get_ident()))

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        opened = self.begin(name, **attrs)
        if opened is None:
            yield
            return
        stack = self._stack()
        stack.append(opened.id)
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            stack.pop()
            self.end(opened)

    def count(self, name: str, n: int) -> None:
        if self.recording():
            self._add(self._counts, Count(name, time.time_ns(), int(n)))

    def recorded(self) -> Recording:
        self.recording()  # a read-out after the session ended lets the next session start afresh
        with self._lock:
            return Recording(list(self._spans), list(self._counts), self._dropped)


# one recorder a process, as the profiler session it follows is one a process
RECORDER = Recorder()
trace_span = RECORDER.span
begin_span = RECORDER.begin
end_span = RECORDER.end
trace_count = RECORDER.count
recorded = RECORDER.recorded
