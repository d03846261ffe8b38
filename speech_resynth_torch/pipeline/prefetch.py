"""Background batch prefetch: overlap host-side batch materialization
(file reads, crops, pad-collation, the copy to the card) with the card's work.

A copy of speech_resynth_tpu/pipeline/prefetch.py: one daemon thread runs the
batch iterator and ``transform`` ``depth`` items ahead of the training loop.
``to_device`` is the loops' transform: numpy arrays to tensors on the
device, through pinned memory with ``non_blocking`` copies on the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence, TypeVar

import numpy as np
import torch

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()


def prefetch(
    iterable: Iterable[T],
    transform: Optional[Callable[[T], U]] = None,
    depth: int = 2,
) -> Iterator[U]:
    """Yield ``transform(item)`` for each item, computed ``depth`` items
    ahead on a daemon thread.  Exceptions from the iterator or transform
    re-raise at the consumption site; order is preserved."""
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()

    def _put(payload) -> bool:
        # bounded put that gives up when the consumer is gone — otherwise an
        # abandoned generator (early break) leaves the worker blocked forever
        # holding prefetched (device) batches
        while not stop.is_set():
            try:
                q.put(payload, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not _put((None, transform(item) if transform is not None else item)):
                    return
        except BaseException as e:  # noqa: BLE001 — propagate to consumer
            _put((e, None))
        else:
            _put((None, _SENTINEL))

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            err, item = q.get()
            if err is not None:
                raise err
            if item is _SENTINEL:
                return
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def to_device(batch: Dict, keys: Sequence[str], device: torch.device) -> Dict[str, torch.Tensor]:
    """The arrays of ``batch`` under ``keys`` as tensors on ``device``; on
    the card each goes through pinned memory with a ``non_blocking`` copy."""
    out = {}
    for k in keys:
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
    return out
