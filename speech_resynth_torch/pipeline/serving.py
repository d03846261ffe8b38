"""Serving runtime: batched, pipelined unit-to-waveform synthesis.

Counterpart of speech_resynth_tpu/pipeline/serving.py:

* requests (unit sequences) are padded into fixed shape buckets;
* dispatch is asynchronous: ``synthesize`` queues a batch's kernels on the
  card's stream and returns, so up to ``max_inflight`` batches are queued
  while the host collates the next one;
* results are copied to the host (``.cpu()``) on a small thread pool, trimmed
  per request (analytic ConvTranspose lengths) and returned in submission
  order.

While a profiler session records (``core.tracing``), each batch records the
span ``serve.enqueue`` (its collate and ``decoder.synthesize``, with its
index and request ids), the span ``serve.inflight`` (from the end of its
enqueue to its samples on the host, closed on the copy thread) and, where it
is drained, the counts ``serve.samples_needed`` (its requests' samples) and
``serve.samples_computed`` (rows times its padded length, filler rows
included).
"""

from __future__ import annotations

import dataclasses
import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.tracing import begin_span, end_span, trace_count, trace_span
from ..models.composite import ConditionalFlowMatchingWithHifiGan
from .data import bucket_length


@dataclasses.dataclass
class SynthesisRequest:
    units: np.ndarray  # (n,) int units, already +1-shifted (0 = pad)
    request_id: int = 0


class SynthesisServer:
    """Micro-batching synthesis loop over the composite decoder."""

    def __init__(
        self,
        decoder: ConditionalFlowMatchingWithHifiGan,
        batch_size: int = 8,
        dt: float = 0.0625,
        truncation_value: Optional[float] = 1.0,
        length_multiple: int = 128,
        pcm16: bool = True,
        mulaw: bool = False,
        seed: int = 0,
        max_inflight: int = 4,
        drain_threads: int = 4,
    ):
        self.decoder = decoder
        self.batch_size = batch_size
        self.dt = dt
        self.truncation_value = truncation_value
        self.length_multiple = length_multiple
        # mu-law takes precedence over the pcm16 default: the formats are exclusive
        self.pcm16 = pcm16 and not mulaw
        self.mulaw = mulaw
        self.generator = torch.Generator(device=decoder.device).manual_seed(seed)
        self.max_inflight = max_inflight
        self.drain_threads = drain_threads

    def _collate(self, batch: Sequence[SynthesisRequest]) -> np.ndarray:
        L = bucket_length(max(len(r.units) for r in batch), self.length_multiple, self.length_multiple)
        ids = np.zeros((self.batch_size, L), np.int64)
        for j, r in enumerate(batch):
            ids[j, : len(r.units)] = r.units
        return ids

    def synthesize_stream(self, requests: Iterable[SynthesisRequest]) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (request_id, waveform) in submission order, keeping up to
        ``max_inflight`` batches queued on the device."""
        inflight: "queue.Queue[tuple]" = queue.Queue()
        pool = ThreadPoolExecutor(max(1, self.drain_threads))

        def materialize(wavs: torch.Tensor, lengths: torch.Tensor, span):
            out = wavs.cpu().numpy(), lengths.cpu().numpy()  # the host copy waits for the batch
            end_span(span)
            return out

        def drain_one():
            reqs, fut = inflight.get()
            wavs, lengths = fut.result()
            trace_count("serve.samples_needed", lengths[: len(reqs)].sum())
            trace_count("serve.samples_computed", wavs.size)
            return [(r.request_id, wavs[j, : int(lengths[j])]) for j, r in enumerate(reqs)]

        def enqueue(reqs: List[SynthesisRequest], index: int):
            with trace_span("serve.enqueue", batch=index, requests=[r.request_id for r in reqs]):
                # a partial batch is filled with one-unit rows, so every row is a real utterance
                filler = [SynthesisRequest(np.ones(1, np.int64), -1)] * (self.batch_size - len(reqs))
                ids = self._collate(reqs + filler)
                wavs, lengths = self.decoder.synthesize(
                    ids,
                    dt=self.dt,
                    truncation_value=self.truncation_value,
                    generator=self.generator,
                    pcm16=self.pcm16,
                    mulaw=self.mulaw,
                )
            span = begin_span("serve.inflight", batch=index)
            inflight.put((reqs, pool.submit(materialize, wavs, lengths, span)))

        try:
            pending: List[SynthesisRequest] = []
            batches = 0
            for req in requests:
                pending.append(req)
                if len(pending) == self.batch_size:
                    enqueue(pending, batches)
                    batches += 1
                    pending = []
                    if inflight.qsize() >= self.max_inflight:
                        yield from drain_one()
            if pending:  # final partial batch
                enqueue(pending, batches)
            while not inflight.empty():
                yield from drain_one()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def synthesize_many(self, unit_seqs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """List of unit sequences -> list of waveforms, in order."""
        reqs = [SynthesisRequest(np.asarray(u, np.int64), i) for i, u in enumerate(unit_seqs)]
        out = dict(self.synthesize_stream(reqs))
        return [out[i] for i in range(len(unit_seqs))]
