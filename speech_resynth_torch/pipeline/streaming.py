"""Exact streaming vocoder: chunked mel -> waveform, sample for sample the batch run.

Counterpart of speech_resynth_tpu/pipeline/streaming.py. The HiFi-GAN
generator has a finite receptive field, so audio can be made incrementally
and exactly: run overlapping mel windows, keep only the output samples whose
receptive field lies inside the window, and pin the first and last windows
to the utterance's true edges, where the layers' own zero padding then
matches the batch run. Time to first audio does not grow with the utterance.
Exactness holds up to the summation order of the window-shaped and
full-shaped runs (the f32 tests on the CPU compare at 1e-6; the PCM16 wire
may flip by one LSB).

``receptive_field_samples`` walks the config for a conservative one-sided
radius; for the production vocoder (hop 320, rates 5/4/4/2/2, MRF K <= 11,
d <= 5) it comes to 22 mel frames of context per side. Windows:

* the first, ``chunk + ctx`` frames, pinned to the left edge: it emits the
  first ``chunk`` frames of audio once ``chunk + ctx`` mel frames have
  arrived (72 at chunk 50);
* interior, ``chunk + 2*ctx`` frames (94): the steady state. While the
  stream is within ``ctx`` of the left edge (only when ``chunk < ctx``), a
  left-pinned interior window emits every ready frame in one call;
* the flush window ends at the true right edge.

The mel buffer is bounded: frames more than one window behind the emission
frontier are dropped, so memory is O(window), not O(utterance).

Each window runs through the port's ``HifiGanGenerator``, which picks its
kernels by device (on the card K2 per branch, or K3 per stage while
``ops.fused_mrf.mrf_stage_fusion`` is on); the JAX ``fused`` argument has no
counterpart.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..dsp.mulaw import mulaw_encode
from ..models.composite import pcm16_encode
from ..models.hifigan import HifiGanConfig, HifiGanGenerator

__all__ = ["receptive_field_samples", "context_frames_for", "StreamingVocoder", "stream_waveform"]

WIRES = {"f32": np.float32, "pcm16": np.int16, "mulaw": np.uint8}


def receptive_field_samples(config: HifiGanConfig) -> int:
    """Conservative one-sided contamination radius, in output samples.

    A stride-1 conv of half-width h grows the radius by h in its own domain;
    a transposed conv (stride S, kernel K) maps radius r to at most r*S + K;
    parallel MRF branches take the max. An output sample further than this
    from a window edge does not depend on anything outside the window.
    """
    r = 3  # conv_pre k=7
    for rate, kernel in zip(config.upsample_rates, config.upsample_kernel_sizes):
        r = r * rate + kernel
        mrf = 0
        for rk, rd in zip(config.resblock_kernel_sizes, config.resblock_dilation_sizes):
            half = (rk - 1) // 2
            mrf = max(mrf, sum(half * d + half for d in rd))
        r += mrf
    return r + 3  # conv_post k=7


def context_frames_for(config: HifiGanConfig) -> int:
    """Mel frames of one-sided context that cover the receptive field."""
    return -(-receptive_field_samples(config) // config.total_upsample)


class StreamingVocoder:
    """Incremental mel -> waveform for one utterance, equal to the batch run.

    >>> sv = StreamingVocoder(generator)
    >>> for mel_chunk in frames:          # (t, model_in_dim) arrays
    ...     play(sv.push(mel_chunk))      # samples, possibly none
    >>> play(sv.flush())                  # the tail; the stream is then finished

    ``generator`` carries the config, the precision policy and the device
    the windows run on. ``wire`` picks the conversion made on that device
    before the copy to the host: "f32", "pcm16" (int16) or "mulaw" (uint8
    codes, dsp/mulaw.py). ``device_calls`` counts windows run: no window is
    ever run twice.
    """

    def __init__(
        self,
        generator: HifiGanGenerator,
        chunk_frames: int = 50,
        context_frames: Optional[int] = None,
        wire: str = "f32",
    ):
        if wire not in WIRES:
            raise ValueError(f"wire must be one of {'|'.join(WIRES)}, got {wire!r}")
        self.generator = generator
        self.config = generator.config
        self.wire = wire
        self.device = generator.conv_pre.weight.device
        self.hop = self.config.total_upsample
        # output samples past (L-1)*hop: the transposed convs' kernel tail
        self.extra = int(self.config.waveform_lengths(1))
        self.ctx = context_frames_for(self.config) if context_frames is None else int(context_frames)
        self.chunk = int(chunk_frames)
        if self.chunk < 1:
            raise ValueError("chunk_frames must be >= 1")
        self.window = self.chunk + 2 * self.ctx
        # the left-pinned first window: the true edge is the left context,
        # so the first audio needs only chunk + ctx frames
        self.first_window = self.chunk + self.ctx
        self.device_calls = 0
        self._mel: List[np.ndarray] = []  # retained frames [base, total)
        self._base = 0  # absolute index of _mel[0] (earlier frames dropped)
        self._emitted = 0  # mel frames whose samples have been emitted
        self._finished = False

    # -- internals ----------------------------------------------------------

    def _total(self) -> int:
        return self._base + len(self._mel)

    @torch.inference_mode()
    def _run_window(self, start: int, length: int) -> np.ndarray:
        i = start - self._base
        if i < 0:
            raise AssertionError("window reaches below the retained buffer")
        mel = torch.from_numpy(np.stack(self._mel[i : i + length]).astype(np.float32))[None].to(self.device)
        self.device_calls += 1
        wav = self.generator(mel)
        if self.wire == "pcm16":
            wav = pcm16_encode(wav)
        elif self.wire == "mulaw":
            wav = mulaw_encode(wav)
        return wav[0].cpu().numpy()

    def _drain_ready(self) -> List[np.ndarray]:
        out: List[np.ndarray] = []
        # a window [start, start+w) emits every frame in [emitted, start+w-ctx):
        # the right context through +ctx is inside it, and the left context is
        # either inside it (start = emitted - ctx) or the true utterance edge
        while True:
            if self._emitted == 0:
                start, w = 0, self.first_window
            else:
                start, w = max(0, self._emitted - self.ctx), self.window
            if self._total() < start + w:
                break
            wav = self._run_window(start, w)
            lo = (self._emitted - start) * self.hop
            out.append(wav[lo : (w - self.ctx) * self.hop])
            self._emitted = start + w - self.ctx
        # frames more than one window behind the frontier are dead: even the
        # flush window starts at total - window >= emitted - window
        keep_from = max(0, self._emitted - self.window)
        if keep_from > self._base:
            del self._mel[: keep_from - self._base]
            self._base = keep_from
        return out

    # -- public -------------------------------------------------------------

    def push(self, mel_frames: np.ndarray) -> np.ndarray:
        """Feed (t, model_in_dim) mel frames; returns the samples now ready
        (maybe none), in the wire's dtype."""
        if self._finished:
            raise RuntimeError("stream already flushed")
        mel_frames = np.asarray(mel_frames)
        if mel_frames.ndim != 2 or mel_frames.shape[1] != self.config.model_in_dim:
            raise ValueError(f"expected (t, {self.config.model_in_dim}) mel frames, got {mel_frames.shape}")
        self._mel.extend(mel_frames)
        chunks = self._drain_ready()
        return np.concatenate(chunks) if chunks else np.zeros((0,), WIRES[self.wire])

    def flush(self) -> np.ndarray:
        """Emit the tail (the frames held back for right context) and finish.
        The concatenation of every push() and flush() return then equals the
        batch run of the whole mel."""
        if self._finished:
            raise RuntimeError("stream already flushed")
        self._finished = True
        total = self._total()
        if total == 0:
            return np.zeros((0,), WIRES[self.wire])
        full_len = (total - 1) * self.hop + self.extra
        if total <= self.window:
            # a short stream: one pass at its own length, both edges true
            # (the buffer is intact: keep_from <= total - window <= 0)
            wav = self._run_window(0, total)
            return wav[self._emitted * self.hop : full_len]
        start = total - self.window  # the right edge is the true end: the tail padding matches
        wav = self._run_window(start, self.window)
        lo = (self._emitted - start) * self.hop
        return wav[lo : full_len - start * self.hop]


def stream_waveform(generator: HifiGanGenerator, mel: np.ndarray, chunk_frames: int = 50, **kwargs) -> np.ndarray:
    """A whole (T, model_in_dim) mel through the streaming path in one push
    and a flush: the concatenated waveform, equal to the batch run."""
    sv = StreamingVocoder(generator, chunk_frames=chunk_frames, **kwargs)
    parts = [sv.push(mel), sv.flush()]
    return np.concatenate(parts)
