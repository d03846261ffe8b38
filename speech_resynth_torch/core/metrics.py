"""Training metrics and profiler spans (the part of
speech_resynth_tpu/core/metrics.py the training loops use).

* ``MetricsWriter``: TensorBoard scalars, audio and spectrogram figures
  through tensorboardX when it is importable, a no-op otherwise.
* ``StepTimer``: step times and throughput; ``synced_step_time`` measures
  between host syncs, so asynchronous dispatch cannot flatter it.
* ``trace_span``: a named range on the ``torch.profiler`` timeline
  (``record_function``); the loops name their steps ``cfm_train_step`` and
  ``hifigan_train_step``, as the JAX loops do.

The JAX module's FLOP counts and MFU read XLA's cost analysis; they have no
counterpart here yet.
"""

from __future__ import annotations

import contextlib
import io
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch


class MetricsWriter:
    """TensorBoard writer; a no-op when disabled or without tensorboardX."""

    def __init__(self, log_dir: str | Path, enabled: bool = True):
        self._writer = None
        if enabled:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return
            self._writer = SummaryWriter(str(log_dir))

    def scalar(self, tag: str, value, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)

    def scalars(self, values: dict, step: int, prefix: str = "") -> None:
        for k, v in values.items():
            self.scalar(f"{prefix}{k}", v, step)

    def audio(self, tag: str, waveform, step: int, sample_rate: int = 16000) -> None:
        """A PCM16 WAV summary, encoded with scipy (tensorboardX's own needs soundfile)."""
        if self._writer is None:
            return
        from scipy.io import wavfile
        from tensorboardX.proto.summary_pb2 import Summary

        wav = np.clip(np.asarray(waveform, np.float32).reshape(-1), -1.0, 1.0)
        buf = io.BytesIO()
        wavfile.write(buf, sample_rate, (wav * 32767).astype(np.int16))
        audio = Summary.Audio(
            sample_rate=sample_rate,
            num_channels=1,
            length_frames=len(wav),
            encoded_audio_string=buf.getvalue(),
            content_type="audio/wav",
        )
        self._writer.file_writer.add_summary(Summary(value=[Summary.Value(tag=tag, audio=audio)]), step)

    def spectrogram_figure(self, tag: str, spectrogram, step: int) -> None:
        """A mel-spectrogram heatmap."""
        if self._writer is None:
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 2))
        im = ax.imshow(np.asarray(spectrogram), aspect="auto", origin="lower", interpolation="none")
        plt.colorbar(im, ax=ax)
        self._writer.add_figure(tag, fig, step)
        plt.close(fig)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class StepTimer:
    """Rolling step-time and throughput tracker."""

    def __init__(self, window: int = 50):
        self._window = window
        self._times: list[float] = []
        self._last: Optional[float] = None
        self._sync_prev: Optional[tuple] = None

    def tick(self) -> Optional[float]:
        """Seconds since the last tick: the enqueue rate, which asynchronous dispatch flatters."""
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self._window:
                self._times.pop(0)
        self._last = now
        return dt

    def synced_step_time(self, step: int) -> Optional[float]:
        """Mean seconds per step between consecutive calls; call it right
        after a host sync (materializing the metrics), so the wall clock
        covers the device's work."""
        now = time.perf_counter()
        dt = None
        prev = self._sync_prev
        if prev is not None and step > prev[0] and now > prev[1]:
            dt = (now - prev[1]) / (step - prev[0])
        self._sync_prev = (step, now)
        return dt

    @property
    def mean_step_time(self) -> float:
        return float(np.mean(self._times)) if self._times else 0.0

    def throughput(self, items_per_step: float) -> float:
        st = self.mean_step_time
        return items_per_step / st if st > 0 else 0.0

    def rtf(self, audio_seconds_per_step: float) -> float:
        """Real-time factor: audio seconds produced per wall-clock second."""
        return self.throughput(audio_seconds_per_step)


@contextlib.contextmanager
def trace_span(name: str):
    """A named range on the torch.profiler timeline."""
    with torch.profiler.record_function(name):
        yield
