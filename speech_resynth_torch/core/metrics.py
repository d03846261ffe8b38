"""Training metrics and profiler spans (the part of
speech_resynth_tpu/core/metrics.py the training loops use).

* ``MetricsWriter``: TensorBoard scalars, audio and spectrogram figures
  through tensorboardX when it is importable, a no-op otherwise.
* ``StepTimer``: step times and throughput; ``synced_step_time`` measures
  between host syncs, so asynchronous dispatch cannot flatter it.
* ``trace_span``: a named range on the ``torch.profiler`` timeline
  (``record_function``); the loops name their steps ``cfm_train_step`` and
  ``hifigan_train_step``, as the JAX loops do.

* ``step_flops`` / ``mfu``: the speech-LM step's FLOP count and its model
  FLOPs utilization. The JAX module reads the count from XLA's cost
  analysis; here it is counted from the Llama config and the batch (see
  ``step_flops``).
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

    def memory(self, step: int, device=None, prefix: str = "memory/") -> None:
        """The card's memory in use and its peak, in GB (the reference logs
        CUDA's peak); nothing for the CPU."""
        device = torch.device("cuda" if device is None else device)
        if self._writer is None or device.type != "cuda":
            return
        self.scalar(prefix + "in_use (GB)", torch.cuda.memory_allocated(device) / 2**30, step)
        self.scalar(prefix + "peak (GB)", torch.cuda.max_memory_allocated(device) / 2**30, step)

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


# dense bf16 tensor-core peak FLOP/s by device name (NVIDIA's H100 SXM data sheet)
PEAK_FLOPS = {"H100": 989e12}


def device_peak_flops(device=None) -> float:
    """The bf16 peak of a CUDA device by its name (0.0 for the CPU or an unknown card)."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return 0.0
    name = torch.cuda.get_device_name(device)
    return next((peak for key, peak in PEAK_FLOPS.items() if key in name), 0.0)


def llama_matmul_params(config) -> int:
    """The parameters a Llama token multiplies: per layer q, k, v, o (D x D
    each) and the SwiGLU's gate, up, down (D x F each), and the LM head (D x
    V). The embedding is a lookup, not a product."""
    d, f = config.hidden_size, config.intermediate_size
    return config.num_hidden_layers * (4 * d * d + 3 * d * f) + d * config.vocab_size


def step_flops(config, batch_size: int, seq_len: int, remat: bool = False) -> float:
    """FLOPs of one speech-LM training step on a (batch_size, seq_len) batch:

        forward   = 2 * P * T + L * 2 * B * H * d * N * (N + 1)
        step      = 3 * forward             (the backward is twice the forward)
        with remat: step * 4 / 3            (the forward once more)

    with P = ``llama_matmul_params``, T = B * N tokens, L layers of H heads
    of d: the second term is the causal attention's QK^T and PV, each
    N (N + 1) / 2 dot products of 2 d FLOPs per head. Norms, rotary, softmax
    and the optimizer are left out (elementwise work)."""
    b, n = batch_size, seq_len
    attention = config.num_hidden_layers * 2 * b * config.num_attention_heads * config.head_dim * n * (n + 1)
    forward = 2 * llama_matmul_params(config) * b * n + attention
    return 3 * forward * (4 / 3 if remat else 1)


def mfu(flops_per_step: float, step_time_s: float, device=None) -> float:
    """Model FLOPs utilization of one device (0.0 where the peak is unknown)."""
    peak = device_peak_flops(device)
    if peak <= 0 or step_time_s <= 0 or flops_per_step <= 0:
        return 0.0
    return flops_per_step / step_time_s / peak
