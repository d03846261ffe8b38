"""Training metrics and profiler spans (the part of
speech_resynth_tpu/core/metrics.py the training loops use).

* ``MetricsWriter``: TensorBoard scalars, audio and spectrogram figures,
  written by the port's own event-file writer (``core.tbevents``).
* ``StepTimer``: ``synced_step_time`` measures step times between host
  syncs, so asynchronous dispatch cannot flatter it.
* ``trace_span`` (from ``core.tracing``): a named span, on the
  ``torch.profiler`` timeline and in the port's own recording while a
  profiler session records; the loops name their steps ``cfm_train_step``,
  ``hifigan_train_step`` and ``speechlm_train_step``, as the JAX loops do.

* ``step_flops`` / ``cfm_step_flops`` / ``hifigan_step_flops`` / ``mfu``:
  the FLOP counts of the speech-LM, CFM and HiFi-GAN training steps and
  their model FLOPs utilization. The JAX module reads the counts from XLA's
  cost analysis, which also counts elementwise work; here they are counted
  from the configs and the batch shape: matmuls and convolutions only, at
  2 FLOPs per multiply-add, on one process's share of the global batch.
"""

from __future__ import annotations

import io
import struct
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .tbevents import EventWriter, audio_value, image_value, scalar_value
from .tracing import trace_span  # noqa: F401  (the loops' step spans)


class MetricsWriter:
    """TensorBoard scalars, audio and spectrogram figures in event files
    written by ``core.tbevents`` (no tensorboardX, which the card's machine
    lacks); a no-op when disabled (every rank but 0)."""

    def __init__(self, log_dir: str | Path, enabled: bool = True):
        self._writer = EventWriter(log_dir) if enabled else None

    def scalar(self, tag: str, value, step: int) -> None:
        if self._writer is not None:
            self._writer.add([scalar_value(tag, float(value))], step)

    def scalars(self, values: dict, step: int, prefix: str = "") -> None:
        for k, v in values.items():
            self.scalar(f"{prefix}{k}", v, step)

    def audio(self, tag: str, waveform, step: int, sample_rate: int = 16000) -> None:
        """A PCM16 WAV summary, encoded with scipy."""
        if self._writer is None:
            return
        from scipy.io import wavfile

        wav = np.clip(np.asarray(waveform, np.float32).reshape(-1), -1.0, 1.0)
        buf = io.BytesIO()
        wavfile.write(buf, sample_rate, (wav * 32767).astype(np.int16))
        self._writer.add([audio_value(tag, buf.getvalue(), sample_rate, 1, len(wav))], step)

    def spectrogram_figure(self, tag: str, spectrogram, step: int) -> None:
        """A mel-spectrogram heatmap as a PNG image summary; nothing where
        matplotlib does not import (the card's machine)."""
        if self._writer is None:
            return
        try:
            import matplotlib
        except ImportError:
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 2))
        im = ax.imshow(np.asarray(spectrogram), aspect="auto", origin="lower", interpolation="none")
        plt.colorbar(im, ax=ax)
        buf = io.BytesIO()
        fig.savefig(buf, format="png")
        plt.close(fig)
        png = buf.getvalue()
        width, height = struct.unpack(">II", png[16:24])  # the IHDR chunk
        self._writer.add([image_value(tag, png, height, width, 4)], step)  # colorspace 4: RGBA

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
    """Step times between host syncs."""

    def __init__(self):
        self._sync_prev: Optional[tuple] = None

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


def cfm_forward_flops(config, batch_size: int, frames: int) -> float:
    """FLOPs of one CFM velocity-field forward on a (batch_size, frames) batch:

        per frame  2 * (dim_in + dim_cond_emb) * h        input projection of x and the unit embedding
                 + 2 * h * k_pos * h / groups              depthwise positional conv
                 + depth * (6 h^2 + 2 h^2 + 18 h F         qkv, out, the feed-forward's two k=3 convs
                            + 4 * N * heads * dim_head)    QK^T and PV over the N frames
                 + 4 h^2 per back-half layer with U-Net skips (the skip combiner)
                 + 2 * h * dim_in                          output projection
        per row    2 * (h + 1) * h + depth * 2 * 2 h^2     the time MLP and the adaptive norms' gains

    with h = hidden_size, F = intermediate_size. The duration predictor's
    conv (6 * dim_cond_emb per token) is left out, as are norms, rotary,
    softmax and activations (elementwise work)."""
    h, f, n = config.hidden_size, config.intermediate_size, frames
    per_layer = 8 * h * h + 18 * h * f + 4 * n * h
    skips = config.depth // 2 if config.use_unet_skip_connection else 0
    per_frame = (
        2 * (config.dim_in + config.dim_cond_emb) * h
        + 2 * h * config.conv_pos_embed_kernel_size * (h // config.conv_pos_embed_groups)
        + config.depth * per_layer
        + skips * 4 * h * h
        + 2 * h * config.dim_in
    )
    per_row = 2 * (h + 1) * h + config.depth * 4 * h * h
    return float(batch_size * (n * per_frame + per_row))


def cfm_step_flops(config, batch_size: int, frames: int, remat: bool = False) -> float:
    """FLOPs of one CFM training step on a (batch_size, frames) batch:

        step       = 3 * forward            (the backward is twice the forward)
        with remat: 4 * forward             (the forward once more)

    with forward = ``cfm_forward_flops``. The first products (the input
    projection of the noisy mel and the frozen unit table, the time MLP)
    compute no input gradient, so the true count is slightly lower (<1% at
    the YAML's widths); the optimizer is left out (elementwise work)."""
    return cfm_forward_flops(config, batch_size, frames) * (4 if remat else 3)


def _conv_out(length: int, kernel: int, stride: int = 1, padding: int = 0, dilation: int = 1) -> int:
    return (length + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


def hifigan_generator_flops(config, batch_size: int, frames: int) -> float:
    """FLOPs of one generator forward on (batch_size, frames) mel frames:
    conv_pre (k 7), each stage's transposed conv (2 * T_in * C_in * C_out *
    k) and its MRF branches (per dilation two convs of 2 * T * C^2 * k),
    conv_post (k 7)."""
    c, t = config.upsample_initial_channel, frames
    total = 2 * t * config.model_in_dim * c * 7
    for rate, kernel in zip(config.upsample_rates, config.upsample_kernel_sizes):
        total += 2 * t * c * (c // 2) * kernel
        t = (t - 1) * rate - 2 * ((kernel - rate) // 2) + kernel
        c //= 2
        for k, dilations in zip(config.resblock_kernel_sizes, config.resblock_dilation_sizes):
            total += len(dilations) * 2 * 2 * t * c * c * k
    total += 2 * t * c * 7
    return float(batch_size * total)


def discriminator_flops(batch_size: int, samples: int) -> float:
    """FLOPs of MPD and MSD (``models.hifigan``'s widths) on one batch of
    (batch_size, samples) waves: every conv at 2 * out positions * C_out *
    C_in / groups * k."""
    from ..models.hifigan import PERIOD_CHANNELS, SCALE_SPECS

    total = 0
    for period in (2, 3, 5, 7, 11):
        h = -(-samples // period)  # reflect-padded to a multiple of the period
        chans = (1, *PERIOD_CHANNELS)
        for c_in, c_out in zip(chans, chans[1:]):
            h = _conv_out(h, 5, 3, 2)
            total += 2 * h * period * c_out * c_in * 5
        h = _conv_out(h, 5, 1, 2)
        total += 2 * h * period * chans[-1] * chans[-1] * 5
        total += 2 * _conv_out(h, 3, 1, 1) * period * chans[-1] * 3
    length = samples
    for scale in range(3):
        if scale:
            length = _conv_out(length, 4, 2, 2)  # the average pool between scales
        t, c_in = length, 1
        for c_out, k, stride, padding, groups in SCALE_SPECS:
            t = _conv_out(t, k, stride, padding)
            total += 2 * t * c_out * (c_in // groups) * k
            c_in = c_out
        total += 2 * _conv_out(t, 3, 1, 1) * c_in * 3
    return float(batch_size * total)


def hifigan_step_flops(config, batch_size: int, frames: int) -> float:
    """FLOPs of one HiFi-GAN training step on (batch_size, frames) mel frames
    and their waves (``config.waveform_lengths(frames)`` samples), as
    ``train.hifigan``'s step runs it:

        G forward                                    G
        D on the real and the detached fake wave,
          forward and backward                       3 * 2 D
        D on the fake again, forward and the
          backward into G (D frozen: input grads)    2 D
        the feature-matching forward on the real     D
        G backward                                   2 G
        step                                         3 G + 9 D

    with G = ``hifigan_generator_flops`` and D = ``discriminator_flops`` of
    one batch of waves. The first conv of each network computes no input
    gradient, so the true count is slightly lower. The STFT of the mel loss
    is FFT work and left out (the port computes it as a product with a DFT
    basis, ~0.35 MFLOP a frame); so is the elementwise work."""
    samples = int(config.waveform_lengths(frames))
    return 3 * hifigan_generator_flops(config, batch_size, frames) + 9 * discriminator_flops(batch_size, samples)
