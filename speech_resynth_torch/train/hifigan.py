"""HiFi-GAN trainer (counterpart of speech_resynth_tpu/train/hifigan.py).

One step, in the reference's order:
* the discriminator update first, LSGAN on MPD and MSD against the generator
  output detached; MSD's spectral-normed first scale runs with
  ``update_stats`` on the real wave, then on the generated one, so its ``u``
  advances twice;
* then the generator update against the updated discriminators: mel-L1 x 45
  (masked, of the port's log-mel of the generated wave) + feature matching
  + the adversarial terms; MSD's first scale runs from the ``u`` the
  discriminator update left, without storing a new one. The discriminators'
  parameters take no gradient there (``requires_grad`` off for the pass).

The generator runs once per step: its output is the JAX step's second
forward too, since nothing changed the generator in between. It records a
gradient, so it runs the plain conv chain and launches neither K2 nor K3.
Both AdamWs (betas 0.8, 0.99, eps 1e-8, weight decay 0.01, no clipping)
follow one per-epoch exponential schedule.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from ..core.precision import DEFAULT, Policy
from ..dsp.mel import log_mel_spectrogram
from ..models.composite import init_random_weights
from ..models.hifigan import (
    HifiGanConfig,
    HifiGanGenerator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    discriminator_loss,
    feature_loss,
    generator_loss,
)
from .common import TrainState, all_reduce_gradients, epoch_exponential_schedule, make_optimizer


@dataclasses.dataclass
class HifiGanTrainerConfig:
    # no accum_steps: the step interleaves D and G updates against freshly
    # updated discriminators, which accumulation would change
    batch_size: int = 64
    segment_size: int = 16080
    training_epochs: int = 181
    learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999
    seed: int = 1234
    n_fft: int = 400
    hop_size: int = 320
    num_mels: int = 80
    steps_per_epoch: int = 5543  # 354729 / 64; the loop sets it from the dataset
    stdout_interval: int = 1000
    summary_interval: int = 1000
    checkpoint_interval: int = 10000
    validation_interval: int = 10000
    mel_loss_weight: float = 45.0


@torch.no_grad()
def init_discriminator_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights as the JAX discriminators initialize them: weight-norm
    directions and spectral-normed kernels N(0, 2 / fan_in), gains 1, biases
    0, the power iteration's ``u`` N(0, 1)."""
    for name, t in list(module.named_parameters()) + list(module.named_buffers()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("v", "weight"):
            fan_in = t[0].numel()
            t.copy_(torch.randn(t.shape, generator=generator) * math.sqrt(2.0 / fan_in))
        elif leaf == "u":
            t.copy_(torch.randn(t.shape, generator=generator))
        elif leaf == "g":
            t.fill_(1.0)
        else:
            t.zero_()


def build_models(config: HifiGanConfig, policy: Policy = DEFAULT, seed: int = 0, device: DeviceLike = None):
    """(generator, MPD, MSD) with seeded random weights, on ``device``."""
    device = resolve_device(device)
    gen = HifiGanGenerator(config, policy)
    init_random_weights(gen, torch.Generator().manual_seed(seed))
    mpd, msd = MultiPeriodDiscriminator(policy=policy), MultiScaleDiscriminator(policy=policy)
    init_discriminator_weights(mpd, torch.Generator().manual_seed(seed + 1))
    init_discriminator_weights(msd, torch.Generator().manual_seed(seed + 2))
    return gen.to(device), mpd.to(device), msd.to(device)


@contextlib.contextmanager
def frozen(*modules: nn.Module):
    """Parameters of ``modules`` take no gradient inside the block."""
    params = [p for m in modules for p in m.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def make_gan_trainer(config: HifiGanConfig, trainer: HifiGanTrainerConfig, policy: Policy = DEFAULT,
                     device: DeviceLike = None, data_group=None):
    """((gen, mpd, msd), state, step). ``step(state, batch) -> (state,
    metrics)`` on a batch of "mel" (B, T, mels) f32, "wav" (B, S) f32 and
    "mel_mask" (B, T) bool, metrics as tensors on the device. With
    ``data_group`` (a process group), each process steps on its rows and the
    gradients are averaged over the group: every loss is a mean over the
    rows, and the loop's crops give every row the same length, so that is
    the gradient of the global batch."""
    gen, mpd, msd = build_models(config, policy, trainer.seed, device)
    schedule = epoch_exponential_schedule(trainer.learning_rate, trainer.lr_decay, trainer.steps_per_epoch)
    kw = dict(b1=trainer.adam_b1, b2=trainer.adam_b2, eps=1e-8, max_norm=None, weight_decay=0.01)
    gen_opt = make_optimizer(gen.parameters(), schedule, **kw)
    disc_opt = make_optimizer([*mpd.parameters(), *msd.parameters()], schedule, **kw)
    state = TrainState(step=0, modules={"gen": gen, "mpd": mpd, "msd": msd}, optimizers={"gen": gen_opt, "disc": disc_opt})

    def step(state: TrainState, batch: dict):
        mel, wav, mel_mask = batch["mel"], batch["wav"], batch["mel_mask"]
        y_g = gen(mel)

        # discriminators, against the generator output detached
        y_hat = y_g.detach()
        mpd_r, mpd_g, _, _ = mpd(wav, y_hat)
        msd_r, msd_g, _, _ = msd(wav, y_hat, update_stats=True)
        loss_d = discriminator_loss(mpd_r, mpd_g) + discriminator_loss(msd_r, msd_g)
        grads = torch.autograd.grad(loss_d, disc_opt.params)
        all_reduce_gradients(grads, data_group, mean=True)
        disc_opt.step(grads)

        # generator, against the updated discriminators
        y_g_mel = log_mel_spectrogram(y_g, n_fft=trainer.n_fft, num_mels=trainer.num_mels, hop_size=trainer.hop_size)
        diff = torch.where(mel_mask[..., None], torch.abs(mel - y_g_mel), 0.0)
        mel_l1 = diff.sum() / (mel_mask.sum() * trainer.num_mels).clamp(min=1)
        with frozen(mpd, msd):
            _, mpd_g, fr_f, fg_f = mpd(wav, y_g)
            _, msd_g, fr_s, fg_s = msd(wav, y_g)
        loss_g = (
            generator_loss(mpd_g)
            + generator_loss(msd_g)
            + feature_loss(fr_f, fg_f)
            + feature_loss(fr_s, fg_s)
            + trainer.mel_loss_weight * mel_l1
        )
        grads = torch.autograd.grad(loss_g, gen_opt.params)
        all_reduce_gradients(grads, data_group, mean=True)
        gen_opt.step(grads)
        state.step += 1
        return state, {"loss_disc": loss_d.detach(), "loss_gen": loss_g.detach(), "mel_error": mel_l1.detach()}

    return (gen, mpd, msd), state, step
