"""Conditional flow matching trainer (counterpart of speech_resynth_tpu/train/cfm.py).

AdamW (betas 0.9, 0.98, eps 1e-9, weight decay 0.01), warmup then linear
decay, gradient clipping at 0.1 and the k-means unit embedding frozen: the
table sits in ``to_cond_emb`` with ``requires_grad`` off, outside the
optimizer, which is the JAX step's "zero its gradient, restore the
parameter" (its reported gradient norm is then the same). One step draws its
noise and flow times from a generator seeded by the step's seed and its
dropout masks from the same seed (dropout is on, as the reference trains in
``train()`` mode), and returns its metrics as tensors on the device: nothing
waits for the card until the loop reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import DeviceLike, resolve_device
from ..core.precision import DEFAULT, Policy
from ..core.rng import derive_seed
from ..models.cfm import CFMConfig, ConditionalFlowMatchingModel
from ..models.composite import init_random_weights
from .common import TrainState, all_reduce_gradients, make_optimizer, warmup_linear_decay


def build_model(
    config: CFMConfig,
    embedding_table: Optional[np.ndarray] = None,
    policy: Policy = DEFAULT,
    seed: int = 0,
    device: DeviceLike = None,
) -> ConditionalFlowMatchingModel:
    """Seeded random weights, the k-means table (vocab + 1, dim_cond_emb; a
    zero pad row) installed when given; the unit embedding frozen either way."""
    model = ConditionalFlowMatchingModel(config, policy)
    init_random_weights(model, torch.Generator().manual_seed(seed))
    if embedding_table is not None:
        with torch.no_grad():
            model.to_cond_emb.weight.copy_(torch.as_tensor(np.asarray(embedding_table, np.float32)))
    model.to_cond_emb.requires_grad_(False)
    return model.to(resolve_device(device))


def make_train_step(model: ConditionalFlowMatchingModel, optimizer, data_group=None):
    """``step(state, batch, seed, x0=None, times=None) -> (state, metrics)``:
    one update on a batch of ``input_ids``, ``spectrogram_labels`` and, for
    a duration-predicting model, ``duration_labels``. ``x0`` / ``times``
    replace the noise and flow times drawn from the seed (the tests pass the
    JAX package's draws).

    With ``data_group`` (a process group of n data replicas) the batch is
    this replica's equal share of the global batch, rank-major: the noise,
    flow times and dropout masks are its rows of the global batch's draws,
    its loss is its terms over the global counts of valid frames and tokens,
    and the gradients are summed over the group. So the replicas step on
    the global batch as one process would, and the metrics are the global
    batch's."""
    params = optimizer.params
    n = 1 if data_group is None else dist.get_world_size(data_group)

    def step(state: TrainState, batch: dict, seed: int, x0=None, times=None):
        device = batch["spectrogram_labels"].device
        rows = None
        if n > 1:
            local = len(batch["spectrogram_labels"])
            rows = (dist.get_rank(data_group) * local, n * local)
        terms = model.loss_terms(
            batch["input_ids"],
            batch["spectrogram_labels"],
            batch.get("duration_labels"),
            generator=torch.Generator(device=device).manual_seed(seed),
            x0=x0,
            times=times,
            dropout_seed=derive_seed(seed, 1),
            rows=rows,
        )
        counts = torch.stack([terms["frames"], terms["tokens"]])
        if n > 1:
            dist.all_reduce(counts, group=data_group)
        frames, tokens = counts.clamp(min=1)
        mse, duration_loss = terms["sq"] / frames, terms["duration_sq"] / tokens
        grads = torch.autograd.grad(mse + duration_loss, params)
        all_reduce_gradients(grads, data_group)
        optimizer.step(grads)
        state.step += 1
        losses = torch.stack([mse, duration_loss]).detach()
        if n > 1:
            dist.all_reduce(losses, group=data_group)
        mse, duration_loss = losses
        metrics = {"loss": mse + duration_loss, "mse": mse, "duration_loss": duration_loss, "grad_norm": optimizer.grad_norm}
        return state, metrics

    return step


@dataclasses.dataclass
class CFMTrainerConfig:
    batch_size: int = 2700
    frames_per_seg: Optional[int] = 100
    epoch: int = 100
    warmup_steps: int = 1000
    lr: float = 1e-3
    lr_min: float = 1e-4
    max_norm: float = 0.1
    summary_interval: int = 100
    save_interval_epoch: int = 20
    dt: float = 0.0625
    truncation_value: float = 1.0
    seed: int = 0
    accum_steps: int = 1  # micro-batches per update: an effective batch of accum_steps x batch_size


def make_trainer(
    model_config: CFMConfig,
    trainer_config: CFMTrainerConfig,
    total_steps: int,
    embedding_table: Optional[np.ndarray] = None,
    policy: Policy = DEFAULT,
    device: DeviceLike = None,
    data_group=None,
):
    """(model, state, step) for the CFM task on ``device`` (the card unless
    ``"cpu"``); ``data_group``: see ``make_train_step``."""
    model = build_model(model_config, embedding_table, policy, trainer_config.seed, device)
    schedule = warmup_linear_decay(total_steps, trainer_config.warmup_steps, trainer_config.lr, trainer_config.lr_min)
    optimizer = make_optimizer(
        model.parameters(), schedule, b1=0.9, b2=0.98, eps=1e-9, max_norm=trainer_config.max_norm,
        accum_steps=trainer_config.accum_steps,
    )
    state = TrainState(step=0, modules={"model": model}, optimizers={"model": optimizer})
    return model, state, make_train_step(model, optimizer, data_group)
