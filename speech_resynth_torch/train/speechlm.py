"""Speech-LM (Llama) trainer (counterpart of speech_resynth_tpu/train/speechlm.py).

AdamW (betas 0.9 / 0.98, eps 1e-8, weight decay 0.01), warmup then linear
decay, clipping at ``max_norm``, gradient accumulation over ``accum_steps``
micro-batches (``train.common.Optimizer``: optax's semantics), the causal-LM
loss with -100 labels at pads. Parameters are f32 and compute is bf16
(``DEFAULT``). Training attention defaults to ``"xla"``, the plain version,
as in the JAX package; ``"auto"`` or ``"pallas"`` take the flash kernel K1
forward with the plain version's backward.

The mesh (``core.mesh``): the batch rows are split over the data axis, and
each data replica's loss is its share of the global batch's mean (its
tokens' negative log-likelihood over the global count of valid tokens), so
the gradients summed over the data axis (``train.common.all_reduce_gradients``)
are those of the whole global batch, as the JAX step computes them on its
global array. A model axis > 1 takes ``parallel.sharding.tensor_parallel_rules``
(``sequence_parallel`` adds the sequence-sharded layout); at 1 the model is
whole on every process.

A step returns its metrics as tensors on the device; nothing waits for the
card until the caller reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..core.device import DeviceLike, resolve_device
from ..core.mesh import DATA_AXIS, Mesh, make_mesh
from ..core.precision import DEFAULT, Policy
from ..models.composite import init_random_weights
from ..models.llama import LlamaConfig, LlamaLM, causal_lm_loss_terms
from ..parallel.sharding import apply_tensor_parallel
from .common import TrainState, all_reduce_gradients, make_optimizer, warmup_linear_decay


@dataclasses.dataclass
class SpeechLMTrainerConfig:
    batch_size_per_device: int = 96
    units_per_sample: int = 128
    epoch: int = 3
    warmup_steps: int = 100
    lr: float = 2e-4
    lr_min: float = 2e-5
    beta1: float = 0.9
    beta2: float = 0.98
    max_norm: float = 1.0
    summary_interval: int = 100
    seed: int = 0
    # the hidden states between layers sharded on the sequence over the model
    # axis (parallel.sharding); the numbers are unchanged, only the layout
    sequence_parallel: bool = False
    # training attention: the plain version, as the JAX package pins it;
    # "auto" / "pallas" take the flash kernel forward
    attn_implementation: str = "xla"
    # recompute each layer in the backward pass (less activation memory)
    remat: bool = False
    # micro-batches per update
    accum_steps: int = 1


def make_speechlm_trainer(
    model_config: LlamaConfig,
    trainer_config: SpeechLMTrainerConfig,
    mesh: Optional[Mesh] = None,
    total_steps: int = 1,
    policy: Policy = DEFAULT,
    device: DeviceLike = None,
):
    """(model, state, step) for the speech LM on ``device`` (the card unless
    ``"cpu"``) over ``mesh`` (``make_mesh()`` when None; see the module doc).
    ``step(state, batch) -> (state, metrics)`` takes this process's rows of
    the global batch (``core.mesh.shard_batch``) as ``input_ids``,
    ``attention_mask`` and ``labels`` tensors on the device and returns
    ``loss`` (of the global batch) and ``grad_norm``. Its weights are seeded
    random (``trainer_config.seed``, a CPU generator, so every process draws
    the same)."""
    mesh = mesh or make_mesh()
    device = resolve_device(device)
    model = LlamaLM(model_config, policy, trainer_config.attn_implementation, trainer_config.remat)
    with torch.no_grad():
        init_random_weights(model, torch.Generator().manual_seed(trainer_config.seed))
    model.to(device)
    apply_tensor_parallel(model, mesh, trainer_config.sequence_parallel)
    data_group = mesh.group(DATA_AXIS) if mesh.shape[DATA_AXIS] > 1 else None
    schedule = warmup_linear_decay(total_steps, trainer_config.warmup_steps, trainer_config.lr, trainer_config.lr_min)
    opt = make_optimizer(
        model.parameters(), schedule, b1=trainer_config.beta1, b2=trainer_config.beta2,
        eps=1e-8,  # torch AdamW's default: the reference's speech LM passes none
        max_norm=trainer_config.max_norm, accum_steps=trainer_config.accum_steps,
    )
    state = TrainState(step=0, modules={"model": model}, optimizers={"model": opt})

    def step(state: TrainState, batch: dict):
        logits, _ = model(batch["input_ids"], batch["attention_mask"])
        nll, count = causal_lm_loss_terms(logits, batch["labels"])
        nll_and_count = torch.stack([nll.detach(), count.to(nll.dtype)])
        if data_group is not None:
            dist.all_reduce(nll_and_count, group=data_group)
        total, count = nll_and_count[0], torch.clamp(nll_and_count[1], min=1)
        grads = torch.autograd.grad(nll / count, opt.params)
        all_reduce_gradients(grads, data_group)
        opt.step(grads)
        state.step += 1
        return state, {"loss": total / count, "grad_norm": opt.grad_norm}

    return model, state, step
