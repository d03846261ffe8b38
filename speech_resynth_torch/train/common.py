"""Shared training core (counterpart of speech_resynth_tpu/train/common.py).

The JAX trainers step ``optax.chain(clip_by_global_norm, adamw)``, wrapped in
``optax.MultiSteps`` for gradient accumulation. ``Optimizer`` gives the same
updates on ``torch.optim.AdamW``:

* the learning rate of update n (0-based) is ``schedule(n)``: optax reads its
  count before incrementing it, so the first update sees ``schedule(0)``;
* clipping as optax clips: gradients stay as they are while their global norm
  is below ``max_norm``, else they are scaled by ``max_norm / norm``
  (``clip_grad_norm_`` would always scale by ``max_norm / (norm + 1e-6)``);
* with ``accum_steps`` k, the k micro-gradients are averaged (Welford, as
  MultiSteps) and only the average is clipped and applied; the count, and so
  the schedule, advances only on the update that is applied;
* AdamW with eps outside the square root and decoupled weight decay on every
  parameter it holds, the same update as optax's ``adamw`` up to rounding.

The accumulated gradients and the micro-step counter are part of the state a
checkpoint saves (``Optimizer.state_dict``), so a run killed inside an
accumulation window resumes without losing or counting twice a micro-batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

Schedule = Callable[[int], float]


def warmup_linear_decay(total_steps: int, warmup_steps: int, base_lr: float, min_lr: float) -> Schedule:
    """min -> base over ``warmup_steps``, then linearly base -> min at
    ``total_steps``; in f32, as the JAX schedule computes it."""
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        if step < warmup_steps:
            return float(f32(min_lr) + f32(base_lr - min_lr) * step / f32(max(warmup_steps, 1)))
        progress = (step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1))
        return float(f32(min_lr) + f32(base_lr - min_lr) * (f32(1) - progress))

    return schedule


def epoch_exponential_schedule(lr: float, gamma: float, steps_per_epoch: int) -> Schedule:
    """lr * gamma ** epoch, stepped once per epoch (ExponentialLR); in f32,
    as the JAX schedule computes it (180 epochs of 0.999 are 2e-6 off f64)."""
    f32 = np.float32

    def schedule(step: int) -> float:
        return float(f32(lr) * f32(gamma) ** f32(step // max(steps_per_epoch, 1)))

    return schedule


def _square_sum(t: torch.Tensor) -> torch.Tensor:
    s = torch.sum(t.float() ** 2)
    return s.full_tensor() if hasattr(s, "full_tensor") else s  # a sharded DTensor's sum is reduced over its mesh


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32, on the tensors'
    device; a ``DTensor``'s squares are summed over every shard."""
    return torch.sqrt(sum(_square_sum(t) for t in tensors))


def all_reduce_gradients(grads: Sequence[torch.Tensor], group, mean: bool = False) -> None:
    """Data parallelism's one reduction: each gradient summed in place over
    the process group ``group`` (a no-op when None), or averaged with
    ``mean``. Summed where each process's loss is its share of the global
    batch's loss (its terms over the global count), averaged where it is a
    mean over its own equal rows. A ``DTensor`` gradient (tensor
    parallelism) is reduced through its local shard."""
    if group is None:
        return
    import torch.distributed as dist

    n = dist.get_world_size(group)
    for g in grads:
        local = g.to_local() if hasattr(g, "to_local") else g
        dist.all_reduce(local, group=group)
        if mean:
            local.div_(n)


class Optimizer:
    """AdamW with optax's clipping, schedule and accumulation semantics over
    the parameters in ``params`` that require grad (see the module doc)."""

    def __init__(
        self,
        params: Iterable[nn.Parameter],
        schedule: Schedule,
        b1: float,
        b2: float,
        eps: float,
        max_norm: Optional[float],
        weight_decay: float = 0.01,
        accum_steps: int = 1,
        norm: Callable[[Sequence[torch.Tensor]], torch.Tensor] = global_norm,
    ):
        self.params: List[nn.Parameter] = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.max_norm = max_norm
        self.norm = norm  # the global norm (a pipeline stage sums its layers' over the stages)
        self.accum_steps = accum_steps
        self.adamw = torch.optim.AdamW(self.params, lr=schedule(0), betas=(b1, b2), eps=eps, weight_decay=weight_decay)
        self.count = 0  # updates applied: the schedule's step
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None
        # with a clip, the global norm of the last step()'s gradients: what
        # the trainers report as grad_norm, and the clip's norm when
        # accum_steps is 1 (without one, as for the GAN, nothing reads it)
        self.grad_norm: Optional[torch.Tensor] = None

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        """Take one (micro-)batch's gradients, aligned with ``self.params``;
        True when an update was applied, False inside an accumulation window."""
        if self.max_norm is not None:
            self.grad_norm = self.norm(grads)
        if self.accum_steps > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.accum_steps:
                return False
            grads = self.acc
        if self.max_norm is not None:
            norm = self.grad_norm if self.accum_steps == 1 else self.norm(grads)
            grads = [torch.where(norm < self.max_norm, g, g / norm * self.max_norm) for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g.to(p.dtype)
        self.adamw.param_groups[0]["lr"] = float(self.schedule(self.count))
        self.adamw.step()
        for p in self.params:
            p.grad = None
        if self.acc is not None:
            self.acc = [torch.zeros_like(a) for a in self.acc]
            self.mini_step = 0
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count, "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        acc = state["acc"]
        self.acc = None if acc is None else [a.to(p.device, p.dtype) for a, p in zip(acc, self.params)]


def make_optimizer(
    params: Iterable[nn.Parameter],
    schedule: Schedule,
    b1: float = 0.9,
    b2: float = 0.98,
    eps: float = 1e-9,
    max_norm: Optional[float] = 0.1,
    weight_decay: float = 0.01,
    accum_steps: int = 1,
    norm: Callable[[Sequence[torch.Tensor]], torch.Tensor] = global_norm,
) -> Optimizer:
    """The JAX ``make_optimizer``'s defaults: the CFM trainer's betas, eps and clip."""
    return Optimizer(params, schedule, b1, b2, eps, max_norm, weight_decay, accum_steps, norm)


@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds: the step, the modules (parameters and buffers,
    the spectral-norm ``u`` among them) and the optimizers (AdamW moments,
    update count, accumulation state)."""

    step: int
    modules: Dict[str, nn.Module]
    optimizers: Dict[str, Optimizer]

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "modules": {k: m.state_dict() for k, m in self.modules.items()},
            "optimizers": {k: o.state_dict() for k, o in self.optimizers.items()},
        }

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        for k, m in self.modules.items():
            m.load_state_dict(state["modules"][k])
        for k, o in self.optimizers.items():
            o.load_state_dict(state["optimizers"][k])
