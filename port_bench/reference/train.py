"""Plain PyTorch reference of the CFM trainer's step: the masked velocity MSE
of ``resynth.cfm_loss_terms``, its gradient by autograd, the global-norm clip
(gradients scaled by max_norm / norm where the norm reaches max_norm), the
warm-up then linear-decay schedule and AdamW with decoupled weight decay,
written from the reference repository's trainer. Imports nothing of the
program; f32 unless a lower ``Precision`` is given (the control)."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import resynth as ref


def learning_rate(step: int, total: int, warmup: int, base: float, low: float) -> float:
    """low -> base over ``warmup`` updates, then linearly base -> low at ``total``."""
    if step < warmup:
        return low + (base - low) * step / max(warmup, 1)
    return low + (base - low) * (1 - (step - warmup) / max(total - warmup, 1))


def loss_and_grads(w: Dict[str, torch.Tensor], trainable: List[str], fm: dict, batch: dict, x0, times, p, rows: int):
    """(loss, gradients of ``trainable``) of one batch, computed ``rows`` rows at
    a time: each block's squared error over the whole batch's frame count."""
    ids, labels = batch["input_ids"], batch["spectrogram_labels"]
    frames = torch.any(labels != -100, dim=-1).sum() * fm["dim_in"]
    grads = [torch.zeros_like(w[n]) for n in trainable]
    total = torch.zeros((), device=labels.device)
    for i in range(0, labels.shape[0], rows):
        sl = slice(i, i + rows)
        sq, _ = ref.cfm_loss_terms(w, fm, ids[sl], labels[sl], x0[sl], times[sl], p)
        part = sq / frames
        for g, d in zip(grads, torch.autograd.grad(part, [w[n] for n in trainable])):
            g += d
        total += part.detach()
    return total, grads


def steps(w0: Dict[str, torch.Tensor], trainable: List[str], fm: dict, batches, noises, n: int, total_steps: int,
          p=ref.F32, rows: int = 900, start=None):
    """``n`` trainer steps from the weights ``w0`` and, where ``start`` gives
    it, AdamW's state ``(first moments, second moments, updates applied)``
    (else a fresh one): (losses, the first step's gradients after the clip,
    the weights after the n steps, AdamW's state after them)."""
    w = {k: v.detach().clone() for k, v in w0.items()}
    for name in trainable:
        w[name].requires_grad_(True)
    b1, b2, eps, wd = fm["adam_b1"], fm["adam_b2"], fm["adam_eps"], fm["weight_decay"]
    if start is None:
        m = {k: torch.zeros_like(w[k]) for k in trainable}
        v = {k: torch.zeros_like(w[k]) for k in trainable}
        t0 = 0
    else:
        m = {k: start[0][k].detach().clone() for k in trainable}
        v = {k: start[1][k].detach().clone() for k in trainable}
        t0 = start[2]
    losses, first = [], None
    for t in range(t0, t0 + n):
        x0, times = noises[t - t0]
        loss, grads = loss_and_grads(w, trainable, fm, batches[t - t0], x0, times, p, rows)
        losses.append(float(loss))
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        if norm >= fm["max_norm"]:
            grads = [g / norm * fm["max_norm"] for g in grads]
        if first is None:
            first = {k: g.clone() for k, g in zip(trainable, grads)}
        lr = learning_rate(t, total_steps, fm["warmup_steps"], fm["lr"], fm["lr_min"])
        with torch.no_grad():
            for k, g in zip(trainable, grads):
                w[k].mul_(1 - lr * wd)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k].sqrt() / math.sqrt(1 - b2 ** (t + 1))).add_(eps)
                w[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** (t + 1)))
    return losses, first, {k: w[k].detach() for k in trainable}, (m, v, t0 + n)
