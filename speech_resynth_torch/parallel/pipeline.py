"""Pipeline parallelism: a GPipe schedule over the model axis
(counterpart of speech_resynth_tpu/parallel/pipeline.py).

The model axis's S processes are the stages. Stage s holds the L/S
consecutive layers ``pp_stage_layers`` gives it (``pipeline_stage`` drops the
others from its model, keeping the global names); the embedding, the final
norm and the LM head are replicated on every stage. ``spmd_pipeline`` runs M
microbatches forward through the stages with blocking send/recv between
neighbours, so stage s works on microbatch t - s at tick t: M + S - 1 ticks,
a bubble of (S - 1) / (M + S - 1). The last stage gathers the M outputs,
applies the norm, the head and the loss to the whole (local) batch, as the
JAX loss does, and the backward runs the schedule in reverse: each stage
receives its outputs' gradients, back-propagates through its layers and sends
its inputs' gradients on. Where the JAX package differentiates through a
``ppermute`` scan, this schedule drives autograd stage by stage.

The replicated parameters' gradients arise on one stage each (the
embedding's on the first, the norm's and the head's on the last) and are
summed over the stages, so every stage applies the same update to its copy.
With a data axis > 1 each data replica runs the pipeline on its rows and its
gradients of the global loss are summed over the data axis.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..core.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from ..train.common import all_reduce_gradients

LAYER_PREFIX = "model.layers."


def pp_stage_layers(num_layers: int, stages: int, stage: int) -> range:
    """The global indices of the layers stage ``stage`` of ``stages`` holds."""
    if num_layers % stages != 0:
        raise ValueError(f"{num_layers} layers not divisible into {stages} stages")
    per = num_layers // stages
    return range(stage * per, (stage + 1) * per)


def pp_param_shardings(mesh: Mesh, model: nn.Module) -> Dict[str, Optional[int]]:
    """For each parameter of a full ``LlamaLM``, the stage that holds it, or
    None where every stage holds a copy (the embedding, the norm, the head)."""
    stages = mesh.shape[MODEL_AXIS]
    owner = {}
    for s in range(stages):
        for i in pp_stage_layers(model.config.num_hidden_layers, stages, s):
            owner[i] = s
    return {
        name: owner[int(name[len(LAYER_PREFIX) :].split(".")[0])] if name.startswith(LAYER_PREFIX) else None
        for name, _ in model.named_parameters()
    }


def pipeline_stage(model: nn.Module, mesh: Mesh) -> nn.Module:
    """``model`` reduced in place to what this process's stage holds: its
    layers stay under their global names (``model.layers.<i>``), in a
    ``ModuleDict``, so ``LlamaLM.forward`` no longer applies to it."""
    own = pp_stage_layers(model.config.num_hidden_layers, mesh.shape[MODEL_AXIS], mesh.local_rank(MODEL_AXIS))
    model.model.layers = nn.ModuleDict({str(i): model.model.layers[i] for i in own})
    return model


def _stage_ranks(mesh: Mesh) -> List[int]:
    return dist.get_process_group_ranks(mesh.group(MODEL_AXIS))


def spmd_pipeline(stage_fn: Callable, xs: Optional[List[torch.Tensor]], extras: List[torch.Tensor], mesh: Mesh, shape, dtype) -> List:
    """The forward of the schedule on this stage: microbatch m enters as
    ``xs[m]`` on stage 0 (``xs`` is None elsewhere) and as activations of
    ``shape`` and ``dtype`` received from the previous stage elsewhere;
    ``stage_fn(x, extras[m])`` applies the stage's layers (``extras``: one
    tensor per microbatch, on the stage's device). Returns [(input, output)]
    per microbatch; the last stage's outputs are the results, the others
    were sent on."""
    S, s = mesh.shape[MODEL_AXIS], mesh.local_rank(MODEL_AXIS)
    ranks = _stage_ranks(mesh)
    pairs = []
    for m, extra in enumerate(extras):
        if s == 0:
            x = xs[m]
        else:
            x = torch.empty(shape, dtype=dtype, device=extra.device)
            dist.recv(x, src=ranks[s - 1])
            x.requires_grad_(True)
        y = stage_fn(x, extra)
        if s < S - 1:
            dist.send(y.detach().contiguous(), dst=ranks[s + 1])
        pairs.append((x, y))
    return pairs


def spmd_pipeline_backward(pairs: List, mesh: Mesh) -> None:
    """The backward of the schedule, microbatches in reverse: on every stage
    but the last (whose loss.backward() already ran) receive the outputs'
    gradients and back-propagate; on every stage but the first send the
    inputs' gradients back."""
    S, s = mesh.shape[MODEL_AXIS], mesh.local_rank(MODEL_AXIS)
    ranks = _stage_ranks(mesh)
    for x, y in reversed(pairs):
        if s < S - 1:
            g = torch.empty_like(y)
            dist.recv(g, src=ranks[s + 1])
            y.backward(g)
        if s > 0:
            dist.send(x.grad.contiguous(), dst=ranks[s - 1])


def pipelined_llama_loss_fn(config, mesh: Mesh, num_microbatches: int, policy=None, attn_implementation: str = "xla"):
    """``loss_and_backward(model, batch) -> loss``: the GPipe forward and
    backward of a stage model (``pipeline_stage``) on this process's rows of
    the batch, split into ``num_microbatches``. It leaves every gradient of
    the step in ``.grad`` and returns the loss of the whole global batch, the
    mean over its valid tokens, on every process. Each data replica's loss is
    its share of that mean (its tokens' sum over the global count), so the
    gradients are summed over the data axis; the replicated parameters' are
    summed over the stages too.

    Raises ``ValueError`` for layers not divisible into the stages and for a
    batch not divisible into the microbatches, as the JAX function does."""
    from ..core.precision import DEFAULT
    from ..models.llama import _rope_tables, causal_lm_loss_terms

    policy = policy or DEFAULT
    S = mesh.shape[MODEL_AXIS]
    if config.num_hidden_layers % S != 0:
        raise ValueError(f"{config.num_hidden_layers} layers not divisible into {S} stages")
    M = num_microbatches
    data_group = mesh.group(DATA_AXIS) if mesh.shape[DATA_AXIS] > 1 else None

    def loss_and_backward(model: nn.Module, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        ids = batch["input_ids"]
        B, L = ids.shape
        if B % M:
            raise ValueError(f"batch {B} not divisible by num_microbatches={M}")
        s = mesh.local_rank(MODEL_AXIS)
        mask = batch.get("attention_mask")
        mask = torch.ones_like(ids, dtype=torch.bool) if mask is None else mask.bool()
        rope = _rope_tables(torch.arange(L, device=ids.device), config.head_dim, config.rope_theta)
        layers = list(model.model.layers.values())
        for layer in layers:
            layer.attn_implementation = attn_implementation

        def stage_fn(x, m):
            for layer in layers:
                x = layer(x, rope, m)
            return x

        cd = policy.compute_dtype
        xs = [model.model.embed_tokens(c).to(cd) for c in ids.chunk(M)] if s == 0 else None
        pairs = spmd_pipeline(stage_fn, xs, list(mask.chunk(M)), mesh, (B // M, L, config.hidden_size), cd)

        nll = torch.zeros((), device=ids.device)
        count = (batch["labels"][:, 1:] != -100).sum()
        if data_group is not None:
            dist.all_reduce(count, group=data_group)
        if s == S - 1:
            logits = model.lm_head(model.model.norm(torch.cat([y for _, y in pairs])))
            nll, _ = causal_lm_loss_terms(logits, batch["labels"])
            (nll / torch.clamp(count, min=1)).backward()
            nll = nll.detach()
        spmd_pipeline_backward(pairs, mesh)

        for name, p in model.named_parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if not name.startswith(LAYER_PREFIX):
                dist.all_reduce(p.grad, group=mesh.group(MODEL_AXIS))
        all_reduce_gradients([p.grad for p in model.parameters()], data_group)
        dist.all_reduce(nll, group=mesh.group(MODEL_AXIS))
        if data_group is not None:
            dist.all_reduce(nll, group=data_group)
        return nll / torch.clamp(count, min=1)

    return loss_and_backward


def pipeline_grad_norm(mesh: Mesh, names: List[str]) -> Callable:
    """The global gradient norm of a stage's parameters (``names`` aligned
    with the gradients): its layers' squares summed over the stages, the
    replicated parameters' counted once."""

    def norm(grads) -> torch.Tensor:
        layers = sum(torch.sum(g.float() ** 2) for n, g in zip(names, grads) if n.startswith(LAYER_PREFIX))
        rest = sum(torch.sum(g.float() ** 2) for n, g in zip(names, grads) if not n.startswith(LAYER_PREFIX))
        layers = torch.as_tensor(layers, dtype=torch.float32, device=grads[0].device)
        dist.all_reduce(layers, group=mesh.group(MODEL_AXIS))
        return torch.sqrt(layers + rest)

    return norm
