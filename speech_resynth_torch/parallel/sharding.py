"""Parameter layouts over the (data, model) mesh: tensor parallelism and FSDP
(counterpart of speech_resynth_tpu/parallel/sharding.py).

* ``tensor_parallel_rules``: the JAX package's Megatron layout of the Llama
  as a ``parallelize_module`` plan over the model axis: ``q_proj``,
  ``k_proj``, ``v_proj``, ``gate_proj`` and ``up_proj`` column-wise,
  ``o_proj`` and ``down_proj`` row-wise (one all-reduce per pair), the
  embedding sharded on its vocab rows and the LM head on its output (vocab)
  dim, everything else replicated. With ``sequence_parallel`` the hidden
  states between the projection pairs stay sharded on the sequence: the
  norms take the ``SequenceParallel`` style and the pairs all-gather before
  and reduce-scatter after (the JAX ``hidden_sharding`` P(data, model)).
* ``fsdp_rules``: FSDP2 ``fully_shard`` over the data axis of every module
  whose own weight reaches ``min_size`` elements, then of the root, which
  takes the small rest (the norm gains; the JAX rule replicates them, here
  they are one group gathered once a step). Composes with TP on the 2-D
  mesh. FSDP2 shards a weight's first dim (the JAX rule its largest
  divisible one): the layout differs, the numbers do not.

A model axis of 1 gives an empty plan: pure data parallelism.
"""

from __future__ import annotations

from typing import Dict

from torch import nn

from ..core.mesh import DATA_AXIS, MODEL_AXIS, Mesh

COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW = ("o_proj", "down_proj")


def tensor_parallel_rules(mesh: Mesh, model: nn.Module, sequence_parallel: bool = False) -> Dict[str, object]:
    """The ``parallelize_module`` plan of a ``LlamaLM`` over ``mesh``'s model
    axis ({} when it is 1)."""
    if mesh.shape[MODEL_AXIS] == 1:
        return {}
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel, SequenceParallel

    seq = Shard(1) if sequence_parallel else Replicate()
    plan: Dict[str, object] = {
        "model.embed_tokens": RowwiseParallel(input_layouts=Replicate(), output_layouts=seq),
        "lm_head": ColwiseParallel(input_layouts=seq, output_layouts=Replicate()),
    }
    if sequence_parallel:
        plan["model.norm"] = SequenceParallel()
    for i in range(len(model.model.layers)):
        base = f"model.layers.{i}"
        for name in COLUMN:
            owner = "self_attn" if name in ("q_proj", "k_proj", "v_proj") else "mlp"
            plan[f"{base}.{owner}.{name}"] = ColwiseParallel(input_layouts=seq)
        plan[f"{base}.self_attn.o_proj"] = RowwiseParallel(output_layouts=seq)
        plan[f"{base}.mlp.down_proj"] = RowwiseParallel(output_layouts=seq)
        if sequence_parallel:
            plan[f"{base}.input_layernorm"] = SequenceParallel()
            plan[f"{base}.post_attention_layernorm"] = SequenceParallel()
    return plan


def apply_tensor_parallel(model: nn.Module, mesh: Mesh, sequence_parallel: bool = False) -> nn.Module:
    """``model`` with ``tensor_parallel_rules`` applied in place (unchanged at model = 1)."""
    plan = tensor_parallel_rules(mesh, model, sequence_parallel)
    if plan:
        from torch.distributed.tensor.parallel import parallelize_module

        parallelize_module(model, mesh[MODEL_AXIS], plan)
    return model


def fsdp_rules(mesh: Mesh, model: nn.Module, min_size: int = 2**16, tp: bool = False, sequence_parallel: bool = False) -> nn.Module:
    """``model`` sharded in place over the data axis with FSDP2 (see the
    module doc); ``tp`` applies ``tensor_parallel_rules`` first. Gradients
    come back averaged over the data axis."""
    if tp:
        apply_tensor_parallel(model, mesh, sequence_parallel)
    from torch.distributed.fsdp import fully_shard

    data_mesh = mesh[DATA_AXIS]
    for module in model.modules():
        weight = getattr(module, "weight", None)
        if module is not model and weight is not None and weight.numel() >= min_size:
            fully_shard(module, mesh=data_mesh)
    fully_shard(model, mesh=data_mesh)
    return model
