"""Parallelism surface: the mesh axes and the layouts over torch.distributed.

Counterpart of speech_resynth_tpu/parallel/__init__.py, one process per
device (torchrun, or ``distributed_init``), a (data, model) ``Mesh`` of
process groups (``make_mesh``):

* DP: each process steps on its rows of the global batch
  (``local_batch_slice`` / ``shard_batch``) and the trainers all-reduce the
  gradients over the ``data`` group.
* TP: ``tensor_parallel_rules`` shards the Llama attention and MLP
  column / row-parallel over ``model`` (DTensor).
* FSDP: ``fsdp_rules`` shards the parameters over ``data`` (FSDP2), composed
  with TP when asked.
* SP: ``SpeechLMTrainerConfig(sequence_parallel=True)`` keeps hidden states
  sequence-sharded over ``model`` between layers.
* PP: ``spmd_pipeline`` / ``pipelined_llama_loss_fn``, a GPipe microbatch
  pipeline over ``model`` (send / recv between neighbouring stages), and
  ``pp_param_shardings``, the stage that owns each parameter.

The JAX package's GSPMD placement helpers (``data_sharded``, ``replicate``,
``replicated``) have no counterpart: a process holds its own tensors here.
"""

from ..core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    distributed_init,
    local_batch_slice,
    make_mesh,
    shard_batch,
)
from .pipeline import pipelined_llama_loss_fn, pp_param_shardings, spmd_pipeline
from .sharding import fsdp_rules, tensor_parallel_rules

__all__ = [
    "pipelined_llama_loss_fn",
    "pp_param_shardings",
    "spmd_pipeline",
    "DATA_AXIS",
    "MODEL_AXIS",
    "distributed_init",
    "fsdp_rules",
    "local_batch_slice",
    "make_mesh",
    "shard_batch",
    "tensor_parallel_rules",
]
