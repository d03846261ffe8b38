"""Process group and (data, model) mesh (counterpart of speech_resynth_tpu/core/mesh.py).

One process drives one device. The JAX package's ``jax.sharding.Mesh`` of
named axes becomes a ``torch.distributed`` ``DeviceMesh`` with the same axis
names over the process group (NCCL on the card, gloo on the CPU):

  data   the batch axis: gradients summed over it (``train.common.all_reduce_gradients``),
         or FSDP2 (``parallel.sharding.fsdp_rules``);
  model  tensor parallelism (``parallel.sharding.tensor_parallel_rules``) or
         pipeline stages (``parallel.pipeline``).

``distributed_init`` starts the process group from torchrun's variables and
is a no-op without them, so a single process needs none: ``make_mesh`` then
gives a 1 x 1 ``Mesh`` with no ``DeviceMesh`` behind it, and nothing runs a
collective. Every process takes part in a step, so a mesh covers all of them
(the JAX mesh may leave devices out).

The policies are pure functions: ``mesh_shape`` (the axes' sizes and their
errors), ``dp_batch_policy`` (the rounding of ``dp_mesh_for_batch``) and
``local_batch_slice`` (a process's rows of a global batch).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
TORCHRUN_VARIABLES = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def distributed_init(device: Optional[torch.device] = None) -> bool:
    """Start the process group when torchrun's ``RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR`` are set (NCCL for a CUDA ``device``, the default; gloo
    for the CPU), binding this process to card ``LOCAL_RANK``. A no-op
    without those variables or with a group already up. Returns whether a
    process group is up."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in TORCHRUN_VARIABLES):
        return False
    cuda = device is None or torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if cuda else "gloo")
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_shape(n: int, data: Optional[int] = None, model: int = 1) -> Tuple[int, int]:
    """(data, model) over ``n`` devices, with the JAX ``make_mesh``'s errors:
    ``data=None`` takes every device the model axis leaves."""
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    return data, model


class Mesh:
    """The (data, model) axes: ``shape`` by name, as the JAX mesh's, and the
    ``DeviceMesh`` over the process group (None on one process without one)."""

    def __init__(self, data: int, model: int, device_mesh=None):
        self.shape: Dict[str, int] = {DATA_AXIS: data, MODEL_AXIS: model}
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    def __getitem__(self, axis: str):
        """The one-axis ``DeviceMesh`` of ``axis`` (for parallelize_module, fully_shard)."""
        if self.device_mesh is None:
            raise ValueError(f"{self} has no DeviceMesh: one process without a process group")
        return self.device_mesh[axis]

    def group(self, axis: str):
        """This process's group along ``axis`` (None without a process group)."""
        return None if self.device_mesh is None else self.device_mesh.get_group(axis)

    def local_rank(self, axis: str) -> int:
        """This process's coordinate along ``axis``."""
        return 0 if self.device_mesh is None else self.device_mesh.get_local_rank(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The (data, model) mesh over every process (``mesh_shape``'s errors,
    and one more: a mesh must cover the process count, since every process
    takes part in a step)."""
    n = process_count()
    data, model = mesh_shape(n, data, model)
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} covers {data * model} of {n} processes; every process takes part in a step")
    if not dist.is_initialized():
        return Mesh(data, model)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(data, model, init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS)))


def dp_batch_policy(batch_size: int, n: int) -> Tuple[int, int]:
    """(data axis, global batch) for ``batch_size`` over ``n`` devices: the
    batch rounded down to a multiple of ``n`` when it is at least ``n``
    (dropping less than one device's worth of examples); otherwise the data
    axis shrunk to gcd(batch, n)."""
    if batch_size >= n:
        return n, (batch_size // n) * n
    return math.gcd(batch_size, n), batch_size


def dp_mesh_for_batch(batch_size: int) -> Tuple[Mesh, int]:
    """A data-parallel mesh and the global batch (``dp_batch_policy``). A
    data axis below the process count raises in ``make_mesh``."""
    data, batch = dp_batch_policy(batch_size, process_count())
    return make_mesh(data=data), batch


def local_batch_slice(global_batch_size: int, index: Optional[int] = None, count: Optional[int] = None) -> slice:
    """Rows ``[index * per, (index + 1) * per)`` of a global batch, per =
    global / count; by default this process's of all processes."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    per = global_batch_size // count
    return slice(index * per, index * per + per)


def data_coordinates(mesh: Mesh) -> Tuple[int, int]:
    """(index, count) of this process along the data axis: the batch
    iterator's process index and count. Processes that differ only on the
    model axis read the same rows. With model = 1 they are the process
    group's rank and size."""
    return mesh.local_rank(DATA_AXIS), mesh.shape[DATA_AXIS]


def shard_batch(batch: Dict[str, Any], mesh: Mesh, device: torch.device) -> Dict[str, torch.Tensor]:
    """This process's rows of a global batch (``data_coordinates``) as tensors
    on ``device``; entries that are not arrays are left out."""
    index, count = data_coordinates(mesh)
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            out[k] = torch.as_tensor(v[local_batch_slice(len(v), index, count)]).to(device)
    return out


def host_local_copy(tree):
    """A copy of a tree (dicts, lists, tuples) of tensors on the host, every
    ``DTensor`` gathered whole (``full_tensor``): a collective, so every
    process calls it, and then rank 0 alone writes files or validates."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: host_local_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_local_copy(v) for v in tree)
    if isinstance(tree, DTensor):
        return tree.full_tensor().detach().cpu()
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree
