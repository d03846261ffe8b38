"""The program's hand-written kernels as the trace names them, and the
operations and bytes each launch needs (what its roofline share divides by).

Frozen copies of ``chip_smoke.py``'s grouping (``KERNEL_GROUPS``,
``kernel_group``) and of its per-launch counts (``attention_shape``,
``stage_path``, ``codebook_shape``). Bytes count each input read once and
each output written once; operations count what these inputs need.
"""

from __future__ import annotations

from typing import Sequence

from .peaks import PEAK_BF16_FLOPS, PEAK_TF32_FLOPS, bound_s

K1, K2, K3, K4 = "flash_attention (K1)", "mrf_branch (K2)", "mrf_stage (K3)", "codebook_assign (K4)"
ELEMENTWISE = "other (elementwise, copies)"

KERNEL_GROUPS = (
    (K1, ("flash_fwd",)),
    (K4, ("codebook_assign", "unpack_ids")),
    (K3, ("mrf_stage",)),  # the f32 stage kernel (also K2's f32 variant)
    # cuDNN's conv kernels are implicit GEMMs ("fprop_implicit_gemm"), so they are matched first
    ("conv (cuDNN)", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit", "winograd", "fft")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "nvjet")),  # nvjet: cuBLASLt's Hopper GEMM kernels
)


def kernel_group(name: str) -> str:
    """The group of a device operation by its name. K2's and K3's bf16
    kernels are the two instances of one template, mrf_block_bf16_kernel<C,
    STAGE>: STAGE true (mangled "Lb1E") is K3."""
    name = name.lower()
    if "mrf_block" in name:
        return K3 if "true>" in name or "lb1e" in name else K2
    return next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), ELEMENTWISE)


def k1_cost(batch: int, heads: int, n: int, head_dim: int, key_lengths: Sequence[int]) -> tuple:
    """(operations, bytes) of one bf16 K1 launch on (batch, heads, n, head_dim)
    with a key mask of ``key_lengths`` valid keys a row: every query (padded
    ones too) against its row's valid keys; q and o, the K and V rows of the
    valid keys, and the mask."""
    valid = int(sum(key_lengths))
    flops = 4.0 * heads * head_dim * n * valid
    nbytes = 2 * batch * heads * n * head_dim * 2 + 2 * heads * head_dim * 2 * valid + batch * n
    return flops, float(nbytes)


def k1_bound_s(batch: int, heads: int, n: int, head_dim: int, key_lengths: Sequence[int]) -> float:
    return bound_s(*k1_cost(batch, heads, n, head_dim, key_lengths), PEAK_BF16_FLOPS)


def mrf_stage_cost(batch: int, channels: int, length: int, kernel_sizes: Sequence[int], dilations: Sequence[Sequence[int]]) -> tuple:
    """(operations, bytes) of one MRF stage's branches in bf16: per branch and
    dilation two convs of 2 K C^2 T B; the stage's input read once, its output
    written once, every branch's weights and biases read once."""
    flops = sum(4.0 * len(d) * k * channels * channels * length * batch for k, d in zip(kernel_sizes, dilations))
    nbytes = 2 * batch * channels * length * 2 + sum(2 * len(d) * (channels * channels * k + channels) * 2 for k, d in zip(kernel_sizes, dilations))
    return flops, float(nbytes)


def mrf_stage_bound_s(batch: int, channels: int, length: int, kernel_sizes, dilations) -> float:
    return bound_s(*mrf_stage_cost(batch, channels, length, kernel_sizes, dilations), PEAK_BF16_FLOPS)


def k4_cost(n: int, dim: int, centers: int) -> tuple:
    """(operations, bytes) of one K4 launch in 3xTF32: three TF32 products of
    (n, dim) x (dim, centers); frames and centers read once, ids written."""
    return 3 * 2.0 * n * dim * centers, float(4 * (n * dim + centers * dim) + 4 * n)


def k4_bound_s(n: int, dim: int, centers: int) -> float:
    return bound_s(*k4_cost(n, dim, centers), PEAK_TF32_FLOPS)
