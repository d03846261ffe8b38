"""Fused HiFi-GAN MRF: the branch kernel (K2), the whole-stage kernel (K3) and their plain versions.

Counterpart of speech_resynth_tpu/ops/fused_mrf.py. One branch of a
multi-receptive-field residual block: for each dilation d,

    x += conv_K(lrelu(conv_{K,d}(lrelu(x)) + b1)) + b2

with SAME padding (zeros outside the sequence at every conv). One stage is
the mean of its branches over the same input; K3 computes it in one launch,
and the generator takes that route while ``MRF_STAGE_FUSION`` is set (see
``mrf_stage_fusion``). The port holds activations as (B, C, T) and weights in
torch layout (n_pairs, C_out, C_in, K). The TPU kernels' phase fold and
block-Toeplitz weights are MXU layouts and are not carried over.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .build import check_launch, kernel_library

LRELU_SLOPE = 0.1

# Kernel geometry (csrc/fused_mrf.cu): a block's window holds WINDOW_ELEMS / C
# columns of all C channels; the channel counts it is instantiated for.
WINDOW_ELEMS = 16384
KERNEL_CHANNELS = (16, 32, 64)
MAX_SHARED_BYTES = 232_448  # what one Hopper block may use
MAX_STAGE_BRANCHES = 4  # csrc/fused_mrf.cu: MAX_BRANCHES

# Whole-stage fusion (K3) in the generator. Off by default, as the JAX package
# ships it; whether this card wants it on is for a measurement to decide.
MRF_STAGE_FUSION: bool = False

# One branch as the stage functions take it: (w1, b1, w2, b2, dilations).
Branch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, Tuple[int, ...]]


@contextlib.contextmanager
def mrf_stage_fusion(enabled: bool):
    """Route the generator's narrow stages through K3 (``True``) or through
    three K2 launches and a mean (``False``) while active."""
    global MRF_STAGE_FUSION
    prev, MRF_STAGE_FUSION = MRF_STAGE_FUSION, enabled
    try:
        yield
    finally:
        MRF_STAGE_FUSION = prev


def branch_halo(kernel_size: int, dilations: Sequence[int]) -> int:
    """Per-side receptive-field growth of the branch's conv chain (samples)."""
    h = 0
    for d in dilations:
        h += (kernel_size * d - d) // 2  # dilated conv pad
        h += (kernel_size - 1) // 2  # unit conv pad
    return h


def _branch_chain_f32(x, w1, b1, w2, b2, dilations, slope) -> torch.Tensor:
    """The branch's residual chain in f32: each conv's operands rounded to x's
    dtype, products summed in f32."""
    dtype = x.dtype
    K = w1.shape[-1]

    def operand(t):
        return t.to(dtype).float()

    h_res = x.float()
    for j, d in enumerate(dilations):
        h = F.conv1d(operand(F.leaky_relu(h_res, slope)), w1[j].float(), b1[j].float(), padding=(K * d - d) // 2, dilation=d)
        h = F.conv1d(operand(F.leaky_relu(h, slope)), w2[j].float(), b2[j].float(), padding=(K - 1) // 2)
        h_res = h_res + h
    return h_res


def mrf_branch_reference(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    dilations: Tuple[int, ...],
    slope: float = LRELU_SLOPE,
) -> torch.Tensor:
    """Plain version of K2 on (B, C, T). w1/w2: (n_pairs, C, C, K);
    b1/b2: (n_pairs, C). Each conv's operands are rounded to x's dtype and
    the products summed in f32; the residual chain is f32; the result is in
    x's dtype (the kernel's numerics)."""
    return _branch_chain_f32(x, w1, b1, w2, b2, dilations, slope).to(x.dtype)


def mrf_stage_reference(x: torch.Tensor, branches: Sequence[Branch], slope: float = LRELU_SLOPE) -> torch.Tensor:
    """Plain version of K3 on (B, C, T): every branch's f32 chain as in
    ``mrf_branch_reference``, summed in f32 in branch order, multiplied by
    1/n and rounded to x's dtype once (the JAX stage kernel's numerics; the
    per-branch route rounds each branch before its sum)."""
    total = None
    for w1, b1, w2, b2, dilations in branches:
        y = _branch_chain_f32(x, w1, b1, w2, b2, dilations, slope)
        total = y if total is None else total + y
    return (total * (1.0 / len(branches))).to(x.dtype)


def mrf_stage_tile(channels: int, branch_shapes: Sequence[Tuple[int, Sequence[int]]], itemsize: int) -> Tuple[int, int, int]:
    """(t_tile, window, shared bytes) of one block of K3 (K2 is its one-branch
    case), as csrc/fused_mrf.cu lays it out: a window of WINDOW_ELEMS / C
    columns holding the tile and the largest branch halo on each side, an f32
    residual buffer, the conv operand with zero margins of the largest conv
    pad, and the weights of one conv of the widest branch. ``branch_shapes``:
    (K, dilations) per branch. Raises for shapes the kernels do not take."""
    if channels not in KERNEL_CHANNELS:
        raise ValueError(f"fused MRF kernels are built for C in {KERNEL_CHANNELS}, got C={channels}")
    if not 1 <= len(branch_shapes) <= MAX_STAGE_BRANCHES:
        raise ValueError(f"fused MRF stage takes 1 to {MAX_STAGE_BRANCHES} branches, got {len(branch_shapes)}")
    for K, dilations in branch_shapes:
        if K % 2 == 0:
            raise ValueError(f"fused MRF kernels require an odd kernel size, got K={K}")
        if not 1 <= len(dilations) <= 3:
            raise ValueError(f"fused MRF kernels take 1 to 3 conv pairs, got {len(dilations)}")
    window = WINDOW_ELEMS // channels
    halo = max(branch_halo(K, dilations) for K, dilations in branch_shapes)
    t_tile = window - 2 * halo
    if t_tile < 32:
        raise ValueError(
            f"fused MRF (C={channels}, branches {[(K, tuple(d)) for K, d in branch_shapes]}) has a halo too wide "
            f"for its {window}-column window"
        )
    margin = max((K - 1) * d // 2 for K, dilations in branch_shapes for d in dilations)
    k_max = max(K for K, _ in branch_shapes)
    rows = window + 2 * margin  # the conv operand's columns, with zero margins past both ends
    if itemsize == 2:  # tensor cores: time-major f32 residual, bf16 operand and weights, padded rows
        shared = 4 * window * (channels + 4) + 2 * (rows + k_max * channels) * (channels + 8)
    else:
        shared = 4 * channels * (window + channels + rows)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"fused MRF needs {shared} bytes of shared memory, more than a block may use")
    return t_tile, window, shared


def mrf_tile(channels: int, kernel_size: int, dilations: Sequence[int], itemsize: int) -> Tuple[int, int, int]:
    """(t_tile, window, shared bytes) of one block of K2; raises for shapes
    the kernel does not take."""
    return mrf_stage_tile(channels, [(kernel_size, dilations)], itemsize)


def mrf_stage_fits(channels: int, branch_shapes: Sequence[Tuple[int, Sequence[int]]], itemsize: int) -> bool:
    """Whether K3 takes this stage (counterpart of ``fused_stage_fits``)."""
    try:
        mrf_stage_tile(channels, branch_shapes, itemsize)
    except ValueError:
        return False
    return True


def mrf_branch(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    dilations: Tuple[int, ...],
    slope: float = LRELU_SLOPE,
) -> torch.Tensor:
    """One MRF branch on (B, C, T): the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if not x.is_cuda:
        return mrf_branch_reference(x, w1, b1, w2, b2, dilations, slope)
    return mrf_branch_kernel(x, w1, b1, w2, b2, dilations, slope)


def mrf_stage(x: torch.Tensor, branches: Sequence[Branch], slope: float = LRELU_SLOPE) -> torch.Tensor:
    """One whole MRF stage on (B, C, T): the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if not x.is_cuda:
        return mrf_stage_reference(x, branches, slope)
    return mrf_stage_kernel(x, branches, slope)


def _check_kernel_operands(name: str, x: torch.Tensor, branches: Sequence[Branch]) -> None:
    B, C, T = x.shape
    for w1, b1, w2, b2, dilations in branches:
        n_pairs, K = len(dilations), w1.shape[-1]
        if w1.shape != (n_pairs, C, C, K) or w2.shape != w1.shape or b1.shape != (n_pairs, C) or b2.shape != b1.shape:
            raise ValueError(f"weights do not match x (B, {C}, T) and {n_pairs} pairs: {tuple(w1.shape)}, {tuple(b1.shape)}")
        if x.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != x.dtype for t in (w1, b1, w2, b2)):
            raise ValueError(f"{name} kernel wants x and weights of one dtype, f32 or bf16")
        if not all(t.is_cuda for t in (x, w1, b1, w2, b2)):
            raise ValueError(f"{name} kernel launches on the card: every tensor must be a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError(f"{name} kernel wants a contiguous x")


def _tap_major(w: torch.Tensor) -> torch.Tensor:
    """(pairs, C_out, C_in, K) -> (pairs, K, C_out, C_in): the kernels stage a
    conv's weights tap by tap with coalesced reads."""
    return w.permute(0, 3, 1, 2).contiguous()


def mrf_branch_kernel(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    dilations: Tuple[int, ...],
    slope: float = LRELU_SLOPE,
) -> torch.Tensor:
    """Launch K2 on CUDA tensors; raises on anything it does not take."""
    _check_kernel_operands("fused MRF", x, [(w1, b1, w2, b2, dilations)])
    B, C, T = x.shape
    n_pairs, K = len(dilations), w1.shape[-1]
    t_tile, _, _ = mrf_tile(C, K, dilations, x.element_size())
    w1t, w2t = _tap_major(w1), _tap_major(w2)
    b1c, b2c = b1.contiguous(), b2.contiguous()
    d = list(dilations) + [1] * (3 - n_pairs)
    out = torch.empty_like(x)
    err = kernel_library().srt_mrf_branch(
        x.data_ptr(),
        w1t.data_ptr(),
        b1c.data_ptr(),
        w2t.data_ptr(),
        b2c.data_ptr(),
        out.data_ptr(),
        B,
        C,
        T,
        K,
        n_pairs,
        d[0],
        d[1],
        d[2],
        t_tile,
        int(x.dtype == torch.bfloat16),
        float(slope),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch("mrf_branch", err)
    mrf_branch_kernel.launches += 1
    return out


mrf_branch_kernel.launches = 0


def mrf_stage_kernel(x: torch.Tensor, branches: Sequence[Branch], slope: float = LRELU_SLOPE) -> torch.Tensor:
    """Launch K3 on CUDA tensors: every branch of one stage and their mean;
    raises on anything it does not take."""
    _check_kernel_operands("MRF stage", x, branches)
    B, C, T = x.shape
    shapes = [(w1.shape[-1], tuple(dilations)) for w1, _, _, _, dilations in branches]
    t_tile, _, _ = mrf_stage_tile(C, shapes, x.element_size())
    w1s = torch.cat([_tap_major(w1).flatten() for w1, _, _, _, _ in branches])
    w2s = torch.cat([_tap_major(w2).flatten() for _, _, w2, _, _ in branches])
    b1s = torch.cat([b1.flatten() for _, b1, _, _, _ in branches])
    b2s = torch.cat([b2.flatten() for _, _, _, b2, _ in branches])
    spec = []
    for K, dilations in shapes:
        spec += [K, len(dilations), *dilations, *[1] * (3 - len(dilations))]
    spec_arr = (ctypes.c_int * len(spec))(*spec)
    out = torch.empty_like(x)
    err = kernel_library().srt_mrf_stage(
        x.data_ptr(),
        w1s.data_ptr(),
        b1s.data_ptr(),
        w2s.data_ptr(),
        b2s.data_ptr(),
        out.data_ptr(),
        B,
        C,
        T,
        len(branches),
        spec_arr,
        t_tile,
        int(x.dtype == torch.bfloat16),
        float(slope),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch("mrf_stage", err)
    mrf_stage_kernel.launches += 1
    return out


mrf_stage_kernel.launches = 0
