"""Fused HiFi-GAN MRF branch: the hand-written kernel (K2) and its plain version.

Counterpart of speech_resynth_tpu/ops/fused_mrf.py. One branch of a
multi-receptive-field residual block: for each dilation d,

    x += conv_K(lrelu(conv_{K,d}(lrelu(x)) + b1)) + b2

with SAME padding (zeros outside the sequence at every conv). The port holds
activations as (B, C, T) and weights in torch layout (n_pairs, C_out, C_in, K).
The TPU kernel's phase fold and block-Toeplitz weights are MXU layouts and are
not carried over.
"""

from __future__ import annotations

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


def branch_halo(kernel_size: int, dilations: Sequence[int]) -> int:
    """Per-side receptive-field growth of the branch's conv chain (samples)."""
    h = 0
    for d in dilations:
        h += (kernel_size * d - d) // 2  # dilated conv pad
        h += (kernel_size - 1) // 2  # unit conv pad
    return h


def mrf_branch_reference(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    dilations: Tuple[int, ...],
    slope: float = LRELU_SLOPE,
) -> torch.Tensor:
    """Plain version of the kernel on (B, C, T). w1/w2: (n_pairs, C, C, K);
    b1/b2: (n_pairs, C). Each conv's operands are rounded to x's dtype and
    the products summed in f32; the residual chain is f32; the result is in
    x's dtype (the kernel's numerics)."""
    dtype = x.dtype
    K = w1.shape[-1]

    def operand(t):
        return t.to(dtype).float()

    h_res = x.float()
    for j, d in enumerate(dilations):
        h = F.conv1d(operand(F.leaky_relu(h_res, slope)), w1[j].float(), b1[j].float(), padding=(K * d - d) // 2, dilation=d)
        h = F.conv1d(operand(F.leaky_relu(h, slope)), w2[j].float(), b2[j].float(), padding=(K - 1) // 2)
        h_res = h_res + h
    return h_res.to(dtype)


def mrf_tile(channels: int, kernel_size: int, dilations: Sequence[int], itemsize: int) -> Tuple[int, int, int]:
    """(t_tile, window, shared bytes) of one kernel block, as csrc/fused_mrf.cu
    lays it out; raises for shapes the kernel does not take."""
    if channels not in KERNEL_CHANNELS:
        raise ValueError(f"fused MRF kernel is built for C in {KERNEL_CHANNELS}, got C={channels}")
    if kernel_size % 2 == 0:
        raise ValueError(f"fused MRF kernel requires an odd kernel size, got K={kernel_size}")
    if not 1 <= len(dilations) <= 3:
        raise ValueError(f"fused MRF kernel takes 1 to 3 conv pairs, got {len(dilations)}")
    window = WINDOW_ELEMS // channels
    t_tile = window - 2 * branch_halo(kernel_size, dilations)
    if t_tile < 32:
        raise ValueError(
            f"fused MRF branch (C={channels}, K={kernel_size}, dilations={tuple(dilations)}) has a halo too wide "
            f"for its {window}-column window"
        )
    margin = max((kernel_size - 1) * d // 2 for d in dilations)
    rows = window + 2 * margin  # the conv operand's columns, with zero margins past both ends
    if itemsize == 2:  # tensor-core kernel: time-major f32 residual, bf16 operand and weights, padded rows
        shared = 4 * window * (channels + 4) + 2 * (rows + kernel_size * channels) * (channels + 8)
    else:
        shared = 4 * channels * (window + channels + rows)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"fused MRF branch needs {shared} bytes of shared memory, more than a block may use")
    return t_tile, window, shared


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


def mrf_branch_kernel(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    dilations: Tuple[int, ...],
    slope: float = LRELU_SLOPE,
) -> torch.Tensor:
    """Launch the fused MRF kernel on CUDA tensors; raises on anything it does not take."""
    B, C, T = x.shape
    n_pairs, K = len(dilations), w1.shape[-1]
    if w1.shape != (n_pairs, C, C, K) or w2.shape != w1.shape or b1.shape != (n_pairs, C) or b2.shape != b1.shape:
        raise ValueError(f"weights do not match x (B, {C}, T) and {n_pairs} pairs: {tuple(w1.shape)}, {tuple(b1.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != x.dtype for t in (w1, b1, w2, b2)):
        raise ValueError("fused MRF kernel wants x and weights of one dtype, f32 or bf16")
    if not all(t.is_cuda for t in (x, w1, b1, w2, b2)):
        raise ValueError("fused MRF kernel launches on the card: every tensor must be a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError("fused MRF kernel wants a contiguous x")
    t_tile, _, _ = mrf_tile(C, K, dilations, x.element_size())
    # (pairs, C_out, C_in, K) -> (pairs, K, C_out, C_in): the kernel stages a conv's
    # weights tap by tap with coalesced reads
    w1t = w1.permute(0, 3, 1, 2).contiguous()
    w2t = w2.permute(0, 3, 1, 2).contiguous()
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
