"""Fused HiFi-GAN MRF: the branch kernel (K2), the whole-stage kernel (K3) and their plain versions.

Counterpart of speech_resynth_tpu/ops/fused_mrf.py. One branch of a
multi-receptive-field residual block: for each dilation d,

    x += conv_K(lrelu(conv_{K,d}(lrelu(x)) + b1)) + b2

with SAME padding (zeros outside the sequence at every conv). One stage is
the mean of its branches over the same input; K3 computes it in one launch,
and the generator takes that route while ``MRF_STAGE_FUSION`` is set (see
``mrf_stage_fusion``). Both kernels are instances of one bf16 block
(csrc/mrf_block.cuh). The port holds activations as (B, C, T) and weights in
torch layout (n_pairs, C_out, C_in, K). The TPU kernels' phase fold and
block-Toeplitz weights are MXU layouts and are not carried over.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .build import check_launch, kernel_library, refuse_grad

LRELU_SLOPE = 0.1

# The f32 geometry of K3 (csrc/fused_mrf.cu; also K2's f32 variant): a
# block's window holds WINDOW_ELEMS / C columns of all C channels; the channel
# counts the kernels are instantiated for.
WINDOW_ELEMS = 16384
KERNEL_CHANNELS = (16, 32, 64)
MAX_SHARED_BYTES = 232_448  # what one Hopper block may use
MAX_STAGE_BRANCHES = 4  # csrc/mrf_block.cuh: MAX_BRANCHES

# The bf16 block of K2 and K3 (csrc/mrf_block.cuh), whose widest case decides
# whether a kernel takes a branch or a stage: BRANCH_WARPGROUPS consumer
# warpgroups, each holding 128 / C M tiles of M_TILE window columns, so a
# window of 24 576 / C columns; a ring of BRANCH_STAGES taps of weights, each
# C rows of 128 bytes. K3 keeps its f32 branch sum in device memory, in its
# block's slot of a scratch buffer made once per card (``_stage_scratch``).
# The tile a launch uses is planned in the C entries (``kernel_branch_plan``
# and ``kernel_stage_plan`` read it).
BRANCH_WARPGROUPS = 3
BRANCH_STAGES = 4
M_TILE = 64

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


def _block_shared(channels: int, window: int, margin: int, pairs: int) -> int:
    """Shared bytes of the bf16 block (csrc/mrf_block.cuh: layout): alignment,
    the weight ring and its barriers, every conv's bias in f32, the f32
    residual [column][C + 4] and the bf16 operand [C / 8][column][8] with
    zero margins."""
    def r16(v):
        return -(-v // 16) * 16

    return (
        1024
        + BRANCH_STAGES * channels * 128
        + 2 * BRANCH_STAGES * 8
        + r16(2 * pairs * channels * 4)
        + window * (channels + 4) * 4
        + r16((window + 2 * margin) * channels * 2)
    )


def mrf_stage_tile(channels: int, branch_shapes: Sequence[Tuple[int, Sequence[int]]], itemsize: int) -> Tuple[int, int, int]:
    """(t_tile, window, shared bytes) of K3's widest block, as its kernels lay
    it out; the window holds the tile and the largest branch halo on each
    side. bf16 (csrc/mrf_block.cuh): K2's block and window, ``branch_window(C)``
    columns, with every branch's biases (the f32 branch sum lives in device
    memory). f32 (csrc/fused_mrf.cu, also K2's f32 variant): a window of
    WINDOW_ELEMS / C columns, an f32 residual, the conv operand with zero
    margins of the largest conv pad, and one tap's weights.
    ``branch_shapes``: (K, dilations) per branch. Raises for shapes the
    kernels do not take."""
    if channels not in KERNEL_CHANNELS:
        raise ValueError(f"fused MRF kernels are built for C in {KERNEL_CHANNELS}, got C={channels}")
    if not 1 <= len(branch_shapes) <= MAX_STAGE_BRANCHES:
        raise ValueError(f"fused MRF stage takes 1 to {MAX_STAGE_BRANCHES} branches, got {len(branch_shapes)}")
    for K, dilations in branch_shapes:
        if K % 2 == 0:
            raise ValueError(f"fused MRF kernels require an odd kernel size, got K={K}")
        if not 1 <= len(dilations) <= 3:
            raise ValueError(f"fused MRF kernels take 1 to 3 conv pairs, got {len(dilations)}")
    window = branch_window(channels) if itemsize == 2 else WINDOW_ELEMS // channels
    halo = max(branch_halo(K, dilations) for K, dilations in branch_shapes)
    t_tile = window - 2 * halo
    if t_tile < 32:
        raise ValueError(
            f"fused MRF (C={channels}, branches {[(K, tuple(d)) for K, d in branch_shapes]}) has a halo too wide "
            f"for its {window}-column window"
        )
    margin = max((K - 1) * d // 2 for K, dilations in branch_shapes for d in dilations)
    if itemsize == 2:
        shared = _block_shared(channels, window, margin, sum(len(d) for _, d in branch_shapes))
    else:
        shared = 4 * channels * (window + channels + window + 2 * margin)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"fused MRF needs {shared} bytes of shared memory, more than a block may use")
    return t_tile, window, shared


def _branch_geometry(channels: int, kernel_size: int, dilations: Sequence[int]) -> Tuple[int, int]:
    """(halo, margin) of one branch; raises for shapes the kernels do not take."""
    if channels not in KERNEL_CHANNELS:
        raise ValueError(f"fused MRF kernels are built for C in {KERNEL_CHANNELS}, got C={channels}")
    if kernel_size % 2 == 0:
        raise ValueError(f"fused MRF kernels require an odd kernel size, got K={kernel_size}")
    if not 1 <= len(dilations) <= 3:
        raise ValueError(f"fused MRF kernels take 1 to 3 conv pairs, got {len(dilations)}")
    return branch_halo(kernel_size, dilations), max((kernel_size - 1) * d // 2 for d in dilations)


def branch_window(channels: int) -> int:
    """K2's widest bf16 window: 128 / C M tiles in each of its warpgroups."""
    return M_TILE * (128 // channels) * BRANCH_WARPGROUPS


def mrf_tile(channels: int, kernel_size: int, dilations: Sequence[int], itemsize: int) -> Tuple[int, int, int]:
    """(t_tile, window, shared bytes) of K2's widest block. bf16
    (csrc/mrf_block.cuh): a window of ``branch_window(C)`` columns holding the
    tile and the branch halo on each side, laid out as ``_block_shared``
    counts it, with no branch sum. f32: K3's one-branch block. Raises for
    shapes the kernel does not take."""
    if itemsize != 2:
        return mrf_stage_tile(channels, [(kernel_size, dilations)], itemsize)
    halo, margin = _branch_geometry(channels, kernel_size, dilations)
    window = branch_window(channels)
    t_tile = window - 2 * halo
    if t_tile < 32:
        raise ValueError(f"fused MRF (C={channels}, K={kernel_size}, {tuple(dilations)}) has a halo too wide for its {window}-column window")
    shared = _block_shared(channels, window, margin, len(dilations))
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"fused MRF needs {shared} bytes of shared memory, more than a block may use")
    return t_tile, window, shared


def mrf_branch_fits(channels: int, kernel_size: int, dilations: Sequence[int], itemsize: int) -> bool:
    """Whether K2 takes this branch (counterpart of ``fused_branch_fits``)."""
    try:
        mrf_tile(channels, kernel_size, dilations, itemsize)
    except ValueError:
        return False
    return True


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


def mrf_stage(x: torch.Tensor, branches: Union[Sequence[Branch], "StageOperands"], slope: float = LRELU_SLOPE) -> torch.Tensor:
    """One whole MRF stage on (B, C, T): the kernel for CUDA tensors, the
    plain version for CPU tensors. ``branches`` may come laid out for the
    kernel already (``stage_operands``)."""
    if not x.is_cuda:
        raw = branches.branches if isinstance(branches, StageOperands) else branches
        return mrf_stage_reference(x, raw, slope)
    return mrf_stage_kernel(x, branches, slope)


def _check_kernel_operands(name: str, x: torch.Tensor, branches: Sequence[Branch]) -> None:
    refuse_grad(f"the {name} kernel", x, *(t for w1, b1, w2, b2, _ in branches for t in (w1, b1, w2, b2)))
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


@functools.lru_cache(maxsize=None)
def _swizzle_index(pairs: int, c_out: int, c_in: int, k: int, device: torch.device) -> torch.Tensor:
    """Position in ``[w.flatten(), 0]`` of every element of ``swizzled_taps(w)``
    for w (pairs, C_out, C_in, K): made once per shape and device."""
    p, t, co, chunk, e = torch.meshgrid(*(torch.arange(n) for n in (pairs, k, c_out, 8, 8)), indexing="ij")
    ci = (chunk ^ (co % 8)) * 8 + e  # the input channel stored at this 16-byte chunk of the row
    src = ((p * c_out + co) * c_in + ci) * k + t
    return torch.where(ci < c_in, src, pairs * c_out * c_in * k).flatten().to(device)


def swizzled_taps(w: torch.Tensor) -> torch.Tensor:
    """(pairs, C_out, C_in, K) -> (pairs, K, C_out, 64): each tap as the
    K-major B operand K2's wgmma reads, C_in padded to one 128-byte row per
    output channel and the row's 16-byte chunk c stored at c ^ (C_out % 8),
    the 128-byte swizzle (csrc/hopper.cuh); one 1-D copy moves a tap. One
    gather from a cached index, so a call costs two small launches."""
    pairs, c_out, c_in, k = w.shape
    flat = torch.cat([w.flatten(), w.new_zeros(1)])
    return flat[_swizzle_index(pairs, c_out, c_in, k, w.device)].view(pairs, k, c_out, 64)


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
    mrf_tile(C, K, dilations, x.element_size())  # raises for shapes the kernel does not take
    prepare = swizzled_taps if x.dtype == torch.bfloat16 else _tap_major
    w1t, w2t = prepare(w1), prepare(w2)
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
        int(x.dtype == torch.bfloat16),
        float(slope),
        torch._C._cuda_getCurrentRawStream(x.device.index),  # the current stream, without a Stream object
    )
    check_launch("mrf_branch", err)
    mrf_branch_kernel.launches += 1
    return out


mrf_branch_kernel.launches = 0


def kernel_branch_plan(batch: int, channels: int, length: int, kernel_size: int, dilations: Sequence[int], itemsize: int):
    """(t_tile, window, shared bytes, SMs) that K2's C entry plans at (B, C, T)
    on the current card: the widest tile, unless B * T gives too few blocks
    for the SMs and a narrower tile finishes in fewer steps."""
    d = list(dilations) + [1] * (3 - len(dilations))
    plan = (ctypes.c_int * 4)()
    err = kernel_library().srt_mrf_branch_plan(batch, channels, length, kernel_size, len(dilations), *d, int(itemsize == 2), plan)
    check_launch("mrf_branch_plan", err)
    return tuple(plan)


def _stage_spec(branch_shapes):
    """The C entries' shapes, int[5] per branch: K, n_pairs, d0, d1, d2."""
    spec = []
    for K, dilations in branch_shapes:
        spec += [K, len(dilations), *dilations, *[1] * (3 - len(dilations))]
    return (ctypes.c_int * len(spec))(*spec)


def kernel_stage_plan(batch: int, channels: int, length: int, branch_shapes, itemsize: int):
    """(t_tile, window, shared bytes, SMs) that K3's C entry plans at (B, C, T)
    on the current card, as ``kernel_branch_plan`` reads K2's."""
    plan = (ctypes.c_int * 4)()
    err = kernel_library().srt_mrf_stage_plan(
        batch, channels, length, len(branch_shapes), _stage_spec(branch_shapes), int(itemsize == 2), plan
    )
    check_launch("mrf_stage_plan", err)
    return tuple(plan)


@functools.lru_cache(maxsize=None)
def _stage_scratch(device: torch.device) -> torch.Tensor:
    """K3's f32 scratch on one card, made once: a branch-sum slot for each
    block of its persistent grid, as the C entry sizes it."""
    n = ctypes.c_longlong()
    with torch.cuda.device(device):
        check_launch("mrf_stage_scratch_floats", kernel_library().srt_mrf_stage_scratch_floats(ctypes.byref(n)))
    return torch.empty(n.value, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class StageOperands:
    """One stage's branches with K3's weights laid out once: every branch's
    taps concatenated in branch order (bf16: ``swizzled_taps``; f32: tap
    major), and the biases likewise."""

    branches: Tuple[Branch, ...]
    shapes: Tuple[Tuple[int, Tuple[int, ...]], ...]
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def stage_operands(branches: Sequence[Branch]) -> StageOperands:
    """Lay out a stage's branches for K3. A caller that runs the same weights
    often (the generator) keeps the result, so a launch prepares nothing."""
    shapes = tuple((w1.shape[-1], tuple(dilations)) for w1, _, _, _, dilations in branches)
    prepare = swizzled_taps if branches[0][0].dtype == torch.bfloat16 else _tap_major
    return StageOperands(
        branches=tuple(branches),
        shapes=shapes,
        w1=torch.cat([prepare(w1).flatten() for w1, _, _, _, _ in branches]),
        b1=torch.cat([b1.flatten() for _, b1, _, _, _ in branches]),
        w2=torch.cat([prepare(w2).flatten() for _, _, w2, _, _ in branches]),
        b2=torch.cat([b2.flatten() for _, _, _, b2, _ in branches]),
    )


def mrf_stage_kernel(
    x: torch.Tensor, branches: Union[Sequence[Branch], StageOperands], slope: float = LRELU_SLOPE
) -> torch.Tensor:
    """Launch K3 on CUDA tensors: every branch of one stage and their mean;
    raises on anything it does not take. ``branches`` raw (laid out here) or
    from ``stage_operands``. bf16 keeps the f32 branch sum in the card's
    scratch (``_stage_scratch``)."""
    ops = branches if isinstance(branches, StageOperands) else stage_operands(branches)
    _check_kernel_operands("MRF stage", x, ops.branches)
    B, C, T = x.shape
    mrf_stage_tile(C, ops.shapes, x.element_size())  # raises for shapes the kernel does not take
    bf16 = x.dtype == torch.bfloat16
    scratch = _stage_scratch(x.device) if bf16 and len(ops.shapes) > 1 else None
    out = torch.empty_like(x)
    err = kernel_library().srt_mrf_stage(
        x.data_ptr(),
        ops.w1.data_ptr(),
        ops.b1.data_ptr(),
        ops.w2.data_ptr(),
        ops.b2.data_ptr(),
        out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        0 if scratch is None else scratch.numel(),
        B,
        C,
        T,
        len(ops.shapes),
        _stage_spec(ops.shapes),
        int(bf16),
        float(slope),
        torch._C._cuda_getCurrentRawStream(x.device.index),  # the current stream, without a Stream object
    )
    check_launch("mrf_stage", err)
    mrf_stage_kernel.launches += 1
    return out


mrf_stage_kernel.launches = 0
