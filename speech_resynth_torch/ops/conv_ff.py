"""The CFM velocity transformer's conv feed-forward as K5, and its plain version.

One feed-forward call on channels-last (B, N, C) activations, SAME padding
(zeros outside each batch row's [0, N)):

    h   = mask * silu(conv3(x, W_gate) + b_gate) * (conv3(x, W_value) + b_value)
    out = conv3(h, W2) + b2

``conv3`` a k = 3 conv; the gate is the second half of conv1's channels, as
in ``models.transformer.ConvFeedForward``. The caller masks x. K5
(csrc/conv_ff.cu) computes it in two launches with no layout copies: conv1
with the SiGLU and the mask in its epilogue, then conv2 with its bias. It
replaces no TPU kernel: the JAX package leaves this block to XLA.

Its numerics, which the plain version repeats: every product's operands in
x's dtype, summed in f32; the biases (rounded to x's dtype, as the plain
chain rounds them), the SiGLU and the mask in f32; h rounded to x's dtype
once, where it is stored; the output rounded once.

The weights are laid out once (``ff_operands``): each conv as a (columns,
3 C_in) matrix, tap-major along its depth, and conv1's columns in blocks of
``PAIR`` value channels followed by their ``PAIR`` gate channels, so the
kernel's epilogue finds each value beside its gate.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .build import check_launch, kernel_library, refuse_grad

TAPS = 3  # the conv's kernel size
PAIR = 64  # value channels in one block of conv1's laid-out columns, followed by as many gates
COLUMN_TILE = 256  # K5's output columns a tile (csrc/conv_ff.cu: BN): C and 2 I must be multiples


def ff_kernel_fits(hidden_size: int, intermediate_size: int, kernel_size: int = TAPS) -> bool:
    """Whether K5 takes a feed-forward of these widths: a k = 3 conv, C a
    multiple of 256 and I of 128 (each conv's output columns in whole tiles)."""
    return (kernel_size == TAPS and hidden_size > 0 and intermediate_size > 0
            and hidden_size % COLUMN_TILE == 0 and 2 * intermediate_size % COLUMN_TILE == 0)


@dataclasses.dataclass(frozen=True)
class FFOperands:
    """One feed-forward's weights as K5 takes them: ``w1`` (2 I, 3 C) in
    ``pair_order``, ``w2`` (C, 3 I), both in the compute dtype; ``b1`` (2 I)
    in the same order and ``b2`` (C), f32 of the compute dtype's values."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor

    @property
    def intermediate_size(self) -> int:
        return self.w2.shape[1] // TAPS


def pair_order(intermediate_size: int) -> torch.Tensor:
    """conv1's output channel at each laid-out column: blocks of PAIR values,
    each followed by the PAIR gates (channels I + ...) of the same positions."""
    if intermediate_size % PAIR:
        raise ValueError(f"K5 lays out conv1 in blocks of {PAIR} channels, got I={intermediate_size}")
    value = torch.arange(intermediate_size).view(-1, PAIR)
    return torch.stack([value, value + intermediate_size], dim=1).flatten()


def _tap_major(w: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, K) torch conv weights -> (C_out, K * C_in): depth index tap * C_in + c."""
    return w.permute(0, 2, 1).reshape(w.shape[0], -1)


def ff_operands(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, dtype: torch.dtype) -> FFOperands:
    """Lay out a feed-forward's conv weights (torch layout: conv1 (2 I, C, 3),
    conv2 (C, I, 3)) for K5 and its plain version, in ``dtype``."""
    order = pair_order(w2.shape[1]).to(w1.device)
    return FFOperands(
        w1=_tap_major(w1[order]).to(dtype).contiguous(),
        b1=b1[order].to(dtype).float().contiguous(),
        w2=_tap_major(w2).to(dtype).contiguous(),
        b2=b2.to(dtype).float().contiguous(),
    )


def _conv3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME k = 3 conv of (B, N, K) f32 by laid-out (cols, 3 K) f32 weights: one product a tap."""
    k, n = x.shape[-1], x.shape[1]
    xp = F.pad(x, (0, 0, 1, 1))
    out = None
    for tap in range(TAPS):
        y = xp[:, tap : tap + n] @ w[:, tap * k : (tap + 1) * k].T
        out = y if out is None else out + y
    return out


def conv_ff_reference(x: torch.Tensor, ops: FFOperands, mask: torch.Tensor = None) -> torch.Tensor:
    """Plain version of K5 on (B, N, C), x already masked: the kernel's
    numerics (module docstring) in x's dtype."""
    dtype = x.dtype
    b, n, _ = x.shape
    i = ops.intermediate_size
    y = (_conv3(x.float(), ops.w1.float()) + ops.b1).view(b, n, i // PAIR, 2, PAIR)
    value, gate = y[..., 0, :].reshape(b, n, i), y[..., 1, :].reshape(b, n, i)
    h = F.silu(gate) * value
    if mask is not None:
        h = torch.where(mask[..., None], h, 0.0)
    return (_conv3(h.to(dtype).float(), ops.w2.float()) + ops.b2).to(dtype)


def conv_ff(x: torch.Tensor, ops: FFOperands, mask: torch.Tensor = None) -> torch.Tensor:
    """One feed-forward call on (B, N, C): K5 for CUDA tensors, the plain
    version for CPU tensors."""
    if not x.is_cuda:
        return conv_ff_reference(x, ops, mask)
    return conv_ff_kernel(x, ops, mask)


def _check_kernel_operands(x: torch.Tensor, ops: FFOperands, mask) -> None:
    refuse_grad("the conv feed-forward kernel", x, ops.w1, ops.w2)
    if x.dim() != 3 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"conv feed-forward kernel wants x (B, N, C) with B, N >= 1, got {tuple(x.shape)}")
    c, i = x.shape[2], ops.intermediate_size
    if not ff_kernel_fits(c, i):
        raise ValueError(f"conv feed-forward kernel takes C a multiple of {COLUMN_TILE} and I of {COLUMN_TILE // 2}, got C={c}, I={i}")
    if ops.w1.shape != (2 * i, TAPS * c) or ops.w2.shape != (c, TAPS * i) or ops.b1.shape != (2 * i,) or ops.b2.shape != (c,):
        raise ValueError(f"laid-out weights do not match x (B, N, {c}): {tuple(ops.w1.shape)}, {tuple(ops.w2.shape)}")
    if x.dtype != torch.bfloat16 or ops.w1.dtype != x.dtype or ops.w2.dtype != x.dtype:
        raise ValueError("conv feed-forward kernel wants bf16 x and weights")
    if ops.b1.dtype != torch.float32 or ops.b2.dtype != torch.float32:
        raise ValueError("conv feed-forward kernel wants f32 biases")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != x.shape[:2] or not mask.is_contiguous()):
        raise ValueError(f"conv feed-forward kernel wants a contiguous bool mask (B, N), got {mask.dtype} {tuple(mask.shape)}")
    tensors = (x, ops.w1, ops.b1, ops.w2, ops.b2) + (() if mask is None else (mask,))
    if not all(t.is_cuda for t in tensors):
        raise ValueError("conv feed-forward kernel launches on the card: every tensor must be a CUDA tensor")
    if not all(t.is_contiguous() for t in tensors) or x.data_ptr() % 16:
        raise ValueError("conv feed-forward kernel wants contiguous tensors and a 16-byte aligned x")


def conv_ff_kernel(x: torch.Tensor, ops: FFOperands, mask: torch.Tensor = None) -> torch.Tensor:
    """Launch K5 on CUDA tensors (two launches: conv1 + SiGLU + mask, then
    conv2 + bias); raises on anything it does not take."""
    _check_kernel_operands(x, ops, mask)
    b, n, c = x.shape
    i = ops.intermediate_size
    h = torch.empty((b, n, i), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    lib = kernel_library()
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)  # the current stream, without a Stream object
    mask_ptr = None if mask is None else mask.data_ptr()
    check_launch("conv_ff conv1", lib.srt_conv_ff(x.data_ptr(), ops.w1.data_ptr(), ops.b1.data_ptr(), mask_ptr,
                                                  h.data_ptr(), b, n, c, 2 * i, 1, stream))
    check_launch("conv_ff conv2", lib.srt_conv_ff(h.data_ptr(), ops.w2.data_ptr(), ops.b2.data_ptr(), None,
                                                  out.data_ptr(), b, n, i, c, 0, stream))
    conv_ff_kernel.launches += 2
    return out


conv_ff_kernel.launches = 0
