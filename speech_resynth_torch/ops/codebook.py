"""k-means codebook assignment: the hand-written kernel (K4) and its plain version.

Counterpart of speech_resynth_tpu/ops/codebook.py. The nearest center of a
frame is argmin_c |x - c|^2 = argmax_c (x.c - |c|^2 / 2), scored in f32, with
the first (lowest) id winning a tie. ``assign_reference`` is the plain
PyTorch version; ``assign_kernel`` launches ``csrc/codebook.cu`` on CUDA
tensors; ``assign`` is what the quantizer calls: the kernel for a CUDA
tensor, the plain version for a CPU tensor, and nothing else. The kernel
reads the codebook transposed, with its half squared norms beside it
(``codebook_operands``); a quantizer makes those once, not per call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .build import check_launch, kernel_library

# Blocks the kernel keeps in flight per SM (its __launch_bounds__): a frame
# tile's center tiles are split over grid.y until the grid covers the card
# about this many times.
BLOCKS_PER_SM = 2
FRAME_TILE = 128  # csrc/codebook.cu TN
CENTER_TILE = 128  # csrc/codebook.cu TC


def half_sq_norms(centers: torch.Tensor) -> torch.Tensor:
    """|c|^2 / 2 per center, in f32 (computed outside the kernel, as on the TPU)."""
    c = centers.float()
    return 0.5 * torch.sum(c * c, dim=-1)


def assign_reference(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(..., D) frames, (K, D) centers -> (...,) int32 nearest-center ids."""
    score = torch.einsum("...d,kd->...k", x.float(), centers.float()) - half_sq_norms(centers)
    return torch.argmax(score, dim=-1).to(torch.int32)


def codebook_operands(centers: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The codebook as the kernel reads it: centers^T (D, K) f32, contiguous
    (k-major, as the TPU wrapper transposes it), and |c|^2 / 2 (K,) f32."""
    return centers.float().t().contiguous(), half_sq_norms(centers)


def _splits(device: torch.device, n: int, k: int) -> int:
    row_tiles = -(-n // FRAME_TILE)
    center_tiles = -(-k // CENTER_TILE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(center_tiles, -(-BLOCKS_PER_SM * sms // row_tiles)))


def assign_kernel(
    x: torch.Tensor, centers: torch.Tensor, operands: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
) -> torch.Tensor:
    """Launch the assignment kernel: x (N, D) f32 or bf16 and centers (K, D)
    f32, contiguous, on the card -> ids (N,) int32. Raises on anything else.
    ``operands`` is ``codebook_operands(centers)``, made here when omitted."""
    if x.ndim != 2 or centers.ndim != 2 or x.shape[1] != centers.shape[1]:
        raise ValueError(f"assign_kernel wants x (N, D) and centers (K, D); got {tuple(x.shape)}, {tuple(centers.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or centers.dtype != torch.float32:
        raise ValueError(f"assign_kernel wants x f32 or bf16 and centers f32; got {x.dtype}, {centers.dtype}")
    if not (x.is_cuda and centers.is_cuda and x.device == centers.device):
        raise ValueError("assign_kernel launches a CUDA kernel: x and centers must be on the same card")
    if not (x.is_contiguous() and centers.is_contiguous()):
        raise ValueError("assign_kernel wants contiguous tensors")
    n, d = x.shape
    k = centers.shape[0]
    if k == 0:
        raise ValueError("assign_kernel needs at least one center")
    ids = torch.empty(n, dtype=torch.int32, device=x.device)
    if n == 0:
        return ids
    ct, half_sq = codebook_operands(centers) if operands is None else operands
    if ct.shape != (d, k) or half_sq.shape != (k,) or ct.device != x.device or not ct.is_contiguous():
        raise ValueError(f"assign_kernel wants operands (D, K) and (K,) on the card; got {tuple(ct.shape)}, {tuple(half_sq.shape)}")
    xt = x.float().t().contiguous()  # k-major as well: x^T (D, N) in f32 (bf16 widens exactly)
    packed = torch.empty(n, dtype=torch.int64, device=x.device)  # (score bits, ~id) of the running best
    err = kernel_library().srt_codebook_assign(
        xt.data_ptr(),
        ct.data_ptr(),
        half_sq.data_ptr(),
        packed.data_ptr(),
        ids.data_ptr(),
        n,
        d,
        k,
        _splits(x.device, n, k),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch("codebook_assign", err)
    assign_kernel.launches += 1
    return ids


assign_kernel.launches = 0


def assign(
    x: torch.Tensor, centers: torch.Tensor, operands: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
) -> torch.Tensor:
    """Nearest-center ids of frames (..., D): the kernel on the card, the plain
    version for CPU tensors."""
    if x.is_cuda:
        shape = x.shape[:-1]
        return assign_kernel(x.reshape(-1, x.shape[-1]).contiguous(), centers.contiguous(), operands).reshape(shape)
    return assign_reference(x, centers)
