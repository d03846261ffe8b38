"""k-means codebook assignment: the hand-written kernel (K4) and its plain version.

Counterpart of speech_resynth_tpu/ops/codebook.py. The nearest center of a
frame is argmin_c |x - c|^2 = argmax_c (x.c - |c|^2 / 2), scored in f32, with
the first (lowest) id winning a tie. ``assign_reference`` is the plain
PyTorch version; ``assign_kernel`` launches ``csrc/codebook.cu`` on CUDA
tensors; ``assign`` is what the quantizer calls: the kernel for a CUDA
tensor, the plain version for a CPU tensor, and nothing else. The kernel
runs split TF32 (3xTF32) on the tensor cores: it reads the codebook as its
two TF32 halves, with the half squared norms beside them
(``codebook_operands``); a quantizer makes those once, not per call. Frames
are read as they are, f32 or bf16, and split inside the kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .build import check_launch, kernel_library, refuse_grad


def half_sq_norms(centers: torch.Tensor) -> torch.Tensor:
    """|c|^2 / 2 per center, in f32 (computed outside the kernel, as on the TPU)."""
    c = centers.float()
    return 0.5 * torch.sum(c * c, dim=-1)


def assign_reference(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(..., D) frames, (K, D) centers -> (...,) int32 nearest-center ids."""
    score = torch.einsum("...d,kd->...k", x.float(), centers.float()) - half_sq_norms(centers)
    return torch.argmax(score, dim=-1).to(torch.int32)


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero, as PTX
    ``cvt.rna.tf32.f32`` rounds: the low 13 mantissa bits rounded off
    through the int32 view (finite inputs)."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def codebook_operands(centers: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The codebook as the kernel reads it: its TF32 halves c_hi and c_lo,
    (K, D) f32 each, contiguous (c_hi + c_lo is c to ~2^-21 relative), and
    |c|^2 / 2 (K,) f32."""
    c = centers.float().contiguous()
    c_hi = tf32_round(c)
    c_lo = tf32_round(torch.where(torch.isfinite(c_hi), c - c_hi, 0.0))  # a non-finite value is all hi
    return c_hi, c_lo, half_sq_norms(centers)


Operands = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def assign_kernel(x: torch.Tensor, centers: torch.Tensor, operands: Optional[Operands] = None) -> torch.Tensor:
    """Launch the assignment kernel: x (N, D) f32 or bf16 and centers (K, D)
    f32, contiguous, on the card -> ids (N,) int32. Raises on anything else.
    ``operands`` is ``codebook_operands(centers)``, made here when omitted;
    ``x`` or ``centers`` requiring grad while grad is on raises (no backward)."""
    refuse_grad("assign_kernel", x, centers)
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
    if d % 8 or x.data_ptr() % 16:
        raise ValueError(f"assign_kernel copies rows in 16-byte pieces: wants D % 8 == 0 and 16-byte aligned x; got D = {d}")
    c_hi, c_lo, half_sq = codebook_operands(centers) if operands is None else operands
    for t in (c_hi, c_lo):
        if t.shape != (k, d) or t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"assign_kernel wants operands (K, D) f32 contiguous on the card; got {tuple(t.shape)} {t.dtype}")
    if half_sq.shape != (k,) or half_sq.device != x.device:
        raise ValueError(f"assign_kernel wants half_sq (K,) on the card; got {tuple(half_sq.shape)}")
    packed = torch.empty(n, dtype=torch.int64, device=x.device)  # (score bits, ~id) of the running best
    err = kernel_library().srt_codebook_assign(
        x.data_ptr(),
        c_hi.data_ptr(),
        c_lo.data_ptr(),
        half_sq.data_ptr(),
        packed.data_ptr(),
        ids.data_ptr(),
        n,
        d,
        k,
        int(x.dtype == torch.bfloat16),
        torch._C._cuda_getCurrentRawStream(x.device.index),  # the current stream, without a Stream object
    )
    check_launch("codebook_assign", err)
    assign_kernel.launches += 1
    return ids


assign_kernel.launches = 0


def pad_depth(x: torch.Tensor, centers: torch.Tensor, operands: Optional[Operands] = None):
    """x (N, D), centers (K, D) and their operands with D padded by zero
    columns up to a multiple of 8, as the kernel copies rows in 16-byte
    pieces (``assign_pallas`` pads D the same way). Exact: a zero column adds
    0 to every dot product and every norm."""
    pad = -x.shape[-1] % 8
    if pad == 0:
        return x, centers, operands
    c_hi, c_lo, half_sq = codebook_operands(centers) if operands is None else operands  # norms of the true rows
    operands = (F.pad(c_hi, (0, pad)), F.pad(c_lo, (0, pad)), half_sq)
    return F.pad(x, (0, pad)), F.pad(centers, (0, pad)), operands


def assign(x: torch.Tensor, centers: torch.Tensor, operands: Optional[Operands] = None) -> torch.Tensor:
    """Nearest-center ids of frames (..., D): the kernel on the card (D
    padded to a multiple of 8), the plain version for CPU tensors."""
    if x.is_cuda:
        shape = x.shape[:-1]
        flat, centers, operands = pad_depth(x.reshape(-1, x.shape[-1]), centers, operands)
        return assign_kernel(flat.contiguous(), centers.contiguous(), operands).reshape(shape)
    return assign_reference(x, centers)
