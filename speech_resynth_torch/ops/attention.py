"""Multi-head attention: the hand-written flash kernel (K1) and its plain version.

Counterpart of speech_resynth_tpu/ops/attention.py. ``attention_reference``
is the plain PyTorch version and defines the semantics; ``flash_attention``
launches ``csrc/flash_attention.cu`` on CUDA tensors; ``dot_product_attention``
is what the models call: the kernel for a CUDA tensor whose shapes it takes
(``flash_supported``), the plain version otherwise. The kernel has no backward:
``FlashAttention`` launches it forward and takes the gradient through the
plain version (``flash_attention_backward``), as the JAX package's
``custom_vjp`` does.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from .build import check_launch, kernel_library, refuse_grad

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

FLASH_HEAD_DIMS = (64, 128)
KEY_TILE = 64  # csrc/flash_attention.cu BK: keys per tile
QUERY_BLOCK = 64  # queries per block of the bf16 kernel (one consumer warpgroup)
# the kernel keeps a flag per key and lists of its key tiles in shared memory
# (76 bytes per 64-key tile), which caps N_k: ~104 000 keys for f32 at d = 128,
# more for the other variants
MAX_KEYS = 100_000


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """(B, H, N, D) attention with f32 scores. ``mask``: (B, N_k) bool, True =
    valid key. Masked logits take the finite ``NEG_INF``, so a row whose keys
    are all masked is the mean of V (a bool mask in SDPA would give NaN)."""
    q_len, d = q.shape[-2], q.shape[-1]
    k_len = k.shape[-2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    if causal:
        allowed = torch.ones(q_len, k_len, dtype=torch.bool, device=q.device).tril(k_len - q_len)
        logits = logits.masked_fill(~allowed, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def _check_flash_args(q, k, v, mask, causal) -> None:
    if q.ndim != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"flash_attention wants q (B, H, Nq, D), k = v (B, H, Nk, D); got {q.shape}, {k.shape}, {v.shape}")
    if q.shape[-1] not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention supports head dims {FLASH_HEAD_DIMS}, got {q.shape[-1]}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention wants q, k, v of one dtype, f32 or bf16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if causal and q.shape[2] > k.shape[2]:
        # queries past the last key would see no allowed key at all
        raise ValueError(f"flash_attention requires q_len <= k_len when causal, got {q.shape[2]} > {k.shape[2]}")
    if k.shape[2] > MAX_KEYS:
        raise ValueError(f"flash_attention takes at most {MAX_KEYS} keys (its per-key flags live in shared memory), got {k.shape[2]}")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (q.shape[0], k.shape[2])):
        raise ValueError(f"mask must be bool (B, Nk) = {(q.shape[0], k.shape[2])}, got {mask.dtype} {tuple(mask.shape)}")
    tensors = (q, k, v) if mask is None else (q, k, v, mask)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention wants contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        # the kernel loads rows as 16-byte vectors; a contiguous view at an odd offset would fault
        raise ValueError("flash_attention wants q, k, v data 16-byte aligned")
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flash_attention launches a CUDA kernel: every tensor must be on the card")


def key_tiles(mask_row: Optional[torch.Tensor], q_len: int, k_len: int, q0: int, q_rows: int, causal: bool) -> List[int]:
    """The key tiles (of ``KEY_TILE`` keys) the kernel visits for queries
    [q0, q0 + q_rows) of one batch row (``mask_row`` (N_k,) bool or None):
    those holding a valid key, and in causal mode only those at or below the
    last query's diagonal; every tile when some query has no valid allowed
    key (then its output is the uniform mean over all N_k keys). The host
    mirror of ``build_tile_list`` in csrc/flash_attention.cu."""
    n_tiles = -(-k_len // KEY_TILE)
    valid = torch.ones(k_len, dtype=torch.bool) if mask_row is None else mask_row.cpu()
    idx = torch.nonzero(valid).flatten()
    first = int(idx[0]) if len(idx) else k_len
    offset = k_len - q_len
    if first >= k_len or (causal and first > q0 + offset):
        return list(range(n_tiles))
    live = torch.zeros(n_tiles, dtype=torch.bool)
    live[idx // KEY_TILE] = True
    q_last = min(q0 + q_rows, q_len) - 1
    return [t for t in range(n_tiles) if live[t] and (not causal or t * KEY_TILE <= q_last + offset)]


def live_tile_share(mask: Optional[torch.Tensor], batch: int, q_len: int, k_len: int, causal: bool, q_rows: int) -> float:
    """The share of (query block, key tile) pairs the kernel visits, over the
    batch rows of ``mask`` (B, N_k) (all keys valid when None), for blocks of
    ``q_rows`` queries: what tile skipping leaves of the work at this input."""
    n_tiles = -(-k_len // KEY_TILE)
    mask = None if mask is None else mask.cpu()
    visited = total = 0
    for b in range(batch):
        row = None if mask is None else mask[b]
        for q0 in range(0, q_len, q_rows):
            visited += len(key_tiles(row, q_len, k_len, q0, q_rows, causal))
            total += n_tiles
    return visited / total


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Launch the flash-attention kernel on CUDA tensors (B, H, N, D), D in
    (64, 128), f32 or bf16, N_k at most ``MAX_KEYS``. Output in q's dtype.
    Raises on anything else, and on an input that requires grad while grad
    is on: the kernel's output has no ``grad_fn`` (``FlashAttention`` gives it one)."""
    refuse_grad("flash_attention (FlashAttention.apply gives it the plain version's gradient)", q, k, v)
    _check_flash_args(q, k, v, mask, causal)
    b, h, q_len, d = q.shape
    out = torch.empty_like(q)
    err = kernel_library().srt_flash_attention(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        None if mask is None else mask.data_ptr(),
        out.data_ptr(),
        b,
        h,
        q_len,
        k.shape[2],
        d,
        int(q.dtype == torch.bfloat16),
        int(causal),
        1.0 / math.sqrt(d),
        torch._C._cuda_getCurrentRawStream(q.device.index),  # the current stream, without a Stream object
    )
    check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    causal: bool,
    grad_out: torch.Tensor,
):
    """(dq, dk, dv) of attention at (q, k, v) for the output gradient
    ``grad_out``: autograd through ``attention_reference`` recomputed on
    detached inputs, so they are the plain version's gradients exactly (the
    JAX package's ``_flash_bwd``)."""
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = attention_reference(q, k, v, mask, causal)
        return torch.autograd.grad(out, (q, k, v), grad_out)


class FlashAttention(torch.autograd.Function):
    """K1 forward with the plain version's gradient; the mask and ``causal`` get none."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        ctx.save_for_backward(q, k, v, mask)
        ctx.causal = causal
        return flash_attention(q, k, v, mask, causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, mask, ctx.causal, grad_out)
        return dq, dk, dv, None, None


def flash_supported(q: torch.Tensor, k: torch.Tensor, mask: Optional[torch.Tensor], causal: bool) -> bool:
    """Whether the flash kernel takes these shapes: head dim in
    ``FLASH_HEAD_DIMS``, at most ``MAX_KEYS`` keys, q_len <= k_len when
    causal. Decided before any launch, as the JAX package routes the shapes
    its kernel does not take to its plain version; anything else that is
    wrong (dtype, rank, mask) makes ``flash_attention`` raise."""
    q_len, k_len = q.shape[-2], k.shape[-2]
    return q.shape[-1] in FLASH_HEAD_DIMS and k_len <= MAX_KEYS and not (causal and q_len > k_len)


IMPLEMENTATIONS = ("auto", "pallas", "xla")


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    implementation: str = "auto",
) -> torch.Tensor:
    """Attention over (B, H, N, D), routed by ``implementation`` (the JAX
    names): ``"auto"`` takes the flash kernel for CUDA tensors it takes
    (``flash_supported``), through ``FlashAttention`` so a gradient flows,
    and the plain version for the rest; ``"pallas"`` takes the kernel for
    every CUDA tensor and raises on a shape it does not take; ``"xla"``
    always takes the plain version. CPU tensors take the plain version under
    every name."""
    if implementation not in IMPLEMENTATIONS:
        raise ValueError(f"attention implementation {implementation!r} is not one of {IMPLEMENTATIONS}")
    if q.is_cuda and implementation != "xla":
        if flash_supported(q, k, mask, causal):
            mask = None if mask is None else mask.contiguous()
            return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), mask, causal)
        if implementation == "pallas":
            raise ValueError(
                f"attention implementation 'pallas': the flash kernel does not take q {tuple(q.shape)}, "
                f"k {tuple(k.shape)}, causal={causal} (flash_supported)"
            )
    return attention_reference(q, k, v, mask, causal)
