#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (speech_resynth_torch) on one NVIDIA H100.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written kernels from ``speech_resynth_torch/ops/csrc``;
3. holds each kernel against its plain PyTorch version on the card, at every
   shape the paths below launch it at, in bf16 and f32, plus edge cases, and
   times kernel, plain version and (where one exists) the single PyTorch call
   that computes the same function there: K1 flash attention (the decoder's,
   HuBERT's and the LM's causal shapes), K2 fused MRF branch, K3 whole MRF
   stage (beside the per-branch route of three K2 launches), K4 k-means
   assignment. Data-dependent shapes (the duration decoder's frame bounds,
   the continuation decoder's bound) are checked after their runs;
4. serves requests of ~500 units through ``SynthesisServer`` at the full
   width of configs/resynth/mhubert-expresso-2000.yaml (random weights from a
   seed, bf16), counts the kernel launches of that run, and checks lengths,
   finiteness and a small-input agreement with the plain path on the CPU;
   then serves one batch with stage fusion on (3 K3, no K2) against the same
   batch without it;
5. encodes 8-10 s waveforms with the full-width mHuBERT + 2000-center
   k-means encoder (random weights from a seed) and checks ids, unit counts,
   launches, padded rows against unpadded runs and the card against the CPU;
6. resynthesizes a tree of 32 WAVs (wav -> units -> wav) through
   ``pipeline.synthesize`` for both resynthesis configs (without and with
   duration prediction), counts the launches of K1, K2 and K4, and checks
   every output file's length;
7. streams 10 s of mel through ``StreamingVocoder`` (chunk 50) with stage
   fusion on and off, against the batch run; time to first audio, ms per
   window, realtime factor;
8. runs the full-width speech LM's scoring forward (K1 causal, d = 64) and
   textless speech continuation (``generate_speechlm``: HuBERT-base + 100
   centers, a port-trained BPE, the LM, the duration-predicting decoder) with
   stage fusion on, greedy and sampled, with the time split of one run;
9. profiles device time by kernel group, and prints one ``{"kernels": [...]}``
   line (launches of every path above, the shape of every counted launch,
   and the times of each kernel at every timed shape) and, last, the
   ``{"ok": true, ...}`` line.

Any failed check raises, and the script exits non-zero with no result line.
Without CUDA, or without the repository beside it, it exits non-zero at once.
"""


from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3

SERVE_BATCH = 16
SERVE_UNITS = 500
BUCKET = 512  # SynthesisServer's length_multiple=128 bucket for ~500 units

SAMPLE_RATE = 16000
ENCODER = ("mhubert-base-vp_mls_cv_8lang", "kmeans-expresso", 2000)
ENC_BATCH = 16
ENC_FRAMES = 499  # 10 s at 50 Hz: HuBERT's attention and K4's shapes
RESYNTH_FRAMES = 1499  # the resynthesis batches' 30-s padding: encoder, K4 and plain-config decoder shapes
RESYNTH_FILES = 32
MRF_DILATIONS = (1, 3, 5)
STAGE_KERNELS = (3, 7, 11)  # the production stage's branches

STREAM_CHUNK = 50  # StreamingVocoder's default chunk; the context comes from the config (22 frames)
STREAM_FRAMES = 500  # 10 s of mel

LM_BATCH, LM_TOKENS = 16, 256  # the LM scoring shape (configs/speechlm/hubert.yaml widths)
CONT_ENCODER = ("hubert-base-ls960", "kmeans", 100)  # configs/speechlm/hubert.yaml s2u
CONT_NEW_TOKENS = 128


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def time_ms(torch, fn, iters: int) -> float:
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


ATT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
MRF_TOL = {"float32": 1e-3, "bfloat16": 6e-2}
DTYPES = ("bfloat16", "float32")


def timed(torch, fn, plain, library, nbytes: float, flops: float, peak_flops: float, iters=(50, 20, 50)) -> dict:
    """Times of the kernel, its plain version and the library call (None when
    there is none), and the bound from this input's bytes and operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return {
        "ms": time_ms(torch, fn, iters[0]),
        "plain_ms": time_ms(torch, plain, iters[1]),
        "library_ms": None if library is None else time_ms(torch, library, iters[2]),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes,
        "ops_ms": t_ops,
    }


def attention_shape(torch, F, A, gen, path: str, B: int, H: int, N: int, D: int, lo: int, hi: int, causal: bool = False) -> dict:
    """K1 against attention_reference at one shape a path launches it at:
    key lengths drawn in [lo, hi] (row 0 at hi), bidirectional or causal,
    bf16 and f32; times in bf16 beside SDPA with the same mask."""
    dev = "cuda"
    lengths = torch.randint(lo, hi + 1, (B,), generator=gen, device=dev)
    lengths[0] = hi
    mask = torch.arange(N, device=dev)[None, :] < lengths[:, None]
    errs, tols = {}, {}
    for name in DTYPES:
        dtype = getattr(torch, name)
        q, k, v = (torch.randn(B, H, N, D, generator=gen, device=dev).to(dtype) for _ in range(3))
        got = A.flash_attention(q, k, v, mask, causal)
        want = A.attention_reference(q, k, v, mask, causal)
        torch.cuda.synchronize()
        errs[name] = max_err(torch, got, want)
        # the tolerance is for O(1) outputs; a causal row near the start averages
        # few keys, its outputs reach |v| ~ 4 and a rounding there is worth more
        tols[name] = ATT_TOL[name] * max(1.0, float(want.float().abs().max()))
        if not torch.isfinite(got.float()).all() or errs[name] > tols[name]:
            fail(f"flash_attention {path} {[B, H, N, D]} {name}: max abs err {errs[name]} > {tols[name]}")
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    allowed = mask[:, None, None, :]  # (B, 1, 1 or N, N): the (query, key) pairs this input needs
    if causal:
        allowed = allowed & torch.ones(N, N, dtype=torch.bool, device=dev).tril()
    float_mask = torch.zeros(allowed.shape, device=dev, dtype=torch.bfloat16).masked_fill(~allowed, A.NEG_INF)
    pairs = float(allowed.expand(B, 1, N, N).sum())
    record = {
        "path": path, "shape": [B, H, N, D], "dtype": "bfloat16", "key_lengths": [lo, hi], "causal": causal,
        "max_abs_err": errs["bfloat16"], "f32_max_abs_err": errs["float32"], "tol": tols,
        **timed(
            torch,
            lambda: A.flash_attention(q, k, v, mask, causal),
            lambda: A.attention_reference(q, k, v, mask, causal),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=float_mask),
            nbytes=4 * B * H * N * D * 2 + B * N,
            flops=4.0 * H * D * pairs,  # every query against the keys its row and position allow
            peak_flops=PEAK_BF16_FLOPS,
        ),
    }
    print(json.dumps({"phase": "flash_attention", **record}))
    return record


def attention_phase(torch, F, A) -> list:
    """K1 against attention_reference: edge cases, then every shape the
    serving, encoder and plain resynthesis paths launch it at."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    B, H, N, D = SERVE_BATCH, 2, BUCKET, 128
    lengths = torch.randint(SERVE_UNITS - 40, N + 1, (B,), generator=gen, device=dev)
    mask = torch.arange(N, device=dev)[None, :] < lengths[:, None]
    cases = []
    for name in DTYPES:
        dtype, tol = getattr(torch, name), ATT_TOL[name]
        q, k, v = (torch.randn(B, H, N, D, generator=gen, device=dev).to(dtype) for _ in range(3))
        masked_row = mask.clone()
        masked_row[3] = False  # edge case: every key of row 3 masked -> mean of V
        causal_q = q[:, :, : N // 2, :64].contiguous()
        causal_k, causal_v = k[..., :64].contiguous(), v[..., :64].contiguous()
        for label, args in (
            ("all_masked_row", (q, k, v, masked_row, False)),
            ("causal_q256_k512_d64", (causal_q, causal_k, causal_v, mask, True)),
        ):
            got = A.flash_attention(*args)
            want = A.attention_reference(*args)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                fail(f"flash_attention {label} {name}: non-finite output")
            err = max_err(torch, got, want)
            cases.append({"case": label, "dtype": name, "max_abs_err": err, "tol": tol})
            if err > tol:
                fail(f"flash_attention {label} {name}: max abs err {err} > {tol}")
        row_mean = v[3].float().mean(dim=1)  # (H, D): what the reference gives an all-masked row
        err = float((A.flash_attention(q, k, v, masked_row)[3].float() - row_mean[:, None, :]).abs().max())
        cases.append({"case": "all_masked_row_is_mean_of_v", "dtype": name, "max_abs_err": err, "tol": tol})
        if err > tol:
            fail(f"flash_attention all-masked row is not the mean of V (err {err})")
    print(json.dumps({"phase": "flash_attention_checks", "cases": cases}))

    lo, hi = 8 * ENC_FRAMES // 10, ENC_FRAMES  # units / frames of 8-10 s files
    records = [
        attention_shape(torch, F, A, gen, "serving", SERVE_BATCH, 2, BUCKET, 128, SERVE_UNITS - 40, BUCKET),
        attention_shape(torch, F, A, gen, "encoder", ENC_BATCH, 12, ENC_FRAMES, 64, lo, hi),
        attention_shape(torch, F, A, gen, "resynth decoder (plain config)", ENC_BATCH, 2, RESYNTH_FRAMES, 128, lo, hi),
        attention_shape(torch, F, A, gen, "resynth encoder", ENC_BATCH, 12, RESYNTH_FRAMES, 64, lo, hi),
    ]
    torch.cuda.synchronize()
    return records


def mrf_shapes(voc_cfg, frames: int):
    """(C, T, K) of every fused-MRF launch of one batch of ``frames`` frames."""
    shapes, t = [], frames
    for i, (rate, kernel) in enumerate(zip(voc_cfg.upsample_rates, voc_cfg.upsample_kernel_sizes)):
        t = (t - 1) * rate - 2 * ((kernel - rate) // 2) + kernel
        channels = voc_cfg.upsample_initial_channel // 2 ** (i + 1)
        if channels <= 64:
            shapes.extend((channels, t, k) for k in voc_cfg.resblock_kernel_sizes)
    return shapes


def mrf_operands(torch, gen, C, T, K, dtype, B):
    std = 1.0 / math.sqrt(C * K)
    x = (torch.randn(B, C, T, generator=gen, device="cuda") * 0.5).to(dtype)
    w1, w2 = ((torch.randn(3, C, C, K, generator=gen, device="cuda") * std).to(dtype) for _ in range(2))
    b1, b2 = ((torch.randn(3, C, generator=gen, device="cuda") * 0.01).to(dtype) for _ in range(2))
    return x, w1, b1, w2, b2


def mrf_check(torch, M, gen, C, T, K, B) -> dict:
    """K2 against mrf_branch_reference at one (B, C, T, K), bf16 and f32."""
    errs = {}
    for name in DTYPES:
        args = mrf_operands(torch, gen, C, T, K, getattr(torch, name), B)
        got = M.mrf_branch_kernel(*args, MRF_DILATIONS)
        want = M.mrf_branch_reference(*args, MRF_DILATIONS)
        torch.cuda.synchronize()
        errs[name] = max_err(torch, got, want)
        if not torch.isfinite(got.float()).all() or errs[name] > MRF_TOL[name]:
            fail(f"mrf_branch B={B} C={C} T={T} K={K} {name}: max abs err {errs[name]} > {MRF_TOL[name]}")
    return {"B": B, "C": C, "T": T, "K": K, "max_abs_err": errs["bfloat16"], "f32_max_abs_err": errs["float32"]}


def mrf_path(torch, M, gen, voc_cfg, path: str, frames: int) -> dict:
    """K2 at the nine launches of one batch of ``frames`` frames: checks, and
    times in bf16 summed over the batch."""
    shapes = []
    totals = dict.fromkeys(("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms"), 0.0)
    for C, T, K in mrf_shapes(voc_cfg, frames):
        check = mrf_check(torch, M, gen, C, T, K, SERVE_BATCH)
        args = mrf_operands(torch, gen, C, T, K, torch.bfloat16, SERVE_BATCH)
        times = timed(
            torch,
            lambda: M.mrf_branch_kernel(*args, MRF_DILATIONS),
            lambda: M.mrf_branch_reference(*args, MRF_DILATIONS),
            None,
            nbytes=2 * SERVE_BATCH * C * T * 2 + 2 * 3 * (C * C * K + C) * 2,
            flops=12.0 * K * C * C * T * SERVE_BATCH,
            peak_flops=PEAK_BF16_FLOPS,
            iters=(5, 3, 0),
        )
        shapes.append({**check, **times})
        for key in totals:
            totals[key] += times[key]
    record = {
        "path": path, "frames": frames, "per": "batch: nine launches", "dtype": "bfloat16",
        "max_abs_err": max(c["max_abs_err"] for c in shapes), "f32_max_abs_err": max(c["f32_max_abs_err"] for c in shapes),
        "tol": MRF_TOL, **totals, "bound_by": "bytes" if totals["bytes_ms"] >= totals["ops_ms"] else "operations",
        "library_ms": None, "shapes": shapes,
    }
    print(json.dumps({"phase": "mrf_branch", **record}))
    return record


def mrf_phase(torch, M, voc_cfg) -> list:
    """K2 against mrf_branch_reference at tile edges, then at every launch of
    a served batch and of a plain-config resynthesis batch."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    edges = [mrf_check(torch, M, gen, C, T, K, 3) for C, T, K in ((64, 50, 11), (32, 1000, 7), (16, 2049, 3))]
    print(json.dumps({"phase": "mrf_branch_checks", "case": "T below / not a multiple of the tile", "cases": edges, "tol": MRF_TOL}))
    records = [
        mrf_path(torch, M, gen, voc_cfg, "serving", BUCKET),
        mrf_path(torch, M, gen, voc_cfg, "resynth decoder (plain config)", RESYNTH_FRAMES),
    ]
    torch.cuda.synchronize()
    return records


def stage_shapes(voc_cfg, frames: int):
    """(C, T) of the three K3 launches of one vocoder call on ``frames`` frames."""
    return list(dict.fromkeys((C, T) for C, T, _ in mrf_shapes(voc_cfg, frames)))


def stage_branches(torch, gen, C, dtype):
    """The production stage's three branches (K = 3, 7, 11; dilations 1, 3, 5)."""
    branches = []
    for K in STAGE_KERNELS:
        std = 1.0 / math.sqrt(C * K)
        w1, w2 = ((torch.randn(3, C, C, K, generator=gen, device="cuda") * std).to(dtype) for _ in range(2))
        b1, b2 = ((torch.randn(3, C, generator=gen, device="cuda") * 0.01).to(dtype) for _ in range(2))
        branches.append((w1, b1, w2, b2, MRF_DILATIONS))
    return branches


def stage_operands(torch, gen, C, T, B, dtype):
    return (torch.randn(B, C, T, generator=gen, device="cuda") * 0.5).to(dtype), stage_branches(torch, gen, C, dtype)


def stage_check(torch, M, gen, C, T, B) -> dict:
    """K3 against mrf_stage_reference at one (B, C, T), bf16 and f32."""
    errs = {}
    for name in DTYPES:
        x, branches = stage_operands(torch, gen, C, T, B, getattr(torch, name))
        got = M.mrf_stage_kernel(x, branches)
        want = M.mrf_stage_reference(x, branches)
        torch.cuda.synchronize()
        errs[name] = max_err(torch, got, want)
        if not torch.isfinite(got.float()).all() or errs[name] > MRF_TOL[name]:
            fail(f"mrf_stage B={B} C={C} T={T} {name}: max abs err {errs[name]} > {MRF_TOL[name]}")
    return {"B": B, "C": C, "T": T, "max_abs_err": errs["bfloat16"], "f32_max_abs_err": errs["float32"]}


def stage_path(torch, M, gen, voc_cfg, path: str, frames: int, batch: int) -> dict:
    """K3 at the three launches of one vocoder call on ``batch`` rows of
    ``frames`` frames: checks, and bf16 times summed over the call of the
    kernel, its plain version and the per-branch route (three K2 launches,
    their sum and mean: no single PyTorch call computes a stage)."""
    shapes = []
    totals = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms"), 0.0)
    for C, T in stage_shapes(voc_cfg, frames):
        check = stage_check(torch, M, gen, C, T, batch)
        x, branches = stage_operands(torch, gen, C, T, batch, torch.bfloat16)

        def route():
            res = None
            for branch in branches:
                out = M.mrf_branch_kernel(x, *branch)
                res = out if res is None else res + out
            return res / len(branches)

        times = timed(
            torch,
            lambda: M.mrf_stage_kernel(x, branches),
            lambda: M.mrf_stage_reference(x, branches),
            route,
            nbytes=2 * batch * C * T * 2 + sum(2 * 3 * (C * C * K + C) * 2 for K in STAGE_KERNELS),
            flops=12.0 * sum(STAGE_KERNELS) * C * C * T * batch,
            peak_flops=PEAK_BF16_FLOPS,
            iters=(10, 3, 10) if batch == 1 else (5, 3, 5),
        )
        shapes.append({**check, **times})
        for key in totals:
            totals[key] += times[key]
    record = {
        "path": path, "frames": frames, "batch": batch, "per": "vocoder call: three launches", "dtype": "bfloat16",
        "max_abs_err": max(c["max_abs_err"] for c in shapes), "f32_max_abs_err": max(c["f32_max_abs_err"] for c in shapes),
        "tol": MRF_TOL, **totals, "bound_by": "bytes" if totals["bytes_ms"] >= totals["ops_ms"] else "operations",
        "library": "per-branch route: three K2 launches, their sum and mean", "shapes": shapes,
    }
    print(json.dumps({"phase": "mrf_stage", **record}))
    return record


def stage_phase(torch, M, voc_cfg, ctx: int) -> list:
    """K3 against mrf_stage_reference at tile edges, then at every launch of a
    served batch and of the streaming windows (the first, left-pinned one and
    the interior one, which the flush of a long stream reuses)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    edges = [stage_check(torch, M, gen, C, T, 3) for C, T in ((64, 50), (64, 1000), (32, 1000), (16, 137), (16, 2049))]
    print(json.dumps({"phase": "mrf_stage_checks", "case": "T below / not a multiple of the tile", "cases": edges, "tol": MRF_TOL}))
    records = [
        stage_path(torch, M, gen, voc_cfg, "serving", BUCKET, SERVE_BATCH),
        stage_path(torch, M, gen, voc_cfg, "streaming window", STREAM_CHUNK + 2 * ctx, 1),
        stage_path(torch, M, gen, voc_cfg, "streaming first window", STREAM_CHUNK + ctx, 1),
    ]
    torch.cuda.synchronize()
    return records


def clear_of_ties(torch, C, x, centers):
    """Frames whose two best scores differ by more than 1e-3 * (|best| + 1):
    there another summation order cannot flip the winner."""
    score = x.float() @ centers.float().T - C.half_sq_norms(centers)
    top2 = score.topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]) > 1e-3 * (top2[:, 0].abs() + 1)


def codebook_phase(torch, C) -> list:
    """K4 against assign_reference at the encoder's and the resynthesis
    path's shapes, plus edge cases; times at the two path shapes."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(4)
    D, K = 768, 2000

    def operands(n, d, k, dtype=torch.float32):
        return torch.randn(n, d, generator=gen, device=dev).to(dtype), torch.randn(k, d, generator=gen, device=dev)

    cases = []

    def check(label, x, centers):
        got = C.assign_kernel(x, centers)
        want = C.assign_reference(x, centers)
        torch.cuda.synchronize()
        score = x.float() @ centers.T - C.half_sq_norms(centers)
        # the score the kernel's choice gives up against the best (0 unless a near-tie flipped)
        err = float((score.gather(1, want.long()[:, None]) - score.gather(1, got.long()[:, None])).abs().max())
        clear = clear_of_ties(torch, C, x, centers)
        case = {
            "case": label, "N": x.shape[0], "D": x.shape[1], "K": centers.shape[0], "dtype": str(x.dtype).split(".")[-1],
            "equal_share": float((got == want).float().mean()), "clear_frame_mismatches": int((got != want)[clear].sum()),
            "near_tie_frames": int((~clear).sum()), "max_abs_score_err": err,
        }
        cases.append(case)
        if case["clear_frame_mismatches"] or case["equal_share"] < 0.999 or int(got.min()) < 0 or int(got.max()) >= centers.shape[0]:
            fail(f"codebook_assign {case}")
        return got

    paths = (
        ("encoder", ENC_BATCH * ENC_FRAMES, K),
        ("resynth encoder", ENC_BATCH * RESYNTH_FRAMES, K),
        ("continuation encoder", ENC_FRAMES, CONT_ENCODER[2]),  # one 10-s prompt, 100 centers: one padded 128-tile
    )
    for path, n, k in paths:
        check(path, *operands(n, D, k))
    check("n_not_a_tile_multiple", *operands(1000, D, K))
    check("kmeans_vocab_100", *operands(ENC_BATCH * ENC_FRAMES, D, 100))
    check("d_32", *operands(3001, 32, K))
    x, c = operands(777, D, K)
    c[K - 1] = c[5]
    c[9] = c[5]
    x[:8] = c[5] + 1e-3 * x[:8]
    got = check("duplicate_centers", x, c)
    if (got[:8] != 5).any() or ((got == 9) | (got == K - 1)).any():
        fail("codebook_assign: on duplicate centers the lower id must win")
    check("bf16_frames", *operands(ENC_BATCH * ENC_FRAMES, D, K, torch.bfloat16))

    # non-finite frames: NaN scores win as in torch.argmax, all -inf scores give id 0
    x, c = operands(300, D, 130)
    c[:, 1] = -c[:, 1].abs()
    c[:, 0] = -c[:, 0].abs()
    c[40, 0] = c[77, 0] = 1.0
    x[0] = float("nan")  # every score NaN -> 0
    x[1, 3] = float("nan")  # every score NaN -> 0
    x[2] = 0.0
    x[2, 1] = float("inf")  # every score -inf -> 0
    x[3, 0] = float("inf")  # +inf at 40 and 77 -> 40
    got, want = C.assign_kernel(x, c), C.assign_reference(x, c)
    non_finite = {"case": "non_finite_frames", "ids": got[:4].tolist(), "plain_ids": want[:4].tolist(), "equal": bool(torch.equal(got, want))}
    cases.append(non_finite)
    if not non_finite["equal"] or non_finite["ids"] != [0, 0, 0, 40]:
        fail(f"codebook_assign on non-finite frames: {non_finite}")
    print(json.dumps({"phase": "codebook_assign_checks", "rule": "ids equal where top-2 gap > 1e-3*(|top|+1); equal share >= 0.999", "cases": cases}))

    records = []
    for path, n, K in paths:
        x, c = operands(n, D, K)
        ops = C.codebook_operands(c)  # made once, as KMeansQuantizer makes them
        half = ops[1]
        record = {
            "path": path, "shape": [n, D, K], "dtype": "float32",
            "max_abs_err": max(case["max_abs_score_err"] for case in cases if "max_abs_score_err" in case),
            "tol": "ids equal where the top-2 score gap exceeds 1e-3*(|top|+1); max_abs_err is the score given up by a flipped near-tie",
            **timed(
                torch,
                lambda: C.assign_kernel(x, c, ops),
                lambda: C.assign_reference(x, c),
                lambda: torch.addmm(-half, x, c.T).argmax(dim=-1),  # cuBLAS SGEMM, TF32 off
                nbytes=4 * (n * D + K * D) + 4 * n,
                flops=2.0 * n * D * K,
                peak_flops=PEAK_F32_FLOPS,
                iters=(20, 20, 20),
            ),
            "bound_peak": "H100 SXM f32 CUDA cores, 67 TFLOP/s",
        }
        print(json.dumps({"phase": "codebook_assign", **record}))
        records.append(record)
    torch.cuda.synchronize()
    return records


def speechlike_waves(np, rng, n: int):
    """``n`` seeded waveforms of 8-10 s (the first exactly 10 s): a gliding
    voiced tone with harmonics under a syllable-rate envelope, plus noise."""
    lengths = rng.integers(8 * SAMPLE_RATE, 10 * SAMPLE_RATE + 1, n)
    lengths[0] = 10 * SAMPLE_RATE
    waves = []
    for length in lengths:
        t = np.arange(int(length)) / SAMPLE_RATE
        f0 = rng.uniform(90, 220) * (1 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t))
        phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
        voiced = np.sin(phase) + 0.4 * np.sin(2 * phase) + 0.2 * np.sin(3 * phase)
        waves.append((0.3 * env * voiced + 0.02 * rng.standard_normal(len(t))).astype(np.float32))
    return waves


def padded(np, waves):
    lengths = np.array([len(w) for w in waves])
    batch = np.zeros((len(waves), lengths.max()), np.float32)
    for i, w in enumerate(waves):
        batch[i, : len(w)] = w
    return batch, lengths


def encoder_phase(torch, np, A, C):
    """SpeechEncoder at full width (mHuBERT layer 11 + 2000 centers, random
    weights from a seed, bf16): ids, unit counts, launches, ragged exactness, card vs CPU."""
    from speech_resynth_torch.core.precision import FLOAT32
    from speech_resynth_torch.models.speech_encoder import SpeechEncoder

    t0 = time.perf_counter()
    enc = SpeechEncoder.by_name(*ENCODER, device="cuda")
    cfg = enc.encoder.config
    rng = np.random.default_rng(5)
    batches = [padded(np, speechlike_waves(np, rng, ENC_BATCH)) for _ in range(2)]
    enc(*batches[0])  # warm-up: allocator, cuDNN plans
    torch.cuda.synchronize()
    print(json.dumps({"phase": "encoder_setup", "seconds": time.perf_counter() - t0}))

    A.flash_attention.launches = 0
    C.assign_kernel.launches = 0
    t1 = time.perf_counter()
    outs = [enc(wav, lengths) for wav, lengths in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {"flash_attention": A.flash_attention.launches, "codebook_assign": C.assign_kernel.launches}
    expected = {"flash_attention": 11 * len(batches), "codebook_assign": len(batches)}
    print(json.dumps({"phase": "encoder_launches", "launches": launches, "expected": expected}))
    if launches != expected:
        fail(f"encoder launches {launches} != expected {expected} (11 K1 + 1 K4 per batch)")
    for out, (wav, lengths) in zip(outs, batches):
        units = out["units"]
        if units.shape != (ENC_BATCH, ENC_FRAMES) or int(units.min()) < 0 or int(units.max()) >= enc.vocab_size:
            fail(f"encoder units of shape {tuple(units.shape)} or outside [0, {enc.vocab_size})")
        if out["num_units"].tolist() != [cfg.num_frames(int(n)) for n in lengths]:
            fail("encoder num_units != num_frames(lengths)")
    audio_s = sum(float(lengths.sum()) for _, lengths in batches) / SAMPLE_RATE
    print(json.dumps({
        "phase": "encoder_slice", "batches": len(batches), "batch": ENC_BATCH, "frames": ENC_FRAMES,
        "audio_seconds": audio_s, "wall_seconds": wall, "realtime_factor": audio_s / wall,
        "distinct_units": int(torch.cat([o["units"].flatten() for o in outs]).unique().numel()),
    }))

    # f32 (TF32 off): padded rows equal their unpadded runs, and the card equals the CPU
    enc32 = SpeechEncoder.by_name(*ENCODER, policy=FLOAT32, device="cuda")
    centers = enc32.quantizer.centers

    def feats(e, wav, lengths=None):
        wav = torch.from_numpy(np.ascontiguousarray(wav)).to(e.device)
        ns = None if lengths is None else torch.from_numpy(lengths).to(e.device)
        return e.encoder(wav, output_layer=e.output_layer, num_samples=ns)

    tol = 1e-3  # f32 on both sides; the padded run sums attention and convs in another order
    wav, lengths = batches[0]
    full = feats(enc32, wav, lengths)
    rows = [int(i) for i in np.argsort(lengths)[:2]]  # the two shortest rows: the most padding
    report = []
    for b in rows:
        k = cfg.num_frames(int(lengths[b]))
        solo = feats(enc32, wav[b : b + 1, : lengths[b]])[0]
        err = float((full[b, :k] - solo).abs().max())
        clear = clear_of_ties(torch, C, full[b, :k], centers)
        mism = int((enc32.quantizer(full[b, :k]) != enc32.quantizer(solo))[clear].sum())
        report.append({"row": b, "frames": k, "max_abs_err": err, "clear_unit_mismatches": mism, "near_ties": int((~clear).sum())})
        if err > tol or mism:
            fail(f"padded row {b} differs from its unpadded run: {report[-1]}")
    print(json.dumps({"phase": "encoder_padded_vs_unpadded", "tol": tol, "rows": report}))

    enc_cpu = SpeechEncoder.by_name(*ENCODER, policy=FLOAT32, device="cpu")
    small, small_lengths = padded(np, [w[:SAMPLE_RATE] for w in speechlike_waves(np, np.random.default_rng(6), 2)])
    small_lengths[1] = SAMPLE_RATE * 4 // 5
    small[1, small_lengths[1] :] = 0.0
    on_card, on_cpu = feats(enc32, small, small_lengths).cpu(), feats(enc_cpu, small, small_lengths)
    errs, mism = [], 0
    for b, n in enumerate(small_lengths):
        k = cfg.num_frames(int(n))
        errs.append(float((on_card[b, :k] - on_cpu[b, :k]).abs().max()))
        clear = clear_of_ties(torch, C, on_cpu[b, :k], enc_cpu.quantizer.centers)
        mism += int((enc32.quantizer(on_card[b, :k].cuda()).cpu() != enc_cpu.quantizer(on_cpu[b, :k]))[clear].sum())
    print(json.dumps({"phase": "encoder_vs_cpu_plain", "max_abs_err": max(errs), "tol": tol, "clear_unit_mismatches": mism}))
    if max(errs) > tol or mism:
        fail(f"card f32 encoder differs from the CPU plain path: {max(errs)}, {mism} unit mismatches")
    del enc32, enc_cpu
    torch.cuda.empty_cache()
    return enc, launches


def resynth_phase(torch, np, A, M, C, enc):
    """The slice's main path: a WAV tree through pipeline.synthesize, for both
    resynthesis configs, at full width."""
    import dataclasses

    from speech_resynth_torch.core.config import config_from_dict
    from speech_resynth_torch.core.precision import BF16_INFERENCE
    from speech_resynth_torch.dsp import audio_io
    from speech_resynth_torch.models.cfm import CFMConfig
    from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan
    from speech_resynth_torch.models.hifigan import HifiGanConfig
    from speech_resynth_torch.pipeline.data import SpeechDataset
    from speech_resynth_torch.pipeline.synthesize import synthesize

    voc_cfg = HifiGanConfig()
    results = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        src = Path(tmp) / "src"
        for i, w in enumerate(speechlike_waves(np, np.random.default_rng(8), RESYNTH_FILES)):
            split = "test-a" if i < RESYNTH_FILES // 2 else "test-b"
            audio_io.write(src / split / f"spk{i % 4}" / f"utt{i:02d}.wav", w, SAMPLE_RATE)

        for predict_duration in (False, True):
            label = "duration_prediction" if predict_duration else "plain"
            decoder = ConditionalFlowMatchingWithHifiGan.from_config(
                CFMConfig(vocab_size=2000, predict_duration=predict_duration), voc_cfg, BF16_INFERENCE,
                generator=torch.Generator().manual_seed(0), device="cuda",
            )
            encoder = dataclasses.replace(enc, deduplicate=predict_duration)

            def config(split, tgt):
                return config_from_dict({
                    "common": {"seed": 0},
                    "synthesis": {"src_dir": str(src), "tgt_dir": str(tgt), "split": split, "ext_audio": ".wav"},
                    "flow_matching": {"dt": 0.0625, "truncation_value": 1.0, "predict_duration": predict_duration},
                    "flow_matching_with_hifigan": {"batch_size": ENC_BATCH},
                })

            synthesize(config("test-a", Path(tmp) / f"warm_{label}"), encoder, decoder)  # warm-up: one batch
            torch.cuda.synchronize()
            tgt = Path(tmp) / f"out_{label}"
            A.flash_attention.launches = 0
            M.mrf_branch_kernel.launches = 0
            C.assign_kernel.launches = 0
            t0 = time.perf_counter()
            synthesize(config("test-*", tgt), encoder, decoder)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {
                "flash_attention": A.flash_attention.launches,
                "codebook_assign": C.assign_kernel.launches,
                "mrf_branch": M.mrf_branch_kernel.launches,
            }
            n_batches = RESYNTH_FILES // ENC_BATCH
            expected = {"flash_attention": (11 + 64) * n_batches, "codebook_assign": n_batches, "mrf_branch": 9 * n_batches}
            print(json.dumps({"phase": f"resynth_{label}_launches", "launches": launches, "expected": expected}))
            if launches != expected:
                fail(f"{label} resynthesis launches {launches} != expected {expected} (11+64 K1, 1 K4, 9 K2 per batch)")

            # every output file, with the length its frames give (frames recomputed
            # here), and the frames each batch's decoder ran at
            out_samples, in_samples, frames_seen, decoder_frames = 0, 0, [], []
            for batch in SpeechDataset(str(src), split="test-*").batches(ENC_BATCH):
                lengths = batch["wavs_len"]
                in_samples += int(lengths.sum())
                padded_frames = enc.encoder.config.num_frames(batch["input_values"].shape[1])
                if padded_frames != RESYNTH_FRAMES:
                    fail(f"resynthesis batches padded to {padded_frames} frames, not {RESYNTH_FRAMES}")
                if predict_duration:
                    out = encoder(batch["input_values"], lengths)
                    pos = torch.arange(out["units"].shape[1], device="cuda")[None, :]
                    ids = torch.where(pos < out["num_units"][:, None], out["units"] + 1, 0)
                    frames = decoder.model.predict_durations(ids).sum(dim=-1).cpu().numpy()
                    decoder_frames.append(max(64, -(-max(int(frames.max()), 1) // 64) * 64))  # the 64-multiple bound
                else:
                    frames = np.array([enc.encoder.config.num_frames(int(n)) for n in lengths])
                    decoder_frames.append(padded_frames)
                frames_seen.extend(int(f) for f in frames)
                for name, f in zip(batch["names"], frames):
                    path = (tgt / name).with_suffix(".wav")
                    want = int(voc_cfg.waveform_lengths(int(f)))
                    if not path.is_file() or audio_io.info(path) != (SAMPLE_RATE, 1, want):
                        fail(f"{label}: {path.name} missing or not {want} samples at 16 kHz")
                    out_samples += want
            audio_s = out_samples / SAMPLE_RATE
            print(json.dumps({
                "phase": f"resynth_{label}", "files": RESYNTH_FILES, "batch": ENC_BATCH,
                "input_audio_seconds": in_samples / SAMPLE_RATE, "audio_seconds": audio_s, "wall_seconds": wall,
                "realtime_factor": audio_s / wall, "frames_per_file": [min(frames_seen), max(frames_seen)],
                "decoder_frames_per_batch": decoder_frames,
            }))
            profile_phase(torch, f"resynth_{label}", lambda: synthesize(config("test-a", Path(tmp) / f"prof_{label}"), encoder, decoder), 1)
            results[label] = {"launches": launches, "decoder_frames": decoder_frames}
            del decoder
            torch.cuda.empty_cache()
    return results


def slice_phase(torch, np, A, M):
    """The port's main path: SynthesisServer at the full mhubert-expresso-2000 width."""
    from speech_resynth_torch.core.precision import BF16_INFERENCE, FLOAT32
    from speech_resynth_torch.models.cfm import CFMConfig
    from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan
    from speech_resynth_torch.models.hifigan import HifiGanConfig
    from speech_resynth_torch.pipeline.serving import SynthesisServer

    cfm_cfg, voc_cfg = CFMConfig(vocab_size=2000), HifiGanConfig()
    t0 = time.perf_counter()
    decoder = ConditionalFlowMatchingWithHifiGan.from_config(
        cfm_cfg, voc_cfg, BF16_INFERENCE, generator=torch.Generator().manual_seed(0), device="cuda"
    )
    server = SynthesisServer(decoder, batch_size=SERVE_BATCH, dt=0.0625, truncation_value=1.0, pcm16=True)
    rng = np.random.default_rng(0)

    def requests(n):
        lengths = rng.integers(SERVE_UNITS - 20, SERVE_UNITS + 1, n)
        return [rng.integers(1, cfm_cfg.vocab_size + 1, int(n_)).astype(np.int64) for n_ in lengths]

    server.synthesize_many(requests(SERVE_BATCH))  # warm-up: allocator, cuDNN plans
    torch.cuda.synchronize()
    print(json.dumps({"phase": "slice_setup", "seconds": time.perf_counter() - t0}))

    n_batches = 4
    seqs = requests(n_batches * SERVE_BATCH)
    A.flash_attention.launches = 0
    M.mrf_branch_kernel.launches = 0
    t1 = time.perf_counter()
    wavs = server.synthesize_many(seqs)
    wall = time.perf_counter() - t1
    launches = {"flash_attention": A.flash_attention.launches, "mrf_branch": M.mrf_branch_kernel.launches}
    expected = {"flash_attention": 64 * n_batches, "mrf_branch": 9 * n_batches}
    print(json.dumps({"phase": "slice_launches", "launches": launches, "expected": expected}))
    if launches != expected:
        fail(f"kernel launches {launches} != expected {expected} (64 K1 + 9 K2 per euler-16 batch)")

    for seq, wav in zip(seqs, wavs):
        if wav.dtype != np.int16 or wav.shape != (int(voc_cfg.waveform_lengths(len(seq))),):
            fail(f"request of {len(seq)} units: waveform {wav.dtype} {wav.shape} != waveform_lengths")
    audio_s = sum(len(w) for w in wavs) / 16000.0
    print(json.dumps({
        "phase": "slice", "requests": len(seqs), "batch": SERVE_BATCH, "units": [int(min(map(len, seqs))), int(max(map(len, seqs)))],
        "audio_seconds": audio_s, "wall_seconds": wall, "realtime_factor": audio_s / wall,
    }))

    # f32 waveforms of one batch are finite
    ids = np.zeros((SERVE_BATCH, BUCKET), np.int64)
    for j, s in enumerate(seqs[:SERVE_BATCH]):
        ids[j, : len(s)] = s
    wav, lengths = decoder.synthesize(ids, dt=0.0625, truncation_value=1.0, generator=torch.Generator("cuda").manual_seed(3))
    torch.cuda.synchronize()
    if not torch.isfinite(wav).all() or wav.shape != (SERVE_BATCH, int(voc_cfg.waveform_lengths(BUCKET))):
        fail(f"f32 waveform batch not finite or of shape {tuple(wav.shape)}")

    # small input: the kernel path on the card against the plain path on the CPU, in f32
    small = np.random.default_rng(1).integers(1, cfm_cfg.vocab_size + 1, (2, 48))
    small[1, 30:] = 0
    x0 = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 48, cfm_cfg.dim_in)).astype(np.float32))
    outs = {}
    for device in ("cuda", "cpu"):
        dec = ConditionalFlowMatchingWithHifiGan.from_config(
            cfm_cfg, voc_cfg, FLOAT32, generator=torch.Generator().manual_seed(0), device=device
        )
        ids = torch.from_numpy(small).to(device)
        mel, _ = dec.model.sample(ids, 0.0625, 1.0, x0=x0.to(device))
        w, n = dec.synthesize(small, dt=0.0625, truncation_value=1.0, x0=x0)
        outs[device] = (mel.cpu(), w.cpu(), n.cpu())
    mel_err = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
    wav_err = float((outs["cuda"][1] - outs["cpu"][1]).abs().max())
    # f32 on both sides (TF32 off); the sums run in another order on the card.
    # log-mels are O(10), waveforms O(1)
    tol = {"mel": 2e-3, "wav": 2e-3}
    print(json.dumps({"phase": "slice_vs_cpu_plain", "mel_max_abs_err": mel_err, "wav_max_abs_err": wav_err, "tol": tol}))
    if not torch.equal(outs["cuda"][2], outs["cpu"][2]) or mel_err > tol["mel"] or wav_err > tol["wav"]:
        fail(f"card f32 synthesis differs from the CPU plain path: mel {mel_err}, waveform {wav_err}")

    profile_phase(torch, "serving", lambda: server.synthesize_many(seqs[: 2 * SERVE_BATCH]), 2)
    return launches


def serving_fused_phase(torch, np, A, M, voc_cfg):
    """One served batch of 16 x ~500 units at full width with stage fusion on:
    3 K3 and no K2 launches, and the waveforms of the same batch (same noise)
    without fusion. bf16: the stage rounds the branch mean once where the
    per-branch route rounds each branch, its sum and its mean, a few bf16
    ulps of the O(1) activations at each of the three narrow stages
    (tol 5e-2 on samples in [-1, 1])."""
    from speech_resynth_torch.core.precision import BF16_INFERENCE
    from speech_resynth_torch.models.cfm import CFMConfig
    from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan
    from speech_resynth_torch.pipeline.serving import SynthesisServer

    decoder = ConditionalFlowMatchingWithHifiGan.from_config(
        CFMConfig(vocab_size=2000), policy=BF16_INFERENCE, generator=torch.Generator().manual_seed(0), device="cuda"
    )
    rng = np.random.default_rng(11)
    seqs = [rng.integers(1, 2001, int(n)).astype(np.int64) for n in rng.integers(SERVE_UNITS - 20, SERVE_UNITS + 1, SERVE_BATCH)]
    outs, walls, launches = {}, {}, None
    for fused in (False, True, False, True):  # a warm-up pair, then the timed pair
        server = SynthesisServer(decoder, batch_size=SERVE_BATCH, dt=0.0625, truncation_value=1.0, pcm16=False, seed=5)
        with M.mrf_stage_fusion(fused):
            torch.cuda.synchronize()
            if fused:
                A.flash_attention.launches = M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = 0
            t0 = time.perf_counter()
            outs[fused] = server.synthesize_many(seqs)
            walls[fused] = time.perf_counter() - t0
            if fused:
                launches = {
                    "flash_attention": A.flash_attention.launches,
                    "mrf_branch": M.mrf_branch_kernel.launches,
                    "mrf_stage": M.mrf_stage_kernel.launches,
                }
    expected = {"flash_attention": 64, "mrf_branch": 0, "mrf_stage": 3}
    print(json.dumps({"phase": "serving_fused_launches", "launches": launches, "expected": expected}))
    if launches != expected:
        fail(f"fused serving launches {launches} != expected {expected} (64 K1 + 3 K3 per batch)")
    tol = 5e-2
    err = max(float(np.abs(a - b).max()) for a, b in zip(outs[True], outs[False]))
    shapes_ok = all(a.shape == b.shape == (int(voc_cfg.waveform_lengths(len(s))),) for a, b, s in zip(outs[True], outs[False], seqs))
    audio_s = sum(len(w) for w in outs[True]) / SAMPLE_RATE
    print(json.dumps({
        "phase": "serving_fused", "requests": SERVE_BATCH, "max_abs_err_vs_per_branch": err, "tol": tol,
        "audio_seconds": audio_s, "wall_seconds_fused": walls[True], "wall_seconds_per_branch": walls[False],
        "realtime_factor_fused": audio_s / walls[True], "realtime_factor_per_branch": audio_s / walls[False],
    }))
    if not shapes_ok or err > tol or not all(np.isfinite(w).all() for w in outs[True]):
        fail(f"fused serving differs from the per-branch route: max abs err {err} (tol {tol}), shapes ok {shapes_ok}")
    with M.mrf_stage_fusion(True):
        server = SynthesisServer(decoder, batch_size=SERVE_BATCH, dt=0.0625, truncation_value=1.0, pcm16=True)
        profile_phase(torch, "serving_fused", lambda: server.synthesize_many(seqs + seqs), 2)
    del decoder
    torch.cuda.empty_cache()
    return launches


def streaming_phase(torch, np, M) -> dict:
    """StreamingVocoder on the full-width vocoder of
    configs/resynth/mhubert-expresso-2000.yaml, chunk 50 and the analytic
    context, over 500 mel frames in irregular pushes: the concatenated
    output against the batch run of the same mel, with stage fusion on and
    off; device calls against the window schedule, and 3 K3 (on) or 9 K2
    (off) launches per call. The bf16 streams are the timed path."""
    from speech_resynth_torch.core.precision import BF16_INFERENCE, FLOAT32
    from speech_resynth_torch.models.composite import init_random_weights, pcm16_encode
    from speech_resynth_torch.models.hifigan import HifiGanConfig, HifiGanGenerator
    from speech_resynth_torch.pipeline.streaming import StreamingVocoder

    voc_cfg = HifiGanConfig()
    gens = {}
    for name, policy in (("bfloat16", BF16_INFERENCE), ("float32", FLOAT32)):
        gen = HifiGanGenerator(voc_cfg, policy)
        init_random_weights(gen, torch.Generator().manual_seed(0))
        gens[name] = gen.to("cuda").eval()
    mel = (np.random.default_rng(12).standard_normal((STREAM_FRAMES, voc_cfg.model_in_dim)) - 4.0).astype(np.float32)
    sizes = [7, 23, 1, 40, 13, 60, 3, 31, 50, 17, 90, 2, 65]  # irregular arrivals, 402 frames; then 98 more
    pushes, i = [], 0
    for n in sizes + [STREAM_FRAMES - sum(sizes)]:
        pushes.append((i, n))
        i += n

    def batch(name, fused, wire="f32"):
        with M.mrf_stage_fusion(fused), torch.no_grad():
            wav = gens[name](torch.from_numpy(mel[None]).cuda())
            return (pcm16_encode(wav) if wire == "pcm16" else wav)[0].cpu().numpy()

    def stream(name, fused, wire="f32"):
        sv = StreamingVocoder(gens[name], chunk_frames=STREAM_CHUNK, wire=wire)
        windows = []
        run = sv._run_window

        def recording(start, length):
            windows.append(length)
            return run(start, length)

        sv._run_window = recording
        parts, t_complete, t_first = [], None, None
        with M.mrf_stage_fusion(fused):
            torch.cuda.synchronize()
            M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = 0
            t0 = time.perf_counter()
            for start, n in pushes:
                if t_complete is None and start + n >= sv.first_window:
                    t_complete = time.perf_counter()  # this push completes the first chunk + ctx frames
                out = sv.push(mel[start : start + n])
                if out.size and t_first is None:
                    t_first = time.perf_counter()
                parts.append(out)
            parts.append(sv.flush())
            wall = time.perf_counter() - t0
        launches = {"mrf_branch": M.mrf_branch_kernel.launches, "mrf_stage": M.mrf_stage_kernel.launches}
        return np.concatenate(parts), sv, windows, launches, {"ttfa_ms": (t_first - t_complete) * 1e3, "wall_s": wall}

    # tolerances against the batch run: f32 (TF32 off) differs in summation
    # order only; bf16 may flip a rounding of the O(1) activations wherever the
    # window-shaped and whole-utterance convs sum in another order, a few bf16
    # ulps at the output (5e-2, as for fused serving); PCM16 within 1 LSB
    results = {}
    for name, fused, wire, tol in (
        ("bfloat16", False, "f32", 5e-2),  # warm-up of both routes, then the timed streams
        ("bfloat16", True, "f32", 5e-2),
        ("bfloat16", False, "f32", 5e-2),
        ("bfloat16", True, "f32", 5e-2),
        ("float32", True, "f32", 1e-4),
        ("float32", False, "f32", 1e-4),
        ("float32", True, "pcm16", 1),
    ):
        got, sv, windows, launches, times = stream(name, fused, wire)
        want = batch(name, fused, wire)
        err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
        # the window schedule at chunk 50: one first window, interior windows
        # while a whole one fits, then the flush window
        emitted, expected_calls = STREAM_CHUNK, 1
        while emitted + STREAM_CHUNK + sv.ctx <= STREAM_FRAMES:
            emitted += STREAM_CHUNK
            expected_calls += 1
        expected_calls += 1  # the flush
        per_call = {"mrf_branch": 0, "mrf_stage": 3} if fused else {"mrf_branch": 9, "mrf_stage": 0}
        expected = {k: v * sv.device_calls for k, v in per_call.items()}
        audio_s = got.size / SAMPLE_RATE
        record = {
            "phase": "streaming", "dtype": name, "stage_fusion": fused, "wire": wire, "frames": STREAM_FRAMES,
            "chunk": STREAM_CHUNK, "ctx": sv.ctx, "device_calls": sv.device_calls, "expected_calls": expected_calls,
            "window_frames": sorted(set(windows)), "launches": launches, "expected_launches": expected,
            "max_abs_err_vs_batch": err, "tol": tol, "ttfa_ms": times["ttfa_ms"],
            "ms_per_window": times["wall_s"] * 1e3 / sv.device_calls, "audio_seconds": audio_s,
            "realtime_factor": audio_s / times["wall_s"],
        }
        print(json.dumps(record))
        if got.shape != want.shape or err > tol or sv.device_calls != expected_calls or launches != expected:
            fail(f"stream {name} fused={fused} wire={wire}: {record}")
        if name == "bfloat16":
            results[fused] = {"launches": launches, "windows": windows}
    del gens
    torch.cuda.empty_cache()
    return results


def lm_scoring_phase(torch, F, A, np) -> tuple:
    """The full-width speech LM's scoring forward (configs/speechlm/hubert.yaml:
    12 layers, 768 wide, 12 heads of 64, vocab 16 384 + 2) over 16 x 256
    tokens with ragged padding: 12 K1 launches, causal with a key mask; K1
    held and timed at that shape; and the LM's f32 logits on the card
    against the CPU plain path on a small input."""
    from speech_resynth_torch.core.precision import BF16_INFERENCE, FLOAT32
    from speech_resynth_torch.models.composite import init_random_weights
    from speech_resynth_torch.models.llama import LlamaConfig, LlamaLM, sequence_pseudo_log_prob

    cfg = LlamaConfig()
    lm = LlamaLM(cfg, BF16_INFERENCE)
    init_random_weights(lm, torch.Generator().manual_seed(0))
    lm = lm.to("cuda").eval()
    gen = torch.Generator(device="cuda").manual_seed(14)
    lengths = torch.randint(LM_TOKENS // 2, LM_TOKENS + 1, (LM_BATCH,), generator=gen, device="cuda")
    lengths[0] = LM_TOKENS
    mask = torch.arange(LM_TOKENS, device="cuda")[None, :] < lengths[:, None]
    ids = torch.randint(2, cfg.vocab_size, (LM_BATCH, LM_TOKENS), generator=gen, device="cuda").masked_fill(~mask, 0)
    with torch.no_grad():
        lm(ids, attention_mask=mask)  # warm-up
        torch.cuda.synchronize()
        A.flash_attention.launches = 0
        t0 = time.perf_counter()
        logits, _ = lm(ids, attention_mask=mask)
        scores = sequence_pseudo_log_prob(logits, ids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"flash_attention": A.flash_attention.launches}
    expected = {"flash_attention": cfg.num_hidden_layers}
    print(json.dumps({
        "phase": "lm_scoring", "batch": LM_BATCH, "tokens": LM_TOKENS, "launches": launches, "expected": expected,
        "wall_ms": wall * 1e3, "tokens_per_second": float(lengths.sum()) / wall, "scores_finite": bool(torch.isfinite(scores).all()),
    }))
    if launches != expected or not torch.isfinite(logits).all() or not torch.isfinite(scores).all():
        fail(f"LM scoring: launches {launches} (expected {expected}) or non-finite logits/scores")
    record = attention_shape(
        torch, F, A, gen, "LM scoring", LM_BATCH, cfg.num_attention_heads, LM_TOKENS, cfg.head_dim, LM_TOKENS // 2, LM_TOKENS, causal=True
    )
    del lm
    torch.cuda.empty_cache()

    # f32 (TF32 off) on both sides; the sums run in another order through 12 layers (logits O(1))
    small = torch.from_numpy(np.random.default_rng(15).integers(2, cfg.vocab_size, (2, 40)))
    small_mask = torch.arange(40)[None, :] < torch.tensor([[40], [27]])
    outs = {}
    for device in ("cuda", "cpu"):
        lm32 = LlamaLM(cfg, FLOAT32)
        init_random_weights(lm32, torch.Generator().manual_seed(0))
        lm32 = lm32.to(device).eval()
        with torch.no_grad():
            outs[device] = lm32(small.to(device), attention_mask=small_mask.to(device))[0].cpu()
    tol = 1e-3
    err = float((outs["cuda"] - outs["cpu"])[small_mask].abs().max())
    print(json.dumps({"phase": "lm_vs_cpu_plain", "max_abs_err": err, "tol": tol}))
    if err > tol:
        fail(f"card f32 LM logits differ from the CPU plain path: {err}")
    return launches, record


def write_hf_dir(torch, path: Path, state_dict: dict, config: dict) -> None:
    """A local HF-format directory: config.json and pytorch_model.bin."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(config))
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path / "pytorch_model.bin")


def continuation_phase(torch, np, A, C, M) -> dict:
    """Textless speech continuation (``generate_speechlm``) at full width with
    stage fusion on: a BPE tokenizer trained by the port on seeded unit
    strings, a 10-s prompt wav, the -duration-prediction decoder and the LM
    as local directories with seeded random weights, then greedy and seeded
    sampled runs of 128 new tokens; launches, output lengths, unit range and
    reproducibility; and the time split of one run."""
    import dataclasses

    from speech_resynth_torch.core.config import config_from_dict
    from speech_resynth_torch.core.precision import BF16_INFERENCE
    from speech_resynth_torch.dsp import audio_io
    from speech_resynth_torch.models.cfm import CFMConfig
    from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan, init_random_weights
    from speech_resynth_torch.models.hifigan import HifiGanConfig
    from speech_resynth_torch.models.llama import LlamaConfig, LlamaLM
    from speech_resynth_torch.pipeline.speechlm import _make_encoder, load_lm_from_hf
    from speech_resynth_torch.pipeline.train_loops import generate_speechlm
    from speech_resynth_torch.text.units import units_to_unicode
    from speech_resynth_torch.tokenizers.bpe import BpeTokenizer

    n_units = CONT_ENCODER[2]
    voc_cfg = HifiGanConfig()
    results = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        rng = np.random.default_rng(16)
        motifs = [rng.integers(0, n_units, int(rng.integers(2, 6))) for _ in range(300)]
        lines = []
        for _ in range(400):
            seq = np.concatenate([motifs[j] for j in rng.integers(0, len(motifs), 40)])
            lines.append(units_to_unicode(seq[np.r_[True, seq[1:] != seq[:-1]]]))
        tok = BpeTokenizer.train(lines, 400, units_to_unicode(range(n_units)))
        tok.save(str(tmp / "tokenizer.json"))
        audio_io.write(tmp / "prompt.wav", speechlike_waves(np, np.random.default_rng(17), 1)[0], SAMPLE_RATE)

        cfm_cfg = CFMConfig(vocab_size=2000, predict_duration=True)
        decoder = ConditionalFlowMatchingWithHifiGan.from_config(
            cfm_cfg, voc_cfg, BF16_INFERENCE, generator=torch.Generator().manual_seed(1), device="cpu"
        )
        sd = {**{f"model.{k}": v for k, v in decoder.model.state_dict().items()},
              **{f"vocoder.{k}": v for k, v in decoder.vocoder.state_dict().items()}}
        write_hf_dir(torch, tmp / "decoder", sd, {"model_config": dataclasses.asdict(cfm_cfg), "vocoder_config": dataclasses.asdict(voc_cfg)})
        lm_cfg = LlamaConfig()
        lm = LlamaLM(lm_cfg, BF16_INFERENCE)
        init_random_weights(lm, torch.Generator().manual_seed(2))
        with torch.no_grad():  # a trained LM never emits ids past its tokenizer's vocabulary: zero logits there
            lm.lm_head.weight[tok.vocab_size + 2 :] = 0.0
        write_hf_dir(torch, tmp / "lm" / "hf", lm.state_dict(), {"model_type": "llama", **dataclasses.asdict(lm_cfg)})
        del decoder, lm
        config = config_from_dict({
            "model": {"path": str(tmp / "lm"), "vocab_size": tok.vocab_size, "pad_token_id": 0, "bos_token_id": None, "eos_token_id": 1},
            "s2u": {"dense_model_name": CONT_ENCODER[0], "quantizer_model_name": CONT_ENCODER[1], "vocab_size": n_units,
                    "tokenizer_path": str(tmp / "tokenizer.json")},
        })
        print(json.dumps({"phase": "continuation_setup", "seconds": time.perf_counter() - t0, "bpe_vocab": tok.vocab_size}))

        dec = ConditionalFlowMatchingWithHifiGan.from_pretrained(tmp / "decoder", device="cuda")
        runs = (("greedy", dict(temperature=0.0)), ("sampled", dict(temperature=1.0, top_k=0, top_p=1.0, seed=3)),
                ("sampled_again", dict(temperature=1.0, top_k=0, top_p=1.0, seed=3)))
        with M.mrf_stage_fusion(True):
            generate_speechlm(config, str(tmp / "prompt.wav"), max_new_tokens=4)  # warm-up: loaders, allocator
            for label, kw in runs:
                out_wav = tmp / f"{label}.wav"
                torch.cuda.synchronize()
                A.flash_attention.launches = C.assign_kernel.launches = 0
                M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = 0
                t1 = time.perf_counter()
                result = generate_speechlm(config, str(tmp / "prompt.wav"), str(out_wav), str(tmp / "decoder"), max_new_tokens=CONT_NEW_TOKENS, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
                launches = {
                    "flash_attention": A.flash_attention.launches, "codebook_assign": C.assign_kernel.launches,
                    "mrf_branch": M.mrf_branch_kernel.launches, "mrf_stage": M.mrf_stage_kernel.launches,
                }
                units, gen_units = result["units"], result["generated_units"]
                ids = torch.from_numpy(units.astype(np.int64) + 1)[None].cuda()
                frames = int(dec.model.predict_durations(ids).sum())
                bound = dec._duration_bound(ids)
                n_samples = int(voc_cfg.waveform_lengths(frames))
                # HuBERT-base to layer 6 + 16 euler steps x 4 CFM layers; 1 K4; 3 K3 in the one vocoder call
                expected = {"flash_attention": 6 + 64, "codebook_assign": 1, "mrf_branch": 0, "mrf_stage": 3}
                prompt_units = len(units) - len(gen_units)
                record = {
                    "phase": f"continuation_{label}", "prompt_units": prompt_units, "generated_units": len(gen_units),
                    "frames": frames, "decoder_bound": bound, "samples": n_samples, "launches": launches,
                    "expected": expected, "wall_seconds": wall, "audio_seconds": n_samples / SAMPLE_RATE,
                }
                print(json.dumps(record))
                if launches != expected:
                    fail(f"continuation {label}: launches {launches} != expected {expected}")
                if not out_wav.is_file() or audio_io.info(out_wav) != (SAMPLE_RATE, 1, n_samples) or result["waveform"].size != n_samples:
                    fail(f"continuation {label}: {out_wav.name} missing or not {n_samples} samples at 16 kHz")
                if len(units) == 0 or int(units.min()) < 0 or int(units.max()) >= n_units:
                    fail(f"continuation {label}: units outside [0, {n_units})")
                results[label] = {"launches": launches, "frames": frames, "bound": bound, "prompt_frames": ENC_FRAMES, "units": units}
            if not np.array_equal(results["sampled"]["units"], results["sampled_again"]["units"]):
                fail("continuation: the same seed gave different units")
            del results["sampled_again"]

            # the time split of one greedy run, piece by piece, on the loaded pieces
            enc = _make_encoder(config, device="cuda")
            lm = load_lm_from_hf(tmp / "lm" / "hf", device="cuda")
            wav, _ = audio_io.read(tmp / "prompt.wav")
            split = {}

            def clock(name, fn):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                split[name] = (time.perf_counter() - t) * 1e3
                return out

            with torch.no_grad():
                enc_units = clock("encode_ms", lambda: enc(wav)["units"]).cpu().numpy()
                prompt = torch.tensor([[t + 2 for t in tok.encode(units_to_unicode(enc_units))]], device="cuda")
                p = prompt.shape[1]
                cache = lm.init_cache(1, p + CONT_NEW_TOKENS)
                logits, _ = clock("lm_prefill_ms", lambda: lm(prompt, cache=cache, cache_index=0))
                tok_id = logits[:, -1].argmax(-1)

                def decode():
                    nonlocal tok_id
                    for i in range(CONT_NEW_TOKENS - 1):
                        step, _ = lm(tok_id[:, None], cache=cache, cache_index=p + i)
                        tok_id = step[:, -1].argmax(-1)

                clock("lm_decode_ms", decode)
                ids = torch.from_numpy(results["greedy"]["units"].astype(np.int64) + 1)[None].cuda()
                mel, _ = clock("decoder_ms", lambda: dec.model.sample(
                    ids, 0.0625, 1.0, generator=torch.Generator(device="cuda").manual_seed(0), max_frames=dec._duration_bound(ids)))
                clock("vocoder_ms", lambda: dec.vocoder(mel))
            split["ms_per_token"] = split["lm_decode_ms"] / (CONT_NEW_TOKENS - 1)
            split["tokens_per_second"] = 1e3 / split["ms_per_token"]
            print(json.dumps({"phase": "continuation_split", "prompt_tokens": p, "new_tokens": CONT_NEW_TOKENS, **split}))
            results["split"] = split
            del enc, lm, dec
    torch.cuda.empty_cache()
    return results


KERNEL_GROUPS = (
    ("flash_attention (K1)", ("flash_fwd",)),
    ("codebook_assign (K4)", ("codebook_assign", "unpack_ids")),
    ("mrf_stage (K3)", ("mrf_stage",)),
    ("mrf_branch (K2)", ("mrf_branch",)),
    # cuDNN's conv kernels are implicit GEMMs ("fprop_implicit_gemm"), so they are matched first
    ("conv (cuDNN)", ("conv", "cudnn", "fprop", "dgrad", "implicit", "winograd", "fft")),
    ("matmul (cuBLAS)", ("gemm", "cutlass")),
)


def profile_phase(torch, path: str, run, batches: int) -> None:
    """Device time by kernel group over ``run()``, and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups: dict = {}
    kernels = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0))
        name = e.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), "other (elementwise, copies)")
        groups[group] = groups.get(group, 0.0) + us / 1e3
        kernels.append((us / 1e3, e.count, e.key[:90]))
    busy = sum(groups.values())
    kernels.sort(reverse=True)
    print(json.dumps({
        "phase": "profile", "path": path, "batches": batches, "wall_ms": wall * 1e3, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / (wall * 1e3), "groups_ms": groups,
        "top_kernels": [{"ms": ms, "count": n, "name": k} for ms, n, k in kernels[:12]],
    }))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import numpy as np
        import torch.nn.functional as F

        from speech_resynth_torch.models.hifigan import HifiGanConfig
        from speech_resynth_torch.ops import attention as A
        from speech_resynth_torch.ops import codebook as C
        from speech_resynth_torch.ops import fused_mrf as M
        from speech_resynth_torch.ops.build import kernel_library
        from speech_resynth_torch.pipeline.streaming import context_frames_for
    except ImportError as e:
        print(f"chip_smoke: the speech_resynth_torch package is not importable here ({e})", file=sys.stderr)
        return 2

    def smi(fields: str) -> str:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"], capture_output=True, text=True, check=True
        ).stdout.strip().splitlines()[0]

    print(smi("name,power.limit"))
    print(json.dumps({
        "phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
        # the bounds below use the published peaks, which assume the full clocks and the 700 W limit
        "clocks_max_sm_mem": smi("clocks.max.sm,clocks.max.mem"),
    }))

    t0 = time.perf_counter()
    kernel_library()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0}))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    voc_cfg = HifiGanConfig()
    ctx = context_frames_for(voc_cfg)
    k1 = attention_phase(torch, F, A)
    k2 = mrf_phase(torch, M, voc_cfg)
    k3 = stage_phase(torch, M, voc_cfg, ctx)
    k4 = codebook_phase(torch, C)
    print(json.dumps({"phase": "kernels_checked", "kernels": ["flash_attention", "mrf_branch", "mrf_stage", "codebook_assign"]}))
    serving = slice_phase(torch, np, A, M)
    serving_fused = serving_fused_phase(torch, np, A, M, voc_cfg)
    enc, encoding = encoder_phase(torch, np, A, C)
    resynth = resynth_phase(torch, np, A, M, C, enc)
    del enc
    streaming = streaming_phase(torch, np, M)
    lm_scoring, k1_lm = lm_scoring_phase(torch, F, A, np)
    k1.append(k1_lm)
    continuation = continuation_phase(torch, np, A, C, M)
    torch.cuda.synchronize()

    # data-dependent shapes, held after their runs: the duration config's 64-multiple
    # decoder bounds (K1, K2), the streaming windows (K3), and the continuation's
    # encoder and decoder (K1, K3)
    gen = torch.Generator(device="cuda").manual_seed(9)
    for frames in sorted(set(resynth["duration_prediction"]["decoder_frames"])):
        k1.append(attention_shape(torch, F, A, gen, "resynth decoder (duration config)", ENC_BATCH, 2, frames, 128, 1, frames))
        k2.append(mrf_path(torch, M, gen, voc_cfg, "resynth decoder (duration config)", frames))
    timed_windows = {STREAM_CHUNK + ctx, STREAM_CHUNK + 2 * ctx}
    for frames in sorted(set(streaming[True]["windows"]) - timed_windows):
        k3.append(stage_path(torch, M, gen, voc_cfg, "streaming flush window", frames, 1))
    cont = continuation["greedy"]
    k1.append(attention_shape(torch, F, A, gen, "continuation encoder", 1, 12, cont["prompt_frames"], 64, cont["prompt_frames"], cont["prompt_frames"]))
    for label in ("greedy", "sampled"):
        run = continuation[label]
        k1.append(attention_shape(torch, F, A, gen, f"continuation decoder ({label})", 1, 2, run["bound"], 128, run["frames"], run["frames"]))
        k3.append(stage_path(torch, M, gen, voc_cfg, f"continuation decoder ({label})", run["bound"], 1))

    # the shape of every launch counted above, from each path's structure and frames
    by_path = {
        "serving": serving, "serving_fused": serving_fused, "encoder": encoding,
        **{f"resynth_{k}": v["launches"] for k, v in resynth.items()},
        "streaming": streaming[False]["launches"], "streaming_fused": streaming[True]["launches"],
        "lm_scoring": lm_scoring,
        **{f"continuation_{k}": continuation[k]["launches"] for k in ("greedy", "sampled")},
    }
    shapes: dict = {}

    def add(kernel, path, shape, n):
        per_path = shapes.setdefault(kernel, {}).setdefault(path, {})
        per_path[tuple(shape)] = per_path.get(tuple(shape), 0) + n

    def vocoder_call(path, frames, batch, fused):
        if fused:
            for C_, T_ in stage_shapes(voc_cfg, frames):
                add("mrf_stage", path, [batch, C_, T_], 1)
        else:
            for C_, T_, K_ in mrf_shapes(voc_cfg, frames):
                add("mrf_branch", path, [batch, C_, T_, K_], 1)

    def decoder_batch(path, frames, batch=SERVE_BATCH, fused=False):
        add("flash_attention", path, [batch, 2, frames, 128], 64)
        vocoder_call(path, frames, batch, fused)

    def encoder_batch(path, frames, batch=ENC_BATCH, layers=11, centers=2000):
        add("flash_attention", path, [batch, 12, frames, 64], layers)
        add("codebook_assign", path, [batch * frames, 768, centers], 1)

    for _ in range(serving["mrf_branch"] // 9):
        decoder_batch("serving", BUCKET)
    for _ in range(serving_fused["mrf_stage"] // 3):
        decoder_batch("serving_fused", BUCKET, fused=True)
    for _ in range(encoding["codebook_assign"]):
        encoder_batch("encoder", ENC_FRAMES)
    for label, run in resynth.items():
        for frames in run["decoder_frames"]:
            encoder_batch(f"resynth_{label}", RESYNTH_FRAMES)
            decoder_batch(f"resynth_{label}", frames)
    for fused, path in ((False, "streaming"), (True, "streaming_fused")):
        for frames in streaming[fused]["windows"]:
            vocoder_call(path, frames, 1, fused)
    add("flash_attention", "lm_scoring", [LM_BATCH, 12, LM_TOKENS, 64], 12)
    for label in ("greedy", "sampled"):
        run = continuation[label]
        encoder_batch(f"continuation_{label}", run["prompt_frames"], batch=1, layers=6, centers=CONT_ENCODER[2])
        decoder_batch(f"continuation_{label}", run["bound"], batch=1, fused=True)
    for kernel, per_path in shapes.items():
        for path, counts in per_path.items():
            if sum(counts.values()) != by_path[path][kernel]:
                fail(f"{kernel} on {path}: {by_path[path][kernel]} launches counted, {sum(counts.values())} by shape")
    for path, run in by_path.items():
        for kernel, n in run.items():
            if n and path not in shapes.get(kernel, {}):
                fail(f"{kernel} on {path}: {n} launches counted, none by shape")

    def entry(name, source, replaces, records, per, batch):
        """``batch``: (record, launches) of the unit of work ``per`` names."""
        def total(key):
            return sum(r[key] * n for r, n in batch)

        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            # launches: every path driven above, each counted from 0 just before its run
            "launches": sum(run.get(name, 0) for run in by_path.values()),
            "launches_by_path": {path: run.get(name, 0) for path, run in by_path.items()},
            "launch_shapes": {
                path: [{"shape": list(shape), "launches": n} for shape, n in counts.items()]
                for path, counts in shapes[name].items()
            },
            "per": per + ": " + " + ".join(f"{n} x {r.get('shape') or str(r['frames']) + ' frames'}" for r, n in batch),
            "max_abs_err": max(r["max_abs_err"] for r in records),
            "tol": records[0]["tol"],
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "bytes" if total("bytes_ms") >= total("ops_ms") else "operations",
            "library_ms": None if any(r["library_ms"] is None for r, _ in batch) else total("library_ms"),
            "timed": [{k: v for k, v in r.items() if k not in ("shapes", "tol")} for r in records],
        }

    def record(records, path):
        return next(r for r in records if r["path"] == path)

    plain_decoder, resynth_encoder = "resynth decoder (plain config)", "resynth encoder"
    resynth_batch = f"one batch of {ENC_BATCH} files through the plain resynthesis config"
    kernels = [
        entry("flash_attention", "speech_resynth_torch/ops/csrc/flash_attention.cu", "speech_resynth_tpu/ops/attention.py:81",
              k1, resynth_batch, [(record(k1, plain_decoder), 64), (record(k1, resynth_encoder), 11)]),
        entry("mrf_branch", "speech_resynth_torch/ops/csrc/fused_mrf.cu", "speech_resynth_tpu/ops/fused_mrf.py:378",
              k2, resynth_batch + " (nine launches)", [(record(k2, plain_decoder), 1)]),
        entry("mrf_stage", "speech_resynth_torch/ops/csrc/fused_mrf.cu", "speech_resynth_tpu/ops/fused_mrf.py:452",
              k3, f"one vocoder call on a served batch of {SERVE_BATCH} (three launches; library_ms is the per-branch "
              "route: three K2 launches, their sum and mean)", [(record(k3, "serving"), 1)]),
        entry("codebook_assign", "speech_resynth_torch/ops/csrc/codebook.cu", "speech_resynth_tpu/ops/codebook.py:29",
              k4, resynth_batch, [(record(k4, resynth_encoder), 1)]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
