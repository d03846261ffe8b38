#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (speech_resynth_torch) on one NVIDIA H100.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written kernels from ``speech_resynth_torch/ops/csrc``;
3. holds each kernel against its plain PyTorch version on the card, at every
   shape the serving, encoder and resynthesis paths launch it at, in bf16 and
   f32, plus edge cases, and times kernel, plain version and (where one
   exists) the single PyTorch call that computes the same function there:
   K1 flash attention (the decoder's and HuBERT's shapes), K2 fused MRF
   branch, K4 k-means assignment. The duration config's data-dependent frame
   bounds are checked after its run;
4. serves requests of ~500 units through ``SynthesisServer`` at the full
   width of configs/resynth/mhubert-expresso-2000.yaml (random weights from a
   seed, bf16), counts the kernel launches of that run, and checks lengths,
   finiteness and a small-input agreement with the plain path on the CPU;
5. encodes 8-10 s waveforms with the full-width mHuBERT + 2000-center
   k-means encoder (random weights from a seed) and checks ids, unit counts,
   launches, padded rows against unpadded runs and the card against the CPU;
6. resynthesizes a tree of 32 WAVs (wav -> units -> wav) through
   ``pipeline.synthesize`` for both resynthesis configs (without and with
   duration prediction), counts the launches of K1, K2 and K4, and checks
   every output file's length;
7. profiles device time by kernel group, and prints one ``{"kernels": [...]}``
   line (launches of the resynthesis paths, the shape of every counted
   launch, and times summed over one plain-config resynthesis batch) and,
   last, the ``{"ok": true, ...}`` line.

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


def attention_shape(torch, F, A, gen, path: str, B: int, H: int, N: int, D: int, lo: int, hi: int) -> dict:
    """K1 against attention_reference at one shape a path launches it at:
    bidirectional, key lengths drawn in [lo, hi] (row 0 at hi), bf16 and f32;
    times in bf16 beside SDPA."""
    dev = "cuda"
    lengths = torch.randint(lo, hi + 1, (B,), generator=gen, device=dev)
    lengths[0] = hi
    mask = torch.arange(N, device=dev)[None, :] < lengths[:, None]
    errs = {}
    for name in DTYPES:
        dtype = getattr(torch, name)
        q, k, v = (torch.randn(B, H, N, D, generator=gen, device=dev).to(dtype) for _ in range(3))
        got = A.flash_attention(q, k, v, mask)
        want = A.attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        errs[name] = max_err(torch, got, want)
        if not torch.isfinite(got.float()).all() or errs[name] > ATT_TOL[name]:
            fail(f"flash_attention {path} {[B, H, N, D]} {name}: max abs err {errs[name]} > {ATT_TOL[name]}")
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    float_mask = torch.zeros(B, 1, 1, N, device=dev, dtype=torch.bfloat16).masked_fill(~mask[:, None, None, :], A.NEG_INF)
    record = {
        "path": path, "shape": [B, H, N, D], "dtype": "bfloat16", "key_lengths": [lo, hi],
        "max_abs_err": errs["bfloat16"], "f32_max_abs_err": errs["float32"], "tol": ATT_TOL,
        **timed(
            torch,
            lambda: A.flash_attention(q, k, v, mask),
            lambda: A.attention_reference(q, k, v, mask),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=float_mask),
            nbytes=4 * B * H * N * D * 2 + B * N,
            flops=4.0 * H * D * N * float(lengths.sum()),  # every query against the valid keys of its row
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

    paths = (("encoder", ENC_BATCH * ENC_FRAMES), ("resynth encoder", ENC_BATCH * RESYNTH_FRAMES))
    for path, n in paths:
        check(path, *operands(n, D, K))
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
    for path, n in paths:
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


KERNEL_GROUPS = (
    ("flash_attention (K1)", ("flash_fwd",)),
    ("codebook_assign (K4)", ("codebook_assign", "unpack_ids")),
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
    k1 = attention_phase(torch, F, A)
    k2 = mrf_phase(torch, M, voc_cfg)
    k4 = codebook_phase(torch, C)
    print(json.dumps({"phase": "kernels_checked", "kernels": ["flash_attention", "mrf_branch", "codebook_assign"]}))
    serving = slice_phase(torch, np, A, M)
    enc, encoding = encoder_phase(torch, np, A, C)
    resynth = resynth_phase(torch, np, A, M, C, enc)
    torch.cuda.synchronize()

    # the duration config's decoder ran at data-dependent 64-multiple bounds: hold K1 and K2 there too
    gen = torch.Generator(device="cuda").manual_seed(9)
    for frames in sorted(set(resynth["duration_prediction"]["decoder_frames"])):
        k1.append(attention_shape(torch, F, A, gen, "resynth decoder (duration config)", ENC_BATCH, 2, frames, 128, 1, frames))
        k2.append(mrf_path(torch, M, gen, voc_cfg, "resynth decoder (duration config)", frames))

    # the shape of every launch counted above, from each path's structure and frames
    by_path = {"serving": serving, "encoder": encoding, **{f"resynth_{k}": v["launches"] for k, v in resynth.items()}}
    shapes: dict = {}

    def add(kernel, path, shape, n):
        per_path = shapes.setdefault(kernel, {}).setdefault(path, {})
        per_path[tuple(shape)] = per_path.get(tuple(shape), 0) + n

    def decoder_batch(path, frames):
        add("flash_attention", path, [SERVE_BATCH, 2, frames, 128], 64)
        for C_, T_, K_ in mrf_shapes(voc_cfg, frames):
            add("mrf_branch", path, [SERVE_BATCH, C_, T_, K_], 1)

    def encoder_batch(path, frames):
        add("flash_attention", path, [ENC_BATCH, 12, frames, 64], 11)
        add("codebook_assign", path, [ENC_BATCH * frames, 768, 2000], 1)

    for _ in range(serving["mrf_branch"] // 9):
        decoder_batch("serving", BUCKET)
    for _ in range(encoding["codebook_assign"]):
        encoder_batch("encoder", ENC_FRAMES)
    for label, run in resynth.items():
        for frames in run["decoder_frames"]:
            encoder_batch(f"resynth_{label}", RESYNTH_FRAMES)
            decoder_batch(f"resynth_{label}", frames)
    for kernel, per_path in shapes.items():
        for path, counts in per_path.items():
            if sum(counts.values()) != by_path[path][kernel]:
                fail(f"{kernel} on {path}: {by_path[path][kernel]} launches counted, {sum(counts.values())} by shape")

    def entry(name, source, replaces, records, batch):
        """``batch``: (record, launches) of one batch of 16 files through the plain resynthesis config."""
        def total(key):
            return sum(r[key] * n for r, n in batch)

        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            # launches: the main path, wav -> units -> wav for both resynthesis configs
            "launches": sum(by_path[f"resynth_{label}"][name] for label in resynth),
            "launches_by_path": {path: run.get(name, 0) for path, run in by_path.items()},
            "launch_shapes": {
                path: [{"shape": list(shape), "launches": n} for shape, n in counts.items()]
                for path, counts in shapes[name].items()
            },
            "per": f"one batch of {ENC_BATCH} files through the plain resynthesis config: "
            + " + ".join(f"{n} x {r.get('shape') or str(r['frames']) + ' frames (nine launches)'}" for r, n in batch),
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
    kernels = [
        entry("flash_attention", "speech_resynth_torch/ops/csrc/flash_attention.cu", "speech_resynth_tpu/ops/attention.py:81",
              k1, [(record(k1, plain_decoder), 64), (record(k1, resynth_encoder), 11)]),
        entry("mrf_branch", "speech_resynth_torch/ops/csrc/fused_mrf.cu", "speech_resynth_tpu/ops/fused_mrf.py:378",
              k2, [(record(k2, plain_decoder), 1)]),
        entry("codebook_assign", "speech_resynth_torch/ops/csrc/codebook.cu", "speech_resynth_tpu/ops/codebook.py:29",
              k4, [(record(k4, resynth_encoder), 1)]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
