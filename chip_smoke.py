#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (speech_resynth_torch) on one NVIDIA H100.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written kernels from ``speech_resynth_torch/ops/csrc``;
3. holds each kernel against its plain PyTorch version on the card, at the
   serving path's shapes in bf16 and f32 plus edge cases, and times kernel,
   plain version and (where one exists) the single PyTorch call that computes
   the same function;
4. serves requests of ~500 units through ``SynthesisServer`` at the full
   width of configs/resynth/mhubert-expresso-2000.yaml (random weights from a
   seed, bf16), counts the kernel launches of that run, and checks lengths,
   finiteness and a small-input agreement with the plain path on the CPU;
5. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}`` line.

Any failed check raises, and the script exits non-zero with no result line.
Without CUDA, or without the repository beside it, it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3

SERVE_BATCH = 16
SERVE_UNITS = 500
BUCKET = 512  # SynthesisServer's length_multiple=128 bucket for ~500 units


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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


def attention_phase(torch, F, A):
    """K1 against attention_reference; times at the serving shape."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    B, H, N, D = SERVE_BATCH, 2, BUCKET, 128
    lengths = torch.randint(SERVE_UNITS - 40, N + 1, (B,), generator=gen, device=dev)
    mask = torch.arange(N, device=dev)[None, :] < lengths[:, None]
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    worst = 0.0
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(B, H, N, D, generator=gen, device=dev).to(dtype) for _ in range(3))
        masked_row = mask.clone()
        masked_row[3] = False  # edge case: every key of row 3 masked -> mean of V
        causal_q = q[:, :, : N // 2, :64].contiguous()
        causal_k, causal_v = k[..., :64].contiguous(), v[..., :64].contiguous()
        for label, args in (
            ("serving", (q, k, v, mask, False)),
            ("all_masked_row", (q, k, v, masked_row, False)),
            ("causal_q256_k512_d64", (causal_q, causal_k, causal_v, mask, True)),
        ):
            got = A.flash_attention(*args)
            want = A.attention_reference(*args)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                fail(f"flash_attention {label} {dtype}: non-finite output")
            err = max_err(torch, got, want)
            cases.append({"case": label, "dtype": str(dtype).split(".")[-1], "max_abs_err": err, "tol": tol[dtype]})
            if err > tol[dtype]:
                fail(f"flash_attention {label} {dtype}: max abs err {err} > {tol[dtype]}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
        row_mean = v[3].float().mean(dim=1)  # (H, D): what the reference gives an all-masked row
        err = float((A.flash_attention(q, k, v, masked_row)[3].float() - row_mean[:, None, :]).abs().max())
        cases.append({"case": "all_masked_row_is_mean_of_v", "dtype": str(dtype).split(".")[-1], "max_abs_err": err, "tol": tol[dtype]})
        if err > tol[dtype]:
            fail(f"flash_attention all-masked row is not the mean of V (err {err})")
    print(json.dumps({"phase": "flash_attention_checks", "cases": cases}))

    q, k, v = (torch.randn(B, H, N, D, generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(3))
    float_mask = torch.zeros(B, 1, 1, N, device=dev, dtype=torch.bfloat16).masked_fill(~mask[:, None, None, :], A.NEG_INF)
    ms = time_ms(torch, lambda: A.flash_attention(q, k, v, mask), 50)
    plain_ms = time_ms(torch, lambda: A.attention_reference(q, k, v, mask), 20)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=float_mask), 50)
    nbytes = 4 * B * H * N * D * 2 + B * N
    bound_ms, bound_by = bound(nbytes, 4.0 * B * H * N * N * D, PEAK_BF16_FLOPS)
    entry = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "speech_resynth_torch/ops/csrc/flash_attention.cu",
        "replaces": "speech_resynth_tpu/ops/attention.py:81",
        "shape": [B, H, N, D],
        "per": "launch",
        "max_abs_err": worst,
        "tol": tol[torch.bfloat16],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
    }
    print(json.dumps({"phase": "flash_attention", **entry}))
    torch.cuda.synchronize()
    return entry


def mrf_shapes(voc_cfg, frames: int):
    """(C, T, K) of every fused-MRF launch of one serving batch."""
    shapes, t = [], frames
    for i, (rate, kernel) in enumerate(zip(voc_cfg.upsample_rates, voc_cfg.upsample_kernel_sizes)):
        t = (t - 1) * rate - 2 * ((kernel - rate) // 2) + kernel
        channels = voc_cfg.upsample_initial_channel // 2 ** (i + 1)
        if channels <= 64:
            shapes.extend((channels, t, k) for k in voc_cfg.resblock_kernel_sizes)
    return shapes


def mrf_phase(torch, M, voc_cfg):
    """K2 against mrf_branch_reference at the nine serving shapes, plus tile edges."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(2)
    dil = (1, 3, 5)
    tol = {torch.float32: 1e-3, torch.bfloat16: 6e-2}

    def operands(C, T, K, dtype, B=SERVE_BATCH):
        std = 1.0 / math.sqrt(C * K)
        x = (torch.randn(B, C, T, generator=gen, device=dev) * 0.5).to(dtype)
        w1, w2 = ((torch.randn(3, C, C, K, generator=gen, device=dev) * std).to(dtype) for _ in range(2))
        b1, b2 = ((torch.randn(3, C, generator=gen, device=dev) * 0.01).to(dtype) for _ in range(2))
        return x, w1, b1, w2, b2

    cases, per_shape = [], []
    worst = 0.0
    edge = [(64, 50, 11), (32, 1000, 7), (16, 2049, 3)]  # T below / not a multiple of the tile
    for C, T, K in mrf_shapes(voc_cfg, BUCKET) + edge:
        for dtype in (torch.bfloat16, torch.float32):
            args = operands(C, T, K, dtype, B=SERVE_BATCH if T > 5000 else 3)
            got = M.mrf_branch_kernel(*args, dil)
            want = M.mrf_branch_reference(*args, dil)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                fail(f"mrf_branch C={C} T={T} K={K} {dtype}: non-finite output")
            err = max_err(torch, got, want)
            cases.append({"C": C, "T": T, "K": K, "dtype": str(dtype).split(".")[-1], "max_abs_err": err, "tol": tol[dtype]})
            if err > tol[dtype]:
                fail(f"mrf_branch C={C} T={T} K={K} {dtype}: max abs err {err} > {tol[dtype]}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    print(json.dumps({"phase": "mrf_branch_checks", "cases": cases}))

    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    for C, T, K in mrf_shapes(voc_cfg, BUCKET):
        args = operands(C, T, K, torch.bfloat16)
        ms = time_ms(torch, lambda: M.mrf_branch_kernel(*args, dil), 5)
        plain_ms = time_ms(torch, lambda: M.mrf_branch_reference(*args, dil), 3)
        nbytes = 2 * SERVE_BATCH * C * T * 2 + 2 * 3 * (C * C * K + C) * 2
        flops = 12.0 * K * C * C * T * SERVE_BATCH
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
        per_shape.append({"C": C, "T": T, "K": K, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["bound_ms"] += b_ms
        totals["bytes_ms"] += nbytes / PEAK_BYTES * 1e3
        totals["ops_ms"] += flops / PEAK_BF16_FLOPS * 1e3
    print(json.dumps({"phase": "mrf_branch_shapes", "shapes": per_shape}))
    entry = {
        "name": "mrf_branch",
        "route": "cuda",
        "source": "speech_resynth_torch/ops/csrc/fused_mrf.cu",
        "replaces": "speech_resynth_tpu/ops/fused_mrf.py:378",
        "per": "batch: the nine serving shapes, one launch each",
        "max_abs_err": worst,
        "tol": tol[torch.bfloat16],
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes" if totals["bytes_ms"] >= totals["ops_ms"] else "operations",
        "library_ms": None,
    }
    print(json.dumps({"phase": "mrf_branch", **entry}))
    torch.cuda.synchronize()
    return entry


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

    profile_phase(torch, server, seqs[: 2 * SERVE_BATCH])
    return launches


KERNEL_GROUPS = (
    ("flash_attention (K1)", ("flash_fwd",)),
    ("mrf_branch (K2)", ("mrf_branch",)),
    # cuDNN's conv kernels are implicit GEMMs ("fprop_implicit_gemm"), so they are matched first
    ("conv (cuDNN)", ("conv", "cudnn", "fprop", "dgrad", "implicit", "winograd", "fft")),
    ("matmul (cuBLAS)", ("gemm", "cutlass")),
)


def profile_phase(torch, server, seqs) -> None:
    """Device time by kernel group over two served batches, and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.synthesize_many(seqs)
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
        "phase": "profile", "batches": len(seqs) // SERVE_BATCH, "wall_ms": wall * 1e3, "device_busy_ms": busy,
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

    k1 = attention_phase(torch, F, A)
    k2 = mrf_phase(torch, M, HifiGanConfig())
    print(json.dumps({"phase": "kernels_checked", "kernels": [k1["name"], k2["name"]]}))
    launches = slice_phase(torch, np, A, M)
    torch.cuda.synchronize()

    k1["launches"], k2["launches"] = launches["flash_attention"], launches["mrf_branch"]
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
