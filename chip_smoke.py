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
   assignment; K5, the velocity model's conv feed-forward, is held after the
   paths (step 18). Data-dependent shapes (the duration decoder's frame bounds,
   the continuation decoder's bound) are checked after their runs; prints the
   ``init`` record: three named tensors of each model an entry point draws at
   random, their std beside the std of the rule their model declares;
4. serves requests of ~500 units through ``SynthesisServer`` at the full
   width of configs/resynth/mhubert-expresso-2000.yaml (random weights from a
   seed, bf16), counts the kernel launches of that run, and checks lengths,
   finiteness and a small-input agreement with the plain path on the CPU;
   then serves one batch with stage fusion on (3 K3, no K2) against the same
   batch without it, and in f32 one mu-law batch through the server (its
   first rows within 1 code of the CPU's from the same noise) and one
   ``synthesize(..., ode_method="midpoint")`` batch (128 K1 + 9 K2) against
   the CPU. The models follow the JAX package's initializers, which
   leave a random vocoder's output near 1e-5: every comparison of a random
   model's output is relative to its reference's peak, and every PCM16
   check runs on a generator whose conv_post weight is scaled by
   ``WIRE_GAIN`` and fails where under half its codes are nonzero (a random
   duration predictor, near 0 frames a unit, takes ``DURATION_BIAS``);
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
9. runs ``continue_speech(speculative=True)`` (prompt-lookup decoding) on the
   same pieces, greedy and sampled: launches, lengths, reproducibility;
   ``lookup_decode`` against ``greedy_decode`` (equal up to a near-tie),
   tokens per iteration and ms per token beside plain decoding, and a small
   LM's speculative samples against ``sample_decode``'s distribution;
10. runs the sLM21 evaluation: ``tokenize_slm21`` (HuBERT-base + 100
   centers) over 96 word and 96 sentence pairs, then ``evaluate`` with the
   full-width LM at batch 96 (K1 causal, no mask): every name scored, the
   four aggregate numbers, one batch on the card against the CPU;
11. runs ``preprocess`` (resample with VAD, tokenize with the full-width
   mHuBERT + 2000-center encoder, extract_features) on a 24 kHz
   LibriTTS-R-shaped tree of 48 files: lengths, unit JSONs, mel frames,
   idempotence, the card's resample and mel against the CPU's, and the peak
   memory of a 40-s batch of 8 resampled from 44.1 kHz;
12. fits k-means (k = 100, 50 000 x 768, 10 Lloyd steps) on the card and on
   the CPU from the same centers;
13. trains at the full widths of configs/resynth/mhubert-expresso-2000.yaml:
   K1 through its autograd Function at the CFM step's shape (2 700, 2, 100,
   128), its output and dq, dk, dv against the plain version's, timed beside
   SDPA forward + backward; the CFM trainer on a fixed 2 700 x 100 batch (20
   steps, then remat), the HiFi-GAN trainer at 64 x 16 080 samples (10 steps,
   no K2 or K3 launch), each also one small f32 step against the CPU
   (metrics, parameters, and each tensor's gradient and update relative to
   its norm); scale ci's 16 GAN steps in f32 and its first 8 under DEFAULT
   on the card against the CPU
   (``gan_drift``: each step's losses, gradients and updates from the CPU's
   state, and the two trajectories' weight changes), beside it the
   kill/resume checks (a HiFi-GAN loop run killed with SIGKILL after a
   mid-epoch checkpoint and resumed against one run straight through, equal
   generator hashes; step 17's ``gan_longrun resume-check``); then
   ``train_flow_matching`` and ``train_hifigan`` on synthetic corpora
   (checkpoints, resume, validation through K2), with the card to
   themselves, and the exported pair synthesizing through
   ``load_pretrained``;
14. trains the speech LM at the full width of configs/speechlm/hubert.yaml:
   K1 at the LM step's shape (96, 12, 128, 64), causal with a
   ``UnitTextDataset`` batch's pad mask, its output and gradients against
   the plain version's, timed beside SDPA forward and forward + backward;
   ``make_speechlm_trainer`` on that fixed batch, LM_STEPS steps under "xla"
   (no K1) and LM_STEPS under "auto" (12 K1 a step), then remat and accum_steps = 2:
   ms per step, tokens/s, MFU, peak memory, profiles, small f32 steps
   against the CPU; ``train_speechlm`` on a seeded corpus (checkpoints, the
   export, dev sLM21 scoring through K1), ``eval_speechlm`` and
   ``generate_speechlm`` from its checkpoint, a run killed with SIGKILL
   after epoch 1's checkpoint and resumed against one straight through
   (equal LM hashes), and the loop as one torchrun-style NCCL rank against
   the single process (equal loss and hash);
15. runs the eval stack: ``NativeWhisperASR`` at large-v3's full widths
   (seeded bf16 weights written as an HF directory through the port's
   safetensors writer, a synthetic byte-level tokenizer of all 51 866 ids)
   on 8 waves of 8-10 s and one of 70 s (three windows), WHISPER_NEW_TOKENS new tokens;
   ``NativeUTMOS`` at full width from a lightning-shaped torch save and from
   safetensors on 8 waves of 1-10 s; ``pipeline.evaluate`` on the
   full-width decoder over 32 utterances with the stand-in scorers and with
   those two; K1 at Whisper's encoder and cross-attention shapes and the
   UTMOS tower's, greedy decoding and UTMOS in f32 on the card against the
   CPU; the CFM loop of step 13 also runs its dev sweep (``dev/*``
   scalars, five clips) once the HiFi-GAN loop has exported a vocoder;
16. prints the MFU of the CFM and HiFi-GAN steps of step 13 (the analytic
   counts of ``core.metrics``) and checks the loops' ``train/MFU`` and
   ``training/MFU`` in (0, 1); runs the CLIs as a user does:
   ``cli.resynth`` and ``cli.speechlm`` ``--help`` in subprocesses,
   ``cli.resynth.main(["all", ...])`` then ``main(["synthesize", ...])`` on
   a 24 kHz LibriTTS-R-shaped tree of 16 files at the widths of
   configs/resynth/mhubert-expresso-2000.yaml (batches of 6: one epoch of 2
   steps), with the checks of tests/test_cli_chain.py, and
   ``cli.speechlm.main`` ``eval`` and ``generate`` on the LM loop's
   checkpoint; calls ``graft_entry.entry()`` (the flagship decoder, 64 K1 +
   9 K2, timed); runs ``run_e2e_quality`` (scale ``E2E_SCALE``) with the JAX
   test's quality gates, beside the JAX package's numbers of E2E_QUALITY.md,
   then the quality run's GAN alone at the port's learning scale
   (``GAN_LEARNING``): the trained held-out mel-L1 at most 0.7 x the draw's;
17. runs the JAX package's tools as a user does, each a process through
   its module entry point: ``scripts.convert_checkpoints`` of all five kinds
   from sources written from seeded full-width models (mHuBERT as
   ``pytorch_model.bin`` and ``model.safetensors``, 2 000 centers as
   ``.npy``, a composite, the UTMOS ``.ckpt`` and the Whisper directory of
   step 15), the outputs loaded on the card equal to their sources (units,
   audio from the same noise, state dicts); ``scripts.fit_kmeans`` (k =
   2000 on 16 files with the converted mHuBERT: K1) and an encode through
   the fitted codebook (K4); ``scripts.gan_longrun run`` at full width (K2
   in its validations), ``report`` on its event files, and the verdict of
   ``resume-check`` (bit-equal after SIGKILL), which ran beside step 13's
   ``gan_drift``;
18. holds K5 against its plain version at every (batch, frames) the paths
   above launched it at (two launches a feed-forward call: 128 a bf16
   euler-16 decoder batch; none in f32 or where a gradient is recorded),
   timed at the served and the plain resynthesis batches beside the plain
   chain it replaced; holds and times K1, K2 and K4 at the shapes of those paths (sLM21
   tokenize and scoring, preprocess tokenize, HiFi-GAN validation, the
   CFM loop's dev sweep, the trained pair's decoder, the LM loop's scoring
   and generation, evaluate's decoder, the CLI's encoder and decoder
   batches, the entry's decoder, the quality run's f32 vocoder and pair
   scoring, fit_kmeans's encoder, gan_longrun's validation), profiles
   device time by kernel group, prints the script's wall time and one ``{"kernels": [...]}`` line (launches of every path above, the
   shape of every counted launch, and the times of each kernel at every
   timed shape) and, last, the ``{"ok": true, ...}`` line.

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
from typing import Optional

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak
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
CONT_NEW_TOKENS = 64
# the profiled decodes' tokens: the profiler's processing of an eager decode took ~100 s at 128 tokens
PROFILE_TOKENS = 16

SLM21_PAIRS = 48  # pairs per sLM21 task
SLM21_BATCH = 96  # configs/speechlm/hubert.yaml dataloader.batch_size_per_device
SLM21_ENC_BATCH = 8  # tokenize_slm21's encoder batch (20-s padding)
PRE_FILES, PRE_RATE = 48, 24000  # the LibriTTS-R-shaped tree of the preprocess phase
PRE_TOKENIZE_BATCH = 16  # configs/resynth/mhubert-expresso-2000.yaml dataset.preprocess_batch_size


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


def graph_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph and
    replayed ``reps`` times, so no host dispatch stands between the kernels
    (time_ms's loop measures the host's enqueue rate where a call takes less
    device time than its dispatch)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# A model drawn by the JAX package's initializers leaves a random vocoder's
# output near 1e-5 (conv weights N(0, 0.01)), so its waveforms are compared
# relative to the reference's peak, and a PCM16 check runs on a generator
# whose conv_post weight is scaled by WIRE_GAIN (a power of two, exact in
# bf16): with zero biases and leaky ReLUs the pre-tanh output scales with it,
# and the codes reach their range instead of all rounding to 0. At 2^18 the
# streamed mel's peak code is past the former draw's (28 491), so the
# stream's 1-code check is as strict against the peak as it was.
WIRE_GAIN = 2.0**18
WIRE_MIN_NONZERO = 0.5  # the least share of nonzero codes a wire check accepts


def as_f64(np, x):
    """A tensor (any dtype or device) or an array as a float64 array."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float64)


def rel_err(np, got, want) -> tuple:
    """(max |got - want| / max |want|, max |want|): the error relative to the
    reference's peak; infinite when the reference is all zero."""
    got, want = as_f64(np, got), as_f64(np, want)
    peak = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    return (err / peak if peak > 0 else math.inf), peak


# The same initializers leave a random duration predictor's log-durations
# within ~0.04 of 0 (a unit table of std 1/sqrt(768)), so every unit would last
# round(e^0 - 1) = 0 frames and the duration path would decode empty batches at
# its 64-frame floor. The duration-predicting decoders of the resynthesis and
# continuation phases take this bias: every unit lasts round(5 e^eps - 1) = 4
# frames, so the duration resynthesis of the 32 speech-like files decodes
# about 100 s of audio in batches of up to ~1 200 frames, and the path's
# data-dependent frame bounds follow the units' counts as they do with a
# trained predictor.
DURATION_BIAS = math.log(1 + 4)


def durations_ready(torch, model) -> None:
    """Set the CFM model's duration-predictor bias to DURATION_BIAS, in place."""
    with torch.no_grad():
        model.duration_predictor.conv.bias.fill_(DURATION_BIAS)


def wire_ready(torch, vocoder) -> None:
    """Scale the generator's conv_post weight by WIRE_GAIN, in place."""
    with torch.no_grad():
        vocoder.conv_post.weight.mul_(WIRE_GAIN)


def wire_share(np, what: str, codes) -> float:
    """The share of nonzero PCM16 codes in ``codes`` (one array or several);
    fails below WIRE_MIN_NONZERO, where a wire check would pass on silence."""
    arrays = [as_f64(np, c).ravel() for c in (codes if isinstance(codes, (list, tuple)) else [codes])]
    n = sum(a.size for a in arrays)
    share = sum(int(np.count_nonzero(a)) for a in arrays) / max(n, 1)
    if share < WIRE_MIN_NONZERO:
        fail(f"{what}: only {share:.3f} of {n} PCM16 codes are nonzero (at least {WIRE_MIN_NONZERO})")
    return share


ATT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
MRF_TOL = {"float32": 1e-3, "bfloat16": 6e-2}
# K5 against its plain version on the same bf16 operands: both sum in f32 and
# round h once, so they part by a bf16 ulp of h where the summation order or
# __expf moves it across a rounding boundary: 1e-2 of the output's peak (as
# tests/test_torch_cuda.py holds it)
FF_TOL = 1e-2
FF_PER_BATCH = 2 * 4 * 16  # K5 launches of one euler-16 decoder batch: two a feed-forward call, 4 layers
K5 = None  # speech_resynth_torch.ops.conv_ff, bound by main() once the package imports
DTYPES = ("bfloat16", "float32")


def timed(torch, fn, plain, library, nbytes: float, flops: float, peak_flops: float, iters=(50, 20, 50), graph=False) -> dict:
    """Times of the kernel, its plain version and the library call (None when
    there is none), and the bound from this input's bytes and operations.
    ``graph``: also the device times of the kernel and the library call
    (graph_ms, library_graph_ms), replayed from CUDA graphs."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    device = {"graph_ms": graph_ms(torch, fn), "library_graph_ms": graph_ms(torch, library)} if graph else {}
    return {
        **device,
        "ms": time_ms(torch, fn, iters[0]),
        "plain_ms": time_ms(torch, plain, iters[1]),
        "library_ms": None if library is None else time_ms(torch, library, iters[2]),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes,
        "ops_ms": t_ops,
    }


def attention_shape(torch, F, A, gen, path: str, B: int, H: int, N: int, D: int, lo: int, hi: int, causal: bool = False,
                    masked: bool = True, lengths=None) -> dict:
    """K1 against attention_reference at one shape a path launches it at:
    key lengths drawn in [lo, hi] (row 0 at hi), or the path's own
    ``lengths`` (B,), bidirectional or causal, bf16 and f32; times in bf16
    beside SDPA with the same mask. ``masked`` False: the kernel gets no
    mask, as the LM's scoring forward calls it (every key valid)."""
    dev = "cuda"
    if lengths is None:
        lengths = torch.randint(lo, hi + 1, (B,), generator=gen, device=dev)
        lengths[0] = hi
    if not masked:
        lengths[:] = N
    full = torch.arange(N, device=dev)[None, :] < lengths[:, None]
    mask = full if masked else None
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
    allowed = full[:, None, None, :]  # (B, 1, 1 or N, N): the (query, key) pairs this input needs
    if causal:
        allowed = allowed & torch.ones(N, N, dtype=torch.bool, device=dev).tril()
    float_mask = torch.zeros(allowed.shape, device=dev, dtype=torch.bfloat16).masked_fill(~allowed, A.NEG_INF)
    pairs = float(allowed.expand(B, 1, N, N).sum())
    record = {
        "path": path, "shape": [B, H, N, D], "dtype": "bfloat16", "key_lengths": [lo, hi] if masked else None, "causal": causal,
        # the (query block, key tile) pairs the bf16 kernel visits, from this mask on the host
        "live_tile_share": A.live_tile_share(mask, B, N, N, causal, A.QUERY_BLOCK),
        "max_abs_err": errs["bfloat16"], "f32_max_abs_err": errs["float32"], "tol": tols,
        **timed(
            torch,
            lambda: A.flash_attention(q, k, v, mask, causal),
            lambda: A.attention_reference(q, k, v, mask, causal),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=float_mask),
            # q and o, the K and V rows of the valid keys (a masked key's are never read), the mask
            nbytes=2 * B * H * N * D * 2 + 2 * H * D * 2 * int(full.sum()) + (B * N if masked else 0),
            flops=4.0 * H * D * pairs,  # every query against the keys its row and position allow
            peak_flops=PEAK_BF16_FLOPS,
            graph=True,
        ),
    }
    print(json.dumps({"phase": "flash_attention", **record}))
    return record


def tile_list_cases(torch, gen, dtype) -> list:
    """K1's tile-list edge cases, (label, (q, k, v, mask, causal)), from the
    table of the ``cuda``-marked tests (tests/test_torch_cuda.py SKIP_CASES):
    masks with holes, a row valid only in its last key tile, causal left
    padding (the first queries see only masked keys: their blocks visit every
    tile), N_k not a multiple of the 64-key tile with a fully masked row, and
    B*H above the SM count."""
    from test_torch_cuda import SKIP_CASES, skip_case_mask

    dev = "cuda"
    cases = []
    for case, B, H, Nq, Nk, D, causal in SKIP_CASES:
        q = torch.randn(B, H, Nq, D, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, H, Nk, D, generator=gen, device=dev).to(dtype) for _ in range(2))
        label = f"{case} {[B, H, Nq, Nk, D]}" + (" causal" if causal else "")
        cases.append((label, (q, k, v, skip_case_mask(case, B, Nk).to(dev), causal)))
    return cases


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
        for label, args in tile_list_cases(torch, gen, dtype):
            got = A.flash_attention(*args)
            want = A.attention_reference(*args)
            torch.cuda.synchronize()
            # causal rows near the start average few keys: outputs up to |v| ~ 4 (see attention_shape)
            case_tol = tol * max(1.0, float(want.float().abs().max()))
            err = max_err(torch, got, want)
            q_, k_, _, mask_, causal_ = args
            share = A.live_tile_share(mask_, q_.shape[0], q_.shape[2], k_.shape[2], causal_, A.QUERY_BLOCK)
            cases.append({"case": label, "dtype": name, "shape": list(q_.shape), "n_k": k_.shape[2], "causal": causal_,
                          "live_tile_share": share, "max_abs_err": err, "tol": case_tol})
            if not torch.isfinite(got.float()).all() or err > case_tol:
                fail(f"flash_attention {label} {name}: max abs err {err} > {case_tol}")
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


def mrf_operands(torch, gen, C, T, K, dtype, B, n_dilations: int = len(MRF_DILATIONS)):
    std = 1.0 / math.sqrt(C * K)
    x = (torch.randn(B, C, T, generator=gen, device="cuda") * 0.5).to(dtype)
    w1, w2 = ((torch.randn(n_dilations, C, C, K, generator=gen, device="cuda") * std).to(dtype) for _ in range(2))
    b1, b2 = ((torch.randn(n_dilations, C, generator=gen, device="cuda") * 0.01).to(dtype) for _ in range(2))
    return x, w1, b1, w2, b2


def mrf_check(torch, M, gen, C, T, K, B, dilations=MRF_DILATIONS) -> dict:
    """K2 against mrf_branch_reference at one (B, C, T, K), bf16 and f32, with
    the tile its C entry plans there."""
    errs = {}
    for name in DTYPES:
        args = mrf_operands(torch, gen, C, T, K, getattr(torch, name), B, len(dilations))
        got = M.mrf_branch_kernel(*args, dilations)
        want = M.mrf_branch_reference(*args, dilations)
        torch.cuda.synchronize()
        errs[name] = max_err(torch, got, want)
        if not torch.isfinite(got.float()).all() or errs[name] > MRF_TOL[name]:
            fail(f"mrf_branch B={B} C={C} T={T} K={K} {dilations} {name}: max abs err {errs[name]} > {MRF_TOL[name]}")
    t_tile, window, shared, _ = M.kernel_branch_plan(B, C, T, K, dilations, 2)
    return {"B": B, "C": C, "T": T, "K": K, "dilations": list(dilations), "t_tile": t_tile, "window": window,
            "shared_bytes": shared, "max_abs_err": errs["bfloat16"], "f32_max_abs_err": errs["float32"]}


def cudnn_chain(torch, F, x, w1, b1, w2, b2, dilations=MRF_DILATIONS):
    """The branch as six bf16 cuDNN convs with their lrelu and adds: a
    yardstick of speed only, with other numerics (it rounds the residual to
    bf16 at every step, where K2 keeps it in f32). The port never calls it."""
    K = w1.shape[-1]
    for j, d in enumerate(dilations):
        h = F.conv1d(F.leaky_relu(x, 0.1), w1[j], b1[j], padding=(K - 1) * d // 2, dilation=d)
        x = x + F.conv1d(F.leaky_relu(h, 0.1), w2[j], b2[j], padding=(K - 1) // 2)
    return x


def mrf_path(torch, F, M, gen, voc_cfg, path: str, frames: int, batch: int = SERVE_BATCH, launch_shapes=None) -> dict:
    """K2 at the launches of one vocoder call on ``batch`` rows of ``frames``
    frames (nine at the config's widths; ``launch_shapes``: the (C, T, K) a
    narrower generator launches, its dilations ``voc_cfg``'s): checks, and
    bf16 times summed over the call (host loop ``ms``, device ``graph_ms``,
    the plain version, and the cuDNN chain as a yardstick)."""
    shapes = []
    keys = ("ms", "graph_ms", "cudnn_chain_ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")
    totals = dict.fromkeys(keys, 0.0)
    dilations = tuple(voc_cfg.resblock_dilation_sizes[0])
    for C, T, K in launch_shapes or mrf_shapes(voc_cfg, frames):
        check = mrf_check(torch, M, gen, C, T, K, batch, dilations)
        args = mrf_operands(torch, gen, C, T, K, torch.bfloat16, batch, len(dilations))
        times = timed(
            torch,
            lambda: M.mrf_branch_kernel(*args, dilations),
            lambda: M.mrf_branch_reference(*args, dilations),
            None,
            nbytes=2 * batch * C * T * 2 + 2 * len(dilations) * (C * C * K + C) * 2,
            flops=4.0 * len(dilations) * K * C * C * T * batch,
            peak_flops=PEAK_BF16_FLOPS,
            iters=(10, 3, 0) if batch == 1 else (5, 3, 0),
        )
        times["graph_ms"] = graph_ms(torch, lambda: M.mrf_branch_kernel(*args, dilations), iters=10, reps=3)
        times["cudnn_chain_ms"] = graph_ms(torch, lambda: cudnn_chain(torch, F, *args, dilations), iters=10, reps=3)
        shapes.append({**check, **times})
        for key in totals:
            totals[key] += times[key]
    record = {
        "path": path, "frames": frames, "batch": batch, "per": f"vocoder call: {len(shapes)} launches", "dtype": "bfloat16",
        "max_abs_err": max(c["max_abs_err"] for c in shapes), "f32_max_abs_err": max(c["f32_max_abs_err"] for c in shapes),
        "tol": MRF_TOL, **totals, "bound_by": "bytes" if totals["bytes_ms"] >= totals["ops_ms"] else "operations",
        "library_ms": None, "cudnn_chain": "six bf16 cuDNN convs, lrelu and adds: a yardstick, other numerics",
        "shapes": shapes,
    }
    print(json.dumps({"phase": "mrf_branch", **record}))
    return record


def mrf_phase(torch, F, M, voc_cfg, ctx: int) -> list:
    """K2 against mrf_branch_reference at tile edges (T % 8 = 4, T odd, T
    below one tile and one tile + 1 of the widest window, short rows whose
    plan narrows the tile), then at every launch of a served batch, of a
    plain-config resynthesis batch, of the streaming windows (B = 1, stage
    fusion off) and of the continuation decoder's 512 frames (B = 1)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    edge_shapes = ((3, 64, 50, 11), (3, 32, 1000, 7), (3, 16, 2049, 3), (2, 64, 1004, 11), (2, 64, 1001, 7),
                   (2, 32, 999, 3), (1, 64, 264, 11), (1, 64, 265, 11), (1, 16, 1513, 3), (2, 16, 30, 11))
    edges = [mrf_check(torch, M, gen, C, T, K, B) for B, C, T, K in edge_shapes]
    print(json.dumps({"phase": "mrf_branch_checks", "case": "T % 8 = 4, T odd, T below / at one tile + 1, narrow plans",
                      "cases": edges, "tol": MRF_TOL}))
    records = [
        mrf_path(torch, F, M, gen, voc_cfg, "serving", BUCKET),
        mrf_path(torch, F, M, gen, voc_cfg, "resynth decoder (plain config)", RESYNTH_FRAMES),
        mrf_path(torch, F, M, gen, voc_cfg, "streaming window", STREAM_CHUNK + 2 * ctx, 1),
        mrf_path(torch, F, M, gen, voc_cfg, "streaming first window", STREAM_CHUNK + ctx, 1),
        mrf_path(torch, F, M, gen, voc_cfg, "continuation decoder", 512, 1),
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
    """K3 against mrf_stage_reference at one (B, C, T), bf16 and f32, with
    the tile its C entry plans there."""
    errs = {}
    for name in ("bfloat16", "float32"):
        x, branches = stage_operands(torch, gen, C, T, B, getattr(torch, name))
        got = M.mrf_stage_kernel(x, branches)
        want = M.mrf_stage_reference(x, branches)
        torch.cuda.synchronize()
        errs[name] = max_err(torch, got, want)
        if not torch.isfinite(got.float()).all() or errs[name] > MRF_TOL[name]:
            fail(f"mrf_stage B={B} C={C} T={T} {name}: max abs err {errs[name]} > {MRF_TOL[name]}")
    shapes = [(K, MRF_DILATIONS) for K in STAGE_KERNELS]
    t_tile, window, shared, _ = M.kernel_stage_plan(B, C, T, shapes, 2)
    return {"B": B, "C": C, "T": T, "t_tile": t_tile, "window": window, "shared_bytes": shared,
            "max_abs_err": errs["bfloat16"], "f32_max_abs_err": errs["float32"]}


def stage_path(torch, M, gen, voc_cfg, path: str, frames: int, batch: int) -> dict:
    """K3 at the three launches of one vocoder call on ``batch`` rows of
    ``frames`` frames: checks, and bf16 times summed over the call of the
    kernel (host loop ``ms``, device ``graph_ms``; its weights laid out once,
    as the generator keeps them), its plain version and the per-branch route
    (three K2 launches, their sum and mean; ``route_ms``, ``route_graph_ms``).
    No single PyTorch call computes a stage, so ``library_ms`` is None."""
    shapes = []
    keys = ("ms", "graph_ms", "plain_ms", "route_ms", "route_graph_ms", "bound_ms", "bytes_ms", "ops_ms")
    totals = dict.fromkeys(keys, 0.0)
    for C, T in stage_shapes(voc_cfg, frames):
        check = stage_check(torch, M, gen, C, T, batch)
        x, branches = stage_operands(torch, gen, C, T, batch, torch.bfloat16)
        laid_out = M.stage_operands(branches)

        def route():
            res = None
            for branch in branches:
                out = M.mrf_branch_kernel(x, *branch)
                res = out if res is None else res + out
            return res / len(branches)

        times = timed(
            torch,
            lambda: M.mrf_stage_kernel(x, laid_out),
            lambda: M.mrf_stage_reference(x, branches),
            None,
            nbytes=2 * batch * C * T * 2 + sum(2 * 3 * (C * C * K + C) * 2 for K in STAGE_KERNELS),
            flops=12.0 * sum(STAGE_KERNELS) * C * C * T * batch,
            peak_flops=PEAK_BF16_FLOPS,
            iters=(10, 3, 0) if batch == 1 else (5, 3, 0),
        )
        times["graph_ms"] = graph_ms(torch, lambda: M.mrf_stage_kernel(x, laid_out), iters=10, reps=3)
        times["route_ms"] = time_ms(torch, route, 10)
        times["route_graph_ms"] = graph_ms(torch, route, iters=10, reps=3)
        shapes.append({**check, **times})
        for key in totals:
            totals[key] += times[key]
    record = {
        "path": path, "frames": frames, "batch": batch, "per": "vocoder call: three launches", "dtype": "bfloat16",
        "max_abs_err": max(c["max_abs_err"] for c in shapes), "f32_max_abs_err": max(c["f32_max_abs_err"] for c in shapes),
        "tol": MRF_TOL, **totals, "bound_by": "bytes" if totals["bytes_ms"] >= totals["ops_ms"] else "operations",
        "library_ms": None, "route": "three K2 launches, their sum and mean", "shapes": shapes,
    }
    print(json.dumps({"phase": "mrf_stage", **record}))
    print(json.dumps({
        "phase": "mrf_stage_vs_route", "path": path, "batch": batch, "frames": frames,
        "k3_graph_ms": totals["graph_ms"], "route_graph_ms": totals["route_graph_ms"],
        "k3_over_route": totals["graph_ms"] / totals["route_graph_ms"], "k3_host_ms": totals["ms"],
        "route_host_ms": totals["route_ms"], "bound_ms": totals["bound_ms"], "per_launch": [
            {"C": c["C"], "T": c["T"], "k3": c["graph_ms"], "route": c["route_graph_ms"]} for c in shapes],
    }))
    return record


def stage_phase(torch, M, voc_cfg, ctx: int) -> list:
    """K3 against mrf_stage_reference at tile edges (T below one tile, not a
    multiple of it, odd, and B = 1 rows whose plan narrows the tile), then at
    every launch of a served batch, of a plain-config resynthesis batch (K2's
    shape) and of the streaming windows (the first, left-pinned one and the
    interior one, which the flush of a long stream reuses)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    edge_shapes = ((3, 64, 50), (3, 64, 1000), (3, 32, 1000), (3, 16, 137), (3, 16, 2049), (2, 64, 265), (2, 32, 999),
                   (1, 64, 7540), (1, 16, 1513))
    edges = [stage_check(torch, M, gen, C, T, B) for B, C, T in edge_shapes]
    print(json.dumps({"phase": "mrf_stage_checks", "case": "T below / not a multiple of the tile, T odd, narrow B = 1 plans",
                      "cases": edges, "tol": MRF_TOL}))
    records = [
        stage_path(torch, M, gen, voc_cfg, "serving", BUCKET, SERVE_BATCH),
        stage_path(torch, M, gen, voc_cfg, "resynth decoder (plain config)", RESYNTH_FRAMES, SERVE_BATCH),
        stage_path(torch, M, gen, voc_cfg, "streaming window", STREAM_CHUNK + 2 * ctx, 1),
        stage_path(torch, M, gen, voc_cfg, "streaming first window", STREAM_CHUNK + ctx, 1),
    ]
    torch.cuda.synchronize()
    return records


SCORE_TOL = 1e-5  # K4: the score a flipped near-tie may give up, relative to |best| + 1 (3xTF32 keeps f32 accuracy)


def clear_of_ties(torch, C, x, centers):
    """Frames whose two best scores differ by more than 1e-3 * (|best| + 1):
    there another summation order cannot flip the winner."""
    score = x.float() @ centers.float().T - C.half_sq_norms(centers)
    top2 = score.topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]) > 1e-3 * (top2[:, 0].abs() + 1)


def score_given_up(C, x, centers, got, want):
    """The score each frame's id gives up against the best (0 unless a
    near-tie flipped): absolute, and relative to |best| + 1."""
    score = x.float() @ centers.T - C.half_sq_norms(centers)
    best = score.gather(1, want.long()[:, None])[:, 0]
    lost = (best - score.gather(1, got.long()[:, None])[:, 0]).abs()
    return float(lost.max()), float((lost / (best.abs() + 1)).max())


def codebook_check(torch, C, label, x, centers) -> tuple:
    """K4 against assign_reference on (x, centers): (ids, case record); fails
    on a clear frame's mismatch, an equal share under 0.999, a flipped
    near-tie that gives up more than SCORE_TOL, or an id out of range."""
    got = C.assign_kernel(x, centers)
    want = C.assign_reference(x, centers)
    torch.cuda.synchronize()
    err, rel = score_given_up(C, x, centers, got, want)
    clear = clear_of_ties(torch, C, x, centers)
    case = {
        "case": label, "N": x.shape[0], "D": x.shape[1], "K": centers.shape[0], "dtype": str(x.dtype).split(".")[-1],
        "equal_share": float((got == want).float().mean()), "clear_frame_mismatches": int((got != want)[clear].sum()),
        "near_tie_frames": int((~clear).sum()), "max_abs_score_err": err, "max_rel_score_err": rel,
    }
    if (case["clear_frame_mismatches"] or case["equal_share"] < 0.999 or rel > SCORE_TOL
            or int(got.min()) < 0 or int(got.max()) >= centers.shape[0]):
        fail(f"codebook_assign {case}")
    return got, case


CODEBOOK_TOL = ("ids equal where the top-2 score gap exceeds 1e-3*(|top|+1); max_abs_err is the score given up by a "
                f"flipped near-tie, at most {SCORE_TOL}*(|best|+1)")


def codebook_shape(torch, C, gen, path: str, n: int, k: int, d: int = 768) -> dict:
    """K4 held against assign_reference at one (n, d, k) a path launches it
    at, and timed (f32) beside its plain version and addmm + argmax."""
    x, c = torch.randn(n, d, generator=gen, device="cuda"), torch.randn(k, d, generator=gen, device="cuda")
    _, case = codebook_check(torch, C, path, x, c)
    ops = C.codebook_operands(c)  # made once, as KMeansQuantizer makes them
    half = ops[2]
    record = {
        "path": path, "shape": [n, d, k], "dtype": "float32", "max_abs_err": case["max_abs_score_err"], "check": case,
        "tol": CODEBOOK_TOL,
        **timed(
            torch,
            lambda: C.assign_kernel(x, c, ops),
            lambda: C.assign_reference(x, c),
            lambda: torch.addmm(-half, x, c.T).argmax(dim=-1),  # cuBLAS SGEMM, TF32 off
            nbytes=4 * (n * d + k * d) + 4 * n,
            flops=3 * 2.0 * n * d * k,  # f32-accurate products on the tensor cores: three TF32 products
            peak_flops=PEAK_TF32_FLOPS,
            iters=(20, 20, 20),
            graph=True,
        ),
        "bound_peak": "H100 SXM TF32 tensor cores, 495 TFLOP/s, three products (3xTF32): the floor for f32-accurate products",
        "f32_cuda_core_bound_ms": 2.0 * n * d * k / PEAK_F32_FLOPS * 1e3,
    }
    print(json.dumps({"phase": "codebook_assign", **record}))
    return record


def codebook_phase(torch, C) -> list:
    """K4 against assign_reference at the encoder's and the resynthesis
    path's shapes, plus edge cases; times at the path shapes."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(4)
    D, K = 768, 2000

    def operands(n, d, k, dtype=torch.float32):
        return torch.randn(n, d, generator=gen, device=dev).to(dtype), torch.randn(k, d, generator=gen, device=dev)

    cases = []

    def check(label, x, centers):
        got, case = codebook_check(torch, C, label, x, centers)
        cases.append(case)
        return got

    paths = (
        ("encoder", ENC_BATCH * ENC_FRAMES, K),
        ("resynth encoder", ENC_BATCH * RESYNTH_FRAMES, K),
        ("continuation encoder", ENC_FRAMES, CONT_ENCODER[2]),  # one 10-s prompt, 100 centers: the narrow 64 x 32 block tile
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

    # the control: plain TF32 products (cuBLAS, TF32 on) at the resynthesis
    # shape, read by the same measures; what a kernel without the low halves gives
    x, c = operands(ENC_BATCH * RESYNTH_FRAMES, D, K)
    want = C.assign_reference(x, c)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_ids = torch.addmm(-C.half_sq_norms(c), x, c.T).argmax(dim=-1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err, rel = score_given_up(C, x, c, tf32_ids, want)
    clear = clear_of_ties(torch, C, x, c)
    tf32_control = {
        "case": "tf32_control (cuBLAS TF32 addmm + argmax, not a kernel of the port)", "N": x.shape[0], "K": K,
        "equal_share": float((tf32_ids == want).float().mean()), "clear_frame_mismatches": int((tf32_ids != want)[clear].sum()),
        "max_abs_score_err": err, "max_rel_score_err": rel, "over_score_tol": rel > SCORE_TOL,
    }

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
    print(json.dumps({
        "phase": "codebook_assign_checks",
        "rule": f"ids equal where top-2 gap > 1e-3*(|top|+1); equal share >= 0.999; score given up <= {SCORE_TOL}*(|best|+1)",
        "cases": cases, "control": tf32_control,
    }))
    records = [codebook_shape(torch, C, gen, path, n, k) for path, n, k in paths]
    torch.cuda.synchronize()
    return records


def ff_module(torch):
    """The velocity model's feed-forward at the config's widths (C 256, I
    896) under BF16_INFERENCE on the card, its weights and biases drawn from a
    seed: the operands of the K5 checks and the plain chain they are timed
    beside."""
    from speech_resynth_torch.core.precision import BF16_INFERENCE
    from speech_resynth_torch.models.cfm import CFMConfig
    from speech_resynth_torch.models.transformer import ConvFeedForward

    cfg = CFMConfig()
    ff = ConvFeedForward(cfg.hidden_size, cfg.intermediate_size, policy=BF16_INFERENCE)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in ff.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (0.5 if p.dim() == 1 else (3 * p.shape[1]) ** -0.5))
    return ff.cuda().eval().requires_grad_(False)


def conv_ff_shape(torch, ff, gen, path: str, B: int, N: int, timed_run: bool = False) -> dict:
    """K5 against conv_ff_reference on ``ff``'s laid-out weights, on (B, N)
    frames with a padded-tail mask (row 0 full), the input masked as the
    module masks it; fails past FF_TOL of the reference's peak. With
    ``timed_run``, one feed-forward call timed: the kernel (host loop and
    device time from a CUDA graph) beside the plain chain (``ff``'s cuDNN
    route, its input mask included: the yardstick K5 replaced), and the bound
    from the call's bytes and operations."""
    c, i = ff.conv2.out_channels, ff.conv2.in_channels
    x = torch.randn(B, N, c, generator=gen, device="cuda")
    lengths = torch.randint(1, N + 1, (B,), generator=gen, device="cuda")
    lengths[0] = N
    mask = torch.arange(N, device="cuda")[None, :] < lengths[:, None]
    x = x.masked_fill(~mask[..., None], 0).to(torch.bfloat16)
    ops = ff.operands()
    with torch.no_grad():
        got = K5.conv_ff_kernel(x, ops, mask)
        want = K5.conv_ff_reference(x, ops, mask)
    torch.cuda.synchronize()
    err, peak = max_err(torch, got, want), float(want.float().abs().max())
    record = {"path": path, "shape": [B, N, c, i], "dtype": "bfloat16", "max_abs_err": err, "ref_peak": peak, "tol": FF_TOL}
    if not torch.isfinite(got.float()).all() or not err <= FF_TOL * peak:
        fail(f"conv_ff against conv_ff_reference: {record}")
    if timed_run:
        def kernel():
            K5.conv_ff_kernel(x, ops, mask)

        def chain():
            ff.route = lambda x_, dropout_on=False: "plain chain"  # this call's route only
            try:
                ff(x, mask)
            finally:
                del ff.route

        with torch.no_grad():
            times = timed(torch, kernel, chain, None,
                          nbytes=2.0 * B * N * (2 * c + 2 * i) + 2.0 * 9 * c * i + B * N + 4.0 * (2 * i + c),
                          flops=18.0 * B * N * c * i, peak_flops=PEAK_BF16_FLOPS, iters=(20, 10, 0))
            times["graph_ms"] = graph_ms(torch, kernel, iters=10, reps=3)
            times["plain_graph_ms"] = graph_ms(torch, chain, iters=10, reps=3)
        record.update(times, plain="the plain chain: cuDNN convs with their layout copies, bias, SiGLU and mask passes")
    print(json.dumps({"phase": "conv_ff", **record}))
    return record


def speechlike_waves(np, rng, n: int, seconds=(8, 10), rate: int = SAMPLE_RATE):
    """``n`` seeded waveforms of 8-10 s (or ``seconds``; the first the
    longest) at ``rate``: a gliding voiced tone with harmonics under a
    syllable-rate envelope, plus noise."""
    lengths = rng.integers(int(seconds[0] * rate), int(seconds[1] * rate) + 1, n)
    lengths[0] = int(seconds[1] * rate)
    waves = []
    for length in lengths:
        t = np.arange(int(length)) / rate
        f0 = rng.uniform(90, 220) * (1 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t))
        phase = 2 * np.pi * np.cumsum(f0) / rate
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
            wire_ready(torch, decoder.vocoder)  # the written PCM16 files' codes reach their range
            if predict_duration:
                durations_ready(torch, decoder.model)
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
            A.flash_attention.launches = M.mrf_branch_kernel.launches = C.assign_kernel.launches = K5.conv_ff_kernel.launches = 0
            t0 = time.perf_counter()
            synthesize(config("test-*", tgt), encoder, decoder)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {
                "flash_attention": A.flash_attention.launches,
                "codebook_assign": C.assign_kernel.launches,
                "mrf_branch": M.mrf_branch_kernel.launches,
                "conv_ff": K5.conv_ff_kernel.launches,
            }
            n_batches = RESYNTH_FILES // ENC_BATCH
            expected = {"flash_attention": (11 + 64) * n_batches, "codebook_assign": n_batches, "mrf_branch": 9 * n_batches,
                        "conv_ff": FF_PER_BATCH * n_batches}
            print(json.dumps({"phase": f"resynth_{label}_launches", "launches": launches, "expected": expected}))
            if launches != expected:
                fail(f"{label} resynthesis launches {launches} != expected {expected} (11+64 K1, 1 K4, 9 K2, 128 K5 per batch)")

            # every output file, with the length its frames give (frames recomputed
            # here), and the frames each batch's decoder ran at
            out_samples, in_samples, frames_seen, decoder_frames, written = 0, 0, [], [], []
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
                    written.append(audio_io.read(path)[0])
                    out_samples += want
            audio_s = out_samples / SAMPLE_RATE
            print(json.dumps({
                "phase": f"resynth_{label}", "files": RESYNTH_FILES, "batch": ENC_BATCH,
                "input_audio_seconds": in_samples / SAMPLE_RATE, "audio_seconds": audio_s, "wall_seconds": wall,
                "realtime_factor": audio_s / wall, "frames_per_file": [min(frames_seen), max(frames_seen)],
                "decoder_frames_per_batch": decoder_frames, "wire_gain": WIRE_GAIN,
                "nonzero_code_share": wire_share(np, f"{label} resynthesis files", written),
            }))
            profile_phase(torch, f"resynth_{label}", lambda: synthesize(config("test-a", Path(tmp) / f"prof_{label}"), encoder, decoder), 1)
            results[label] = {"launches": launches, "decoder_frames": decoder_frames}
            del decoder
            torch.cuda.empty_cache()
    return results


# (model, tensor, rule) of the init record: three named tensors of each model an
# entry point draws at random, and the rule its model declares for each
INIT_TENSORS = (
    ("vocoder", "conv_pre.weight", ("normal", 0.01)),
    ("vocoder", "upsampler.0.weight", ("normal", 0.01)),
    ("vocoder", "resblocks.12.convs1.0.weight", ("normal", 0.01)),
    ("cfm", "to_cond_emb.weight", ("embed",)),
    ("cfm", "to_embed.weight", ("lecun",)),
    ("cfm", "transformer.layers.0.4.conv1.weight", ("lecun",)),
    ("mpd", "discriminators.0.convs.1.v", ("he",)),
    ("mpd", "discriminators.4.convs.3.v", ("he",)),
    ("mpd", "discriminators.2.conv_post.v", ("he",)),
    ("msd", "discriminators.0.convs.1.weight", ("he",)),
    ("msd", "discriminators.1.convs.3.v", ("he",)),
    ("msd", "discriminators.0.convs.5.u", ("normal", 1.0)),
    ("hubert", "feature_extractor.conv_layers.0.conv.weight", ("he",)),
    ("hubert", "encoder.pos_conv_embed.conv.weight", ("he",)),
    ("hubert", "encoder.layers.0.attention.q_proj.weight", ("lecun",)),
    ("llama", "model.embed_tokens.weight", ("embed",)),
    ("llama", "model.layers.0.mlp.down_proj.weight", ("lecun",)),
    ("llama", "lm_head.weight", ("lecun",)),
)


def init_phase(torch, np) -> list:
    """The random weights of each model a port entry point draws, at full
    width and through those entry points (``from_config``'s decoder,
    ``train.hifigan.build_models``' discriminators, ``SpeechEncoder.by_name``'s
    seeded mHuBERT, the LM trainer's draw): the std of three named tensors of
    each beside the std of the rule its model declares (the JAX package's
    initializers), within 4 / sqrt(n) + 0.02 of their ratio; a truncated
    rule's draw (lecun_normal, he_normal) inside its cut at 2 / 0.8796 of
    that std."""
    import warnings

    from speech_resynth_torch.core.precision import FLOAT32
    from speech_resynth_torch.models.cfm import CFMConfig
    from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan, init_random_weights
    from speech_resynth_torch.models.hifigan import HifiGanConfig
    from speech_resynth_torch.models.llama import LlamaConfig, LlamaLM
    from speech_resynth_torch.models.speech_encoder import SpeechEncoder
    from speech_resynth_torch.train.hifigan import build_models

    decoder = ConditionalFlowMatchingWithHifiGan.from_config(CFMConfig(vocab_size=2000), HifiGanConfig(), FLOAT32,
                                                             generator=torch.Generator().manual_seed(0), device="cpu")
    _, mpd, msd = build_models(HifiGanConfig(), FLOAT32, seed=0, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the seeded tower's "randomly initialized" warning
        hubert = SpeechEncoder.by_name(*ENCODER, policy=FLOAT32, device="cpu").encoder
    llama = LlamaLM(LlamaConfig(), FLOAT32)
    init_random_weights(llama, torch.Generator().manual_seed(0))
    models = {"vocoder": decoder.vocoder, "cfm": decoder.model, "mpd": mpd, "msd": msd, "hubert": hubert, "llama": llama}
    records = []
    for model, name, rule in INIT_TENSORS:
        w = as_f64(np, models[model].state_dict()[name])
        fan_in = math.prod(w.shape[1:])
        want = {"normal": lambda: rule[1], "embed": lambda: 1 / math.sqrt(w.shape[-1]), "lecun": lambda: math.sqrt(1 / fan_in),
                "he": lambda: math.sqrt(2 / fan_in)}[rule[0]]()
        cut = 2 / 0.87962566103423978 * want if rule[0] in ("lecun", "he") else None
        record = {"model": model, "tensor": name, "shape": list(w.shape), "rule": rule[0], "rule_std": want, "std": float(w.std()),
                  "mean": float(w.mean()), "max_abs": float(np.abs(w).max()), "cut": cut}
        records.append(record)
        if (abs(record["std"] / want - 1) > 4 / math.sqrt(w.size) + 0.02 or abs(record["mean"]) > 4 * want / math.sqrt(w.size)
                or cut is not None and record["max_abs"] > cut * (1 + 1e-6)):
            fail(f"init: {record}")
    print(json.dumps({"phase": "init", "tensors": records}))
    return records


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
    wire_ready(torch, decoder.vocoder)  # the served PCM16 codes reach their range
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
    A.flash_attention.launches = M.mrf_branch_kernel.launches = K5.conv_ff_kernel.launches = 0
    t1 = time.perf_counter()
    wavs = server.synthesize_many(seqs)
    wall = time.perf_counter() - t1
    launches = {"flash_attention": A.flash_attention.launches, "mrf_branch": M.mrf_branch_kernel.launches,
                "conv_ff": K5.conv_ff_kernel.launches}
    expected = {"flash_attention": 64 * n_batches, "mrf_branch": 9 * n_batches, "conv_ff": FF_PER_BATCH * n_batches}
    print(json.dumps({"phase": "slice_launches", "launches": launches, "expected": expected}))
    if launches != expected:
        fail(f"kernel launches {launches} != expected {expected} (64 K1 + 128 K5 + 9 K2 per euler-16 batch)")

    for seq, wav in zip(seqs, wavs):
        if wav.dtype != np.int16 or wav.shape != (int(voc_cfg.waveform_lengths(len(seq))),):
            fail(f"request of {len(seq)} units: waveform {wav.dtype} {wav.shape} != waveform_lengths")
    audio_s = sum(len(w) for w in wavs) / 16000.0
    print(json.dumps({
        "phase": "slice", "requests": len(seqs), "batch": SERVE_BATCH, "units": [int(min(map(len, seqs))), int(max(map(len, seqs)))],
        "audio_seconds": audio_s, "wall_seconds": wall, "realtime_factor": audio_s / wall, "wire_gain": WIRE_GAIN,
        "nonzero_code_share": wire_share(np, "served PCM16", wavs),
        "peak_code": int(max(np.abs(w.astype(np.int32)).max() for w in wavs)),
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
    mel_err, mel_peak = rel_err(np, outs["cuda"][0], outs["cpu"][0])
    wav_err, wav_peak = rel_err(np, outs["cuda"][1], outs["cpu"][1])
    # f32 on both sides (TF32 off); the sums run in another order on the card.
    # Errors relative to the CPU reference's peak: log-mels of O(10) (5e-5 is
    # at least as strict as the former absolute 2e-3 for any peak up to 40),
    # waveforms in [-1, 1] (2e-3 of a peak of at most 1)
    tol = {"mel": 5e-5, "wav": 2e-3}
    print(json.dumps({"phase": "slice_vs_cpu_plain", "mel_max_rel_err": mel_err, "wav_max_rel_err": wav_err,
                      "mel_ref_peak": mel_peak, "wav_ref_peak": wav_peak, "tol": tol}))
    if not torch.equal(outs["cuda"][2], outs["cpu"][2]) or mel_err > tol["mel"] or wav_err > tol["wav"]:
        fail(f"card f32 synthesis differs from the CPU plain path: mel {mel_err}, waveform {wav_err} (relative)")

    profile_phase(torch, "serving", lambda: server.synthesize_many(seqs[: 2 * SERVE_BATCH]), 2)
    return launches


def serving_fused_phase(torch, np, A, M, voc_cfg):
    """One served batch of 16 x ~500 units at full width with stage fusion on:
    3 K3 and no K2 launches, and the waveforms of the same batch (same noise)
    without fusion. bf16: the stage rounds the branch mean once where the
    per-branch route rounds each branch, its sum and its mean, a few bf16
    ulps of the O(1) activations at each of the three narrow stages
    (5e-2 of the per-branch waveforms' peak)."""
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
                K5.conv_ff_kernel.launches = 0
            t0 = time.perf_counter()
            outs[fused] = server.synthesize_many(seqs)
            walls[fused] = time.perf_counter() - t0
            if fused:
                launches = {
                    "flash_attention": A.flash_attention.launches,
                    "mrf_branch": M.mrf_branch_kernel.launches,
                    "mrf_stage": M.mrf_stage_kernel.launches,
                    "conv_ff": K5.conv_ff_kernel.launches,
                }
    expected = {"flash_attention": 64, "mrf_branch": 0, "mrf_stage": 3, "conv_ff": FF_PER_BATCH}
    print(json.dumps({"phase": "serving_fused_launches", "launches": launches, "expected": expected}))
    if launches != expected:
        fail(f"fused serving launches {launches} != expected {expected} (64 K1 + 128 K5 + 3 K3 per batch)")
    tol = 5e-2  # relative to the per-branch batch's peak
    shapes_ok = all(a.shape == b.shape == (int(voc_cfg.waveform_lengths(len(s))),) for a, b, s in zip(outs[True], outs[False], seqs))
    err, peak = (rel_err(np, np.concatenate(outs[True]), np.concatenate(outs[False])) if shapes_ok else (math.inf, 0.0))
    audio_s = sum(len(w) for w in outs[True]) / SAMPLE_RATE
    print(json.dumps({
        "phase": "serving_fused", "requests": SERVE_BATCH, "max_rel_err_vs_per_branch": err, "ref_peak": peak, "tol": tol,
        "audio_seconds": audio_s, "wall_seconds_fused": walls[True], "wall_seconds_per_branch": walls[False],
        "realtime_factor_fused": audio_s / walls[True], "realtime_factor_per_branch": audio_s / walls[False],
    }))
    if not shapes_ok or err > tol or not all(np.isfinite(w).all() for w in outs[True]):
        fail(f"fused serving differs from the per-branch route: max rel err {err} (tol {tol}), shapes ok {shapes_ok}")
    with M.mrf_stage_fusion(True):
        server = SynthesisServer(decoder, batch_size=SERVE_BATCH, dt=0.0625, truncation_value=1.0, pcm16=True)
        profile_phase(torch, "serving_fused", lambda: server.synthesize_many(seqs + seqs), 2)
    del decoder
    torch.cuda.empty_cache()
    return launches


OPTIONS_CPU_ROWS = 2  # the rows of the options' batches recomputed on the CPU (each row is computed alone)


def serving_options_phase(torch, np, A, M) -> dict:
    """The serving options no earlier run took on the card, at the full
    width of configs/resynth/mhubert-expresso-2000.yaml in f32 on both sides
    (TF32 off), one batch of SERVE_BATCH x ~500 units each:

    * mu-law: ``SynthesisServer(..., mulaw=True)`` on a generator whose
      conv_post is scaled by WIRE_GAIN; its first OPTIONS_CPU_ROWS requests
      recomputed on the CPU (``synthesize(..., mulaw=True)``) from the noise
      the server drew (its generator, seed 0, drawn again), every code
      within 1; the share of codes other than silence's (fails under
      WIRE_MIN_NONZERO);
    * midpoint: ``synthesize(..., ode_method="midpoint")`` of the same ids
      and noise on the generator without the gain, its first rows against
      the CPU's relative to the CPU waveform's peak (2e-3, the f32 tolerance
      of ``slice_vs_cpu_plain``).

    Launches: 64 K1 + 9 K2 for the Euler batch at dt 0.0625, 128 K1 (two
    velocity evaluations a step) + 9 K2 for the midpoint one."""
    from speech_resynth_torch.core.precision import FLOAT32
    from speech_resynth_torch.dsp.mulaw import mulaw_encode
    from speech_resynth_torch.models.cfm import CFMConfig
    from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan
    from speech_resynth_torch.pipeline.serving import SynthesisServer

    cfm_cfg = CFMConfig(vocab_size=2000)
    decoders = {dev: ConditionalFlowMatchingWithHifiGan.from_config(cfm_cfg, policy=FLOAT32, generator=torch.Generator().manual_seed(0),
                                                                    device=dev) for dev in ("cuda", "cpu")}
    voc_cfg = decoders["cuda"].vocoder.config
    rng = np.random.default_rng(17)
    seqs = [rng.integers(1, cfm_cfg.vocab_size + 1, int(n)).astype(np.int64) for n in rng.integers(SERVE_UNITS - 20, SERVE_UNITS + 1, SERVE_BATCH)]
    ids = np.zeros((SERVE_BATCH, BUCKET), np.int64)
    for j, seq in enumerate(seqs):
        ids[j, : len(seq)] = seq
    rows = ids[:OPTIONS_CPU_ROWS]
    # the noise the server draws for its one batch: its generator (seed 0) on the card, one randn call
    x0 = torch.randn((SERVE_BATCH, BUCKET, cfm_cfg.dim_in), generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    x0_rows = x0[:OPTIONS_CPU_ROWS].cpu()
    runs, launches, expected = {}, {}, {}

    for dec in decoders.values():
        wire_ready(torch, dec.vocoder)
    server = SynthesisServer(decoders["cuda"], batch_size=SERVE_BATCH, dt=0.0625, truncation_value=1.0, mulaw=True)
    torch.cuda.synchronize()
    A.flash_attention.launches = M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = K5.conv_ff_kernel.launches = 0
    t0 = time.perf_counter()
    codes = server.synthesize_many(seqs)
    wall = time.perf_counter() - t0
    launches["mulaw"] = {"flash_attention": A.flash_attention.launches, "mrf_branch": M.mrf_branch_kernel.launches,
                         "mrf_stage": M.mrf_stage_kernel.launches, "conv_ff": K5.conv_ff_kernel.launches}
    expected["mulaw"] = {"flash_attention": 64, "mrf_branch": 9, "mrf_stage": 0, "conv_ff": 0}  # f32: the plain chain
    cpu_codes, cpu_lengths = decoders["cpu"].synthesize(rows, dt=0.0625, truncation_value=1.0, x0=x0_rows, mulaw=True)
    silence = int(mulaw_encode(torch.zeros(1))[0])
    shapes_ok = all(c.dtype == np.uint8 and c.shape == (int(voc_cfg.waveform_lengths(len(q))),) for c, q in zip(codes, seqs))
    worst = max(int(np.abs(codes[j].astype(np.int32) - cpu_codes[j, : int(cpu_lengths[j])].numpy().astype(np.int32)).max())
                for j in range(OPTIONS_CPU_ROWS)) if shapes_ok else math.inf
    share = sum(int(np.count_nonzero(c != silence)) for c in codes) / sum(c.size for c in codes)
    runs["mulaw"] = {"wall_seconds": wall, "audio_seconds": sum(c.size for c in codes) / SAMPLE_RATE, "max_code_diff_vs_cpu": worst,
                     "tol_codes": 1, "cpu_rows": OPTIONS_CPU_ROWS, "silence_code": silence, "non_silence_share": share,
                     "wire_gain": WIRE_GAIN}

    with torch.no_grad():
        for dec in decoders.values():
            dec.vocoder.conv_post.weight.div_(WIRE_GAIN)  # a power of two: the draw again, exactly
    torch.cuda.synchronize()
    A.flash_attention.launches = M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = K5.conv_ff_kernel.launches = 0
    t0 = time.perf_counter()
    wav, lengths = decoders["cuda"].synthesize(ids, dt=0.0625, truncation_value=1.0, x0=x0, ode_method="midpoint")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["midpoint"] = {"flash_attention": A.flash_attention.launches, "mrf_branch": M.mrf_branch_kernel.launches,
                            "mrf_stage": M.mrf_stage_kernel.launches, "conv_ff": K5.conv_ff_kernel.launches}
    expected["midpoint"] = {"flash_attention": 128, "mrf_branch": 9, "mrf_stage": 0, "conv_ff": 0}
    cpu_wav, cpu_len = decoders["cpu"].synthesize(rows, dt=0.0625, truncation_value=1.0, x0=x0_rows, ode_method="midpoint")
    err, peak = rel_err(np, wav[:OPTIONS_CPU_ROWS], cpu_wav)
    runs["midpoint"] = {"wall_seconds": wall, "max_rel_err_vs_cpu": err, "ref_peak": peak, "tol": 2e-3, "cpu_rows": OPTIONS_CPU_ROWS,
                        "lengths_equal": bool(torch.equal(lengths[:OPTIONS_CPU_ROWS].cpu(), cpu_len))}
    record = {"phase": "serving_options", "batch": SERVE_BATCH, "bucket": BUCKET, "runs": runs, "launches": launches,
              "expected": expected}
    print(json.dumps(record))
    if (launches != expected or not shapes_ok or worst > 1 or share < WIRE_MIN_NONZERO or err > 2e-3
            or not runs["midpoint"]["lengths_equal"] or not torch.isfinite(wav).all()):
        fail(f"serving options: {record}")
    del decoders, server
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
    for name, policy in (("bfloat16", BF16_INFERENCE), ("float32", FLOAT32), ("float32_wire", FLOAT32)):
        gen = HifiGanGenerator(voc_cfg, policy)
        init_random_weights(gen, torch.Generator().manual_seed(0))
        gens[name] = gen.to("cuda").eval()
    wire_ready(torch, gens["float32_wire"])  # the PCM16 stream's codes reach their range
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

    # tolerances against the batch run, relative to its peak: f32 (TF32 off)
    # differs in summation order only; bf16 may flip a rounding of the
    # activations wherever the window-shaped and whole-utterance convs sum in
    # another order, a few bf16 ulps at the output (5e-2, as for fused
    # serving); PCM16 (the WIRE_GAIN generator) within 1 code
    results = {}
    for name, fused, wire, tol in (
        ("bfloat16", False, "f32", 5e-2),  # warm-up of both routes, then the timed streams
        ("bfloat16", True, "f32", 5e-2),
        ("bfloat16", False, "f32", 5e-2),
        ("bfloat16", True, "f32", 5e-2),
        ("float32", True, "f32", 1e-4),
        ("float32", False, "f32", 1e-4),
        ("float32_wire", True, "pcm16", 1),
    ):
        got, sv, windows, launches, times = stream(name, fused, wire)
        want = batch(name, fused, wire)
        if got.shape != want.shape:
            fail(f"stream {name} fused={fused} wire={wire}: {got.shape} samples, the batch run {want.shape}")
        if wire == "pcm16":
            err, peak = float(np.abs(got.astype(np.int32) - want.astype(np.int32)).max()), int(np.abs(want.astype(np.int32)).max())
            extra = {"max_abs_code_err_vs_batch": err, "ref_peak_code": peak, "wire_gain": WIRE_GAIN,
                     "nonzero_code_share": wire_share(np, f"stream {name} PCM16", got)}
        else:
            err, peak = rel_err(np, got, want)
            extra = {"max_rel_err_vs_batch": err, "ref_peak": peak}
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
            "phase": "streaming", "dtype": name.split("_")[0], "stage_fusion": fused, "wire": wire, "frames": STREAM_FRAMES,
            "chunk": STREAM_CHUNK, "ctx": sv.ctx, "device_calls": sv.device_calls, "expected_calls": expected_calls,
            "window_frames": sorted(set(windows)), "launches": launches, "expected_launches": expected,
            **extra, "tol": tol, "ttfa_ms": times["ttfa_ms"],
            "ms_per_window": times["wall_s"] * 1e3 / sv.device_calls, "audio_seconds": audio_s,
            "realtime_factor": audio_s / times["wall_s"],
        }
        print(json.dumps(record))
        if err > tol or sv.device_calls != expected_calls or launches != expected:
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


def train_bpe(np, BpeTokenizer, units_to_unicode, n_units: int):
    """The port's BPE trained on 400 seeded deduplicated unit strings built
    from 300 motifs of 2-5 units: a 400-token vocabulary over ``n_units``."""
    rng = np.random.default_rng(16)
    motifs = [rng.integers(0, n_units, int(rng.integers(2, 6))) for _ in range(300)]
    lines = []
    for _ in range(400):
        seq = np.concatenate([motifs[j] for j in rng.integers(0, len(motifs), 40)])
        lines.append(units_to_unicode(seq[np.r_[True, seq[1:] != seq[:-1]]]))
    return BpeTokenizer.train(lines, 400, units_to_unicode(range(n_units)))


LM_MODEL = dict(vocab_size=16384, hidden_size=768, intermediate_size=3072, num_hidden_layers=12, num_attention_heads=12,
                pad_token_id=0, bos_token_id=None, eos_token_id=1)  # configs/speechlm/hubert.yaml model


def continuation_config(config_from_dict, tmp: Path):
    """configs/speechlm/hubert.yaml's model and s2u sections over the pieces in ``tmp``."""
    return config_from_dict({
        "model": {"path": str(tmp / "lm"), **LM_MODEL},
        "s2u": {"dense_model_name": CONT_ENCODER[0], "quantizer_model_name": CONT_ENCODER[1], "vocab_size": CONT_ENCODER[2],
                "tokenizer_path": str(tmp / "tokenizer.json")},
    })


def continuation_phase(torch, np, A, C, M, tmp: Path) -> dict:
    """Textless speech continuation (``generate_speechlm``) at full width with
    stage fusion on: a BPE tokenizer trained by the port on seeded unit
    strings, a 10-s prompt wav, the -duration-prediction decoder and the LM
    (a trainer checkpoint, and an HF directory for the speculative phase) as
    local directories under ``tmp`` with seeded random weights (left there
    for the later phases), then greedy and seeded sampled runs of 128
    new tokens; launches, output lengths, unit range and reproducibility;
    and the time split of one run."""
    import dataclasses

    from speech_resynth_torch.core.checkpoint import CheckpointManager
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
    t0 = time.perf_counter()
    tok = train_bpe(np, BpeTokenizer, units_to_unicode, n_units)
    tok.save(str(tmp / "tokenizer.json"))
    audio_io.write(tmp / "prompt.wav", speechlike_waves(np, np.random.default_rng(17), 1)[0], SAMPLE_RATE)

    cfm_cfg = CFMConfig(vocab_size=2000, predict_duration=True)
    decoder = ConditionalFlowMatchingWithHifiGan.from_config(
        cfm_cfg, voc_cfg, BF16_INFERENCE, generator=torch.Generator().manual_seed(1), device="cpu"
    )
    wire_ready(torch, decoder.vocoder)  # the continuations' PCM16 codes reach their range
    durations_ready(torch, decoder.model)
    sd = {**{f"model.{k}": v for k, v in decoder.model.state_dict().items()},
          **{f"vocoder.{k}": v for k, v in decoder.vocoder.state_dict().items()}}
    write_hf_dir(torch, tmp / "decoder", sd, {"model_config": dataclasses.asdict(cfm_cfg), "vocoder_config": dataclasses.asdict(voc_cfg)})
    lm_cfg = LlamaConfig()
    lm = LlamaLM(lm_cfg, BF16_INFERENCE)
    init_random_weights(lm, torch.Generator().manual_seed(2))
    with torch.no_grad():  # a trained LM never emits ids past its tokenizer's vocabulary: zero logits there
        lm.lm_head.weight[tok.vocab_size + 2 :] = 0.0
    write_hf_dir(torch, tmp / "lm" / "hf", lm.state_dict(), {"model_type": "llama", **dataclasses.asdict(lm_cfg)})
    with CheckpointManager(tmp / "lm" / "ckpt") as ckpt:  # generate_speechlm's LM: the trainer's checkpoint
        ckpt.save(1, {"step": 1, "modules": {"model": {k: v.float() for k, v in lm.state_dict().items()}}, "optimizers": {}})
    del decoder, lm
    config = continuation_config(config_from_dict, tmp)
    print(json.dumps({"phase": "continuation_setup", "seconds": time.perf_counter() - t0, "bpe_vocab": tok.vocab_size}))

    dec = ConditionalFlowMatchingWithHifiGan.from_pretrained(tmp / "decoder", device="cuda")
    runs = (("greedy", dict(temperature=0.0)), ("sampled", dict(temperature=1.0, top_k=0, top_p=1.0, seed=3)),
            ("sampled_again", dict(temperature=1.0, top_k=0, top_p=1.0, seed=3)))
    with M.mrf_stage_fusion(True):
        generate_speechlm(config, str(tmp / "prompt.wav"), max_new_tokens=4)  # warm-up: loaders, allocator
        for label, kw in runs:
            out_wav = tmp / f"{label}.wav"
            torch.cuda.synchronize()
            A.flash_attention.launches = C.assign_kernel.launches = K5.conv_ff_kernel.launches = 0
            M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = 0
            t1 = time.perf_counter()
            result = generate_speechlm(config, str(tmp / "prompt.wav"), str(out_wav), str(tmp / "decoder"), max_new_tokens=CONT_NEW_TOKENS, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = {
                "flash_attention": A.flash_attention.launches, "codebook_assign": C.assign_kernel.launches,
                "mrf_branch": M.mrf_branch_kernel.launches, "mrf_stage": M.mrf_stage_kernel.launches,
                "conv_ff": K5.conv_ff_kernel.launches,
            }
            units, gen_units = result["units"], result["generated_units"]
            ids = torch.from_numpy(units.astype(np.int64) + 1)[None].cuda()
            frames = int(dec.model.predict_durations(ids).sum())
            bound = dec._duration_bound(ids)
            n_samples = int(voc_cfg.waveform_lengths(frames))
            # HuBERT-base to layer 6 + 16 euler steps x 4 CFM layers; 1 K4; 3 K3 in the one vocoder call
            expected = {"flash_attention": 6 + 64, "codebook_assign": 1, "mrf_branch": 0, "mrf_stage": 3, "conv_ff": FF_PER_BATCH}
            prompt_units = len(units) - len(gen_units)
            record = {
                "phase": f"continuation_{label}", "prompt_units": prompt_units, "generated_units": len(gen_units),
                "frames": frames, "decoder_bound": bound, "samples": n_samples, "launches": launches,
                "expected": expected, "wall_seconds": wall, "audio_seconds": n_samples / SAMPLE_RATE,
            }
            if not out_wav.is_file() or audio_io.info(out_wav) != (SAMPLE_RATE, 1, n_samples) or result["waveform"].size != n_samples:
                fail(f"continuation {label}: {out_wav.name} missing or not {n_samples} samples at 16 kHz")
            record.update(wire_gain=WIRE_GAIN, nonzero_code_share=wire_share(np, f"continuation {label}", audio_io.read(out_wav)[0]))
            print(json.dumps(record))
            if launches != expected:
                fail(f"continuation {label}: launches {launches} != expected {expected}")
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


def write_slm21_tree(np, audio_io, root: Path) -> dict:
    """An sLM21-shaped tree: ``lexical/test`` (SLM21_PAIRS word pairs of
    0.4-1.2 s) and ``syntactic/test`` (SLM21_PAIRS sentence pairs of 2-5 s),
    speech-like waves from a seed, and each task's gold.csv (id, filename,
    correct, frequency or type, subset). Returns {task: [names]}."""
    rng = np.random.default_rng(20)
    names = {}
    for task, by, cats, seconds in (("lexical", "frequency", ("high", "mid", "low", "oov"), (0.4, 1.2)),
                                    ("syntactic", "type", ("agreement", "anaphor", "binding", "filler_gap"), (2, 5))):
        waves = speechlike_waves(np, rng, 2 * SLM21_PAIRS, seconds)
        rows, names[task] = [], []
        for pair in range(SLM21_PAIRS):
            for correct in (1, 0):
                name = f"{task[:3]}_{pair:03d}_{correct}"
                audio_io.write(root / task / "test" / f"{name}.wav", waves[2 * pair + 1 - correct], SAMPLE_RATE)
                rows.append(f"{pair},{name}.wav,{correct},{cats[pair % len(cats)]},test")
                names[task].append(name)
        (root / task / "gold.csv").write_text(f"id,filename,correct,{by},subset\n" + "\n".join(rows) + "\n")
    return names


def slm21_phase(torch, np, A, C) -> dict:
    """The speech LM's sLM21 evaluation at full width: ``tokenize_slm21``
    (HuBERT-base to layer 6 + 100 centers, random weights from a seed, batch
    8 at 20-s padding, the continuation phase's BPE) over an sLM21-shaped
    tree, then ``evaluate`` with the 12 x 768 LM (random weights, bf16) at
    batch_size_per_device 96: launches, every name scored and finite, the
    four aggregate numbers in [0, 1], and one scoring batch in f32 on the
    card against the CPU."""
    from speech_resynth_torch.core.config import config_from_dict
    from speech_resynth_torch.core.precision import BF16_INFERENCE, FLOAT32
    from speech_resynth_torch.dsp import audio_io
    from speech_resynth_torch.models.composite import init_random_weights
    from speech_resynth_torch.models.hubert import HubertConfig
    from speech_resynth_torch.models.llama import LlamaConfig, LlamaLM, sequence_pseudo_log_prob
    from speech_resynth_torch.pipeline.data import load_named_units_from_json
    from speech_resynth_torch.pipeline.slm21_native import read_score_file
    from speech_resynth_torch.pipeline.speechlm import evaluate, tokenize_slm21
    from speech_resynth_torch.text.units import units_to_unicode
    from speech_resynth_torch.tokenizers.bpe import BpeTokenizer

    with tempfile.TemporaryDirectory(prefix="chip_smoke_slm21_") as tmp:
        tmp = Path(tmp)
        names = write_slm21_tree(np, audio_io, tmp / "sLM21")
        tok = train_bpe(np, BpeTokenizer, units_to_unicode, CONT_ENCODER[2])
        tok.save(str(tmp / "tokenizer.json"))
        unit = tmp / "unit"
        config = config_from_dict({
            "dataset": {
                "swuggy_dev_file": str(unit / "lexical/dev.json"), "sblimp_dev_file": str(unit / "syntactic/dev.json"),
                "swuggy_test_file": str(unit / "lexical/test.json"), "sblimp_test_file": str(unit / "syntactic/test.json"),
                "swuggy_dir": str(tmp / "sLM21/lexical"), "sblimp_dir": str(tmp / "sLM21/syntactic"),
                "result_dir": str(tmp / "results"),
            },
            "dataloader": {"batch_size_per_device": SLM21_BATCH},
            "model": {"vocab_size": tok.vocab_size, "pad_token_id": 0, "bos_token_id": None, "eos_token_id": 1},
            "s2u": {"dense_model_name": CONT_ENCODER[0], "quantizer_model_name": CONT_ENCODER[1], "vocab_size": CONT_ENCODER[2],
                    "tokenizer_path": str(tmp / "tokenizer.json")},
        })
        tokenize_slm21(config, device="cuda")  # warm-up: the encoder's load, cuDNN plans
        torch.cuda.synchronize()
        A.flash_attention.launches = C.assign_kernel.launches = 0
        t0 = time.perf_counter()
        tokenize_slm21(config, device="cuda")
        torch.cuda.synchronize()
        tokenize_s = time.perf_counter() - t0
        tokenize_launches = {"flash_attention": A.flash_attention.launches, "codebook_assign": C.assign_kernel.launches}
        n_files = sum(len(v) for v in names.values())
        enc_batches = sum(-(-len(v) // SLM21_ENC_BATCH) for v in names.values())
        expected = {"flash_attention": 6 * enc_batches, "codebook_assign": enc_batches}
        print(json.dumps({"phase": "slm21_tokenize", "files": n_files, "batches": enc_batches, "seconds": tokenize_s,
                          "files_per_second": n_files / tokenize_s, "launches": tokenize_launches, "expected": expected}))
        if tokenize_launches != expected:
            fail(f"tokenize_slm21 launches {tokenize_launches} != expected {expected} (6 K1 + 1 K4 per batch)")
        tokenized = {task: json.loads((unit / task / "test.json").read_text()) for task in names}
        for task, items in tokenized.items():
            if sorted(items) != sorted(names[task]) or not all(items.values()):
                fail(f"tokenize_slm21 {task}: names {len(items)} of {len(names[task])}, or an empty BPE sequence")

        cfg = LlamaConfig()
        lm = LlamaLM(cfg, BF16_INFERENCE)
        init_random_weights(lm, torch.Generator().manual_seed(21))
        lm = lm.to("cuda").eval()
        batches = {task: list(load_named_units_from_json(str(unit / task / "test.json"), SLM21_BATCH, 2)) for task in names}
        scoring_shapes = [list(b["input_ids"].shape) for task in names for b in batches[task]]
        evaluate(config, lm)  # warm-up
        torch.cuda.synchronize()
        A.flash_attention.launches = 0
        t1 = time.perf_counter()
        result = evaluate(config, lm)
        torch.cuda.synchronize()
        evaluate_s = time.perf_counter() - t1
        scoring_launches = {"flash_attention": A.flash_attention.launches}
        expected = {"flash_attention": cfg.num_hidden_layers * len(scoring_shapes)}
        for task in names:
            scores = read_score_file(tmp / "results" / task / "test.txt")
            if list(scores) != list(tokenized[task]) or not all(math.isfinite(v) for v in scores.values()):
                fail(f"sLM21 {task}: {len(scores)} scores for {len(names[task])} names, or a non-finite score")
        csv_rows = (tmp / "results/scores/score.csv").read_text().splitlines()
        if scoring_launches != expected or result is None or len(csv_rows) != 5 or not all(0.0 <= v <= 1.0 for v in result.values()):
            fail(f"sLM21 evaluate: launches {scoring_launches} (expected {expected}), result {result}, score.csv {csv_rows}")
        ids = torch.from_numpy(batches["syntactic"][0]["input_ids"]).to("cuda", torch.long)
        with torch.inference_mode():
            batch_ms = time_ms(torch, lambda: sequence_pseudo_log_prob(lm(ids)[0], ids), 5)
        profile_phase(torch, "slm21_tokenize", lambda: tokenize_slm21(config, device="cuda"), enc_batches)
        profile_phase(torch, "slm21_scoring", lambda: evaluate(config, lm), len(scoring_shapes))
        items = sum(len(v) for v in names.values())
        print(json.dumps({
            "phase": "slm21_scoring", "items": items, "batch": SLM21_BATCH, "scoring_batch_shapes": scoring_shapes,
            "launches": scoring_launches, "expected": expected, "evaluate_seconds": evaluate_s,
            "items_per_second": items / evaluate_s, "ms_per_scoring_batch": batch_ms,
            "ms_per_scoring_batch_shape": list(ids.shape), "result": result,
        }))
        del lm
        torch.cuda.empty_cache()

        # one scoring batch in f32 (TF32 off), the card against the CPU's plain path: O(10)
        # per-token log-probs averaged over the row, summed in another order through 12 layers
        ids = torch.from_numpy(batches["lexical"][0]["input_ids"]).long()
        outs = {}
        for device in ("cuda", "cpu"):
            lm32 = LlamaLM(cfg, FLOAT32)
            init_random_weights(lm32, torch.Generator().manual_seed(21))
            lm32 = lm32.to(device).eval()
            with torch.inference_mode():
                outs[device] = sequence_pseudo_log_prob(lm32(ids.to(device))[0], ids.to(device)).cpu()
            del lm32
        tol = 1e-3
        err = float((outs["cuda"] - outs["cpu"]).abs().max())
        print(json.dumps({"phase": "slm21_scoring_vs_cpu_plain", "shape": list(ids.shape), "max_abs_err": err, "tol": tol}))
        if err > tol or not torch.isfinite(outs["cuda"]).all():
            fail(f"card f32 sLM21 scores differ from the CPU plain path: {err}")
    torch.cuda.empty_cache()
    frames = [HubertConfig().num_frames(int(s * SAMPLE_RATE)) for s in (0.4, 5)]  # the files' frame range
    return {"tokenize": tokenize_launches, "frames": frames, "scoring": scoring_launches, "scoring_shapes": scoring_shapes,
            "encoder_batches": enc_batches, "tokenize_seconds": tokenize_s, "items_per_second": items / evaluate_s,
            "ms_per_scoring_batch": batch_ms}


def continuation_speculative_phase(torch, np, A, C, M, tmp: Path) -> dict:
    """``continue_speech(speculative=True)`` at B = 1 with stage fusion on,
    on the continuation phase's prompt, LM, tokenizer and decoder (in
    ``tmp``), greedy and sampled (twice with one seed), each with the
    prompt's encoding, as ``generate_speechlm`` runs it: launches, unit range,
    output length, reproducibility. Then ``lookup_decode`` against
    ``greedy_decode`` on the prompt (equal, or equal up to a near-tie:
    tests/test_torch_cuda.py's rule), EOS handling of ``lookup_sample_decode``,
    tokens per iteration and ms per token beside plain decoding in this run,
    and a small LM's speculative samples against ``sample_decode``'s by
    total variation (N = 4 096, T = 4; at most max(3 x noise floor, 0.06))."""
    from test_torch_cuda import speculative_greedy_divergence

    from speech_resynth_torch.core.config import config_from_dict
    from speech_resynth_torch.core.precision import FLOAT32
    from speech_resynth_torch.dsp import audio_io
    from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan, init_random_weights
    from speech_resynth_torch.models.hifigan import HifiGanConfig
    from speech_resynth_torch.models.llama import (
        LlamaConfig, LlamaLM, greedy_decode, lookup_decode, lookup_sample_decode, sample_decode,
    )
    from speech_resynth_torch.pipeline.generate import continue_speech
    from speech_resynth_torch.pipeline.speechlm import _make_encoder, load_lm_from_hf
    from speech_resynth_torch.text.units import units_to_unicode
    from speech_resynth_torch.tokenizers.bpe import BpeTokenizer

    voc_cfg = HifiGanConfig()
    tok = BpeTokenizer.from_file(str(tmp / "tokenizer.json"))
    config = continuation_config(config_from_dict, tmp)
    enc = _make_encoder(config, device="cuda")
    lm = load_lm_from_hf(tmp / "lm" / "hf", device="cuda")
    dec = ConditionalFlowMatchingWithHifiGan.from_pretrained(tmp / "decoder", device="cuda")
    wav, _ = audio_io.read(tmp / "prompt.wav")
    n_units = CONT_ENCODER[2]
    results = {}
    runs = (("greedy", dict(temperature=0.0)), ("sampled", dict(temperature=1.0, seed=3)), ("sampled_again", dict(temperature=1.0, seed=3)))
    with M.mrf_stage_fusion(True):
        continue_speech(enc(wav)["units"].cpu().numpy(), tok, lm, dec, max_new_tokens=4, speculative=True)  # warm-up
        for label, kw in runs:
            generator = torch.Generator(device="cuda").manual_seed(kw.pop("seed", 0))
            torch.cuda.synchronize()
            A.flash_attention.launches = C.assign_kernel.launches = K5.conv_ff_kernel.launches = 0
            M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = 0
            t0 = time.perf_counter()
            prompt_units = enc(wav)["units"].cpu().numpy()
            result = continue_speech(prompt_units, tok, lm, dec, max_new_tokens=CONT_NEW_TOKENS, eos_token_id=1,
                                     num_special_tokens=2, generator=generator, speculative=True, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {
                "flash_attention": A.flash_attention.launches, "codebook_assign": C.assign_kernel.launches,
                "mrf_branch": M.mrf_branch_kernel.launches, "mrf_stage": M.mrf_stage_kernel.launches,
                "conv_ff": K5.conv_ff_kernel.launches,
            }
            units = result["units"]
            ids = torch.from_numpy(units.astype(np.int64) + 1)[None].cuda()
            frames = int(dec.model.predict_durations(ids).sum())
            bound = dec._duration_bound(ids)
            n_samples = int(voc_cfg.waveform_lengths(frames))
            expected = {"flash_attention": 6 + 64, "codebook_assign": 1, "mrf_branch": 0, "mrf_stage": 3, "conv_ff": FF_PER_BATCH}
            codes = np.round(np.clip(result["waveform"], -1.0, 1.0) * 32767.0)  # as the port's pcm16_encode
            print(json.dumps({
                "phase": f"continuation_speculative_{label}", "prompt_units": len(prompt_units),
                "generated_units": len(result["generated_units"]), "frames": frames, "decoder_bound": bound,
                "samples": n_samples, "launches": launches, "expected": expected, "wall_seconds": wall,
                "wire_gain": WIRE_GAIN, "nonzero_code_share": wire_share(np, f"speculative continuation {label}", codes),
            }))
            if launches != expected:
                fail(f"speculative continuation {label}: launches {launches} != expected {expected}")
            if result["waveform"].size != n_samples or not np.isfinite(result["waveform"]).all():
                fail(f"speculative continuation {label}: waveform of {result['waveform'].size} samples, not {n_samples}")
            if len(units) == 0 or int(units.min()) < 0 or int(units.max()) >= n_units:
                fail(f"speculative continuation {label}: units outside [0, {n_units})")
            results[label] = {"launches": launches, "frames": frames, "bound": bound, "prompt_frames": ENC_FRAMES, "units": units}
    if not np.array_equal(results["sampled"]["units"], results["sampled_again"]["units"]):
        fail("speculative continuation: the same seed gave different units")
    del results["sampled_again"]

    # the decoders on the prompt's tokens: the greedy rule, EOS handling, and speed beside plain decoding
    prompt = torch.tensor([[t + 2 for t in tok.encode(units_to_unicode(prompt_units))]], device="cuda")
    report = speculative_greedy_divergence(lm, prompt, CONT_NEW_TOKENS)
    print(json.dumps({"phase": "continuation_speculative_greedy_rule", "prompt_tokens": prompt.shape[1], **report}))
    if not report["ok"]:
        fail(f"lookup_decode differs from greedy_decode away from a near-tie: {report}")
    sampled = lookup_sample_decode(lm, prompt, CONT_NEW_TOKENS, 1, torch.Generator(device="cuda").manual_seed(5))[0, prompt.shape[1]:]
    hits = (sampled == 1).nonzero()
    if int(sampled.min()) < 0 or int(sampled.max()) >= lm.config.vocab_size or (len(hits) and not (sampled[int(hits[0]):] == 1).all()):
        fail("lookup_sample_decode: ids out of range, or not EOS after the first EOS")

    def clocked(fn):
        fn()  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    speed = {}
    for label, plain_fn, spec_fn in (
        ("greedy", lambda: greedy_decode(lm, prompt, CONT_NEW_TOKENS),
         lambda: lookup_decode(lm, prompt, CONT_NEW_TOKENS, return_stats=True)),
        ("sampled", lambda: sample_decode(lm, prompt, CONT_NEW_TOKENS, 1, torch.Generator(device="cuda").manual_seed(6)),
         lambda: lookup_sample_decode(lm, prompt, CONT_NEW_TOKENS, 1, torch.Generator(device="cuda").manual_seed(6), return_stats=True)),
    ):
        _, plain_ms = clocked(plain_fn)
        (_, stats), spec_ms = clocked(spec_fn)
        speed[label] = {**stats, "speculative_ms_per_token": spec_ms / max(stats["generated"], 1),
                        "plain_ms_per_token": plain_ms / CONT_NEW_TOKENS, "speculative_ms": spec_ms, "plain_ms": plain_ms}
    print(json.dumps({"phase": "continuation_speculative_speed", "prompt_tokens": prompt.shape[1], "new_tokens": CONT_NEW_TOKENS,
                      "note": "prefill included; B = 1; bf16", **speed}))
    profile_phase(torch, "lm_greedy_decode", lambda: greedy_decode(lm, prompt, PROFILE_TOKENS), 1)
    profile_phase(torch, "lm_lookup_decode", lambda: lookup_decode(lm, prompt, PROFILE_TOKENS), 1)
    results["speed"] = speed
    del enc, lm, dec
    torch.cuda.empty_cache()

    # distribution: a small f32 LM, 4 096 rows of one prompt, four new tokens
    small = LlamaLM(LlamaConfig(vocab_size=50, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2), FLOAT32)
    init_random_weights(small, torch.Generator().manual_seed(7))
    small = small.cuda().eval()
    N, T = 4096, 4
    rows = torch.tensor([[2, 3, 4, 2, 3]], device="cuda").repeat(N, 1)
    kw = dict(temperature=0.8, top_k=8, top_p=0.9)
    ref, ctl = (sample_decode(small, rows, T, 1, torch.Generator(device="cuda").manual_seed(s), **kw)[:, 5:].cpu().numpy() for s in (0, 1))
    got = lookup_sample_decode(small, rows, T, 1, torch.Generator(device="cuda").manual_seed(2), ngram=2, spec_tokens=3, **kw)[:, 5:].cpu().numpy()

    def tv(a, b, t):
        ha, hb = (np.bincount(x[:, t], minlength=50) / len(x) for x in (a, b))
        return 0.5 * float(np.abs(ha - hb).sum())

    tvs = [{"t": t, "tv": tv(ref, got, t), "noise_floor": tv(ref, ctl, t)} for t in range(T)]
    print(json.dumps({"phase": "continuation_speculative_distribution", "N": N, "T": T, "bound": "max(3 x noise floor, 0.06)", "tv": tvs}))
    if any(r["tv"] > max(3 * r["noise_floor"], 0.06) for r in tvs):
        fail(f"lookup_sample_decode's marginals differ from sample_decode's: {tvs}")
    return results


def write_libritts_tree(np, audio_io, root: Path, files: int = PRE_FILES, train: int = 32, dev: int = 8) -> dict:
    """A LibriTTS-R-shaped tree at 24 kHz: ``files`` speech-like files of
    4-10 s, each with 0.2-0.6 s of near-silence before and after (for the
    VAD), and its ``.normalized.txt``; ``train`` in ``train-clean-100``,
    ``dev`` in ``dev-clean``, the rest in ``test-clean``. Returns {name: samples}."""
    rng = np.random.default_rng(22)
    lengths = {}
    for i, wave in enumerate(speechlike_waves(np, rng, files, (4, 10), PRE_RATE)):
        split = "train-clean-100" if i < train else "dev-clean" if i < train + dev else "test-clean"
        pads = rng.integers(int(0.2 * PRE_RATE), int(0.6 * PRE_RATE), 2)
        wave = np.concatenate([0.001 * rng.standard_normal(pads[0]), wave, 0.001 * rng.standard_normal(pads[1])]).astype(np.float32)
        name = f"{split}/{100 + i % 5}/{i:03d}/{100 + i % 5}_{i:03d}_000001"
        audio_io.write(root / f"{name}.wav", wave, PRE_RATE)
        (root / f"{name}.normalized.txt").write_text(f"utterance number {i}\n")
        lengths[name] = len(wave)
    return lengths


def preprocess_phase(torch, np, A, C) -> dict:
    """``preprocess`` (resample with VAD, tokenize, extract_features) on a
    LibriTTS-R-shaped tree at 24 kHz with the full-width mHuBERT + 2000-center
    encoder of configs/resynth/mhubert-expresso-2000.yaml (random weights from
    a seed): launches of the tokenize stage; sample rates and lengths before
    and after the trim; every file in the unit JSONs with as many units as
    durations, transcripts where the tree has them; mel frame counts;
    idempotence; the card's resample and log-mel against the CPU's; and one
    40-s batch of 8 at 44.1 kHz, whose peak memory shows the polyphase form's
    O(T)."""
    from speech_resynth_torch.core.config import config_from_dict
    from speech_resynth_torch.dsp import audio_io
    from speech_resynth_torch.dsp.mel import log_mel_spectrogram
    from speech_resynth_torch.dsp.resample import resample as resample_op
    from speech_resynth_torch.models.hubert import HubertConfig
    from speech_resynth_torch.pipeline import preprocess as P

    with tempfile.TemporaryDirectory(prefix="chip_smoke_pre_") as tmp:
        tmp = Path(tmp)
        lengths = write_libritts_tree(np, audio_io, tmp / "orig")

        def config(wav_dir, vad):
            return config_from_dict({
                "dataset": {
                    "wav_dir": str(tmp / wav_dir), "wav_dir_orig": str(tmp / "orig"), "spectrogram_dir": str(tmp / wav_dir / "spectrogram"),
                    "vad": vad, "preprocess_batch_size": 16, "ext_audio": ".wav",
                    "train_file": str(tmp / "units/train.json"), "dev_file": str(tmp / "units/dev.json"),
                    "test_file": str(tmp / "units/test.json"),
                },
                "flow_matching": {"dense_model_name": ENCODER[0], "quantizer_model_name": ENCODER[1], "vocab_size": ENCODER[2]},
            })

        # the lengths before the trim: the resample stage without VAD
        P.resample(config("untrimmed", False), device="cuda")
        untrimmed = {}
        for name, n in lengths.items():
            info = audio_io.info(tmp / "untrimmed" / f"{name}.wav")
            untrimmed[name] = info[2]
            if info != (SAMPLE_RATE, 1, -(-n * SAMPLE_RATE // PRE_RATE)):
                fail(f"resample: {name} is {info}, not 16 kHz mono of ceil({n} * 2 / 3) samples")

        stage_s = {}
        stages = {k: getattr(P, k) for k in ("resample", "tokenize", "extract_features")}

        def clocked(name):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = stages[name](*args, **kwargs)
                torch.cuda.synchronize()
                stage_s[name] = time.perf_counter() - t
                return out
            return run

        cfg = config("16k", True)
        A.flash_attention.launches = C.assign_kernel.launches = 0
        for name in stages:
            setattr(P, name, clocked(name))
        try:
            t0 = time.perf_counter()
            P.preprocess(cfg, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for name, fn in stages.items():
                setattr(P, name, fn)
        launches = {"flash_attention": A.flash_attention.launches, "codebook_assign": C.assign_kernel.launches}
        split_files = {"train": 32, "dev": 8, "test": 8}
        batches = [min(PRE_TOKENIZE_BATCH, n - i) for n in split_files.values() for i in range(0, n, PRE_TOKENIZE_BATCH)]
        expected = {"flash_attention": 11 * len(batches), "codebook_assign": len(batches)}
        if launches != expected:
            fail(f"preprocess launches {launches} != expected {expected} (11 K1 + 1 K4 per tokenize batch)")

        trimmed = {}
        for name in lengths:
            sr, ch, n = audio_io.info(tmp / "16k" / f"{name}.wav")
            trimmed[name] = n
            if (sr, ch) != (SAMPLE_RATE, 1) or not 0 < n <= untrimmed[name]:
                fail(f"preprocess resample: {name} at {sr} Hz, {n} samples after the trim of {untrimmed[name]}")
        for split, n_files in split_files.items():
            units = json.loads((tmp / f"units/{split}.json").read_text())
            if len(units) != n_files or any(len(u["units"]) != len(u["durations"]) or not u["units"] for u in units.values()):
                fail(f"preprocess tokenize: {split}.json has {len(units)} of {n_files} files, or units and durations differ")
            if any(int(min(u["units"])) < 0 or int(max(u["units"])) >= ENCODER[2] for u in units.values()):
                fail(f"preprocess tokenize: {split} units outside [0, {ENCODER[2]})")
            # dev and test transcripts resolve against wav_dir_orig (the tree has them); train against the 16 kHz tree
            if split != "train" and not all(u["transcript"].startswith("utterance number") for u in units.values()):
                fail(f"preprocess tokenize: {split} transcripts missing")
        spec = tmp / "16k" / "spectrogram"
        for name, n in trimmed.items():
            mel = np.load(spec / f"{name}.npy")
            if mel.shape != (max(1 + (n - 400) // 320, 0), 80) or not np.isfinite(mel).all():
                fail(f"extract_features: {name} mel {mel.shape}, not ({1 + (n - 400) // 320}, 80) for {n} samples")
        profile_phase(torch, "preprocess", lambda: P.preprocess(config("profiled", True), device="cuda"), len(batches))
        stamps = {p: p.stat().st_mtime_ns for p in spec.glob("**/*.npy")}
        P.extract_features(cfg, device="cuda")
        if {p: p.stat().st_mtime_ns for p in spec.glob("**/*.npy")} != stamps:
            fail("extract_features is not idempotent: a second run rewrote a file")

        # the card against the CPU: resample (f32 products over the strided windows, ~34 taps a sample,
        # O(1) samples: 1e-5) and the log-mel: the log of a bin ~40 dB below its frame's loudest, near the
        # 1e-5 floor, turns the STFT's f32 rounding into up to 1.0e-3 on these files (the CPU's f32 against
        # an f64 evaluation of the same formula), so two f32 evaluations may differ by twice that: 3e-3
        names = sorted(lengths)[:8]
        wavs, _, _ = audio_io.read_batch([tmp / "orig" / f"{n}.wav" for n in names], max(lengths[n] for n in names))
        on_card, on_cpu = resample_op(torch.from_numpy(wavs).cuda(), PRE_RATE, SAMPLE_RATE).cpu(), resample_op(torch.from_numpy(wavs), PRE_RATE, SAMPLE_RATE)
        resample_err = float((on_card - on_cpu).abs().max())
        mel_card, mel_cpu = log_mel_spectrogram(on_cpu.cuda()).cpu(), log_mel_spectrogram(on_cpu)
        mel_err = float((mel_card - mel_cpu).abs().max())
        tol = {"resample": 1e-5, "log_mel": 3e-3}
        print(json.dumps({"phase": "preprocess_vs_cpu_plain", "files": len(names), "resample_max_abs_err": resample_err,
                          "log_mel_max_abs_err": mel_err, "tol": tol}))
        if resample_err > tol["resample"] or mel_err > tol["log_mel"]:
            fail(f"card resample / log-mel differ from the CPU's: {resample_err}, {mel_err}")

    audio_min = sum(lengths.values()) / PRE_RATE / 60
    record = {
        "phase": "preprocess", "files": len(lengths), "audio_minutes": audio_min, "launches": launches, "expected": expected,
        "tokenize_batches": batches, "wall_seconds": wall, "stage_seconds": stage_s, "seconds_per_audio_minute": wall / audio_min,
        "trimmed_share": 1 - sum(trimmed.values()) / sum(untrimmed.values()),
        "note": "tokenize includes the encoder's construction (random weights from a seed, on the CPU)",
    }
    print(json.dumps(record))

    # one 40-s batch of 8 at 44.1 kHz -> 16 kHz: the peak beside the input, and beside what an input
    # zero-stuffed by L = 160 would take alone
    x = torch.from_numpy(np.random.default_rng(23).standard_normal((8, 40 * 44100)).astype(np.float32) * 0.1).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y = resample_op(x, 44100, SAMPLE_RATE)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    t_ms = time_ms(torch, lambda: resample_op(x, 44100, SAMPLE_RATE), 5)
    memory = {"phase": "resample_44k_memory", "batch": list(x.shape), "out": list(y.shape), "peak_bytes_above_input": peak,
              "input_bytes": x.numel() * 4, "zero_stuffed_input_bytes": x.numel() * 4 * 160, "ms": t_ms,
              "card_seconds_per_audio_minute": t_ms / 1e3 / (8 * 40 / 60)}
    print(json.dumps(memory))
    if y.shape != (8, 40 * SAMPLE_RATE) or peak > 8 * x.numel() * 4:
        fail(f"44.1 kHz resample: out {tuple(y.shape)}, peak {peak} bytes above the input")
    del x, y
    torch.cuda.empty_cache()
    frames = [HubertConfig().num_frames(n) for n in trimmed.values()]
    record.update(batches=batches, key_frames=[min(frames), max(frames)])
    return record


def kmeans_fit_phase(torch, np, C) -> dict:
    """``kmeans_fit``'s Lloyd iterations at k = 100 on 50 000 x 768 f32
    seeded features (100 clusters), on the card and on the CPU from the same
    k-means++ centers: the first step's ids equal on every frame clear of
    ties (the codebook phase's rule), the inertias within 1e-4 relative
    (f32 sums of 50 000 x 768 squares in another order, and any near-tie
    flipped once moves its frame's share), and the fit's time on the card."""
    from speech_resynth_torch.models.kmeans import _plusplus_init, kmeans_fit, lloyd

    rng = np.random.default_rng(24)
    means = rng.standard_normal((100, 768)).astype(np.float32)
    data = torch.from_numpy((means[rng.integers(0, 100, 50_000)] + 0.5 * rng.standard_normal((50_000, 768))).astype(np.float32))
    card = data.cuda()
    init = _plusplus_init(torch.Generator(device="cuda").manual_seed(25), card, 100)
    ids_card, ids_cpu = C.assign_reference(card, init).cpu(), C.assign_reference(data, init.cpu())
    clear = clear_of_ties(torch, C, data, init.cpu())
    mismatches = int((ids_card != ids_cpu)[clear].sum())
    centers_card, inertia_card = lloyd(card, init, 10)  # also the warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lloyd(card, init, 10)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    centers_cpu, inertia_cpu = lloyd(data, init.cpu(), 10)
    cpu_ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _, fit_inertia = kmeans_fit(card, 100, 10, generator=torch.Generator(device="cuda").manual_seed(25))
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t2) * 1e3
    rel = abs(float(inertia_card) - float(inertia_cpu)) / float(inertia_cpu)
    record = {
        "phase": "kmeans_fit", "shape": [50_000, 768, 100], "iters": 10, "first_step_clear_mismatches": mismatches,
        "first_step_near_ties": int((~clear).sum()), "inertia_card": float(inertia_card), "inertia_cpu": float(inertia_cpu),
        "inertia_rel_diff": rel, "tol": 1e-4, "centers_max_abs_diff": float((centers_card.cpu() - centers_cpu).abs().max()),
        "lloyd_10_ms_card": card_ms, "lloyd_10_ms_cpu": cpu_ms, "fit_ms_card": fit_ms, "fit_inertia": float(fit_inertia),
    }
    print(json.dumps(record))
    if mismatches or rel > 1e-4 or not math.isfinite(float(fit_inertia)):
        fail(f"kmeans_fit on the card differs from the CPU: {record}")
    return record


# configs/resynth/mhubert-expresso-2000.yaml: the trainers' batches and widths
CFM_TRAIN = dict(
    batch_size=2700, frames_per_seg=100, warmup_steps=1000, lr=0.001, lr_min=0.0001, max_norm=0.1, dt=0.0625,
    truncation_value=1.0, dense_model_name=ENCODER[0], quantizer_model_name=ENCODER[1], vocab_size=ENCODER[2], dim_in=80,
    dim_cond_emb=768, hidden_size=256, depth=4, heads=2, intermediate_size=896, ff_dropout=0.0,
    use_unet_skip_connection=False, conv_pos_embed_kernel_size=31, conv_pos_embed_groups=256, attn_dropout=0.0,
    mean=-5.8843, std=2.2615, predict_duration=False,
)
GAN_TRAIN = dict(
    batch_size=64, segment_size=16080, learning_rate=0.0002, adam_b1=0.8, adam_b2=0.99, lr_decay=0.999, seed=1234,
    upsample_rates=[5, 4, 4, 2, 2], upsample_kernel_sizes=[10, 9, 8, 4, 4], n_fft=400, hop_size=320, stdout_interval=1000,
)
GAN_FRAMES = (GAN_TRAIN["segment_size"] - GAN_TRAIN["n_fft"]) // GAN_TRAIN["hop_size"] + 1  # 50
CFM_STEPS, GAN_STEPS = 20, 10
TRAIN_SEED = 5  # the step seed of the fixed-batch runs: the same noise and flow times every step
LOOP_UTTS, LOOP_WAVS, LOOP_DEV = 5400, 128, 20  # two CFM steps and two GAN steps per epoch; three dev batches
EXPORT_BATCH, EXPORT_UNITS = 4, 200  # the exported pair's synthesis batch


def k1_grad_check(torch, A, gen, shape, mask, causal: bool, name: str, label: str) -> dict:
    """K1 through ``dot_product_attention`` on inputs that require grad (one
    launch, an output with a ``grad_fn``): the output against
    attention_reference (ATT_TOL, scaled for outputs above 1) and dq, dk, dv
    against autograd through attention_reference on the card (the Function's
    backward is that computation: tolerance ATT_TOL of max |grad|)."""
    dtype = getattr(torch, name)
    q, k, v, g = (torch.randn(*shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = A.flash_attention.launches
    out = A.dot_product_attention(*leaves, mask=mask, causal=causal)
    if A.flash_attention.launches != before + 1 or out.grad_fn is None:
        fail(f"K1 at the {label} shape did not launch once with a gradient ({name})")
    out.backward(g)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = A.attention_reference(*plain, mask, causal)
    want.backward(g)
    torch.cuda.synchronize()
    fwd_err, fwd_tol = max_err(torch, out.detach(), want.detach()), ATT_TOL[name] * max(1.0, float(want.detach().float().abs().max()))
    grad_err = max(max_err(torch, a.grad, b.grad) for a, b in zip(leaves, plain))
    grad_tol = ATT_TOL[name] * max(float(b.grad.float().abs().max()) for b in plain)
    check = {"path": label, "dtype": name, "fwd_max_abs_err": fwd_err, "fwd_tol": fwd_tol, "grad_max_abs_err": grad_err,
             "grad_tol": grad_tol}
    if not torch.isfinite(out.float()).all() or fwd_err > fwd_tol or grad_err > grad_tol:
        fail(f"K1's gradient at the {label} shape: {check}")
    return check


def k1_fwd_bwd_times(torch, F, A, gen, shape, mask, causal: bool) -> dict:
    """Host-loop ms of forward + backward in bf16: the Function (K1 forward,
    the plain version's backward), the plain version, and SDPA with the same
    float mask (the library yardstick for a training step's attention)."""
    B, H, N, D = shape
    q, k, v, g = (torch.randn(B, H, N, D, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(4))
    qr, kr, vr = (t.requires_grad_(True) for t in (q, k, v))
    allowed = mask[:, None, None, :]
    if causal:
        allowed = allowed & torch.ones(N, N, dtype=torch.bool, device="cuda").tril()
    float_mask = torch.zeros(allowed.shape, device="cuda", dtype=torch.bfloat16).masked_fill(~allowed, A.NEG_INF)
    return {
        "fwd_bwd_ms": time_ms(torch, lambda: torch.autograd.grad(A.FlashAttention.apply(qr, kr, vr, mask, causal), (qr, kr, vr), g), 10),
        "plain_fwd_bwd_ms": time_ms(torch, lambda: torch.autograd.grad(A.attention_reference(qr, kr, vr, mask, causal), (qr, kr, vr), g), 10),
        "library_fwd_bwd_ms": time_ms(
            torch, lambda: torch.autograd.grad(F.scaled_dot_product_attention(qr, kr, vr, attn_mask=float_mask), (qr, kr, vr), g), 10
        ),
    }


FWD_BWD_KEYS = ("ms", "graph_ms", "fwd_bwd_ms", "plain_fwd_bwd_ms", "library_fwd_bwd_ms", "library_ms", "library_graph_ms", "bound_ms")


def k1_train_phase(torch, F, A) -> list:
    """K1 through its autograd Function at the CFM step's shape (2 700, 2,
    100, 128), bf16 and f32, every key valid and ragged: ``k1_grad_check``.
    Times: the forward records of ``attention_shape`` (K1, plain, SDPA with
    the same float mask), and ``k1_fwd_bwd_times``."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(31)
    B, H, N, D = CFM_TRAIN["batch_size"], 2, CFM_TRAIN["frames_per_seg"], 128
    records, checks = [], []
    for ragged in (False, True):
        lengths = torch.full((B,), N, device=dev)
        if ragged:
            lengths = torch.randint(40, N + 1, (B,), generator=gen, device=dev)
        mask = torch.arange(N, device=dev)[None, :] < lengths[:, None]
        label = "cfm training" + (" (ragged)" if ragged else "")
        checks.extend(k1_grad_check(torch, A, gen, (B, H, N, D), mask, False, name, label) for name in DTYPES)
        record = attention_shape(torch, F, A, gen, label, B, H, N, D, 40 if ragged else N, N)
        record.update(k1_fwd_bwd_times(torch, F, A, gen, (B, H, N, D), mask, False))
        print(json.dumps({"phase": "k1_train_fwd_bwd", "path": label, **{k: record[k] for k in FWD_BWD_KEYS}}))
        records.append(record)
    print(json.dumps({"phase": "k1_train_grad_checks", "cases": checks}))
    torch.cuda.empty_cache()
    return records


def cfm_train_batch(torch, dev: str = "cuda"):
    """A fixed (2 700, 100) unit batch and its mels, three rows in four full
    (crops of long utterances), the rest padded from 40 frames up."""
    gen = torch.Generator(device=dev).manual_seed(41)
    B, N = CFM_TRAIN["batch_size"], CFM_TRAIN["frames_per_seg"]
    lengths = torch.randint(40, N + 1, (B,), generator=gen, device=dev)
    lengths[: 3 * B // 4] = N
    pad = torch.arange(N, device=dev)[None, :] >= lengths[:, None]
    ids = torch.randint(1, CFM_TRAIN["vocab_size"] + 1, (B, N), generator=gen, device=dev).masked_fill(pad, 0)
    mels = (torch.randn(B, N, 80, generator=gen, device=dev) * 2 - 5).masked_fill(pad[..., None], -100.0)
    return {"input_ids": ids, "spectrogram_labels": mels}


def train_cfm_phase(torch, np, A) -> dict:
    """The full-width CFM trainer (``make_trainer``, DEFAULT policy: f32
    parameters, bf16 compute) with a seeded random 2 001 x 768 table frozen
    in, on one fixed batch of 2 700 x 100 frames and one step seed: 20 steps
    (finite, falling loss; 4 K1 launches a step), then 3 with remat (the same
    first loss within 1e-3, 8 launches a step, less peak memory); ms per
    step, segments per second and peak memory of each. Then one small-width
    f32 step on the card against the CPU, without and with remat. MFU:
    ``core.metrics.cfm_step_flops`` (matmuls and convs) over the step time
    and the bf16 peak, as the loop writes ``train/MFU``."""
    from speech_resynth_torch.core.metrics import cfm_step_flops, mfu
    from speech_resynth_torch.core.precision import DEFAULT
    from speech_resynth_torch.models.cfm import CFMConfig
    from speech_resynth_torch.train.cfm import CFMTrainerConfig, make_trainer
    from test_torch_cuda import cfm_step_card_vs_cpu

    batch = cfm_train_batch(torch)
    table = np.random.default_rng(42).standard_normal((CFM_TRAIN["vocab_size"] + 1, 768)).astype(np.float32)
    table[0] = 0
    runs, launches = {}, 0
    for remat, steps in ((False, CFM_STEPS), (True, 3)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, state, step = make_trainer(CFMConfig(vocab_size=CFM_TRAIN["vocab_size"], remat=remat), CFMTrainerConfig(),
                                          1000, table, DEFAULT, "cuda")
        A.flash_attention.launches = 0
        losses = []
        for i in range(steps):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, metrics = step(state, batch, TRAIN_SEED)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
        n = A.flash_attention.launches
        launches += n
        flops = cfm_step_flops(model.config, CFM_TRAIN["batch_size"], CFM_TRAIN["frames_per_seg"], remat)
        runs[remat] = {
            "remat": remat, "steps": steps, "ms_per_step": ms, "segments_per_s": CFM_TRAIN["batch_size"] / ms * 1e3,
            "step_tflop": flops / 1e12, "mfu": mfu(flops, ms / 1e3, "cuda"),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30, "k1_launches": n,
            "losses": [float(x) for x in losses], "grad_norm": float(metrics["grad_norm"]),
        }
        print(json.dumps({"phase": "train_cfm_step", **runs[remat]}))
        if not remat:  # where a step's device time goes (after the count: these launches are not the path's)
            profile_phase(torch, "train_cfm_step", lambda: step(state, batch, TRAIN_SEED), 1)
        del model, state, step, metrics
        if n != steps * 4 * (2 if remat else 1):
            fail(f"CFM training launched K1 {n} times in {steps} steps (remat={remat})")
        if not 0 < runs[remat]["mfu"] < 1:
            fail(f"CFM step MFU {runs[remat]['mfu']} outside (0, 1)")
    plain, remat = runs[False], runs[True]
    losses = plain["losses"]
    if not all(math.isfinite(x) for x in losses) or np.mean(losses[-5:]) >= np.mean(losses[:5]):
        fail(f"CFM training's loss is not finite and falling: {losses}")
    rel = abs(remat["losses"][0] - losses[0]) / abs(losses[0])
    if rel > 1e-3 or remat["peak_memory_gb"] >= plain["peak_memory_gb"]:
        fail(f"remat: first loss {remat['losses'][0]} against {losses[0]}, peak {remat['peak_memory_gb']} GB against {plain['peak_memory_gb']}")
    small = [cfm_step_card_vs_cpu(r) for r in (False, True)]
    print(json.dumps({"phase": "train_cfm_card_vs_cpu", "cases": small}))
    torch.cuda.empty_cache()
    return {"launches": {"flash_attention": launches}, "runs": runs, "remat_loss_rel_diff": rel, "card_vs_cpu": small}


def gan_train_batch(torch, np, dev: str = "cuda") -> dict:
    """64 speech-like 16 080-sample segments and their 50-frame log-mels."""
    from speech_resynth_torch.dsp.mel import log_mel_spectrogram

    waves = speechlike_waves(np, np.random.default_rng(43), GAN_TRAIN["batch_size"], seconds=(1.1, 1.1))
    wav = torch.from_numpy(np.stack([w[: GAN_TRAIN["segment_size"]] for w in waves])).to(dev)
    mel = log_mel_spectrogram(wav)
    if mel.shape[1] != GAN_FRAMES:
        fail(f"a {wav.shape[1]}-sample segment gave {mel.shape[1]} mel frames, not {GAN_FRAMES}")
    return {"mel": mel, "wav": wav, "mel_mask": torch.ones(mel.shape[:2], dtype=torch.bool, device=dev)}


def train_hifigan_phase(torch, np, M) -> dict:
    """The full-width generator, MPD and MSD (``make_gan_trainer``, DEFAULT
    policy) at the config's batch of 64 x 16 080 samples (50 frames): 10
    steps, finite losses, no K2 or K3 launch (the generator records a
    gradient, so it runs the plain conv chain); ms per step, peak memory.
    Then one small-width f32 step on the card against the CPU. MFU:
    ``core.metrics.hifigan_step_flops`` over the step time and the bf16
    peak, as the loop writes ``training/MFU``."""
    from speech_resynth_torch.core.metrics import hifigan_step_flops, mfu
    from speech_resynth_torch.core.precision import DEFAULT
    from speech_resynth_torch.models.hifigan import HifiGanConfig
    from speech_resynth_torch.train.hifigan import HifiGanTrainerConfig, make_gan_trainer
    from test_torch_cuda import gan_step_card_vs_cpu

    batch = gan_train_batch(torch, np)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, state, step = make_gan_trainer(HifiGanConfig(), HifiGanTrainerConfig(), DEFAULT, "cuda")
    M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = 0
    history = []
    for i in range(GAN_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = step(state, batch)
        history.append(metrics)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (GAN_STEPS - 1)
    launches = {"mrf_branch": M.mrf_branch_kernel.launches, "mrf_stage": M.mrf_stage_kernel.launches}
    flops = hifigan_step_flops(HifiGanConfig(), GAN_TRAIN["batch_size"], GAN_FRAMES)
    record = {
        "phase": "train_hifigan_step", "steps": GAN_STEPS, "batch": list(batch["wav"].shape), "ms_per_step": ms,
        "step_tflop": flops / 1e12, "mfu": mfu(flops, ms / 1e3, "cuda"),
        "segments_per_s": GAN_TRAIN["batch_size"] / ms * 1e3, "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "metrics": [{k: float(v) for k, v in m.items()} for m in history],
    }
    print(json.dumps(record))
    profile_phase(torch, "train_hifigan_step", lambda: step(state, batch), 1)
    del state, step, history, metrics
    if any(launches.values()) or not all(math.isfinite(v) for m in record["metrics"] for v in m.values()):
        fail(f"HiFi-GAN training: launches {launches}, metrics {record['metrics'][-1]}")
    if not 0 < record["mfu"] < 1:
        fail(f"HiFi-GAN step MFU {record['mfu']} outside (0, 1)")
    small = gan_step_card_vs_cpu()
    print(json.dumps({"phase": "train_hifigan_card_vs_cpu", **small}))
    torch.cuda.empty_cache()
    return {"launches": launches, "record": record, "card_vs_cpu": small}


# scale ci's 16-step epoch of the quality run's GAN in f32, and its first 8 steps
# under the loop's DEFAULT (bf16 convs)
GAN_DRIFT_STEPS = {"float32": 16, "default": 8}


def gan_drift_phase(torch, M) -> dict:
    """Scale ci's GAN training on the card against the CPU over
    GAN_DRIFT_STEPS steps under each of its policies
    (``tests/test_torch_cuda.py:gan_steps_card_vs_cpu``, TF32 off): from the
    CPU's state at every step, the card's three losses within the policy's
    GAN_TOL "loss", at step 1 each tensor's gradient and update within its
    "step1", at every step each module's (gen, mpd, msd, its tensors as one
    vector) gradient, and update against the CPU optimizer's replay of its
    state and gradients, within its "module"; the card's own trajectory's
    final ``gan_weight_change`` within its "weight" of the CPU's, as a ratio
    (``gan_weight_change_within``). The steps
    launch neither K2 nor K3 (the generator records a gradient). The
    kill/resume checks' processes share the card and the host with it
    (``background_checks``): its seconds time nothing."""
    from test_torch_cuda import GAN_TOL, gan_steps_card_vs_cpu, gan_weight_change_within

    M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = 0
    records, faults = {}, []
    for policy, steps in GAN_DRIFT_STEPS.items():
        t0 = time.perf_counter()
        r = gan_steps_card_vs_cpu(steps, policy=policy)
        cpu, card = r["gan_weight_change"]
        within = gan_weight_change_within(policy, cpu, card)
        record = {
            "phase": "gan_drift", "policy": policy, "seconds": time.perf_counter() - t0, "steps": r["steps"], "tol": r["tol"],
            "threads": r["threads"],
            "per_step": [{k: x[k] for k in ("step", "loss_rel", "grad_rel_module", "update_replayed_rel_module", "update_rel_module",
                                            "grad_rel_worst", "update_rel_worst", "free_grad_rel_module", "free_update_rel_module",
                                            "gan_weight_change")} for x in r["records"]],
            "first_divergence": r["first_divergence"],
            "gan_weight_change": {"cpu": cpu, "cuda": card, "ratio": card / cpu, "tol": GAN_TOL[policy]["weight"]},
        }
        print(json.dumps(record))
        if r["first_divergence"] is not None or not within:
            faults.append(f"{policy}: {r['first_divergence']}, weight change {cpu} (cpu) {card} (card)")
        records[policy] = record
    launches = {"mrf_branch": M.mrf_branch_kernel.launches, "mrf_stage": M.mrf_stage_kernel.launches}
    if faults or any(launches.values()):
        fail(f"the card's GAN steps part from the CPU's: {faults}, launches {launches}")
    return {"records": records, "launches": launches}


def write_train_corpora(torch, np, audio_io, root: Path) -> dict:
    """A CFM corpus (LOOP_UTTS utterances of 100-140 units and mels, one unit
    JSON) and a HiFi-GAN corpus (LOOP_WAVS speech-like wavs of 1.2-2 s with
    their log-mels from the card; the first LOOP_DEV are also the dev list)."""
    from speech_resynth_torch.dsp.mel import log_mel_spectrogram

    rng = np.random.default_rng(44)
    spec = root / "spectrogram"
    spec.mkdir(parents=True)
    units = {}
    for i in range(LOOP_UTTS):
        n = int(rng.integers(100, 141))
        units[f"u{i}"] = {"units": rng.integers(0, CFM_TRAIN["vocab_size"], n).tolist(), "durations": [1] * n, "transcript": ""}
        np.save(spec / f"u{i}.npy", (rng.standard_normal((n, 80)) * 2 - 5).astype(np.float32))
    (root / "train.json").write_text(json.dumps(units))
    wav_dir = root / "wav"
    wav_dir.mkdir()
    names = []
    for i, wave in enumerate(speechlike_waves(np, rng, LOOP_WAVS, seconds=(1.2, 2.0))):
        audio_io.write(wav_dir / f"w{i}.wav", wave, SAMPLE_RATE)
        np.save(spec / f"w{i}.npy", log_mel_spectrogram(torch.from_numpy(wave).cuda()).cpu().numpy())
        names.append(f"w{i}")
    (root / "wavs.txt").write_text("\n".join(names) + "\n")
    # the dev set: a unit JSON, read by the CFM loop's validation (units, transcripts, the waves as references)
    # and, through its keys, by the HiFi-GAN loop's
    dev = {}
    for name in names[:LOOP_DEV]:
        n = int(rng.integers(100, 141))
        dev[name] = {"units": rng.integers(0, CFM_TRAIN["vocab_size"], n).tolist(), "durations": [1] * n,
                     "transcript": " ".join(rng.choice(WORDS, 6))}
    (root / "dev.json").write_text(json.dumps(dev))
    return {"spec": spec, "wav": wav_dir}


def loop_config(root: Path, train_file: str, cfm_epochs: int = 2, **gan) -> dict:
    """The loops' config: the YAML's trainer values, the corpora under ``root``,
    2 epochs of each trainer, a summary every step, a CFM checkpoint every
    epoch, a HiFi-GAN checkpoint and validation every 2 steps (``gan``
    overrides)."""
    return {
        "common": {"seed": 0},
        "dataset": {"wav_dir": str(root / "wav"), "spectrogram_dir": str(root / "spectrogram"), "ext_audio": ".wav",
                    "train_file": str(root / train_file), "dev_file": str(root / "dev.json")},
        "flow_matching": {**CFM_TRAIN, "path": str(root / "flow_matching"), "epoch": cfm_epochs, "summary_interval": 1,
                          "save_interval_epoch": 1},
        "hifigan": {**GAN_TRAIN, "path": str(root / "hifigan"), "training_epochs": 2, "summary_interval": 1,
                    "checkpoint_interval": 2, "validation_interval": 2, **gan},
    }


# One training loop (``train_hifigan`` or ``train_speechlm``) in a process of
# its own, deterministic: straight through, stopped (to be killed) right after
# the checkpoint at ``stop_at``, or resumed; under torchrun's variables it runs
# as one rank of a process group. It keeps one checkpoint: a resume reads the
# latest, and a full-width LM's is 1.65 GB.
LOOP_RUN = """
import json, sys, time
import torch
torch.use_deterministic_algorithms(True)
import torch.distributed as dist
from speech_resynth_torch.core.config import config_from_dict
from speech_resynth_torch.pipeline import train_loops
loop, cfg, stop_at = sys.argv[1], config_from_dict(json.loads(sys.argv[2])), int(sys.argv[3])
class StopAfterSave(train_loops.CheckpointManager):
    def __init__(self, directory):
        super().__init__(directory, max_to_keep=1)
    def save(self, step, state, force=False):
        saved = super().save(step, state, force)
        if saved and step == stop_at:
            print("checkpoint", step, flush=True)
            time.sleep(3600)
        return saved
train_loops.CheckpointManager = StopAfterSave
result = getattr(train_loops, loop)(cfg)
result["process_group"] = dist.is_initialized() and {"backend": dist.get_backend(), "world_size": dist.get_world_size()}
if dist.is_initialized():
    dist.destroy_process_group()
print(json.dumps(result), flush=True)
"""


def loop_run(loop: str, config: dict, stop_at: int = -1, env: Optional[dict] = None):
    """``LOOP_RUN`` of ``train_loops.<loop>`` in a process of its own,
    CUBLAS_WORKSPACE_CONFIG set before CUDA starts, ``env`` added."""
    import os

    return subprocess.Popen([sys.executable, "-c", LOOP_RUN, loop, json.dumps(config), str(stop_at)],
                            cwd=str(Path(__file__).resolve().parent),
                            env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", **(env or {})),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def generator_hash(hashlib, torch, path: Path) -> str:
    """sha256 over the exported generator's tensors in key order (16 hex digits)."""
    from speech_resynth_torch.core.safetensors import load_file

    sd = load_file(path / "model.safetensors")
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].numpy().tobytes())
    return h.hexdigest()[:16]


def run_result(proc, what: str, timeout: int = 900) -> dict:
    """The last stdout line of a finished run, as JSON; fails on a non-zero exit."""
    so, se = proc.communicate(timeout=timeout)
    if proc.returncode:
        fail(f"{what} failed: {se[-3000:]}")
    return json.loads(so.strip().splitlines()[-1])


def kill_and_resume(run, ckpt_dir: Path, stop_at: int, what: str) -> dict:
    """Start the straight run and the run to kill at once (one card holds
    both, and each is deterministic on its own), SIGKILL the second right
    after it prints its checkpoint at ``stop_at``, then resume it. ``run(name,
    stop_at=-1)`` starts a run as a process; ``ckpt_dir(name)`` is where it
    checkpoints. Returns both runs' results and the steps checkpointed when killed."""
    import signal
    import threading

    straight, killed = run("straight"), run("resumed", stop_at=stop_at)
    watchdog = threading.Timer(900, killed.kill)  # a run that never reaches its checkpoint
    watchdog.start()
    try:
        line = killed.stdout.readline()
        if line.split() != ["checkpoint", str(stop_at)]:
            killed.kill()
            fail(f"the {what} run to kill did not reach its checkpoint: {line!r} {killed.stderr.read()[-3000:]}")
        killed.send_signal(signal.SIGKILL)
    finally:
        watchdog.cancel()
        killed.wait(timeout=60)
    steps = sorted(int(p.name) for p in ckpt_dir("resumed").iterdir() if p.name.isdigit())
    resumed = run("resumed")
    return {"straight": run_result(straight, f"the straight {what} run"), "resumed": run_result(resumed, f"the resumed {what} run"),
            "checkpoints_when_killed": steps}


def kill_resume_check(torch, root: Path, config: dict) -> dict:
    """``train_hifigan`` at the corpus's 2 steps an epoch for 2 epochs with a
    checkpoint every 3 steps, in processes of their own under
    ``torch.use_deterministic_algorithms(True)`` (CUBLAS_WORKSPACE_CONFIG set
    before CUDA starts): once straight through; once killed with SIGKILL
    right after the mid-epoch checkpoint at step 3, then resumed. The two
    exported generators must be equal bit for bit."""
    import hashlib

    def run(name, stop_at=-1):
        return loop_run("train_hifigan", {**config, "hifigan": {**config["hifigan"], "path": str(root / name)}}, stop_at)

    t0 = time.perf_counter()
    out = kill_and_resume(run, lambda name: root / name / "ckpt", 3, "HiFi-GAN")
    steps = out.pop("checkpoints_when_killed")
    hashes = {k: generator_hash(hashlib, torch, root / k) for k in ("straight", "resumed")}
    record = {"phase": "train_kill_resume", "killed_with": "SIGKILL", "killed_at_checkpoint": 3, "checkpoints_when_killed": steps,
              "steps": {k: out[k]["step"] for k in out}, "generator_sha256": hashes, "bit_equal": hashes["straight"] == hashes["resumed"],
              "deterministic_algorithms": True, "nondeterministic_ops": [], "seconds": time.perf_counter() - t0}
    if steps != [3] or not record["bit_equal"] or set(record["steps"].values()) != {4}:
        fail(f"kill/resume: {record}")
    return record


def background_checks(torch, np, root: Path):
    """Start the two kill/resume checks in processes of their own, to run
    beside ``gan_drift_phase`` (a check whose seconds nobody reads), so that
    no timed window of the loops or of ``gan_longrun run`` shares the card
    with them: the HiFi-GAN loop's (``kill_resume_check``, on the training
    corpora written here under ``root`` for ``train_loops_phase``) and
    ``gan_longrun resume-check``'s (8 steps on a 32-utterance corpus of its
    own: SIGKILL after a mid-epoch checkpoint, then resume; bit-equal
    generators). Returns a function that waits for both and returns
    (the loop's record, the tool's verdict)."""
    from concurrent.futures import ThreadPoolExecutor

    from speech_resynth_torch.dsp import audio_io

    t0 = time.perf_counter()
    write_train_corpora(torch, np, audio_io, root)
    corpus_seconds = time.perf_counter() - t0
    pool = ThreadPoolExecutor(2)
    loop = pool.submit(kill_resume_check, torch, root,
                       loop_config(root, "wavs.txt", checkpoint_interval=3, validation_interval=1000))
    tool = pool.submit(tool_result, tool_start("gan_longrun", "resume-check", root / "gan_resume", *GAN_RESUME),
                       "gan_longrun resume-check", 900)

    def wait() -> tuple:
        kill, (lines, _) = loop.result(), tool.result()
        pool.shutdown()
        print(json.dumps(kill))
        verdict = json.loads(next(l for l in reversed(lines) if l.startswith('{"kill_step"')))
        print(json.dumps({"phase": "background_checks", "corpus_seconds": corpus_seconds,
                          "seconds": time.perf_counter() - t0, "gan_longrun_resume_check": verdict}))
        if not verdict["step_exact"] or verdict["kill_step"] != 3 or verdict["total_steps"] != 8:
            fail(f"gan_longrun resume-check: {verdict}")
        return kill, verdict

    return wait


def train_loops_phase(torch, np, A, M, root: Path, kill: dict) -> dict:
    """The training loops through the config entries on synthetic corpora:
    ``train_flow_matching`` at full width and batch 2 700 (2 steps an epoch)
    for 2 epochs saving every epoch (no vocoder export yet: no dev sweep);
    ``train_hifigan`` at full width and batch 64 (2 steps an epoch) for 2
    epochs, checkpoint and validation every 2 steps (the validation's
    generator runs K2 under inference_mode); ``train_flow_matching`` raised
    to 3 epochs (resumes at step 4, ends at 6), whose save runs the dev
    sweep through the exported vocoder (``dev/WER``, ``dev/CER``,
    ``dev/MOS``, ``dev/MOS (REF)``, five ``hyp/`` clips; K1 and K2); the
    exported pair through ``load_pretrained`` synthesizing one batch. The corpora under ``root``
    are ``background_checks``': its kill/resume check (``kill``) ran before
    this phase, so the loops' seconds, steps per second and MFU are taken
    with the card to themselves."""
    from speech_resynth_torch.core.config import config_from_dict
    from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan
    from speech_resynth_torch.pipeline import train_loops
    from speech_resynth_torch.pipeline.data import MelDataset, bucket_length

    record = {"phase": "train_loops"}

    def cfm_run(epochs):
        t1 = time.perf_counter()
        result = train_loops.train_flow_matching(config_from_dict(loop_config(root, "train.json", cfm_epochs=epochs)))
        torch.cuda.synchronize()
        steps = sorted(int(p.name) for p in (root / "flow_matching" / "ckpt").iterdir() if p.name.isdigit())
        record[f"cfm_{epochs}_epochs"] = {"step": result["step"], "checkpoints": steps, "metrics": result["metrics"],
                                          "seconds": time.perf_counter() - t1}

    A.flash_attention.launches = M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = K5.conv_ff_kernel.launches = 0
    cfm_run(2)
    cfm_launches = {"flash_attention": A.flash_attention.launches, "mrf_branch": M.mrf_branch_kernel.launches,
                    "conv_ff": K5.conv_ff_kernel.launches}

    dev = MelDataset(str(root / "wav"), str(root / "spectrogram"), train_loops._mel_file_list(str(root / "dev.json")),
                     GAN_TRAIN["segment_size"], 400, 320, False)
    dev_batches = [list(b["mel"].shape[:2]) for b in dev.padded_batches(8, max_utts=32, with_wav=False)]
    validations = 2  # at steps 2 and 4
    from test_torch_cuda import RecordingWriter

    gan_writer = RecordingWriter()
    real_writer, train_loops.MetricsWriter = train_loops.MetricsWriter, lambda *args, **kwargs: gan_writer
    M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = 0
    t1 = time.perf_counter()
    try:
        result = train_loops.train_hifigan(config_from_dict(loop_config(root, "wavs.txt")))
    finally:
        train_loops.MetricsWriter = real_writer
    torch.cuda.synchronize()
    gan_launches = {"mrf_branch": M.mrf_branch_kernel.launches, "mrf_stage": M.mrf_stage_kernel.launches}
    record["hifigan"] = {"step": result["step"], "metrics": result["metrics"], "seconds": time.perf_counter() - t1,
                         "dev_batches": dev_batches, "validations": validations, "launches": gan_launches}
    if result["step"] != 4 or gan_launches != {"mrf_branch": 9 * len(dev_batches) * validations, "mrf_stage": 0}:
        fail(f"train_hifigan: {record['hifigan']}")

    # the third epoch: its save runs the dev sweep through the vocoder the GAN loop exported
    writer = RecordingWriter()
    real_writer, train_loops.MetricsWriter = train_loops.MetricsWriter, lambda *args, **kwargs: writer
    A.flash_attention.launches, M.mrf_branch_kernel.launches = cfm_launches["flash_attention"], cfm_launches["mrf_branch"]
    K5.conv_ff_kernel.launches = cfm_launches["conv_ff"]
    try:
        cfm_run(3)
    finally:
        train_loops.MetricsWriter = real_writer
    cfm_launches = {"flash_attention": A.flash_attention.launches, "mrf_branch": M.mrf_branch_kernel.launches,
                    "conv_ff": K5.conv_ff_kernel.launches}
    # validate_flow_matching: at most 16 dev utterances in batches of 8, each padded to its bucket
    dev_units = json.loads((root / "dev.json").read_text())
    sweep = [bucket_length(max(len(dev_units[n]["units"]) for n in list(dev_units)[i : i + 8])) for i in range(0, 16, 8)]
    dev_scalars = {k: v for k, v in writer.scalars_.items() if k.startswith("dev/")}
    record["cfm_dev_sweep"] = {"scalars": dev_scalars, "clips": writer.clips, "batches": [[8, f] for f in sweep]}
    if record["cfm_2_epochs"]["checkpoints"] != [2, 4] or record["cfm_3_epochs"]["checkpoints"] != [2, 4, 6]:
        fail(f"train_flow_matching did not checkpoint and resume as expected: {record}")
    if sorted(dev_scalars) != ["dev/CER", "dev/MOS", "dev/MOS (REF)", "dev/WER"] or len(writer.clips) != 5:
        fail(f"train_flow_matching's dev sweep wrote {sorted(dev_scalars)} and clips {writer.clips}")
    # the loops' MFU (the last summary's: one step between two syncs), written beside steps_per_sec
    record["loop_mfu"] = {k: w.scalars_.get(k) for w, k in ((writer, "train/MFU"), (gan_writer, "training/MFU"))}
    record["loop_steps_per_sec"] = {k: w.scalars_.get(k) for w, k in ((writer, "train/steps_per_sec"),
                                                                       (gan_writer, "training/steps_per_sec"))}
    if not all(v is not None and 0 < v < 1 for v in record["loop_mfu"].values()):
        fail(f"the loops' MFU scalars: {record['loop_mfu']}")
    # the steps record a gradient, so only the dev sweep takes K5
    want = {"flash_attention": 6 * 4 + 4 * 16 * len(sweep), "mrf_branch": 9 * len(sweep), "conv_ff": FF_PER_BATCH * len(sweep)}
    if cfm_launches != want:
        fail(f"train_flow_matching launched {cfm_launches} in 6 steps and its dev sweep, expected {want}")

    decoder = ConditionalFlowMatchingWithHifiGan.load_pretrained(root / "flow_matching" / "hf", root / "hifigan", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(45)
    ids = torch.randint(1, CFM_TRAIN["vocab_size"] + 1, (EXPORT_BATCH, EXPORT_UNITS), generator=gen, device="cuda")
    ids[1:, EXPORT_UNITS * 3 // 4 :] = 0
    A.flash_attention.launches = M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = K5.conv_ff_kernel.launches = 0
    wave, lengths = decoder.synthesize(ids, dt=CFM_TRAIN["dt"], truncation_value=CFM_TRAIN["truncation_value"])
    torch.cuda.synchronize()
    export_launches = {"flash_attention": A.flash_attention.launches, "mrf_branch": M.mrf_branch_kernel.launches,
                       "mrf_stage": M.mrf_stage_kernel.launches, "conv_ff": K5.conv_ff_kernel.launches}
    want = decoder.vocoder.config.waveform_lengths((ids != 0).sum(dim=1))
    record["export"] = {"batch": [EXPORT_BATCH, EXPORT_UNITS], "lengths": lengths.tolist(), "launches": export_launches,
                        "peak": float(wave.float().abs().max())}
    if not torch.equal(lengths, want) or not torch.isfinite(wave).all():
        fail(f"the exported pair did not synthesize: {record['export']}")
    print(json.dumps(record))
    return {"cfm": cfm_launches, "hifigan": gan_launches, "export": export_launches, "dev_batches": dev_batches,
            "validations": validations, "kill_resume": kill, "cfm_dev_sweep": record["cfm_dev_sweep"]["batches"],
            "loop_mfu": record["loop_mfu"]}


LM_TRAIN_BATCH, LM_TRAIN_TOKENS = 96, 128  # configs/speechlm/hubert.yaml batch_size_per_device, units_per_sample
LM_STEPS = 10
LM_BPE_IDS = 400  # the continuation phase's BPE vocabulary: the corpora's ids
LM_LOOP_LINES, LM_LOOP_EPOCHS = 2 * LM_TRAIN_BATCH, 2  # two steps an epoch
LM_KILL_EPOCHS = 2  # the kill/resume check's and the torchrun rank's epochs: killed after the first
LM_SLM21_PAIRS = 48  # 96 items per sLM21 task: one scoring batch each
LM_GEN_TOKENS = 64


def write_lm_corpus(np, path: Path, lines: int, seed: int) -> None:
    """BPE-id lines of 40-400 ids below LM_BPE_IDS: about three in four
    longer than a sample, so UnitTextDataset crops them full and pads the rest."""
    rng = np.random.default_rng(seed)
    path.write_text("\n".join(" ".join(map(str, rng.integers(0, LM_BPE_IDS, int(rng.integers(40, 401))))) for _ in range(lines)) + "\n")


def lm_train_batch(torch, np, root: Path) -> dict:
    """The first 96 x 128 batch ``UnitTextDataset`` makes of a seeded corpus, on the card."""
    from speech_resynth_torch.pipeline.data import UnitTextDataset

    write_lm_corpus(np, root / "lm_batch.txt", LM_TRAIN_BATCH, 52)
    batch = next(UnitTextDataset(str(root / "lm_batch.txt"), LM_TRAIN_TOKENS).batches(LM_TRAIN_BATCH, seed=0, epoch=1))
    return {k: torch.from_numpy(v).long().cuda() for k, v in batch.items()}


def k1_lm_train_phase(torch, F, A, batch) -> dict:
    """K1 at the LM training step's shape (96, 12, 128, 64), causal, with the
    batch's pad mask: ``k1_grad_check`` in bf16 and f32, the forward record
    of ``attention_shape`` on those key lengths, and ``k1_fwd_bwd_times``."""
    gen = torch.Generator(device="cuda").manual_seed(53)
    B, N = batch["input_ids"].shape
    shape = (B, 12, N, 64)
    mask = batch["attention_mask"].bool()
    lengths = mask.sum(dim=1)
    checks = [k1_grad_check(torch, A, gen, shape, mask, True, name, "lm training") for name in DTYPES]
    record = attention_shape(torch, F, A, gen, "lm training", *shape, int(lengths.min()), N, causal=True, lengths=lengths)
    record.update(k1_fwd_bwd_times(torch, F, A, gen, shape, mask, True), full_rows=int((lengths == N).sum()))
    print(json.dumps({"phase": "k1_lm_train_fwd_bwd", "path": "lm training", **{k: record[k] for k in FWD_BWD_KEYS},
                      "grad_checks": checks}))
    torch.cuda.empty_cache()
    return record


def train_speechlm_phase(torch, np, A, batch) -> dict:
    """The full-width speech LM (configs/speechlm/hubert.yaml: 12 x 768, 12
    heads of 64, intermediate 3 072, vocab 16 384 + 2; DEFAULT policy: f32
    parameters, bf16 compute) through ``make_speechlm_trainer`` on one fixed
    96 x 128 batch (warmup 5 steps, so the LM_STEPS steps learn): LM_STEPS steps under
    "xla" (the trainer's default: no K1) and LM_STEPS under "auto" (K1 forward in
    each of the 12 layers), then 3 with remat and 4 micro-steps of
    accum_steps = 2; ms per step, tokens/s, MFU against 989 TFLOP/s
    (``core.metrics.step_flops``), peak memory, K1 launches, losses; a step's
    device profile under each attention; then small f32 steps on the card
    against the CPU."""
    from speech_resynth_torch.core.metrics import mfu, step_flops
    from speech_resynth_torch.core.precision import DEFAULT
    from speech_resynth_torch.models.llama import LlamaConfig
    from speech_resynth_torch.train.speechlm import SpeechLMTrainerConfig, make_speechlm_trainer
    from test_torch_cuda import lm_step_card_vs_cpu

    cfg = LlamaConfig()
    B, N = batch["input_ids"].shape
    runs, launches = {}, 0
    for label, kw, steps in (("xla", {}, LM_STEPS), ("auto", {"attn_implementation": "auto"}, LM_STEPS),
                             ("remat", {"remat": True}, 3), ("accum_2", {"accum_steps": 2}, 4)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, state, step = make_speechlm_trainer(cfg, SpeechLMTrainerConfig(warmup_steps=5, **kw), None, 1000, DEFAULT, "cuda")
        A.flash_attention.launches = 0
        losses = []
        for i in range(steps):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
        n = A.flash_attention.launches
        if label == "auto":
            launches += n
        flops = step_flops(cfg, B, N, remat=label == "remat")
        runs[label] = {
            "attn_implementation": kw.get("attn_implementation", "xla"), "remat": label == "remat",
            "accum_steps": kw.get("accum_steps", 1), "steps": steps, "updates": state.optimizers["model"].count,
            "batch": [B, N], "ms_per_step": ms, "tokens_per_s": B * N / ms * 1e3, "step_flops": flops,
            "mfu": mfu(flops, ms / 1e3, "cuda"), "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
            "k1_launches": n, "losses": [float(x) for x in losses], "grad_norm": float(metrics["grad_norm"]),
        }
        print(json.dumps({"phase": "train_speechlm_step", "run": label, **runs[label]}))
        if label in ("xla", "auto"):  # after the count: these launches are not the path's
            profile_phase(torch, f"train_speechlm_step_{label}", lambda: step(state, batch), 1)
        del state, step, metrics
        if n != (cfg.num_hidden_layers * steps if label == "auto" else 0):
            fail(f"LM training ({label}) launched K1 {n} times in {steps} steps")
    for label in ("xla", "auto"):
        losses = runs[label]["losses"]
        if not all(math.isfinite(x) for x in losses) or np.mean(losses[-5:]) >= np.mean(losses[:5]):
            fail(f"LM training ({label}): the loss is not finite and falling: {losses}")
    xla, remat = runs["xla"], runs["remat"]
    rel = {k: abs(runs[k]["losses"][0] - xla["losses"][0]) / abs(xla["losses"][0]) for k in ("auto", "remat", "accum_2")}
    if max(rel.values()) > 1e-3 or remat["peak_memory_gb"] >= xla["peak_memory_gb"] or runs["accum_2"]["updates"] != 2:
        fail(f"LM training: first losses against xla's {rel}, remat peak {remat['peak_memory_gb']} GB against "
             f"{xla['peak_memory_gb']}, accum_2 updates {runs['accum_2']['updates']}")
    small = [lm_step_card_vs_cpu(impl, r) for impl, r in (("xla", False), ("auto", False), ("auto", True))]
    print(json.dumps({"phase": "train_speechlm_card_vs_cpu", "cases": small, "first_loss_rel_diff": rel}))
    torch.cuda.empty_cache()
    return {"launches": {"flash_attention": launches}, "runs": runs, "card_vs_cpu": small}


def write_lm_slm21(np, root: Path) -> dict:
    """sLM21-shaped unit JSONs (dev and test, LM_SLM21_PAIRS pairs a task:
    words of 1-30 BPE ids, sentences of 10-60) and each task's gold.csv."""
    rng = np.random.default_rng(54)
    files = {}
    for task, by, cats, (lo, hi) in (("lexical", "frequency", ("high", "mid", "low", "oov"), (1, 30)),
                                     ("syntactic", "type", ("agreement", "anaphor", "binding", "filler_gap"), (10, 60))):
        items, rows = {}, []
        for pair in range(LM_SLM21_PAIRS):
            for correct in (1, 0):
                name = f"{task[:3]}_{pair:03d}_{correct}"
                items[name] = rng.integers(0, LM_BPE_IDS, int(rng.integers(lo, hi + 1))).tolist()
                rows.append(f"{pair},{name}.wav,{correct},{cats[pair % len(cats)]},test")
        (root / "sLM21" / task).mkdir(parents=True)
        (root / "sLM21" / task / "gold.csv").write_text(f"id,filename,correct,{by},subset\n" + "\n".join(rows) + "\n")
        for split in ("dev", "test"):
            files[f"{task}_{split}"] = root / f"{task}_{split}.json"
            files[f"{task}_{split}"].write_text(json.dumps(items))
    return files


def lm_loop_config(root: Path, cont_tmp: Path, files: dict, name: str) -> dict:
    """configs/speechlm/hubert.yaml at full width over the corpus and JSONs
    under ``root``, the model at ``root / name``, LM_LOOP_EPOCHS epochs, a
    summary every step; s2u from the continuation phase's pieces."""
    return {
        "dataset": {"train_file": str(root / "train.txt"), "units_per_sample": LM_TRAIN_TOKENS,
                    "swuggy_dev_file": str(files["lexical_dev"]), "sblimp_dev_file": str(files["syntactic_dev"]),
                    "swuggy_test_file": str(files["lexical_test"]), "sblimp_test_file": str(files["syntactic_test"]),
                    "swuggy_dir": str(root / "sLM21" / "lexical"), "sblimp_dir": str(root / "sLM21" / "syntactic"),
                    "result_dir": str(root / name / "results")},
        "dataloader": {"batch_size_per_device": LM_TRAIN_BATCH},
        "model": {"path": str(root / name), **LM_MODEL},
        "optim": {"epoch": LM_LOOP_EPOCHS, "warmup_steps": 100, "lr": 0.0002, "lr_min": 0.00002, "beta1": 0.9, "beta2": 0.98,
                  "max_norm": 1.0, "summary_interval": 1},
        "s2u": {"dense_model_name": CONT_ENCODER[0], "quantizer_model_name": CONT_ENCODER[1], "vocab_size": CONT_ENCODER[2],
                "tokenizer_path": str(cont_tmp / "tokenizer.json")},
    }


def lm_checkpoint_hash(hashlib, torch, path: Path) -> str:
    """sha256 over the latest checkpoint's LM tensors in key order (16 hex digits)."""
    from speech_resynth_torch.core.checkpoint import CheckpointManager

    sd = CheckpointManager(path / "ckpt").read()["modules"]["model"]
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].numpy().tobytes())
    return h.hexdigest()[:16]


def lm_run(root: Path, config: dict, name: str, stop_at: int = -1, env: Optional[dict] = None):
    """``train_speechlm`` in ``loop_run`` with the model at ``root / name``."""
    cfg = {**config, "model": {**config["model"], "path": str(root / name)},
           "dataset": {**config["dataset"], "result_dir": str(root / name / "results")}}
    return loop_run("train_speechlm", cfg, stop_at, env)


def lm_kill_resume_check(torch, root: Path, config: dict) -> dict:
    """``train_speechlm`` at 2 steps an epoch for LM_KILL_EPOCHS epochs in processes of
    their own under ``torch.use_deterministic_algorithms(True)``: once
    straight through; once killed with SIGKILL right after epoch 1's
    checkpoint (step 2), then resumed (at epoch 2, as the JAX loop resumes).
    The two final checkpoints' LMs must be equal bit for bit."""
    import hashlib
    import shutil

    t0 = time.perf_counter()
    out = kill_and_resume(lambda name, stop_at=-1: lm_run(root, config, f"kr_{name}", stop_at),
                          lambda name: root / f"kr_{name}" / "ckpt", 2, "speech-LM")
    steps = out.pop("checkpoints_when_killed")
    hashes = {k: lm_checkpoint_hash(hashlib, torch, root / f"kr_{k}") for k in ("straight", "resumed")}
    record = {"phase": "train_speechlm_kill_resume", "killed_with": "SIGKILL", "killed_at_checkpoint": 2,
              "checkpoints_when_killed": steps, "steps": {k: out[k]["step"] for k in out},
              "losses": {k: out[k]["metrics"]["loss"] for k in out}, "lm_sha256": hashes,
              "bit_equal": hashes["straight"] == hashes["resumed"], "deterministic_algorithms": True,
              "seconds": time.perf_counter() - t0}
    print(json.dumps(record))
    shutil.rmtree(root / "kr_resumed")
    if steps != [2] or not record["bit_equal"] or set(record["steps"].values()) != {2 * LM_KILL_EPOCHS}:
        fail(f"LM kill/resume: {record}")
    return {**record, "straight": out["straight"], "straight_hash": hashes["straight"]}


def speechlm_loop_phase(torch, np, A, C, M, root: Path, cont_tmp: Path) -> dict:
    """The speech-LM loop through the config entries at full width on a
    seeded corpus of LM_LOOP_LINES lines (2 steps an epoch, LM_LOOP_EPOCHS
    epochs): ``train_speechlm`` (checkpoints, the HF export, the dev sLM21
    scoring at each epoch's end through K1), ``eval_speechlm`` of the
    checkpoint (K1; the native pair scorer on the JSONs' gold tables),
    ``generate_speechlm`` of the checkpoint without and with a decoder
    directory (the continuation phase's prompt, tokenizer and decoder, stage
    fusion off: K2); ``eval`` and ``generate`` (greedy, with the decoder)
    again through ``cli.speechlm.main`` from a YAML of the same config: the
    same launches and the same continuation's length; then, in processes of
    their own, the kill/resume check and ``distributed_phase``."""
    import shutil

    from speech_resynth_torch.core.config import config_from_dict
    from speech_resynth_torch.dsp import audio_io
    from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan
    from speech_resynth_torch.pipeline import train_loops
    from speech_resynth_torch.pipeline.data import load_named_units_from_json
    from speech_resynth_torch.pipeline.speechlm import load_lm_from_hf

    write_lm_corpus(np, root / "train.txt", LM_LOOP_LINES, 55)
    files = write_lm_slm21(np, root)
    config = lm_loop_config(root, cont_tmp, files, "loop")
    layers = LM_MODEL["num_hidden_layers"]
    shapes = {split: [list(b["input_ids"].shape) for task in ("lexical", "syntactic")
                      for b in load_named_units_from_json(str(files[f"{task}_{split}"]), LM_TRAIN_BATCH, 2)]
              for split in ("dev", "test")}
    record = {"phase": "speechlm_loop", "scoring_shapes": shapes}

    A.flash_attention.launches = 0
    t0 = time.perf_counter()
    result = train_loops.train_speechlm(config_from_dict(config))
    torch.cuda.synchronize()
    validation = {"flash_attention": A.flash_attention.launches}
    ckpts = sorted(int(p.name) for p in (root / "loop" / "ckpt").iterdir() if p.name.isdigit())
    record["train"] = {"step": result["step"], "metrics": result["metrics"], "checkpoints": ckpts,
                       "seconds": time.perf_counter() - t0, "launches": validation}
    want = {"flash_attention": LM_LOOP_EPOCHS * layers * len(shapes["dev"])}
    scores = (root / "loop" / "results" / "lexical" / "dev.txt").read_text().splitlines()
    if result["step"] != 2 * LM_LOOP_EPOCHS or ckpts != list(range(2, 2 * LM_LOOP_EPOCHS + 1, 2)) or validation != want or len(scores) != 2 * LM_SLM21_PAIRS:
        fail(f"train_speechlm: {record['train']} (K1 expected {want}), {len(scores)} dev scores")
    exported = load_lm_from_hf(root / "loop" / "hf", device="cuda")  # the export reads back
    if exported.config.vocab_size != LM_MODEL["vocab_size"] + 2:
        fail(f"the LM export's config: {exported.config}")
    del exported

    A.flash_attention.launches = 0
    t0 = time.perf_counter()
    numbers = train_loops.eval_speechlm(config_from_dict(config))
    torch.cuda.synchronize()
    evaluation = {"flash_attention": A.flash_attention.launches}
    record["eval"] = {"result": numbers, "seconds": time.perf_counter() - t0, "launches": evaluation}
    if evaluation != {"flash_attention": layers * len(shapes["test"])} or numbers is None or not all(0 <= v <= 1 for v in numbers.values()):
        fail(f"eval_speechlm: {record['eval']}")

    generate = {}
    dec = ConditionalFlowMatchingWithHifiGan.from_pretrained(cont_tmp / "decoder", device="cuda")
    for label, decoder in (("units", None), ("speech", str(cont_tmp / "decoder"))):
        A.flash_attention.launches = C.assign_kernel.launches = M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = 0
        K5.conv_ff_kernel.launches = 0
        out_wav = root / f"generated_{label}.wav"
        t0 = time.perf_counter()
        out = train_loops.generate_speechlm(config_from_dict(config), str(cont_tmp / "prompt.wav"), str(out_wav) if decoder else None,
                                            decoder, max_new_tokens=LM_GEN_TOKENS, temperature=0.0)
        torch.cuda.synchronize()
        launches = {"flash_attention": A.flash_attention.launches, "codebook_assign": C.assign_kernel.launches,
                    "mrf_branch": M.mrf_branch_kernel.launches, "mrf_stage": M.mrf_stage_kernel.launches,
                    "conv_ff": K5.conv_ff_kernel.launches}
        units = out["units"]
        ids = torch.from_numpy(units.astype(np.int64) + 1)[None].cuda()
        bound = dec._duration_bound(ids)
        expected = {"flash_attention": 6 + (64 if decoder else 0), "codebook_assign": 1, "mrf_branch": 9 if decoder else 0, "mrf_stage": 0,
                    "conv_ff": FF_PER_BATCH if decoder else 0}
        generate[label] = {"launches": launches, "expected": expected, "prompt_units": len(units) - len(out["generated_units"]),
                           "generated_units": len(out["generated_units"]), "bound": bound,
                           "frames": int(dec.model.predict_durations(ids).sum()), "seconds": time.perf_counter() - t0}
        if launches != expected or int(units.min()) < 0 or int(units.max()) >= CONT_ENCODER[2]:
            fail(f"generate_speechlm ({label}) from the checkpoint: {generate[label]}")
        if decoder:
            n = int(dec.vocoder.config.waveform_lengths(int(dec.model.predict_durations(ids).sum())))
            if out["waveform"].size != n or audio_io.info(out_wav) != (SAMPLE_RATE, 1, n):
                fail(f"generate_speechlm with a decoder: {out['waveform'].size} samples, expected {n}")
        elif out["waveform"] is not None:
            fail("generate_speechlm without a decoder returned a waveform")
    record["generate"] = generate
    del dec

    # the same two stages through the CLI (speech_resynth_torch.cli.speechlm) on the checkpoint, from a YAML
    import yaml

    from speech_resynth_torch.cli import speechlm as lm_cli

    cfg_path = root / "loop.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    cli = {}
    A.flash_attention.launches = C.assign_kernel.launches = M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = 0
    t0 = time.perf_counter()
    lm_cli.main(["eval", "--config", str(cfg_path)])
    torch.cuda.synchronize()
    cli["eval"] = {"launches": {"flash_attention": A.flash_attention.launches}, "seconds": time.perf_counter() - t0}
    lines = (root / "loop" / "results" / "lexical" / "test.txt").read_text().splitlines()
    if cli["eval"]["launches"] != evaluation or len(lines) != 2 * LM_SLM21_PAIRS:
        fail(f"cli.speechlm eval: {cli['eval']}, {len(lines)} lexical test scores")
    out_wav = root / "generated_cli.wav"
    A.flash_attention.launches = C.assign_kernel.launches = M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = 0
    K5.conv_ff_kernel.launches = 0
    t0 = time.perf_counter()
    lm_cli.main(["generate", "--config", str(cfg_path), "--prompt-wav", str(cont_tmp / "prompt.wav"), "--out-wav", str(out_wav),
                 "--decoder-dir", str(cont_tmp / "decoder"), "--max-new-tokens", str(LM_GEN_TOKENS), "--temperature", "0.0"])
    torch.cuda.synchronize()
    launches = {"flash_attention": A.flash_attention.launches, "codebook_assign": C.assign_kernel.launches,
                "mrf_branch": M.mrf_branch_kernel.launches, "mrf_stage": M.mrf_stage_kernel.launches,
                "conv_ff": K5.conv_ff_kernel.launches}
    # greedy decoding from the same checkpoint and prompt: the direct call's continuation, so its length
    direct = audio_io.info(root / "generated_speech.wav")
    cli["generate"] = {"launches": launches, "seconds": time.perf_counter() - t0, "wav": audio_io.info(out_wav), "direct_wav": direct}
    if launches != generate["speech"]["expected"] or cli["generate"]["wav"] != direct:
        fail(f"cli.speechlm generate: {cli['generate']}, expected the launches {generate['speech']['expected']}")
    record["cli"] = cli
    print(json.dumps(record))
    torch.cuda.empty_cache()
    shutil.rmtree(root / "loop")  # its checkpoints (1.65 GB each) have been read: room for the runs below
    config = {**config, "optim": {**config["optim"], "epoch": LM_KILL_EPOCHS}}
    one_rank = start_one_rank_run(root, config)  # beside the kill/resume runs: its own process, deterministic
    kill = lm_kill_resume_check(torch, root, config)
    distributed = distributed_phase(torch, root, one_rank, kill)
    return {"validation": validation, "eval": evaluation, "generate": {k: v["launches"] for k, v in generate.items()},
            "cli_eval": cli["eval"]["launches"], "cli_generate": cli["generate"]["launches"],
            "generate_decoder": (generate["speech"]["bound"], generate["speech"]["frames"]), "scoring_shapes": shapes,
            "kill_resume": kill, "distributed": distributed}


TORCHRUN_RANK = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost"}


def start_one_rank_run(root: Path, config: dict):
    """``lm_run`` as one torchrun-style rank (TORCHRUN_RANK and a free port)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return lm_run(root, config, "distributed", env={**TORCHRUN_RANK, "MASTER_PORT": str(port)})


def distributed_phase(torch, root: Path, proc, kill: dict) -> dict:
    """``train_speechlm`` as one torchrun-style rank (``proc``: RANK=0,
    WORLD_SIZE=1, NCCL through ``distributed_init``: the mesh's DeviceMesh,
    rank-0 checkpoints) on the loop phase's corpus and config,
    deterministic: its final loss and checkpoint must equal the straight
    run's of the kill/resume check (one process, no process group). This
    machine has one card: no multi-card number is measured here."""
    import hashlib
    import shutil

    t0 = time.perf_counter()
    result = run_result(proc, "the one-rank torchrun LM run")
    straight = kill["straight"]
    record = {"phase": "distributed", "env": TORCHRUN_RANK, "process_group": result["process_group"], "step": result["step"],
              "loss": result["metrics"]["loss"], "loss_single_process": straight["metrics"]["loss"],
              "lm_sha256": lm_checkpoint_hash(hashlib, torch, root / "distributed"),
              "lm_sha256_single_process": kill["straight_hash"], "waited_seconds": time.perf_counter() - t0,
              "multi_card": "not measured: this machine has one card; multi-card numbers wait for a 4-chip benchmark cell"}
    print(json.dumps(record))
    shutil.rmtree(root / "distributed")
    shutil.rmtree(root / "kr_straight")
    if (result["process_group"] != {"backend": "nccl", "world_size": 1} or record["loss"] != record["loss_single_process"]
            or record["lm_sha256"] != record["lm_sha256_single_process"] or result["step"] != straight["step"]):
        fail(f"the one-rank torchrun run differs from the single process: {record}")
    return record


# -- the eval stack: Whisper ASR, UTMOS MOS, evaluate ---------------------------------

WHISPER_BATCH, WHISPER_NEW_TOKENS = 8, 50  # NativeWhisperASR's window batch and token budget
WHISPER_LONG_SECONDS = 70  # a wave of three 30-s windows (step 20 s)
WHISPER_PROFILE_TOKENS = 20  # the timed and the profiled window batch's tokens (~1 100 kernels a step)
UTMOS_WAVES = 8
EVAL_UTTS = 32  # configs/resynth/mhubert-expresso-2000.yaml flow_matching_with_hifigan.batch_size: one decoder batch
# a 10-s utterance's transcript is ~30-60 tokens; random weights never give eos, so evaluate's
# native ASR stops at this cap instead
EVAL_NEW_TOKENS = 16
EVAL_PROFILE_UTTS, EVAL_PROFILE_TOKENS = 8, 10
WORDS = ("the", "cat", "sat", "on", "a", "mat", "in", "nineteen", "eighty", "four", "we", "met", "hello", "world", "speech")


def init_on_card(torch, module, seed: int) -> None:
    """Seeded random weights drawn on the card (a CUDA generator) by the
    module's own rules (``models.composite.init_random_weights``): Whisper
    large-v3's 1.5 B parameters in seconds."""
    from speech_resynth_torch.models.composite import init_random_weights

    init_random_weights(module, torch.Generator(device="cuda").manual_seed(seed))


def write_whisper_dir(torch, path: Path) -> dict:
    """A large-v3-shaped HF directory: seeded bf16 weights at the full widths
    (``core.safetensors.save_file``), ``config.json``,
    ``generation_config.json`` with the forced ids (English, transcribe, no
    timestamps) and a synthetic byte-level tokenizer of all 51 866 ids."""
    import dataclasses

    from speech_resynth_torch.core.precision import BF16_INFERENCE
    from speech_resynth_torch.core.safetensors import save_file
    from speech_resynth_torch.models.whisper import WhisperConfig, WhisperForASR
    from test_torch_cuda import write_whisper_tokenizer

    path.mkdir(parents=True)
    languages = ["en"] + [f"x{i:02d}" for i in range(99)]
    ids = write_whisper_tokenizer(path, 50257, languages=languages, timestamps=1501)["added"]
    cfg = WhisperConfig()
    if len(ids) + 50257 != cfg.vocab_size or ids["<|startoftranscript|>"] != cfg.decoder_start_token_id:
        fail(f"the synthetic tokenizer's ids are not large-v3's: {len(ids) + 50257}")
    with torch.device("cuda"):
        model = WhisperForASR(cfg, BF16_INFERENCE)
    init_on_card(torch, model, 11)
    save_file(model.state_dict(), path / "model.safetensors")
    del model
    (path / "config.json").write_text(json.dumps({"model_type": "whisper", **dataclasses.asdict(cfg)}))
    forced = [[1, ids["<|en|>"]], [2, ids["<|transcribe|>"]], [3, ids["<|notimestamps|>"]]]
    (path / "generation_config.json").write_text(json.dumps({"forced_decoder_ids": forced}))
    return ids


def counting_decode_steps(model) -> list:
    """Each ``decode_step`` call's batch, recorded (no launch of its own)."""
    calls = []
    real = model.decode_step

    def step(input_ids, cross_kv, cache, cache_index):
        calls.append((input_ids.shape[0], input_ids.shape[1]))
        return real(input_ids, cross_kv, cache, cache_index)

    model.decode_step = step
    return calls


def whisper_launch_shapes(calls: list, layers: int, heads: int, keys: int) -> list:
    """(shape, launches) of K1 for the decode-step calls of ``greedy_decode``
    runs: per run the encoder (a launch a layer), then the prefill's and
    every step's cross-attention (a launch a layer); shapes of a
    cross-attention are (B, H, q_len, k_len, d)."""
    out = []
    for b, n in calls:
        if n > 1:  # a prefill starts a run: its window batch's encoder ran just before
            out.append(([b, heads, keys, 64], layers))
        out.append(([b, heads, n, keys, 64], layers))
    return out


def cross_attention_shape(torch, F, A, gen, path: str, B: int, H: int, Nq: int, Nk: int, D: int = 64) -> dict:
    """K1 against attention_reference at a cross-attention shape (q_len !=
    k_len, no mask, not causal), bf16 and f32; times in bf16 beside SDPA."""
    dev = "cuda"
    errs = {}
    for name in DTYPES:
        dtype = getattr(torch, name)
        q = torch.randn(B, H, Nq, D, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, H, Nk, D, generator=gen, device=dev).to(dtype) for _ in range(2))
        got = A.flash_attention(q, k, v, None, False)
        want = A.attention_reference(q, k, v, None, False)
        torch.cuda.synchronize()
        errs[name] = max_err(torch, got, want)
        if not torch.isfinite(got.float()).all() or errs[name] > ATT_TOL[name]:
            fail(f"flash_attention {path} {[B, H, Nq, Nk, D]} {name}: max abs err {errs[name]} > {ATT_TOL[name]}")
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    record = {
        "path": path, "shape": [B, H, Nq, Nk, D], "dtype": "bfloat16", "key_lengths": None, "causal": False,
        "live_tile_share": A.live_tile_share(None, B, Nq, Nk, False, A.QUERY_BLOCK),
        "max_abs_err": errs["bfloat16"], "f32_max_abs_err": errs["float32"], "tol": ATT_TOL,
        **timed(
            torch,
            lambda: A.flash_attention(q, k, v, None, False),
            lambda: A.attention_reference(q, k, v, None, False),
            lambda: F.scaled_dot_product_attention(q, k, v),
            nbytes=2 * B * H * Nq * D * 2 + 2 * B * H * Nk * D * 2,  # q and o, K and V read once
            flops=4.0 * B * H * Nq * Nk * D,
            peak_flops=PEAK_BF16_FLOPS,
            graph=True,
        ),
    }
    print(json.dumps({"phase": "flash_attention", **record}))
    return record


def whisper_phase(torch, np, F, A, root: Path):
    """``NativeWhisperASR`` at large-v3's full widths (32 + 32 layers, d_model
    1 280, 20 heads of 64, 128 mels, vocab 51 866; seeded bf16 weights) from
    an HF directory written through the port's safetensors writer:
    transcribes 8 waves of 8-10 s and one of 70 s (three windows) with 200
    new tokens (random weights never give eos), windows batched 8 at a time.
    Checks the long wave's windows, the transcripts, the launches; then
    ``greedy_decode`` in f32 on the card against the CPU at a small width, K1
    at the encoder's and the cross-attention's shapes, the encoder's ms per
    window batch and the ms per decoded token, and a profile of one window
    batch. Returns the scorer (the evaluate phase reuses it), the launches
    and their shapes."""
    from speech_resynth_torch.dsp.mel import whisper_log_mel
    from speech_resynth_torch.models.whisper import greedy_decode
    from speech_resynth_torch.pipeline.scorers import NativeWhisperASR
    from test_torch_cuda import whisper_decode_card_vs_cpu

    t0 = time.perf_counter()
    ids = write_whisper_dir(torch, root / "whisper-large-v3")
    t_write = time.perf_counter() - t0
    asr = NativeWhisperASR(root / "whisper-large-v3", max_new_tokens=WHISPER_NEW_TOKENS, batch_size=WHISPER_BATCH)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0 - t_write
    cfg = asr.config
    rng = np.random.default_rng(61)
    waves = speechlike_waves(np, rng, 8) + speechlike_waves(np, rng, 1, seconds=(WHISPER_LONG_SECONDS, WHISPER_LONG_SECONDS))
    starts = asr._window_starts(len(waves[-1]), SAMPLE_RATE)
    if starts != [0, 20 * SAMPLE_RATE, 40 * SAMPLE_RATE] or asr._window_starts(len(waves[0]), SAMPLE_RATE) != [0]:
        fail(f"the 70-s wave's windows start at {starts}")
    asr.max_new_tokens = 2
    asr.transcribe(waves[:WHISPER_BATCH])  # warm-up: allocator, cuBLAS plans
    asr.max_new_tokens = WHISPER_NEW_TOKENS
    calls = asr.decode_calls = counting_decode_steps(asr.model)
    A.flash_attention.launches = 0
    t1 = time.perf_counter()
    texts = asr.transcribe(waves)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {"flash_attention": A.flash_attention.launches}
    shapes = whisper_launch_shapes(calls, cfg.decoder_layers, cfg.decoder_attention_heads, cfg.max_source_positions)
    if launches["flash_attention"] != sum(n for _, n in shapes):
        fail(f"whisper: {launches} K1 launches, {sum(n for _, n in shapes)} from its {len(calls)} decode steps")
    windows = 8 + len(starts)
    batches = [min(WHISPER_BATCH, windows - b) for b in range(0, windows, WHISPER_BATCH)]
    if [b for b, n in calls if n > 1] != batches or len(calls) != len(batches) * WHISPER_NEW_TOKENS:
        fail(f"whisper: decode steps {calls[:3]}... ({len(calls)}) for window batches {batches}")
    if len(texts) != len(waves) or not all(isinstance(t, str) for t in texts):
        fail(f"whisper: transcripts {texts!r}")
    audio_s = sum(len(w) for w in waves) / SAMPLE_RATE
    record = {"phase": "whisper", "widths": {"d_model": cfg.d_model, "layers": [cfg.encoder_layers, cfg.decoder_layers],
                                             "heads": cfg.encoder_attention_heads, "mels": cfg.num_mel_bins, "vocab": cfg.vocab_size},
              "write_seconds": t_write, "load_seconds": t_load, "waves": len(waves), "windows": windows, "window_batches": batches,
              "long_wave_window_starts_s": [s / SAMPLE_RATE for s in starts], "new_tokens": WHISPER_NEW_TOKENS,
              "prompt_ids": asr.prompt_ids, "wall_seconds": wall, "audio_seconds": audio_s, "realtime_factor": audio_s / wall,
              "launches": launches, "transcript_chars": [len(t) for t in texts], "transcript_0": texts[0][:80]}

    # the encoder's ms per window batch and the ms per decoded token (over WHISPER_PROFILE_TOKENS), CUDA events on a warm batch
    chunk = 30 * SAMPLE_RATE
    batch = np.zeros((WHISPER_BATCH, chunk), np.float32)
    for j, w in enumerate(waves[:WHISPER_BATCH]):
        batch[j, : min(len(w), chunk)] = w[:chunk]
    mel = whisper_log_mel(torch.from_numpy(batch).cuda(), num_mels=cfg.num_mel_bins)
    prompt = torch.tensor([asr.prompt_ids] * WHISPER_BATCH)
    with torch.inference_mode():
        enc_ms = time_ms(torch, lambda: asr.model.encode(mel), 3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    greedy_decode(asr.model, mel, WHISPER_PROFILE_TOKENS, prompt)
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end)
    record.update({"encoder_ms_per_window_batch": enc_ms, f"greedy_ms_per_window_batch_{WHISPER_PROFILE_TOKENS}_tokens": decode_ms,
                   "ms_per_decoded_token": (decode_ms - enc_ms) / WHISPER_PROFILE_TOKENS})
    record["card_vs_cpu_f32"] = whisper_decode_card_vs_cpu()
    print(json.dumps(record))
    profile_phase(torch, f"whisper window batch ({WHISPER_BATCH} windows, {WHISPER_PROFILE_TOKENS} tokens)",
                  lambda: greedy_decode(asr.model, mel, WHISPER_PROFILE_TOKENS, prompt), 1)

    gen = torch.Generator(device="cuda").manual_seed(62)
    held = []
    for b in sorted(set(batches), reverse=True):
        held.append(attention_shape(torch, F, A, gen, "whisper encoder", b, cfg.encoder_attention_heads, cfg.max_source_positions,
                                    64, cfg.max_source_positions, cfg.max_source_positions, masked=False))
        for q_len in (len(asr.prompt_ids), 1):
            held.append(cross_attention_shape(torch, F, A, gen, f"whisper cross-attention (q_len {q_len})", b,
                                              cfg.decoder_attention_heads, q_len, cfg.max_source_positions))
    return asr, launches, shapes, held, record


def lightning_utmos_state_dict(torch, sd: dict) -> dict:
    """The port's UTMOS state_dict in the published lightning layout
    (fairseq names, the positional conv as weight norm's g and v): the
    inverse of ``models.convert.utmos_state_dict_from_lightning``."""
    from speech_resynth_torch.models.convert import FAIRSEQ_LAYER_KEYS, POS_CONV

    ssl_prefix, out = "model.feature_extractors.0.ssl_model.", {}
    renames = {"feature_projection.layer_norm": "layer_norm", "feature_projection.projection": "post_extract_proj",
               "encoder.layer_norm": "encoder.layer_norm"}
    for key, value in sd.items():
        if not key.startswith("ssl."):
            continue
        k = key[len("ssl."):]
        if k.startswith(POS_CONV):
            if k.endswith("weight"):
                out[ssl_prefix + "encoder.pos_conv.0.weight_g"] = value.norm(dim=(0, 1), keepdim=True)
                out[ssl_prefix + "encoder.pos_conv.0.weight_v"] = value
            else:
                out[ssl_prefix + "encoder.pos_conv.0.bias"] = value
            continue
        if k.startswith("feature_extractor.conv_layers."):
            k = k.replace(".conv.weight", ".0.weight").replace(".layer_norm.", ".2.")
        elif k.startswith("encoder.layers."):
            for theirs, ours in FAIRSEQ_LAYER_KEYS:
                k = k.replace(f".{ours}.", f".{theirs}.")
        else:
            k = next(theirs + k[len(ours):] for ours, theirs in renames.items() if k.startswith(ours + "."))
        out[ssl_prefix + k] = value
    out.update({f"model.output_layers.0.decoder_rnn.{k[len('decoder_rnn.'):]}": v for k, v in sd.items() if k.startswith("decoder_rnn.")})
    out["model.feature_extractors.1.embedding.weight"] = sd["domain_embedding.weight"]
    out["model.output_layers.0.judge_embedding.weight"] = sd["judge_embedding.weight"]
    for ours, theirs in (("proj_in", "net.0"), ("proj_out", "net.3")):
        for part in ("weight", "bias"):
            out[f"model.output_layers.1.{theirs}.{part}"] = sd[f"{ours}.{part}"]
    return out


def utmos_phase(torch, np, F, A, root: Path):
    """``NativeUTMOS`` at full width (wav2vec2-base 12 x 768, 3 280 judges,
    LSTM 512, head 2 048; seeded weights) from a lightning-shaped torch save
    and from the same tensors as safetensors: 8 waves of 1-10 s scored as
    one padded batch by each, then each wave alone (bf16 tower). Checks the
    two files agree, the padded batch against the waves alone, and in f32
    the padded batch against the waves alone on the card and the card
    against the CPU; K1 at the tower's masked shape held and timed."""
    from speech_resynth_torch.core.precision import FLOAT32
    from speech_resynth_torch.core.safetensors import save_file
    from speech_resynth_torch.models.composite import init_random_weights
    from speech_resynth_torch.models.utmos import UTMOSConfig, UTMOSPredictor
    from speech_resynth_torch.pipeline.scorers import BUCKET_SAMPLES, NativeUTMOS
    from test_torch_cuda import utmos_card_vs_cpu

    model = UTMOSPredictor(UTMOSConfig(), FLOAT32)
    init_random_weights(model, torch.Generator().manual_seed(21))
    lightning = lightning_utmos_state_dict(torch, model.state_dict())
    del model
    ckpt, st = root / "utmos.ckpt", root / "utmos.safetensors"
    torch.save({"state_dict": lightning}, ckpt)
    save_file(lightning, st)
    rng = np.random.default_rng(63)
    waves = speechlike_waves(np, rng, UTMOS_WAVES, seconds=(1, 10))
    cfg = UTMOSConfig()
    scorers = {"ckpt": NativeUTMOS(ckpt), "safetensors": NativeUTMOS(st)}
    scorers["ckpt"].score_batch(waves)  # warm-up
    A.flash_attention.launches = 0
    t0 = time.perf_counter()
    batch = {name: s.score_batch(waves) for name, s in scorers.items()}
    wall = time.perf_counter() - t0
    alone = [scorers["ckpt"].score(w) for w in waves]
    torch.cuda.synchronize()
    launches = {"flash_attention": A.flash_attention.launches}
    bucket = -(-max(map(len, waves)) // BUCKET_SAMPLES) * BUCKET_SAMPLES
    frames = [int(cfg.ssl.num_frames(len(w))) for w in waves]
    layers, heads = cfg.ssl.num_hidden_layers, cfg.ssl.num_attention_heads
    shapes = [([UTMOS_WAVES, heads, int(cfg.ssl.num_frames(bucket)), 64], 2 * layers)]
    shapes += [([1, heads, int(cfg.ssl.num_frames(max(BUCKET_SAMPLES, -(-len(w) // BUCKET_SAMPLES) * BUCKET_SAMPLES))), 64], layers)
               for w in waves]
    if launches["flash_attention"] != sum(n for _, n in shapes):
        fail(f"utmos: {launches} K1 launches, expected {sum(n for _, n in shapes)}")
    files_err = max(abs(a - b) for a, b in zip(batch["ckpt"], batch["safetensors"]))
    alone_err = max(abs(a - b) for a, b in zip(batch["ckpt"], alone))
    f32 = NativeUTMOS(st, policy=FLOAT32)
    f32_batch, f32_alone = f32.score_batch(waves), [f32.score(w) for w in waves]
    f32_cpu = NativeUTMOS(st, policy=FLOAT32, device="cpu").score_batch(waves[-2:])
    tol = {"files": 1e-6, "padded_vs_alone_bf16": 5e-2, "padded_vs_alone_f32": 1e-3, "card_vs_cpu_f32": 1e-3}
    record = {"phase": "utmos", "waves": UTMOS_WAVES, "seconds": [len(w) / SAMPLE_RATE for w in waves], "frames": frames,
              "bucket_samples": bucket, "mos": batch["ckpt"], "score_batch_seconds_both_files": wall, "launches": launches,
              "files_max_abs_err": files_err, "padded_vs_alone_max_abs_err": alone_err,
              "f32_padded_vs_alone_max_abs_err": max(abs(a - b) for a, b in zip(f32_batch, f32_alone)),
              "f32_card_vs_cpu_max_abs_err": max(abs(a - b) for a, b in zip(f32_batch[-2:], f32_cpu)), "tol": tol,
              "tiny_card_vs_cpu": utmos_card_vs_cpu()}
    print(json.dumps(record))
    if (files_err > tol["files"] or alone_err > tol["padded_vs_alone_bf16"] or record["f32_padded_vs_alone_max_abs_err"] > tol["padded_vs_alone_f32"]
            or record["f32_card_vs_cpu_max_abs_err"] > tol["card_vs_cpu_f32"] or not all(math.isfinite(m) for m in batch["ckpt"])):
        fail(f"utmos: {record}")
    gen = torch.Generator(device="cuda").manual_seed(64)
    T = int(cfg.ssl.num_frames(bucket))
    held = attention_shape(torch, F, A, gen, "utmos tower", UTMOS_WAVES, heads, T, 64, 1, T,
                           lengths=torch.tensor(frames, device="cuda"))
    return scorers["ckpt"], launches, shapes, held, record


def write_eval_set(np, audio_io, root: Path, n: int, seed: int) -> Path:
    """``n`` utterances of 400-500 units (8-10 s at 50 Hz) with transcripts
    and 8-10 s reference waves: a unit JSON and a wav directory."""
    rng = np.random.default_rng(seed)
    (root / "wav").mkdir(parents=True, exist_ok=True)
    units = {}
    for i, wave in enumerate(speechlike_waves(np, rng, n)):
        k = int(rng.integers(400, 501))
        units[f"e{i}"] = {"units": rng.integers(0, ENCODER[2], k).tolist(), "durations": [1] * k,
                          "transcript": " ".join(rng.choice(WORDS, int(rng.integers(4, 12))))}
        audio_io.write(root / "wav" / f"e{i}.wav", wave, SAMPLE_RATE)
    path = root / f"test_{n}.json"
    path.write_text(json.dumps(units))
    return path


def evaluate_phase(torch, np, A, M, root: Path, asr, mos) -> dict:
    """``pipeline.evaluate`` on the full-width decoder of
    configs/resynth/mhubert-expresso-2000.yaml (random weights, bf16) over
    32 utterances with reference waves, one decoder batch of 32: once with
    ``NullASR`` / ``EnergyMOS`` and once with the native Whisper and UTMOS
    of the phases above (Whisper stopping at ``EVAL_NEW_TOKENS``). Checks
    the six rows, the scorer column and the CSV; counts the launches of each
    run; profiles an 8-utterance run with the native scorers at 10 new
    tokens."""
    from speech_resynth_torch.core.config import config_from_dict
    from speech_resynth_torch.core.precision import BF16_INFERENCE
    from speech_resynth_torch.dsp import audio_io
    from speech_resynth_torch.models.cfm import CFMConfig
    from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan
    from speech_resynth_torch.models.hifigan import HifiGanConfig
    from speech_resynth_torch.pipeline.data import UnitDataset
    from speech_resynth_torch.pipeline.evaluate import ROWS, evaluate, read_table
    from speech_resynth_torch.pipeline.scorers import EnergyMOS, NullASR

    decoder = ConditionalFlowMatchingWithHifiGan.from_config(
        CFMConfig(vocab_size=ENCODER[2]), HifiGanConfig(), BF16_INFERENCE, generator=torch.Generator().manual_seed(0), device="cuda")
    test_file = write_eval_set(np, audio_io, root, EVAL_UTTS, 65)

    def config(name, file):
        return config_from_dict({
            "dataset": {"test_file": str(file), "wav_dir": str(root / "wav"), "ext_audio": ".wav"},
            "flow_matching": {"dt": 0.0625, "truncation_value": 1.0},
            "flow_matching_with_hifigan": {"batch_size": EVAL_UTTS},
            "eval": {"result_path": str(root / name / "score.csv")},
        })

    frames = [b["input_ids"].shape[1] for b in UnitDataset(str(test_file)).batches(EVAL_UTTS, shuffle=False, drop_last=False)]
    out = {"frames": frames, "runs": {}}
    evaluate(config("warm", test_file), decoder=decoder, asr=NullASR(), mos=EnergyMOS())  # warm-up: allocator, cuDNN plans
    calls = asr.decode_calls
    mos_lengths = []  # the sample count of every wave the native MOS scores
    score_batch = mos.score_batch
    mos.score_batch = lambda wavs: mos_lengths.extend(len(w) for w in wavs) or score_batch(wavs)
    asr.max_new_tokens = EVAL_NEW_TOKENS
    for name, scorers in (("stand_in", (NullASR(), EnergyMOS())), ("native", (asr, mos))):
        calls.clear()
        mos_lengths.clear()
        A.flash_attention.launches = M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = K5.conv_ff_kernel.launches = 0
        t0 = time.perf_counter()
        rows = evaluate(config(name, test_file), decoder=decoder, asr=scorers[0], mos=scorers[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": A.flash_attention.launches, "mrf_branch": M.mrf_branch_kernel.launches,
                    "mrf_stage": M.mrf_stage_kernel.launches, "conv_ff": K5.conv_ff_kernel.launches}
        whisper = whisper_launch_shapes(calls, asr.config.decoder_layers, asr.config.decoder_attention_heads,
                                        asr.config.max_source_positions)
        ssl = mos.config.ssl
        utmos = [([1, ssl.num_attention_heads, int(ssl.num_frames(max(1, -(-n // 16000)) * 16000)), 64], ssl.num_hidden_layers)
                 for n in mos_lengths]
        want = {"flash_attention": 64 * len(frames) + sum(n for _, n in whisper + utmos), "mrf_branch": 9 * len(frames),
                "mrf_stage": 0, "conv_ff": FF_PER_BATCH * len(frames)}
        scorer_names = [type(scorers[1 if r.startswith("MOS") else 0]).__name__ for r in ROWS]
        from_csv = read_table(root / name / "score.csv")
        run = {"rows": rows, "wall_seconds": wall, "launches": launches, "whisper_decode_steps": len(calls),
               "whisper_window_batches": [b for b, n in calls if n > 1]}
        out["runs"][name] = {**run, "whisper_shapes": whisper, "utmos_shapes": utmos}
        print(json.dumps({"phase": "evaluate", "scorers": name, **run}))
        if (launches != want or len(mos_lengths) != (2 * EVAL_UTTS if name == "native" else 0) or [r[0] for r in rows] != list(ROWS) or [r[2] for r in rows] != scorer_names
                or from_csv != rows or not all(math.isfinite(r[1]) for r in rows)):
            fail(f"evaluate ({name}): launches {launches} (expected {want}), rows {rows}, CSV {from_csv}")
        if name == "stand_in" and (rows[0][1] != 1.0 or rows[1][1] != 1.0):
            fail(f"evaluate with NullASR: WER / CER {rows[:2]} != 1")
    small = write_eval_set(np, audio_io, root / "small", EVAL_PROFILE_UTTS, 66)
    asr.max_new_tokens = EVAL_PROFILE_TOKENS
    try:
        profile_phase(torch, f"evaluate ({EVAL_PROFILE_UTTS} utterances, native scorers, {EVAL_PROFILE_TOKENS} new tokens)",
                      lambda: evaluate(config("profile", small), decoder=decoder, asr=asr, mos=mos), 1)
    finally:
        asr.max_new_tokens = WHISPER_NEW_TOKENS
        mos.score_batch = score_batch
    return out


# -- the CLIs, the entry points of graft_entry and the end-to-end quality run ---------

CLI_FILES, CLI_TRAIN, CLI_DEV = 16, 12, 2  # the cli phase's 24 kHz tree: 12 train, 2 dev and 2 test files
CLI_BATCH = 6  # both trainers' batch there: one epoch of 2 steps over the 12 train files
E2E_SCALE = "ci"  # the chip scale runs for minutes: python -m speech_resynth_torch.pipeline.e2e_quality <dir> chip
# E2E_QUALITY.md: the JAX package's quality numbers at scale "chip" (mel-L1s and pair accuracy; its times are a TPU's)
JAX_E2E_QUALITY = {"gan_mel_l1_untrained": 4.61, "gan_mel_l1_trained": 0.95, "cfm_mel_l1_untrained": 2.97,
                   "cfm_mel_l1_trained": 1.29, "resynth_mel_l1": 1.00, "lm_pair_accuracy": 1.00}


def cli_resynth_config(root: Path) -> dict:
    """configs/resynth/mhubert-expresso-2000.yaml over the tree under
    ``root``: its widths, encoder and trainer values; both batches cut to
    CLI_BATCH and one epoch each (2 steps), a CFM save (and its dev sweep)
    at that epoch; no composite checkpoint, so ``evaluate`` and
    ``synthesize`` read the two training exports."""
    wav_dir = root / "16k"
    return {
        "common": {"seed": 0},
        "dataset": {"wav_dir": str(wav_dir), "wav_dir_orig": str(root / "orig"), "spectrogram_dir": str(wav_dir / "spectrogram"),
                    "vad": False, "preprocess_batch_size": PRE_TOKENIZE_BATCH, "ext_audio": ".wav", "ext_txt": ".normalized.txt",
                    "train_file": str(root / "units/train.json"), "dev_file": str(root / "units/dev.json"),
                    "test_file": str(root / "units/test.json")},
        "synthesis": {"src_dir": str(wav_dir), "tgt_dir": str(root / "resynth"), "split": "test-*", "ext_audio": ".wav"},
        "eval": {"result_path": str(root / "results/score.csv")},
        "flow_matching": {**CFM_TRAIN, "batch_size": CLI_BATCH, "path": str(root / "flow_matching"), "epoch": 1,
                          "summary_interval": 1, "save_interval_epoch": 1},
        "hifigan": {**GAN_TRAIN, "batch_size": CLI_BATCH, "path": str(root / "hifigan"), "training_epochs": 1,
                    "summary_interval": 1, "checkpoint_interval": 10000, "validation_interval": 10000},
        "flow_matching_with_hifigan": {"name": str(root / "no_composite"), "batch_size": EVAL_UTTS},
    }


def cli_phase(torch, np, A, C, M, root: Path) -> dict:
    """The resynthesis CLI as a user runs it: ``--help`` of both CLIs in
    subprocesses; then, in this process (so the counters see its launches),
    ``cli.resynth.main(["all", "--config", ...])`` on a 24 kHz
    LibriTTS-R-shaped tree of CLI_FILES files at the widths of
    configs/resynth/mhubert-expresso-2000.yaml (seeded random weights, the
    stand-in scorers: no Whisper or UTMOS checkpoint) and ``main(["synthesize",
    ...])``. The checks of tests/test_cli_chain.py: the 16 kHz wavs, the unit
    JSONs, the mels, both exports, the 7-line score CSV, every resynthesized
    file at the length its units give; and the launches: 11 K1 + 1 K4 per
    tokenize batch, 4 K1 per CFM step, 64 K1 + 9 K2 per decoder batch (the
    CFM save's dev sweep, ``evaluate``, ``synthesize``), 11 K1 + 1 K4 per
    ``synthesize`` encoder batch. Between the two calls the exported
    generator's conv_post weight is scaled by WIRE_GAIN, so the files
    ``synthesize`` writes hold nonzero PCM16 codes (two GAN steps leave the
    generator near its initial scale)."""
    import yaml

    from speech_resynth_torch.cli import resynth as cli
    from speech_resynth_torch.core.safetensors import load_file, save_file
    from speech_resynth_torch.dsp import audio_io
    from speech_resynth_torch.models.hifigan import HifiGanConfig
    from speech_resynth_torch.models.hubert import HubertConfig
    from speech_resynth_torch.pipeline.data import UnitDataset

    t0 = time.perf_counter()
    helps = {}
    for module in ("speech_resynth_torch.cli.resynth", "speech_resynth_torch.cli.speechlm"):
        proc = subprocess.run([sys.executable, "-m", module, "--help"], capture_output=True, text=True, timeout=120,
                              cwd=str(Path(__file__).resolve().parent))
        helps[module] = proc.returncode
        if proc.returncode or "--device" not in proc.stdout:
            fail(f"{module} --help: exit {proc.returncode}, {proc.stderr[-2000:]}")
    lengths = write_libritts_tree(np, audio_io, root / "orig", CLI_FILES, CLI_TRAIN, CLI_DEV)
    path = root / "config.yaml"
    path.write_text(yaml.safe_dump(cli_resynth_config(root)))
    record = {"phase": "cli", "help_exit_codes": helps, "files": CLI_FILES, "batch": CLI_BATCH}

    A.flash_attention.launches = C.assign_kernel.launches = M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = 0
    K5.conv_ff_kernel.launches = 0
    t1 = time.perf_counter()
    cli.main(["all", "--config", str(path)])
    torch.cuda.synchronize()
    record["all_seconds"] = time.perf_counter() - t1
    exported = root / "hifigan" / "model.safetensors"
    weights = load_file(str(exported))
    weights["conv_post.weight"] = weights["conv_post.weight"] * WIRE_GAIN
    save_file(weights, str(exported))
    t1 = time.perf_counter()
    cli.main(["synthesize", "--config", str(path)])
    torch.cuda.synchronize()
    record["synthesize_seconds"] = time.perf_counter() - t1
    launches = {"flash_attention": A.flash_attention.launches, "codebook_assign": C.assign_kernel.launches,
                "mrf_branch": M.mrf_branch_kernel.launches, "mrf_stage": M.mrf_stage_kernel.launches,
                "conv_ff": K5.conv_ff_kernel.launches}

    splits = {"train": CLI_TRAIN, "dev": CLI_DEV, "test": CLI_FILES - CLI_TRAIN - CLI_DEV}
    tokenize_batches = [min(PRE_TOKENIZE_BATCH, n - i) for n in splits.values() for i in range(0, n, PRE_TOKENIZE_BATCH)]
    wavs = sorted((root / "16k").glob("**/*.wav"))
    units = {split: json.loads((root / f"units/{split}.json").read_text()) for split in splits}
    mels = list((root / "16k" / "spectrogram").glob("**/*.npy"))
    exports = [root / "hifigan", root / "flow_matching" / "hf"]
    csv = (root / "results/score.csv").read_text().splitlines()
    # the decoder batches: the CFM save's dev sweep and evaluate (each one batch, its bucket), synthesize's (30-s padding)
    dev_frames = [b["input_ids"].shape[1] for b in UnitDataset(str(root / "units/dev.json")).batches(8, shuffle=False, drop_last=False)]
    test_frames = [b["input_ids"].shape[1] for b in UnitDataset(str(root / "units/test.json")).batches(EVAL_UTTS, shuffle=False, drop_last=False)]
    hubert, voc = HubertConfig(), HifiGanConfig()
    outs, written = {}, []
    for wav in wavs:
        if "test-clean" in str(wav):
            name = wav.relative_to(root / "16k")
            out = root / "resynth" / name
            want = int(voc.waveform_lengths(hubert.num_frames(audio_io.info(wav)[2])))
            outs[str(name)] = {"info": list(audio_io.info(out)) if out.is_file() else None, "want": [SAMPLE_RATE, 1, want]}
            if out.is_file():
                written.append(audio_io.read(out)[0])
    want = {
        "flash_attention": 11 * len(tokenize_batches) + 2 * 4 + 64 * (len(dev_frames) + len(test_frames)) + 11 + 64,
        "codebook_assign": len(tokenize_batches) + 1, "mrf_branch": 9 * (len(dev_frames) + len(test_frames) + 1), "mrf_stage": 0,
        "conv_ff": FF_PER_BATCH * (len(dev_frames) + len(test_frames) + 1),  # the CFM steps record a gradient: no K5
    }
    record.update(launches=launches, expected=want, tokenize_batches=tokenize_batches,
                  dev_frames=dev_frames, test_frames=test_frames, wavs=len(wavs), units={k: len(v) for k, v in units.items()},
                  mels=len(mels), csv_lines=len(csv), resynthesized=outs, seconds=time.perf_counter() - t0,
                  wire_gain=WIRE_GAIN, nonzero_code_share=wire_share(np, "cli.resynth synthesize files", written))
    print(json.dumps(record))
    if (len(wavs) != CLI_FILES or {k: len(v) for k, v in units.items()} != splits or len(mels) != CLI_FILES
            or not all((e / "model.safetensors").is_file() and (e / "config.json").is_file() for e in exports)
            or len(csv) != 7 or len(outs) != splits["test"] or any(o["info"] != o["want"] for o in outs.values())):
        fail(f"cli.resynth all + synthesize: {record}")
    if launches != want:
        fail(f"cli.resynth launched {launches}, expected {want}")
    frames = [hubert.num_frames(n) for n in (audio_io.info(w)[2] for w in wavs)]
    return {"launches": launches, "tokenize_batches": tokenize_batches, "dev_frames": dev_frames, "test_frames": test_frames,
            "key_frames": [min(frames), max(frames)], "synthesize_batch": splits["test"]}


def entry_phase(torch, A, M) -> dict:
    """``graft_entry.entry()`` on the card: the flagship decoder at reference
    sizes on its seeded (2, 128) ids. One warm-up call, then one counted and
    timed call: 64 K1 (16 ODE steps x 4 layers), 128 K5 and 9 K2, finite waves of
    ``HifiGanConfig.waveform_lengths`` samples."""
    from speech_resynth_torch import graft_entry

    fn, (ids, generator) = graft_entry.entry()
    fn(ids, generator)
    torch.cuda.synchronize()
    A.flash_attention.launches = M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = K5.conv_ff_kernel.launches = 0
    t0 = time.perf_counter()
    wave, lengths = fn(ids, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {"flash_attention": A.flash_attention.launches, "mrf_branch": M.mrf_branch_kernel.launches,
                "mrf_stage": M.mrf_stage_kernel.launches, "conv_ff": K5.conv_ff_kernel.launches}
    want = graft_entry.VOCODER_CONFIG.waveform_lengths(torch.full((ids.shape[0],), ids.shape[1], device="cuda"))
    record = {"phase": "entry", "ids": list(ids.shape), "ms": ms, "launches": launches, "lengths": lengths.tolist(),
              "wave": list(wave.shape), "audio_seconds_per_s": float(lengths.sum()) / SAMPLE_RATE / (ms / 1e3),
              "peak": float(wave.float().abs().max())}
    print(json.dumps(record))
    if (launches != {"flash_attention": 64, "mrf_branch": 9, "mrf_stage": 0, "conv_ff": FF_PER_BATCH} or not torch.equal(lengths, want)
            or wave.device.type != "cuda" or not torch.isfinite(wave.float()).all()):
        fail(f"graft_entry.entry(): {record}")
    return {"launches": launches, "ids": list(ids.shape)}


def e2e_branch_shapes(p: dict):
    """(vocoder config, the (C, T, K) of K2's launches per vocoder call) of
    the quality run's generator at the scale dict ``p``, evaluated in f32 on
    EVAL_PAD_FRAMES frames: its branches that K2 takes (``ResidualBlock.fused``)."""
    from speech_resynth_torch.core.precision import FLOAT32
    from speech_resynth_torch.models.hifigan import HifiGanConfig, HifiGanGenerator
    from speech_resynth_torch.pipeline import e2e_quality as e2e

    voc = HifiGanConfig(upsample_initial_channel=p["gan_channels"], resblock_kernel_sizes=(3, 7),
                        resblock_dilation_sizes=((1, 3), (1, 3)))
    blocks = HifiGanGenerator(voc, FLOAT32).resblocks
    shapes, t, per_stage = [], e2e.EVAL_PAD_FRAMES, len(voc.resblock_kernel_sizes)
    for i, (rate, kernel) in enumerate(zip(voc.upsample_rates, voc.upsample_kernel_sizes)):
        t = (t - 1) * rate - 2 * ((kernel - rate) // 2) + kernel
        for blk, k in zip(blocks[i * per_stage : (i + 1) * per_stage], voc.resblock_kernel_sizes):
            if blk.fused:
                shapes.append((voc.upsample_initial_channel // 2 ** (i + 1), t, k))
    return voc, shapes


# The guards of the quality run's GAN beside its gate. A generator drawn by the
# JAX package's initializers starts near silent (peak ~7e-9), where its
# gradients lie far below Adam's eps, so its first steps move the weights
# little (a relative change of 4e-4 after 2 steps and 1.4e-3 after the 16 of
# scale "ci" on the CPU, 1.0e-2 after those 16 on an H100) but its output a
# lot (peak 1.5e-4 to 4e-4). A trainer that never stepped the generator
# leaves a change of 0 and a ratio of peaks of 1.
GAN_MOVED_MIN = 1e-5  # the least relative change of the weights
GAN_LOUDER_MIN = 10.0  # the least ratio of the trained generator's peak to its draw's


def e2e_quality_phase(torch, np, A, C, M, root: Path, scale: str = E2E_SCALE) -> dict:
    """``run_e2e_quality(root, scale)`` on the card: the three loops on the
    synthetic corpora, then the held-out measures, with the JAX test's gates
    (tests/test_e2e_quality.py): GAN mel-L1 trained <= 1.05 x untrained, CFM
    trained < 0.7 x untrained, resynthesis finite and < 1.5 x the untrained
    GAN's, pair accuracy > 0.9. The launches: K2 (f32) in every vocoder
    call of the measures (3 per held-out utterance), K1 causal in the pair
    scoring (a batch of 16 a forward) where the LM's head dim is one K1
    takes (64 at scale "chip", 32 at "ci": the plain version); none in
    training (the CFM's head dim 32 and the LM's "xla" take the plain
    version; the generator records a gradient). Printed beside the JAX
    package's numbers of E2E_QUALITY.md. Beside the gates, two guards that
    are no quality gates: the trained generator's weights moved off their
    draw by more than GAN_MOVED_MIN of its norm, and its output's peak is at
    least GAN_LOUDER_MIN times its draw's (at scale "ci" both generators stay
    at the mel-L1 of silence, and the GAN gate there would hold a trainer
    that never stepped as well as one that did)."""
    from speech_resynth_torch.pipeline import e2e_quality as E
    from speech_resynth_torch.pipeline.data import load_named_units_from_json

    A.flash_attention.launches = C.assign_kernel.launches = M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = 0
    t0 = time.perf_counter()
    results = E.run_e2e_quality(root, scale=scale)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": A.flash_attention.launches, "codebook_assign": C.assign_kernel.launches,
                "mrf_branch": M.mrf_branch_kernel.launches, "mrf_stage": M.mrf_stage_kernel.launches}
    p = E.SCALES[scale]
    voc, branches = e2e_branch_shapes(p)
    scoring = [list(b["input_ids"].shape) for b in load_named_units_from_json(str(root / "lm_corpus" / "lm_pairs.json"), 16, 2)]
    k1_per_forward = p["lm_layers"] if p["lm_hidden"] // 2 in A.FLASH_HEAD_DIMS else 0  # 2 heads
    want = {"flash_attention": k1_per_forward * len(scoring), "codebook_assign": 0,
            "mrf_branch": 3 * p["n_eval"] * len(branches), "mrf_stage": 0}
    r = results
    gates = {
        "gan": bool(np.isfinite(r["gan_mel_l1_trained"]) and r["gan_mel_l1_trained"] <= 1.05 * r["gan_mel_l1_untrained"]),
        "cfm": bool(r["cfm_mel_l1_trained"] < 0.7 * r["cfm_mel_l1_untrained"]),
        "resynth": bool(np.isfinite(r["resynth_mel_l1"]) and r["resynth_mel_l1"] < 1.5 * r["gan_mel_l1_untrained"]),
        "lm": bool(r["lm_pair_accuracy"] > 0.9),
    }
    guards = {"gan_moved": bool(r["gan_weight_change"] > GAN_MOVED_MIN),
              "gan_louder": bool(r["gan_peak_trained"] >= GAN_LOUDER_MIN * r["gan_peak_untrained"])}
    record = {"phase": "e2e_quality", "scale": scale, "wall_seconds": wall, "results": results, "gates": gates,
              "guards": guards, "guard_limits": {"gan_moved": GAN_MOVED_MIN, "gan_louder": GAN_LOUDER_MIN},
              "jax_package_chip_scale": JAX_E2E_QUALITY,
              "launches": launches, "expected": want}
    print(json.dumps(record))
    if not all(gates.values()) or not all(guards.values()) or launches != want:
        fail(f"e2e quality: {record}")
    return {"launches": launches, "branches": branches, "scoring_shapes": scoring if k1_per_forward else [], "vocoder": voc,
            "n_eval": p["n_eval"], "k1_per_forward": k1_per_forward, "head_dim": p["lm_hidden"] // 2, "results": results,
            "wall_seconds": wall}


# The port's GAN learning check beside the quality run's gate: at scale ci the
# JAX draw's generator stays at the mel-L1 of silence, and on an H100 so does one
# of 32 or 64 channels for 1 200 steps at batch 16, while scale chip's GAN (128
# channels, batches of 16 crops of 16 frames, 192 + 16 utterances) leaves it
# within 100 steps (3.617 -> 2.053). 10 epochs of 12 steps.
GAN_LEARNING = dict(n_train=192, n_eval=16, gan_channels=128, gan_epochs=10, gan_batch=16, frames_per_seg=16)
GAN_LEARNING_MAX = 0.7  # trained held-out mel-L1 at most this times the draw's, the form of the CFM gate


def gan_learning_phase(torch, np, A, C, M, root: Path) -> dict:
    """The quality run's GAN at the port's learning scale GAN_LEARNING
    (``e2e_quality.run_gan_quality``: ``_gan_config``, the seed-0 and
    seed-99 corpora, GAN seed 1234, ``_eval_vocoder``): fails unless the
    trained held-out mel-L1 is at most GAN_LEARNING_MAX times the draw's.
    Launches: K2 (f32) in each evaluation's vocoder calls, one per held-out
    utterance for each of the two generators; none in training."""
    from speech_resynth_torch.pipeline import e2e_quality as E

    A.flash_attention.launches = C.assign_kernel.launches = M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = 0
    t0 = time.perf_counter()
    r = E.run_gan_quality(root, GAN_LEARNING)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": A.flash_attention.launches, "codebook_assign": C.assign_kernel.launches,
                "mrf_branch": M.mrf_branch_kernel.launches, "mrf_stage": M.mrf_stage_kernel.launches}
    voc, branches = e2e_branch_shapes(GAN_LEARNING)
    want = {"flash_attention": 0, "codebook_assign": 0, "mrf_branch": 2 * GAN_LEARNING["n_eval"] * len(branches), "mrf_stage": 0}
    ratio = r["gan_mel_l1_trained"] / r["gan_mel_l1_untrained"]
    record = {"phase": "gan_learning", "scale": GAN_LEARNING, "steps": r["gan_steps"], "wall_seconds": wall, "results": r,
              "trained_over_untrained": ratio, "max": GAN_LEARNING_MAX, "launches": launches, "expected": want}
    print(json.dumps(record))
    if not np.isfinite(r["gan_mel_l1_trained"]) or ratio > GAN_LEARNING_MAX or launches != want:
        fail(f"the GAN at the learning scale: {record}")
    return {"launches": launches, "branches": branches, "vocoder": voc, "n_eval": GAN_LEARNING["n_eval"], "results": r,
            "wall_seconds": wall}


# Each tool in a process of its own through its module entry point, as a user
# runs it (``python -m speech_resynth_torch.scripts.<tool>``); at exit the
# process prints its kernels' launch counts on a last line of its own.
TOOL_RUN = """
import atexit, json, runpy, sys
from speech_resynth_torch.ops import attention as A, codebook as C, fused_mrf as M
atexit.register(lambda: print("launches", json.dumps({"flash_attention": A.flash_attention.launches,
    "codebook_assign": C.assign_kernel.launches, "mrf_branch": M.mrf_branch_kernel.launches,
    "mrf_stage": M.mrf_stage_kernel.launches}), flush=True))
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""
FIT_FILES, FIT_ITERS = 16, 5  # fit_kmeans: 16 files of 8-10 s, padded to 20 s in 2 batches of 8 (999 frames)
GAN_RUN = ("--batch", "16", "--n-utts", "64")  # gan_longrun: 4 steps an epoch on a 64-utterance corpus
GAN_RESUME = ("--batch", "16", "--n-utts", "32")  # its resume-check: 2 steps an epoch, 8 steps, killed at step 3
GAN_EPOCHS, GAN_VAL = 3, 6  # 12 steps, validations at steps 6 and 12


def tool_start(module: str, *args, env: Optional[dict] = None):
    import os

    return subprocess.Popen([sys.executable, "-c", TOOL_RUN, f"speech_resynth_torch.scripts.{module}", *map(str, args)],
                            cwd=str(Path(__file__).resolve().parent), env=dict(os.environ, **(env or {})),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def tool_result(proc, what: str, timeout: int = 600) -> tuple:
    """(the tool's stdout lines, its launches); fails on a non-zero exit."""
    so, se = proc.communicate(timeout=timeout)
    lines = so.strip().splitlines()
    if proc.returncode or not lines or not lines[-1].startswith("launches "):
        fail(f"{what} failed ({proc.returncode}): {so[-2000:]} {se[-3000:]}")
    return lines[:-1], json.loads(lines[-1].split(" ", 1)[1])


def tools_phase(torch, np, A, C, M, root: Path, resume: dict) -> dict:
    """The JAX package's tools as the port runs them, each a process:
    ``convert_checkpoints`` of every kind from sources written from the
    port's seeded full-width models (mHuBERT as ``pytorch_model.bin`` and as
    ``model.safetensors``, its 2 000 x 768 centers as ``.npy``, a composite
    as ``pytorch_model.bin``, the UTMOS ``.ckpt`` and the Whisper large-v3
    directory of the eval phases), the outputs loaded on the card and held
    against their sources (units, audio from the same noise, state dicts);
    ``fit_kmeans`` on 16 speech-like files with the converted mHuBERT (K1),
    its codebook encoding through ``by_name`` (K4); ``gan_longrun run`` at
    full width (K2 in its validations) and ``report`` on its event files.
    ``resume`` is ``gan_longrun resume-check``'s verdict from
    ``background_checks``, run before this phase."""
    import dataclasses

    from speech_resynth_torch.core.precision import BF16_INFERENCE, FLOAT32
    from speech_resynth_torch.core.safetensors import load_file, save_file
    from speech_resynth_torch.core.tbevents import read_scalars
    from speech_resynth_torch.dsp import audio_io
    from speech_resynth_torch.models.cfm import CFMConfig
    from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan
    from speech_resynth_torch.models.convert import hubert_state_dict_from_hf
    from speech_resynth_torch.models.hifigan import HifiGanConfig
    from speech_resynth_torch.models.hubert import HubertConfig, HubertEncoder
    from speech_resynth_torch.models.kmeans import KMeansQuantizer
    from speech_resynth_torch.models.speech_encoder import SpeechEncoder
    from speech_resynth_torch.models.whisper import whisper_state_dict_from_hf
    from speech_resynth_torch.pipeline import train_loops
    from speech_resynth_torch.pipeline.data import MelDataset
    from speech_resynth_torch.pipeline.scorers import NativeUTMOS, NativeWhisperASR

    record = {"phase": "tools"}
    dense, _, vocab = ENCODER
    src, out = root / "tool_sources", root / "tool_outputs"
    src.mkdir()

    # the sources: an HF mHuBERT (positional conv weight-normed, as HF keeps it) and its centers, a composite
    t0 = time.perf_counter()
    seeded = SpeechEncoder.by_name(*ENCODER, checkpoint_dir=str(root / "no-encoders"), policy=FLOAT32, device="cpu")
    hf = dict(seeded.encoder.state_dict())
    w = hf.pop("encoder.pos_conv_embed.conv.weight")
    hf["encoder.pos_conv_embed.conv.weight_v"] = w
    hf["encoder.pos_conv_embed.conv.weight_g"] = torch.sqrt(torch.sum(w * w, dim=(0, 1), keepdim=True))
    centers = seeded.quantizer.centers.numpy()
    del seeded
    for fmt in ("bin", "safetensors"):
        (src / f"hubert_{fmt}").mkdir()
    torch.save(hf, src / "hubert_bin" / "pytorch_model.bin")
    save_file(hf, src / "hubert_safetensors" / "model.safetensors")
    np.save(src / "centers.npy", centers)
    pair = ConditionalFlowMatchingWithHifiGan.from_config(CFMConfig(vocab_size=2000), HifiGanConfig(), FLOAT32,
                                                          generator=torch.Generator().manual_seed(3), device="cpu")
    (src / "composite").mkdir()
    (src / "composite" / "config.json").write_text(json.dumps(
        {"model_config": dataclasses.asdict(pair.model.config), "vocoder_config": dataclasses.asdict(pair.vocoder.config)}))
    torch.save({**{f"model.{k}": v for k, v in pair.model.state_dict().items()},
                **{f"vocoder.{k}": v for k, v in pair.vocoder.state_dict().items()}}, src / "composite" / "pytorch_model.bin")
    del pair
    record["sources_seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    procs = {
        "hubert_bin": tool_start("convert_checkpoints", "hubert", "--src", src / "hubert_bin", "--name", dense, "--out", out / "bin"),
        "hubert": tool_start("convert_checkpoints", "hubert", "--src", src / "hubert_safetensors", "--name", dense,
                             "--out", out / "models"),
        "kmeans": tool_start("convert_checkpoints", "kmeans", "--src", src / "centers.npy", "--name", dense,
                             "--out", out / "models"),
        "composite": tool_start("convert_checkpoints", "composite", "--src", src / "composite", "--out", out / "composite"),
        "utmos": tool_start("convert_checkpoints", "utmos", "--src", root / "utmos.ckpt", "--out", out / "utmos.safetensors"),
        "whisper": tool_start("convert_checkpoints", "whisper", "--src", root / "whisper-large-v3", "--out", out / "whisper"),
    }
    for name, proc in procs.items():
        lines, launches = tool_result(proc, f"convert_checkpoints ({name})")
        if not lines or not lines[-1].startswith("wrote ") or any(launches.values()):
            fail(f"convert_checkpoints ({name}): {lines} {launches}")
    record["convert_seconds"] = time.perf_counter() - t0

    # the outputs through the port's loaders on the card, against their sources
    t0 = time.perf_counter()
    want = hubert_state_dict_from_hf(hf)
    for path in (out / "bin" / f"{dense}.safetensors", out / "models" / f"{dense}.safetensors"):
        got = load_file(path)
        if sorted(got) != sorted(hf) or not all(torch.equal(got[k], v) for k, v in hf.items()):
            fail(f"convert_checkpoints hubert: {path} differs from its source")
    tower = HubertEncoder(HubertConfig(), BF16_INFERENCE)  # the source model, built as by_name builds it
    tower.load_state_dict(want)
    source = SpeechEncoder(tower.cuda().eval().requires_grad_(False), KMeansQuantizer(torch.from_numpy(centers)).to("cuda"), 11)
    converted = SpeechEncoder.by_name(*ENCODER, checkpoint_dir=str(out / "models"), device="cuda")
    waves, lengths = padded(np, speechlike_waves(np, np.random.default_rng(72), ENC_BATCH))
    A.flash_attention.launches = C.assign_kernel.launches = M.mrf_branch_kernel.launches = M.mrf_stage_kernel.launches = 0
    K5.conv_ff_kernel.launches = 0
    units = [e(waves, lengths)["units"] for e in (source, converted)]
    decoders = [ConditionalFlowMatchingWithHifiGan.from_pretrained(d, device="cuda") for d in (src / "composite", out / "composite")]
    gen = torch.Generator(device="cuda").manual_seed(73)
    ids = torch.randint(1, 2001, (SERVE_BATCH, BUCKET), generator=gen, device="cuda")
    ids[1:, BUCKET * 7 // 8 :] = 0
    x0 = torch.randn((SERVE_BATCH, BUCKET, decoders[0].model.config.dim_in), generator=gen, device="cuda")
    audio = [d.synthesize(ids, dt=0.0625, truncation_value=1.0, x0=x0)[0] for d in decoders]
    torch.cuda.synchronize()
    convert_launches = {"flash_attention": A.flash_attention.launches, "codebook_assign": C.assign_kernel.launches,
                        "mrf_branch": M.mrf_branch_kernel.launches, "mrf_stage": M.mrf_stage_kernel.launches,
                        "conv_ff": K5.conv_ff_kernel.launches}
    held = {
        "encoder_state": all(torch.equal(v, converted.encoder.state_dict()[k]) for k, v in source.encoder.state_dict().items()),
        "centers": torch.equal(converted.quantizer.centers.cpu(), torch.from_numpy(centers)),
        "units": torch.equal(*units), "audio": torch.equal(*audio) and bool(torch.isfinite(audio[0].float()).all()),
    }
    del source, converted, decoders
    utmos = [NativeUTMOS(p).model.state_dict() for p in (root / "utmos.ckpt", out / "utmos.safetensors")]
    held["utmos_state"] = sorted(utmos[0]) == sorted(utmos[1]) and all(torch.equal(v, utmos[1][k]) for k, v in utmos[0].items())
    del utmos
    asr = NativeWhisperASR(out / "whisper")
    whisper_want = whisper_state_dict_from_hf(load_file(root / "whisper-large-v3" / "model.safetensors"))
    got = asr.model.state_dict()
    held["whisper_state"] = sorted(got) == sorted(whisper_want) and all(torch.equal(got[k].cpu(), v.to(got[k].dtype))
                                                                              for k, v in whisper_want.items())
    held["whisper_files"] = all((out / "whisper" / p.name).read_bytes() == p.read_bytes()
                                for p in (root / "whisper-large-v3").iterdir() if p.suffix != ".safetensors")
    del asr, got, whisper_want
    torch.cuda.empty_cache()
    expected = {"flash_attention": 2 * (11 + 64), "codebook_assign": 2, "mrf_branch": 2 * 9, "mrf_stage": 0, "conv_ff": 2 * FF_PER_BATCH}
    record.update(loaders_seconds=time.perf_counter() - t0, convert_held=held, convert_launches=convert_launches)
    if not all(held.values()) or convert_launches != expected:
        fail(f"convert_checkpoints outputs: {held}, launches {convert_launches} (expected {expected})")

    # fit_kmeans with the converted mHuBERT, then its codebook through by_name
    t0 = time.perf_counter()
    fit_dir = root / "fit_wavs"
    fit_waves = speechlike_waves(np, np.random.default_rng(74), FIT_FILES)
    for i, wave in enumerate(fit_waves):
        audio_io.write(fit_dir / f"f{i:02d}.wav", wave, SAMPLE_RATE)
    npz = out / "models" / f"{dense}-kmeans-fit-{vocab}.npz"
    lines, fit_launches = tool_result(tool_start(
        "fit_kmeans", "--wav-dir", fit_dir, "--dense-model", dense, "--vocab", vocab, "--iters", FIT_ITERS, "--out", npz,
        env={"SPEECH_RESYNTH_MODELS": str(out / "models")}), "fit_kmeans")
    record["fit_kmeans_seconds"] = time.perf_counter() - t0
    frames = sum(HubertConfig().num_frames(len(w)) for w in fit_waves)
    inertia = float(lines[-2].split()[-1]) if len(lines) >= 3 and lines[-2].startswith("inertia: ") else math.nan
    fitted = np.load(npz)["centers"]
    fit_batches = -(-FIT_FILES // 8)
    record["fit_kmeans"] = {"lines": lines[-3:], "frames": frames, "inertia": inertia, "centers": [list(fitted.shape), str(fitted.dtype)],
                            "launches": fit_launches}
    if (lines[-3] != f"fitting k={vocab} on {frames} frames of dim 768" or not math.isfinite(inertia)
            or fitted.shape != (vocab, 768) or fitted.dtype != np.float32 or not np.isfinite(fitted).all()
            or fit_launches != {"flash_attention": 11 * fit_batches, "codebook_assign": 0, "mrf_branch": 0, "mrf_stage": 0}):
        fail(f"fit_kmeans: {record['fit_kmeans']}")
    encoder = SpeechEncoder.by_name(dense, "kmeans-fit", vocab, checkpoint_dir=str(out / "models"), device="cuda")
    A.flash_attention.launches = C.assign_kernel.launches = 0
    fit_units = encoder(waves, lengths)["units"]
    torch.cuda.synchronize()
    fit_encode = {"flash_attention": A.flash_attention.launches, "codebook_assign": C.assign_kernel.launches}
    del encoder
    if fit_encode != {"flash_attention": 11, "codebook_assign": 1} or int(fit_units.max()) >= vocab:
        fail(f"the fitted codebook's encode: {fit_encode}")

    # gan_longrun: run, report
    work = root / "gan"
    t0 = time.perf_counter()
    _, gan_launches = tool_result(tool_start("gan_longrun", "run", work, *GAN_RUN, "--epochs", GAN_EPOCHS,
                                                 "--summary-interval", 1, "--val-interval", GAN_VAL), "gan_longrun run", 900)
    record["gan_run_seconds"] = time.perf_counter() - t0
    corpus = work / "corpus"
    dev = MelDataset(str(corpus / "wavs"), str(corpus / "spec"), train_loops._mel_file_list(str(corpus / "train.json")),
                     16080, 400, 320, False)
    dev_batches = [list(b["mel"].shape[:2]) for b in dev.padded_batches(8, max_utts=32, with_wav=False)]
    validations = GAN_EPOCHS * 4 // GAN_VAL
    if gan_launches != {"flash_attention": 0, "codebook_assign": 0, "mrf_branch": 9 * len(dev_batches) * validations, "mrf_stage": 0}:
        fail(f"gan_longrun run launched {gan_launches}; dev batches {dev_batches} x {validations} validations")
    t0 = time.perf_counter()
    tool_result(tool_start("gan_longrun", "report", work), "gan_longrun report")
    record["gan_report_seconds"] = time.perf_counter() - t0
    scalars = read_scalars(work / "run" / "logs")
    tags = ("training/loss_gen", "training/loss_disc", "training/mel_error", "training/lr", "validation/mel_spec_error")
    curves = {t: len(scalars.get(t, ())) for t in tags}
    report = (work / "report.md").read_text().splitlines()
    rate = [l for l in report if l.startswith("- steps ")]
    record["gan_longrun"] = {"launches": gan_launches, "dev_batches": dev_batches, "validations": validations, "events": curves,
                             "report_header": report[0], "report_rows": sum(l.startswith("| ") for l in report) - 1,
                             "rate_line": rate, "nonfinite_line": report[-1]}
    if (curves != {**dict.fromkeys(tags[:4], GAN_EPOCHS * 4), tags[4]: validations}
            or not all(math.isfinite(v) for t in tags for _, v, _ in scalars[t])
            or report[0] != "| step | loss_gen | loss_disc | mel_error | lr | mel_spec_error | wall steps/s |"
            or not report[-1].startswith("- non-finite scalar events: none") or not rate):
        fail(f"gan_longrun report: {record['gan_longrun']}")
    record["resume_check"] = resume
    print(json.dumps(record))
    return {"convert": convert_launches, "fit_kmeans": fit_launches, "fit_batches": fit_batches, "fit_encode": fit_encode,
            "gan_longrun": gan_launches, "dev_batches": dev_batches, "validations": validations}


KERNEL_GROUPS = (
    ("flash_attention (K1)", ("flash_fwd",)),
    ("codebook_assign (K4)", ("codebook_assign", "unpack_ids")),
    ("mrf_stage (K3)", ("mrf_stage",)),  # the f32 stage kernel (also K2's f32 variant)
    # cuDNN's conv kernels are implicit GEMMs ("fprop_implicit_gemm"), so they are matched first
    ("conv (cuDNN)", ("conv", "cudnn", "fprop", "dgrad", "implicit", "winograd", "fft")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "nvjet")),  # nvjet: cuBLASLt's Hopper GEMM kernels
)


def kernel_group(name: str) -> str:
    """The group of a kernel by its lower-cased name. K2's and K3's bf16
    kernels are the two instances of one template (csrc/mrf_block.cuh),
    mrf_block_bf16_kernel<C, STAGE>: STAGE true (mangled "Lb1E") is K3."""
    if "mrf_block" in name:
        return "mrf_stage (K3)" if "true>" in name or "lb1e" in name else "mrf_branch (K2)"
    return next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), "other (elementwise, copies)")


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
    events = prof.key_averages()
    # a record_function range (the optimizer's step, a trace_span) also shows on the device's
    # timeline under its own name, spanning kernels already counted: leave those out
    ranges = {e.key for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU}
    for e in events:
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA or e.key in ranges:
            continue
        us = float(getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0))
        group = kernel_group(e.key.lower())
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
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))  # the K1 edge-case table of test_torch_cuda
    try:
        import numpy as np
        import torch.nn.functional as F

        from speech_resynth_torch.models.hifigan import HifiGanConfig
        from speech_resynth_torch.models.hubert import HubertConfig
        from speech_resynth_torch.ops import attention as A
        from speech_resynth_torch.ops import codebook as C
        from speech_resynth_torch.ops import fused_mrf as M
        from speech_resynth_torch.ops.build import kernel_library

        global K5
        from speech_resynth_torch.ops import conv_ff as K5
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

    t0 = start = time.perf_counter()
    kernel_library()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0}))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    laps = {"at": time.perf_counter()}

    def lap(name: str) -> None:
        """The wall seconds of the phase just run, on a line of its own."""
        now = time.perf_counter()
        print(json.dumps({"phase": "lap", "after": name, "seconds": now - laps["at"]}), flush=True)
        laps["at"] = now

    voc_cfg = HifiGanConfig()
    ctx = context_frames_for(voc_cfg)
    k1 = attention_phase(torch, F, A)
    lap("attention_phase")
    k2 = mrf_phase(torch, F, M, voc_cfg, ctx)
    lap("mrf_phase")
    k3 = stage_phase(torch, M, voc_cfg, ctx)
    lap("stage_phase")
    k4 = codebook_phase(torch, C)
    lap("codebook_phase")
    print(json.dumps({"phase": "kernels_checked", "kernels": ["flash_attention", "mrf_branch", "mrf_stage", "codebook_assign"]}))
    init_phase(torch, np)
    lap("init_phase")
    serving = slice_phase(torch, np, A, M)
    lap("slice_phase")
    serving_fused = serving_fused_phase(torch, np, A, M, voc_cfg)
    lap("serving_fused_phase")
    options = serving_options_phase(torch, np, A, M)
    lap("serving_options_phase")
    enc, encoding = encoder_phase(torch, np, A, C)
    lap("encoder_phase")
    resynth = resynth_phase(torch, np, A, M, C, enc)
    lap("resynth_phase")
    del enc
    streaming = streaming_phase(torch, np, M)
    lap("streaming_phase")
    lm_scoring, k1_lm = lm_scoring_phase(torch, F, A, np)
    lap("lm_scoring_phase")
    k1.append(k1_lm)
    lm_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_lm_")  # the continuation's pieces, kept for the LM loop
    continuation = continuation_phase(torch, np, A, C, M, Path(lm_tmp.name))
    lap("continuation_phase")
    speculative = continuation_speculative_phase(torch, np, A, C, M, Path(lm_tmp.name))
    lap("continuation_speculative_phase")
    slm21 = slm21_phase(torch, np, A, C)
    lap("slm21_phase")
    preprocess = preprocess_phase(torch, np, A, C)
    lap("preprocess_phase")
    kmeans_fit_phase(torch, np, C)
    lap("kmeans_fit_phase")
    k1.extend(k1_train_phase(torch, F, A))
    lap("k1_train_phase")
    train_cfm = train_cfm_phase(torch, np, A)
    lap("train_cfm_phase")
    train_gan = train_hifigan_phase(torch, np, M)
    lap("train_hifigan_phase")
    train_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    wait_for_checks = background_checks(torch, np, Path(train_tmp.name))
    drift = gan_drift_phase(torch, M)
    lap("gan_drift_phase (beside the kill/resume checks)")
    kill, resume = wait_for_checks()
    lap("background_checks (the rest of)")
    loops = train_loops_phase(torch, np, A, M, Path(train_tmp.name), kill)
    train_tmp.cleanup()
    lap("train_loops_phase")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as cli_tmp:
        cli = cli_phase(torch, np, A, C, M, Path(cli_tmp))
    lap("cli_phase")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_loop_") as loop_tmp:
        lm_batch = lm_train_batch(torch, np, Path(loop_tmp))
        k1.append(k1_lm_train_phase(torch, F, A, lm_batch))
        lap("k1_lm_train_phase")
        train_lm = train_speechlm_phase(torch, np, A, lm_batch)
        lap("train_speechlm_phase")
        del lm_batch
        lm_loop = speechlm_loop_phase(torch, np, A, C, M, Path(loop_tmp), Path(lm_tmp.name))
    lap("speechlm_loop_phase (and distributed_phase)")
    lm_tmp.cleanup()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as eval_tmp:
        asr, whisper, whisper_shapes, k1_whisper, _ = whisper_phase(torch, np, F, A, Path(eval_tmp))
        k1.extend(k1_whisper)
        lap("whisper_phase")
        mos, utmos, utmos_shapes, k1_utmos, _ = utmos_phase(torch, np, F, A, Path(eval_tmp))
        k1.append(k1_utmos)
        lap("utmos_phase")
        evaluation = evaluate_phase(torch, np, A, M, Path(eval_tmp), asr, mos)
        del asr, mos
        lap("evaluate_phase")
        tools = tools_phase(torch, np, A, C, M, Path(eval_tmp), resume)  # converts the Whisper and UTMOS files written above
    lap("tools_phase")
    entry_run = entry_phase(torch, A, M)
    lap("entry_phase")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_e2e_") as e2e_tmp:
        e2e = e2e_quality_phase(torch, np, A, C, M, Path(e2e_tmp))
    lap("e2e_quality_phase")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gan_learning_") as learn_tmp:
        learning = gan_learning_phase(torch, np, A, C, M, Path(learn_tmp))
    lap("gan_learning_phase")
    torch.cuda.synchronize()

    # data-dependent shapes, held after their runs: the duration config's 64-multiple
    # decoder bounds (K1, K2), the streaming windows (K3), and the continuation's
    # encoder and decoder (K1, K3)
    gen = torch.Generator(device="cuda").manual_seed(9)
    for frames in sorted(set(resynth["duration_prediction"]["decoder_frames"])):
        k1.append(attention_shape(torch, F, A, gen, "resynth decoder (duration config)", ENC_BATCH, 2, frames, 128, 1, frames))
        k2.append(mrf_path(torch, F, M, gen, voc_cfg, "resynth decoder (duration config)", frames))
    timed_windows = {STREAM_CHUNK + ctx, STREAM_CHUNK + 2 * ctx}
    for frames in sorted(set(streaming[True]["windows"]) - timed_windows):
        k3.append(stage_path(torch, M, gen, voc_cfg, "streaming flush window", frames, 1))
    cont = continuation["greedy"]
    k1.append(attention_shape(torch, F, A, gen, "continuation encoder", 1, 12, cont["prompt_frames"], 64, cont["prompt_frames"], cont["prompt_frames"]))
    for runs, prefix in ((continuation, "continuation"), (speculative, "speculative continuation")):
        for label in ("greedy", "sampled"):
            run = runs[label]
            k1.append(attention_shape(torch, F, A, gen, f"{prefix} decoder ({label})", 1, 2, run["bound"], 128, run["frames"], run["frames"]))
            k3.append(stage_path(torch, M, gen, voc_cfg, f"{prefix} decoder ({label})", run["bound"], 1))
    # K1 and K4 at the sLM21 and preprocess shapes: tokenize_slm21's encoder (20-s padding), the LM's scoring
    # forward (causal, no mask), and the preprocess tokenize stage's encoder (30-s padding)
    slm21_frames = HubertConfig().num_frames(20 * SAMPLE_RATE)
    k1.append(attention_shape(torch, F, A, gen, "slm21 tokenize", SLM21_ENC_BATCH, 12, slm21_frames, 64, *slm21["frames"]))
    k4.append(codebook_shape(torch, C, gen, "slm21 tokenize", SLM21_ENC_BATCH * slm21_frames, CONT_ENCODER[2]))
    for B_, L_ in sorted(set(map(tuple, slm21["scoring_shapes"]))):
        k1.append(attention_shape(torch, F, A, gen, "slm21 scoring", B_, 12, L_, 64, L_, L_, causal=True, masked=False))
    for b in sorted(set(preprocess["batches"])):
        k1.append(attention_shape(torch, F, A, gen, "preprocess tokenize", b, 12, RESYNTH_FRAMES, 64, *preprocess["key_frames"]))
        k4.append(codebook_shape(torch, C, gen, "preprocess tokenize", b * RESYNTH_FRAMES, ENCODER[2]))
    # K2 at the HiFi-GAN validation's dev batches, K1 and K2 at the exported pair's synthesis batch
    for b, frames in sorted(set(map(tuple, loops["dev_batches"]))):
        k2.append(mrf_path(torch, F, M, gen, voc_cfg, "hifigan validation", frames, b))
    for b, frames in sorted(set(map(tuple, loops["cfm_dev_sweep"]))):  # the CFM loop's dev sweep (bf16 compute)
        k1.append(attention_shape(torch, F, A, gen, "cfm loop dev sweep decoder", b, 2, frames, 128, 100, min(140, frames)))
        k2.append(mrf_path(torch, F, M, gen, voc_cfg, "cfm loop dev sweep decoder", frames, b))
    for frames in sorted(set(evaluation["frames"])):  # evaluate's decoder batch
        k1.append(attention_shape(torch, F, A, gen, "evaluate decoder", EVAL_UTTS, 2, frames, 128, 400, min(500, frames)))
        k2.append(mrf_path(torch, F, M, gen, voc_cfg, "evaluate decoder", frames, EVAL_UTTS))
    lo = EXPORT_UNITS * 3 // 4
    k1.append(attention_shape(torch, F, A, gen, "trained pair decoder", EXPORT_BATCH, 2, EXPORT_UNITS, 128, lo, EXPORT_UNITS))
    k2.append(mrf_path(torch, F, M, gen, voc_cfg, "trained pair decoder", EXPORT_UNITS, EXPORT_BATCH))
    # K1 at the LM loop's scoring batches (causal, no mask), K1 and K2 at its generation's decoder bound
    loop_scoring = lm_loop["scoring_shapes"]
    for B_, L_ in sorted(set(map(tuple, loop_scoring["dev"] + loop_scoring["test"]))):
        k1.append(attention_shape(torch, F, A, gen, "speechlm loop scoring", B_, 12, L_, 64, L_, L_, causal=True, masked=False))
    bound, frames = lm_loop["generate_decoder"]
    k1.append(attention_shape(torch, F, A, gen, "speechlm loop generate decoder", 1, 2, bound, 128, frames, frames))
    k2.append(mrf_path(torch, F, M, gen, voc_cfg, "speechlm loop generate decoder", bound, 1))
    # the CLI's: its tokenize and synthesize encoder batches (K1, K4), its CFM steps (K1), its decoder batches
    # (the dev sweep, evaluate, synthesize: K1, K2); graft_entry's decoder; the quality run's f32 vocoder
    # calls (K2 at its widths and dilations) and its pair scoring (K1 causal)
    for b in sorted(set(cli["tokenize_batches"] + [cli["synthesize_batch"]]) - set(preprocess["batches"])):
        k1.append(attention_shape(torch, F, A, gen, "cli encoder", b, 12, RESYNTH_FRAMES, 64, *cli["key_frames"]))
        k4.append(codebook_shape(torch, C, gen, "cli encoder", b * RESYNTH_FRAMES, ENCODER[2]))
    k1.append(attention_shape(torch, F, A, gen, "cli cfm training", CLI_BATCH, 2, CFM_TRAIN["frames_per_seg"], 128, 40,
                              CFM_TRAIN["frames_per_seg"]))
    B_ = cli["synthesize_batch"]
    for frames in sorted(set(cli["dev_frames"] + cli["test_frames"] + [RESYNTH_FRAMES])):
        k1.append(attention_shape(torch, F, A, gen, "cli decoder", B_, 2, frames, 128, frames // 2, frames))
        k2.append(mrf_path(torch, F, M, gen, voc_cfg, "cli decoder", frames, B_))
    k1.append(attention_shape(torch, F, A, gen, "entry decoder", *entry_run["ids"][:1], 2, entry_run["ids"][1], 128,
                              entry_run["ids"][1], entry_run["ids"][1]))
    k2.append(mrf_path(torch, F, M, gen, voc_cfg, "entry decoder", entry_run["ids"][1], entry_run["ids"][0]))
    if e2e["branches"]:
        k2.append(mrf_path(torch, F, M, gen, e2e["vocoder"], "e2e quality vocoder (f32 on the path)", 48, 1, e2e["branches"]))
    k2.append(mrf_path(torch, F, M, gen, learning["vocoder"], "gan learning vocoder (f32 on the path)", 48, 1, learning["branches"]))
    for B_, L_ in sorted(set(map(tuple, e2e["scoring_shapes"]))):
        k1.append(attention_shape(torch, F, A, gen, "e2e quality pair scoring", B_, 2, L_, e2e["head_dim"], L_, L_, causal=True,
                                  masked=False))
    # the quality run's pair scoring at scale chip (its own call: python -m speech_resynth_torch.pipeline.e2e_quality <dir> chip)
    k1.append(attention_shape(torch, F, A, gen, "e2e quality pair scoring (scale chip)", 16, 2, 32, 64, 32, 32, causal=True,
                              masked=False))
    # the tools: fit_kmeans's encoder (the padded batch, no mask), gan_longrun's validation batches (K2); the
    # conversion's encoder and decoder batches are the encoder's and serving's shapes, held above
    k1.append(attention_shape(torch, F, A, gen, "fit_kmeans encoder (no mask)", 8, 12, 999, 64, 999, 999, masked=False))
    for b, frames in sorted(set(map(tuple, tools["dev_batches"]))):
        k2.append(mrf_path(torch, F, M, gen, voc_cfg, "gan_longrun validation", frames, b))

    # the shape of every launch counted above, from each path's structure and frames
    by_path = {
        "serving": serving, "serving_fused": serving_fused, "serving_mulaw": options["mulaw"],
        "synthesize_midpoint": options["midpoint"], "encoder": encoding,
        **{f"resynth_{k}": v["launches"] for k, v in resynth.items()},
        "streaming": streaming[False]["launches"], "streaming_fused": streaming[True]["launches"],
        "lm_scoring": lm_scoring,
        **{f"continuation_{k}": continuation[k]["launches"] for k in ("greedy", "sampled")},
        **{f"continuation_speculative_{k}": speculative[k]["launches"] for k in ("greedy", "sampled")},
        "slm21_tokenize": slm21["tokenize"], "slm21_scoring": slm21["scoring"], "preprocess_tokenize": preprocess["launches"],
        "train_cfm": train_cfm["launches"], "train_hifigan": train_gan["launches"], "gan_drift": drift["launches"],
        "train_loops_cfm": loops["cfm"],
        "train_loops_hifigan": loops["hifigan"], "train_loops_export": loops["export"],
        "train_speechlm": train_lm["launches"], "speechlm_loop_validation": lm_loop["validation"],
        "speechlm_loop_eval": lm_loop["eval"],
        **{f"speechlm_loop_generate_{k}": v for k, v in lm_loop["generate"].items()},
        "whisper": whisper, "utmos": utmos, **{f"evaluate_{k}": v["launches"] for k, v in evaluation["runs"].items()},
        "cli_resynth": cli["launches"], "cli_speechlm_eval": lm_loop["cli_eval"], "cli_speechlm_generate": lm_loop["cli_generate"],
        "entry": entry_run["launches"], "e2e_quality": e2e["launches"], "gan_learning": learning["launches"],
        "tools_convert": tools["convert"], "tools_fit_kmeans": tools["fit_kmeans"], "tools_fit_encode": tools["fit_encode"],
        "tools_gan_longrun": tools["gan_longrun"],
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

    def decoder_batch(path, frames, batch=SERVE_BATCH, fused=False, bf16=True):
        add("flash_attention", path, [batch, 2, frames, 128], 64)
        if bf16:  # f32 takes the feed-forward's plain chain
            add("conv_ff", path, [batch, frames], FF_PER_BATCH)
        vocoder_call(path, frames, batch, fused)

    def encoder_batch(path, frames, batch=ENC_BATCH, layers=11, centers=2000):
        add("flash_attention", path, [batch, 12, frames, 64], layers)
        add("codebook_assign", path, [batch * frames, 768, centers], 1)

    for _ in range(serving["mrf_branch"] // 9):
        decoder_batch("serving", BUCKET)
    for _ in range(serving_fused["mrf_stage"] // 3):
        decoder_batch("serving_fused", BUCKET, fused=True)
    decoder_batch("serving_mulaw", BUCKET, bf16=False)
    add("flash_attention", "synthesize_midpoint", [SERVE_BATCH, 2, BUCKET, 128], 2 * 64)  # two velocity evaluations a step
    vocoder_call("synthesize_midpoint", BUCKET, SERVE_BATCH, False)
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
    for runs, prefix in ((continuation, "continuation"), (speculative, "continuation_speculative")):
        for label in ("greedy", "sampled"):
            run = runs[label]
            encoder_batch(f"{prefix}_{label}", run["prompt_frames"], batch=1, layers=6, centers=CONT_ENCODER[2])
            decoder_batch(f"{prefix}_{label}", run["bound"], batch=1, fused=True)
    for _ in range(slm21["encoder_batches"]):
        encoder_batch("slm21_tokenize", slm21_frames, batch=SLM21_ENC_BATCH, layers=6, centers=CONT_ENCODER[2])
    for B_, L_ in slm21["scoring_shapes"]:
        add("flash_attention", "slm21_scoring", [B_, 12, L_, 64], 12)
    for b in preprocess["batches"]:
        encoder_batch("preprocess_tokenize", RESYNTH_FRAMES, batch=b)
    train_shape = [CFM_TRAIN["batch_size"], 2, CFM_TRAIN["frames_per_seg"], 128]
    add("flash_attention", "train_cfm", train_shape, train_cfm["launches"]["flash_attention"])  # 4 a step, 8 with remat
    add("flash_attention", "train_loops_cfm", train_shape, 6 * 4)  # 6 steps
    for b, frames in loops["cfm_dev_sweep"]:  # its dev sweep
        decoder_batch("train_loops_cfm", frames, batch=b)
    for _ in range(loops["validations"]):
        for b, frames in loops["dev_batches"]:
            vocoder_call("train_loops_hifigan", frames, b, False)
    decoder_batch("train_loops_export", EXPORT_UNITS, batch=EXPORT_BATCH)
    add("flash_attention", "train_speechlm", [LM_TRAIN_BATCH, 12, LM_TRAIN_TOKENS, 64], train_lm["launches"]["flash_attention"])
    for _ in range(LM_LOOP_EPOCHS):
        for B_, L_ in loop_scoring["dev"]:
            add("flash_attention", "speechlm_loop_validation", [B_, 12, L_, 64], 12)
    for B_, L_ in loop_scoring["test"]:
        add("flash_attention", "speechlm_loop_eval", [B_, 12, L_, 64], 12)
    for label in lm_loop["generate"]:
        encoder_batch(f"speechlm_loop_generate_{label}", ENC_FRAMES, batch=1, layers=6, centers=CONT_ENCODER[2])
    decoder_batch("speechlm_loop_generate_speech", bound, batch=1)
    for shape, n in whisper_shapes:
        add("flash_attention", "whisper", shape, n)
    for shape, n in utmos_shapes:
        add("flash_attention", "utmos", shape, n)
    for label, run in evaluation["runs"].items():
        for frames in evaluation["frames"]:
            decoder_batch(f"evaluate_{label}", frames, batch=EVAL_UTTS)
        for shape, n in run["whisper_shapes"] + run["utmos_shapes"]:
            add("flash_attention", f"evaluate_{label}", shape, n)
    for b in cli["tokenize_batches"] + [cli["synthesize_batch"]]:
        encoder_batch("cli_resynth", RESYNTH_FRAMES, batch=b)
    add("flash_attention", "cli_resynth", [CLI_BATCH, 2, CFM_TRAIN["frames_per_seg"], 128], 2 * 4)  # 2 CFM steps
    for frames, b in [(f, CLI_DEV) for f in cli["dev_frames"]] + [(f, cli["synthesize_batch"]) for f in cli["test_frames"] + [RESYNTH_FRAMES]]:
        decoder_batch("cli_resynth", frames, batch=b)
    for B_, L_ in loop_scoring["test"]:
        add("flash_attention", "cli_speechlm_eval", [B_, 12, L_, 64], 12)
    encoder_batch("cli_speechlm_generate", ENC_FRAMES, batch=1, layers=6, centers=CONT_ENCODER[2])
    decoder_batch("cli_speechlm_generate", bound, batch=1)
    decoder_batch("entry", entry_run["ids"][1], batch=entry_run["ids"][0])
    for _ in range(3 * e2e["n_eval"]):
        for C_, T_, K_ in e2e["branches"]:
            add("mrf_branch", "e2e_quality", [1, C_, T_, K_], 1)
    for _ in range(2 * learning["n_eval"]):
        for C_, T_, K_ in learning["branches"]:
            add("mrf_branch", "gan_learning", [1, C_, T_, K_], 1)
    for B_, L_ in e2e["scoring_shapes"]:
        add("flash_attention", "e2e_quality", [B_, 2, L_, e2e["head_dim"]], e2e["k1_per_forward"])
    for _ in range(2):  # the source's and the converted encoder and decoder
        encoder_batch("tools_convert", ENC_FRAMES)
        decoder_batch("tools_convert", BUCKET)
    add("flash_attention", "tools_fit_kmeans", [8, 12, 999, 64], 11 * tools["fit_batches"])
    encoder_batch("tools_fit_encode", ENC_FRAMES)
    for _ in range(tools["validations"]):
        for b, frames in tools["dev_batches"]:
            vocoder_call("tools_gan_longrun", frames, b, False)
    for kernel, per_path in shapes.items():
        for path, counts in per_path.items():
            if sum(counts.values()) != by_path[path][kernel]:
                fail(f"{kernel} on {path}: {by_path[path][kernel]} launches counted, {sum(counts.values())} by shape")
    for path, run in by_path.items():
        for kernel, n in run.items():
            if n and path not in shapes.get(kernel, {}):
                fail(f"{kernel} on {path}: {n} launches counted, none by shape")

    # K5 at every (B, N) a path launched it at (the first path that did names it), timed at the
    # served batch's and the plain resynthesis batch's
    ff_at = {}
    for path, counts in shapes["conv_ff"].items():
        for shape in counts:
            ff_at.setdefault(shape, path)
    ff, timed_ff = ff_module(torch), {(SERVE_BATCH, BUCKET), (ENC_BATCH, RESYNTH_FRAMES)}
    k5 = [conv_ff_shape(torch, ff, gen, path, *shape, timed_run=shape in timed_ff) for shape, path in sorted(ff_at.items())]
    del ff

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
            **({"graph_ms": total("graph_ms")} if all("graph_ms" in r for r, _ in batch) else {}),
            **({"library_graph_ms": total("library_graph_ms")} if all(r.get("library_graph_ms") is not None for r, _ in batch) else {}),
            **({"route_graph_ms": total("route_graph_ms")} if all("route_graph_ms" in r for r, _ in batch) else {}),
            "bound_by": "bytes" if total("bytes_ms") >= total("ops_ms") else "operations",
            "library_ms": None if any(r["library_ms"] is None for r, _ in batch) else total("library_ms"),
            "timed": [{k: v for k, v in r.items() if k not in ("shapes", "tol")} for r in records],
        }

    def record(records, path):
        return next(r for r in records if r["path"] == path)

    resynth_ff = next(r for r in k5 if r["shape"][:2] == [ENC_BATCH, RESYNTH_FRAMES])

    plain_decoder, resynth_encoder = "resynth decoder (plain config)", "resynth encoder"
    resynth_batch = f"one batch of {ENC_BATCH} files through the plain resynthesis config"
    kernels = [
        entry("flash_attention", "speech_resynth_torch/ops/csrc/flash_attention.cu", "speech_resynth_tpu/ops/attention.py:81",
              k1, resynth_batch, [(record(k1, plain_decoder), 64), (record(k1, resynth_encoder), 11)]),
        entry("mrf_branch", "speech_resynth_torch/ops/csrc/mrf_branch.cu", "speech_resynth_tpu/ops/fused_mrf.py:378",
              k2, resynth_batch + " (nine launches)", [(record(k2, plain_decoder), 1)]),
        entry("mrf_stage", "speech_resynth_torch/ops/csrc/fused_mrf.cu", "speech_resynth_tpu/ops/fused_mrf.py:452",
              k3, f"one vocoder call on a served batch of {SERVE_BATCH} (three launches; no PyTorch call computes a "
              "stage; route_graph_ms is the per-branch route: three K2 launches, their sum and mean)", [(record(k3, "serving"), 1)]),
        entry("codebook_assign", "speech_resynth_torch/ops/csrc/codebook.cu", "speech_resynth_tpu/ops/codebook.py:29",
              k4, resynth_batch, [(record(k4, resynth_encoder), 1)]),
        entry("conv_ff", "speech_resynth_torch/ops/csrc/conv_ff.cu", "none: XLA's convs (speech_resynth_tpu/models/transformer.py:223)",
              k5, resynth_batch + f" ({FF_PER_BATCH} launches, two a feed-forward call; plain_ms is the plain chain)",
              [(resynth_ff, FF_PER_BATCH // 2)]),
    ]
    lap("the held shapes and the kernels line")
    print(json.dumps({"phase": "wall", "seconds": time.perf_counter() - start, "note": "the whole script after the build started"}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
