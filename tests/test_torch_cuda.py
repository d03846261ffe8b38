"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode. The file imports neither JAX nor the JAX package, so
it runs on a machine that has only PyTorch with CUDA:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: tests/conftest.py sets up JAX for the other test files.)

Tolerances: in f32 (TF32 off for matmuls and cuDNN convs) the kernel and the
plain version differ only in summation order, 1e-4 for attention's O(1)
outputs and 1e-3 for the six-conv MRF chain; in bf16 the two round the
probabilities or the conv operands at different points, a few bf16 ulps of
the O(1) outputs (1e-2 for attention, 6e-2 for the MRF chain). The k-means
assignment compares ids: they must agree on every frame whose two best
scores differ by more than 1e-3 * (|best| + 1), where the two summation
orders cannot flip the winner, and where a near-tie flips, the score the
kernel's id gives up stays within SCORE_TOL * (|best| + 1): 3xTF32 keeps f32
accuracy, where plain TF32 (10 mantissa bits) can give up more.
"""

import contextlib
import copy
import itertools
import math
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speech_resynth_torch.ops import attention as TA
from speech_resynth_torch.ops import codebook as TC
from speech_resynth_torch.ops import fused_mrf as TM


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


ATT_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
MRF_TOL = {torch.float32: 1e-3, torch.bfloat16: 6e-2}
SCORE_TOL = 1e-5
# gan_steps_card_vs_cpu's limits on relative differences, synced trainer against
# the reference, each limit between what sound runs read (an H100 against its
# host's CPU, 16 steps, twice; the CPU on 4 threads once more) and what faults
# planted in the second side read (``planted_gan_fault``, CPU against CPU at the
# module widths, step 2):
# - the three losses, every step: sound at most 2.0e-6; a dropped feature loss
#   0.114, a flipped adversarial sign 0.080, the mel weight x3 1.69, a dropped
#   real term of the discriminators' loss 1.00.
# - step 1, per tensor, both sides from the draw: gradients 6.3e-4, updates 1.7e-2
#   (Adam multiplies a gradient's last bits by up to lr / eps where |g| < eps),
#   held to 16x and 12x that.
# - every step, per module (gen, mpd, msd), its tensors as one vector (one tensor
#   alone is no measure after step 1: a resblock bias whose leaky ReLUs sit at
#   their kink reads up to 0.8 from one device's rounding): gradients, sound at
#   most 9.4e-5 (2.5e-4 with the CPU on 4 threads), faults 1.4e-2 (feature loss
#   dropped), 2.3e-2 (adversarial sign), 1.95 (mel x3), 1.00 (real term dropped);
#   the updates against the CPU optimizer's replay of the same state and gradients
#   (``update_replayed``), sound at most 1.3e-6, both updates x3 2.0. The updates
#   against the reference's (``update``) are recorded, not held after step 1: from
#   the same state they read up to 0.47 (gen) and 0.099 (mpd, msd) in sound runs,
#   Adam's amplification of the gradients' last bits, and 2.5e-3-0.57 under the
#   faults above, so no limit tells the two apart.
GAN_LOSS_TOL = 1e-4
GAN_STEP1_TOL = {"grad": 1e-2, "update": 0.2}
GAN_MODULE_TOL = {"grad": 2e-3, "update_replayed": 1e-4}
# The free trajectories' final weight changes, card against CPU, each moving with
# its rounding over 16 steps: 1.2e-5 to 16.7% in sound runs (the CPU reference
# itself ends at 1.775e-2 on one host's CPU, 2.129e-2 on another's), 6.4x (bf16)
# and 16x (f32) for the two draws of one seed that torch versions once gave.
GAN_WEIGHT_TOL = 0.3
# The same limits under the loop's policy, DEFAULT (f32 parameters, bf16 convs),
# set the same way: sound runs on an H100 against its host's CPU (16 steps,
# twice), faults planted under DEFAULT CPU against CPU at step 2. Sound: losses
# loss_disc 1.5e-2, loss_gen 2.7e-4, mel_error 4.3e-6; module gradients gen
# 1.1e-2, mpd 1.6e-2, msd 3.9e-2; replayed updates 1.5e-6; at step 1 per tensor
# gradients 3.7e-2, updates 0.35. Faults: the loss faults above read 1.00
# (loss_disc), 0.080-1.69 (loss_gen), gradients up to 1.95; updates x3 2.0.
# Each weight change is held as the card's over the CPU's, within (low, high):
# under f32 within GAN_WEIGHT_TOL of 1; under DEFAULT the card's free trajectory
# moves less, 0.548-0.554 of the CPU's after 16 steps and 0.666 after 8; the
# free trainer's updates x0.2 from step 2 read 0.109 after 8 steps (CPU against
# CPU), and one that never left its draw reads 0.
GAN_BF16_TOL = {"loss": {"loss_disc": 0.1, "loss_gen": 5e-3, "mel_error": 1e-4}, "step1": {"grad": 0.3, "update": 1.0},
                "module": {"grad": 0.2, "update_replayed": 1e-4}, "weight": (0.4, 2.5)}
GAN_TOL = {"float32": {"loss": dict.fromkeys(("loss_disc", "loss_gen", "mel_error"), GAN_LOSS_TOL), "step1": GAN_STEP1_TOL,
                       "module": GAN_MODULE_TOL, "weight": (1 - GAN_WEIGHT_TOL, 1 + GAN_WEIGHT_TOL)},
           "default": GAN_BF16_TOL}


def gan_weight_change_within(policy: str, cpu: float, card: float) -> bool:
    """The card's free trajectory's final weight change within the policy's
    GAN_TOL "weight" of the CPU's, as a ratio (low, high)."""
    low, high = GAN_TOL[policy]["weight"]
    return low * cpu <= card <= high * cpu


# The CPU reference's intra-op threads: its reductions, and so its trajectory,
# follow the thread count (16 steps end 1.4% apart between 1 and 8 threads on one
# CPU), so the count is pinned; the CPU's model still moves it (above).
GAN_REFERENCE_THREADS = 8
# The one-step checks' relative differences of each tensor (``_compare_steps``).
# Measured on an H100 against its host's CPU (f32, TF32 off): gradients at most
# 9.7e-6 (GAN), 1.4e-6 (LM), 7.2e-7 (CFM); updates 7.6e-4 (LM), 3.3e-4 (GAN),
# 1.3e-4 (CFM): Adam's first update is lr * g / (|g| + eps), so where |g| is
# near eps a gradient's last bits move its update by up to lr / eps times them.
STEP_TOL = {"grad_rel": 1e-4, "update_rel": 5e-3}


def _score_given_up(x, centers, got, want):
    """Per frame, the score of ``got``'s id below that of ``want``'s, relative to |best| + 1."""
    score = x.float() @ centers.T - TC.half_sq_norms(centers)
    best = score.gather(1, want.long()[:, None])[:, 0]
    return (best - score.gather(1, got.long()[:, None])[:, 0]).abs() / (best.abs() + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Nq,Nk,D,causal", [(200, 200, 128, False), (70, 150, 64, True)])
def test_flash_kernel_matches_plain_on_card(card, dtype, Nq, Nk, D, causal):
    """Key padding, a fully masked row (the mean of V) and a causal offset."""
    rng = np.random.default_rng(Nq)
    q = torch.from_numpy(rng.standard_normal((2, 2, Nq, D)).astype(np.float32)).to("cuda", dtype)
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, Nk, D)).astype(np.float32)).to("cuda", dtype) for _ in range(2))
    mask = torch.arange(Nk, device="cuda")[None, :] < torch.tensor([[Nk], [Nk // 2 + 3]], device="cuda")
    if not causal:
        mask[1] = False
    before = TA.flash_attention.launches
    got = TA.flash_attention(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert TA.flash_attention.launches == before + 1 and got.dtype == dtype
    want = TA.attention_reference(q, k, v, mask, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATT_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "C,K,T,B",
    [(32, 7, 1500, 2), (16, 3, 2049, 2), (64, 11, 50, 2), (64, 11, 1004, 2), (64, 7, 1001, 2), (64, 11, 264, 1),
     (64, 11, 265, 1), (64, 11, 7540, 1), (16, 11, 30, 2)],
)
def test_mrf_kernel_matches_plain_on_card(card, dtype, C, K, T, B):
    """T not a multiple of the tile, T below one tile, T % 8 = 4 (every C = 64
    production row: 8-byte pieces, never 16), T odd (element by element), one
    tile and one tile + 1 of the widest window, and a B = 1 streaming row
    whose plan narrows the tile: zero padding at every conv."""
    rng = np.random.default_rng(C + K + T)

    def rand(*shape, scale):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to("cuda", dtype)

    x = rand(B, C, T, scale=0.5)
    w1, w2 = rand(3, C, C, K, scale=1 / np.sqrt(C * K)), rand(3, C, C, K, scale=1 / np.sqrt(C * K))
    b1, b2 = rand(3, C, scale=0.01), rand(3, C, scale=0.01)
    before = TM.mrf_branch_kernel.launches
    got = TM.mrf_branch(x, w1, b1, w2, b2, (1, 3, 5))
    torch.cuda.synchronize()
    assert TM.mrf_branch_kernel.launches == before + 1 and got.dtype == dtype
    want = TM.mrf_branch_reference(x, w1, b1, w2, b2, (1, 3, 5))
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=MRF_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,C,T,K,tile_on_132_sms",
    [
        (16, 64, 119940, 11, 264),  # a resynthesis batch: the widest tile
        (16, 16, 479760, 3, 1512),
        (1, 64, 7540, 11, 80),  # a streaming window at B = 1: narrow tiles, one wave
        (1, 16, 300, 3, 168),  # T below one tile: the smallest window of the fewest steps
    ],
)
def test_mrf_plan_of_the_c_entry_on_card(card, B, C, T, K, tile_on_132_sms):
    """The tile K2's C entry plans: within the widest block, the window the
    tile and its halo, the shared bytes those of the widest block; on a
    132-SM H100 the tile that finishes in the fewest steps."""
    t_tile, window, shared, sms = TM.kernel_branch_plan(B, C, T, K, (1, 3, 5), 2)
    t_max, widest, widest_shared = TM.mrf_tile(C, K, (1, 3, 5), 2)
    assert sms == torch.cuda.get_device_properties(0).multi_processor_count
    assert 32 <= t_tile <= t_max and window == t_tile + 2 * TM.branch_halo(K, (1, 3, 5)) and TM.M_TILE <= window <= widest
    assert shared == widest_shared
    if sms == 132:
        assert t_tile == tile_on_132_sms


@pytest.mark.cuda
def test_tiny_composite_synthesizes_on_card(card):
    """bench.py --tiny's decoder (CFM head dim 8, vocoder stages C = 8 and 4),
    which no kernel takes: the dispatchers' gates send it to the plain path,
    no kernel launches, and the waveforms have the lengths of waveform_lengths."""
    from speech_resynth_torch.core.precision import BF16_INFERENCE
    from speech_resynth_torch.models.cfm import CFMConfig
    from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan
    from speech_resynth_torch.models.hifigan import HifiGanConfig
    from speech_resynth_torch.pipeline.serving import SynthesisServer

    cfm = CFMConfig(vocab_size=2000, dim_in=8, dim_cond_emb=12, hidden_size=16, depth=2, heads=2, intermediate_size=24,
                    conv_pos_embed_kernel_size=7, conv_pos_embed_groups=16)
    voc = HifiGanConfig(model_in_dim=8, upsample_initial_channel=16, upsample_rates=(5, 4), upsample_kernel_sizes=(10, 8),
                        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
    decoder = ConditionalFlowMatchingWithHifiGan.from_config(cfm, voc, BF16_INFERENCE, device="cuda")
    seqs = [np.random.default_rng(0).integers(1, 2001, n) for n in (50, 37, 64)]
    k1, k2 = TA.flash_attention.launches, TM.mrf_branch_kernel.launches
    wavs = SynthesisServer(decoder, batch_size=2, dt=0.25, length_multiple=8).synthesize_many(seqs)
    torch.cuda.synchronize()
    assert [w.shape for w in wavs] == [(voc.waveform_lengths(len(s)),) for s in seqs]
    assert all(np.isfinite(w.astype(np.float32)).all() for w in wavs)
    assert (TA.flash_attention.launches, TM.mrf_branch_kernel.launches) == (k1, k2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D,K", [(7984, 768, 2000), (333, 32, 100), (129, 768, 130)])
def test_codebook_kernel_matches_plain_on_card(card, dtype, N, D, K):
    """N and K off the 128-tiles; K = 100 (the small vocab); D = 32;
    duplicated centers, where the lower id must win."""
    rng = np.random.default_rng(N + K)
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)).to("cuda", dtype)
    c = rng.standard_normal((K, D)).astype(np.float32)
    c[K - 1] = c[3]
    c[7] = c[3]
    centers = torch.from_numpy(c).cuda()
    before = TC.assign_kernel.launches
    got = TC.assign(x, centers)
    torch.cuda.synchronize()
    assert TC.assign_kernel.launches == before + 1 and got.dtype == torch.int32 and got.shape == (N,)
    want = TC.assign_reference(x, centers)
    score = x.float() @ centers.T - TC.half_sq_norms(centers)
    top2 = score.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3 * (top2[:, 0].abs() + 1)
    assert torch.equal(got[clear], want[clear])
    assert float((got == want).float().mean()) >= 0.999
    assert float(_score_given_up(x, centers, got, want).max()) <= SCORE_TOL
    assert not ((got == 7) | (got == K - 1)).any()
    near = x[:5].float().clone()
    near[:] = centers[3] + 1e-3 * near  # these frames lie on the duplicated centers: id 3 wins the exact tie
    assert TC.assign(near.to(dtype).contiguous(), centers).tolist() == [3] * 5


@pytest.mark.cuda
def test_codebook_kernel_non_finite_frames_on_card(card):
    """NaN scores win as in torch.argmax (the first id), a frame whose every
    score is -inf gets id 0, and +inf at two centers picks the lower id."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((300, 32)).astype(np.float32)).cuda()
    c = rng.standard_normal((130, 32)).astype(np.float32)
    c[:, :2] = -np.abs(c[:, :2]) - 0.1
    c[40, 0] = c[77, 0] = 1.0
    centers = torch.from_numpy(c).cuda()
    x[0] = float("nan")
    x[1, 3] = float("nan")
    x[2] = 0.0
    x[2, 1] = float("inf")
    x[3, 0] = float("inf")
    got = TC.assign_kernel(x, centers, TC.codebook_operands(centers))
    want = TC.assign_reference(x, centers)
    assert got[:4].tolist() == [0, 0, 0, 40]
    assert torch.equal(got, want)


def _stage_branches(rng, C, dtype):
    def rand(*shape, scale):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to("cuda", dtype)

    branches = []
    for K in (3, 7, 11):
        w1, w2 = rand(3, C, C, K, scale=1 / np.sqrt(C * K)), rand(3, C, C, K, scale=1 / np.sqrt(C * K))
        branches.append((w1, rand(3, C, scale=0.01), w2, rand(3, C, scale=0.01), (1, 3, 5)))
    return branches


STAGE_SHAPES = ((3, 7, 11), ((1, 3, 5),) * 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,C,T",
    [(2, 64, 50), (2, 64, 1000), (2, 32, 1000), (2, 16, 137), (2, 16, 2049), (1, 64, 7540), (1, 16, 1513),
     (16, 64, 40980), (16, 32, 81960), (16, 16, 163920)],
)
def test_stage_kernel_matches_plain_on_card(card, dtype, B, C, T):
    """K3: T below one tile and not a multiple of it, at each stage width; a
    B = 1 streaming window (its plan narrows the tile), a B = 1 row with T odd
    (element by element), and the three launches of a served batch."""
    rng = np.random.default_rng(C + T)
    x = torch.from_numpy(rng.standard_normal((B, C, T)).astype(np.float32) * 0.5).to("cuda", dtype)
    branches = _stage_branches(rng, C, dtype)
    before = TM.mrf_stage_kernel.launches
    got = TM.mrf_stage(x, branches)
    torch.cuda.synchronize()
    assert TM.mrf_stage_kernel.launches == before + 1 and got.dtype == dtype
    want = TM.mrf_stage_reference(x, branches)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=MRF_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,T", [(1, 32, 15080), (16, 64, 40980)])
def test_stage_kernel_on_laid_out_weights_and_one_scratch_on_card(card, B, C, T):
    """K3 on weights laid out once (``stage_operands``, as the generator keeps
    them) equals K3 on the raw branches, bit for bit; every bf16 launch uses
    the card's one scratch, a sum slot for each SM."""
    rng = np.random.default_rng(C + T + 1)
    x = torch.from_numpy(rng.standard_normal((B, C, T)).astype(np.float32) * 0.5).to("cuda", torch.bfloat16)
    branches = _stage_branches(rng, C, torch.bfloat16)
    laid_out = TM.stage_operands(branches)
    got = TM.mrf_stage_kernel(x, laid_out)
    assert torch.equal(got, TM.mrf_stage_kernel(x, branches))
    torch.testing.assert_close(got.float(), TM.mrf_stage_reference(x, branches).float(), rtol=0, atol=MRF_TOL[torch.bfloat16])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    scratch = TM._stage_scratch(x.device)
    assert scratch.numel() == sms * 128 * TM.M_TILE * TM.BRANCH_WARPGROUPS and scratch is TM._stage_scratch(x.device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,T", [(16, 64, 40980), (16, 16, 479760), (1, 64, 7540), (1, 16, 300)])
def test_stage_plan_of_the_c_entry_on_card(card, B, C, T):
    """The tile K3's C entry plans (bf16): within its widest block, the window
    the tile and the largest halo, the shared bytes those of the widest block."""
    shapes = list(zip(*STAGE_SHAPES))
    t_tile, window, shared, sms = TM.kernel_stage_plan(B, C, T, shapes, 2)
    t_max, widest, widest_shared = TM.mrf_stage_tile(C, shapes, 2)
    assert sms == torch.cuda.get_device_properties(0).multi_processor_count
    assert 32 <= t_tile <= t_max and window == t_tile + 2 * 60 and TM.M_TILE <= window <= widest
    assert shared == widest_shared


def _vocoder(policy):
    from speech_resynth_torch.models.composite import init_random_weights
    from speech_resynth_torch.models.hifigan import HifiGanConfig, HifiGanGenerator

    gen = HifiGanGenerator(HifiGanConfig(), policy)
    init_random_weights(gen, torch.Generator().manual_seed(0))
    return gen.to("cuda").eval()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_fused_generator_matches_per_branch_on_card(card, dtype):
    """The production vocoder with stage fusion on: 3 K3 launches and no K2,
    and the waveform of the per-branch route (9 K2 launches). In bf16 the
    stage rounds the branch mean once where the route rounds each branch, a
    few bf16 ulps through the later stages. The random vocoder's samples are
    ~1e-5 (the JAX package's N(0, 0.01) conv weights), so the tolerance is
    relative to the per-branch waveform's peak: 1e-4 (f32), 2e-2 (bf16)."""
    from speech_resynth_torch.core.precision import BF16_INFERENCE, FLOAT32

    gen = _vocoder(FLOAT32 if dtype == torch.float32 else BF16_INFERENCE)
    mel = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 60, 80)).astype(np.float32)).cuda()
    with torch.no_grad():
        k2, k3 = TM.mrf_branch_kernel.launches, TM.mrf_stage_kernel.launches
        off = gen(mel)
        assert (TM.mrf_branch_kernel.launches - k2, TM.mrf_stage_kernel.launches - k3) == (9, 0)
        with TM.mrf_stage_fusion(True):
            on = gen(mel)
        torch.cuda.synchronize()
        assert (TM.mrf_branch_kernel.launches - k2, TM.mrf_stage_kernel.launches - k3) == (9, 3)
    peak = float(off.abs().max())
    assert peak > 0
    torch.testing.assert_close(on, off, rtol=0, atol=(1e-4 if dtype == torch.float32 else 2e-2) * peak)


@pytest.mark.cuda
def test_short_stream_matches_batch_on_card(card):
    """The production vocoder in f32 (TF32 off), streamed in irregular pushes
    with stage fusion on: the batch run, up to summation order (1e-4 of its
    peak)."""
    from speech_resynth_torch.core.precision import FLOAT32
    from speech_resynth_torch.pipeline.streaming import StreamingVocoder

    gen = _vocoder(FLOAT32)
    mel = np.random.default_rng(4).standard_normal((130, 80)).astype(np.float32)
    with torch.no_grad():
        want = gen(torch.from_numpy(mel[None]).cuda())[0].cpu().numpy()
    with TM.mrf_stage_fusion(True):
        sv = StreamingVocoder(gen, chunk_frames=20)
        parts, i = [], 0
        for step in (7, 33, 1, 50, 39):
            parts.append(sv.push(mel[i : i + step]))
            i += step
        parts.append(sv.flush())
    got = np.concatenate(parts)
    assert got.shape == want.shape and sv.device_calls >= 3 and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.cuda
def test_codebook_kernel_at_the_continuation_codebook_on_card(card):
    """K4 with the speech LM's encoder codebook, 100 centers of 768: the
    narrow 64-frame x 32-center block tile, whose last center tile holds 4."""
    rng = np.random.default_rng(100)
    x = torch.from_numpy(rng.standard_normal((499, 768)).astype(np.float32)).cuda()
    centers = torch.from_numpy(rng.standard_normal((100, 768)).astype(np.float32)).cuda()
    got = TC.assign(x, centers)
    want = TC.assign_reference(x, centers)
    score = x @ centers.T - TC.half_sq_norms(centers)
    top2 = score.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3 * (top2[:, 0].abs() + 1)
    assert torch.equal(got[clear], want[clear]) and int(got.max()) < 100


@pytest.mark.cuda
def test_llama_full_forward_matches_cpu_on_card(card):
    """The LM's scoring forward (K1 causal, d = 64, ragged key mask) in f32
    on the card against the plain path on the CPU."""
    from speech_resynth_torch.core.precision import FLOAT32
    from speech_resynth_torch.models.composite import init_random_weights
    from speech_resynth_torch.models.llama import LlamaConfig, LlamaLM

    cfg = LlamaConfig(vocab_size=300, hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2)
    lm = LlamaLM(cfg, FLOAT32)
    init_random_weights(lm, torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.default_rng(5).integers(2, 300, (2, 70)))
    mask = torch.arange(70)[None, :] < torch.tensor([[70], [41]])
    with torch.no_grad():
        on_cpu, _ = lm.eval()(ids, attention_mask=mask)
        before = TA.flash_attention.launches
        on_card, _ = lm.cuda()(ids.cuda(), attention_mask=mask.cuda())
        torch.cuda.synchronize()
    assert TA.flash_attention.launches == before + cfg.num_hidden_layers
    torch.testing.assert_close(on_card.cpu()[mask], on_cpu[mask], rtol=0, atol=1e-3)


def skip_case_mask(case, B, Nk):
    """Key masks (B, Nk) that exercise K1's tile list: row 0 is always fully
    valid; the others as the case says."""
    mask = torch.ones(B, Nk, dtype=torch.bool)
    if case == "holes":  # not a prefix: valid runs with whole masked tiles between them
        mask[1:, 64:192] = False
        mask[1:, 250:260] = False
        mask[2:, 300:] = False
    elif case == "last_tile_only":  # a row valid only in its last key tile
        mask[1:, : (Nk - 1) // 64 * 64 + 3] = False
    elif case == "left_padding":  # causal: the first queries see only masked keys
        mask[1:, :150] = False
    elif case == "ragged":
        mask[1:, Nk - 37 :] = False
        mask[-1] = False  # a fully masked row: the mean of V over all N_k keys
    return mask


# also chip_smoke.py's K1 edge cases
SKIP_CASES = [
    # case, B, H, Nq, Nk, D, causal
    ("holes", 3, 2, 200, 333, 128, False),
    ("holes", 3, 2, 333, 333, 64, True),
    ("last_tile_only", 2, 2, 150, 301, 128, False),
    ("left_padding", 2, 2, 300, 300, 64, True),
    ("left_padding", 3, 2, 200, 300, 128, True),
    ("ragged", 4, 40, 130, 130, 64, False),  # B*H = 160 > the SMs: one-warpgroup and two-warpgroup grids
    ("ragged", 2, 2, 1499, 1499, 128, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,B,H,Nq,Nk,D,causal", SKIP_CASES)
def test_flash_kernel_tile_skipping_on_card(card, dtype, case, B, H, Nq, Nk, D, causal):
    """K1's tile list against the plain version: masks with holes, a row
    valid only in its last tile, causal left padding (blocks whose first
    queries see no valid key visit every tile), N_k off the 64-key tile, a
    fully masked row, and B*H above the SM count."""
    rng = np.random.default_rng(Nq + Nk + D)
    q = torch.from_numpy(rng.standard_normal((B, H, Nq, D)).astype(np.float32)).to("cuda", dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, H, Nk, D)).astype(np.float32)).to("cuda", dtype) for _ in range(2))
    mask = skip_case_mask(case, B, Nk).cuda()
    got = TA.flash_attention(q, k, v, mask, causal)
    torch.cuda.synchronize()
    want = TA.attention_reference(q, k, v, mask, causal)
    # causal rows near the start average few keys: outputs up to |v| ~ 4, where a bf16 ulp is larger
    tol = ATT_TOL[dtype] * max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_never_reads_skipped_tiles_on_card(card, dtype, causal):
    """NaN written into K and V only inside key tiles that are fully masked,
    in rows that have a valid key, gives the output of zeros there: the
    kernel never loads a skipped tile."""
    B, H, N, D = 3, 2, 400, 128
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((B, H, N, D)).astype(np.float32)).to("cuda", dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, H, N, D)).astype(np.float32)).to("cuda", dtype) for _ in range(2))
    mask = torch.ones(B, N, dtype=torch.bool, device="cuda")
    mask[1, 64:192] = False  # tiles 1 and 2 of row 1
    mask[2, 256:] = False  # tiles 4-6 of row 2 (tile 6 runs past N)
    # causal: key 0 of each row stays valid, so every query has a valid allowed key
    dead = [(1, 64, 192), (2, 256, N)]
    zeroed, poisoned = (k.clone(), v.clone()), (k.clone(), v.clone())
    for b, lo, hi in dead:
        for t in zeroed:
            t[b, :, lo:hi] = 0
        for t in poisoned:
            t[b, :, lo:hi] = float("nan")
    want = TA.flash_attention(q, *zeroed, mask, causal)
    got = TA.flash_attention(q, *poisoned, mask, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_codebook_kernel_at_the_resynthesis_shape_on_card(card, dtype):
    """K4 at the resynthesis batches' 23 984 frames x 2 000 centers of 768
    (the wide block tile, many splits), f32 and bf16 frames: ids equal on
    every clear frame, at least 99.9% equal overall, and no flipped near-tie
    gives up more than SCORE_TOL of the score."""
    rng = np.random.default_rng(23984)
    x = torch.from_numpy(rng.standard_normal((23984, 768)).astype(np.float32)).to("cuda", dtype)
    centers = torch.from_numpy(rng.standard_normal((2000, 768)).astype(np.float32)).cuda()
    got = TC.assign(x, centers)
    want = TC.assign_reference(x, centers)
    score = x.float() @ centers.T - TC.half_sq_norms(centers)
    top2 = score.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3 * (top2[:, 0].abs() + 1)
    assert torch.equal(got[clear], want[clear])
    assert float((got == want).float().mean()) >= 0.999
    assert float(_score_given_up(x, centers, got, want).max()) <= SCORE_TOL


# ---------------------------------------------------------------------------
# the speech LM's speculative decoding, scoring, and the preprocessing front end
# ---------------------------------------------------------------------------


def teacher_forced_logits(lm, ids, p: int, block: int):
    """The cache path's logits over ``ids`` (B, n) after a prefill of its
    first ``p``: the prefill's last row, then one forward per ``block``
    tokens. Row j predicts token p + j, as a decode step (``block`` 1) or a
    verify block of lookup decoding (``block`` 1 + S) computes it."""
    with torch.inference_mode():
        cache = lm.init_cache(ids.shape[0], ids.shape[1])
        logits, _ = lm(ids[:, :p], cache=cache, cache_index=0)
        rows = [logits[:, -1:]]
        for i in range(p, ids.shape[1] - 1, block):
            chunk = ids[:, i : min(i + block, ids.shape[1] - 1)]
            logits, _ = lm(chunk, cache=cache, cache_index=i)
            rows.append(logits)
    return torch.cat(rows, dim=1)


def speculative_greedy_divergence(lm, prompt, max_new_tokens: int, eos_token_id: int = 1, spec_tokens: int = 7) -> dict:
    """``lookup_decode`` against ``greedy_decode`` at B = 1: equal token for
    token, or equal up to a first divergence at a near-tie, a position where
    the plain step's top-2 logit gap is at most twice the largest |logit
    difference| between verify blocks of 1 + S tokens and single steps over
    the plain sequence up to that position (under bf16 the two shapes of
    product may round differently). Returns the report; ``ok`` says whether
    the rule holds."""
    from speech_resynth_torch.models.llama import greedy_decode, lookup_decode

    p = prompt.shape[1]
    plain = greedy_decode(lm, prompt, max_new_tokens, eos_token_id)
    spec, stats = lookup_decode(lm, prompt, max_new_tokens, eos_token_id, spec_tokens=spec_tokens, return_stats=True)
    single = teacher_forced_logits(lm, plain, p, 1)[0].float()
    verify = teacher_forced_logits(lm, plain, p, 1 + spec_tokens)[0].float()
    differ = (plain[0, p:] != spec[0, p:]).nonzero()
    first = int(differ[0]) if len(differ) else None
    upto = max_new_tokens if first is None else first + 1
    delta = float((single[:upto] - verify[:upto]).abs().max())
    report = {"divergence": first, "max_logit_delta": delta, "stats": stats}
    if first is not None:
        top2 = single[first].topk(2).values
        report["gap"] = float(top2[0] - top2[1])
        report["near_tie"] = report["gap"] <= 2 * delta
    report["ok"] = first is None or report["near_tie"]
    return report


@pytest.mark.cuda
def test_speculative_greedy_equals_plain_greedy_on_card(card):
    """bf16 LM on the card (d = 64): lookup_decode gives greedy_decode's ids,
    except from a first divergence at a near-tie."""
    from speech_resynth_torch.core.precision import BF16_INFERENCE
    from speech_resynth_torch.models.composite import init_random_weights
    from speech_resynth_torch.models.llama import LlamaConfig, LlamaLM, greedy_decode

    cfg = LlamaConfig(vocab_size=300, hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2)
    lm = LlamaLM(cfg, BF16_INFERENCE)
    init_random_weights(lm, torch.Generator().manual_seed(1))
    lm = lm.cuda().eval()
    seed = torch.tensor([[5, 9, 17]], device="cuda")
    prompt = greedy_decode(lm, seed, 24, eos_token_id=-1)  # a greedy continuation: its tail recurs, drafts verify
    report = speculative_greedy_divergence(lm, prompt, 48, eos_token_id=-1)
    assert report["ok"], report
    assert report["stats"]["generated"] == 48


@pytest.mark.cuda
def test_write_scores_on_card_matches_cpu(card, tmp_path):
    """The score file of an f32 LM on the card (K1 causal, d = 64, no mask)
    against the CPU's: the same names in order, scores within 1e-4."""
    import json

    from speech_resynth_torch.core.precision import FLOAT32
    from speech_resynth_torch.models.composite import init_random_weights
    from speech_resynth_torch.models.llama import LlamaConfig, LlamaLM
    from speech_resynth_torch.pipeline.speechlm import write_scores

    cfg = LlamaConfig(vocab_size=300, hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2)
    lm = LlamaLM(cfg, FLOAT32)
    init_random_weights(lm, torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    items = {f"w{i:03d}": rng.integers(0, 290, int(rng.integers(3, 90))).tolist() for i in range(37)}
    (tmp_path / "units.json").write_text(json.dumps(items))
    write_scores(lm.eval(), tmp_path / "units.json", tmp_path / "cpu.txt", 16)
    before = TA.flash_attention.launches
    write_scores(lm.cuda(), tmp_path / "units.json", tmp_path / "card.txt", 16)
    assert TA.flash_attention.launches == before + 3 * cfg.num_hidden_layers
    ours = [line.split() for line in (tmp_path / "card.txt").read_text().splitlines()]
    theirs = [line.split() for line in (tmp_path / "cpu.txt").read_text().splitlines()]
    assert [n for n, _ in ours] == [n for n, _ in theirs] == list(items)
    np.testing.assert_allclose([float(s) for _, s in ours], [float(s) for _, s in theirs], rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("orig", [44100, 24000, 8000])
def test_resample_on_card_matches_cpu(card, orig):
    from speech_resynth_torch.dsp.resample import resample

    x = torch.from_numpy(np.random.default_rng(orig).standard_normal((3, orig * 2)).astype(np.float32) * 0.3)
    torch.testing.assert_close(resample(x.cuda(), orig, 16000).cpu(), resample(x, orig, 16000), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_log_mel_on_card_matches_cpu(card):
    """Broadband input (every mel bin within ~30 dB of its frame's loudest): atol 1e-4 in the log domain."""
    from speech_resynth_torch.dsp.mel import log_mel_spectrogram, whisper_log_mel

    rng = np.random.default_rng(5)
    x = torch.from_numpy((0.3 * np.sin(np.arange(48000) * 0.05) + 0.1 * rng.standard_normal((4, 48000))).astype(np.float32))
    for fn in (log_mel_spectrogram, whisper_log_mel):
        torch.testing.assert_close(fn(x.cuda()).cpu(), fn(x), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# training on the card: K1's gradient, and no K2 / K3 / K4 under gradient
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_function_gradient_equals_plain_on_card(card, dtype, causal):
    """K1 through ``dot_product_attention`` with inputs that require grad:
    one launch, an output with a ``grad_fn`` within ATT_TOL of the plain
    version, and dq, dk, dv equal to autograd through the plain version (the
    backward is that computation)."""
    rng = np.random.default_rng(int(causal))
    B, H, N, D = 3, 2, 100, 128
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, H, N, D)).astype(np.float32)).to("cuda", dtype) for _ in range(4))
    mask = torch.arange(N, device="cuda")[None, :] < torch.tensor([[N], [61], [1]], device="cuda")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = TA.flash_attention.launches
    out = TA.dot_product_attention(*leaves, mask=mask, causal=causal)
    assert TA.flash_attention.launches == before + 1 and out.grad_fn is not None
    out.backward(g)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = TA.attention_reference(*plain, mask, causal)
    want.backward(g)
    # for O(1) outputs; a causal row near the start averages few keys and reaches |v| ~ 3
    tol = ATT_TOL[dtype] * max(1.0, float(want.detach().float().abs().max()))
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=tol)
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_grad_on_card(card):
    x = torch.zeros(1, 16, 64, device="cuda", requires_grad=True)
    w = torch.zeros(1, 16, 16, 3, device="cuda")
    b = torch.zeros(1, 16, device="cuda")
    q = torch.zeros(1, 1, 64, 64, device="cuda", requires_grad=True)
    for call in (
        lambda: TM.mrf_branch_kernel(x, w, b, w, b, (1,)),
        lambda: TM.mrf_stage_kernel(x, [(w, b, w, b, (1,))]),
        lambda: TC.assign_kernel(x[0].T.contiguous(), torch.zeros(4, 16, device="cuda")),
        lambda: TA.flash_attention(q, q.detach(), q.detach()),
    ):
        with pytest.raises(ValueError, match="no backward"):
            call()


@pytest.mark.cuda
def test_tiny_gan_step_launches_no_mrf_kernel_on_card(card):
    """A generator whose narrow stages K2 takes (C = 32, 16) trains on the
    plain conv chain: a step launches neither K2 nor K3 and every generator
    parameter moves; under ``inference_mode`` the same generator takes K2."""
    from speech_resynth_torch.core.precision import DEFAULT
    from speech_resynth_torch.models.hifigan import HifiGanConfig
    from speech_resynth_torch.train.hifigan import HifiGanTrainerConfig, make_gan_trainer

    cfg = HifiGanConfig(model_in_dim=80, upsample_initial_channel=64, upsample_rates=(5, 4), upsample_kernel_sizes=(10, 8),
                        resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3)))
    (gen, _, _), state, step = make_gan_trainer(cfg, HifiGanTrainerConfig(n_fft=24, hop_size=20), DEFAULT, "cuda")
    rng = np.random.default_rng(0)
    T = 16
    batch = {
        "mel": torch.from_numpy(rng.standard_normal((2, T, 80)).astype(np.float32) - 5).cuda(),
        "wav": torch.from_numpy(rng.standard_normal((2, (T - 1) * 20 + 24)).astype(np.float32) * 0.1).cuda(),
        "mel_mask": torch.ones(2, T, dtype=torch.bool, device="cuda"),
    }
    before = [p.detach().clone() for p in gen.parameters()]
    counts = TM.mrf_branch_kernel.launches, TM.mrf_stage_kernel.launches
    for fusion in (False, True):
        with TM.mrf_stage_fusion(fusion):
            state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert (TM.mrf_branch_kernel.launches, TM.mrf_stage_kernel.launches) == counts
    assert all(np.isfinite(float(v)) for v in metrics.values()) and state.step == 2
    assert all(not torch.equal(a, p) for a, p in zip(before, gen.parameters()))
    with torch.inference_mode():
        gen(batch["mel"])
    assert TM.mrf_branch_kernel.launches == counts[0] + 4


def _recording(opt):
    """Record the gradients an ``Optimizer`` is given, on the CPU."""
    grads, real = [], opt.step
    opt.step = lambda g: grads.extend(x.detach().cpu() for x in g) or real(g)
    return grads


def _compare_steps(results, metric_keys) -> dict:
    """Card against CPU after one f32 step from the same parameters: metrics
    rtol 1e-4; parameters to 1e-6 where the CPU gradient exceeds 1e-3 *
    max|g| of its tensor (Adam's first update is about lr * sign(g), so a
    gradient near 0 may flip; see tests/test_torch_train_cfm.py); and, per
    tensor and over every element, the card's gradient (as its optimizer was
    given it) and its update (p_after - p_before) relative to the CPU's norm,
    ||x_card - x_cpu|| / ||x_cpu||, within STEP_TOL."""
    (cpu_m, cpu_drawn, cpu_p, cpu_g), (card_m, card_drawn, card_p, card_g) = results["cpu"], results["cuda"]
    assert all(torch.equal(a, b) for a, b in zip(cpu_drawn, card_drawn))
    rel = {k: abs(card_m[k] - cpu_m[k]) / max(abs(cpu_m[k]), 1e-12) for k in metric_keys}
    err = 0.0
    for a, b, g in zip(card_p, cpu_p, cpu_g):
        live = g.abs() > 1e-3 * g.abs().max()
        err = max(err, float((a[live] - b[live]).abs().max()) if live.any() else 0.0)
    grad_rel = max(_rel(a, b) for a, b in zip(card_g, cpu_g))
    update_rel = max(_rel(a - d, b - d) for a, b, d in zip(card_p, cpu_p, cpu_drawn))
    record = {"metrics_card": card_m, "metrics_cpu": cpu_m, "metrics_rel_diff": rel, "param_max_abs_diff": err,
              "grad_max_rel_diff": grad_rel, "update_max_rel_diff": update_rel,
              "tol": {"metrics_rel": 1e-4, "params_abs": 1e-6, **STEP_TOL}}
    assert all(r <= 1e-4 for r in rel.values()) and err <= 1e-6, record
    assert grad_rel <= STEP_TOL["grad_rel"] and update_rel <= STEP_TOL["update_rel"], record
    return record


def cfm_step_card_vs_cpu(remat: bool) -> dict:
    """One f32 CFM step (head dim 64, so K1 runs on the card) on the card and
    on the CPU from the same weights, table, batch, noise and times; K1's
    launches counted (2 a step at depth 2, 4 with remat)."""
    from speech_resynth_torch.core.precision import FLOAT32
    from speech_resynth_torch.models.cfm import CFMConfig
    from speech_resynth_torch.train.cfm import CFMTrainerConfig, make_trainer

    cfg = CFMConfig(vocab_size=20, dim_in=8, dim_cond_emb=12, hidden_size=128, depth=2, heads=2, intermediate_size=64,
                    conv_pos_embed_kernel_size=7, conv_pos_embed_groups=128, remat=remat)
    table = np.random.default_rng(1).standard_normal((21, 12)).astype(np.float32)
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 21, (3, 40))
    ids[1, 30:] = 0
    mels = rng.standard_normal((3, 40, 8)).astype(np.float32) - 5
    mels[1, 30:] = -100
    x0, times = rng.standard_normal((3, 40, 8)).astype(np.float32), rng.random(3).astype(np.float32)
    results, launches = {}, {}
    for device in ("cpu", "cuda"):
        model, state, step = make_trainer(cfg, CFMTrainerConfig(warmup_steps=2), 10, table, FLOAT32, device)
        grads = _recording(state.optimizers["model"])
        batch = {"input_ids": torch.from_numpy(ids).to(device), "spectrogram_labels": torch.from_numpy(mels).to(device)}
        drawn = [p.detach().cpu().clone() for p in state.optimizers["model"].params]
        before = TA.flash_attention.launches
        state, metrics = step(state, batch, 0, x0=torch.from_numpy(x0).to(device), times=torch.from_numpy(times).to(device))
        launches[device] = TA.flash_attention.launches - before
        params = [p.detach().cpu() for p in state.optimizers["model"].params]
        results[device] = ({k: float(v) for k, v in metrics.items()}, drawn, params, grads)
    assert launches == {"cpu": 0, "cuda": 2 * (2 if remat else 1)}, launches
    return {"remat": remat, "k1_launches": launches["cuda"], **_compare_steps(results, ("loss", "grad_norm"))}


def gan_step_card_vs_cpu() -> dict:
    """One f32 GAN step (a small generator, the fixed-width discriminators on
    324-sample waves) on the card and on the CPU from the same weights and
    batch; the card launches neither K2 nor K3."""
    from speech_resynth_torch.core.precision import FLOAT32
    from speech_resynth_torch.models.hifigan import HifiGanConfig
    from speech_resynth_torch.train.hifigan import HifiGanTrainerConfig, make_gan_trainer

    cfg = HifiGanConfig(model_in_dim=80, upsample_initial_channel=64, upsample_rates=(5, 4), upsample_kernel_sizes=(10, 8),
                        resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3)))
    tcfg = HifiGanTrainerConfig(n_fft=24, hop_size=20)
    rng = np.random.default_rng(0)
    T = 16
    batch = {
        "mel": rng.standard_normal((2, T, 80)).astype(np.float32) - 5,
        "wav": (rng.standard_normal((2, (T - 1) * 20 + 24)) * 0.1).astype(np.float32),
        "mel_mask": np.arange(T)[None, :] < np.array([[T], [T - 4]]),
    }
    results = {}
    counts = TM.mrf_branch_kernel.launches, TM.mrf_stage_kernel.launches
    for device in ("cpu", "cuda"):
        _, state, step = make_gan_trainer(cfg, tcfg, FLOAT32, device)
        grads = {k: _recording(o) for k, o in state.optimizers.items()}
        drawn = [p.detach().cpu().clone() for k in ("gen", "disc") for p in state.optimizers[k].params]
        state, metrics = step(state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        params = [p.detach().cpu() for k in ("gen", "disc") for p in state.optimizers[k].params]
        results[device] = ({k: float(v) for k, v in metrics.items()}, drawn, params, grads["gen"] + grads["disc"])
    assert (TM.mrf_branch_kernel.launches, TM.mrf_stage_kernel.launches) == counts
    return _compare_steps(results, ("loss_disc", "loss_gen", "mel_error"))


def _norms(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(||a - b||, ||b||), in f64 where an f32 norm would underflow."""
    ref, diff = float(torch.linalg.vector_norm(b)), float(torch.linalg.vector_norm(a - b))
    if not 1e-30 < ref < 1e30:
        a, b = a.double(), b.double()
        ref, diff = float(b.norm()), float((a - b).norm())
    return diff, ref


def _ratio(diff: float, ref: float) -> float:
    return diff / ref if ref > 0 else (0.0 if diff == 0 else math.inf)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||: 0 when both are 0, infinite when only b is."""
    return _ratio(*_norms(a, b))


def _to_cpu(tree):
    """A copy of a state dict's tree with its tensors on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return copy.deepcopy(tree)


GAN_MODULES = ("gen", "mpd", "msd")  # gan_steps_card_vs_cpu's modules: its tensor names' first part


def gan_steps_card_vs_cpu(steps: int = 16, devices=("cpu", "cuda"), policy: str = "float32") -> dict:
    """Scale ci's GAN training on two devices: the quality run's generator
    (``e2e_quality._gan_config`` at ``SCALES["ci"]``: 32 channels, rates 5,
    4, 4, 2, 2), the discriminators at their module widths, under
    ``policy`` ("float32", or "default": the loop's DEFAULT, bf16 convs;
    TF32 off), the CPU on GAN_REFERENCE_THREADS threads, every trainer from the same CPU
    draw, each step on the batch of 2 crops of 8 frames that
    ``train_hifigan`` takes from the formant corpus (seed 0) at that step.
    Three trainers: the reference on ``devices[0]``, and on ``devices[1]``
    one that follows its own trajectory ("free") and one that takes the
    reference's state before each step and, between the step's two halves,
    the reference's updated discriminators and MSD's ``u`` ("synced"). So
    each half of each step runs from the same state on both devices: Adam,
    at the draw's gradients (far below its eps), multiplies a difference of
    the discriminators' gradients by up to lr / eps = 2e4 in their update,
    and the generator's gradient through discriminators that see a
    near-silent output is set by the signs of their biases.

    At every step, against the reference's: the synced trainer's three
    losses (``loss_rel``), its gradients as its optimizers were given them
    (``grad``), its updates (``update``: the discriminators' after their
    half, the generator's after the step), and its updates against those the
    reference's optimizers make on the CPU from its state and gradients
    (``update_replayed``), each as ||x_b - x_a|| / ||x_a||, no element left
    out: per tensor (``*_rel_worst``: the worst and its name) and per
    module, its tensors as one vector (``*_rel_module``).
    ``first_divergence``: the first (step, where, kind, rel) past the
    policy's GAN_TOL: its "loss", its "step1" per tensor at step 1, or its
    "module" per module; None when none is. The free trainer gives the trajectory's
    measures: the three losses and the running ``gan_weight_change``
    (``e2e_quality._weight_change`` against the draw) of each device, and
    its generator's per-step differences (``free_*``)."""
    from speech_resynth_torch.core.precision import DEFAULT, FLOAT32
    from speech_resynth_torch.pipeline import e2e_quality as E
    from speech_resynth_torch.pipeline.prefetch import to_device
    from speech_resynth_torch.pipeline.synthetic import make_formant_corpus
    from speech_resynth_torch.pipeline.train_loops import GAN_KEYS, hifigan_training_setup
    from speech_resynth_torch.train.hifigan import make_gan_trainer

    p, tol = E.SCALES["ci"], GAN_TOL[policy]
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.get_num_threads()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(GAN_REFERENCE_THREADS)
    try:
        with tempfile.TemporaryDirectory(prefix="gan_steps_") as tmp:
            corpus = make_formant_corpus(Path(tmp) / "train_corpus", n_utts=p["n_train"], n_units=E.N_UNITS, seed=0)
            model_config, train_set, tcfg = hifigan_training_setup(E._gan_config(Path(tmp), corpus, p), p["gan_batch"])
            epochs = (train_set.batches(tcfg.batch_size, seed=tcfg.seed, epoch=e) for e in itertools.count())
            batches = list(itertools.islice(itertools.chain.from_iterable(epochs), steps))
        sides = {}
        for role, device in (("reference", devices[0]), ("free", devices[1]), ("synced", devices[1])):
            (gen, mpd, msd), state, step = make_gan_trainer(model_config, tcfg, {"float32": FLOAT32, "default": DEFAULT}[policy],
                                                            device)
            names = [f"gen.{n}" for n, _ in gen.named_parameters()]
            names += [f"{m}.{n}" for m, mod in (("mpd", mpd), ("msd", msd)) for n, _ in mod.named_parameters()]
            gen_opt, disc_opt = state.optimizers["gen"], state.optimizers["disc"]
            assert len(names) == len(gen_opt.params) + len(disc_opt.params)
            side = {"device": torch.device(device), "gen": gen, "msd": msd, "state": state, "step": step,
                    "grads": {k: _recording(o) for k, o in state.optimizers.items()}}
            side["follow"] = sides.get("reference") if role == "synced" else None

            def disc_step(g, side=side, opt=disc_opt, real=disc_opt.step):
                applied = real(g)
                side["disc_after"] = [q.detach().to("cpu", copy=True) for q in opt.params]
                side["u"] = {n: b.detach().cpu().clone() for n, b in side["msd"].named_buffers()}
                ref = side["follow"]
                if ref is not None:  # the generator's half runs through the reference's discriminators
                    with torch.no_grad():
                        for q, r in zip(opt.params, ref["disc_after"]):
                            q.copy_(r)
                        for n, b in side["msd"].named_buffers():
                            b.copy_(ref["u"][n])
                return applied

            disc_opt.step = disc_step
            sides[role] = side
        params = {r: [*s_["state"].optimizers["gen"].params, *s_["state"].optimizers["disc"].params] for r, s_ in sides.items()}
        draw = copy.deepcopy(sides["reference"]["gen"]).cpu()
        assert all(torch.equal(a.cpu(), b.cpu()) for ps in params.values() for a, b in zip(params["reference"], ps))

        def take_step(role, batch):
            side = sides[role]
            before = [q.detach().to("cpu", copy=True) for q in params[role]]
            moments = {k: _to_cpu(o.state_dict()) for k, o in side["state"].optimizers.items()} if role == "synced" else None
            side["state"], metrics = side["step"](side["state"], to_device(batch, GAN_KEYS, side["device"]))
            grads = side["grads"]["gen"] + side["grads"]["disc"]
            for g in side["grads"].values():
                g.clear()
            after = [q.detach().cpu() for q in side["state"].optimizers["gen"].params] + side["disc_after"]
            return {k: float(v) for k, v in metrics.items()}, grads, [a - b for a, b in zip(after, before)], before, moments

        def replayed(taken) -> list:
            """The updates the reference's optimizers make on the CPU from the
            state and the gradients of a step ``taken`` on the other device."""
            _, grads, _, before, moments = taken
            updates, at = [], 0
            for k in ("gen", "disc"):
                opt = sides["reference"]["state"].optimizers[k]
                n = len(opt.params)
                ps = [torch.nn.Parameter(b.clone()) for b in before[at : at + n]]
                replica = type(opt)(ps, opt.schedule, *opt.adamw.defaults["betas"], opt.adamw.defaults["eps"], opt.max_norm,
                                    opt.adamw.defaults["weight_decay"])
                replica.load_state_dict(moments[k])
                replica.step(grads[at : at + n])
                updates += [q.detach() - b for q, b in zip(ps, before[at : at + n])]
                at += n
            return updates

        records, first, n_gen = [], None, len(sides["reference"]["state"].optimizers["gen"].params)
        for i, batch in enumerate(batches):
            ref_state = sides["reference"]["state"].state_dict()
            if devices[0] == devices[1]:  # a load onto the same device would alias the moments
                ref_state["optimizers"] = copy.deepcopy(ref_state["optimizers"])
            sides["synced"]["state"].load_state_dict(ref_state)
            ref, synced, free = (take_step(r, batch) for r in ("reference", "synced", "free"))
            loss_rel = {k: abs(synced[0][k] - v) / max(abs(v), 1e-30) for k, v in ref[0].items()}
            record = {"step": i + 1, "losses": [ref[0], free[0]], "loss_rel": loss_rel}
            over = [(k, r) for k, r in loss_rel.items() if r > tol["loss"][k]]
            if first is None and over:
                first = {"step": i + 1, "where": over[0][0], "kind": "loss", "rel": over[0][1]}
            for prefix, other, modules in (("", synced, GAN_MODULES), ("free_", free, ("gen",))):
                kinds = [("grad", ref[1], other[1]), ("update", ref[2], other[2])]
                if not prefix:  # the card's optimizer against the CPU's on the card's gradients
                    kinds.append(("update_replayed", replayed(synced), synced[2]))
                for kind, xs, ys in kinds:
                    norms = [_norms(y, x) for x, y in zip(xs[: n_gen if prefix else len(names)], ys)]
                    values = [_ratio(*dr) for dr in norms]
                    worst = max(range(len(values)), key=values.__getitem__)
                    record[f"{prefix}{kind}_rel_worst"] = [values[worst], names[worst]]
                    # a module's tensors as one vector: its squared norms summed
                    by_module = {m: _ratio(*(math.sqrt(sum(dr[k] ** 2 for dr, n in zip(norms, names) if n.startswith(m + ".")))
                                             for k in (0, 1))) for m in modules}
                    record[f"{prefix}{kind}_rel_module"] = by_module
                    if prefix or first is not None:
                        continue
                    step1_tol = tol["step1"].get(kind, math.inf) if i == 0 else math.inf
                    over = [(names[j], v) for j, v in enumerate(values) if v > step1_tol]
                    over += [(m, r) for m, r in by_module.items() if r > tol["module"].get(kind, math.inf)]
                    if over:
                        first = {"step": i + 1, "where": over[0][0], "kind": kind, "rel": over[0][1]}
            record["gan_weight_change"] = [E._weight_change(draw, sides[r]["gen"]) for r in ("reference", "free")]
            records.append(record)
        return {"devices": list(devices), "steps": steps, "policy": policy, "threads": GAN_REFERENCE_THREADS, "tol": tol,
                "records": records,
                "first_divergence": first, "gan_weight_change": records[-1]["gan_weight_change"]}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, threads = saved
        torch.set_num_threads(threads)


# The GAN's bf16 convs at scale ci's shapes (a batch of 2 crops of 2 560 samples):
# (name, B, C_in, C_out, the input's spatial shape, kernel, stride, padding, groups)
BF16_CONV_PROBES = (
    ("generator resblock, C = 16, K = 11", 2, 16, 16, (640,), (11,), (1,), (5,), 1),
    ("MPD period 3, second conv", 2, 32, 128, (285, 3), (5, 1), (3, 1), (2, 0), 1),
    ("MSD third conv", 2, 128, 256, (1280,), (41,), (2,), (20,), 16),
    ("MSD sixth conv", 2, 1024, 1024, (80,), (41,), (1,), (20,), 16),
)
# The share of a bf16 conv's outputs and gradients more than one bf16 ulp from
# the exact value: at most 1.2e-4 on an H100, 2.4e-5 on its host's CPU
BF16_CONV_ULP_SHARE = 1e-3


def _ulp_share(got: torch.Tensor, exact: torch.Tensor) -> float:
    """The share of elements more than one bf16 ulp of the exact value from it."""
    _, e = torch.frexp(exact.abs())
    ulp = torch.where(exact == 0, torch.full_like(exact, 2.0**-133), torch.ldexp(torch.ones_like(exact), e - 8))
    return float(((got.double() - exact).abs() > ulp).double().mean())


def bf16_conv_errors(device: str) -> list:
    """Each of BF16_CONV_PROBES in bf16 on ``device``, forward and backward
    from seeded bf16 operands, against the exact values (f64 on the CPU from
    the same operands): per output, input gradient and weight gradient, the
    share of elements more than one bf16 ulp off and ||got - exact|| / ||exact||."""
    out = []
    for name, b, c_in, c_out, spatial, kernel, stride, padding, groups in BF16_CONV_PROBES:
        conv = F.conv1d if len(spatial) == 1 else F.conv2d
        gen = torch.Generator().manual_seed(len(out))
        x = torch.randn((b, c_in, *spatial), generator=gen).to(torch.bfloat16)
        w = (torch.randn((c_out, c_in // groups, *kernel), generator=gen) / math.sqrt(c_in // groups * math.prod(kernel)))
        w = w.to(torch.bfloat16)
        xs = [x.double().requires_grad_(), x.to(device).requires_grad_()]
        ws = [w.double().requires_grad_(), w.to(device).requires_grad_()]
        ys = [conv(xi, wi, None, stride, padding, 1, groups) for xi, wi in zip(xs, ws)]
        gy = torch.randn(ys[0].shape, generator=gen).to(torch.bfloat16)
        for y, ref in zip(ys, (gy.double(), gy.to(device))):
            y.backward(ref)
        record = {"conv": name, "device": device}
        for what, exact, got in (("output", ys[0], ys[1]), ("input_grad", xs[0].grad, xs[1].grad), ("weight_grad", ws[0].grad, ws[1].grad)):
            got, exact = got.detach().cpu(), exact.detach()
            record[what] = {"share_over_one_ulp": _ulp_share(got, exact), "rel": _rel(got.double(), exact)}
        out.append(record)
    return out


@pytest.mark.cuda
def test_card_bf16_convs_within_one_ulp_of_exact(card):
    """The GAN's bf16 convs on the card, forward and both gradients, within
    one bf16 ulp of the exact value but for at most BF16_CONV_ULP_SHARE of
    the elements: the card's bf16 GAN steps part from the CPU's by rounding
    amplified through the step, not by a wrong op (ROADMAP's accepted difference)."""
    for record in bf16_conv_errors("cuda"):
        for what in ("output", "input_grad", "weight_grad"):
            assert record[what]["share_over_one_ulp"] <= BF16_CONV_ULP_SHARE, record


# Faults that gan_steps_card_vs_cpu must see, planted in its second device's
# trainers: in the generator's loss a term's weight off by 3, a dropped term, a
# flipped sign; in the discriminators' loss a dropped term; both optimizers'
# updates x3; and in the free trainer alone both optimizers' updates x0.2, a
# trajectory that moves too little, which only the final weight change sees
GAN_FAULTS = ("mel_loss_weight_x3", "no_feature_loss", "adversarial_sign", "no_disc_real_term", "adam_update_x3",
              "free_update_x0.2")


@contextlib.contextmanager
def planted_gan_fault(fault: str, from_step: int = 2):
    """While open, every trainer ``make_gan_trainer`` builds after its first
    (``gan_steps_card_vs_cpu``'s free and synced ones; for the "free_"
    faults the free one alone) computes its losses or its updates with
    ``fault`` (one of GAN_FAULTS) from step ``from_step`` on."""
    import dataclasses

    import speech_resynth_torch.train.hifigan as TTH

    real_make, real_feature, real_adversarial, real_disc = (TTH.make_gan_trainer, TTH.feature_loss, TTH.generator_loss,
                                                           TTH.discriminator_loss)
    built, active = [], [False]
    scale = {"adam_update_x3": 3.0, "free_update_x0.2": 0.2}.get(fault)

    def make(config, trainer, *args, **kwargs):
        built.append(config)
        if len(built) == 1 or (fault.startswith("free_") and len(built) != 2):
            return real_make(config, trainer, *args, **kwargs)
        trainer = dataclasses.replace(trainer)
        modules, state, step = real_make(config, trainer, *args, **kwargs)
        if scale is not None:
            for opt in state.optimizers.values():

                def scaled(grads, opt=opt, real=opt.step):
                    before = [q.detach().clone() for q in opt.params] if active[0] else None
                    applied = real(grads)
                    if before is not None:
                        with torch.no_grad():
                            for q, b in zip(opt.params, before):
                                q.add_((scale - 1) * (q - b))
                    return applied

                opt.step = scaled

        def faulty(state, batch, weight=trainer.mel_loss_weight):
            active[0] = state.step + 1 >= from_step
            if fault == "mel_loss_weight_x3":
                trainer.mel_loss_weight = 3 * weight if active[0] else weight
            try:
                return step(state, batch)
            finally:
                active[0] = False

        return modules, state, faulty

    TTH.make_gan_trainer = make
    if fault == "no_feature_loss":
        TTH.feature_loss = lambda real, fake: 0 * real_feature(real, fake) if active[0] else real_feature(real, fake)
    if fault == "adversarial_sign":
        TTH.generator_loss = lambda outputs: -real_adversarial(outputs) if active[0] else real_adversarial(outputs)
    if fault == "no_disc_real_term":  # D(y) read as 1: (1 - D(y))^2 is 0
        TTH.discriminator_loss = lambda real, fake: real_disc([torch.ones_like(r) for r in real] if active[0] else real, fake)
    try:
        yield
    finally:
        TTH.make_gan_trainer, TTH.feature_loss, TTH.generator_loss, TTH.discriminator_loss = (real_make, real_feature,
                                                                                              real_adversarial, real_disc)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["float32", "default"])
def test_gan_steps_card_match_cpu_over_scale_ci_epoch(card, policy):
    """The 16 steps of scale ci's GAN epoch (``gan_steps_card_vs_cpu``)
    under ``policy``: from the CPU's state, at step 1 every tensor's gradient
    and update within the policy's GAN_TOL "step1" of the CPU's and at every
    step each module's within its "module"; the card's own trajectory's
    final ``gan_weight_change`` within its "weight" of the CPU's
    (``gan_weight_change_within``)."""
    r = gan_steps_card_vs_cpu(16, policy=policy)
    assert r["first_divergence"] is None, r["first_divergence"]
    assert gan_weight_change_within(policy, *r["gan_weight_change"]), r["gan_weight_change"]


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_tiny_cfm_step_launches_k1_on_card(card, remat):
    """K1 launches 2 a step at depth 2 (4 with remat, which recomputes each
    attention in the backward pass); the card's f32 step equals the CPU's
    (``_compare_steps``)."""
    cfm_step_card_vs_cpu(remat)


@pytest.mark.cuda
def test_tiny_gan_step_card_matches_cpu(card):
    gan_step_card_vs_cpu()


def lm_step_card_vs_cpu(attn_implementation: str, remat: bool = False) -> dict:
    """One f32 speech-LM step (head dim 64, so K1 takes the card's attention
    under "auto") on the card and on the CPU from the same seeded weights and
    padded batch; K1's launches counted (0 under "xla"; 2 a step at depth 2
    under "auto", 4 with remat)."""
    from speech_resynth_torch.core.precision import FLOAT32
    from speech_resynth_torch.models.llama import LlamaConfig
    from speech_resynth_torch.train.speechlm import SpeechLMTrainerConfig, make_speechlm_trainer

    cfg = LlamaConfig(vocab_size=50, hidden_size=128, intermediate_size=96, num_hidden_layers=2, num_attention_heads=2)
    tcfg = SpeechLMTrainerConfig(warmup_steps=2, lr=1e-3, attn_implementation=attn_implementation, remat=remat)
    ids = np.random.default_rng(3).integers(2, 50, (4, 48))
    ids[1, 40:] = 0
    ids[3, 17:] = 0
    batch = {"input_ids": ids, "attention_mask": ids != 0, "labels": np.where(ids == 0, -100, ids)}
    results, launches = {}, {}
    for device in ("cpu", "cuda"):
        _, state, step = make_speechlm_trainer(cfg, tcfg, None, 10, FLOAT32, device=device)
        grads = _recording(state.optimizers["model"])
        drawn = [p.detach().cpu().clone() for p in state.optimizers["model"].params]
        before = TA.flash_attention.launches
        state, metrics = step(state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        launches[device] = TA.flash_attention.launches - before
        params = [p.detach().cpu() for p in state.optimizers["model"].params]
        results[device] = ({k: float(v) for k, v in metrics.items()}, drawn, params, grads)
    want = 0 if attn_implementation == "xla" else 2 * (2 if remat else 1)
    assert launches == {"cpu": 0, "cuda": want}, launches
    return {"attn_implementation": attn_implementation, "remat": remat, "k1_launches": launches["cuda"],
            **_compare_steps(results, ("loss", "grad_norm"))}


@pytest.mark.cuda
@pytest.mark.parametrize("attn_implementation,remat", [("xla", False), ("auto", False), ("auto", True), ("pallas", False)])
def test_tiny_lm_step_card_matches_cpu(card, attn_implementation, remat):
    """The LM trainer's f32 step on the card equals the CPU's
    (``_compare_steps``); "xla" never launches K1, "auto" and "pallas" once
    per layer forward (twice with remat)."""
    lm_step_card_vs_cpu(attn_implementation, remat)


# the eval stack: Whisper's cross-attention (a decode step's one query, the
# prompt's four, the encoder's 1 500 keys, no mask, not causal) and a smaller one
CROSS_SHAPES = [(8, 20, 1, 1500), (8, 20, 4, 1500), (3, 2, 1, 130), (3, 2, 7, 70)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Nq,Nk", CROSS_SHAPES)
def test_flash_kernel_at_cross_attention_shapes_on_card(card, dtype, B, H, Nq, Nk):
    """K1 with q_len below one 64-query block and q_len != k_len, not causal:
    the block's empty rows are never stored."""
    rng = np.random.default_rng(Nq * Nk)
    q = torch.from_numpy(rng.standard_normal((B, H, Nq, 64)).astype(np.float32)).to("cuda", dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, H, Nk, 64)).astype(np.float32)).to("cuda", dtype) for _ in range(2))
    got = TA.flash_attention(q, k, v, None, False)
    torch.cuda.synchronize()
    want = TA.attention_reference(q, k, v, None, False)
    assert got.shape == (B, H, Nq, 64)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATT_TOL[dtype])


WHISPER_TINY = dict(vocab_size=96, num_mel_bins=16, d_model=128, encoder_layers=2, encoder_attention_heads=2,
                    decoder_layers=2, decoder_attention_heads=2, encoder_ffn_dim=256, decoder_ffn_dim=256,
                    max_source_positions=50, max_target_positions=40, decoder_start_token_id=90, eos_token_id=91)
GAP_TOL = 1e-3  # ids must agree while the CPU run's top-2 logit gap exceeds this


def whisper_decode_card_vs_cpu(kw: dict = WHISPER_TINY, batch: int = 4, new_tokens: int = 12, seed: int = 0) -> dict:
    """``greedy_decode`` of seeded random weights in f32 on the card (K1 at the
    encoder, the prefill's and every step's cross-attention) and on the CPU:
    the ids agree up to the first step whose top-2 logit gap on the CPU is
    below ``GAP_TOL``; the encoder states and the teacher-forced logits agree
    within 1e-3."""
    from speech_resynth_torch.core.precision import FLOAT32
    from speech_resynth_torch.models import whisper as TW
    from speech_resynth_torch.models.composite import init_random_weights

    cfg = TW.WhisperConfig(**kw)
    model = TW.WhisperForASR(cfg, FLOAT32).eval()
    init_random_weights(model, torch.Generator().manual_seed(seed))
    mel = torch.from_numpy(np.random.default_rng(seed).standard_normal((batch, 2 * cfg.max_source_positions, cfg.num_mel_bins))
                           .astype(np.float32))
    prompt = torch.tensor([[cfg.decoder_start_token_id, 5, 9]] * batch)
    cpu = TW.greedy_decode(model, mel, new_tokens, prompt)
    with torch.no_grad():
        logits = model(mel, cpu[:, :-1])[:, prompt.shape[1] - 1 :]
        enc_cpu = model.encode(mel)
    top2 = logits.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]  # (B, new_tokens)
    model.cuda()
    before = TA.flash_attention.launches
    card = TW.greedy_decode(model, mel.cuda(), new_tokens, prompt).cpu()
    torch.cuda.synchronize()
    launches = TA.flash_attention.launches - before
    with torch.no_grad():
        enc_err = float((model.encode(mel.cuda()).cpu() - enc_cpu).abs().max())
        logit_err = float((model(mel.cuda(), cpu[:, :-1].cuda())[:, prompt.shape[1] - 1 :].cpu() - logits).abs().max())
    p = prompt.shape[1]
    agree = []
    for b in range(batch):
        clear = gap[b] > GAP_TOL
        n = int(clear.long().cumprod(0).sum())  # steps up to the first near-tie
        agree.append(bool(torch.equal(card[b, : p + n], cpu[b, : p + n])))
    record = {"batch": batch, "new_tokens": new_tokens, "k1_launches": launches, "ids_agree": all(agree),
              "min_top2_gap": float(gap.min()), "encoder_max_abs_err": enc_err, "logits_max_abs_err": logit_err,
              "gap_tol": GAP_TOL}
    assert record["ids_agree"] and enc_err < 1e-3 and logit_err < 1e-3, record
    return record


@pytest.mark.cuda
def test_tiny_whisper_greedy_decode_card_matches_cpu(card):
    whisper_decode_card_vs_cpu()


def utmos_card_vs_cpu(seed: int = 0) -> dict:
    """A tiny UTMOS (tower hidden 128, two heads of 64) of seeded random
    weights in f32 on a right-padded batch of three waves, on the card (K1 at
    the tower's masked shape) and on the CPU: valid-frame scores within
    1e-3, MOS within 1e-4, and each padded row equal to its wave alone."""
    from speech_resynth_torch.core.precision import FLOAT32
    from speech_resynth_torch.models import utmos as TU
    from speech_resynth_torch.models.composite import init_random_weights
    from speech_resynth_torch.models.hubert import HubertConfig

    ssl = HubertConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
                       conv_dim=(32, 32, 32), conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
                       num_conv_pos_embedding_groups=4)
    cfg = TU.UTMOSConfig(ssl=ssl, domain_dim=8, num_judges=10, judge_dim=8, lstm_hidden=16, projection_hidden=32)
    model = TU.UTMOSPredictor(cfg, FLOAT32).eval()
    init_random_weights(model, torch.Generator().manual_seed(seed))
    lens = [4000, 2600, 1500]
    rng = np.random.default_rng(seed)
    waves = torch.zeros(3, max(lens))
    for i, n in enumerate(lens):
        waves[i, :n] = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1)
    n_samples = torch.tensor(lens)
    frames_n = cfg.ssl.num_frames(n_samples)
    dom, judge = torch.tensor([0, 1, 2]), torch.tensor([3, 0, 9])
    with torch.no_grad():
        cpu = model(waves, dom, judge, n_samples)
        model.cuda()
        before = TA.flash_attention.launches
        on_card = model(waves.cuda(), dom.cuda(), judge.cuda(), n_samples.cuda())
        torch.cuda.synchronize()
        launches = TA.flash_attention.launches - before
        alone = [model(waves[i : i + 1, :n].cuda(), dom[i : i + 1].cuda(), judge[i : i + 1].cuda()).cpu() for i, n in enumerate(lens)]
    on_card = on_card.cpu()
    err = max(float((on_card[i, :n] - cpu[i, :n]).abs().max()) for i, n in enumerate(frames_n.tolist()))
    alone_err = max(float((on_card[i, :n] - alone[i][0]).abs().max()) for i, n in enumerate(frames_n.tolist()))
    mos_err = float((TU.UTMOSPredictor.score_from_frames(on_card, frames_n) - TU.UTMOSPredictor.score_from_frames(cpu, frames_n)).abs().max())
    record = {"lengths": lens, "k1_launches": launches, "frames_max_abs_err": err, "padded_vs_alone_max_abs_err": alone_err,
              "mos_max_abs_err": mos_err}
    assert launches == ssl.num_hidden_layers and err < 1e-3 and alone_err < 1e-3 and mos_err < 1e-4, record
    return record


@pytest.mark.cuda
def test_tiny_utmos_card_matches_cpu(card):
    utmos_card_vs_cpu()


def write_whisper_tokenizer(path, n_vocab: int, seed: int = 0, clean_up: bool = True, languages=("en",),
                            timestamps: int = 10) -> dict:
    """Byte-level BPE files in Whisper's layout (``vocab.json``,
    ``merges.txt``, ``tokenizer_config.json``): ``n_vocab`` vocabulary tokens
    (the 256 bytes, some words and multi-byte UTF-8 pieces, then seeded
    distinct 2-3 character tokens of GPT-2's printable byte characters),
    then as added tokens the specials in large-v3's order (end of text,
    start of transcript, ``languages``, translate, transcribe, start of LM,
    start of previous text, no speech, no timestamps) and ``timestamps``
    timestamp tokens. With 50 257 tokens, 100 languages and 1 501
    timestamps the ids are large-v3's 51 866. Returns the vocabulary and
    the added tokens' ids."""
    import json

    from speech_resynth_torch.pipeline.scorers import bytes_to_unicode

    b2u = bytes_to_unicode()
    rng = np.random.default_rng(seed)
    vocab = {b2u[b]: b for b in range(256)}
    for piece in (" the", " cat", "é", " ü", "日本", " ,", " .", "n't", " 's", "€"):
        vocab.setdefault("".join(b2u[b] for b in piece.encode()), len(vocab))
    while len(vocab) < n_vocab:
        vocab.setdefault("".join(b2u[int(b)] for b in rng.integers(32, 127, rng.integers(2, 4))), len(vocab))
    specials = (["<|endoftext|>", "<|startoftranscript|>"] + [f"<|{lang}|>" for lang in languages]
                + ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>", "<|nospeech|>", "<|notimestamps|>"])
    added = specials + [f"<|{0.02 * i:.2f}|>" for i in range(timestamps)]
    ids = {c: n_vocab + i for i, c in enumerate(added)}
    (path / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (path / "merges.txt").write_text("#version: 0.2\n")
    (path / "tokenizer_config.json").write_text(json.dumps({
        "added_tokens_decoder": {str(i): {"content": c, "special": c in specials} for c, i in ids.items()},
        "additional_special_tokens": specials[1:],
        "bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>", "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>",
        "clean_up_tokenization_spaces": clean_up, "errors": "replace", "tokenizer_class": "WhisperTokenizer",
    }))
    return {"vocab": vocab, "added": ids}


class RecordingWriter:
    """A stand-in for ``core.metrics.MetricsWriter`` (a no-op without
    tensorboardX) that records the scalars and the audio clips' tags and
    lengths."""

    def __init__(self, *args, **kwargs):
        self.scalars_, self.clips = {}, []

    def scalar(self, tag, value, step):
        self.scalars_[tag] = float(value)

    def scalars(self, values, step, prefix=""):
        for k, v in values.items():
            self.scalar(prefix + k, v, step)

    def audio(self, tag, waveform, step, sample_rate=16000):
        self.clips.append((tag, len(np.asarray(waveform).reshape(-1))))

    def __getattr__(self, name):  # the loops' other summaries
        return lambda *args, **kwargs: None


# ---------------------------------------------------------------------------
# K5: the velocity transformer's conv feed-forward (ops/conv_ff.py)
# ---------------------------------------------------------------------------

# K5 against its plain version on the same bf16 operands: both sum in f32 and
# round h once, so they part only where the summation order or __expf moves
# h across a bf16 rounding boundary (one ulp of those elements) and where
# the output rounds: within 1e-2 of the output's largest magnitude.
FF_TOL = 1e-2
# the serving batch's velocity model through sample() by both routes, against
# its f32 plain chain (TF32 off): the kernel route's worst-row normalized mel
# error may exceed the bf16 plain chain's by at most FF_SAMPLE_MARGIN of it
FF_SAMPLE_MARGIN = 1.25


def ff_case(c, i, B, N, mask_kind, seed=0):
    """A feed-forward's laid-out bf16 weights (nonzero biases), x (B, N, C)
    bf16 masked where its frame mask (padded tails, holes, none) says."""
    from speech_resynth_torch.ops import conv_ff as K5

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w1 = torch.randn(2 * i, c, 3, generator=gen, device="cuda") / (3 * c) ** 0.5
    w2 = torch.randn(c, i, 3, generator=gen, device="cuda") / (3 * i) ** 0.5
    b1, b2 = 0.5 * torch.randn(2 * i, generator=gen, device="cuda"), 0.5 * torch.randn(c, generator=gen, device="cuda")
    ops = K5.ff_operands(w1, b1, w2, b2, torch.bfloat16)
    x = torch.randn(B, N, c, generator=gen, device="cuda")
    mask = None
    if mask_kind != "none":
        lengths = torch.randint(1, N + 1, (B,), generator=gen, device="cuda")
        lengths[0] = N
        mask = torch.arange(N, device="cuda")[None, :] < lengths[:, None]
        if mask_kind == "holes":
            mask &= torch.rand(B, N, generator=gen, device="cuda") > 0.3
        x = x.masked_fill(~mask[..., None], 0)
    return x.to(torch.bfloat16), ops, mask


@pytest.mark.cuda
@pytest.mark.parametrize("c,i,B,N,mask_kind", [
    (256, 896, 32, 1024, "tail"),  # serving
    (256, 896, 32, 1536, "tail"),
    (256, 896, 32, 1152, "holes"),
    (256, 896, 1, 50, "none"),  # a streaming window
    (256, 896, 3, 1, "tail"),
    (256, 896, 4, 333, "holes"),  # N not a multiple of the 128-row tile
    (256, 896, 2, 129, "tail"),
    (256, 128, 3, 200, "holes"),  # the narrowest widths K5 takes: one column tile each
])
def test_conv_ff_kernel_matches_plain_on_card(card, c, i, B, N, mask_kind):
    from speech_resynth_torch.ops import conv_ff as K5

    x, ops, mask = ff_case(c, i, B, N, mask_kind)
    before = K5.conv_ff_kernel.launches
    got = K5.conv_ff_kernel(x, ops, mask)
    torch.cuda.synchronize()
    want = K5.conv_ff_reference(x, ops, mask)
    assert K5.conv_ff_kernel.launches == before + 2
    assert got.shape == want.shape and got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert max_abs_diff(got, want) <= FF_TOL * float(want.float().abs().max()), (c, i, B, N, mask_kind)


def max_abs_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.cuda
def test_conv_ff_kernel_reads_no_other_batch_row_on_card(card):
    """A frame's output sees only its own batch row: the SAME padding at
    each row's ends comes from the tensor map's bounds, so another row's
    frames change nothing."""
    from speech_resynth_torch.ops import conv_ff as K5

    x, ops, mask = ff_case(256, 896, 3, 200, "holes", seed=1)
    base = K5.conv_ff_kernel(x, ops, mask)
    x2 = x.clone()
    x2[1] = 7.0
    out2 = K5.conv_ff_kernel(x2, ops, mask)
    torch.cuda.synchronize()
    assert torch.equal(out2[0], base[0]) and torch.equal(out2[2], base[2]) and not torch.equal(out2[1], base[1])


@pytest.mark.cuda
def test_sample_at_the_serving_shape_by_both_routes_on_card(card, monkeypatch):
    """The serving batch's velocity model (the Expresso widths, 32 rows of
    up to 1 024 units, euler 16) through ``sample``: K5 launches exactly 2 x 4
    layers x 16 steps times, and the mel it gives is as close to the f32
    plain chain's as the bf16 plain chain's is."""
    from speech_resynth_torch.core.precision import BF16_INFERENCE, FLOAT32
    from speech_resynth_torch.models import transformer as TR
    from speech_resynth_torch.models.cfm import CFMConfig, ConditionalFlowMatchingModel
    from speech_resynth_torch.models.composite import init_random_weights
    from speech_resynth_torch.ops import conv_ff as K5

    cfg = CFMConfig()
    model = ConditionalFlowMatchingModel(cfg, BF16_INFERENCE)
    init_random_weights(model, torch.Generator().manual_seed(0))
    model32 = ConditionalFlowMatchingModel(cfg, FLOAT32)
    model32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    model, model32 = (m.to("cuda").eval().requires_grad_(False) for m in (model, model32))
    rng = np.random.default_rng(1)
    ids = rng.integers(1, cfg.vocab_size + 1, (32, 1024))
    lengths = rng.integers(50, 1025, 32)
    lengths[0] = 1024
    ids[np.arange(1024)[None, :] >= lengths[:, None]] = 0
    ids = torch.from_numpy(ids).cuda()
    x0 = torch.from_numpy(rng.standard_normal((32, 1024, cfg.dim_in)).astype(np.float32)).cuda()

    def run(m):
        mel, mask = m.sample(ids, 1 / 16, 1.0, x0=x0)
        return (mel.float() - cfg.mean) / cfg.std, mask

    before = K5.conv_ff_kernel.launches
    kernel, mask = run(model)
    torch.cuda.synchronize()
    assert K5.conv_ff_kernel.launches - before == 2 * cfg.depth * 16
    want, _ = run(model32)
    monkeypatch.setattr(TR.ConvFeedForward, "route", lambda self, x, dropout_on=False: "plain chain")
    plain, _ = run(model)

    def worst(a):
        return max(float((a[j, :n] - want[j, :n]).norm() / want[j, :n].norm()) for j, n in enumerate(lengths))

    assert torch.equal(mask.cpu(), torch.from_numpy(np.arange(1024)[None, :] < lengths[:, None]))
    kernel_err, plain_err = worst(kernel), worst(plain)
    print(f"mel_rel_err against the f32 plain chain: kernel route {kernel_err:.6f}, bf16 plain chain {plain_err:.6f}")
    assert kernel_err <= FF_SAMPLE_MARGIN * plain_err, (kernel_err, plain_err)


if __name__ == "__main__":
    # python tests/test_torch_cuda.py [steps] [policy ...]: gan_steps_card_vs_cpu's
    # records on the card, one JSON line a policy; python tests/test_torch_cuda.py
    # faults [policy] [steps] [fault ...]: each planted fault's steps (2 by
    # default), CPU against CPU, the discriminators at their module widths (the
    # numbers the GAN_TOL limits sit between); python tests/test_torch_cuda.py
    # convs [device ...]: bf16_conv_errors
    import json
    import sys

    args = sys.argv[1:]
    if args[:1] == ["convs"]:
        for device in args[1:] or ("cpu", "cuda"):
            for record in bf16_conv_errors(device):
                print(json.dumps(record), flush=True)
    elif args[:1] == ["faults"]:
        policy, steps = (args[1] if len(args) > 1 else "float32"), (int(args[2]) if len(args) > 2 else 2)
        for fault in args[3:] or GAN_FAULTS:
            with planted_gan_fault(fault):
                r = gan_steps_card_vs_cpu(steps, devices=("cpu", "cpu"), policy=policy)
            last = r["records"][-1]
            print(json.dumps({"fault": fault, "steps": steps, "gan_weight_change": r["gan_weight_change"],
                              **{k: last[k] for k in ("loss_rel", "grad_rel_module", "update_replayed_rel_module")},
                              "first_divergence": r["first_divergence"]}), flush=True)
    else:
        for name in args[1:] or GAN_TOL:
            print(json.dumps(gan_steps_card_vs_cpu(int(args[0]) if args else 16, policy=name)), flush=True)
