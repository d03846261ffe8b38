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

import numpy as np
import pytest
import torch

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
    few bf16 ulps through the later stages (atol 2e-2 on O(1) samples)."""
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
    torch.testing.assert_close(on, off, rtol=0, atol=1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
def test_short_stream_matches_batch_on_card(card):
    """The production vocoder in f32 (TF32 off), streamed in irregular pushes
    with stage fusion on: the batch run, up to summation order."""
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
    assert got.shape == want.shape and sv.device_calls >= 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


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
    """Card against CPU after one f32 step: metrics rtol 1e-4; parameters to
    1e-6 where the CPU gradient exceeds 1e-3 * max|g| of its tensor (Adam's
    first update is about lr * sign(g), so a gradient near 0 may flip; see
    tests/test_torch_train_cfm.py)."""
    (cpu_m, cpu_p, cpu_g), (card_m, card_p, _) = results["cpu"], results["cuda"]
    rel = {k: abs(card_m[k] - cpu_m[k]) / max(abs(cpu_m[k]), 1e-12) for k in metric_keys}
    err = 0.0
    for a, b, g in zip(card_p, cpu_p, cpu_g):
        live = g.abs() > 1e-3 * g.abs().max()
        err = max(err, float((a[live] - b[live]).abs().max()) if live.any() else 0.0)
    record = {"metrics_card": card_m, "metrics_cpu": cpu_m, "metrics_rel_diff": rel, "param_max_abs_diff": err,
              "tol": {"metrics_rel": 1e-4, "params_abs": 1e-6}}
    assert all(r <= 1e-4 for r in rel.values()) and err <= 1e-6, record
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
        before = TA.flash_attention.launches
        state, metrics = step(state, batch, 0, x0=torch.from_numpy(x0).to(device), times=torch.from_numpy(times).to(device))
        launches[device] = TA.flash_attention.launches - before
        params = [p.detach().cpu() for p in state.optimizers["model"].params]
        results[device] = ({k: float(v) for k, v in metrics.items()}, params, grads)
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
        state, metrics = step(state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        params = [p.detach().cpu() for k in ("gen", "disc") for p in state.optimizers[k].params]
        results[device] = ({k: float(v) for k, v in metrics.items()}, params, grads["gen"] + grads["disc"])
    assert (TM.mrf_branch_kernel.launches, TM.mrf_stage_kernel.launches) == counts
    return _compare_steps(results, ("loss_disc", "loss_gen", "mel_error"))


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
        before = TA.flash_attention.launches
        state, metrics = step(state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        launches[device] = TA.flash_attention.launches - before
        params = [p.detach().cpu() for p in state.optimizers["model"].params]
        results[device] = ({k: float(v) for k, v in metrics.items()}, params, grads)
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
