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
orders cannot flip the winner.
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
@pytest.mark.parametrize("C,K,T", [(32, 7, 1500), (16, 3, 2049), (64, 11, 50)])
def test_mrf_kernel_matches_plain_on_card(card, dtype, C, K, T):
    """T not a multiple of the tile, and T below one tile: zero padding at every conv."""
    rng = np.random.default_rng(C + K)

    def rand(*shape, scale):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to("cuda", dtype)

    x = rand(2, C, T, scale=0.5)
    w1, w2 = rand(3, C, C, K, scale=1 / np.sqrt(C * K)), rand(3, C, C, K, scale=1 / np.sqrt(C * K))
    b1, b2 = rand(3, C, scale=0.01), rand(3, C, scale=0.01)
    before = TM.mrf_branch_kernel.launches
    got = TM.mrf_branch(x, w1, b1, w2, b2, (1, 3, 5))
    torch.cuda.synchronize()
    assert TM.mrf_branch_kernel.launches == before + 1 and got.dtype == dtype
    want = TM.mrf_branch_reference(x, w1, b1, w2, b2, (1, 3, 5))
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=MRF_TOL[dtype])


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,T", [(64, 50), (64, 1000), (32, 1000), (16, 137), (16, 2049)])
def test_stage_kernel_matches_plain_on_card(card, dtype, C, T):
    """K3: T below one tile and not a multiple of it, at each stage width."""
    rng = np.random.default_rng(C + T)
    x = torch.from_numpy(rng.standard_normal((2, C, T)).astype(np.float32) * 0.5).to("cuda", dtype)
    branches = _stage_branches(rng, C, dtype)
    before = TM.mrf_stage_kernel.launches
    got = TM.mrf_stage(x, branches)
    torch.cuda.synchronize()
    assert TM.mrf_stage_kernel.launches == before + 1 and got.dtype == dtype
    want = TM.mrf_stage_reference(x, branches)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=MRF_TOL[dtype])


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
    """K4 with the speech LM's encoder codebook, 100 centers of 768: one
    128-center tile holds them all, most of it padding."""
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
