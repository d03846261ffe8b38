"""The whole-stage MRF kernel's plain version and the generator's stage gate, against the JAX package.

K3 computes one HiFi-GAN MRF stage, every branch and their mean, in one
launch. Here its plain version (``mrf_stage_reference``) is held against the
JAX stage kernel in interpret mode, a blocked emulation of the CUDA kernel's
tiling (the shared max-halo window, per-branch offsets, the edge masks)
against the plain version, and the port's generator with stage fusion on
against the JAX package's fused generator. The kernel itself runs only on a
card (tests/test_torch_cuda.py).

Tolerances: f32 on both sides with another summation order, rtol 1e-4 and
atol 1e-5 (the JAX stage test's own); bf16 against the f32 mean, rtol 0.05
and atol 0.06 (the JAX test's bf16 bound: bf16 operands through six convs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.models import hifigan as jax_hifigan
from speech_resynth_tpu.ops import fused_mrf as JM
from speech_resynth_torch.core.precision import BF16_INFERENCE, FLOAT32
from speech_resynth_torch.models import hifigan as torch_hifigan
from speech_resynth_torch.models.convert import hifigan_generator_state_dict
from speech_resynth_torch.ops import fused_mrf as TM

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=0.05, atol=0.06)
PRODUCTION_BRANCHES = ((3, (1, 3, 5)), (7, (1, 3, 5)), (11, (1, 3, 5)))


def _stage(C, T, shapes, seed=0, B=2):
    """x (B, T, C) and JAX-layout branches ((pairs, K, C_in, C_out) weights), seeded."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32) * 0.5
    branches = []
    for K, dil in shapes:
        n = len(dil)
        w1, w2 = (rng.standard_normal((n, K, C, C)).astype(np.float32) * 0.1 for _ in range(2))
        b1, b2 = (rng.standard_normal((n, C)).astype(np.float32) * 0.01 for _ in range(2))
        branches.append((w1, b1, w2, b2, tuple(dil)))
    return x, branches


def _to_torch(x, branches, dtype=torch.float32):
    """JAX (B, T, C) and (pairs, K, C_in, C_out) -> the port's (B, C, T) and (pairs, C_out, C_in, K)."""
    tx = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).to(dtype)
    tb = []
    for w1, b1, w2, b2, dil in branches:
        tw1, tw2 = (torch.from_numpy(np.ascontiguousarray(w.transpose(0, 3, 2, 1))).to(dtype) for w in (w1, w2))
        tb.append((tw1, torch.from_numpy(b1).to(dtype), tw2, torch.from_numpy(b2).to(dtype), dil))
    return tx, tb


@pytest.mark.parametrize("T", [137, 40])
def test_stage_reference_matches_jax_stage_kernel(T):
    x, branches = _stage(16, T, PRODUCTION_BRANCHES, seed=7)
    theirs = JM.mrf_stage_pallas(jnp.asarray(x), [tuple(map(jnp.asarray, b[:4])) + (b[4],) for b in branches],
                                 t_blk=128, interpret=True, fold=1)
    ours = TM.mrf_stage_reference(*_to_torch(x, branches))
    np.testing.assert_allclose(ours.numpy().transpose(0, 2, 1), np.asarray(theirs), **F32_TOL)


def test_stage_reference_bf16_matches_jax_within_the_bf16_bound():
    """bf16 operands and one rounding of the f32 mean, against the f32 mean
    of the JAX branch references; and against the JAX stage kernel in bf16."""
    x, branches = _stage(16, 137, PRODUCTION_BRANCHES, seed=8)
    ref = sum(JM.mrf_branch_reference(jnp.asarray(x), *map(jnp.asarray, b[:4]), b[4]) for b in branches) / 3.0
    ours = TM.mrf_stage_reference(*_to_torch(x, branches, torch.bfloat16))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy().transpose(0, 2, 1), np.asarray(ref), **BF16_TOL)
    bf = [tuple(jnp.asarray(a, jnp.bfloat16) for a in b[:4]) + (b[4],) for b in branches]
    theirs = JM.mrf_stage_pallas(jnp.asarray(x, jnp.bfloat16), bf, t_blk=128, interpret=True, fold=1)
    np.testing.assert_allclose(ours.float().numpy().transpose(0, 2, 1), np.asarray(theirs, np.float32), atol=3e-2, rtol=0)


def test_stage_reference_is_the_mean_of_the_branch_chains():
    """In f32 the stage equals the per-branch route (three branch outputs
    and their mean) up to summation order; the stage multiplies by 1/n."""
    x, branches = _to_torch(*_stage(32, 90, PRODUCTION_BRANCHES, seed=3))
    per_branch = sum(TM.mrf_branch_reference(x, *b) for b in branches) / 3.0
    np.testing.assert_allclose(TM.mrf_stage_reference(x, branches).numpy(), per_branch.numpy(), rtol=1e-6, atol=1e-6)


POISON = 1e3  # what the emulation leaves in tiles a conv skips: any leak into the outputs shows


def _stage_emulation(x, branches, slope=TM.LRELU_SLOPE):
    """K3's tiling (csrc/fused_mrf.cu) in torch: per time tile one window of
    t_tile + 2*halo_max columns, read once; every branch starts from that
    pristine window; each conv computes only the 8-column tiles its outputs
    still need (halo_max -+ the pads of the branch's remaining convs: the
    JAX kernel's per-branch offset and shrinking widths) and the rest is
    poisoned; every conv input is zeroed outside [0, T); the branches'
    central t_tile columns are summed in f32, then 1/n and one rounding."""
    B, C, T = x.shape
    shapes = [(w1.shape[-1], dil) for w1, _, _, _, dil in branches]
    t_tile, window, _ = TM.mrf_stage_tile(C, shapes, x.element_size())
    halo_max = max(TM.branch_halo(K, dil) for K, dil in shapes)

    def live(h, rem):
        lo = max(0, (halo_max - rem) // 8) * 8
        hi = min(window // 8, (halo_max + t_tile + rem + 7) // 8) * 8
        h = h.clone()
        h[..., :lo] = POISON
        h[..., hi:] = POISON
        return h

    out = torch.empty_like(x)
    for t0 in range(0, T, t_tile):
        g = torch.arange(t0 - halo_max, t0 - halo_max + window)
        inside = (g >= 0) & (g < T)
        pristine = torch.zeros(B, C, window)
        pristine[..., inside] = x[..., g[inside]].float()
        total = torch.zeros(B, C, t_tile)
        for (w1, b1, w2, b2, dil), (K, _) in zip(branches, shapes):
            xs, rem = pristine, TM.branch_halo(K, dil)
            for j, d in enumerate(dil):
                a = torch.where(inside, F.leaky_relu(xs, slope), 0.0).to(x.dtype).float()
                rem -= (K - 1) * d // 2
                h = live(F.conv1d(a, w1[j].float(), b1[j].float(), padding=(K - 1) * d // 2, dilation=d), rem)
                a = torch.where(inside, F.leaky_relu(h, slope), 0.0).to(x.dtype).float()
                rem -= (K - 1) // 2
                xs = xs + live(F.conv1d(a, w2[j].float(), b2[j].float(), padding=(K - 1) // 2), rem)
            total = total + xs[..., halo_max : halo_max + t_tile]
        n = min(t_tile, T - t0)
        out[..., t0 : t0 + n] = (total * (1.0 / len(branches)))[..., :n].to(x.dtype)
    return out


@pytest.mark.parametrize(
    "C,T",
    [(16, 137), (16, 2000), (32, 1000), (64, 50), (64, 300)],
    ids=["c16_below_tile", "c16_not_multiple", "c32_not_multiple", "c64_below_tile", "c64_not_multiple"],
)
def test_stage_kernel_tiling_emulation_matches_reference(C, T):
    """T below one tile and not a multiple of it: the tiles at t=0 and t=T
    see zero padding at every conv of every branch."""
    x, branches = _to_torch(*_stage(C, T, PRODUCTION_BRANCHES, seed=C + T, B=1))
    got = _stage_emulation(x, branches)
    np.testing.assert_allclose(got.numpy(), TM.mrf_stage_reference(x, branches).numpy(), **F32_TOL)


def test_stage_kernel_tiling_emulation_bf16():
    """In bf16 the emulation rounds the same operands as the plain version;
    the f32 sums differ in order, so the one final rounding may differ by a
    bf16 ulp of the O(1) outputs."""
    x, branches = _to_torch(*_stage(64, 300, PRODUCTION_BRANCHES, seed=11, B=1), torch.bfloat16)
    got = _stage_emulation(x, branches)
    want = TM.mrf_stage_reference(x, branches)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=2e-2, rtol=0)


@pytest.mark.parametrize("C", [16, 32, 64])
def test_stage_tile_fits_the_production_stages(C):
    for itemsize in (2, 4):
        t_tile, window, shared = TM.mrf_stage_tile(C, PRODUCTION_BRANCHES, itemsize)
        assert window == TM.WINDOW_ELEMS // C and t_tile == window - 2 * 60 and t_tile >= 32
        assert shared <= TM.MAX_SHARED_BYTES
        assert TM.mrf_stage_fits(C, PRODUCTION_BRANCHES, itemsize)
    # K2 plans its own bf16 block (csrc/mrf_branch.cu): a window of 24 576 / C
    # columns, the K = 11 halo on each side; its f32 variant is K3's one-branch block
    t2, w2, s2 = TM.mrf_tile(C, 11, (1, 3, 5), 2)
    assert (t2, w2) == (TM.branch_window(C) - 120, TM.branch_window(C)) and s2 <= TM.MAX_SHARED_BYTES
    assert TM.mrf_tile(C, 11, (1, 3, 5), 4) == TM.mrf_stage_tile(C, [PRODUCTION_BRANCHES[2]], 4)


@pytest.mark.parametrize(
    "C,shapes",
    [(8, PRODUCTION_BRANCHES), (128, PRODUCTION_BRANCHES), (64, ((3, (1,)), (4, (1,)))), (64, ((3, (1,)),) * 5), (64, ((3, (1, 2, 3, 4)),))],
    ids=["c8", "c128", "even_k", "five_branches", "four_pairs"],
)
def test_stage_tile_refuses_shapes_the_kernel_does_not_take(C, shapes):
    with pytest.raises(ValueError):
        TM.mrf_stage_tile(C, shapes, 2)
    assert not TM.mrf_stage_fits(C, shapes, 2)


def test_stage_cpu_dispatch_takes_the_plain_version():
    x, branches = _to_torch(*_stage(16, 60, PRODUCTION_BRANCHES))
    before = TM.mrf_stage_kernel.launches
    torch.testing.assert_close(TM.mrf_stage(x, branches), TM.mrf_stage_reference(x, branches), rtol=0, atol=0)
    assert TM.mrf_stage_kernel.launches == before


def test_stage_kernel_wrapper_refuses_cpu_tensors():
    x, branches = _to_torch(*_stage(16, 60, PRODUCTION_BRANCHES))
    with pytest.raises(ValueError):
        TM.mrf_stage_kernel(x, branches)


def test_stage_fusion_context_restores_the_flag():
    assert TM.MRF_STAGE_FUSION is False  # off by default, as the JAX package ships it
    with TM.mrf_stage_fusion(True):
        assert TM.MRF_STAGE_FUSION is True
        with TM.mrf_stage_fusion(False):
            assert TM.MRF_STAGE_FUSION is False
        assert TM.MRF_STAGE_FUSION is True
    assert TM.MRF_STAGE_FUSION is False


# ---------------------------------------------------------------------------
# the generator's stage gate
# ---------------------------------------------------------------------------

GEN_KW = dict(
    model_in_dim=8,
    upsample_initial_channel=32,
    upsample_rates=(5, 4),
    upsample_kernel_sizes=(10, 8),
    resblock_kernel_sizes=(3, 7),
    resblock_dilation_sizes=((1, 3), (1, 3)),
)


@pytest.fixture(scope="module")
def generator_pair():
    """The JAX generator (init, then every tensor refilled with seeded values
    so each matters) and the port's on the same weights."""
    cfg = jax_hifigan.HifiGanConfig(**GEN_KW)
    gen = jax_hifigan.HifiGanGenerator(cfg, policy=JAX_FLOAT32)
    variables = gen.init(jax.random.key(0), jnp.zeros((1, 4, 8), jnp.float32))
    rng = np.random.default_rng(0)

    def fill(a):
        a = np.asarray(a, np.float32)
        std = 0.1 if a.ndim == 1 else 1.0 / np.sqrt(np.prod(a.shape[:-1]))
        return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * std)

    params = jax.tree_util.tree_map(fill, variables["params"])
    port = torch_hifigan.HifiGanGenerator(torch_hifigan.HifiGanConfig(**GEN_KW), FLOAT32)
    port.load_state_dict(hifigan_generator_state_dict(params))
    return cfg, params, port.eval()


def test_generator_stage_fusion_matches_jax_fused_generator(generator_pair):
    """Stage fusion on for both: the JAX package's fused generator (its stage
    kernel in interpret mode) and the port's (the C = 16 stage through
    mrf_stage; C = 8 is not a kernel width and keeps the per-branch route)."""
    cfg, params, port = generator_pair
    assert port.stage_eligible == (True, False)
    mel = np.random.default_rng(9).standard_normal((2, 12, 8)).astype(np.float32)
    with JM.mrf_stage_fusion(True):
        theirs = jax_hifigan.generator_apply_fused(
            params, cfg, jnp.asarray(mel), compute_dtype=jnp.float32, force_fused=True, interpret=True, mrf_fold=1
        )
    with TM.mrf_stage_fusion(True), torch.no_grad():
        ours = port(torch.from_numpy(mel))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **F32_TOL)


def test_generator_stage_fusion_on_equals_off(generator_pair):
    _, _, port = generator_pair
    mel = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 17, 8)).astype(np.float32))
    calls = []
    original = TM.mrf_stage_reference

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return original(*args, **kwargs)

    with torch.no_grad():
        off = port(mel)
        TM.mrf_stage_reference = counting
        try:
            with TM.mrf_stage_fusion(True):
                on = port(mel)
        finally:
            TM.mrf_stage_reference = original
    assert len(calls) == 1 and calls[0][1] == 16  # the one narrow stage a kernel width, C = 16
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("policy", [BF16_INFERENCE, FLOAT32], ids=["bf16", "f32"])
def test_gate_takes_the_three_narrow_production_stages(policy):
    """configs/resynth: stages of C = 256, 128 (plain convs) and 64, 32, 16 (K3)."""
    gen = torch_hifigan.HifiGanGenerator(torch_hifigan.HifiGanConfig(), policy)
    assert gen.stage_eligible == (False, False, True, True, True)
    itemsize = torch.empty((), dtype=policy.compute_dtype).element_size()
    for C in (512, 256, 128):
        assert not torch_hifigan.stage_fusion_eligible(C, (3, 7, 11), ((1, 3, 5),) * 3, itemsize)
    assert not torch_hifigan.stage_fusion_eligible(64, (3, 8, 11), ((1, 3, 5),) * 3, itemsize)
