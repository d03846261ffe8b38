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


POISON = 1e3  # what the emulation leaves in columns a conv skips or a branch never loads: any leak into the outputs shows


def _stage_emulation(x, branches, t_tile=None, slope=TM.LRELU_SLOPE):
    """K3's bf16 block (csrc/mrf_block.cuh) in torch at a tile of ``t_tile``
    columns (the widest, ``mrf_stage_tile``'s, when None; the C entry plans
    narrower ones for small grids): per time tile a window of t_tile +
    2*halo_max columns, an f32 residual and a conv operand rounded to x's
    dtype, zero outside [0, T). Each branch re-reads only its own columns
    [halo_max - halo_b, halo_max + t_tile + halo_b) of the pristine input;
    the rest of the window keeps what the branch before left there (poison
    before the first). Each conv computes only its 64-column M tiles from the
    first column the tile still needs (halo_max - the pads of the branch's
    convs after it), the last tile no further than the window's end, and
    every column it skips is poisoned. The tile's columns of each branch
    output go into the sum (set by the first branch, added to by the next),
    and the last branch's output is added to the sum, multiplied by 1/n and
    rounded once. The arithmetic is f64 on operands rounded to x's dtype, as
    in ``_plain_stage_f64``."""
    B, C, T = x.shape
    shapes = [(w1.shape[-1], tuple(dil)) for w1, _, _, _, dil in branches]
    t_max, widest, _ = TM.mrf_stage_tile(C, shapes, 2)
    t_tile = t_max if t_tile is None else t_tile
    halo = max(TM.branch_halo(K, dil) for K, dil in shapes)
    window = t_tile + 2 * halo
    assert TM.M_TILE <= window <= widest, "the kernel's window holds one M tile and fits its block"

    def skipped(rem):
        lo = halo - rem
        hi = min(lo + TM.M_TILE * -(-(t_tile + 2 * rem) // TM.M_TILE), window)
        cols = torch.arange(window)
        return (cols < lo) | (cols >= hi)

    def operand(v, inside):
        return torch.where(inside, F.leaky_relu(v, slope), 0.0).to(x.dtype).double()

    out = torch.empty_like(x)
    for t0 in range(0, T, t_tile):
        g = torch.arange(t0 - halo, t0 - halo + window)
        inside = (g >= 0) & (g < T)
        pristine = torch.zeros(B, C, window, dtype=torch.float64)
        pristine[..., inside] = x[..., g[inside]].double()
        res, act, total = torch.full_like(pristine, POISON), torch.full_like(pristine, POISON), None
        for (w1, b1, w2, b2, dil), (K, _) in zip(branches, shapes):
            rem = TM.branch_halo(K, dil)
            own = slice(halo - rem, halo + t_tile + rem)
            res, act = res.clone(), act.clone()
            res[..., own] = pristine[..., own]
            act[..., own] = operand(pristine, inside)[..., own]
            for j, d in enumerate(dil):
                rem -= (K - 1) * d // 2
                h = F.conv1d(act, w1[j].double(), b1[j].double(), padding=(K - 1) * d // 2, dilation=d)
                act = operand(h, inside).masked_fill(skipped(rem), POISON)
                rem -= (K - 1) // 2
                h = F.conv1d(act, w2[j].double(), b2[j].double(), padding=(K - 1) // 2)
                res = (res + h).masked_fill(skipped(rem), POISON)
                act = operand(res, inside).masked_fill(skipped(rem), POISON)
            branch_out = res[..., halo : halo + t_tile]
            total = branch_out if total is None else total + branch_out
        n = min(t_tile, T - t0)
        out[..., t0 : t0 + n] = (total * (1.0 / len(branches)))[..., :n].to(x.dtype)
    return out


def _plain_stage_f64(x, branches, slope=TM.LRELU_SLOPE):
    """mrf_stage_reference's arithmetic in f64: each conv's operands rounded
    to x's dtype, the chains and their sum in f64, one rounding at the end.
    The tiling emulation is held against this, not the f32 plain version: at
    C = 64 these chains reach O(40), and the f32 plain version sits up to
    3.6e-5 from f64 there (C = 64, T = 300), about twice the f32 tolerance;
    at C = 16 and 32 it sits within a quarter of it
    (``test_plain_stage_f64_is_the_plain_version``)."""
    total = None
    for w1, b1, w2, b2, dil in branches:
        K = w1.shape[-1]
        res = x.double()
        for j, d in enumerate(dil):
            a = F.leaky_relu(res, slope).to(x.dtype).double()
            h = F.conv1d(a, w1[j].double(), b1[j].double(), padding=(K - 1) * d // 2, dilation=d)
            a = F.leaky_relu(h, slope).to(x.dtype).double()
            res = res + F.conv1d(a, w2[j].double(), b2[j].double(), padding=(K - 1) // 2)
        total = res if total is None else total + res
    return (total * (1.0 / len(branches))).to(x.dtype)


@pytest.mark.parametrize(
    "C,T,B,t_tile",
    [
        (16, 137, 1, None),
        (16, 2000, 1, None),
        (32, 1000, 1, None),
        (64, 50, 1, None),
        (64, 300, 1, None),
        (64, 265, 2, None),  # one tile + 1 of the widest window (264)
        (64, 700, 1, 80),  # a narrow tile: the plan's at B = 1 on 132 SMs for a streaming window
        (16, 900, 1, 272),  # a narrow tile at C = 16, below the K = 3 branch's own width
    ],
    ids=["c16_below_tile", "c16_not_multiple", "c32_not_multiple", "c64_below_tile", "c64_not_multiple",
         "c64_tile_plus_one", "c64_narrow_tile", "c16_narrow_tile"],
)
def test_stage_kernel_tiling_emulation_matches_reference(C, T, B, t_tile):
    """T below one tile and not a multiple of it, and narrow planned tiles:
    the tiles at t=0 and t=T see zero padding at every conv of every branch,
    and neither the columns a conv skips nor those a branch does not load
    reach an output."""
    x, branches = _to_torch(*_stage(C, T, PRODUCTION_BRANCHES, seed=C + T, B=B))
    got = _stage_emulation(x, branches, t_tile)
    np.testing.assert_allclose(got.numpy(), _plain_stage_f64(x, branches).numpy(), **F32_TOL)


@pytest.mark.parametrize("C,T", [(16, 300), (32, 200)])
def test_plain_stage_f64_is_the_plain_version(C, T):
    """What the emulation is held against is ``mrf_stage_reference``'s
    arithmetic: in f32 the two agree within the f32 tolerance at widths whose
    chains stay O(1-10)."""
    x, branches = _to_torch(*_stage(C, T, PRODUCTION_BRANCHES, seed=C * T, B=2))
    np.testing.assert_allclose(_plain_stage_f64(x, branches).numpy(), TM.mrf_stage_reference(x, branches).numpy(), **F32_TOL)


def test_stage_kernel_tiling_emulation_bf16():
    """In bf16 the emulation rounds the same operands as the plain version;
    the sums differ in order, so the one final rounding may differ by a bf16
    ulp of the O(1) outputs."""
    x, branches = _to_torch(*_stage(64, 300, PRODUCTION_BRANCHES, seed=11, B=1), torch.bfloat16)
    got = _stage_emulation(x, branches)
    want = _plain_stage_f64(x, branches)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=2e-2, rtol=0)


@pytest.mark.parametrize("C", [16, 32, 64])
def test_stage_tile_fits_the_production_stages(C):
    # bf16 (csrc/mrf_block.cuh): K2's window of 24 576 / C columns, the K = 11
    # halo (60) on each side, every branch's biases; the branch sum lives in
    # device memory. f32: K3's whole-window block of 16 384 / C columns.
    t_tile, window, shared = TM.mrf_stage_tile(C, PRODUCTION_BRANCHES, 2)
    assert window == TM.branch_window(C) and t_tile == window - 2 * 60 and shared <= TM.MAX_SHARED_BYTES
    assert (t_tile, window) == TM.mrf_tile(C, 11, (1, 3, 5), 2)[:2]
    assert shared == TM.mrf_tile(C, 11, (1, 3, 5), 2)[2] + 2 * 2 * 3 * C * 4  # the other two branches' biases
    t_tile, window, shared = TM.mrf_stage_tile(C, PRODUCTION_BRANCHES, 4)
    assert window == TM.WINDOW_ELEMS // C and t_tile == window - 2 * 60 and shared <= TM.MAX_SHARED_BYTES
    for itemsize in (2, 4):
        assert TM.mrf_stage_fits(C, PRODUCTION_BRANCHES, itemsize)
    # K2's bf16 block is K3's with one branch; its f32 variant is K3's one-branch block
    assert TM.mrf_stage_tile(C, [PRODUCTION_BRANCHES[2]], 2) == TM.mrf_tile(C, 11, (1, 3, 5), 2)
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


def test_generator_lays_out_stage_weights_once_and_again_after_they_change(generator_pair):
    """With stage fusion on the generator keeps each stage's weights laid out
    for K3 (``stage_operands``) across calls, and lays them out again once a
    parameter changes in place, so the output follows the new weights."""
    _, _, port = generator_pair
    mel = torch.from_numpy(np.random.default_rng(11).standard_normal((1, 9, 8)).astype(np.float32))
    saved = {k: v.clone() for k, v in port.state_dict().items()}
    made = []
    original = TM.stage_operands

    def counting(branches):
        made.append(len(branches))
        return original(branches)

    TM.stage_operands = counting
    try:
        with TM.mrf_stage_fusion(True), torch.no_grad():
            port._stage_ops.clear()
            first, again = port(mel), port(mel)
            assert made == [2] and torch.equal(first, again)
            port.load_state_dict({k: v * 1.5 if k.startswith("resblocks") else v for k, v in saved.items()})
            changed = port(mel)
            assert made == [2, 2]
        with torch.no_grad():
            off = port(mel)
    finally:
        TM.stage_operands = original
        port.load_state_dict(saved)
    assert not torch.allclose(changed, first)
    np.testing.assert_allclose(changed.numpy(), off.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("policy", [BF16_INFERENCE, FLOAT32], ids=["bf16", "f32"])
def test_gate_takes_the_three_narrow_production_stages(policy):
    """configs/resynth: stages of C = 256, 128 (plain convs) and 64, 32, 16 (K3)."""
    gen = torch_hifigan.HifiGanGenerator(torch_hifigan.HifiGanConfig(), policy)
    assert gen.stage_eligible == (False, False, True, True, True)
    itemsize = torch.empty((), dtype=policy.compute_dtype).element_size()
    for C in (512, 256, 128):
        assert not torch_hifigan.stage_fusion_eligible(C, (3, 7, 11), ((1, 3, 5),) * 3, itemsize)
    assert not torch_hifigan.stage_fusion_eligible(64, (3, 8, 11), ((1, 3, 5),) * 3, itemsize)
