"""The port's kernels (speech_resynth_torch.ops) against the JAX package.

K1 (flash attention) and K2 (fused MRF branch): the plain PyTorch versions
are held against the JAX references and the JAX Pallas kernels in interpret
mode, on inputs made with numpy from a seed. The CUDA kernels cannot run
here; blocked emulations of their algorithms (the same tiles, masks and edge
handling, in torch) pin the index math on the CPU, and
tests/test_torch_cuda.py holds the kernels themselves against the plain
versions on a card.

Tolerances (f32): both sides compute in f32 with the same formulas but
another summation order, so results agree to a few f32 ulps of the largest
intermediate: atol 1e-5 / rtol 1e-5 for attention (O(1) outputs), 1e-4 for
the six-conv MRF chain (O(1) values through six K*C-term sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speech_resynth_tpu.dsp import mulaw as jax_mulaw
from speech_resynth_tpu.ops import attention as JA
from speech_resynth_tpu.ops import fused_mrf as JM
from speech_resynth_tpu.pipeline.data import bucket_length as jax_bucket_length
from speech_resynth_torch.dsp import mulaw as torch_mulaw
from speech_resynth_torch.ops import attention as TA
from speech_resynth_torch.ops import fused_mrf as TM
from speech_resynth_torch.pipeline.data import bucket_length

ATT_TOL = dict(rtol=1e-5, atol=1e-5)
MRF_TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(B, H, Nq, Nk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Nq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Nk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Nk, D)).astype(np.float32)
    return q, k, v


def _mask(B, Nk, seed=1):
    lengths = np.random.default_rng(seed).integers(Nk // 2, Nk + 1, B)
    lengths[0] = Nk
    return np.arange(Nk)[None, :] < lengths[:, None]


def _both(q, k, v, mask, causal):
    ours = TA.attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), None if mask is None else torch.from_numpy(mask), causal
    )
    theirs = JA.attention_reference(*(jnp.asarray(a) for a in (q, k, v)), None if mask is None else jnp.asarray(mask), causal)
    return ours.numpy(), np.asarray(theirs)


# ---------------------------------------------------------------------------
# K1: flash attention
# ---------------------------------------------------------------------------


def test_neg_inf_is_the_reference_value():
    assert TA.NEG_INF == JA.NEG_INF
    assert np.isfinite(TA.NEG_INF)


@pytest.mark.parametrize("D", [8, 64, 128])
@pytest.mark.parametrize("mode", ["none", "padding", "causal"])
def test_attention_reference_matches_jax(D, mode):
    Nq, Nk = (24, 40) if mode == "causal" else (40, 40)
    q, k, v = _qkv(2, 2, Nq, Nk, D, seed=D)
    mask = _mask(2, Nk) if mode != "none" else None
    ours, theirs = _both(q, k, v, mask, causal=mode == "causal")
    np.testing.assert_allclose(ours, theirs, **ATT_TOL)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_dot_product_attention_cpu_matches_jax_flash_interpret(D, causal):
    """On CPU tensors the wrapper takes the plain version; it matches the
    Pallas kernel run in interpret mode (causal with q_len < k_len)."""
    Nq, Nk = (24, 40) if causal else (40, 40)
    q, k, v = _qkv(2, 2, Nq, Nk, D, seed=3)
    mask = _mask(2, Nk, seed=4)
    ours = TA.dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask), causal)
    theirs = JA._flash_forward(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask), causal, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **ATT_TOL)


def test_fully_masked_row_is_mean_of_v():
    """Finite NEG_INF: a row with every key masked is a uniform softmax over
    the N_k keys (the mean of V), never 0 or NaN."""
    q, k, v = _qkv(2, 2, 16, 16, 64, seed=5)
    mask = np.ones((2, 16), bool)
    mask[1] = False
    ours, theirs = _both(q, k, v, mask, causal=False)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours[1], np.broadcast_to(v[1].mean(axis=1, keepdims=True), ours[1].shape), **ATT_TOL)
    np.testing.assert_allclose(ours, theirs, **ATT_TOL)


def test_bf16_attention_reference_matches_jax():
    """bf16 inputs: scores in f32, probabilities rounded to bf16 before PV,
    as the JAX reference does; atol covers one bf16 rounding of O(0.3) outputs."""
    q, k, v = _qkv(2, 2, 32, 32, 64, seed=6)
    mask = _mask(2, 32)
    ours = TA.attention_reference(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), torch.from_numpy(mask))
    theirs = JA.attention_reference(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(mask))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs, np.float32), atol=8e-3, rtol=0)


def _flash_emulation(q, k, v, mask, causal, bq=64, bk=64):
    """The CUDA kernel's algorithm (csrc/flash_attention.cu) in torch: 64-query
    blocks, 64-key tiles, running max and sum in f32, masked keys at NEG_INF,
    keys past N_k at -inf (no part), causal offset N_k - N_q."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    out = torch.empty_like(q)
    scale = 1.0 / D**0.5
    for q0 in range(0, Nq, bq):
        qi = torch.arange(q0, min(q0 + bq, Nq))
        qb = q[:, :, qi]
        m = torch.full((B, H, len(qi)), TA.NEG_INF)
        l = torch.zeros(B, H, len(qi))
        acc = torch.zeros(B, H, len(qi), D)
        for k0 in range(0, Nk, bk):
            kj = torch.arange(k0, k0 + bk)
            inside = kj < Nk
            kt = torch.zeros(B, H, bk, D)
            vt = torch.zeros(B, H, bk, D)
            kt[:, :, inside], vt[:, :, inside] = k[:, :, kj[inside]], v[:, :, kj[inside]]
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kt) * scale
            masked = torch.zeros(B, 1, 1, bk, dtype=torch.bool)
            if mask is not None:
                masked[..., inside] = ~mask[:, None, None, kj[inside]]
            if causal:
                masked = masked | (kj[None, None, None, :] > qi[None, None, :, None] + (Nk - Nq))
            s = s.masked_fill(masked, TA.NEG_INF).masked_fill(~inside, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vt)
            m = m_new
        out[:, :, qi] = acc / l.clamp_min(1e-30)[..., None]
    return out


@pytest.mark.parametrize("Nq,Nk,causal", [(100, 100, False), (70, 150, True), (130, 130, False)])
def test_flash_kernel_algorithm_emulation_matches_reference(Nq, Nk, causal):
    """Tiles that end past N_k, a fully masked row and causal offsets go
    through the kernel's online softmax exactly as the plain version says."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, Nq, Nk, 64, seed=Nq))
    mask = torch.from_numpy(_mask(3, Nk, seed=Nk))
    mask[2] = False
    got = _flash_emulation(q, k, v, mask, causal)
    want = TA.attention_reference(q, k, v, mask, causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **ATT_TOL)


@pytest.mark.parametrize(
    "case",
    ["head_dim", "causal_q_longer", "dtype_mismatch", "cpu_tensor", "mask_dtype"],
)
def test_flash_attention_wrapper_refuses(case):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 16, 16, 64))
    mask = None
    causal = False
    if case == "head_dim":
        q, k, v = q[..., :8].contiguous(), k[..., :8].contiguous(), v[..., :8].contiguous()
    elif case == "causal_q_longer":
        k, v, causal = k[:, :, :8].contiguous(), v[:, :, :8].contiguous(), True
    elif case == "dtype_mismatch":
        v = v.bfloat16()
    elif case == "mask_dtype":
        mask = torch.ones(1, 16, dtype=torch.int32)
    before = TA.flash_attention.launches
    with pytest.raises(ValueError):
        TA.flash_attention(q, k, v, mask, causal)
    assert TA.flash_attention.launches == before


def test_flash_attention_wrapper_refuses_misaligned_data():
    """A contiguous view at an offset that is not a multiple of 16 bytes would
    fault the kernel's vector loads; the wrapper refuses it first."""
    q = torch.zeros(1 + 2 * 16 * 64)[1:].view(1, 2, 16, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    k = v = torch.zeros(1, 2, 16, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TA.flash_attention(q, k, v)


def test_cpu_dispatch_takes_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 16, 16, 64))
    before = TA.flash_attention.launches
    torch.testing.assert_close(TA.dot_product_attention(q, k, v), TA.attention_reference(q, k, v), rtol=0, atol=0)
    assert TA.flash_attention.launches == before


# ---------------------------------------------------------------------------
# K2: fused MRF branch
# ---------------------------------------------------------------------------


def _branch(C, K, T, pairs=3, seed=0, B=2):
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((pairs, K, C, C)).astype(np.float32) * 0.1  # JAX (pairs, K, C_in, C_out)
    b1 = rng.standard_normal((pairs, C)).astype(np.float32) * 0.01
    w2 = rng.standard_normal((pairs, K, C, C)).astype(np.float32) * 0.1
    b2 = rng.standard_normal((pairs, C)).astype(np.float32) * 0.01
    x = rng.standard_normal((B, T, C)).astype(np.float32) * 0.5  # JAX (B, T, C)
    return x, w1, b1, w2, b2


def _to_torch(x, w1, b1, w2, b2):
    """JAX (B, T, C) and (pairs, K, C_in, C_out) -> the port's (B, C, T) and (pairs, C_out, C_in, K)."""
    tx = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    tw = [torch.from_numpy(np.ascontiguousarray(w.transpose(0, 3, 2, 1))) for w in (w1, w2)]
    return tx, tw[0], torch.from_numpy(b1), tw[1], torch.from_numpy(b2)


MRF_CASES = [(8, 3, 64, (1, 3, 5)), (16, 11, 100, (1, 3, 5)), (16, 7, 37, (1, 3))]


@pytest.mark.parametrize("C,K,T,dil", MRF_CASES)
def test_mrf_reference_matches_jax_reference(C, K, T, dil):
    x, w1, b1, w2, b2 = _branch(C, K, T, pairs=len(dil))
    ours = TM.mrf_branch_reference(*_to_torch(x, w1, b1, w2, b2), dil)
    theirs = JM.mrf_branch_reference(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)), dil)
    np.testing.assert_allclose(ours.numpy().transpose(0, 2, 1), np.asarray(theirs), **MRF_TOL)


@pytest.mark.parametrize("C,K,T,dil", MRF_CASES)
def test_mrf_reference_matches_jax_pallas_interpret(C, K, T, dil):
    x, w1, b1, w2, b2 = _branch(C, K, T, pairs=len(dil), seed=1)
    ours = TM.mrf_branch(*_to_torch(x, w1, b1, w2, b2), dil)  # CPU tensors: the plain version
    theirs = JM.mrf_branch_pallas(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)), dil, t_blk=32, interpret=True)
    np.testing.assert_allclose(ours.numpy().transpose(0, 2, 1), np.asarray(theirs), **MRF_TOL)


def test_mrf_bf16_operands_match_jax_pallas_interpret():
    """bf16 operands, f32 products and f32 residual chain on both sides: the
    two differ only where an f32 sum order flips a bf16 rounding (atol 0.03
    on O(1) values, a few bf16 ulps)."""
    x, w1, b1, w2, b2 = _branch(16, 11, 100, seed=2)
    ours = TM.mrf_branch_reference(*(t.bfloat16() for t in _to_torch(x, w1, b1, w2, b2)), (1, 3, 5))
    theirs = JM.mrf_branch_pallas(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, w1, b1, w2, b2)), (1, 3, 5), t_blk=32, interpret=True
    )
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy().transpose(0, 2, 1), np.asarray(theirs, np.float32), atol=3e-2, rtol=0)


@pytest.mark.parametrize("K", [3, 7, 11])
def test_branch_halo_matches_jax(K):
    for dil in ((1, 3, 5), (1, 3), (2,)):
        assert TM.branch_halo(K, dil) == JM.branch_halo(K, dil)


@pytest.mark.parametrize("C", [16, 32, 64])
def test_mrf_tile_fits_every_serving_shape(C):
    """Every (C, K) pair of the serving path fits one block, in bf16 (K2's
    own window of 24 576 / C columns: 384 at C = 64) and in f32 (K3's
    one-branch block)."""
    for K in (3, 7, 11):
        halo = TM.branch_halo(K, (1, 3, 5))
        t_tile, window, shared = TM.mrf_tile(C, K, (1, 3, 5), 2)
        assert window == TM.branch_window(C) == 24576 // C and t_tile == window - 2 * halo >= 32
        assert shared <= TM.MAX_SHARED_BYTES
        assert TM.mrf_branch_fits(C, K, (1, 3, 5), 2) and TM.mrf_branch_fits(C, K, (1, 3, 5), 4)
        t_tile, window, shared = TM.mrf_tile(C, K, (1, 3, 5), 4)
        assert window == TM.WINDOW_ELEMS // C and t_tile == window - 2 * halo and shared <= TM.MAX_SHARED_BYTES


@pytest.mark.parametrize("C,K", [(8, 3), (128, 3), (64, 4)])
def test_mrf_tile_refuses_shapes_the_kernel_does_not_take(C, K):
    with pytest.raises(ValueError):
        TM.mrf_tile(C, K, (1, 3, 5), 2)


POISON = 1e3  # what the emulation leaves in columns a conv skips: any leak into the outputs shows


def _mrf_emulation(x, w1, b1, w2, b2, dilations, t_tile=None, slope=TM.LRELU_SLOPE):
    """K2's tiling (csrc/mrf_branch.cu) in torch at a tile of ``t_tile``
    columns (the widest, ``mrf_tile``'s, when None; the C entry plans
    narrower ones for small grids): per time tile a window of t_tile + 2*halo
    columns, an f32 residual and a conv operand rounded to x's dtype, zero
    outside [0, T); each conv computes only its 64-column M tiles from the
    first column the tile still needs (halo - the pads of the convs after
    it), the last tile no further than the window's end, and every column it
    skips is poisoned; conv1 writes lrelu(h + b1), conv2 adds into the
    residual and writes the next operand; the central t_tile columns are the
    output."""
    B, C, T = x.shape
    K = w1.shape[-1]
    halo = TM.branch_halo(K, dilations)
    t_max, widest, _ = TM.mrf_tile(C, K, dilations, x.element_size())
    t_tile = t_max if t_tile is None else t_tile
    window = t_tile + 2 * halo
    assert TM.M_TILE <= window <= widest, "the kernel's window holds one M tile and fits its block"

    def skipped(rem):
        lo = halo - rem
        hi = min(lo + TM.M_TILE * -(-(t_tile + 2 * rem) // TM.M_TILE), window)
        cols = torch.arange(window)
        return (cols < lo) | (cols >= hi)

    def operand(v, inside):
        return torch.where(inside, F.leaky_relu(v, slope), 0.0).to(x.dtype).float()

    out = torch.empty_like(x)
    for t0 in range(0, T, t_tile):
        g = torch.arange(t0 - halo, t0 - halo + window)
        inside = (g >= 0) & (g < T)
        res = torch.zeros(B, C, window)
        res[..., inside] = x[..., g[inside]].float()
        act, rem = operand(res, inside), halo
        for j, d in enumerate(dilations):
            rem -= (K - 1) * d // 2
            h = F.conv1d(act, w1[j].float(), b1[j].float(), padding=(K - 1) * d // 2, dilation=d)
            act = operand(h, inside).masked_fill(skipped(rem), POISON)
            rem -= (K - 1) // 2
            h = F.conv1d(act, w2[j].float(), b2[j].float(), padding=(K - 1) // 2)
            res = (res + h).masked_fill(skipped(rem), POISON)
            act = operand(res, inside).masked_fill(skipped(rem), POISON)
        n = min(t_tile, T - t0)
        out[..., t0 : t0 + n] = res[..., halo : halo + n].to(x.dtype)
    return out


@pytest.mark.parametrize(
    "C,K,T,B,t_tile",
    [
        (16, 11, 2000, 1, None),
        (16, 3, 300, 1, None),  # T below one tile of the widest window (1 512)
        (16, 3, 300, 1, 168),  # a narrow tile, as the plan picks for a small grid
        (32, 7, 1500, 1, None),
        (64, 11, 200, 1, None),  # T below one tile of the widest window (264)
        (64, 11, 265, 1, None),  # one tile + 1
        (64, 11, 1500, 1, 80),  # a narrow tile: the plan's at B = 1 on 132 SMs for a streaming window
        (64, 3, 1001, 2, None),
    ],
    ids=["c16_not_multiple", "c16_below_tile", "c16_narrow_tile", "c32_not_multiple", "c64_below_tile", "c64_tile_plus_one",
         "c64_small_grid", "c64_k3_odd_t"],
)
def test_mrf_kernel_tiling_emulation_matches_reference(C, K, T, B, t_tile):
    """T not a multiple of the tile (and T below one tile): the tiles at t=0
    and t=T see zero padding at every conv of the chain, and the columns a
    conv skips are never read for an output."""
    x, w1, b1, w2, b2 = _to_torch(*_branch(C, K, T, seed=C + K, B=B))
    got = _mrf_emulation(x, w1, b1, w2, b2, (1, 3, 5), t_tile)
    want = TM.mrf_branch_reference(x, w1, b1, w2, b2, (1, 3, 5))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **MRF_TOL)


def test_mrf_kernel_tiling_emulation_bf16():
    """bf16 operands: the emulation rounds the same operands as the plain
    version; the f32 sums differ in order, so the one final rounding may
    differ by a bf16 ulp of the O(1) outputs."""
    x, w1, b1, w2, b2 = _to_torch(*_branch(64, 7, 700, seed=5, B=1))
    w1, w2 = w1 * (10 / np.sqrt(64 * 7)), w2 * (10 / np.sqrt(64 * 7))  # std 1/sqrt(C K): O(1) outputs
    x, w1, b1, w2, b2 = (t.bfloat16() for t in (x, w1, b1, w2, b2))
    got = _mrf_emulation(x, w1, b1, w2, b2, (1, 3, 5))
    want = TM.mrf_branch_reference(x, w1, b1, w2, b2, (1, 3, 5))
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=2e-2, rtol=0)


def test_swizzled_taps_layout():
    """K2's B operand: tap-major, one 128-byte row per output channel, the
    row's 16-byte chunk c at c ^ (row % 8), channels past C_in unused."""
    w = torch.arange(2 * 16 * 16 * 3, dtype=torch.float32).view(2, 16, 16, 3)
    sw = TM.swizzled_taps(w)
    assert sw.shape == (2, 3, 16, 64)
    for pair, tap, co in ((0, 0, 0), (1, 2, 5), (0, 1, 11)):
        for c in range(2):  # C_in = 16: two chunks of 8
            phys = c ^ (co % 8)
            assert torch.equal(sw[pair, tap, co, 8 * phys : 8 * phys + 8], w[pair, co, 8 * c : 8 * c + 8, tap])


def test_mrf_cpu_dispatch_takes_the_plain_version():
    x, w1, b1, w2, b2 = _to_torch(*_branch(8, 3, 50))
    before = TM.mrf_branch_kernel.launches
    torch.testing.assert_close(
        TM.mrf_branch(x, w1, b1, w2, b2, (1, 3, 5)), TM.mrf_branch_reference(x, w1, b1, w2, b2, (1, 3, 5)), rtol=0, atol=0
    )
    assert TM.mrf_branch_kernel.launches == before


def test_mrf_kernel_wrapper_refuses_cpu_tensors():
    x, w1, b1, w2, b2 = _to_torch(*_branch(16, 3, 50))
    with pytest.raises(ValueError):
        TM.mrf_branch_kernel(x, w1, b1, w2, b2, (1, 3, 5))


# ---------------------------------------------------------------------------
# the dispatchers' gates: what each kernel takes, decided from shapes and
# dtypes before any launch; the rest runs the plain version, as in the JAX
# package. The gates are pure functions; the routing is checked here with
# the tensors made to look like CUDA tensors and the kernels stubbed.
# ---------------------------------------------------------------------------

from speech_resynth_tpu.ops import codebook as JC  # noqa: E402
from speech_resynth_torch.models import hifigan as torch_hifigan  # noqa: E402
from speech_resynth_torch.ops import codebook as TC  # noqa: E402


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "q_shape,k_len,mask,causal,dtype,want",
    [
        ((2, 2, 40, 8), 40, None, False, torch.float32, False),  # the --tiny CFM's head dim
        ((2, 2, 40, 64), 40, None, False, torch.bfloat16, True),
        ((2, 2, 40, 128), 40, "bool", False, torch.float32, True),
        ((2, 2, 40, 128), 40, "int", False, torch.float32, True),  # the gate passes; flash_attention raises
        ((2, 2, 48, 64), 40, None, True, torch.float32, False),  # causal q_len > k_len
        ((2, 2, 40, 64), 48, None, True, torch.float32, True),
        ((1, 1, 4, 64), TA.MAX_KEYS + 1, None, False, torch.float32, False),
        ((2, 2, 40, 64), 40, None, False, torch.float16, True),  # the gate passes; flash_attention raises
        ((2, 40, 64), 40, None, False, torch.float32, True),  # the gate passes; flash_attention raises
    ],
    ids=["d8", "d64_bf16", "d128_mask", "int_mask", "causal_q_longer", "causal_k_longer", "too_many_keys", "f16", "rank3"],
)
def test_flash_supported_gate(q_shape, k_len, mask, causal, dtype, want):
    """The gate holds only the kernel's shape limits, as the JAX dispatcher routes."""
    q = _meta(*q_shape, dtype=dtype)
    k = _meta(*q_shape[:-2], k_len, q_shape[-1], dtype=dtype)
    m = None if mask is None else _meta(q_shape[0], k_len, dtype=torch.bool if mask == "bool" else torch.int32)
    assert TA.flash_supported(q, k, m, causal) is want


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """Tensors that report is_cuda, so the dispatchers take their card branch."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


@pytest.mark.parametrize("case", ["f16", "int_mask", "rank3"])
def test_dot_product_attention_raises_past_the_gate_on_the_card(as_if_on_the_card, case):
    """A wrong dtype, mask or rank on a card-routed call raises; it never
    falls back to the plain version."""
    shape = (2, 16, 64) if case == "rank3" else (1, 2, 16, 64)
    dtype = torch.float16 if case == "f16" else torch.float32
    q, k, v = (torch.zeros(shape, dtype=dtype) for _ in range(3))
    mask = torch.ones(shape[0], 16, dtype=torch.int32) if case == "int_mask" else None
    assert TA.flash_supported(q, k, mask, False)
    with pytest.raises(ValueError):
        TA.dot_product_attention(q, k, v, mask, False)


@pytest.mark.parametrize("D,launched", [(8, 0), (64, 1)])
def test_dot_product_attention_routes_by_the_gate(as_if_on_the_card, monkeypatch, D, launched):
    calls = []
    monkeypatch.setattr(TA, "flash_attention", lambda q, k, v, mask, causal: calls.append(q.shape) or TA.attention_reference(q, k, v, mask, causal))
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 16, 16, D))
    got = TA.dot_product_attention(q, k, v, None, False)
    assert len(calls) == launched
    torch.testing.assert_close(got, TA.attention_reference(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize(
    "C,K,dil,itemsize,want",
    [(8, 3, (1, 3), 2, False), (4, 3, (1, 3), 2, False), (40, 3, (1, 3, 5), 2, False), (16, 3, (1, 3, 5), 2, True),
     (32, 7, (1, 3, 5), 4, True), (64, 11, (1, 3, 5), 2, True), (64, 4, (1, 3, 5), 2, False), (64, 3, (1, 2, 3, 4), 2, False),
     (64, 11, (13, 13, 13), 2, False)],
    ids=["c8", "c4", "c40", "c16", "c32_f32", "c64_k11", "even_k", "four_pairs", "halo_too_wide"],
)
def test_mrf_branch_fits_gate(C, K, dil, itemsize, want):
    assert TM.mrf_branch_fits(C, K, dil, itemsize) is want
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    policy = torch_hifigan.Policy(param_dtype=torch.float32, compute_dtype=dtype, output_dtype=torch.float32)
    block = torch_hifigan.ResidualBlock(C, K, dil, policy=policy)
    assert block.fused is want


def test_residual_block_off_the_gate_runs_the_plain_chain(as_if_on_the_card, monkeypatch):
    """The --tiny vocoder's C = 8 branch on the card: the plain conv chain, no K2 launch."""
    launches = []
    monkeypatch.setattr(torch_hifigan, "mrf_branch", lambda *a: launches.append(a) or TM.mrf_branch_reference(*a))
    block = torch_hifigan.ResidualBlock(8, 3, (1, 3), policy=torch_hifigan.DEFAULT)
    assert not block.fused
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 8, 30)).astype(np.float32))
    with torch.no_grad():
        y = block(x)
    assert not launches and y.shape == x.shape and torch.isfinite(y.float()).all()


@pytest.mark.parametrize("D", [12, 8])
def test_assign_pads_the_depth_to_a_multiple_of_8(as_if_on_the_card, monkeypatch, D):
    """D = 12 reaches the kernel as 16 with zero columns (assign_pallas pads
    the same way); the ids equal assign_reference's exactly."""
    rng = np.random.default_rng(D)
    x = torch.from_numpy(rng.standard_normal((2, 37, D)).astype(np.float32))
    centers = torch.from_numpy(rng.standard_normal((20, D)).astype(np.float32))
    seen = []

    def kernel(xf, c, operands=None):
        seen.append((tuple(xf.shape), tuple(c.shape)))
        return TC.assign_reference(xf, c)

    monkeypatch.setattr(TC, "assign_kernel", kernel)
    got = TC.assign(x, centers)
    assert seen == [((74, -(-D // 8) * 8), (20, -(-D // 8) * 8))]
    assert torch.equal(got, TC.assign_reference(x, centers))
    assert torch.equal(got.flatten(), torch.from_numpy(np.array(JC.assign_reference(jnp.asarray(x.numpy().reshape(-1, D).copy()), jnp.asarray(centers.numpy().copy())))).int())


def test_pad_depth_is_exact():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((50, 12)).astype(np.float32))
    centers = torch.from_numpy(rng.standard_normal((9, 12)).astype(np.float32))
    xp, cp, ops = TC.pad_depth(x, centers, TC.codebook_operands(centers))
    assert xp.shape == (50, 16) and cp.shape == (9, 16) and ops[0].shape == ops[1].shape == (9, 16)
    assert not xp[:, 12:].any() and not cp[:, 12:].any() and not ops[0][:, 12:].any() and not ops[1][:, 12:].any()
    assert torch.equal(ops[2], TC.half_sq_norms(centers))  # the true rows' norms, not the padded rows' sums
    assert torch.equal(TC.pad_depth(x, centers)[2][2], TC.half_sq_norms(centers))
    assert torch.equal(TC.assign_reference(xp, cp), TC.assign_reference(x, centers))
    assert TC.pad_depth(xp, cp)[0] is xp


# ---------------------------------------------------------------------------
# small host-side pieces of the slice
# ---------------------------------------------------------------------------


def test_mulaw_matches_jax():
    w = np.linspace(-1.2, 1.2, 2001).astype(np.float32)
    ours = torch_mulaw.mulaw_encode(torch.from_numpy(w)).numpy()
    theirs = np.asarray(jax_mulaw.mulaw_encode(jnp.asarray(w)))
    assert ours.dtype == np.uint8
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1  # a code on a rounding boundary may flip
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_allclose(torch_mulaw.mulaw_decode(codes), jax_mulaw.mulaw_decode(codes), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n,multiple,minimum", [(1, 64, 64), (64, 64, 64), (65, 64, 64), (500, 128, 128), (3, 8, 8)])
def test_bucket_length_matches_jax(n, multiple, minimum):
    assert bucket_length(n, multiple, minimum) == jax_bucket_length(n, multiple, minimum)

