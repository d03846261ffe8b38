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
    """Every (C, K) pair of the serving path fits one block, in bf16 and f32."""
    for K in (3, 7, 11):
        for itemsize in (2, 4):
            t_tile, window, shared = TM.mrf_tile(C, K, (1, 3, 5), itemsize)
            assert t_tile >= 32 and t_tile + 2 * TM.branch_halo(K, (1, 3, 5)) == window
            assert shared <= TM.MAX_SHARED_BYTES


@pytest.mark.parametrize("C,K", [(8, 3), (128, 3), (64, 4)])
def test_mrf_tile_refuses_shapes_the_kernel_does_not_take(C, K):
    with pytest.raises(ValueError):
        TM.mrf_tile(C, K, (1, 3, 5), 2)


def _mrf_emulation(x, w1, b1, w2, b2, dilations, slope=TM.LRELU_SLOPE):
    """The CUDA kernel's tiling (csrc/fused_mrf.cu) in torch: per time tile a
    window of t_tile + 2*halo columns, every conv over the whole window with
    zero margins past its ends, conv inputs zeroed outside [0, T), and only
    the central t_tile columns written."""
    B, C, T = x.shape
    K = w1.shape[-1]
    t_tile, window, _ = TM.mrf_tile(C, K, dilations, x.element_size())
    halo = TM.branch_halo(K, dilations)
    out = torch.empty_like(x)
    for t0 in range(0, T, t_tile):
        g = torch.arange(t0 - halo, t0 - halo + window)
        inside = (g >= 0) & (g < T)
        xs = torch.zeros(B, C, window)
        xs[..., inside] = x[..., g[inside]].float()
        for j, d in enumerate(dilations):
            a = torch.where(inside, F.leaky_relu(xs, slope), 0.0).to(x.dtype).float()
            h = F.conv1d(a, w1[j].float(), b1[j].float(), padding=(K - 1) * d // 2, dilation=d)
            a = torch.where(inside, F.leaky_relu(h, slope), 0.0).to(x.dtype).float()
            xs = xs + F.conv1d(a, w2[j].float(), b2[j].float(), padding=(K - 1) // 2)
        n = min(t_tile, T - t0)
        out[..., t0 : t0 + n] = xs[..., halo : halo + n].to(x.dtype)
    return out


@pytest.mark.parametrize("C,K,T", [(16, 11, 2000), (16, 3, 300), (32, 7, 1500)])
def test_mrf_kernel_tiling_emulation_matches_reference(C, K, T):
    """T not a multiple of the tile (and T below one tile): the tiles at t=0
    and t=T see zero padding at every conv of the chain."""
    x, w1, b1, w2, b2 = _to_torch(*_branch(C, K, T, seed=C + K, B=1))
    got = _mrf_emulation(x, w1, b1, w2, b2, (1, 3, 5))
    want = TM.mrf_branch_reference(x, w1, b1, w2, b2, (1, 3, 5))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **MRF_TOL)


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

