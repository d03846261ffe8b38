"""The algorithms of the redesigned K1 and K4 kernels, emulated on the CPU.

The CUDA kernels cannot run here. These tests run their arithmetic in torch,
at small sizes, on inputs made with numpy from a seed:

- K1 (csrc/flash_attention.cu): each 64-query block visits only the key
  tiles that ``attention.key_tiles`` lists (the host mirror of the kernel's
  ``build_tile_list``), with the online softmax in log2 units as the kernel
  runs it. Held against ``attention_reference`` (f32, atol/rtol 1e-5: the
  same formulas in another summation order), against the same emulation
  visiting every tile (1e-6: a skipped tile contributes exactly 0, so the two
  differ by nothing but rounding), and against the JAX package.
- K4 (csrc/codebook.cu): split TF32 (3xTF32) scores, rounded as PTX
  ``cvt.rna.tf32.f32`` rounds, held against the f32 references of both
  packages under the clear-frame rule of tests/test_torch_cuda.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_resynth_tpu.ops import attention as JA
from speech_resynth_tpu.ops import codebook as JC
from speech_resynth_torch.ops import attention as TA
from speech_resynth_torch.ops import codebook as TC

ATT_TOL = dict(rtol=1e-5, atol=1e-5)
LOG2E = 1.4426950408889634

# ---------------------------------------------------------------------------
# K1: tile list and skipping
# ---------------------------------------------------------------------------


def _flash_tile_emulation(q, k, v, mask, causal, bq=64, bk=64, skip=True):
    """The bf16 kernel's algorithm in f32 torch: per batch row and block of
    ``bq`` queries, the key tiles ``key_tiles`` lists, grouped into tiles of
    ``bk`` keys (all of them when ``skip`` is False); scores in log2 units (scale * log2 e), masked keys at
    NEG_INF, keys past N_k at -inf, p = 2^(s - m)."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    n_tiles = -(-Nk // bk)
    c = LOG2E / math.sqrt(D)
    offset = Nk - Nq
    out = torch.empty(B, H, Nq, D)
    for b in range(B):
        row = None if mask is None else mask[b]
        for q0 in range(0, Nq, bq):
            qi = torch.arange(q0, min(q0 + bq, Nq))
            tiles = range(n_tiles)
            if skip:  # the tiles of bk keys that hold a listed 64-key tile: each one with a valid allowed key
                tiles = sorted({t * TA.KEY_TILE // bk for t in TA.key_tiles(row, Nq, Nk, q0, bq, causal)})
            m = torch.full((H, len(qi)), TA.NEG_INF)
            l = torch.zeros(H, len(qi))
            acc = torch.zeros(H, len(qi), D)
            for t in tiles:
                kj = torch.arange(t * bk, (t + 1) * bk)
                inside = kj < Nk
                kt, vt = torch.zeros(H, bk, D), torch.zeros(H, bk, D)
                kt[:, inside], vt[:, inside] = k[b][:, kj[inside]], v[b][:, kj[inside]]
                s = torch.einsum("hqd,hkd->hqk", q[b][:, qi], kt) * c
                masked = torch.zeros(len(qi), bk, dtype=torch.bool)
                if row is not None:
                    masked[:, inside] = ~row[kj[inside]]
                if causal:
                    masked = masked | (kj[None, :] > qi[:, None] + offset)
                s = s.masked_fill(masked, TA.NEG_INF).masked_fill(~inside, float("-inf"))
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp2(s - m_new[..., None])
                alpha = torch.exp2(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum("hqk,hkd->hqd", p, vt)
                m = m_new
            out[b][:, qi] = acc / l.clamp_min(1e-30)[..., None]
    return out


def _skip_case(case, seed=0):
    """(q, k, v, mask, causal) as numpy arrays: B = 3, H = 2, D = 64."""
    Nq, Nk = (150, 260) if case == "causal_q_shorter" else (200, 200)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, 2, Nq, 64)).astype(np.float32)
    k = rng.standard_normal((3, 2, Nk, 64)).astype(np.float32)
    v = rng.standard_normal((3, 2, Nk, 64)).astype(np.float32)
    mask = np.ones((3, Nk), bool)
    causal = case.startswith("causal")
    if case in ("prefix", "causal_right_padding", "causal_q_shorter"):
        mask[1, 130:] = False
        mask[2, 61:] = False
    elif case == "holes":  # valid runs with whole masked tiles between them: not a prefix
        mask[1, 64:192] = False
        mask[2, 10:150] = False
        mask[2, 170:180] = False
    elif case == "fully_masked_row":
        mask[1, 90:] = False
        mask[2] = False
    elif case == "causal_left_padding":  # the first queries of rows 1 and 2 see only masked keys
        mask[1, :70] = False
        mask[2, :140] = False
    return q, k, v, mask, causal


SKIP_CASES = [
    "prefix",
    "holes",
    "fully_masked_row",
    "causal_right_padding",
    "causal_left_padding",
    "causal_q_shorter",
]


@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("case", SKIP_CASES)
def test_flash_tile_skipping_emulation_matches_reference(case, bk):
    """Visiting only the listed tiles gives the plain version's output, and
    the visit-everything emulation's to 1e-6."""
    q, k, v, mask, causal = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in _skip_case(case))
    skipped = _flash_tile_emulation(q, k, v, mask, causal, bk=bk)
    every = _flash_tile_emulation(q, k, v, mask, causal, bk=bk, skip=False)
    want = TA.attention_reference(q, k, v, mask, causal)
    np.testing.assert_allclose(skipped.numpy(), want.numpy(), **ATT_TOL)
    np.testing.assert_allclose(skipped.numpy(), every.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", SKIP_CASES)
def test_flash_tile_skipping_cases_match_jax(case):
    """The same inputs through the JAX package: its attention_reference for
    every case, and its Pallas kernel in interpret mode for the causal cases
    in which every query has a valid allowed key. (Under left padding the
    Pallas kernel averages a row with no valid allowed key over the keys it
    visits and the zero padding of its key blocks, not over the N_k keys as
    both references do; the port's kernel follows the references.)"""
    q, k, v, mask, causal = _skip_case(case)
    ours = _flash_tile_emulation(*(torch.from_numpy(a) for a in (q, k, v, mask)), causal)
    theirs = JA.attention_reference(*(jnp.asarray(a) for a in (q, k, v, mask)), causal)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **ATT_TOL)
    if causal and case != "causal_left_padding":
        flash = JA._flash_forward(*(jnp.asarray(a) for a in (q, k, v, mask)), causal, interpret=True)
        np.testing.assert_allclose(ours.numpy(), np.asarray(flash), **ATT_TOL)


def test_key_tiles_lists_what_the_mask_and_the_diagonal_leave():
    """The tile list itself: live tiles only; in causal mode none past the
    block's last diagonal; every tile for a block with a query that sees no
    valid key."""
    row = torch.ones(300, dtype=torch.bool)
    row[64:192] = False
    assert TA.key_tiles(row, 300, 300, 0, 64, False) == [0, 3, 4]
    assert TA.key_tiles(row, 300, 300, 0, 64, True) == [0]
    assert TA.key_tiles(row, 300, 300, 256, 64, True) == [0, 3, 4]
    assert TA.key_tiles(row, 300, 300, 64, 64, True) == [0]  # tiles 1 and 2 hold no valid key
    assert TA.key_tiles(torch.zeros(300, dtype=torch.bool), 300, 300, 0, 64, False) == [0, 1, 2, 3, 4]
    left = torch.ones(300, dtype=torch.bool)
    left[:100] = False
    assert TA.key_tiles(left, 300, 300, 0, 64, True) == [0, 1, 2, 3, 4]  # query 0 sees only masked keys
    assert TA.key_tiles(left, 300, 300, 128, 64, True) == [1, 2]
    # shares: the serving mask keeps every tile, padding to 3x the speech keeps about a third
    full = torch.ones(2, 512, dtype=torch.bool)
    assert TA.live_tile_share(full, 2, 512, 512, False, 64) == 1.0
    padded = torch.arange(1499)[None, :] < torch.tensor([[499], [450]])
    assert abs(TA.live_tile_share(padded, 2, 1499, 1499, False, 64) - 8 / 24) < 1e-9


def test_flash_attention_refuses_more_keys_than_its_shared_memory_holds():
    """N_k past ``MAX_KEYS`` raises before any launch, with the limit in the
    message: the kernel's per-key flags would not fit in shared memory."""
    q = torch.zeros(1, 1, 1, 64)
    k = v = torch.zeros(1, 1, TA.MAX_KEYS + 1, 64)
    before = TA.flash_attention.launches
    with pytest.raises(ValueError, match=f"at most {TA.MAX_KEYS} keys"):
        TA.flash_attention(q, k, v)
    assert TA.flash_attention.launches == before


# ---------------------------------------------------------------------------
# K4: split TF32 (3xTF32)
# ---------------------------------------------------------------------------


def _tf32_rna_numpy(v: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on finite f32: round the low 13 mantissa bits to
    nearest, ties away from zero, through the int32 view."""
    bits = v.astype(np.float32).view(np.int32)
    return ((bits + np.int32(0x1000)) & np.int32(~0x1FFF)).view(np.float32)


def test_tf32_round_is_cvt_rna():
    """The port's TF32 rounding against the bit recipe, on values just below,
    at and just above a tie, of both signs, and on random values."""
    one = np.float32(1.0).view(np.int32)
    edges = np.array([one + 0x0FFF, one + 0x1000, one + 0x1001, one + 0x3000], np.int32).view(np.float32)
    values = np.concatenate([edges, -edges, np.random.default_rng(0).standard_normal(1000).astype(np.float32)])
    got = TC.tf32_round(torch.from_numpy(values)).numpy()
    np.testing.assert_array_equal(got, _tf32_rna_numpy(values))
    np.testing.assert_array_equal(got[:4], np.array([one, one + 0x2000, one + 0x2000, one + 0x4000], np.int32).view(np.float32))
    assert not (got.view(np.int32) & 0x1FFF).any()


def _scores_3xtf32(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The kernel's scores: x_lo c_hi + x_hi c_lo + x_hi c_hi (each TF32 x
    TF32 product is exact in f64), rounded to f32, less |c|^2 / 2."""
    x_hi = _tf32_rna_numpy(x)
    x_lo = _tf32_rna_numpy(x - x_hi)
    c_hi, c_lo, half = (t.numpy() for t in TC.codebook_operands(torch.from_numpy(c)))
    f64 = np.float64
    dot = x_lo.astype(f64) @ c_hi.T.astype(f64) + x_hi.astype(f64) @ c_lo.T.astype(f64) + x_hi.astype(f64) @ c_hi.T.astype(f64)
    return dot.astype(np.float32) - half


def test_3xtf32_assignment_matches_the_f32_references():
    """At D = 768: the split-TF32 scores are within 1e-5 (|best| + 1) of the
    exact scores, where plain TF32 is not; their ids equal both packages'
    f32 references on every frame whose top-2 gap exceeds 1e-3 (|best| + 1),
    and on at least 99.9% of all frames."""
    rng = np.random.default_rng(768)
    x = rng.standard_normal((1024, 768)).astype(np.float32)
    c = rng.standard_normal((512, 768)).astype(np.float32)
    exact = x.astype(np.float64) @ c.T.astype(np.float64) - 0.5 * np.sum(c.astype(np.float64) ** 2, axis=-1)
    best = exact.max(axis=-1)
    split = _scores_3xtf32(x, c)
    assert np.max(np.abs(split - exact) / (np.abs(best)[:, None] + 1)) < 1e-5
    plain_tf32 = _tf32_rna_numpy(x).astype(np.float64) @ _tf32_rna_numpy(c).T.astype(np.float64)
    assert np.max(np.abs(plain_tf32 - 0.5 * np.sum(c.astype(np.float64) ** 2, axis=-1) - exact) / (np.abs(best)[:, None] + 1)) > 1e-5

    ids = np.argmax(split, axis=-1)
    ours = TC.assign_reference(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    theirs = np.asarray(JC.assign_reference(jnp.asarray(x), jnp.asarray(c)))
    top2 = np.sort(exact, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-3 * (np.abs(top2[:, 1]) + 1)
    for ref in (ours, theirs):
        np.testing.assert_array_equal(ids[clear], ref[clear])
        assert np.mean(ids == ref) >= 0.999


def test_bf16_frames_need_no_low_half():
    """A bf16 frame widens exactly into TF32 (8 mantissa bits of 10): its low
    half is 0, so the kernel runs two products for it, not three."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(4096).astype(np.float32)).bfloat16().float()
    assert torch.equal(TC.tf32_round(x), x)


def test_codebook_operands_keep_non_finite_centers_whole():
    """A non-finite center value stays whole in c_hi with c_lo 0, so the
    kernel's products keep the f32 product's inf or NaN."""
    c = torch.from_numpy(np.random.default_rng(9).standard_normal((6, 16)).astype(np.float32))
    c[1, 3], c[4, 0], c[5, 7] = float("inf"), float("-inf"), float("nan")
    c_hi, c_lo, _ = TC.codebook_operands(c)
    finite = torch.isfinite(c)
    assert torch.equal(c_hi[~finite].isnan(), c[~finite].isnan())
    assert torch.equal(c_hi[~finite & ~c.isnan()], c[~finite & ~c.isnan()])
    assert torch.equal(c_lo[~finite], torch.zeros(int((~finite).sum())))
    torch.testing.assert_close(c_hi[finite] + c_lo[finite], c[finite], rtol=2.0**-21, atol=0)
