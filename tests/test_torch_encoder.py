"""The port's encoder path (wav -> units) against the JAX package.

Covers the k-means assignment (K4's module, against the Pallas kernel in
interpret mode and against the plain version), run-length deduplication,
the HuBERT tower (the tiny config of tests/test_hubert.py), the weights
carried across from a Flax tree and from an HF ``HubertModel``, and
``SpeechEncoder`` with and without deduplication.

Tolerances: f32 on both sides (JAX at "highest" matmul precision) with the
same formulas and another summation order; the tower's O(1) LayerNorm outputs
agree to ~2e-6, held at atol 2e-5. Unit ids are compared exactly: the random
centers leave no frame within 1e-3 of a tie at these sizes (checked below).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.models import hubert as jax_hubert
from speech_resynth_tpu.models.kmeans import KMeansQuantizer as JaxQuantizer
from speech_resynth_tpu.models.speech_encoder import SpeechEncoder as JaxSpeechEncoder
from speech_resynth_tpu.ops import codebook as jax_codebook
from speech_resynth_tpu.ops import dedup as jax_dedup
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.models import hubert as torch_hubert
from speech_resynth_torch.models import speech_encoder as torch_se
from speech_resynth_torch.models.convert import hubert_state_dict, hubert_state_dict_from_hf
from speech_resynth_torch.models.kmeans import KMeansQuantizer
from speech_resynth_torch.ops import codebook as torch_codebook
from speech_resynth_torch.ops import dedup as torch_dedup

FEAT_TOL = dict(rtol=1e-5, atol=2e-5)


def tiny_cfg():
    return jax_hubert.HubertConfig(
        hidden_size=24,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=48,
        conv_dim=(12, 12, 12),
        conv_kernel=(10, 3, 2),
        conv_stride=(5, 2, 2),
        num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4,
    )


def _port_cfg(cfg):
    return torch_hubert.HubertConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def hubert_pair():
    """A JAX tower with random weights (every tensor nonzero) and the port's copy."""
    cfg = tiny_cfg()
    enc = jax_hubert.HubertEncoder(cfg, policy=JAX_FLOAT32)
    variables = enc.init(jax.random.key(0), jnp.zeros((1, 800), jnp.float32))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a) if np.asarray(a).any() else jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.1),
        variables["params"],
    )
    port = torch_hubert.HubertEncoder(_port_cfg(cfg), FLOAT32)
    port.load_state_dict(hubert_state_dict(params))
    return cfg, enc, {"params": params}, port.eval()


def _wav(b, t, seed):
    return np.random.default_rng(seed).standard_normal((b, t)).astype(np.float32) * 0.1


# ---------------------------------------------------------------------------
# K4's module: k-means assignment
# ---------------------------------------------------------------------------


def _frames_and_centers(n, d, k, seed, duplicate=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    if duplicate:
        c[k - 1] = c[k // 3]  # the lower id must win the exact tie
        c[5] = c[2]
        x[:10] = c[2] + 0.01 * x[:10]  # frames whose nearest center is the duplicated pair
    return x, c


@pytest.mark.parametrize(
    "n,d,k,duplicate",
    [(300, 24, 130, False), (257, 32, 100, True), (64, 48, 2000, False), (5, 8, 7, True)],
)
def test_assign_matches_jax_pallas_interpret_and_reference(n, d, k, duplicate):
    """K not a multiple of 128, N not a multiple of the Pallas frame tile,
    duplicate centers (first id wins)."""
    x, c = _frames_and_centers(n, d, k, seed=n + k, duplicate=duplicate)
    pallas = np.asarray(jax_codebook.assign_pallas(jnp.asarray(x), jnp.asarray(c), interpret=True))
    reference = np.asarray(jax_codebook.assign_reference(jnp.asarray(x), jnp.asarray(c)))
    ours = torch_codebook.assign(torch.from_numpy(x), torch.from_numpy(c))
    assert ours.dtype == torch.int32 and ours.shape == (n,)
    np.testing.assert_array_equal(ours.numpy(), pallas)
    np.testing.assert_array_equal(ours.numpy(), reference)
    if duplicate:
        assert not np.any(ours.numpy() == 5) and not np.any(ours.numpy() == k - 1)
        assert np.all(ours.numpy()[:10] == 2)


def test_assign_keeps_leading_dims_and_takes_bf16_frames():
    x, c = _frames_and_centers(24, 16, 40, seed=3)
    x3 = x.reshape(2, 3, 4, 16)
    ours = torch_codebook.assign(torch.from_numpy(x3), torch.from_numpy(c))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_codebook.assign(jnp.asarray(x3), jnp.asarray(c))))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    theirs = jax_codebook.assign_reference(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jnp.asarray(c))
    np.testing.assert_array_equal(torch_codebook.assign(xb, torch.from_numpy(c)).numpy(), np.asarray(theirs))


def test_assign_kernel_refuses_cpu_tensors():
    x, c = _frames_and_centers(8, 8, 4, seed=0)
    before = torch_codebook.assign_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        torch_codebook.assign_kernel(torch.from_numpy(x), torch.from_numpy(c))
    assert torch_codebook.assign_kernel.launches == before


def test_codebook_operands_are_the_transposed_codebook_and_its_half_norms():
    """The kernel's codebook operands: its TF32 halves (K, D), each with the
    low 13 mantissa bits zero, summing back to the centers within f32's own
    rounding (2^-21 relative, the size of the dropped lo bits), and the half
    squared norms."""
    _, c = _frames_and_centers(1, 24, 130, seed=6)
    c_hi, c_lo, half_sq = torch_codebook.codebook_operands(torch.from_numpy(c))
    for t in (c_hi, c_lo):
        assert t.shape == (130, 24) and t.is_contiguous() and t.dtype == torch.float32
        assert not (t.view(torch.int32) & 0x1FFF).any()
    np.testing.assert_allclose((c_hi + c_lo).numpy(), c, rtol=2.0**-21, atol=0)
    np.testing.assert_allclose(half_sq.numpy(), 0.5 * np.sum(c.astype(np.float64) ** 2, axis=-1), rtol=1e-6)
    assert KMeansQuantizer(torch.from_numpy(c))._operands is None  # made only for a codebook on the card


def test_assign_non_finite_frames_match_jax():
    """NaN scores win (the first id), all -inf scores give id 0, and +inf at
    two centers the lower id: the argmax semantics the kernel keeps."""
    x, c = _frames_and_centers(6, 16, 130, seed=7)
    c[:, :2] = -np.abs(c[:, :2]) - 0.1
    c[40, 0] = c[77, 0] = 1.0
    x[0] = np.nan
    x[1, 3] = np.nan
    x[2] = 0.0
    x[2, 1] = np.inf
    x[3, 0] = np.inf
    ours = torch_codebook.assign(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    theirs = np.asarray(jax_codebook.assign_reference(jnp.asarray(x), jnp.asarray(c)))
    np.testing.assert_array_equal(ours, theirs)
    assert ours[:4].tolist() == [0, 0, 0, 40]


def test_quantizer_embedding_table_and_file_round_trip(tmp_path):
    c = np.random.default_rng(4).standard_normal((7, 5)).astype(np.float32)
    ours, theirs = KMeansQuantizer(torch.from_numpy(c)), JaxQuantizer(jnp.asarray(c))
    assert ours.vocab_size == theirs.vocab_size == 7
    np.testing.assert_array_equal(ours.embedding_table(), theirs.embedding_table())
    assert not ours.embedding_table()[0].any()
    ours.save(tmp_path / "c.npz")
    np.testing.assert_array_equal(JaxQuantizer.load(tmp_path / "c.npz").centers, c)
    theirs.save(tmp_path / "j.npz")
    np.save(tmp_path / "n.npy", c)
    for name in ("j.npz", "n.npy"):
        np.testing.assert_array_equal(KMeansQuantizer.load(tmp_path / name).centers.numpy(), c)


# ---------------------------------------------------------------------------
# deduplication
# ---------------------------------------------------------------------------


def _runs(b, t, seed):
    rng = np.random.default_rng(seed)
    units = rng.integers(0, 6, (b, t))
    units[:, 1::3] = units[:, ::3][:, : units[:, 1::3].shape[1]]  # plenty of runs of length 2-3
    lengths = rng.integers(0, t + 1, b)
    lengths[0], lengths[-1] = t, 0
    return units.astype(np.int32), lengths.astype(np.int32)


@pytest.mark.parametrize("t", [1, 7, 40])
def test_deduplicate_batch_matches_jax_exactly(t):
    units, lengths = _runs(5, t, seed=t)
    theirs = jax_dedup.deduplicate_batch(jnp.asarray(units), jnp.asarray(lengths))
    ours = torch_dedup.deduplicate_batch(torch.from_numpy(units), torch.from_numpy(lengths))
    for o, j in zip(ours, theirs):
        np.testing.assert_array_equal(o.numpy(), np.asarray(j))
    # durations sum to each row's valid length
    np.testing.assert_array_equal(ours[1].numpy().sum(axis=1), lengths)


@pytest.mark.parametrize("length", [None, 0, 5, 9])
def test_deduplicate_matches_jax_exactly(length):
    units = np.array([3, 3, 1, 1, 1, 2, 3, 3, 0], np.int32)
    theirs = jax_dedup.deduplicate(jnp.asarray(units), None if length is None else jnp.asarray(length))
    ours = torch_dedup.deduplicate(torch.from_numpy(units), length)
    for o, j in zip(ours, theirs):
        np.testing.assert_array_equal(o.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# HuBERT tower
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("output_layer", [None, 1])
def test_hubert_features_match_jax(hubert_pair, ragged, output_layer):
    cfg, enc, variables, port = hubert_pair
    wav = _wav(2, 800, seed=2)
    ns = np.array([800, 517]) if ragged else None
    theirs = enc.apply(variables, jnp.asarray(wav), output_layer=output_layer, num_samples=None if ns is None else jnp.asarray(ns))
    ours = port(torch.from_numpy(wav), output_layer=output_layer, num_samples=None if ns is None else torch.from_numpy(ns))
    assert ours.dtype == torch.float32 and ours.shape == theirs.shape == (2, cfg.num_frames(800), cfg.hidden_size)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), **FEAT_TOL)


def test_hubert_do_normalize_matches_jax(hubert_pair):
    cfg, _, variables, port = hubert_pair
    ncfg = dataclasses.replace(cfg, do_normalize=True)
    enc = jax_hubert.HubertEncoder(ncfg, policy=JAX_FLOAT32)
    nport = torch_hubert.HubertEncoder(_port_cfg(ncfg), FLOAT32)
    nport.load_state_dict(port.state_dict())
    wav = _wav(2, 700, seed=3) + 0.3
    ns = np.array([650, 700])
    theirs = enc.apply(variables, jnp.asarray(wav), num_samples=jnp.asarray(ns))
    ours = nport(torch.from_numpy(wav), num_samples=torch.from_numpy(ns))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), **FEAT_TOL)


def test_padded_row_equals_its_unpadded_run(hubert_pair):
    cfg, _, _, port = hubert_pair
    wav = _wav(2, 900, seed=4)
    lens = [900, 611]
    padded = port(torch.from_numpy(wav), num_samples=torch.tensor(lens)).detach().numpy()
    for b, n in enumerate(lens):
        solo = port(torch.from_numpy(wav[b : b + 1, :n])).detach().numpy()[0]
        k = cfg.num_frames(n)
        assert solo.shape[0] == k
        np.testing.assert_allclose(padded[b, :k], solo, rtol=1e-5, atol=1e-5)


def test_hubert_frame_count_math():
    cfg = torch_hubert.HubertConfig()
    assert cfg.total_stride == 320 and cfg.num_frames(16000) == 49 == jax_hubert.HubertConfig().num_frames(16000)
    assert cfg.num_frames(torch.tensor([16000, 160000])).tolist() == [49, 499]


def _hf_hubert(cfg):
    from transformers import HubertConfig as HFHubertConfig
    from transformers import HubertModel

    torch.manual_seed(0)
    model = HubertModel(
        HFHubertConfig(
            hidden_size=cfg.hidden_size,
            num_hidden_layers=cfg.num_hidden_layers,
            num_attention_heads=cfg.num_attention_heads,
            intermediate_size=cfg.intermediate_size,
            conv_dim=list(cfg.conv_dim),
            conv_kernel=list(cfg.conv_kernel),
            conv_stride=list(cfg.conv_stride),
            num_conv_pos_embeddings=cfg.num_conv_pos_embeddings,
            num_conv_pos_embedding_groups=cfg.num_conv_pos_embedding_groups,
            feat_extract_norm="group",
            conv_bias=False,
            do_stable_layer_norm=False,
            hidden_dropout=0.0,
            attention_dropout=0.0,
            feat_proj_dropout=0.0,
            layerdrop=0.0,
            attn_implementation="eager",
        )
    ).eval()
    return model


def test_hf_checkpoint_reads_like_the_jax_conversion():
    """``hubert_state_dict_from_hf`` (weight-normed positional conv folded)
    gives the tower the JAX package builds from ``hubert_params``."""
    from speech_resynth_tpu.models.convert import hubert_params

    cfg = tiny_cfg()
    hf = _hf_hubert(cfg)
    sd = hf.state_dict()
    assert any("pos_conv_embed.conv.parametrizations" in k or k.endswith("weight_g") for k in sd)
    port = torch_hubert.HubertEncoder(_port_cfg(cfg), FLOAT32)
    port.load_state_dict(hubert_state_dict_from_hf(sd))
    wav = _wav(2, 400, seed=5)
    theirs = jax_hubert.HubertEncoder(cfg, policy=JAX_FLOAT32).apply({"params": hubert_params(sd)}, jnp.asarray(wav))
    ours = port.eval()(torch.from_numpy(wav)).detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), **FEAT_TOL)
    with torch.no_grad():
        hf_out = hf(torch.from_numpy(wav)).last_hidden_state.numpy()
    np.testing.assert_allclose(ours, hf_out, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# SpeechEncoder
# ---------------------------------------------------------------------------


def _encoder_pair(hubert_pair, deduplicate, k=9):
    cfg, enc, variables, port = hubert_pair
    # few, well-separated centers: units repeat across neighbouring frames, so dedup has runs to merge
    centers = np.random.default_rng(6).standard_normal((k, cfg.hidden_size)).astype(np.float32) * 2.0
    jse = JaxSpeechEncoder(
        encoder=enc, variables=variables, quantizer=JaxQuantizer(jnp.asarray(centers)),
        output_layer=cfg.num_hidden_layers, deduplicate=deduplicate,
    )
    tse = torch_se.SpeechEncoder(
        encoder=port, quantizer=KMeansQuantizer(torch.from_numpy(centers)),
        output_layer=cfg.num_hidden_layers, deduplicate=deduplicate,
    )
    return jse, tse, centers


def _tie_margin(port, wav, ns, centers, output_layer):
    feats = port(torch.from_numpy(wav), output_layer=output_layer, num_samples=torch.from_numpy(ns)).detach()
    score = feats @ torch.from_numpy(centers).T - torch_codebook.half_sq_norms(torch.from_numpy(centers))
    top2 = score.topk(2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


@pytest.mark.parametrize("deduplicate", [False, True])
def test_speech_encoder_matches_jax(hubert_pair, deduplicate):
    jse, tse, centers = _encoder_pair(hubert_pair, deduplicate)
    wav = _wav(3, 1200, seed=7)
    lengths = np.array([1200, 830, 401])
    assert _tie_margin(tse.encoder, wav, lengths, centers, tse.output_layer) > 1e-3
    theirs = jse(wav, lengths=lengths)
    ours = tse(wav, lengths=lengths)
    for key in ("units", "durations", "num_units"):
        assert ours[key].dtype == torch.int32, key
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(theirs[key]), err_msg=key)
    if deduplicate:
        assert (ours["num_units"] < torch.tensor([hubert_pair[0].num_frames(int(n)) for n in lengths])).any()
    else:
        assert ours["num_units"].tolist() == [hubert_pair[0].num_frames(int(n)) for n in lengths]
        assert torch.equal(ours["durations"], torch.ones_like(ours["units"]))


@pytest.mark.parametrize("deduplicate", [False, True])
def test_speech_encoder_one_waveform_gives_trimmed_outputs(hubert_pair, deduplicate):
    jse, tse, _ = _encoder_pair(hubert_pair, deduplicate)
    wav = _wav(1, 700, seed=8)[0]
    theirs, ours = jse(wav), tse(wav)
    assert isinstance(ours["num_units"], int) and ours["num_units"] == int(theirs["num_units"])
    np.testing.assert_array_equal(ours["units"].numpy(), np.asarray(theirs["units"]))
    np.testing.assert_array_equal(ours["durations"].numpy(), np.asarray(theirs["durations"]))
    assert int(ours["durations"].sum()) == hubert_pair[0].num_frames(700)


def test_by_name_reads_a_checkpoint_dir_like_the_jax_package(tmp_path, monkeypatch):
    """An HF safetensors file and an npz of centers, read by both packages'
    ``by_name`` through a registry entry for the tiny config."""
    from safetensors.torch import save_file

    from speech_resynth_tpu.models import speech_encoder as jax_se

    cfg = tiny_cfg()
    hf = _hf_hubert(cfg)
    save_file({k: v.contiguous() for k, v in hf.state_dict().items()}, str(tmp_path / "tiny.safetensors"))
    centers = np.random.default_rng(9).standard_normal((6, cfg.hidden_size)).astype(np.float32)
    np.savez(tmp_path / "tiny-kmeans-6.npz", centers=centers)
    monkeypatch.setitem(jax_se.DENSE_MODELS, "tiny", {"config": cfg, "output_layer": 2})
    monkeypatch.setitem(torch_se.DENSE_MODELS, "tiny", {"config": _port_cfg(cfg), "output_layer": 2})
    theirs = jax_se.SpeechEncoder.by_name("tiny", "kmeans", 6, checkpoint_dir=str(tmp_path), policy=JAX_FLOAT32)
    ours = torch_se.SpeechEncoder.by_name("tiny", "kmeans", 6, checkpoint_dir=str(tmp_path), policy=FLOAT32, device="cpu")
    assert ours.vocab_size == 6 and ours.output_layer == 2 and ours.device.type == "cpu"
    wav = _wav(2, 900, seed=10)
    lengths = np.array([900, 640])
    assert _tie_margin(ours.encoder, wav, lengths, centers, 2) > 1e-3
    np.testing.assert_array_equal(ours(wav, lengths)["units"].numpy(), np.asarray(theirs(wav, lengths)["units"]))


def test_by_name_falls_back_to_seeded_random_weights(tmp_path, monkeypatch):
    monkeypatch.setitem(torch_se.DENSE_MODELS, "tiny", {"config": _port_cfg(tiny_cfg()), "output_layer": 1})
    with pytest.warns(UserWarning, match="RANDOMLY"):
        a = torch_se.SpeechEncoder.by_name("tiny", "kmeans", 5, checkpoint_dir=str(tmp_path), device="cpu", deduplicate=True)
    with pytest.warns(UserWarning, match="random centers"):
        b = torch_se.SpeechEncoder.by_name("tiny", "kmeans", 5, checkpoint_dir=str(tmp_path), device="cpu", deduplicate=True)
    assert a.deduplicate and a.quantizer.centers.shape == (5, 24)
    for pa, pb in zip(a.encoder.state_dict().values(), b.encoder.state_dict().values()):
        assert torch.equal(pa, pb)
    wav = _wav(1, 800, seed=11)[0]
    out = a(wav)
    assert int(out["durations"].sum()) == tiny_cfg().num_frames(800)
    assert out["units"].max() < 5
    with pytest.raises(KeyError, match="unknown dense model"):
        torch_se.SpeechEncoder.by_name("nope", device="cpu")


def test_registries_match_jax():
    from speech_resynth_tpu.models import speech_encoder as jax_se

    assert torch_se.QUANTIZERS == jax_se.QUANTIZERS
    assert {k: (dataclasses.asdict(v["config"]), v["output_layer"]) for k, v in torch_se.DENSE_MODELS.items()} == {
        k: (dataclasses.asdict(v["config"]), v["output_layer"]) for k, v in jax_se.DENSE_MODELS.items()
    }


def test_embedding_table_from_a_checkpoint_dir(tmp_path, monkeypatch):
    cfg = _port_cfg(tiny_cfg())
    monkeypatch.setitem(torch_se.DENSE_MODELS, "tiny", {"config": cfg, "output_layer": 1})
    centers = np.random.default_rng(12).standard_normal((4, cfg.hidden_size)).astype(np.float32)
    np.savez(tmp_path / "tiny-kmeans-4.npz", centers=centers)
    with pytest.warns(UserWarning, match="RANDOMLY"):
        table = torch_se.embedding("tiny", "kmeans", 4, checkpoint_dir=str(tmp_path), device="cpu")
    assert table.shape == (5, cfg.hidden_size) and not table[0].any()
    np.testing.assert_array_equal(table[1:], centers)
