"""The port's models (speech_resynth_torch.models) against the JAX package.

Weights are made by the JAX package's own init (FLOAT32 policy), every
zero-initialised tensor is then filled with small random values so that each
parameter matters, and the trees are carried across with the port's
``models/convert.py``. Inputs and ODE noise are made with numpy from a seed.

Tolerances (f32): both sides compute in f32 (JAX at "highest" matmul
precision) with the same formulas and another summation order. One
transformer pass agrees to ~1e-6 of its O(1) outputs (atol 2e-5); the ODE
compounds that over its steps (log-mels of O(10), atol 1e-4); the vocoder's
O(1) waveforms through ~20 convs, atol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_resynth_tpu.core.flaxinit import jitted_init
from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.models import cfm as jax_cfm
from speech_resynth_tpu.models import hifigan as jax_hifigan
from speech_resynth_tpu.models import transformer as jax_tr
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.models import cfm as torch_cfm
from speech_resynth_torch.models import hifigan as torch_hifigan
from speech_resynth_torch.models import transformer as torch_tr
from speech_resynth_torch.models.convert import cfm_state_dict, hifigan_generator_state_dict

TR_TOL = dict(rtol=1e-5, atol=2e-5)
MEL_TOL = dict(rtol=1e-5, atol=1e-4)
WAV_TOL = dict(rtol=1e-5, atol=2e-5)

CFM_KW = dict(
    vocab_size=20,
    dim_in=8,
    dim_cond_emb=12,
    hidden_size=16,
    depth=2,
    heads=2,
    intermediate_size=24,
    conv_pos_embed_kernel_size=7,
    conv_pos_embed_groups=16,
)
# C = 80 and 40: no width K2 takes, so both stages run the plain conv chain;
# NARROW_VOC_KW's stages (C = 32 and 16) take the fused-branch path
VOC_KW = dict(
    model_in_dim=8,
    upsample_initial_channel=160,
    upsample_rates=(5, 4),
    upsample_kernel_sizes=(10, 8),
    resblock_kernel_sizes=(3, 7),
    resblock_dilation_sizes=((1, 3, 5), (1, 3)),
)
NARROW_VOC_KW = dict(VOC_KW, upsample_initial_channel=64)


def _fill_zeros(tree, seed):
    """Replace every all-zero leaf (biases, adaptive-norm gains) by small random values."""
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a, np.float32)
        return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.1) if not a.any() else jnp.asarray(a)

    return jax.tree_util.tree_map(fill, tree)


def _jax_cfm(seed=0, **overrides):
    cfg = jax_cfm.CFMConfig(**{**CFM_KW, **overrides})
    model = jax_cfm.ConditionalFlowMatchingModel(cfg, policy=JAX_FLOAT32)
    ids = jnp.ones((1, 8), jnp.int32)
    mels = jnp.zeros((1, 8, cfg.dim_in), jnp.float32)
    variables = jitted_init(model, {"params": jax.random.key(seed)}, ids, mels, jnp.ones((1, 8), jnp.int32), rng=jax.random.key(1))
    return cfg, model, _fill_zeros(variables, seed)


def _torch_cfm(variables, **overrides):
    model = torch_cfm.ConditionalFlowMatchingModel(torch_cfm.CFMConfig(**{**CFM_KW, **overrides}), FLOAT32)
    model.load_state_dict(cfm_state_dict(variables))
    return model.eval()


@pytest.fixture(scope="module")
def cfm_pair():
    cfg, jmodel, variables = _jax_cfm()
    return cfg, jmodel, variables, _torch_cfm(variables)


@pytest.fixture(scope="module")
def vocoder_pair():
    return _vocoder_pair(VOC_KW)


@pytest.fixture(scope="module")
def narrow_vocoder_pair():
    return _vocoder_pair(NARROW_VOC_KW)


def _vocoder_pair(kw):
    cfg = jax_hifigan.HifiGanConfig(**kw)
    gen = jax_hifigan.HifiGanGenerator(cfg, policy=JAX_FLOAT32)
    variables = _fill_zeros(gen.init(jax.random.key(0), jnp.zeros((1, 6, cfg.model_in_dim))), 3)
    port = torch_hifigan.HifiGanGenerator(torch_hifigan.HifiGanConfig(**kw), FLOAT32)
    port.load_state_dict(hifigan_generator_state_dict(variables["params"]))
    return cfg, gen, variables, port.eval()


def _mask(B, N, seed=0):
    lengths = np.random.default_rng(seed).integers(N // 2, N + 1, B)
    lengths[0] = N
    return np.arange(N)[None, :] < lengths[:, None]


# ---------------------------------------------------------------------------
# transformer pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,dim", [(7, 8), (40, 128)])
def test_rotary_matches_jax(n, dim):
    pos = torch_tr.rotary_frequencies(n, dim)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jax_tr.rotary_frequencies(n, dim)), rtol=1e-6, atol=1e-6)
    t = np.random.default_rng(n).standard_normal((2, 3, n, dim)).astype(np.float32)
    ours = torch_tr.apply_rotary(pos, torch.from_numpy(t)).numpy()
    theirs = np.asarray(jax_tr.apply_rotary(jnp.asarray(np.asarray(pos)), jnp.asarray(t)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)


def test_rotary_is_half_split():
    """Dim i pairs with dim i + D/2 (not with i+1): rotating by 90 degrees maps
    (a, b) halves to (-b, a)."""
    t = torch.arange(8, dtype=torch.float32).view(1, 8)
    pos = torch.full((1, 8), np.pi / 2)
    np.testing.assert_allclose(torch_tr.apply_rotary(pos, t).numpy(), [[-4, -5, -6, -7, 0, 1, 2, 3]], atol=1e-5)


def test_adaptive_rmsnorm_is_l2_normalize_times_sqrt_d():
    rng = np.random.default_rng(0)
    d = 16
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    x[1, 2] = 0.0  # all-zero row: 1e-24 inside the rsqrt keeps it finite
    cond = rng.standard_normal((2, d)).astype(np.float32)
    w = rng.standard_normal((d, d)).astype(np.float32) * 0.1
    theirs = jax_tr.AdaptiveRMSNorm(d, JAX_FLOAT32).apply({"params": {"to_weight": jnp.asarray(w)}}, jnp.asarray(x), jnp.asarray(cond))
    norm = torch_tr.AdaptiveRMSNorm(d, FLOAT32)
    with torch.no_grad():
        norm.to_weight.weight.copy_(torch.from_numpy(w))
    ours = norm(torch.from_numpy(x), torch.from_numpy(cond)).detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), **TR_TOL)
    assert np.isfinite(ours).all() and not ours[1, 2].any()


def test_rmsnorm_eps_is_f32_eps():
    d = 16
    x = np.random.default_rng(1).standard_normal((2, 3, d)).astype(np.float32) * 1e-4  # eps matters here
    w = np.random.default_rng(2).standard_normal(d).astype(np.float32)
    theirs = jax_tr.RMSNorm(d, policy=JAX_FLOAT32).apply({"params": {"weight": jnp.asarray(w)}}, jnp.asarray(x))
    norm = torch_tr.RMSNorm(d, FLOAT32)
    assert norm.eps == float(np.finfo(np.float32).eps)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(w))
    np.testing.assert_allclose(norm(torch.from_numpy(x)).detach().numpy(), np.asarray(theirs), **TR_TOL)


def test_conv_feedforward_gate_gelu_and_masks(cfm_pair):
    """SiGLU takes the gate from the second channel half; masked frames are
    zero on the way in and after the activation."""
    cfg, jmodel, variables, port = cfm_pair
    x = np.random.default_rng(3).standard_normal((2, 9, cfg.hidden_size)).astype(np.float32)
    mask = _mask(2, 9, seed=3)
    p = variables["params"]["transformer"]["layers_0_ff"]
    jff = jax_tr.ConvFeedForward(cfg.hidden_size, cfg.intermediate_size, policy=JAX_FLOAT32)
    theirs = jff.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask))
    ours = port.transformer.layers[0][4](torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), **TR_TOL)


def test_conv_position_embed_matches_jax(cfm_pair):
    cfg, jmodel, variables, port = cfm_pair
    x = np.random.default_rng(4).standard_normal((2, 11, cfg.hidden_size)).astype(np.float32)
    mask = _mask(2, 11, seed=4)
    jpe = jax_tr.ConvPositionEmbed(cfg.hidden_size, cfg.conv_pos_embed_kernel_size, cfg.conv_pos_embed_groups, JAX_FLOAT32)
    theirs = jpe.apply({"params": variables["params"]["conv_embed"]}, jnp.asarray(x), jnp.asarray(mask))
    ours = port.conv_embed(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), **TR_TOL)
    assert not ours[~mask].any()


@pytest.mark.parametrize("unet", [False, True])
def test_transformer_matches_jax(unet):
    cfg, jmodel, variables = _jax_cfm(seed=5, depth=4, use_unet_skip_connection=unet)
    port = _torch_cfm(variables, depth=4, use_unet_skip_connection=unet)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 13, cfg.hidden_size)).astype(np.float32)
    t = rng.standard_normal((2, cfg.hidden_size)).astype(np.float32)
    mask = _mask(2, 13, seed=5)
    theirs = jmodel.apply(
        variables, jnp.asarray(x), method=lambda m, x: m.transformer(x, mask=jnp.asarray(mask), time_cond=jnp.asarray(t))
    )
    ours = port.transformer(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(t)).detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), **TR_TOL)


# ---------------------------------------------------------------------------
# CFM
# ---------------------------------------------------------------------------


def test_embedding_pad_row_reads_zero(cfm_pair):
    cfg, jmodel, variables, port = cfm_pair
    assert port.to_cond_emb.weight[0].abs().sum() > 0  # the stored row is not zero ...
    ids = torch.tensor([[3, 0, 5, 0]])
    emb = port._embed_units(ids)
    assert not emb[0, 1].any() and not emb[0, 3].any()  # ... but pad ids embed to zero
    theirs = jmodel.apply(variables, jnp.asarray(ids.numpy()), method="_embed_units")
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(theirs), rtol=0, atol=0)


def test_velocity_matches_jax_and_is_f32(cfm_pair):
    cfg, jmodel, variables, port = cfm_pair
    rng = np.random.default_rng(6)
    ids = rng.integers(1, cfg.vocab_size + 1, (2, 10))
    ids[1, 6:] = 0
    xt = rng.standard_normal((2, 10, cfg.dim_in)).astype(np.float32)
    times = np.array([0.25, 0.75], np.float32)

    def jax_velocity(m, ids, xt, times):
        return m._velocity(xt, m._embed_units(ids), times, ids != 0)

    theirs = jmodel.apply(variables, jnp.asarray(ids), jnp.asarray(xt), jnp.asarray(times), method=jax_velocity)
    tids = torch.from_numpy(ids)
    ours = port._velocity(torch.from_numpy(xt), port._embed_units(tids), torch.from_numpy(times), tids != 0)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), **TR_TOL)


@pytest.mark.parametrize("ode_method", ["euler", "midpoint"])
@pytest.mark.parametrize("dt", [0.25, 0.5])
def test_sample_matches_jax(cfm_pair, ode_method, dt):
    cfg, jmodel, variables, port = cfm_pair
    rng = np.random.default_rng(7)
    ids = rng.integers(1, cfg.vocab_size + 1, (3, 12))
    ids[1, 8:] = 0
    ids[2, 3:] = 0
    x0 = rng.standard_normal((3, 12, cfg.dim_in)).astype(np.float32) * 1.5  # truncation clips part of it
    theirs, jmask = jmodel.apply(
        variables, jnp.asarray(ids), dt=dt, truncation_value=1.0, x0=jnp.asarray(x0), ode_method=ode_method, method="sample"
    )
    ours, mask = port.sample(torch.from_numpy(ids), dt, 1.0, x0=torch.from_numpy(x0), ode_method=ode_method)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **MEL_TOL)
    assert np.all(ours.numpy()[~mask.numpy()] == np.float32(np.log(1e-5)))


@pytest.mark.parametrize("dt", [0.3, 0.4, 0.15])
def test_sample_refuses_dt_that_does_not_tile_the_interval(cfm_pair, dt):
    _, _, _, port = cfm_pair
    with pytest.raises(ValueError, match="does not divide"):
        port.sample(torch.ones(1, 4, dtype=torch.long), dt, x0=torch.zeros(1, 4, 8))


def test_sample_without_noise_source_raises(cfm_pair):
    with pytest.raises(ValueError):
        cfm_pair[3].sample(torch.ones(1, 4, dtype=torch.long), 0.5)


def test_sample_with_duration_prediction_is_not_ported_yet():
    """Duration prediction is ported now: without ``max_frames`` the sample runs
    at the largest predicted total, as the JAX package's eager apply does."""
    _, jmodel, variables = _jax_cfm(seed=2, predict_duration=True)
    port = _torch_cfm(variables, predict_duration=True)
    ids = np.array([[3, 5, 7, 9], [2, 4, 0, 0]])
    frames = int(np.asarray(jmodel.apply(variables, jnp.asarray(ids), method="predict_durations")).sum(axis=1).max())
    x0 = np.random.default_rng(3).standard_normal((2, max(frames, 1), 8)).astype(np.float32)
    theirs, jmask = jmodel.apply(variables, jnp.asarray(ids), dt=0.5, x0=jnp.asarray(x0), method="sample")
    ours, mask = port.sample(torch.from_numpy(ids), 0.5, x0=torch.from_numpy(x0))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **MEL_TOL)


def test_mel_pad_value_matches_jax():
    from speech_resynth_tpu.dsp.mel import MEL_PAD_VALUE

    assert torch_cfm.MEL_PAD_VALUE == MEL_PAD_VALUE


# ---------------------------------------------------------------------------
# HiFi-GAN generator
# ---------------------------------------------------------------------------


def test_generator_matches_jax_apply(vocoder_pair):
    cfg, gen, variables, port = vocoder_pair
    mel = np.random.default_rng(8).standard_normal((2, 9, cfg.model_in_dim)).astype(np.float32)
    theirs = gen.apply(variables, jnp.asarray(mel))
    ours = port(torch.from_numpy(mel)).detach()
    assert ours.shape == theirs.shape == (2, int(cfg.waveform_lengths(9)))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **WAV_TOL)


def _matches_jax_fused_pallas_interpret(pair):
    cfg, gen, variables, port = pair
    mel = np.random.default_rng(9).standard_normal((2, 7, cfg.model_in_dim)).astype(np.float32)
    theirs = jax_hifigan.generator_apply_fused(
        variables["params"], cfg, jnp.asarray(mel), compute_dtype=jnp.float32, force_fused=True, interpret=True
    )
    ours = port(torch.from_numpy(mel)).detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), **WAV_TOL)


def test_generator_matches_jax_fused_pallas_interpret(narrow_vocoder_pair):
    """Against the TPU path: the port's fused-branch route (mrf_branch per
    branch, then the mean) on stages K2 takes (C = 32 and 16), the JAX
    generator's narrow stages through mrf_branch_pallas (interpret)."""
    assert all(rb.fused for rb in narrow_vocoder_pair[3].resblocks)
    _matches_jax_fused_pallas_interpret(narrow_vocoder_pair)


def test_generator_plain_chain_matches_jax_fused_pallas_interpret(vocoder_pair):
    """Stages K2 does not take (C = 80 and 40) keep the port's plain conv
    chain; it matches the JAX generator's fused path there too."""
    assert not any(rb.fused for rb in vocoder_pair[3].resblocks)
    _matches_jax_fused_pallas_interpret(vocoder_pair)


def test_generator_routes_narrow_odd_stages_to_the_fused_branch(vocoder_pair):
    """A branch goes to K2 when C <= 64, K is odd and K2 takes it
    (mrf_branch_fits: C in 16, 32, 64); C = 40 is no kernel width and keeps
    the plain conv chain, as the JAX gate sends what its kernel does not take."""
    port = vocoder_pair[3]
    routes = [(rb.convs1[0].in_channels, rb.convs1[0].kernel_size[0], rb.fused) for rb in port.resblocks]
    assert routes == [(80, 3, False), (80, 7, False), (40, 3, False), (40, 7, False)]
    routes = [(rb.convs1[0].in_channels, rb.fused) for rb in torch_hifigan.HifiGanGenerator(torch_hifigan.HifiGanConfig(**NARROW_VOC_KW), FLOAT32).resblocks]
    assert routes == [(32, True), (32, True), (16, True), (16, True)]


def test_generator_normalize_before_uses_carried_stats():
    kw = dict(VOC_KW, normalize_before=True, upsample_initial_channel=32)
    cfg = jax_hifigan.HifiGanConfig(**kw)
    gen = jax_hifigan.HifiGanGenerator(cfg, policy=JAX_FLOAT32)
    variables = _fill_zeros(gen.init(jax.random.key(1), jnp.zeros((1, 6, cfg.model_in_dim))), 4)
    rng = np.random.default_rng(10)
    variables["buffers"] = {
        "mean": jnp.asarray(rng.standard_normal(cfg.model_in_dim).astype(np.float32)),
        "scale": jnp.asarray(rng.uniform(0.5, 2.0, cfg.model_in_dim).astype(np.float32)),
    }
    port = torch_hifigan.HifiGanGenerator(torch_hifigan.HifiGanConfig(**kw), FLOAT32)
    port.load_state_dict(hifigan_generator_state_dict(variables["params"], variables["buffers"]))
    mel = rng.standard_normal((1, 6, cfg.model_in_dim)).astype(np.float32)
    np.testing.assert_allclose(
        port(torch.from_numpy(mel)).detach().numpy(), np.asarray(gen.apply(variables, jnp.asarray(mel))), **WAV_TOL
    )


@pytest.mark.parametrize("frames", [1, 9, 500])
def test_waveform_lengths_match_jax(frames):
    ours = torch_hifigan.HifiGanConfig().waveform_lengths(frames)
    assert ours == int(jax_hifigan.HifiGanConfig().waveform_lengths(jnp.asarray(frames))) == (frames - 1) * 320 + 400
    assert torch_hifigan.HifiGanConfig().total_upsample == 320
    lengths = torch_hifigan.HifiGanConfig().waveform_lengths(torch.tensor([frames, 2]))
    assert lengths.tolist() == [(frames - 1) * 320 + 400, 720]


def test_hifigan_config_from_dict_matches_jax():
    d = {"upsample_rates": [4, 4], "upsample_kernel_sizes": [8, 8], "resblock_dilation_sizes": [[1, 2]], "leaky_relu_slope": 0.2}
    ours, theirs = torch_hifigan.HifiGanConfig.from_dict(d), jax_hifigan.HifiGanConfig.from_dict(d)
    assert ours.__dict__ == {k: v for k, v in theirs.__dict__.items() if k != "initializer_range"}


# ---------------------------------------------------------------------------
# weights carried across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("unet", [False, True])
def test_cfm_state_dict_covers_every_port_tensor(unet):
    _, _, variables = _jax_cfm(seed=6, depth=4, use_unet_skip_connection=unet)
    sd = cfm_state_dict(variables)
    port = torch_cfm.ConditionalFlowMatchingModel(torch_cfm.CFMConfig(**{**CFM_KW, "depth": 4, "use_unet_skip_connection": unet}))
    assert set(sd) == set(port.state_dict())
    assert "time_cond_mlp.0.weights" in sd and ("transformer.layers.3.0.weight" in sd) == unet
    np.testing.assert_array_equal(
        sd["time_cond_mlp.0.weights"].numpy(), np.asarray(variables["buffers"]["time_cond_mlp"]["fourier"]["weights"])
    )


def test_generator_state_dict_matches_jax_export(vocoder_pair):
    """The port's mapping equals the JAX package's HF export, key for key."""
    from speech_resynth_tpu.models.export import hifigan_generator_state_dict as jax_export

    _, _, variables, port = vocoder_pair
    ours = hifigan_generator_state_dict(variables["params"])
    theirs = jax_export(variables["params"])
    assert set(ours) == set(theirs) == set(port.state_dict())
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k])
