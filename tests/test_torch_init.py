"""The port's random weights against the JAX package's initializers.

For each model an entry point draws at random, the JAX package's init
(``jitted_init``, FLOAT32 policy) is carried to torch names by ``models/convert.py``
and set beside the port's ``init_random_weights`` at small widths. The draws
cannot be equal across frameworks; the distributions must be:

* the key sets are equal, and every tensor the JAX init makes constant (zeros,
  ones) is the same constant in the port;
* every random tensor of n >= 256 elements has the JAX tensor's std within
  4 / sqrt(n) + 0.02 of their ratio (the sample std's relative spread is about
  1 / sqrt(n)) and a mean within 4 * std / sqrt(n) of 0;
* where the JAX declaration truncates (``lecun_normal``, ``he_normal``: cut
  at +-2 of N(0, 1) and scaled by sqrt(scale / fan_in) / 0.8796), both sides
  stay within that cut; an untruncated draw of 256 or more elements crosses it
  almost surely (2.3 % of its elements lie past it).

``TRUNCATED`` is this file's own reading of the JAX sources: the torch names
of the truncated tensors and their scale; the JAX side is held to it too.
"""

import functools
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_resynth_tpu.core.flaxinit import jitted_init
from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.models import cfm as JC
from speech_resynth_tpu.models import hifigan as JH
from speech_resynth_tpu.models import hubert as JHu
from speech_resynth_tpu.models import llama as JL
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.models import cfm as TC
from speech_resynth_torch.models import hifigan as TH
from speech_resynth_torch.models import hubert as THu
from speech_resynth_torch.models import llama as TL
from speech_resynth_torch.models.composite import init_random_weights
from speech_resynth_torch.models.convert import (
    cfm_state_dict,
    hifigan_generator_state_dict,
    hubert_state_dict,
    llama_state_dict,
    mpd_state_dict,
    msd_state_dict,
)

MIN_ELEMENTS = 256
TRUNC = 2.0 / 0.87962566103423978  # the cut, in units of the rule's std

GEN_KW = dict(model_in_dim=8, upsample_initial_channel=32, upsample_rates=(5,), upsample_kernel_sizes=(10,),
              resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3)))
CFM_KW = dict(vocab_size=50, dim_in=8, dim_cond_emb=32, hidden_size=32, depth=2, heads=2, intermediate_size=48,
              conv_pos_embed_kernel_size=7, conv_pos_embed_groups=8, predict_duration=True, use_unet_skip_connection=True)
HUBERT_KW = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64, conv_dim=(16, 16),
                 conv_kernel=(10, 3), conv_stride=(5, 2), num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
LLAMA_KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=2)
WAVE = 324  # the discriminators' input samples

# torch names of the tensors the JAX package draws truncated, and the variance scale of each
TRUNCATED = {
    "generator": (),
    "mpd": ((r".*\.v", 2.0),),
    "msd": ((r".*\.(v|weight)", 2.0),),
    "cfm": ((r"(?!to_cond_emb\.).*\.weight", 1.0),),
    "hubert": ((r".*conv\.weight", 2.0), (r".*(proj|projection|dense)\.weight", 1.0)),
    "llama": ((r".*proj\.weight|lm_head\.weight", 1.0),),
}


def _np(sd):
    """f32 arrays (the moments are taken in f64 by ``check_distributions``)."""
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def _jax_generator_vars(normalize_before: bool):
    """The JAX generator's variables: drawn once, with ``normalize_before``;
    without it the JAX init has the same parameters (flax folds each key by
    the parameter's path) and no buffers, which only its shapes are traced for."""
    model = JH.HifiGanGenerator(JH.HifiGanConfig(**GEN_KW, normalize_before=normalize_before), JAX_FLOAT32)
    mel = jnp.zeros((1, 6, GEN_KW["model_in_dim"]))
    if normalize_before:
        return jitted_init(model, jax.random.key(0), mel)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), mel))
    drawn = _jax_generator_vars(True)
    assert set(shapes) == {"params"} and jax.tree.structure(shapes["params"]) == jax.tree.structure(drawn["params"])
    return {"params": drawn["params"]}


def _generator(normalize_before: bool):
    jvars = _jax_generator_vars(normalize_before)
    port = TH.HifiGanGenerator(TH.HifiGanConfig(**GEN_KW, normalize_before=normalize_before), FLOAT32)
    return hifigan_generator_state_dict(jvars["params"], jvars.get("buffers")), port


def _waves():
    return jnp.zeros((1, WAVE)), jnp.zeros((1, WAVE))


def _mpd():
    jvars = jitted_init(JH.MultiPeriodDiscriminator(policy=JAX_FLOAT32), jax.random.key(0), *_waves())
    return mpd_state_dict(jvars["params"]), TH.MultiPeriodDiscriminator(policy=FLOAT32)


def _msd():
    jvars = jitted_init(JH.MultiScaleDiscriminator(policy=JAX_FLOAT32), jax.random.key(0), *_waves())
    return msd_state_dict(jvars["params"], jvars["spectral"]), TH.MultiScaleDiscriminator(policy=FLOAT32)


def _cfm():
    model = JC.ConditionalFlowMatchingModel(JC.CFMConfig(**CFM_KW), policy=JAX_FLOAT32)
    ids = jnp.ones((1, 8), jnp.int32)
    jvars = jitted_init(model, {"params": jax.random.key(0)}, ids, jnp.zeros((1, 8, CFM_KW["dim_in"])), ids, rng=jax.random.key(1))
    return cfm_state_dict(jvars), TC.ConditionalFlowMatchingModel(TC.CFMConfig(**CFM_KW), FLOAT32)


def _hubert():
    jvars = jitted_init(JHu.HubertEncoder(JHu.HubertConfig(**HUBERT_KW), policy=JAX_FLOAT32), jax.random.key(0), jnp.zeros((1, 800)))
    return hubert_state_dict(jvars["params"]), THu.HubertEncoder(THu.HubertConfig(**HUBERT_KW), FLOAT32)


def _llama():
    model = JL.LlamaLM(JL.LlamaConfig(**LLAMA_KW), policy=JAX_FLOAT32, attn_implementation="xla")
    jvars = jitted_init(model, jax.random.key(0), jnp.zeros((1, 4), jnp.int32))
    return llama_state_dict(jvars["params"]), TL.LlamaLM(TL.LlamaConfig(**LLAMA_KW), FLOAT32)


MODELS = {
    "generator": lambda: _generator(False),
    "generator_normalize_before": lambda: _generator(True),
    "mpd": _mpd,
    "msd": _msd,
    "cfm": _cfm,
    "hubert": _hubert,
    "llama": _llama,
}


def _truncation_scale(model: str, name: str):
    for pattern, scale in TRUNCATED[model.replace("_normalize_before", "")]:
        if re.fullmatch(pattern, name):
            return scale
    return None


def _fan_in(shape) -> int:
    return math.prod(shape[1:])


def check_distributions(model: str, theirs: dict, ours: dict) -> list:
    """The mismatches of ``ours`` against ``theirs`` (numpy, torch names), by
    the rules of the module docstring; empty when the distributions agree."""
    bad = []
    if set(theirs) != set(ours):
        return [f"keys: only JAX {sorted(set(theirs) - set(ours))}, only port {sorted(set(ours) - set(theirs))}"]
    for name, want in theirs.items():
        got = ours[name]
        if got.shape != want.shape:
            bad.append(f"{name}: shape {got.shape} != {want.shape}")
        elif np.ptp(want) == 0 and (want.size > 1 or want.flat[0] in (0.0, 1.0)):  # a one-element draw is no constant
            if not np.array_equal(got, want):
                bad.append(f"{name}: JAX's constant {want.flat[0]}, port's in [{got.min()}, {got.max()}]")
        elif want.size >= MIN_ELEMENTS:
            n = want.size
            s_want, s_got = want.std(dtype=np.float64), got.std(dtype=np.float64)
            if abs(s_got / s_want - 1) > 4 / math.sqrt(n) + 0.02:
                bad.append(f"{name}: std {s_got:.4g}, JAX {s_want:.4g} (x{s_got / s_want:.3g})")
            mean = got.mean(dtype=np.float64)
            if abs(mean) > 4 * s_want / math.sqrt(n):
                bad.append(f"{name}: mean {mean:.3g} for std {s_want:.3g} over {n}")
            scale = _truncation_scale(model, name)
            if scale is not None:
                bound = TRUNC * math.sqrt(scale / _fan_in(want.shape)) * (1 + 1e-6)
                for side, t in (("JAX", want), ("port", got)):
                    peak = float(np.abs(t).max())
                    if peak > bound:
                        bad.append(f"{name}: {side} max |w| {peak:.4g} past the truncation at {bound:.4g}")
    return bad


@pytest.mark.parametrize("model", sorted(MODELS))
def test_random_weights_follow_the_jax_initializers(model):
    theirs, port = MODELS[model]()
    init_random_weights(port, torch.Generator().manual_seed(0))
    bad = check_distributions(model, _np(theirs), _np(port.state_dict()))
    assert not bad, "\n".join(bad)


def test_quality_run_untrained_cfm_is_a_fresh_draw():
    """The quality run's untrained CFM: its own draw of the whole model, the
    unit table by nn.Embed's default, not the trained model's table."""
    from speech_resynth_torch.pipeline import e2e_quality
    from speech_resynth_torch.train.cfm import build_model

    cfg = TC.CFMConfig(**CFM_KW)
    table = np.random.default_rng(0).standard_normal((cfg.vocab_size + 1, cfg.dim_cond_emb)).astype(np.float32)
    trained = build_model(cfg, table, FLOAT32, 0, "cpu")
    untrained = e2e_quality._untrained_cfm(trained.config, 0, "cpu")
    got = untrained.to_cond_emb.weight.detach().numpy().astype(np.float64)
    assert not np.allclose(got, table)
    n, want = got.size, 1 / math.sqrt(cfg.dim_cond_emb)
    assert abs(got.std() / want - 1) <= 4 / math.sqrt(n) + 0.02, got.std()
    assert not untrained.training and not any(p.requires_grad for p in untrained.parameters())


def _flax_layout(shape):
    """A torch (O, I, *K) shape in flax's (*K, I, O) layout."""
    return (*shape[2:], shape[1], shape[0])


@pytest.mark.parametrize("name", ["lecun_normal", "he_normal", "glorot_uniform", "normal", "embed_normal"])
def test_initializer_matches_flax(name):
    """Each of ``core.initializers``' flax initializers against flax's own on
    one (O, I, K) conv weight (a (V, F) table for the embedding's)."""
    import flax.linen as nn

    from speech_resynth_torch.core import initializers as I

    shape = (48, 40, 5) if name != "embed_normal" else (300, 24)
    theirs = {
        "lecun_normal": nn.initializers.lecun_normal(),
        "he_normal": nn.initializers.he_normal(),
        "glorot_uniform": nn.initializers.glorot_uniform(),
        "normal": nn.initializers.normal(0.01),
        "embed_normal": nn.linear.default_embed_init,
    }[name]
    ours = {"normal": I.normal(0.01)}.get(name) or getattr(I, name)()
    flax_shape = shape if name == "embed_normal" else _flax_layout(shape)
    want = np.asarray(theirs(jax.random.key(0), flax_shape, jnp.float32), np.float64)
    got = ours(shape, torch.Generator().manual_seed(0)).double().numpy()
    n = got.size
    assert got.shape == shape and got.dtype == np.float64
    assert abs(got.std() / want.std() - 1) <= 4 / math.sqrt(n) + 0.02, (got.std(), want.std())
    assert abs(got.mean()) <= 4 * want.std() / math.sqrt(n)
    # the support: the truncated normals' cut, the uniform's edge sqrt(3) std
    edge = {"lecun_normal": TRUNC, "he_normal": TRUNC * math.sqrt(2), "glorot_uniform": math.sqrt(3)}.get(name)
    if edge is not None:
        std = (1 / math.sqrt(40 * 5) if name != "glorot_uniform" else math.sqrt(2 / (40 * 5 + 48 * 5)))
        for t in (want, got):
            assert np.abs(t).max() <= edge * std * (1 + 1e-6)
        assert np.abs(got).max() > 0.9 * edge * std  # the draw reaches its edge: not a narrower one


def _generator_with_a_new_layer():
    gen = TH.HifiGanGenerator(TH.HifiGanConfig(**GEN_KW), FLOAT32)
    gen.extra = torch.nn.Conv1d(2, 2, 3)  # a layer the generator's rules do not name
    return gen


@pytest.mark.parametrize("make, error", [(lambda: torch.nn.Linear(3, 4), TypeError), (_generator_with_a_new_layer, KeyError)],
                         ids=["no_rules", "new_layer"])
def test_a_tensor_without_a_rule_raises(make, error):
    with pytest.raises(error):
        init_random_weights(make(), torch.Generator().manual_seed(0))


@pytest.fixture
def one_thread():
    """One intra-op thread for torch: the suite runs six workers on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PORT_MODELS = {
    "generator": lambda: TH.HifiGanGenerator(TH.HifiGanConfig(**GEN_KW), FLOAT32),
    "mpd": lambda: TH.MultiPeriodDiscriminator(policy=FLOAT32),
    "msd": lambda: TH.MultiScaleDiscriminator(policy=FLOAT32),
    "cfm": lambda: TC.ConditionalFlowMatchingModel(TC.CFMConfig(**CFM_KW), FLOAT32),
    "hubert": lambda: THu.HubertEncoder(THu.HubertConfig(**HUBERT_KW), FLOAT32),
    "llama": lambda: TL.LlamaLM(TL.LlamaConfig(**LLAMA_KW), FLOAT32),
}


def test_truncated_normal_is_the_inverse_cdf_of_the_generators_uniforms(one_thread):
    """``truncated_normal_`` at a fixed seed: sqrt(2) * erfinv, taken in f64,
    of the f32 uniforms that a generator of the same seed draws between the
    CDFs of -2 and 2 (as 2 * CDF - 1), and not a draw of torch's own
    ``trunc_normal_``, whose method differs between torch versions."""
    from scipy.special import erf, erfinv

    from speech_resynth_torch.core.initializers import truncated_normal_

    got = truncated_normal_(torch.empty(4096), torch.Generator().manual_seed(7)).double().numpy()
    bound = float(erf(2 / math.sqrt(2)))
    u = torch.empty(4096).uniform_(-bound, bound, generator=torch.Generator().manual_seed(7)).double().numpy()
    want = np.clip(math.sqrt(2) * erfinv(u), -2.0, 2.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert np.abs(got).max() <= 2.0 and abs(got.std() - 0.87962566103423978) < 0.03


@pytest.mark.parametrize("model", sorted(PORT_MODELS))
def test_no_init_rule_reaches_torchs_trunc_normal(model, monkeypatch, one_thread):
    """Every model's random weights are drawn without ``torch.nn.init.trunc_normal_``."""

    def refuse(*args, **kwargs):
        raise AssertionError("torch.nn.init.trunc_normal_ drew a weight")

    monkeypatch.setattr(torch.nn.init, "trunc_normal_", refuse)
    port = PORT_MODELS[model]()
    init_random_weights(port, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(t).all() for t in port.state_dict().values())
