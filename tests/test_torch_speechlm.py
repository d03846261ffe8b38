"""The speech-LM path of the port against the JAX package.

Covers the unit <-> unicode mapping, the BPE tokenizer (files and merges
shared with the JAX copy), the Llama LM (logits, the KV-cache path, greedy
and sampled decoding, the speculative decoders, logit filtering,
pseudo-log-prob scoring, weight conversion and the HF directory loader),
``continue_speech`` (plain and speculative), the ``generate_speechlm``
stage, and the LM stages ``encode``, ``tokenize``, ``tokenize_slm21``,
``write_scores`` and ``evaluate``, all at tiny sizes with seeded weights.

Tolerances: f32 on both sides (JAX at "highest" matmul precision), another
summation order: LM logits atol 1e-4 (O(1) logits through two layers),
scores 1e-5; waveforms as in tests/test_torch_duration.py (atol 2e-5).
Token ids and units compare exactly. The speculative sampler is held to
``sample_decode``'s distribution by total variation per position, at most
max(3 x the noise floor of two ``sample_decode`` runs, 0.06), the JAX
package's bound.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.models import cfm as jax_cfm
from speech_resynth_tpu.models import composite as jax_composite
from speech_resynth_tpu.models import export as jax_export
from speech_resynth_tpu.models import hifigan as jax_hifigan
from speech_resynth_tpu.models import hubert as jax_hubert
from speech_resynth_tpu.models import llama as JL
from speech_resynth_tpu.models import speech_encoder as jax_se
from speech_resynth_tpu.models.convert import stack_llama_layers
from speech_resynth_tpu.pipeline import data as jax_data
from speech_resynth_tpu.pipeline import generate as jax_generate
from speech_resynth_tpu.pipeline import speechlm as jax_speechlm
from speech_resynth_tpu.text import units as jax_units
from speech_resynth_tpu.tokenizers.bpe import BpeTokenizer as JaxBpe
from speech_resynth_torch.core.checkpoint import CheckpointManager
from speech_resynth_torch.core.config import config_from_dict
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.dsp import audio_io
from speech_resynth_torch.models import hubert as torch_hubert
from speech_resynth_torch.models import llama as TL
from speech_resynth_torch.models import speech_encoder as torch_se
from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan
from speech_resynth_torch.models.convert import llama_state_dict
from speech_resynth_torch.pipeline import data as torch_data
from speech_resynth_torch.pipeline import generate as torch_generate
from speech_resynth_torch.pipeline import speechlm as torch_speechlm
from speech_resynth_torch.pipeline.speechlm import load_lm_from_hf
from speech_resynth_torch.pipeline.train_loops import generate_speechlm
from speech_resynth_torch.text import units as torch_units
from speech_resynth_torch.tokenizers.bpe import BpeTokenizer

LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)
WAV_TOL = dict(rtol=1e-5, atol=2e-5)
N_UNITS = 20  # the tiny encoder's codebook
LM_KW = dict(vocab_size=40, hidden_size=32, intermediate_size=48, num_hidden_layers=2, num_attention_heads=2)


# ---------------------------------------------------------------------------
# units and BPE
# ---------------------------------------------------------------------------


def test_units_round_trip_equals_jax():
    units = list(range(0, 300, 7)) + [93, 94, 0, 1999]
    text = torch_units.units_to_unicode(units)
    assert text == jax_units.units_to_unicode(units)
    assert torch_units.unicode_to_units(text) == jax_units.unicode_to_units(text) == units
    for u in (0, 93, 94, 500):
        assert torch_units.shift_unit(u) == jax_units.shift_unit(u)
        assert torch_units.unshift_unit(torch_units.shift_unit(u)) == u
    with pytest.raises(ValueError):
        torch_units.unshift_unit(32)


def _unit_lines(n, seed):
    """Seeded deduplicated unit strings with repeated motifs, so BPE has
    pairs worth merging."""
    rng = np.random.default_rng(seed)
    motifs = [rng.integers(0, N_UNITS, 3) for _ in range(6)]
    lines = []
    for _ in range(n):
        seq = np.concatenate([motifs[i] for i in rng.integers(0, 6, 8)] + [rng.integers(0, N_UNITS, 5)])
        seq = seq[np.r_[True, seq[1:] != seq[:-1]]]
        lines.append(torch_units.units_to_unicode(seq))
    return lines


ALPHABET = torch_units.units_to_unicode(range(N_UNITS))


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    lines = _unit_lines(60, 0)
    jax_tok = JaxBpe.train(lines, 32, ALPHABET)
    port_tok = BpeTokenizer.train(lines, 32, ALPHABET)
    path = tmp_path_factory.mktemp("bpe") / "tokenizer.json"
    jax_tok.save(str(path))
    return lines, jax_tok, port_tok, path


def test_bpe_training_gives_the_jax_merges(tokenizers):
    _, jax_tok, port_tok, _ = tokenizers
    assert port_tok.vocab_size == jax_tok.vocab_size == 32
    assert port_tok.merges() == jax_tok.merges()
    assert port_tok.get_vocab() == jax_tok.get_vocab()


def test_bpe_reads_the_jax_tokenizer_file(tokenizers, tmp_path):
    lines, jax_tok, _, path = tokenizers
    loaded = BpeTokenizer.from_file(str(path))
    assert loaded.vocab_size == jax_tok.vocab_size
    for line in lines + _unit_lines(10, 1) + [""]:
        assert loaded.encode(line) == jax_tok.encode(line)
    loaded.save(str(tmp_path / "again.json"))
    assert json.loads((tmp_path / "again.json").read_text())["model"] == json.loads(path.read_text())["model"]


# ---------------------------------------------------------------------------
# Llama
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm_pair():
    """The JAX tiny LM with seeded weights (norm gains off 1; the LM head's
    pad and EOS columns zeroed, so greedy decoding runs its whole length)
    and the port's LM on the same weights."""
    cfg = JL.LlamaConfig(**LM_KW)
    jmodel = JL.LlamaLM(cfg, policy=JAX_FLOAT32, attn_implementation="xla")
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]
    rng = np.random.default_rng(1)

    def fill(path, a):
        a = np.asarray(a, np.float32)
        if a.ndim == 1:  # RMSNorm gains
            return jnp.asarray(1.0 + 0.1 * rng.standard_normal(a.shape).astype(np.float32))
        return jnp.asarray(a)

    params = jax.tree_util.tree_map_with_path(fill, params)
    head = np.array(params["lm_head"]["kernel"])
    head[:, :2] = 0.0
    params["lm_head"]["kernel"] = jnp.asarray(head)
    port = TL.LlamaLM(TL.LlamaConfig(**LM_KW), FLOAT32)
    port.load_state_dict(llama_state_dict(params))
    return cfg, jmodel, {"params": params}, port.eval()


def _tokens(seed, shape):
    """Seeded ids past the special tokens (pad 0, EOS 1)."""
    return np.random.default_rng(seed).integers(2, LM_KW["vocab_size"], shape)


def _ids(seed=0):
    """Three rows of 12, two of them padded."""
    ids = _tokens(seed, (3, 12))
    ids[1, 9:] = 0
    ids[2, 4:] = 0
    return ids


def test_logits_equal_jax(lm_pair):
    _, jmodel, variables, port = lm_pair
    ids = _ids()
    mask = ids != 0
    theirs, _ = jmodel.apply(variables, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        ours, cache = port(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    assert ours.dtype == torch.float32 and cache is None
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **LOGIT_TOL)


def test_kv_cache_decode_equals_full_forward(lm_pair):
    """Prefill of a prefix through the cache path, then one cache step per
    token: every step's logits equal the full causal forward's at that position."""
    _, _, _, port = lm_pair
    ids = torch.from_numpy(_tokens(1, (2, 10)))
    with torch.no_grad():
        full, _ = port(ids)
        cache = port.init_cache(2, 10)
        logits, cache = port(ids[:, :4], cache=cache, cache_index=0)
        steps = [logits]
        for i in range(4, 10):
            logits, cache = port(ids[:, i : i + 1], cache=cache, cache_index=i)
            steps.append(logits)
    np.testing.assert_allclose(torch.cat(steps, dim=1).numpy(), full.numpy(), rtol=1e-5, atol=1e-5)


def test_cache_path_never_launches_the_flash_path(lm_pair, monkeypatch):
    """Prefill and decode compute their scores inline; only the full forward
    goes through dot_product_attention (the flash kernel on the card)."""
    _, _, _, port = lm_pair
    calls = []
    original = TL.dot_product_attention
    monkeypatch.setattr(TL, "dot_product_attention", lambda *a, **k: calls.append(k) or original(*a, **k))
    TL.greedy_decode(port, torch.tensor([[5, 6, 7]]), 3)
    assert calls == []
    with torch.no_grad():
        port(torch.tensor([[5, 6, 7]]))
    assert calls == [{"mask": None, "causal": True, "implementation": "auto"}] * LM_KW["num_hidden_layers"]


@pytest.mark.parametrize("max_new", [1, 9])
def test_greedy_decode_equals_jax(lm_pair, max_new):
    _, jmodel, variables, port = lm_pair
    prompt = _tokens(2, (2, 5))
    theirs = np.asarray(JL.greedy_decode(jmodel, variables, jnp.asarray(prompt), max_new, 1))
    ours = TL.greedy_decode(port, torch.from_numpy(prompt), max_new, 1).numpy()
    np.testing.assert_array_equal(ours, theirs)
    assert ours.shape == (2, 5 + max_new)


def test_decode_keeps_emitting_eos_after_eos(lm_pair):
    """Take as EOS the token greedy decoding emits third in row 0: from there
    on that row emits it to the end, the other row as its logits say."""
    _, _, _, port = lm_pair
    prompt = torch.from_numpy(_tokens(3, (2, 4)))
    free = TL.greedy_decode(port, prompt, 10, eos_token_id=-1)
    eos = int(free[0, 4 + 2])
    out = TL.greedy_decode(port, prompt, 10, eos_token_id=eos)
    assert torch.equal(out[0, : 4 + 3], free[0, : 4 + 3]) and (out[0, 4 + 2 :] == eos).all()
    first = [i for i, t in enumerate(out[1, 4:].tolist()) if t == eos]
    if first:
        assert (out[1, 4 + first[0] :] == eos).all()


def test_filter_logits_equals_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 40)).astype(np.float32)
    logits[0, :5] = logits[0, 5]  # ties at the thresholds are kept
    logits[1] = np.round(logits[1])
    for top_k, top_p in ((0, 1.0), (5, 1.0), (0, 0.7), (8, 0.5), (1, 1.0), (0, 0.0), (40, 0.95)):
        theirs = np.asarray(JL._filter_logits(jnp.asarray(logits), top_k, top_p))
        ours = TL._filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
        np.testing.assert_array_equal(np.isinf(ours), np.isinf(theirs))
        np.testing.assert_allclose(ours[np.isfinite(ours)], theirs[np.isfinite(theirs)], rtol=0, atol=0)


def test_sample_decode_greedy_limits_and_reproducibility(lm_pair):
    _, _, _, port = lm_pair
    prompt = torch.from_numpy(_tokens(4, (2, 4)))
    greedy = TL.greedy_decode(port, prompt, 8)
    assert torch.equal(TL.sample_decode(port, prompt, 8, temperature=0.0), greedy)
    assert torch.equal(TL.sample_decode(port, prompt, 8, generator=torch.Generator().manual_seed(5), top_k=1), greedy)
    a = TL.sample_decode(port, prompt, 8, generator=torch.Generator().manual_seed(7), top_p=0.9)
    b = TL.sample_decode(port, prompt, 8, generator=torch.Generator().manual_seed(7), top_p=0.9)
    c = TL.sample_decode(port, prompt, 8, generator=torch.Generator().manual_seed(8), top_p=0.9)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < LM_KW["vocab_size"]


LOOKUP_PROMPTS = ([[2, 3, 4], [5, 6, 7]], [[8, 9, 10, 11, 12, 9, 10, 11]], [[2]])  # a repeated n-gram; shorter than the n-gram


@pytest.mark.parametrize("prompt", LOOKUP_PROMPTS, ids=["two_rows", "repeated_ngram", "one_token"])
def test_lookup_decode_equals_greedy_and_jax(lm_pair, prompt):
    """The same ids as the port's greedy_decode and the JAX lookup_decode,
    whatever the acceptance, n-gram and speculation depth."""
    _, jmodel, variables, port = lm_pair
    greedy = TL.greedy_decode(port, torch.tensor(prompt), 16)
    for ngram, spec in ((2, 7), (3, 4), (2, 1)):
        ours = TL.lookup_decode(port, torch.tensor(prompt), 16, ngram=ngram, spec_tokens=spec)
        theirs = np.asarray(JL.lookup_decode(jmodel, variables, jnp.asarray(prompt), 16, 1, ngram=ngram, spec_tokens=spec))
        assert torch.equal(ours, greedy), (ngram, spec)
        np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=f"ngram={ngram} spec={spec}")


def test_lookup_decode_accepts_on_cyclic_continuation(lm_pair):
    """A greedy continuation as the prompt: its tail recurs, drafts verify,
    and more than one token commits per iteration, in as many iterations as
    the JAX package takes."""
    _, jmodel, variables, port = lm_pair
    prompt = TL.greedy_decode(port, torch.tensor([[2, 3, 4]]), 24)
    assert not (prompt == 1).any()
    ours, stats = TL.lookup_decode(port, prompt, 16, return_stats=True)
    theirs, jax_stats = JL.lookup_decode(jmodel, variables, jnp.asarray(prompt.numpy()), 16, 1, return_stats=True)
    assert torch.equal(ours, TL.greedy_decode(port, prompt, 16))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert stats == jax_stats and stats["generated"] == 16
    assert stats["tokens_per_iteration"] > 1.0, stats


def test_lookup_sample_decode_greedy_limits_and_reproducibility(lm_pair):
    """temperature 0 is lookup_decode; top-k 1 is greedy through the accept,
    residual and bonus draws; one seed gives one sequence; EOS holds."""
    _, _, _, port = lm_pair
    for prompt in LOOKUP_PROMPTS[:2]:
        prompt = torch.tensor(prompt)
        greedy = TL.greedy_decode(port, prompt, 16)
        assert torch.equal(TL.lookup_sample_decode(port, prompt, 16, temperature=0.0), greedy)
        for ngram, spec in ((2, 7), (2, 3), (3, 2)):
            got = TL.lookup_sample_decode(port, prompt, 16, generator=torch.Generator().manual_seed(3), temperature=0.7,
                                          top_k=1, ngram=ngram, spec_tokens=spec)
            assert torch.equal(got, greedy), (ngram, spec)
    prompt = torch.tensor([[2, 3, 4]])
    kw = dict(temperature=1.3, top_k=8, top_p=0.9)
    a, stats = TL.lookup_sample_decode(port, prompt, 6, generator=torch.Generator().manual_seed(5), return_stats=True, **kw)
    b = TL.lookup_sample_decode(port, prompt, 6, generator=torch.Generator().manual_seed(5), **kw)
    assert torch.equal(a, b) and a.shape == (1, 9) and torch.equal(a[:, :3], prompt)
    assert int(a.min()) >= 0 and int(a.max()) < LM_KW["vocab_size"] and stats["iterations"] >= 1
    eos = int(a[0, 4])  # the second sampled token taken as EOS: from its first emission on, EOS
    c = TL.lookup_sample_decode(port, prompt, 6, eos_token_id=eos, generator=torch.Generator().manual_seed(5), **kw)
    hits = (c[0, 3:] == eos).nonzero()
    assert len(hits) and (c[0, 3 + int(hits[0]) :] == eos).all()


def _tv(a, b, t):
    ha = np.bincount(a[:, t], minlength=LM_KW["vocab_size"]) / len(a)
    hb = np.bincount(b[:, t], minlength=LM_KW["vocab_size"]) / len(b)
    return 0.5 * float(np.abs(ha - hb).sum())


TV_N, TV_T = 4096, 4
TV_PROMPT = np.tile(np.array([[2, 3, 4, 2, 3]]), (TV_N, 1))
TV_KW = dict(temperature=0.8, top_k=8, top_p=0.9)


@pytest.fixture(scope="module")
def speculative_samples(lm_pair):
    """4 096 rows of lookup_sample_decode on one prompt: four new tokens each."""
    port = lm_pair[3]
    return TL.lookup_sample_decode(port, torch.from_numpy(TV_PROMPT), TV_T, 1, torch.Generator().manual_seed(2), ngram=2,
                                   spec_tokens=3, **TV_KW).numpy()[:, TV_PROMPT.shape[1]:]


@pytest.mark.parametrize("reference", ["port", "jax"])
def test_lookup_sample_decode_matches_the_sample_decode_distribution(lm_pair, speculative_samples, reference):
    """Per-position marginals of 4 096 speculative samples against
    sample_decode's (the port's, or the JAX package's with the same
    filtering): total variation within max(3 x the noise floor, 0.06)."""
    _, jmodel, variables, port = lm_pair
    P, T, prompt, kw, got = TV_PROMPT.shape[1], TV_T, TV_PROMPT, TV_KW, speculative_samples
    if reference == "port":
        ref, ctl = (TL.sample_decode(port, torch.from_numpy(prompt), T, 1, torch.Generator().manual_seed(s), **kw).numpy()[:, P:]
                    for s in (0, 1))
    else:
        ref, ctl = (np.asarray(JL.sample_decode(jmodel, variables, jnp.asarray(prompt), T, 1, rng=jax.random.key(s), **kw))[:, P:]
                    for s in (0, 1))
    for t in range(T):
        noise, dist = _tv(ref, ctl, t), _tv(ref, got, t)
        assert dist <= max(3.0 * noise, 0.06), f"t={t}: TV(speculative, ancestral)={dist:.4f}, noise floor={noise:.4f}"


def test_lookup_sample_residual_never_draws_the_removed_draft(lm_pair, monkeypatch):
    """A rejected draft's mass is removed: log(0) stays -inf under the
    Gumbel draw (never NaN), so the replacement is never the draft. Uniforms
    of 1 - 2^-24 reject every draft and push every Gumbel term toward +inf."""
    _, _, _, port = lm_pair
    real_rand = torch.rand

    def near_one(shape, generator=None, device=None):
        return torch.full(tuple(shape), 1.0 - 2.0 ** -24, device=device)

    prompt = torch.tensor([[8, 9, 10, 11, 12, 9, 10, 11]])
    monkeypatch.setattr(torch, "rand", near_one)
    out = TL.lookup_sample_decode(port, prompt, 8, eos_token_id=-1, top_k=3, ngram=2, spec_tokens=3)
    monkeypatch.setattr(torch, "rand", real_rand)
    # the first iteration's drafts, from the prompt and the first token
    drafts = TL._propose_drafts(torch.cat([out, torch.zeros(1, 4, dtype=torch.long)], 1), 1, p=8, ngram=2, spec_tokens=3)
    assert int(out[0, 9]) != int(drafts[0, 0]) and int(out.min()) >= 0 and int(out.max()) < LM_KW["vocab_size"]


def test_sequence_pseudo_log_prob_equals_jax(lm_pair):
    _, _, _, port = lm_pair
    ids = _ids(5)
    with torch.no_grad():
        logits, _ = port(torch.from_numpy(ids), attention_mask=torch.from_numpy(ids != 0))
    theirs = np.asarray(JL.sequence_pseudo_log_prob(jnp.asarray(logits.numpy()), jnp.asarray(ids)))
    ours = TL.sequence_pseudo_log_prob(logits, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)


def test_stacked_params_convert_like_unrolled(lm_pair):
    _, _, variables, _ = lm_pair
    unrolled = llama_state_dict(variables["params"])
    stacked = llama_state_dict(stack_llama_layers(variables["params"]))
    assert unrolled.keys() == stacked.keys()
    for k in unrolled:
        assert torch.equal(unrolled[k], stacked[k])


def _export_lm(params, path):
    cfg = LM_KW
    jax_export.save_pretrained(
        path,
        jax_export.llama_state_dict(params),
        {"model_type": "llama", **cfg, "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "pad_token_id": 0, "bos_token_id": None, "eos_token_id": 1},
    )


def test_load_lm_from_hf_reads_the_jax_export(lm_pair, tmp_path):
    _, jmodel, variables, _ = lm_pair
    _export_lm(variables["params"], tmp_path / "hf")
    port = load_lm_from_hf(tmp_path / "hf", policy=FLOAT32, device="cpu")
    assert port.config == TL.LlamaConfig(**LM_KW)
    ids = _ids(6)
    theirs, _ = jmodel.apply(variables, jnp.asarray(ids), attention_mask=jnp.asarray(ids != 0))
    with torch.no_grad():
        ours, _ = port(torch.from_numpy(ids), attention_mask=torch.from_numpy(ids != 0))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **LOGIT_TOL)
    assert load_lm_from_hf(tmp_path / "hf", device="cpu").lm_head.weight.dtype == torch.bfloat16  # BF16_INFERENCE


# ---------------------------------------------------------------------------
# continuation
# ---------------------------------------------------------------------------

CFM_KW = dict(
    vocab_size=2000,
    dim_in=8,
    dim_cond_emb=12,
    hidden_size=16,
    depth=2,
    heads=2,
    intermediate_size=24,
    conv_pos_embed_kernel_size=7,
    conv_pos_embed_groups=16,
    predict_duration=True,
)
VOC_KW = dict(
    model_in_dim=8,
    upsample_initial_channel=16,
    upsample_rates=(5, 4),
    upsample_kernel_sizes=(10, 8),
    resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),),
)


@pytest.fixture(scope="module")
def decoder_pair(tmp_path_factory):
    """A duration-predicting JAX decoder with seeded weights, exported as a
    composite directory, and the port's decoder loaded from that directory."""
    dec = jax_composite.ConditionalFlowMatchingWithHifiGan.from_config(
        jax_cfm.CFMConfig(**CFM_KW), jax_hifigan.HifiGanConfig(**VOC_KW), policy=JAX_FLOAT32
    )
    rng = np.random.default_rng(2)

    def fill(a):
        a = np.asarray(a, np.float32)
        std = 0.1 if a.ndim == 1 else 1.0 / np.sqrt(np.prod(a.shape[:-1]))
        return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * std)

    mvars = dict(dec.model_variables)
    params = dict(jax.tree_util.tree_map(fill, mvars["params"]))
    emb = np.asarray(params["to_cond_emb"]["embedding"])
    params["to_cond_emb"] = {"embedding": jnp.asarray(emb / emb.std())}
    k = rng.standard_normal((3, CFM_KW["dim_cond_emb"], 1)).astype(np.float32)
    params["duration_predictor"] = {"kernel": jnp.asarray(k * 0.8 / np.sqrt(3 * 12)), "bias": jnp.asarray(np.array([1.0], np.float32))}
    mvars["params"] = params
    jdec = jax_composite.ConditionalFlowMatchingWithHifiGan(dec.model, mvars, dec.vocoder, jax.tree_util.tree_map(fill, dec.vocoder_variables))
    path = tmp_path_factory.mktemp("decoder")
    jax_export.save_composite_pretrained(path, jdec.model_variables, jdec.model.config, jdec.vocoder_variables, jdec.vocoder.config)
    return jdec, ConditionalFlowMatchingWithHifiGan.from_pretrained(path, policy=FLOAT32, device="cpu"), path


PROMPT = [3, 7, 1, 12, 4, 9, 3, 15, 0, 8, 2, 19, 5, 11, 6, 13, 2]


def test_generate_unit_continuation_equals_jax(lm_pair, tokenizers):
    _, jmodel, variables, port = lm_pair
    _, jax_tok, port_tok, _ = tokenizers
    kw = dict(max_new_tokens=12, eos_token_id=1, num_special_tokens=2, temperature=0.0)
    theirs = jax_generate.generate_unit_continuation(PROMPT, jax_tok, jmodel, variables, **kw)
    ours = torch_generate.generate_unit_continuation(PROMPT, port_tok, port, **kw)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.size > 0 and ours.min() >= 0 and ours.max() < N_UNITS


def test_continue_speech_equals_jax(lm_pair, tokenizers, decoder_pair):
    """Greedy: the units equal the JAX package's; the waveform equals its
    decoder's on the same ODE noise."""
    _, jmodel, variables, port = lm_pair
    jdec, tdec, _ = decoder_pair
    kw = dict(max_new_tokens=10, temperature=0.0)
    jax_units_out = np.concatenate([PROMPT, jax_generate.generate_unit_continuation(PROMPT, tokenizers[1], jmodel, variables, **kw)])
    ids = np.asarray(jax_units_out, np.int64)[None] + 1
    bound = tdec._duration_bound(torch.from_numpy(ids))
    x0 = np.random.default_rng(4).standard_normal((1, bound, CFM_KW["dim_in"])).astype(np.float32)
    ours = torch_generate.continue_speech(PROMPT, tokenizers[2], port, tdec, x0=torch.from_numpy(x0), **kw)
    np.testing.assert_array_equal(ours["units"], jax_units_out)
    mel, mask = jdec.model.apply(
        jdec.model_variables, jnp.asarray(ids), dt=0.0625, truncation_value=1.0, x0=jnp.asarray(x0), max_frames=bound, method="sample"
    )
    want = np.asarray(jdec.vocoder.apply(jdec.vocoder_variables, mel))[0]
    n = int(jdec.vocoder.config.waveform_lengths(int(np.asarray(mask).sum())))
    assert ours["waveform"].shape == (n,)
    np.testing.assert_allclose(ours["waveform"], want[:n], **WAV_TOL)
    assert np.abs(want[:n]).max() > 0.05


def test_speculative_continuation_equals_jax(lm_pair, tokenizers):
    """Greedy: the prompt-lookup route gives the JAX package's units, which
    are plain decoding's; sampled: one seed gives one continuation."""
    _, jmodel, variables, port = lm_pair
    _, jax_tok, port_tok, _ = tokenizers
    kw = dict(max_new_tokens=12, eos_token_id=1, num_special_tokens=2, temperature=0.0)
    theirs = jax_generate.generate_unit_continuation(PROMPT, jax_tok, jmodel, variables, speculative=True, **kw)
    ours = torch_generate.generate_unit_continuation(PROMPT, port_tok, port, speculative=True, **kw)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, torch_generate.generate_unit_continuation(PROMPT, port_tok, port, **kw))
    kw["temperature"] = 1.0
    sampled = [torch_generate.generate_unit_continuation(PROMPT, port_tok, port, speculative=True,
                                                         generator=torch.Generator().manual_seed(4), **kw) for _ in range(2)]
    np.testing.assert_array_equal(sampled[0], sampled[1])
    assert sampled[0].dtype == np.int32 and (sampled[0].size == 0 or sampled[0].max() < N_UNITS)


def test_continue_speech_speculative_equals_jax(lm_pair, tokenizers, decoder_pair):
    """continue_speech(speculative=True), greedy: the JAX package's units and
    its decoder's waveform on the same ODE noise."""
    _, jmodel, variables, port = lm_pair
    jdec, tdec, _ = decoder_pair
    kw = dict(max_new_tokens=10, temperature=0.0, speculative=True)
    jax_units_out = np.concatenate([PROMPT, jax_generate.generate_unit_continuation(PROMPT, tokenizers[1], jmodel, variables, **kw)])
    ids = np.asarray(jax_units_out, np.int64)[None] + 1
    bound = tdec._duration_bound(torch.from_numpy(ids))
    x0 = np.random.default_rng(4).standard_normal((1, bound, CFM_KW["dim_in"])).astype(np.float32)
    ours = torch_generate.continue_speech(PROMPT, tokenizers[2], port, tdec, x0=torch.from_numpy(x0), **kw)
    np.testing.assert_array_equal(ours["units"], jax_units_out)
    mel, mask = jdec.model.apply(
        jdec.model_variables, jnp.asarray(ids), dt=0.0625, truncation_value=1.0, x0=jnp.asarray(x0), max_frames=bound, method="sample"
    )
    want = np.asarray(jdec.vocoder.apply(jdec.vocoder_variables, mel))[0]
    n = int(jdec.vocoder.config.waveform_lengths(int(np.asarray(mask).sum())))
    assert ours["waveform"].shape == (n,)
    np.testing.assert_allclose(ours["waveform"], want[:n], **WAV_TOL)


HUBERT_KW = dict(
    hidden_size=24,
    num_hidden_layers=2,
    num_attention_heads=4,
    intermediate_size=48,
    conv_dim=(12, 12, 12),
    conv_kernel=(10, 8, 4),
    conv_stride=(5, 8, 8),
    num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4,
)


@pytest.mark.filterwarnings("ignore:no (converted weights|k-means centers):UserWarning")
def test_generate_speechlm_runs_on_the_cpu(lm_pair, tokenizers, decoder_pair, tmp_path, monkeypatch):
    """The whole stage with device="cpu": a tiny deduplicating encoder
    (seeded random weights), the tokenizer file, the LM as a trainer
    checkpoint under <model.path>/ckpt and the decoder directory; greedy,
    then seeded sampling. Greedy continues as the checkpoint's LM does."""
    _, _, variables, _ = lm_pair
    _, jax_tok, _, tok_path = tokenizers
    _, _, dec_path = decoder_pair
    monkeypatch.setitem(
        torch_se.DENSE_MODELS, "tiny-hubert", {"config": torch_hubert.HubertConfig(**HUBERT_KW), "output_layer": 2}
    )
    monkeypatch.setenv("SPEECH_RESYNTH_MODELS", str(tmp_path / "no-encoders"))
    with CheckpointManager(tmp_path / "lm" / "ckpt") as ckpt:  # what train_speechlm saves, no optimizer
        ckpt.save(3, {"step": 3, "modules": {"model": llama_state_dict(variables["params"])}, "optimizers": {}})
    t = np.arange(16000) / 16000.0
    audio_io.write(tmp_path / "prompt.wav", (0.3 * np.sin(2 * np.pi * 180 * t * (1 + t))).astype(np.float32), 16000)
    config = config_from_dict({
        "model": {"path": str(tmp_path / "lm"), **LM_KW, "vocab_size": LM_KW["vocab_size"] - 2, "pad_token_id": 0,
                  "bos_token_id": None, "eos_token_id": 1},
        "s2u": {"dense_model_name": "tiny-hubert", "quantizer_model_name": "kmeans", "vocab_size": N_UNITS,
                "tokenizer_path": str(tok_path)},
    })
    out_wav = tmp_path / "out.wav"
    with pytest.warns(UserWarning, match="RANDOMLY initialized"):
        result = generate_speechlm(config, str(tmp_path / "prompt.wav"), str(out_wav), str(dec_path), max_new_tokens=8,
                                   temperature=0.0, device="cpu")
    assert out_wav.is_file() and audio_io.info(out_wav) == (16000, 1, result["waveform"].size)
    assert result["units"].min() >= 0 and result["units"].max() < N_UNITS
    lm = TL.LlamaLM(TL.LlamaConfig(**LM_KW))  # the trainer's policy: f32 parameters, bf16 compute
    lm.load_state_dict(llama_state_dict(variables["params"]))
    prompt = result["units"][: result["units"].size - result["generated_units"].size]
    want = torch_generate.generate_unit_continuation(prompt, tokenizers[2], lm.eval(), max_new_tokens=8, temperature=0.0)
    np.testing.assert_array_equal(result["generated_units"], want)
    sampled = [
        generate_speechlm(config, str(tmp_path / "prompt.wav"), max_new_tokens=8, seed=s, device="cpu")["generated_units"]
        for s in (3, 3)
    ]
    np.testing.assert_array_equal(sampled[0], sampled[1])
    assert result["waveform"] is not None and sampled[0].dtype == np.int32


def test_lm_loader_defaults_to_the_card(lm_pair, tmp_path, monkeypatch):
    _, _, variables, _ = lm_pair
    _export_lm(variables["params"], tmp_path / "hf")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_lm_from_hf(tmp_path / "hf")


# ---------------------------------------------------------------------------
# LM stages: encode, tokenize, tokenize_slm21, write_scores, evaluate
# ---------------------------------------------------------------------------


def _named_units(seed, n):
    rng = np.random.default_rng(seed)
    return {f"item{i:02d}": rng.integers(0, 30, int(rng.integers(1, 70))).tolist() for i in range(n)}


def test_load_named_units_from_json_equals_jax(tmp_path):
    path = tmp_path / "units.json"
    path.write_text(json.dumps(_named_units(20, 11)))
    ours = list(torch_data.load_named_units_from_json(str(path), 4, 2))
    theirs = list(jax_data.load_named_units_from_json(str(path), 4, 2))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a["names"] == b["names"]
        assert a["input_ids"].dtype == b["input_ids"].dtype and a["input_ids"].shape[1] % 32 == 0
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])


def test_write_scores_equals_jax(lm_pair, tmp_path):
    """Names in the JSON's order, scores within 1e-5, one forward per batch
    without an attention mask (so K1 on the card, never a masked path)."""
    _, jmodel, variables, port = lm_pair
    path = tmp_path / "units.json"
    items = {k: [t % 30 for t in v] for k, v in _named_units(21, 7).items()}
    path.write_text(json.dumps(items))
    jax_speechlm.write_scores(jmodel, variables, str(path), tmp_path / "jax.txt", 3, 2)
    torch_speechlm.write_scores(port, str(path), tmp_path / "port.txt", 3, 2)
    theirs = [line.split() for line in (tmp_path / "jax.txt").read_text().splitlines()]
    ours = [line.split() for line in (tmp_path / "port.txt").read_text().splitlines()]
    assert [n for n, _ in ours] == [n for n, _ in theirs] == list(items)
    np.testing.assert_allclose([float(s) for _, s in ours], [float(s) for _, s in theirs], rtol=0, atol=1e-5)


STAGE_HUBERT = "stage-hubert"


def _stage_config(root, data, models):
    return {
        "dataset": {
            "wav_dir_train": str(data / "librilight"), "ext_audio": ".wav",
            "unicode_train": str(root / "unicode/train"), "train_file": str(root / "unit/train.txt"),
            "swuggy_dev_file": str(root / "unit/lexical/dev.json"), "sblimp_dev_file": str(root / "unit/syntactic/dev.json"),
            "swuggy_test_file": str(root / "unit/lexical/test.json"), "sblimp_test_file": str(root / "unit/syntactic/test.json"),
            "swuggy_dir": str(data / "slm21/lexical"), "sblimp_dir": str(data / "slm21/syntactic"),
            "result_dir": str(root / "results"),
        },
        "dataloader": {"batch_size_per_device": 3},
        "model": {"vocab_size": 32, "pad_token_id": 0, "bos_token_id": None, "eos_token_id": 1},
        "s2u": {"dense_model_name": STAGE_HUBERT, "quantizer_model_name": "kmeans", "vocab_size": N_UNITS,
                "tokenizer_path": str(root / "tokenizer.json")},
    }


def _voiced(rng, seconds):
    t = np.arange(int(seconds * 16000)) / 16000.0
    f0 = rng.uniform(100, 250) * (1 + 0.3 * np.sin(2 * np.pi * rng.uniform(1, 4) * t))
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    return (0.3 * np.sin(phase) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def lm_stages(lm_pair, tmp_path_factory):
    """A tiny HuBERT (an HF-format checkpoint) and 20 centers registered in both
    packages' DENSE_MODELS and read by both ``by_name`` from one directory; a
    Libri-Light-shaped tree (and one unreadable file) and an sLM21-shaped
    tree with gold tables; then each package's encode, tokenize,
    tokenize_slm21 and evaluate into its own directory. Both encoders run in
    f32 (``_make_encoder`` asks for the bf16 default otherwise), and the
    units of every file are clear of ties (top-2 score gap > 1e-3)."""
    from safetensors.torch import save_file

    from speech_resynth_torch.models.composite import init_random_weights
    from speech_resynth_tpu.core.config import config_from_dict as jax_config

    data = tmp_path_factory.mktemp("lm_stage_data")
    jcfg = jax_hubert.HubertConfig(**HUBERT_KW)
    # an HF HubertModel checkpoint: the port's keys are HF's, but for the
    # positional conv, which HF keeps weight-normed (norm over all but the taps)
    tower = torch_hubert.HubertEncoder(torch_hubert.HubertConfig(**HUBERT_KW), FLOAT32)
    init_random_weights(tower, torch.Generator().manual_seed(33))
    sd = dict(tower.state_dict())
    w = sd.pop("encoder.pos_conv_embed.conv.weight")
    sd["encoder.pos_conv_embed.conv.weight_v"] = w
    sd["encoder.pos_conv_embed.conv.weight_g"] = torch.sqrt(torch.sum(w * w, dim=(0, 1), keepdim=True))
    save_file({k: v.contiguous() for k, v in sd.items()}, str(data / f"{STAGE_HUBERT}.safetensors"))
    centers = np.random.default_rng(30).standard_normal((N_UNITS, jcfg.hidden_size)).astype(np.float32) * 2.0
    np.savez(data / f"{STAGE_HUBERT}-kmeans-{N_UNITS}.npz", centers=centers)
    rng = np.random.default_rng(31)
    wavs = {}
    for spk, chap, utt in (("12", "1", "a"), ("12", "2", "b"), ("3", "1", "c"), ("5", "7", "d"), ("7", "1", "e")):
        wavs[f"librilight/small/{spk}/{chap}/{utt}.wav"] = _voiced(rng, rng.uniform(0.8, 2.0))
    gold = {}
    for task, by, cats, secs in (("lexical", "frequency", ("high", "low", "oov"), (0.4, 0.9)), ("syntactic", "type", ("agreement", "anaphor"), (1.0, 2.0))):
        rows = []
        for pair in range(3):
            for correct in (1, 0):
                name = f"{task[:3]}{pair}{'ab'[correct]}"
                wavs[f"slm21/{task}/test/{name}.wav"] = _voiced(rng, rng.uniform(*secs))
                rows.append(f"{pair},{name}.wav,{correct},{cats[pair % len(cats)]},test")
        gold[task] = f"id,filename,correct,{by},subset\n" + "\n".join(rows) + "\n"
    for rel, w in wavs.items():
        audio_io.write(data / rel, w, 16000)
    (data / "librilight/small/9/1").mkdir(parents=True)
    (data / "librilight/small/9/1/broken.wav").write_bytes(b"not a wav file")
    for task, text in gold.items():
        (data / "slm21" / task / "gold.csv").write_text(text)

    _, jmodel, variables, port = lm_pair
    jax_root, port_root = data / "jax", data / "port"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPEECH_RESYNTH_MODELS", str(data))
        mp.setitem(jax_se.DENSE_MODELS, STAGE_HUBERT, {"config": jcfg, "output_layer": 2})
        mp.setitem(torch_se.DENSE_MODELS, STAGE_HUBERT, {"config": torch_hubert.HubertConfig(**HUBERT_KW), "output_layer": 2})
        spec = (STAGE_HUBERT, "kmeans", N_UNITS)
        mp.setattr(jax_speechlm, "_make_encoder", lambda c: jax_se.SpeechEncoder.by_name(*spec, deduplicate=True, policy=JAX_FLOAT32))
        mp.setattr(torch_speechlm, "_make_encoder",
                   lambda c, device=None: torch_se.SpeechEncoder.by_name(*spec, deduplicate=True, policy=FLOAT32, device=device))
        enc = torch_speechlm._make_encoder(config_from_dict(_stage_config(port_root, data, None)), device="cpu")
        for w in wavs.values():
            feats = enc.encoder(torch.from_numpy(w)[None], output_layer=2)[0]
            score = feats @ enc.quantizer.centers.T - enc.quantizer.centers.pow(2).sum(-1) / 2
            top2 = score.topk(2, dim=-1).values
            assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-3
        jconf, pconf = jax_config(_stage_config(jax_root, data, None)), config_from_dict(_stage_config(port_root, data, None))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            jax_speechlm.encode(jconf, "1-9")
            torch_speechlm.encode(pconf, "1-9", device="cpu")
            jax_speechlm.tokenize(jconf)
            torch_speechlm.tokenize(pconf)
            jax_speechlm.tokenize_slm21(jconf)
            torch_speechlm.tokenize_slm21(pconf, device="cpu")
            jax_result = jax_speechlm.evaluate(jconf, jmodel, variables)
            port_result = torch_speechlm.evaluate(pconf, port)
    return jax_root, port_root, jax_result, port_result


def test_encode_stage_equals_jax(lm_stages):
    """``encode`` (through ``_encode_paths``): one unicode line per readable
    file, in path order, the unreadable one skipped."""
    jax_root, port_root, _, _ = lm_stages
    ours = (port_root / "unicode/train1-9").read_text()
    assert ours == (jax_root / "unicode/train1-9").read_text()
    assert len(ours.splitlines()) == 5 and all(ours.splitlines())


def test_tokenize_stage_equals_jax(lm_stages):
    jax_root, port_root, _, _ = lm_stages
    assert json.loads((port_root / "tokenizer.json").read_text())["model"] == json.loads((jax_root / "tokenizer.json").read_text())["model"]
    ours = (port_root / "unit/train.txt").read_text()
    assert ours == (jax_root / "unit/train.txt").read_text() and len(ours.splitlines()) == 5


def test_tokenize_slm21_stage_equals_jax(lm_stages):
    jax_root, port_root, _, _ = lm_stages
    for rel in ("unit/lexical/test.json", "unit/syntactic/test.json", "unit/lexical/dev.json", "unit/syntactic/dev.json"):
        assert json.loads((port_root / rel).read_text()) == json.loads((jax_root / rel).read_text()), rel
    assert len(json.loads((port_root / "unit/lexical/test.json").read_text())) == 6


def test_evaluate_stage_equals_jax(lm_stages):
    """Score files (names in order, scores within 1e-5), the pair tables and
    the four aggregate numbers, which the port returns as a dict."""
    jax_root, port_root, jax_result, port_result = lm_stages
    for task in ("lexical", "syntactic"):
        ours = [line.split() for line in (port_root / f"results/{task}/test.txt").read_text().splitlines()]
        theirs = [line.split() for line in (jax_root / f"results/{task}/test.txt").read_text().splitlines()]
        assert [n for n, _ in ours] == [n for n, _ in theirs] and len(ours) == 6
        np.testing.assert_allclose([float(s) for _, s in ours], [float(s) for _, s in theirs], rtol=0, atol=1e-5)
    for name in ("score_lexical_test_by_frequency.csv", "score_syntactic_test_by_type.csv"):
        assert (port_root / "results/scores" / name).read_text() == (jax_root / "results/scores" / name).read_text()
    assert list(port_result) == list(jax_result.index)
    np.testing.assert_allclose(list(port_result.values()), jax_result[0].to_numpy(), rtol=0, atol=0)
    assert (port_root / "results/scores/score.csv").read_text() == (jax_root / "results/scores/score.csv").read_text()
