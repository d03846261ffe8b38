"""The speech-continuation path of the port against the JAX package.

Covers the unit <-> unicode mapping, the BPE tokenizer (files and merges
shared with the JAX copy), the Llama LM (logits, the KV-cache path, greedy
and sampled decoding, logit filtering, pseudo-log-prob scoring, weight
conversion and the HF directory loader), ``continue_speech`` and the
``generate_speechlm`` stage, all at tiny sizes with seeded weights.

Tolerances: f32 on both sides (JAX at "highest" matmul precision), another
summation order: LM logits atol 1e-4 (O(1) logits through two layers),
scores 1e-5; waveforms as in tests/test_torch_duration.py (atol 2e-5).
Token ids and units compare exactly.
"""

import json

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
from speech_resynth_tpu.models import llama as JL
from speech_resynth_tpu.models.convert import stack_llama_layers
from speech_resynth_tpu.pipeline import generate as jax_generate
from speech_resynth_tpu.text import units as jax_units
from speech_resynth_tpu.tokenizers.bpe import BpeTokenizer as JaxBpe
from speech_resynth_torch.core.config import config_from_dict
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.dsp import audio_io
from speech_resynth_torch.models import hubert as torch_hubert
from speech_resynth_torch.models import llama as TL
from speech_resynth_torch.models import speech_encoder as torch_se
from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan
from speech_resynth_torch.models.convert import llama_state_dict
from speech_resynth_torch.pipeline import generate as torch_generate
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
    assert calls == [{"mask": None, "causal": True}] * LM_KW["num_hidden_layers"]


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


def test_speculative_decoding_is_not_ported_yet(lm_pair, tokenizers):
    _, _, _, port = lm_pair
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        torch_generate.generate_unit_continuation(PROMPT, tokenizers[2], port, speculative=True)


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
    (seeded random weights), the tokenizer file, the LM's HF directory under
    <model.path>/hf and the decoder directory; greedy, then seeded sampling."""
    _, _, variables, _ = lm_pair
    _, jax_tok, _, tok_path = tokenizers
    _, _, dec_path = decoder_pair
    monkeypatch.setitem(
        torch_se.DENSE_MODELS, "tiny-hubert", {"config": torch_hubert.HubertConfig(**HUBERT_KW), "output_layer": 2}
    )
    monkeypatch.setenv("SPEECH_RESYNTH_MODELS", str(tmp_path / "no-encoders"))
    _export_lm(variables["params"], tmp_path / "lm" / "hf")
    t = np.arange(16000) / 16000.0
    audio_io.write(tmp_path / "prompt.wav", (0.3 * np.sin(2 * np.pi * 180 * t * (1 + t))).astype(np.float32), 16000)
    config = config_from_dict({
        "model": {"path": str(tmp_path / "lm"), "pad_token_id": 0, "bos_token_id": None, "eos_token_id": 1},
        "s2u": {"dense_model_name": "tiny-hubert", "quantizer_model_name": "kmeans", "vocab_size": N_UNITS,
                "tokenizer_path": str(tok_path)},
    })
    out_wav = tmp_path / "out.wav"
    with pytest.warns(UserWarning, match="RANDOMLY initialized"):
        result = generate_speechlm(config, str(tmp_path / "prompt.wav"), str(out_wav), str(dec_path), max_new_tokens=8,
                                   temperature=0.0, device="cpu")
    assert out_wav.is_file() and audio_io.info(out_wav) == (16000, 1, result["waveform"].size)
    assert result["units"].min() >= 0 and result["units"].max() < N_UNITS
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
