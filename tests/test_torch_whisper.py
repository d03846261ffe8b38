"""The port's Whisper (speech_resynth_torch.models.whisper) against the JAX
package's, on the same weights and inputs, at a tiny width (2 + 2 layers,
d_model 128, heads of 64, 16 mels, 100 mel frames) in f32; the JAX side
unrolled at "highest" precision.

Held: encoder states, teacher-forced logits and the cached decode's logits
within 1e-4; greedy ids equal (the seed's top-2 logit gaps exceed 1e-3);
the HF key loader and the safetensors reader against HF's own export; the
attention routes of Whisper, the CFM transformer and HuBERT with K1 swapped
for a counting plain version; and the scorers' pure pieces
(``merge_chunk_tokens``, ``_window_starts``) and the byte-level text
decoder against the JAX package and ``transformers``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.models import whisper as JW
from speech_resynth_tpu.pipeline import scorers as JS
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.models import whisper as TW
from speech_resynth_torch.models.convert import load_checkpoint, whisper_state_dict
from speech_resynth_torch.ops import attention as TA
from speech_resynth_torch.pipeline import scorers as TS
from test_torch_cuda import write_whisper_tokenizer as write_tokenizer

KW = dict(vocab_size=96, num_mel_bins=16, d_model=128, encoder_layers=2, encoder_attention_heads=2, decoder_layers=2,
          decoder_attention_heads=2, encoder_ffn_dim=128, decoder_ffn_dim=128, max_source_positions=50,
          max_target_positions=40, decoder_start_token_id=90, eos_token_id=91)
TOL = dict(rtol=0, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for torch: the suite runs six workers on the
    host's cores, where torch's default pools spin against each other (a
    tiny UTMOS forward took 10-60 s under that load, 0.01 s with one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mel(b=2, seed=0):
    return np.random.default_rng(seed).standard_normal((b, 2 * KW["max_source_positions"], KW["num_mel_bins"])).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """The JAX model with seeded random weights (every bias and norm moved off
    its init) and the port's model loaded from the same tree."""
    jmodel = JW.WhisperForASR(JW.WhisperConfig(**KW), policy=JAX_FLOAT32, attn_implementation="xla")
    params = jmodel.init(jax.random.key(0), jnp.asarray(_mel(1)), jnp.zeros((1, 3), jnp.int32))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(np.float32), params)
    model = TW.WhisperForASR(TW.WhisperConfig(**KW), FLOAT32).eval()
    model.load_state_dict(whisper_state_dict(params))
    return jmodel, {"params": params}, model


def _np(t):
    return t.detach().numpy()


def test_encoder_and_teacher_forced_logits_match_jax(pair):
    jmodel, variables, model = pair
    mel = _mel()
    ids = np.random.default_rng(2).integers(0, KW["vocab_size"], (2, 7))
    with jax.default_matmul_precision("highest"):
        j_enc = np.asarray(jmodel.apply(variables, jnp.asarray(mel), method="encode"))
        j_logits = np.asarray(jmodel.apply(variables, jnp.asarray(mel), jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        enc = model.encode(torch.from_numpy(mel))
        logits = model(torch.from_numpy(mel), torch.from_numpy(ids))
    assert enc.shape == (2, KW["max_source_positions"], KW["d_model"])
    np.testing.assert_allclose(_np(enc), j_enc, **TOL)
    np.testing.assert_allclose(_np(logits), j_logits, **TOL)


def test_cached_decode_logits_match_jax_and_teacher_forcing(pair):
    """Prefill two tokens, then one a step, against the JAX decode steps and
    the teacher-forced logits."""
    jmodel, variables, model = pair
    mel = _mel()
    ids = np.random.default_rng(3).integers(0, KW["vocab_size"], (2, 6))
    with jax.default_matmul_precision("highest"):
        enc = jmodel.apply(variables, jnp.asarray(mel), method="encode")
        jkv = jmodel.apply(variables, enc, method="cross_kv")
        jcache = jmodel.init_cache(2, 6)
        j_steps = []
        for t0, t1 in ((0, 2), (2, 3), (3, 4), (4, 5), (5, 6)):
            logits, jcache = jmodel.apply(variables, jnp.asarray(ids[:, t0:t1], jnp.int32), jkv, jcache, jnp.asarray(t0),
                                          method="decode_step")
            j_steps.append(np.asarray(logits))
    with torch.no_grad():
        full = _np(model(torch.from_numpy(mel), torch.from_numpy(ids)))
        kv = model.cross_kv(model.encode(torch.from_numpy(mel)))
        assert all(d["k"].is_contiguous() and d["v"].is_contiguous() for d in kv)
        cache = model.init_cache(2, 6)
        for (t0, t1), want in zip(((0, 2), (2, 3), (3, 4), (4, 5), (5, 6)), j_steps):
            logits, cache = model.decode_step(torch.from_numpy(ids[:, t0:t1]), kv, cache, t0)
            np.testing.assert_allclose(_np(logits), want, **TOL)
            np.testing.assert_allclose(_np(logits), full[:, t0:t1], **TOL)


def test_greedy_decode_equals_jax(pair):
    """Equal ids, the loop's early stop included: the JAX run's top-2 logit
    gap exceeds 1e-3 at every step (checked on the teacher-forced logits of
    its own output), so no near-tie decides an id."""
    jmodel, variables, model = pair
    mel = _mel(2, seed=4)
    prompt = np.array([[90, 5, 9], [90, 7, 3]])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JW.greedy_decode(jmodel, variables, jnp.asarray(mel), 8, jnp.asarray(prompt, jnp.int32)))
        logits = np.asarray(jmodel.apply(variables, jnp.asarray(mel), jnp.asarray(want[:, :-1])))
    top2 = np.sort(logits[:, prompt.shape[1] - 1 :], axis=-1)[..., -2:]
    assert float((top2[..., 1] - top2[..., 0]).min()) > 1e-3
    got = TW.greedy_decode(model, torch.from_numpy(mel), 8, torch.from_numpy(prompt)).numpy()
    np.testing.assert_array_equal(got, want)


def test_greedy_decode_fills_eos_and_stops_early(pair, monkeypatch):
    """A row that ends keeps eos; once every row has ended no step runs."""
    _, _, model = pair
    eos = KW["eos_token_id"]
    steps = []
    real = model.decode_step

    def ending(ids, kv, cache, index):
        logits, cache = real(ids, kv, cache, index)
        steps.append(index)
        if index >= 4:  # from position 4 on, eos wins every row
            logits[..., eos] = 1e9
        return logits, cache

    monkeypatch.setattr(model, "decode_step", ending)
    tokens = TW.greedy_decode(model, torch.from_numpy(_mel()), 10, torch.tensor([[90, 1], [90, 2]])).numpy()
    assert tokens.shape == (2, 12)
    assert (tokens[:, 5:] == eos).all() and steps == [0, 2, 3, 4]


def test_hf_checkpoint_loads_through_the_safetensors_reader(tmp_path):
    """HF's own ``save_pretrained`` (tied ``proj_out`` dropped) read by
    ``core.safetensors`` and ``whisper_state_dict_from_hf``, against the JAX
    converter of the same state_dict: the same tensors."""
    from transformers import WhisperConfig as HFConfig, WhisperForConditionalGeneration

    from speech_resynth_tpu.models.convert import whisper_params

    torch.manual_seed(0)
    hf = WhisperForConditionalGeneration(HFConfig(
        vocab_size=51000, num_mel_bins=16,  # HF wants pad_token_id < vocab_size d_model=128, encoder_layers=1, decoder_layers=1,
        encoder_attention_heads=2, decoder_attention_heads=2, encoder_ffn_dim=128, decoder_ffn_dim=128,
        max_source_positions=50, max_target_positions=40,
    )).eval()
    hf.save_pretrained(tmp_path, safe_serialization=True)
    sd = load_checkpoint(tmp_path)
    assert "proj_out.weight" not in sd
    config = TW.WhisperConfig.from_hf(json.loads((tmp_path / "config.json").read_text()))
    model = TW.WhisperForASR(config, FLOAT32)
    model.load_state_dict(TW.whisper_state_dict_from_hf(sd))
    ported = whisper_state_dict(whisper_params({k: v.numpy() for k, v in hf.state_dict().items()}))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, ported[k], rtol=0, atol=0)


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """Tensors that report is_cuda, and K1's wrapper swapped for a counting
    plain version, so the dispatcher's routing shows on the CPU."""
    launches = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(
        TA, "flash_attention", lambda q, k, v, mask, causal: launches.append(tuple(q.shape)) or TA.attention_reference(q, k, v, mask, causal)
    )
    return launches


@pytest.mark.parametrize("implementation", ["xla", "auto"])
def test_attention_routes(pair, as_if_on_the_card, implementation):
    """"xla" launches nothing; "auto" launches K1 once a layer: Whisper's
    encoder, its uncached decoder (causal self- and cross-attention) and
    every decode step's cross-attention (the cached self-attention is the
    einsum), the CFM transformer and HuBERT; the outputs equal the plain
    route's, since the swapped kernel is the plain version."""
    from speech_resynth_torch.models.cfm import CFMConfig, ConditionalFlowMatchingModel
    from speech_resynth_torch.models.hubert import HubertConfig, HubertEncoder

    _, _, ref = pair
    model = TW.WhisperForASR(TW.WhisperConfig(**KW), FLOAT32, implementation)
    model.load_state_dict(ref.state_dict())
    mel, ids = torch.from_numpy(_mel()), torch.tensor([[90, 4, 5], [90, 6, 7]])
    with torch.no_grad():
        logits = model(mel, ids)
        tokens = TW.greedy_decode(model, mel, 3, ids[:, :1])
        counts = {"whisper": len(as_if_on_the_card)}
        cfm = ConditionalFlowMatchingModel(CFMConfig(vocab_size=9, dim_in=8, dim_cond_emb=16, hidden_size=128, depth=2, heads=2,
                                                     intermediate_size=24, conv_pos_embed_kernel_size=7, conv_pos_embed_groups=16),
                                           FLOAT32, implementation)
        cfm.sample(torch.tensor([[1, 2, 3, 0]]), 0.5, generator=torch.Generator().manual_seed(0))
        counts["cfm"] = len(as_if_on_the_card) - counts["whisper"]
        hubert = HubertEncoder(HubertConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                                            conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2),
                                            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4), FLOAT32, implementation)
        hubert(torch.randn(1, 800, generator=torch.Generator().manual_seed(0)))
        counts["hubert"] = len(as_if_on_the_card) - counts["whisper"] - counts["cfm"]
    layers = KW["encoder_layers"] + KW["decoder_layers"]
    # teacher forcing: encoder, decoder self + cross; greedy (3 new): encoder, cross-attention of the prefill and 2 steps
    want = {"whisper": layers + KW["decoder_layers"] + KW["encoder_layers"] + 3 * KW["decoder_layers"],
            "cfm": 2 * 2, "hubert": 2}
    assert counts == ({k: 0 for k in want} if implementation == "xla" else want)
    with torch.no_grad():
        torch.testing.assert_close(logits, ref(mel, ids), rtol=0, atol=0)
        torch.testing.assert_close(tokens, TW.greedy_decode(ref, mel, 3, ids[:, :1]), rtol=0, atol=0)


def test_merge_chunk_tokens_equals_jax():
    rng = np.random.default_rng(0)
    for _ in range(40):
        stream = rng.integers(10, 60, size=rng.integers(20, 90)).tolist()
        step, overlap = int(rng.integers(5, 15)), int(rng.integers(2, 8))
        chunks = []
        for s in range(0, len(stream), step):
            chunk = stream[s : s + step + overlap]
            if len(chunk) >= 2 and rng.uniform() < 0.4:
                chunk[rng.integers(0, len(chunk))] = int(rng.integers(10, 60))
            chunks.append(chunk)
        assert TS.merge_chunk_tokens(chunks) == JS.merge_chunk_tokens(chunks)


@pytest.mark.parametrize("chunk_s,stride_s", [(30.0, None), (30.0, 5.0), (1.0, None), (2.0, 0.0)])
def test_window_starts_equal_jax(chunk_s, stride_s):
    ours, theirs = TS.NativeWhisperASR.__new__(TS.NativeWhisperASR), JS.NativeWhisperASR.__new__(JS.NativeWhisperASR)
    for asr in (ours, theirs):
        asr.chunk_length_s, asr.stride_length_s = chunk_s, chunk_s / 6.0 if stride_s is None else stride_s
    for n_sec in [0.5, 1, 29.9, 30, 30.1, 35, 44.9, 45, 50, 61, 70, 90, 124.7]:
        n = int(n_sec * 16000)
        assert ours._window_starts(n, 16000) == theirs._window_starts(n, 16000), n_sec


@pytest.mark.parametrize("clean_up", [False, True])
def test_text_decoder_equals_hf_whisper_tokenizer(tmp_path, clean_up):
    """``WhisperTextDecoder`` against HF's tokenizer from the same files:
    special, timestamp and multi-byte UTF-8 ids (a split character too), a
    previous-text prompt, with and without ``skip_special_tokens``. HF's
    slow ``WhisperTokenizer`` never applies ``clean_up_tokenization_spaces``
    (its ``_decode`` drops the flag) while the fast one, which
    ``AutoTokenizer`` gives the JAX scorer, applies it as the config says;
    the port follows the JAX scorer's, so the clean-up case is held against
    the fast tokenizer and the other against the slow one."""
    from transformers import AutoTokenizer, WhisperTokenizer

    ids = write_tokenizer(tmp_path, 400, clean_up=clean_up)
    if clean_up:
        hf = AutoTokenizer.from_pretrained(str(tmp_path))
    else:
        hf = WhisperTokenizer(str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"),
                              **{k: v for k, v in json.loads((tmp_path / "tokenizer_config.json").read_text()).items()
                                 if k not in ("added_tokens_decoder", "tokenizer_class")})
    ours = TS.WhisperTextDecoder.from_dir(tmp_path)
    assert sorted(ours.all_special_ids) == sorted(hf.all_special_ids)
    v, a = ids["vocab"], ids["added"]
    b2u = TS.bytes_to_unicode()
    tok = lambda text: v["".join(b2u[b] for b in text.encode())]
    rng = np.random.default_rng(0)
    cases = [
        [a["<|startoftranscript|>"], a["<|en|>"], a["<|transcribe|>"], a["<|notimestamps|>"], tok(" the"), tok(" cat"),
         tok(" ,"), tok("n't"), tok(" 's"), tok(" ."), a["<|endoftext|>"]],
        [a["<|0.00|>"], tok(" the"), a["<|0.04|>"], tok("é"), tok("日本"), a["<|0.18|>"]],
        ["é".encode()[0], tok(" the"), "€".encode()[1]],  # lone pieces of multi-byte characters
        [a["<|startofprev|>"], tok(" cat"), a["<|startoftranscript|>"], tok(" ü")],
        [a["<|startofprev|>"], tok(" cat")],
        [],
    ] + [rng.integers(0, 400 + len(a), 30).tolist() for _ in range(20)]
    for case in cases:
        for skip in (True, False):
            assert ours.decode(case, skip_special_tokens=skip) == hf.decode(case, skip_special_tokens=skip), (case, skip)
