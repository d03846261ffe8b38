"""The port's eval stack against the JAX package's: the text normalizer and
WER/CER, hub-id resolution and the composite checkpoint writer, ``evaluate``
(the CSV both ways) with stand-in and with native scorers, and the CFM
loop's dev validation.

Everything is tiny and in f32: the ``bench.py --tiny`` decoder of
``tests/test_torch_composite.py`` (x20 vocoder), a Whisper of 1 + 1 layers
(d_model 128, 1-s windows), the UTMOS torch oracle's lightning checkpoint of
``tests/test_utmos.py``. JAX draws its ODE noise from ``jax.random.key(0)``;
the port's runs are given the same noise (``noise=``), so the synthesized
audio agrees to f32 rounding. Tolerances: text metrics exactly equal, the
CSV rows and the MOS within 1e-6 with the energy stand-in and 1e-4 through
UTMOS, transcripts equal.
"""

import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_resynth_tpu.core.config import config_from_dict as jax_config
from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.models import composite as JC
from speech_resynth_tpu.models import hifigan as JH
from speech_resynth_tpu.models import hub as JHUB
from speech_resynth_tpu.models import whisper as JW
from speech_resynth_tpu.pipeline import evaluate as JE
from speech_resynth_tpu.pipeline import scorers as JS
from speech_resynth_tpu.pipeline import train_loops as JL
from speech_resynth_tpu.text import normalize as JN
from speech_resynth_torch.core.config import config_from_dict
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.core.safetensors import save_file
from speech_resynth_torch.dsp import audio_io
from speech_resynth_torch.models import hifigan as TH
from speech_resynth_torch.models import hub as THUB
from speech_resynth_torch.models import whisper as TW
from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan, init_random_weights
from speech_resynth_torch.models.convert import save_composite_pretrained, save_pretrained
from speech_resynth_torch.pipeline import evaluate as TE
from speech_resynth_torch.pipeline import scorers as TS
from speech_resynth_torch.pipeline import train_loops as TL
from speech_resynth_torch.text import normalize as TN
from test_torch_composite import CFM_KW, VOC_KW, _carry_across, _reinit
from test_torch_cuda import RecordingWriter, write_whisper_tokenizer as write_tokenizer
from test_utmos import _TorchOracle, tiny_ssl_cfg

DT, TRUNC = 0.25, 1.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for torch: the suite runs six workers on the
    host's cores, where torch's default pools spin against each other (a
    tiny UTMOS forward took 10-60 s under that load, 0.01 s with one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# -- text -----------------------------------------------------------------------

TEXT_CASES = [
    "in 2000", "in 2005", "in 1900", "in 1984", "I have 42 cats", "Dr. Smith won't go", "I don't know, it's fine",
    "Mr. Jones", "don’t “stop”", "a <noise> b [laughter] c", " a  b ", "don't", "the 3rd of 1000000 Lt. Col. Ft. 1066",
    "", "   ", "Mrs. Co. Jr. St. 2009 2010 1999 -5",
]


def _random_texts(n=60, seed=0):
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefghij  ,.'’-<>[]$0123456789") + ["Dr.", "mr.", " 19", "2004", "é", "“"]
    return ["".join(rng.choice(alphabet, rng.integers(0, 30))) for _ in range(n)]


def test_normalizer_and_metrics_equal_jax():
    """Every function of ``text.normalize`` on the JAX test's cases and on
    seeded random strings: equal outputs; WER and CER exactly equal."""
    texts = TEXT_CASES + _random_texts()
    for t in texts:
        assert TN.wer_normalize(t) == JN.wer_normalize(t), t
        assert TN.cer_normalize(t) == JN.cer_normalize(t), t
    for n in list(range(0, 130)) + [345, 1000, 1066, 1984, 2000, 2005, 10**6, 10**9 + 7, -42]:
        assert TN.number_to_words(n) == JN.number_to_words(n)
        if n > 0:
            assert TN.year_to_words(n) == JN.year_to_words(n)
    refs, hyps = texts[: len(texts) // 2], texts[len(texts) // 2 :][: len(texts) // 2]
    assert TN.wer(refs, hyps) == JN.wer(refs, hyps) and TN.cer(refs, hyps) == JN.cer(refs, hyps)
    assert TN.edit_distance("kitten", "sitting") == JN.edit_distance("kitten", "sitting") == 3


# -- hub ------------------------------------------------------------------------


def _fake_cache(root, repo_id, sha="abc123", with_ref=True):
    repo = root / ("models--" + repo_id.replace("/", "--"))
    snap = repo / "snapshots" / sha
    snap.mkdir(parents=True)
    if with_ref:
        (repo / "refs").mkdir()
        (repo / "refs" / "main").write_text(sha + "\n")
    return snap


def test_resolve_pretrained_dir_equals_jax(tmp_path, monkeypatch):
    """``tests/test_hub.py``'s cases through both packages: a local
    directory, ``refs/main``, the newest snapshot, an explicit cache
    directory; a missing id raises naming the roots (the port never
    downloads), and so does a path that is no hub id."""
    import os
    import time

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")  # the JAX fallback's download must fail here
    monkeypatch.delenv("HF_HOME", raising=False)
    hub = tmp_path / "hub"
    snap = _fake_cache(hub, "org/model")
    old = _fake_cache(hub, "org/partial", sha="old000", with_ref=False)
    os.utime(old, (time.time() - 1000,) * 2)
    new = hub / "models--org--partial" / "snapshots" / "new111"
    new.mkdir()
    mine = _fake_cache(tmp_path / "mycache", "org/other")
    monkeypatch.setenv("HF_HUB_CACHE", str(hub))
    for resolve in (THUB.resolve_pretrained_dir, JHUB.resolve_pretrained_dir):
        assert resolve(tmp_path) == tmp_path and resolve(str(tmp_path)) == tmp_path
        assert resolve("org/model") == snap
        assert resolve("org/partial") == new
        assert resolve("org/other", cache_dir=str(tmp_path / "mycache")) == mine
        with pytest.raises(FileNotFoundError, match="org/nope"):
            resolve("org/nope")
        with pytest.raises(FileNotFoundError, match="not an 'org/name' hub id"):
            resolve(tmp_path / "does-not-exist")
    with pytest.raises(FileNotFoundError, match=str(hub)):
        THUB.resolve_pretrained_dir("org/nope")


# -- the tiny decoder on both sides ------------------------------------------------


@pytest.fixture(scope="module")
def decoders():
    dec = JC.ConditionalFlowMatchingWithHifiGan.from_config(
        JC.CFMConfig(**CFM_KW), JH.HifiGanConfig(**VOC_KW), policy=JAX_FLOAT32
    )
    mvars = dict(dec.model_variables)
    mvars["params"] = _reinit(mvars["params"], 0)
    jdec = JC.ConditionalFlowMatchingWithHifiGan(dec.model, mvars, dec.vocoder, _reinit(dec.vocoder_variables, 1))
    return jdec, _carry_across(jdec)


def test_composite_writer_is_read_by_both_packages(decoders, tmp_path, monkeypatch):
    """``save_composite_pretrained`` of the port, read by the port's
    ``from_pretrained`` through a hub id in the HF cache and by the JAX
    package's from the directory: the same waveform from the same noise."""
    jdec, port = decoders
    snap = _fake_cache(tmp_path / "hub", "org/composite")
    save_composite_pretrained(snap, port.model, port.vocoder)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    ours = ConditionalFlowMatchingWithHifiGan.from_pretrained("org/composite", FLOAT32, device="cpu")
    theirs = JC.ConditionalFlowMatchingWithHifiGan.from_pretrained(str(snap), policy=JAX_FLOAT32)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, CFM_KW["vocab_size"] + 1, (2, 10))
    ids[1, 6:] = 0
    x0 = rng.standard_normal((2, 10, CFM_KW["dim_in"])).astype(np.float32)
    wav, lengths = ours.synthesize(ids, DT, TRUNC, x0=torch.from_numpy(x0))
    mel, mask = theirs.model.apply(theirs.model_variables, jnp.asarray(ids), dt=DT, truncation_value=TRUNC,
                                   x0=jnp.asarray(x0), method="sample")
    want = np.asarray(theirs.vocoder.apply(theirs.vocoder_variables, mel))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(theirs.vocoder.config.waveform_lengths(mask.sum(axis=1))))
    np.testing.assert_allclose(wav.numpy(), want, rtol=1e-5, atol=2e-5)


# -- evaluate ---------------------------------------------------------------------

TRANSCRIPTS = ["the cat sat", "hello world", "in 1984 we met", "a b c", "don't stop"]


class LengthASR:
    """A deterministic stand-in transcriber: the text is a function of the
    wave's length, so both packages' hypotheses agree wherever their waves'
    lengths do."""

    def transcribe(self, wavs, sample_rate=16000):
        return [TRANSCRIPTS[len(w) % len(TRANSCRIPTS)] + (" x" if len(w) % 3 else "") for w in wavs]


@pytest.fixture(scope="module")
def unit_set(tmp_path_factory):
    """5 utterances of 6-12 units with transcripts and reference waves: the
    dev set (``dev.json``, the sweep's five clips) and its first 4 the test
    set (two batches of 2: one shape for every compiled JAX program)."""
    root = tmp_path_factory.mktemp("units")
    rng = np.random.default_rng(3)
    units = {}
    (root / "wav").mkdir()
    for i, text in enumerate(TRANSCRIPTS):
        n = int(rng.integers(6, 13))
        units[f"u{i}"] = {"units": rng.integers(0, CFM_KW["vocab_size"], n).tolist(), "durations": [1] * n, "transcript": text}
        audio_io.write(root / "wav" / f"u{i}.wav", (0.1 * rng.standard_normal(int(rng.integers(3000, 9000)))).astype(np.float32), 16000)
    (root / "dev.json").write_text(json.dumps(units))
    (root / "test.json").write_text(json.dumps(dict(list(units.items())[:4])))
    return root


def _eval_config(root: Path, name: str) -> dict:
    return {
        "dataset": {"test_file": str(root / "test.json"), "dev_file": str(root / "dev.json"), "wav_dir": str(root / "wav"),
                    "ext_audio": ".wav"},
        "flow_matching": {"dt": DT, "truncation_value": TRUNC},
        "flow_matching_with_hifigan": {"batch_size": 2},
        "eval": {"result_path": str(root / name / "result.csv")},
    }


def _jax_noise(i, shape):
    """The noise the JAX ``evaluate`` draws for its batch ``i``."""
    rng = jax.random.key(0)
    for _ in range(i + 1):
        rng, sub = jax.random.split(rng)
    return torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32)))


def _run_both(decoders, unit_set, tag, jax_scorers, port_scorers):
    jdec, port = decoders
    jrows = JE.evaluate(jax_config(_eval_config(unit_set, f"jax_{tag}")), decoder=jdec, **jax_scorers)
    rows = TE.evaluate(config_from_dict(_eval_config(unit_set, f"port_{tag}")), decoder=port, noise=_jax_noise, **port_scorers)
    return jrows, rows


def _assert_tables_agree(jrows, rows, unit_set, tag, mos_tol):
    import pandas as pd

    assert [r[0] for r in rows] == list(jrows.index) == list(TE.ROWS)
    assert [r[2] for r in rows] == list(jrows["scorer"])
    for (name, score, _), want in zip(rows, jrows["score"]):
        assert score == pytest.approx(want, abs=mos_tol if name.startswith("MOS") else 0), name
    # each package's CSV read by the other's reader
    theirs_by_port = TE.read_table(unit_set / f"jax_{tag}" / "result.csv")
    ours_by_pandas = pd.read_csv(unit_set / f"port_{tag}" / "result.csv", index_col=0)
    assert [r[0] for r in theirs_by_port] == list(ours_by_pandas.index) == list(TE.ROWS)
    np.testing.assert_allclose([r[1] for r in theirs_by_port], [r[1] for r in rows], rtol=0, atol=mos_tol)
    np.testing.assert_allclose(ours_by_pandas["score"].to_numpy(), jrows["score"].to_numpy(), rtol=0, atol=mos_tol)
    assert list(ours_by_pandas["scorer"]) == [r[2] for r in rows]


def test_evaluate_with_stand_in_scorers_equals_jax(decoders, unit_set):
    """The energy MOS and a length-keyed transcriber: the six rows, the
    scorer column and the CSV, both ways."""
    jrows, rows = _run_both(decoders, unit_set, "stand_in", {"asr": LengthASR(), "mos": JS.EnergyMOS()},
                            {"asr": LengthASR(), "mos": TS.EnergyMOS()})
    assert rows[0][1] > 0 and rows[2][2] == "EnergyMOS"
    _assert_tables_agree(jrows, rows, unit_set, "stand_in", 1e-6)


WHISPER_KW = dict(num_mel_bins=16, d_model=128, encoder_layers=1, encoder_attention_heads=2, decoder_layers=1,
                  decoder_attention_heads=2, encoder_ffn_dim=128, decoder_ffn_dim=128, max_source_positions=50,
                  max_target_positions=40)


@pytest.fixture(scope="module")
def native_dirs(tmp_path_factory):
    """A tiny Whisper as an HF directory (the port's safetensors writer,
    ``generation_config.json``'s forced ids, the byte-level tokenizer files)
    and the UTMOS oracle's lightning checkpoint."""
    root = tmp_path_factory.mktemp("native")
    whisper = root / "whisper"
    whisper.mkdir()
    n_vocab = 200
    ids = write_tokenizer(whisper, n_vocab)["added"]
    cfg = TW.WhisperConfig(**WHISPER_KW, vocab_size=n_vocab + len(ids), decoder_start_token_id=ids["<|startoftranscript|>"],
                           eos_token_id=ids["<|endoftext|>"])
    model = TW.WhisperForASR(cfg, FLOAT32)
    init_random_weights(model, torch.Generator().manual_seed(1))
    save_file(model.state_dict(), whisper / "model.safetensors")
    (whisper / "config.json").write_text(json.dumps({"model_type": "whisper", **dataclasses.asdict(cfg)}))
    forced = [[1, ids["<|en|>"]], [2, ids["<|transcribe|>"]], [3, ids["<|notimestamps|>"]]]
    (whisper / "generation_config.json").write_text(json.dumps({"forced_decoder_ids": forced}))
    utmos = root / "utmos.ckpt"
    torch.save({"state_dict": _TorchOracle(tiny_ssl_cfg()).lightning_state_dict()}, utmos)
    return whisper, utmos


def test_evaluate_with_native_scorers_equals_jax(decoders, unit_set, native_dirs, monkeypatch):
    """The slice as a whole: ``evaluate`` through ``NativeWhisperASR`` (1-s
    windows) and ``NativeUTMOS`` on both sides, in f32: equal transcripts,
    hence equal WER / CER, the MOS rows within 1e-4."""
    import speech_resynth_tpu.core.precision as jax_precision

    whisper, utmos = native_dirs
    monkeypatch.setattr(jax_precision, "BF16_INFERENCE", JAX_FLOAT32)  # the JAX scorer fixes its policy
    jax_asr = JS.NativeWhisperASR(str(whisper), max_new_tokens=5, chunk_length_s=1.0)
    asr = TS.NativeWhisperASR(whisper, max_new_tokens=5, chunk_length_s=1.0, policy=FLOAT32, device="cpu")
    assert asr.prompt_ids == jax_asr.prompt_ids and len(asr.prompt_ids) == 4
    with jax.default_matmul_precision("highest"):
        jrows, rows = _run_both(decoders, unit_set, "native",
                                {"asr": jax_asr, "mos": JS.NativeUTMOS(str(utmos), policy=JAX_FLOAT32)},
                                {"asr": asr, "mos": TS.NativeUTMOS(utmos, policy=FLOAT32, device="cpu")})
    assert [r[2] for r in rows] == ["NativeWhisperASR"] * 2 + ["NativeUTMOS"] + ["NativeWhisperASR"] * 2 + ["NativeUTMOS"]
    _assert_tables_agree(jrows, rows, unit_set, "native", 1e-4)


def test_default_scorers_raise_instead_of_falling_back(tmp_path):
    """A Whisper directory that does not load raises (the JAX package would
    fall back to a host pipeline); no directory named gives ``NullASR``."""
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(KeyError):
        TS.default_asr(config_from_dict({"asr": {"name": str(tmp_path)}}), device="cpu")
    assert isinstance(TS.default_asr(config_from_dict({})), TS.NullASR)


# -- the CFM loop's dev validation ---------------------------------------------------


DEV_SCALARS = ["dev/CER", "dev/MOS", "dev/MOS (REF)", "dev/WER"]


def test_validate_flow_matching_equals_jax(decoders, unit_set, tmp_path, monkeypatch):
    """Both packages' ``validate_flow_matching`` on the same CFM weights, the
    same exported vocoder (f32 on both sides) and the same noise: the four
    ``dev/`` scalars within 1e-6 and the same five ``hyp/`` clips."""
    jdec, port = decoders
    save_pretrained(tmp_path / "voc", port.vocoder.state_dict(), dataclasses.asdict(port.vocoder.config))
    cfg = {**_eval_config(unit_set, "validate"), "hifigan": {"path": str(tmp_path / "voc")}}
    monkeypatch.setattr(JH, "HifiGanGenerator", functools.partial(JH.HifiGanGenerator, policy=JAX_FLOAT32))
    monkeypatch.setattr(TL, "DEFAULT", FLOAT32)  # the sweep's vocoder policy
    writers = RecordingWriter(), RecordingWriter()
    JL.validate_flow_matching(jax_config(cfg), jdec.model, jdec.model_variables, 7, writers[0])
    noise = lambda i, shape: torch.from_numpy(np.array(jax.random.normal(jax.random.key(0), shape, jnp.float32)))
    TL.validate_flow_matching(config_from_dict(cfg), port.model, 7, writers[1], device="cpu", noise=noise)
    assert sorted(writers[1].scalars_) == sorted(writers[0].scalars_) == DEV_SCALARS
    for k, v in writers[0].scalars_.items():
        assert writers[1].scalars_[k] == pytest.approx(v, abs=1e-6), k
    assert writers[1].clips == writers[0].clips and len(writers[1].clips) == 5


def test_both_cfm_loops_write_the_dev_scalars(unit_set, tmp_path, monkeypatch):
    """One epoch of each package's ``train_flow_matching`` on one tiny config
    with a dev set and a vocoder export: the same ``dev/`` scalar names and
    clip names; WER, CER (``NullASR``) and the reference MOS equal, the
    hypotheses' MOS (each loop its own trained weights and noise) in [1, 5]."""
    from speech_resynth_tpu.models import speech_encoder as JSE
    from speech_resynth_tpu.models.hubert import HubertConfig as JaxHubertConfig
    from speech_resynth_torch.models import speech_encoder as TSE
    from speech_resynth_torch.models.hubert import HubertConfig
    from test_torch_train_loops import FM

    vocoder = TH.HifiGanGenerator(TH.HifiGanConfig(**{**VOC_KW, "model_in_dim": 80}), FLOAT32)
    init_random_weights(vocoder, torch.Generator().manual_seed(0))
    save_pretrained(tmp_path / "voc", vocoder.state_dict(), dataclasses.asdict(vocoder.config))
    rng = np.random.default_rng(0)
    (tmp_path / "spec").mkdir()
    units = json.loads((unit_set / "dev.json").read_text())
    for name, u in units.items():
        u["units"] = [x % FM["vocab_size"] for x in u["units"]]
        np.save(tmp_path / "spec" / f"{name}.npy", rng.standard_normal((len(u["units"]), 80)).astype(np.float32))
    (tmp_path / "units.json").write_text(json.dumps(units))
    hubert = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=24, conv_dim=(8, 8),
                  conv_kernel=(10, 4), conv_stride=(5, 4), num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=2)
    monkeypatch.setitem(TSE.DENSE_MODELS, "_eval_tiny", {"config": HubertConfig(**hubert), "output_layer": 1})
    monkeypatch.setitem(JSE.DENSE_MODELS, "_eval_tiny", {"config": JaxHubertConfig(**hubert), "output_layer": 1})
    writers = {}
    for pkg, loop in (("jax", JL), ("port", TL)):
        monkeypatch.setattr(loop, "MetricsWriter", lambda *a, pkg=pkg, **k: writers.setdefault(pkg, RecordingWriter()))
        cfg = {"common": {"seed": 0},
               "dataset": {"wav_dir": str(unit_set / "wav"), "spectrogram_dir": str(tmp_path / "spec"), "ext_audio": ".wav",
                           "train_file": str(tmp_path / "units.json"), "dev_file": str(tmp_path / "units.json")},
               "flow_matching": {**FM, "dense_model_name": "_eval_tiny", "dim_in": 80, "epoch": 1, "path": str(tmp_path / pkg)},
               "hifigan": {"path": str(tmp_path / "voc")}}
        if pkg == "jax":
            JL.train_flow_matching(jax_config(cfg))
        else:
            TL.train_flow_matching(config_from_dict(cfg), device="cpu")
    jw, pw = writers["jax"], writers["port"]
    assert sorted(k for k in pw.scalars_ if k.startswith("dev/")) == sorted(k for k in jw.scalars_ if k.startswith("dev/")) == DEV_SCALARS
    assert [c[0] for c in pw.clips] == [c[0] for c in jw.clips] and len(pw.clips) == 5
    for k in ("dev/WER", "dev/CER", "dev/MOS (REF)"):
        assert pw.scalars_[k] == pytest.approx(jw.scalars_[k], abs=1e-6), k
    assert 1.0 <= pw.scalars_["dev/MOS"] <= 5.0 and 1.0 <= jw.scalars_["dev/MOS"] <= 5.0
