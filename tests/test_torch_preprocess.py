"""The port's preprocessing front end against the JAX package.

Covers the log-mel front end (``dsp/mel.py``), the polyphase resampler
(``dsp/resample.py``), the VAD (``dsp/vad.py``), the k-means fit
(``models/kmeans.py``), the datasets the stages read (``pipeline/data.py``)
and the three preprocess stages (``pipeline/preprocess.py``), at small sizes
with seeded inputs, on the CPU.

Tolerances: f32 on both sides (JAX at "highest" matmul precision) with the
same formulas and another summation order. The filterbank is numpy on both
sides (1e-7). Magnitudes and log-mels atol 1e-4 on broadband input, where
every mel bin is within ~30 dB of its frame's loudest: the log of a bin
turns the f32 rounding of the STFT sums (relative to the frame's energy)
into an error that grows as the bin gets quieter. On the pipeline corpus (a
pure tone over 0.01 noise, bins ~40 dB down) the JAX package's own f32
log-mel differs from an f64 evaluation of the same formula by up to 2.8e-4,
so the cached mels there are held at 5e-4. Resampled samples atol 1e-5 (O(1)
samples, sums of ~34 taps). The stages write PCM16 files: files of the two
packages agree within one PCM16 step (1/32767), as a rounding of 1e-7 can
cross a step boundary, and a file against the float samples it was written
from within two. Unit JSONs compare exactly (the units are clear of ties).
k-means centers atol 1e-5 and inertia rtol 1e-5.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_resynth_torch.core.config import config_from_dict
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.dsp import audio_io
from speech_resynth_torch.dsp import mel as TM
from speech_resynth_torch.dsp import resample as TR
from speech_resynth_torch.dsp import vad as TV
from speech_resynth_torch.models import hubert as torch_hubert
from speech_resynth_torch.models import kmeans as TK
from speech_resynth_torch.models import speech_encoder as torch_se
from speech_resynth_torch.models.convert import hubert_state_dict
from speech_resynth_torch.pipeline import data as torch_data
from speech_resynth_torch.pipeline import preprocess as torch_pre
from speech_resynth_tpu.core.config import config_from_dict as jax_config_from_dict
from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.dsp import mel as JM
from speech_resynth_tpu.dsp import resample as JR
from speech_resynth_tpu.dsp import vad as JV
from speech_resynth_tpu.models import hubert as jax_hubert
from speech_resynth_tpu.models import kmeans as JK
from speech_resynth_tpu.models.kmeans import KMeansQuantizer as JaxQuantizer
from speech_resynth_tpu.models.speech_encoder import SpeechEncoder as JaxSpeechEncoder
from speech_resynth_tpu.pipeline import data as jax_data
from speech_resynth_tpu.pipeline import preprocess as jax_pre

MEL_TOL = dict(rtol=0, atol=1e-4)
CORPUS_MEL_TOL = dict(rtol=0, atol=5e-4)
PCM16_STEP = 1.0 / 32767


def _speech(seed, shape, scale=0.3, noise=0.02):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 16000.0
    tone = np.sin(2 * np.pi * rng.uniform(150, 400, shape[:-1] + (1,)) * t)
    return (scale * tone + noise * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# mel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(16000, 400, 80, 0.0, 8000.0), (16000, 400, 128, 0.0, 8000.0), (22050, 1024, 80, 0.0, 8000.0)])
def test_mel_filterbank_equals_jax(args):
    np.testing.assert_allclose(TM.mel_filterbank(*args), JM.mel_filterbank(*args), rtol=0, atol=1e-7)
    assert TM.MEL_PAD_VALUE == JM.MEL_PAD_VALUE


@pytest.mark.parametrize("fn", ["stft_magnitude", "log_mel_spectrogram", "mel_spectrogram", "whisper_log_mel"])
def test_mel_front_ends_equal_jax(fn):
    y = _speech(1, (2, 3, 7000), noise=0.1)  # broadband: no mel bin far below its frame's loudest
    ours = getattr(TM, fn)(torch.from_numpy(y)).numpy()
    theirs = np.asarray(getattr(JM, fn)(jnp.asarray(y)))
    assert ours.shape == theirs.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, **MEL_TOL)


@pytest.mark.parametrize("T,expected", [(0, 0), (120, 0), (399, 0), (400, 1), (719, 1), (720, 2), (16080, 50)])
def test_frame_count(T, expected):
    """1 + (T - 400) // 320 frames, and none below 400 samples (no error)."""
    out = TM.log_mel_spectrogram(torch.from_numpy(_speech(2, (2, T))))
    assert out.shape == (2, expected, 80) == np.asarray(JM.log_mel_spectrogram(jnp.asarray(_speech(2, (2, T))))).shape


# ---------------------------------------------------------------------------
# resample
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("orig,new", [(24000, 16000), (44100, 16000), (22050, 16000), (48000, 16000), (8000, 16000), (16000, 16000)])
@pytest.mark.parametrize("shape", [(4411,), (3, 2205), (2, 2, 1001), (1, 1)])
def test_resample_equals_jax(orig, new, shape):
    x = _speech(3, shape)
    ours = TR.resample(torch.from_numpy(x), orig, new)
    theirs = np.asarray(JR.resample(jnp.asarray(x), orig, new))
    assert ours.shape == theirs.shape == shape[:-1] + (-(-shape[-1] * new // orig),)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-5)


def test_resample_polyphase_allocates_no_zero_stuffed_input():
    """10 s at 44.1 kHz (L = 160, M = 441): no tensor of the run comes near
    the L x T floats a zero-stuffed input would take (its largest is about
    twice the input: the padded input and the strided windows' copy)."""
    x = _speech(4, (1, 441000))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], profile_memory=True) as prof:
        ours = TR.resample(torch.from_numpy(x), 44100, 16000)
    largest = max(e.cpu_memory_usage for e in prof.key_averages())
    assert 0 < largest < 4 * x.nbytes < 160 * x.nbytes
    assert ours.shape == (1, 160000) and torch.isfinite(ours).all()


def test_sinc_kernel_equals_jax():
    for args in ((44100, 16000, 6, 0.99), (8000, 16000, 6, 0.99), (24000, 16000, 4, 0.9)):
        np.testing.assert_array_equal(TR._sinc_kernel(*args), JR._sinc_kernel(*args))


# ---------------------------------------------------------------------------
# VAD
# ---------------------------------------------------------------------------


def _padded_tone():
    sr = 16000
    return np.concatenate([np.zeros(sr // 2), 0.5 * np.sin(2 * np.pi * 440 * np.arange(sr) / sr), np.zeros(sr // 3)]).astype(np.float32)


@pytest.mark.parametrize("case", ["tone", "stereo", "all_silence", "short"])
def test_trim_equals_jax(case):
    sig = {"tone": _padded_tone(), "stereo": np.stack([_padded_tone(), 0.5 * _padded_tone()]),
           "all_silence": np.zeros(4000, np.float32) + 1e-8, "short": _padded_tone()[7900:8900]}[case]
    ours, span = TV.trim(sig, top_db=20)
    theirs, jax_span = JV.trim(sig, top_db=20)
    assert span == jax_span
    np.testing.assert_array_equal(ours, theirs)
    if case == "tone":
        assert span[0] > 0 and span[1] < len(sig)


def test_trim_mask_equals_jax():
    sig = np.stack([
        np.concatenate([np.zeros(2000), 0.3 * np.random.default_rng(2).standard_normal(4000), np.zeros(2000)]),
        np.zeros(8000),  # all silence
        0.3 * np.random.default_rng(3).standard_normal(8000),
    ]).astype(np.float32)
    ours = TV.trim_mask(torch.from_numpy(sig), top_db=20, frame_length=512, hop_length=128).numpy()
    theirs = np.asarray(JV.trim_mask(jnp.asarray(sig), top_db=20, frame_length=512, hop_length=128))
    np.testing.assert_array_equal(ours, theirs)
    assert ours[1].all() and ours[0].any() and not ours[0].all()  # a uniform row is kept whole, as librosa keeps it


# ---------------------------------------------------------------------------
# k-means fit
# ---------------------------------------------------------------------------


def _clustered(seed, n, d, k, spread=3.0):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((k, d)) * spread
    return (means[rng.integers(0, k, n)] + rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("k,iters", [(8, 10), (5, 0), (16, 3)])
def test_lloyd_from_the_jax_init_equals_jax_kmeans_fit(k, iters):
    data = _clustered(10 + k, 600, 12, k)
    key = jax.random.key(k)
    init = np.array(JK._plusplus_init(key, jnp.asarray(data), k))
    centers, inertia = JK.kmeans_fit(key, jnp.asarray(data), k, iters=iters)
    ours, our_inertia = TK.lloyd(torch.from_numpy(data), torch.from_numpy(init), iters)
    np.testing.assert_allclose(ours.numpy(), np.asarray(centers), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(our_inertia), float(inertia), rtol=1e-5)


def test_lloyd_keeps_a_center_without_frames():
    data = torch.from_numpy(_clustered(20, 200, 4, 2))
    centers = torch.cat([data[:2], torch.full((1, 4), 1e3)])  # the third center wins no frame
    out, _ = TK.lloyd(data, centers, 2)
    assert torch.equal(out[2], centers[2])


def test_plusplus_init_picks_distinct_rows_reproducibly():
    data = torch.from_numpy(_clustered(21, 300, 6, 10))
    a = TK._plusplus_init(torch.Generator().manual_seed(4), data, 10)
    b = TK._plusplus_init(torch.Generator().manual_seed(4), data, 10)
    c = TK._plusplus_init(torch.Generator().manual_seed(5), data, 10)
    assert torch.equal(a, b) and not torch.equal(a, c)
    rows = [int(torch.nonzero((data == a[i]).all(dim=1))[0]) for i in range(10)]
    assert len(set(rows)) == 10


def test_plusplus_init_takes_one_center_per_far_cluster():
    rng = np.random.default_rng(22)
    data = np.concatenate([rng.standard_normal((100, 3)) * 0.1, 100.0 + rng.standard_normal((100, 3)) * 0.1]).astype(np.float32)
    for seed in range(5):
        centers = TK._plusplus_init(torch.Generator().manual_seed(seed), torch.from_numpy(data), 2)
        assert sorted(int(c[0] > 50) for c in centers) == [0, 1]


def test_kmeans_fit_recovers_separated_clusters():
    data = _clustered(23, 500, 5, 4, spread=20.0)
    centers, inertia = TK.kmeans_fit(torch.from_numpy(data), 4, iters=10, generator=torch.Generator().manual_seed(1))
    assert centers.shape == (4, 5) and float(inertia) / len(data) < 2 * 5  # about the unit noise per dimension
    random_init, _ = TK.kmeans_fit(torch.from_numpy(data), 4, iters=0, init="random", generator=torch.Generator().manual_seed(1))
    assert len({tuple(r) for r in random_init.tolist()}) == 4


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def libri_trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("libri")
    tts, ls = root / "tts", root / "ls"
    for i, (split, spk, chap) in enumerate((("train-clean-100", "1", "10"), ("train-clean-100", "2", "20"), ("dev-clean", "3", "30"))):
        for utt in ("0001", "0002"):
            name = f"{spk}_{chap}_{utt}"
            audio_io.write(tts / split / spk / chap / f"{name}.wav", _speech(i, (1600 + 160 * i,))[0], 24000)
            if utt == "0001":
                (tts / split / spk / chap / f"{name}.normalized.txt").write_text(f"text of {name}\n")
            audio_io.write(ls / split / spk / chap / f"{spk}-{chap}-{utt}.wav", _speech(i, (800,))[0], 16000)
        (ls / split / spk / chap / f"{spk}-{chap}.trans.txt").write_text(f"{spk}-{chap}-0001 FIRST LINE\n{spk}-{chap}-0002 SECOND\n")
    (tts / "train-clean-100" / "9").mkdir(parents=True)
    (tts / "train-clean-100" / "9" / "bad.wav").write_bytes(b"RIFF")
    return tts, ls


@pytest.mark.parametrize("kind", ["SpeechDataset", "LibriTTS_R", "LibriSpeech"])
def test_datasets_give_the_jax_batches(libri_trees, kind):
    tts, ls = libri_trees
    wav_dir = ls if kind == "LibriSpeech" else tts
    ours = list(getattr(torch_data, kind)(str(wav_dir), split="*").batches(3, max_seconds=0.5))
    theirs = list(getattr(jax_data, kind)(str(wav_dir), split="*").batches(3, max_seconds=0.5))
    assert len(ours) == len(theirs) >= 2
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys() == {"input_values", "wavs_len", "sample_rates", "names", "transcripts", "paths"}
        for key in ("input_values", "wavs_len", "sample_rates"):
            np.testing.assert_array_equal(a[key], b[key])
        assert a["names"] == b["names"] and a["transcripts"] == b["transcripts"] and a["paths"] == b["paths"]
    transcripts = [t for batch in ours for t in batch["transcripts"]]
    assert kind == "SpeechDataset" and not any(transcripts) or kind != "SpeechDataset" and any(transcripts)


def test_transcripts_resolve_against_txt_dir(libri_trees, tmp_path):
    tts, _ = libri_trees
    ours = torch_data.LibriTTS_R(str(tts), str(tts), split="dev-clean")
    other = torch_data.LibriTTS_R(str(tts), str(tmp_path), split="dev-clean")
    assert ours.transcript_of(ours.wav_paths[0]) == "text of 3_30_0001" and other.transcript_of(other.wav_paths[0]) == ""
    assert ours.ext_txt == ".normalized.txt" and torch_data.SpeechDataset(str(tts)).ext_txt is None


# ---------------------------------------------------------------------------
# preprocess stages
# ---------------------------------------------------------------------------

HUBERT_KW = dict(
    hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=24, conv_dim=(8, 8, 8),
    conv_kernel=(10, 8, 4), conv_stride=(5, 8, 8), num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=2,
)
N_UNITS = 9


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The LibriTTS-R-shaped tree of tests/test_pipeline.py: 4 utterances at
    24 kHz (train, train, dev, test) with transcripts."""
    root = tmp_path_factory.mktemp("corpus")
    orig = root / "orig"
    rng = np.random.default_rng(0)
    for split, spk in [("train-clean-100", "1"), ("train-clean-100", "2"), ("dev-clean", "3"), ("test-clean", "4")]:
        name = f"{split}/{spk}/c1/utt{spk}"
        wav = (0.3 * np.sin(2 * np.pi * (200 + 100 * int(spk)) * np.arange(12000) / 24000)).astype(np.float32)
        wav += 0.01 * rng.standard_normal(12000).astype(np.float32)
        audio_io.write(orig / (name + ".wav"), wav, 24000)
        (orig / (name + ".normalized.txt")).write_text(f"utterance {spk}\n")
    return root


def _pre_config(root, out, wav_dir):
    return {
        "dataset": {
            "wav_dir": str(wav_dir), "wav_dir_orig": str(root / "orig"), "spectrogram_dir": str(out / "spec"),
            "vad": False, "preprocess_batch_size": 2, "ext_audio": ".wav",
            "train_file": str(out / "units/train.json"), "dev_file": str(out / "units/dev.json"), "test_file": str(out / "units/test.json"),
        },
        "flow_matching": {"dense_model_name": "unused", "quantizer_model_name": "kmeans", "vocab_size": N_UNITS, "predict_duration": False},
    }


@pytest.fixture(scope="module")
def stage_runs(corpus):
    """The JAX package's three stages, and the port's: its resample into its
    own tree, then tokenize and extract_features on the JAX package's 16 kHz
    tree (both encoders f32 on one tiny HuBERT's weights, 9 centers clear of
    ties on these files)."""
    jcfg = jax_hubert.HubertConfig(**HUBERT_KW)
    enc = jax_hubert.HubertEncoder(jcfg, policy=JAX_FLOAT32)
    variables = enc.init(jax.random.key(0), jnp.zeros((1, 800), jnp.float32))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a) if np.asarray(a).any() else jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.1),
        variables["params"],
    )
    centers = np.random.default_rng(2).standard_normal((N_UNITS, jcfg.hidden_size)).astype(np.float32) * 2.0
    jax_enc = JaxSpeechEncoder(encoder=enc, variables={"params": params}, quantizer=JaxQuantizer(jnp.asarray(centers)), output_layer=1)
    port = torch_hubert.HubertEncoder(torch_hubert.HubertConfig(**HUBERT_KW), FLOAT32)
    port.load_state_dict(hubert_state_dict(params))
    port_enc = torch_se.SpeechEncoder(encoder=port.eval(), quantizer=TK.KMeansQuantizer(torch.from_numpy(centers)), output_layer=1)

    jax_out, port_out = corpus / "jax", corpus / "port"
    jconf = jax_config_from_dict(_pre_config(corpus, jax_out, jax_out / "16k"))
    jax_pre.resample(jconf)
    jax_pre.tokenize(jconf, encoder=jax_enc)
    jax_pre.extract_features(jconf)
    torch_pre.resample(config_from_dict(_pre_config(corpus, port_out, port_out / "16k")), device="cpu")
    pconf = config_from_dict(_pre_config(corpus, port_out, jax_out / "16k"))
    torch_pre.tokenize(pconf, encoder=port_enc)
    torch_pre.extract_features(pconf, device="cpu")
    for path in sorted((jax_out / "16k").glob("**/*.wav")):
        wav, _ = audio_io.read(path)
        with torch.no_grad():
            feats = port(torch.from_numpy(wav)[None], output_layer=1)[0]
        top2 = (feats @ torch.from_numpy(centers).T - torch.from_numpy(centers).pow(2).sum(-1) / 2).topk(2).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-3
    return jax_out, port_out, pconf


def test_resample_stage_equals_jax(stage_runs, corpus):
    jax_out, port_out, _ = stage_runs
    ours, theirs = sorted((port_out / "16k").glob("**/*.wav")), sorted((jax_out / "16k").glob("**/*.wav"))
    assert [p.relative_to(port_out) for p in ours] == [p.relative_to(jax_out) for p in theirs] and len(ours) == 4
    for a, b in zip(ours, theirs):
        assert audio_io.info(a) == audio_io.info(b) == (16000, 1, 8000)  # ceil(12 000 * 2 / 3)
        np.testing.assert_allclose(audio_io.read(a)[0], audio_io.read(b)[0], rtol=0, atol=PCM16_STEP * 1.01)
    # the stage's resampled batch before the PCM16 write: the op the stage ran
    wavs, _, _ = audio_io.read_batch(sorted((corpus / "orig").glob("**/*.wav"))[:2], 12000)
    np.testing.assert_allclose(torch_pre.resample_op(torch.from_numpy(wavs), 24000, 16000).numpy(),
                               np.asarray(JR.resample(jnp.asarray(wavs), 24000, 16000)), rtol=0, atol=1e-5)


def test_resample_stage_trims_with_vad(corpus, tmp_path):
    """``dataset.vad``: each file is the host trim of its resampled samples."""
    cfg = _pre_config(corpus, tmp_path, tmp_path / "16k")
    cfg["dataset"]["vad"] = True
    quiet = corpus / "orig_vad"
    wav = np.concatenate([np.zeros(9000), 0.4 * np.sin(2 * np.pi * 300 * np.arange(12000) / 24000), np.zeros(6000)])
    audio_io.write(quiet / "train-clean-100/5/c1/utt5.wav", wav.astype(np.float32), 24000)
    cfg["dataset"]["wav_dir_orig"] = str(quiet)
    torch_pre.resample(config_from_dict(cfg), device="cpu")
    out, sr = audio_io.read(tmp_path / "16k/train-clean-100/5/c1/utt5.wav")
    full = TR.resample(torch.from_numpy(audio_io.read(quiet / "train-clean-100/5/c1/utt5.wav")[0]), 24000, 16000).numpy()
    trimmed, (start, end) = JV.trim(full, top_db=20)
    assert sr == 16000 and len(out) == end - start < len(full) == 18000
    np.testing.assert_allclose(out, trimmed, rtol=0, atol=2 * PCM16_STEP)


def test_tokenize_stage_equals_jax(stage_runs):
    jax_out, port_out, _ = stage_runs
    for split in ("train", "dev", "test"):
        ours = json.loads((port_out / f"units/{split}.json").read_text())
        assert ours == json.loads((jax_out / f"units/{split}.json").read_text()), split
        for entry in ours.values():
            assert len(entry["units"]) == len(entry["durations"]) > 0
    # dev and test transcripts resolve against wav_dir_orig; train against the 16 kHz tree, which has none
    assert next(iter(json.loads((port_out / "units/dev.json").read_text()).values()))["transcript"] == "utterance 3"
    assert next(iter(json.loads((port_out / "units/train.json").read_text()).values()))["transcript"] == ""


def test_extract_features_stage_equals_jax_and_is_idempotent(stage_runs):
    jax_out, port_out, pconf = stage_runs
    ours, theirs = sorted((port_out / "spec").glob("**/*.npy")), sorted((jax_out / "spec").glob("**/*.npy"))
    assert [p.relative_to(port_out) for p in ours] == [p.relative_to(jax_out) for p in theirs] and len(ours) == 4
    for a, b in zip(ours, theirs):
        mel = np.load(a)
        assert mel.shape == (1 + (8000 - 400) // 320, 80) and mel.dtype == np.float32
        np.testing.assert_allclose(mel, np.load(b), **CORPUS_MEL_TOL)
    stamps = [p.stat().st_mtime_ns for p in ours]
    torch_pre.extract_features(pconf, device="cpu")
    assert [p.stat().st_mtime_ns for p in ours] == stamps


def test_stages_default_to_the_card(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config_from_dict(_pre_config(corpus, corpus / "none", corpus / "none16k"))
    for stage in (torch_pre.resample, torch_pre.extract_features, torch_pre.preprocess):
        with pytest.raises(RuntimeError, match="CUDA"):
            stage(cfg)


def test_bucket_equals_jax():
    for n in (1, 80000, 80001, 640000, 10**7):
        assert torch_pre._bucket(n, torch_pre.BUCKETS) == jax_pre._bucket(n, (16000 * 5, 16000 * 10, 16000 * 20, 16000 * 40))
