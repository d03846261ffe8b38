"""Duration prediction and the composed wav -> units -> wav path, against the JAX package.

Covers the length regulator, the duration predictor and ``predict_durations``
(exact integers), ``sample`` and ``synthesize`` of a duration-predicting
decoder (the 64-multiple frame bound, a row with no frames), the
two-directory loader, the config tree, the WAV reader/writer and
``pipeline.synthesize.synthesize`` over a WAV tree for both resynthesis
configs (``predict_duration`` false, and true with deduplicated units).

Tolerances: f32 on both sides with another summation order, as in
tests/test_torch_composite.py: log-mels atol 1e-4, waveforms atol 2e-5.
The composed path runs with truncation 0, so the ODE starts from zero noise
on both sides and needs no shared random numbers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_resynth_tpu.core.config import load_config as jax_load_config
from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.dsp import audio_io as jax_audio_io
from speech_resynth_tpu.models import cfm as jax_cfm
from speech_resynth_tpu.models import composite as jax_composite
from speech_resynth_tpu.models import hifigan as jax_hifigan
from speech_resynth_tpu.models import hubert as jax_hubert
from speech_resynth_tpu.models.kmeans import KMeansQuantizer as JaxQuantizer
from speech_resynth_tpu.models.speech_encoder import SpeechEncoder as JaxSpeechEncoder
from speech_resynth_tpu.ops import length_regulator as jax_lr
from speech_resynth_tpu.pipeline import synthesize as jax_synthesize
from speech_resynth_torch.core.config import config_from_dict, load_config
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.dsp import audio_io
from speech_resynth_torch.models import cfm as torch_cfm
from speech_resynth_torch.models import hifigan as torch_hifigan
from speech_resynth_torch.models import hubert as torch_hubert
from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan
from speech_resynth_torch.models.convert import cfm_state_dict, hifigan_generator_state_dict, hubert_state_dict
from speech_resynth_torch.models.kmeans import KMeansQuantizer
from speech_resynth_torch.models.speech_encoder import SpeechEncoder
from speech_resynth_torch.ops import length_regulator as torch_lr
from speech_resynth_torch.pipeline import synthesize as torch_synthesize
from speech_resynth_torch.pipeline.evaluate import _load_decoder

MEL_TOL = dict(rtol=1e-5, atol=1e-4)
WAV_TOL = dict(rtol=1e-5, atol=2e-5)
DT = 0.5

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
)
VOC_KW = dict(
    model_in_dim=8,
    upsample_initial_channel=16,
    upsample_rates=(5, 4),
    upsample_kernel_sizes=(10, 8),
    resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),),
)
# a tiny HuBERT with the real x320 frame rate, so a 30 s batch is 1500 frames
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


def _reinit(tree, seed):
    """Fan-in-scaled random kernels and small random 1-D tensors, so every
    weight matters and the waveform is O(1)."""
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a, np.float32)
        std = 0.1 if a.ndim == 1 else 1.0 / np.sqrt(np.prod(a.shape[:-1]))
        return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * std)

    return jax.tree_util.tree_map(fill, tree)


def _jax_decoder(predict_duration: bool, seed: int = 0):
    dec = jax_composite.ConditionalFlowMatchingWithHifiGan.from_config(
        jax_cfm.CFMConfig(**CFM_KW, predict_duration=predict_duration), jax_hifigan.HifiGanConfig(**VOC_KW), policy=JAX_FLOAT32
    )
    mvars = dict(dec.model_variables)
    params = dict(_reinit(mvars["params"], seed))
    emb = np.asarray(params["to_cond_emb"]["embedding"])
    params["to_cond_emb"] = {"embedding": jnp.asarray(emb / emb.std())}  # O(1) unit embeddings
    if predict_duration:
        # log-durations of about 1 +- 0.8: durations 0 to ~8 frames, zeros included
        k = np.random.default_rng(seed + 7).standard_normal((3, CFM_KW["dim_cond_emb"], 1)).astype(np.float32)
        params["duration_predictor"] = {
            "kernel": jnp.asarray(k * 0.8 / np.sqrt(3 * CFM_KW["dim_cond_emb"])),
            "bias": jnp.asarray(np.array([1.0], np.float32)),
        }
    mvars["params"] = params
    return jax_composite.ConditionalFlowMatchingWithHifiGan(dec.model, mvars, dec.vocoder, _reinit(dec.vocoder_variables, seed + 1))


def _port_decoder(jdec, predict_duration: bool) -> ConditionalFlowMatchingWithHifiGan:
    model = torch_cfm.ConditionalFlowMatchingModel(torch_cfm.CFMConfig(**CFM_KW, predict_duration=predict_duration), FLOAT32)
    model.load_state_dict(cfm_state_dict(jdec.model_variables))
    vocoder = torch_hifigan.HifiGanGenerator(torch_hifigan.HifiGanConfig(**VOC_KW), FLOAT32)
    vocoder.load_state_dict(hifigan_generator_state_dict(jdec.vocoder_variables["params"]))
    return ConditionalFlowMatchingWithHifiGan(model, vocoder, device="cpu")


@pytest.fixture(scope="module")
def duration_pair():
    jdec = _jax_decoder(predict_duration=True)
    return jdec, _port_decoder(jdec, predict_duration=True)


@pytest.fixture(scope="module")
def plain_pair():
    jdec = _jax_decoder(predict_duration=False, seed=3)
    return jdec, _port_decoder(jdec, predict_duration=False)


def _ids(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, CFM_KW["vocab_size"] + 1, (4, 15))
    ids[1, 9:] = 0
    ids[2, 2:] = 0
    ids[3, :] = 0  # a row with no units: no frames
    return ids


# ---------------------------------------------------------------------------
# length regulator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("out_len", [1, 12, 40])
def test_regulate_length_matches_jax_exactly(out_len):
    rng = np.random.default_rng(out_len)
    hidden = rng.standard_normal((3, 6, 5)).astype(np.float32)
    durations = rng.integers(0, 5, (3, 6)).astype(np.int32)
    durations[2] = 0
    theirs, jmask = jax_lr.regulate_length(jnp.asarray(hidden), jnp.asarray(durations), out_len)
    ours, mask = torch_lr.regulate_length(torch.from_numpy(hidden), torch.from_numpy(durations), out_len)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_regulated_lengths_match_jax():
    durations = np.array([[1, 2, 3], [4, 0, 5]], np.int32)
    token_mask = np.array([[True, True, False], [True, True, True]])
    for tm in (None, token_mask):
        theirs = jax_lr.regulated_lengths(jnp.asarray(durations), None if tm is None else jnp.asarray(tm))
        ours = torch_lr.regulated_lengths(torch.from_numpy(durations), None if tm is None else torch.from_numpy(tm))
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


# ---------------------------------------------------------------------------
# duration predictor, sample and synthesize
# ---------------------------------------------------------------------------


def test_predict_durations_match_jax_exactly(duration_pair):
    jdec, port = duration_pair
    ids = _ids()
    theirs = np.asarray(jdec._predict_durations(jnp.asarray(ids)))
    ours = port.model.predict_durations(torch.from_numpy(ids))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert 0 in theirs[ids != 0] and theirs[ids != 0].max() >= 3  # zeros and long runs both occur
    assert not theirs[ids == 0].any()


def test_duration_predictor_matches_jax_exactly():
    """Random hidden states over a wide range of log-durations: every rounding,
    the clamp at zero and the SAME padding at both ends."""
    rng = np.random.default_rng(11)
    hidden = rng.standard_normal((3, 30, 12)).astype(np.float32) * 2.0
    params = {
        "kernel": rng.standard_normal((3, 12, 1)).astype(np.float32) * 0.3,
        "bias": np.array([0.5], np.float32),
    }
    theirs = jax_cfm.DurationPredictor(12, JAX_FLOAT32).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)}, jnp.asarray(hidden), train=False
    )
    dp = torch_cfm.DurationPredictor(12, FLOAT32)
    dp.load_state_dict({"conv.weight": torch.from_numpy(params["kernel"].transpose(2, 1, 0).copy()), "conv.bias": torch.from_numpy(params["bias"])})
    ours = dp(torch.from_numpy(hidden))
    assert ours.dtype == torch.int32 and ours.shape == (3, 30)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert (ours == 0).any() and ours.max() >= 5


def test_sample_with_durations_matches_jax(duration_pair):
    jdec, port = duration_pair
    ids = _ids(1)
    max_frames = 70
    x0 = np.random.default_rng(2).standard_normal((4, max_frames, CFM_KW["dim_in"])).astype(np.float32)
    theirs, jmask = jdec.model.apply(
        jdec.model_variables, jnp.asarray(ids), dt=DT, truncation_value=1.0, x0=jnp.asarray(x0), max_frames=max_frames,
        method="sample",
    )
    ours, mask = port.model.sample(torch.from_numpy(ids), DT, 1.0, x0=torch.from_numpy(x0), max_frames=max_frames)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **MEL_TOL)
    assert mask.shape == (4, max_frames) and mask.sum() > 0 and not mask[3].any()


def test_synthesize_with_durations_matches_jax(duration_pair):
    jdec, port = duration_pair
    ids = _ids(2)
    bound = jdec._duration_bound(jnp.asarray(ids))
    assert port._duration_bound(torch.from_numpy(ids)) == bound and bound % 64 == 0
    x0 = np.random.default_rng(3).standard_normal((4, bound, CFM_KW["dim_in"])).astype(np.float32)
    mel, jmask = jdec.model.apply(
        jdec.model_variables, jnp.asarray(ids), dt=DT, truncation_value=1.0, x0=jnp.asarray(x0), max_frames=bound,
        method="sample",
    )
    want = np.asarray(jdec.vocoder.apply(jdec.vocoder_variables, mel))
    want_lengths = np.asarray(jdec.vocoder.config.waveform_lengths(jnp.sum(jmask, axis=1)))
    wav, lengths = port.synthesize(ids, DT, 1.0, x0=torch.from_numpy(x0))
    assert wav.shape == want.shape == (4, int(torch_hifigan.HifiGanConfig(**VOC_KW).waveform_lengths(bound)))
    np.testing.assert_array_equal(lengths.numpy(), want_lengths)
    assert lengths[3] == torch_hifigan.HifiGanConfig(**VOC_KW).waveform_lengths(0)  # the row with no frames
    np.testing.assert_allclose(wav.numpy(), want, **WAV_TOL)
    # the JAX package's own jitted path picks the same bound: same output shape
    jwav, jlengths = jdec.synthesize(jnp.asarray(ids), dt=DT, truncation_value=1.0)
    assert jwav.shape == wav.shape
    np.testing.assert_array_equal(np.asarray(jlengths), lengths.numpy())


def test_max_frames_must_equal_the_input_length_without_durations(plain_pair):
    _, port = plain_pair
    with pytest.raises(ValueError, match="max_frames"):
        port.model.sample(torch.ones(1, 4, dtype=torch.long), DT, x0=torch.zeros(1, 4, 8), max_frames=5)


# ---------------------------------------------------------------------------
# loaders and configs
# ---------------------------------------------------------------------------


def test_load_pretrained_reads_the_two_export_dirs(duration_pair, tmp_path):
    from speech_resynth_tpu.models import export

    jdec, port = duration_pair
    fm_dir, voc_dir = tmp_path / "fm" / "hf", tmp_path / "voc"
    export.save_pretrained(fm_dir, export.cfm_state_dict(jdec.model_variables), dataclasses.asdict(jdec.model.config))
    voc_cfg = jdec.vocoder.config
    export.save_pretrained(
        voc_dir,
        export.hifigan_generator_state_dict(jdec.vocoder_variables["params"]),
        {k: getattr(voc_cfg, k) for k in ("model_in_dim", "upsample_initial_channel", "upsample_rates",
                                            "upsample_kernel_sizes", "resblock_kernel_sizes", "resblock_dilation_sizes")},
    )
    config = config_from_dict({
        "flow_matching": {"path": str(tmp_path / "fm")},
        "hifigan": {"path": str(voc_dir)},
        "flow_matching_with_hifigan": {"name": str(tmp_path / "no-such-dir")},
    })
    served = _load_decoder(config, device="cpu")  # bf16 serving policy, as in the JAX package
    assert served.model.config == port.model.config and served.vocoder.config == port.vocoder.config
    loaded = ConditionalFlowMatchingWithHifiGan.load_pretrained(fm_dir, voc_dir, policy=FLOAT32, device="cpu")
    ids = _ids(4)
    x0 = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 128, 8)).astype(np.float32))
    a, _ = loaded.synthesize(ids, DT, 1.0, x0=x0, max_frames=128)
    b, _ = port.synthesize(ids, DT, 1.0, x0=x0, max_frames=128)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(FileNotFoundError, match="no decoder checkpoint"):
        _load_decoder(config_from_dict({**config.to_dict(), "hifigan": {"path": str(tmp_path / "none")}}), device="cpu")


@pytest.mark.parametrize("name", ["mhubert-expresso-2000.yaml", "mhubert-expresso-2000-duration-prediction.yaml"])
def test_config_tree_matches_jax(name):
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "configs" / "resynth" / name
    ours, theirs = load_config(path), jax_load_config(path)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.synthesis.src_dir == theirs.synthesis.src_dir == "data/LibriTTS_R_16k"
    assert ours.flow_matching.get("predict_duration", False) == ("duration" in name)


def test_audio_io_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    wavs = [np.clip(rng.standard_normal(n) * 0.3, -1, 1).astype(np.float32) for n in (1600, 999, 2500)]
    paths = []
    for i, w in enumerate(wavs):
        paths.append(tmp_path / f"d{i}" / f"{i}.wav")
        audio_io.write(paths[-1], w, 16000)
    for p, w in zip(paths, wavs):
        ours, sr = audio_io.read(p)
        theirs, jsr = jax_audio_io.read(p)
        assert sr == jsr == 16000 and audio_io.info(p) == (16000, 1, len(w))
        np.testing.assert_array_equal(ours, theirs)
        assert np.abs(ours - w).max() <= 2.0 / 32767  # PCM16: scaled by 32767 on write, 32768 on read
    batch, lengths, srs = audio_io.read_batch(paths + [tmp_path / "missing.wav"], 2000)
    jbatch, jlengths, jsrs = jax_audio_io.read_batch(paths + [tmp_path / "missing.wav"], 2000)
    np.testing.assert_array_equal(batch, jbatch)
    np.testing.assert_array_equal(lengths, jlengths)
    assert lengths.tolist() == [1600, 999, 2000, -1]


# ---------------------------------------------------------------------------
# the composed path: wav tree -> units -> wav tree
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoder_pair():
    cfg = jax_hubert.HubertConfig(**HUBERT_KW)
    enc = jax_hubert.HubertEncoder(cfg, policy=JAX_FLOAT32)
    variables = enc.init(jax.random.key(4), jnp.zeros((1, 4000), jnp.float32))
    rng = np.random.default_rng(8)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a) if np.asarray(a).any() else jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.1),
        variables["params"],
    )
    centers = rng.standard_normal((12, cfg.hidden_size)).astype(np.float32) * 2.0
    port = torch_hubert.HubertEncoder(torch_hubert.HubertConfig(**HUBERT_KW), FLOAT32)
    port.load_state_dict(hubert_state_dict(params))
    pairs = {}
    for dedup in (False, True):
        pairs[dedup] = (
            JaxSpeechEncoder(enc, {"params": params}, JaxQuantizer(jnp.asarray(centers)), cfg.num_hidden_layers, dedup),
            SpeechEncoder(port.eval(), KMeansQuantizer(torch.from_numpy(centers)), cfg.num_hidden_layers, dedup),
        )
    return pairs


@pytest.fixture(scope="module")
def wav_tree(tmp_path_factory):
    src = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(9)
    for i, n in enumerate((4800, 7000, 5555, 6400)):
        t = np.arange(n) / 16000.0
        wav = 0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t * (1 + t)) + 0.05 * rng.standard_normal(n)
        audio_io.write(src / "test-clean" / f"spk{i % 2}" / f"utt{i}.wav", wav.astype(np.float32), 16000)
    audio_io.write(src / "train-clean" / "x.wav", np.zeros(1600, np.float32), 16000)  # outside the split
    return src


def _captured_writes(monkeypatch, module):
    """Record each waveform the pipeline writes (before PCM16 rounding)."""
    written = {}
    write = module.audio_io.write

    def capture(path, samples, sample_rate):
        written[str(path)] = np.array(samples, np.float32)
        write(path, samples, sample_rate)

    monkeypatch.setattr(module.audio_io, "write", capture)
    return written


@pytest.mark.parametrize("predict_duration", [False, True])
def test_pipeline_synthesize_matches_jax(encoder_pair, duration_pair, plain_pair, wav_tree, tmp_path, monkeypatch, predict_duration):
    jdec, port = duration_pair if predict_duration else plain_pair
    jenc, tenc = encoder_pair[predict_duration]

    def config(tgt):
        return config_from_dict({
            "common": {"seed": 0},
            "synthesis": {"src_dir": str(wav_tree), "tgt_dir": str(tgt), "split": "test-*", "ext_audio": ".wav"},
            "flow_matching": {"dt": DT, "truncation_value": 0.0, "predict_duration": predict_duration},
            "flow_matching_with_hifigan": {"batch_size": 2},
        })

    theirs = _captured_writes(monkeypatch, jax_synthesize)
    jax_synthesize.synthesize(config(tmp_path / "jax"), encoder=jenc, decoder=jdec)
    monkeypatch.undo()
    ours = _captured_writes(monkeypatch, torch_synthesize)
    torch_synthesize.synthesize(config(tmp_path / "port"), encoder=tenc, decoder=port)

    names = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.wav"))
    assert [str(n) for n in names] == sorted(f"test-clean/spk{i % 2}/utt{i}.wav" for i in range(4))
    assert names == sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.wav"))
    assert len(ours) == len(theirs) == 4
    for name in names:
        o, t = ours[str(tmp_path / "port" / name)], theirs[str(tmp_path / "jax" / name)]
        assert o.shape == t.shape and audio_io.info(tmp_path / "port" / name)[2] == len(o)
        np.testing.assert_allclose(o, t, **WAV_TOL)
    assert max(np.abs(w).max() for w in ours.values()) > 0.05  # O(1) output: the comparison means something
