"""The port's file formats against the JAX package's and TensorBoard's.

* Exports: the port's CFM, HiFi-GAN, speech-LM and composite exports are
  ``config.json`` + ``model.safetensors``, the files the JAX package writes,
  and the JAX loaders read them to the port's arrays.
* Event files: ``core.tbevents`` (no tensorboardX) writes what TensorBoard's
  ``EventAccumulator`` reads back equal, reads what tensorboardX writes,
  raises on a CRC mismatch and stops quietly at a truncated final record;
  ``MetricsWriter``'s audio decodes to its PCM16 wav and its spectrogram
  figure is skipped without matplotlib.
"""

import io
import sys
import types

import numpy as np
import pytest
import torch

from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.models import composite as jax_composite
from speech_resynth_tpu.models import export as jax_export
from speech_resynth_tpu.pipeline import speechlm as jax_speechlm
from speech_resynth_torch.core import tbevents
from speech_resynth_torch.core.config import config_from_dict
from speech_resynth_torch.core.metrics import MetricsWriter
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.models.cfm import CFMConfig, ConditionalFlowMatchingModel
from speech_resynth_torch.models.composite import init_random_weights
from speech_resynth_torch.models.convert import save_composite_pretrained
from speech_resynth_torch.models.hifigan import HifiGanConfig, HifiGanGenerator
from speech_resynth_torch.models.llama import LlamaConfig, LlamaLM
from speech_resynth_torch.pipeline import train_loops
from test_torch_composite import CFM_KW, VOC_KW


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def event_accumulator():
    """TensorBoard's ``EventAccumulator`` on its own TensorFlow stub (as its
    no-TensorFlow build runs it): reading event files needs no TensorFlow,
    whose import takes ~12 s where it is installed."""
    sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))
    return pytest.importorskip("tensorboard.backend.event_processing.event_accumulator").EventAccumulator


def _np(sd) -> dict:
    return {k: v.detach().float().numpy() for k, v in sd.items()}


def assert_arrays_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k], np.float32), v, err_msg=k)


def test_jax_loaders_read_the_port_exports(tmp_path):
    """The port's four export kinds, written by the loops' exporters and
    ``save_composite_pretrained``: the JAX export's file names, and the JAX
    ``_load_state_dict``, ``load_pretrained``, ``from_pretrained`` and
    ``load_lm_from_hf`` read them to the port's state dicts."""
    cfm = ConditionalFlowMatchingModel(CFMConfig(**CFM_KW), FLOAT32)
    voc_config = HifiGanConfig(**VOC_KW)
    gen = HifiGanGenerator(voc_config, FLOAT32)
    lm_config = LlamaConfig(vocab_size=24, hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2)
    lm = LlamaLM(lm_config, FLOAT32)
    for i, module in enumerate((cfm, gen, lm)):
        init_random_weights(module, torch.Generator().manual_seed(40 + i))
    config = config_from_dict({"flow_matching": {"path": str(tmp_path / "cfm")}, "hifigan": {"path": str(tmp_path / "voc")},
                               "model": {"path": str(tmp_path / "lm")}})
    train_loops._export_cfm(config, cfm.config, cfm)
    train_loops._export_hifigan(config, voc_config, gen)
    train_loops._export_speechlm(config, lm_config, lm.state_dict())
    save_composite_pretrained(tmp_path / "composite", cfm, gen)
    jax_export.save_pretrained(tmp_path / "jax_written", {"w": np.zeros(3, np.float32)}, {})
    names = sorted(p.name for p in (tmp_path / "jax_written").iterdir())
    exports = {"cfm": (tmp_path / "cfm" / "hf", _np(cfm.state_dict())), "voc": (tmp_path / "voc", _np(gen.state_dict())),
               "lm": (tmp_path / "lm" / "hf", _np(lm.state_dict())),
               "composite": (tmp_path / "composite", {**{f"model.{k}": v for k, v in _np(cfm.state_dict()).items()},
                                                      **{f"vocoder.{k}": v for k, v in _np(gen.state_dict()).items()}})}
    for name, (path, want) in exports.items():
        assert sorted(p.name for p in path.iterdir()) == names == ["config.json", "model.safetensors"], name
        assert_arrays_equal(jax_composite._load_state_dict(path), want)

    pair = jax_composite.ConditionalFlowMatchingWithHifiGan.load_pretrained(str(tmp_path / "cfm" / "hf"), str(tmp_path / "voc"),
                                                                            policy=JAX_FLOAT32)
    whole = jax_composite.ConditionalFlowMatchingWithHifiGan.from_pretrained(str(tmp_path / "composite"), policy=JAX_FLOAT32)
    for dec in (pair, whole):
        assert_arrays_equal(jax_export.cfm_state_dict(dec.model_variables), exports["cfm"][1])
        assert_arrays_equal(jax_export.hifigan_generator_state_dict(dec.vocoder_variables["params"]), exports["voc"][1])
    _, variables = jax_speechlm.load_lm_from_hf(str(tmp_path / "lm" / "hf"), policy=JAX_FLOAT32)
    assert_arrays_equal(jax_export.llama_state_dict(variables["params"]), exports["lm"][1])


# -- event files ----------------------------------------------------------------


def _write_run(log_dir, rng):
    """Scalars of a few tags over 12 steps (one NaN) and an audio clip."""
    writer = MetricsWriter(log_dir)
    written = {}
    for step in range(1, 13):
        values = {"loss_gen": float(rng.uniform(0, 5)), "lr": 2e-4 * 0.999 ** step}
        if step == 7:
            values["loss_gen"] = float("nan")
        writer.scalars(values, step, prefix="training/")
        if step % 4 == 0:
            writer.scalar("validation/mel_spec_error", float(rng.uniform(0, 2)), step)
    wave = (0.5 * np.sin(np.arange(3200) / 7.0)).astype(np.float32)
    writer.audio("generated/y_hat_0", wave, 12)
    writer.close()
    return wave


def test_port_events_read_back_through_tensorboard(tmp_path):
    EventAccumulator = event_accumulator()
    wave = _write_run(tmp_path, np.random.default_rng(0))
    acc = EventAccumulator(str(tmp_path), size_guidance={"scalars": 0, "audio": 0})
    acc.Reload()
    theirs = {t: [(e.step, e.value, e.wall_time) for e in acc.Scalars(t)] for t in acc.Tags()["scalars"]}
    ours = tbevents.read_scalars(tmp_path)
    assert list(theirs) == list(ours) == ["training/loss_gen", "training/lr", "validation/mel_spec_error"]
    for tag in ours:
        assert len(ours[tag]) == len(theirs[tag]) == (3 if tag.startswith("validation") else 12)
        for (s0, v0, w0), (s1, v1, w1) in zip(ours[tag], theirs[tag]):
            assert (s0, w0) == (s1, w1) and (v0 == v1 or (np.isnan(v0) and np.isnan(v1)))
    (clip,) = acc.Audio("generated/y_hat_0")
    from scipy.io import wavfile

    rate, pcm = wavfile.read(io.BytesIO(clip.encoded_audio_string))
    assert (clip.step, rate, clip.length_frames, clip.content_type) == (12, 16000, 3200, "audio/wav")
    np.testing.assert_array_equal(pcm, (wave * 32767).astype(np.int16))
    audio = [v["audio"] for ev in tbevents.read_events(tmp_path) for v in ev.get("values", ()) if "audio" in v]
    assert audio[0]["encoded_audio_string"] == clip.encoded_audio_string


def test_tensorboardx_events_read_back_through_the_port(tmp_path):
    SummaryWriter = pytest.importorskip("tensorboardX").SummaryWriter
    writer = SummaryWriter(str(tmp_path))
    want = {"a": [], "b/c": []}
    for step in range(5):
        for tag, scale in (("a", 1.0), ("b/c", -3.0)):
            value, wall = scale * step + 0.1, 1.7e9 + step + (0.5 if tag == "a" else 0.25)
            writer.add_scalar(tag, value, step, walltime=wall)
            want[tag].append((step, float(np.float32(value)), wall))
    writer.close()
    assert tbevents.read_scalars(tmp_path) == want
    (header,) = [ev for ev in tbevents.read_events(tmp_path) if "file_version" in ev]
    assert header["file_version"] == "brain.Event:2"


def test_a_flipped_byte_raises_and_a_truncated_tail_ends_quietly(tmp_path):
    writer = tbevents.EventWriter(tmp_path)
    for step in range(3):
        writer.add([tbevents.scalar_value("x", step * 1.5)], step)
    writer.close()
    data = writer.path.read_bytes()
    assert [s for s, _, _ in tbevents.read_scalars(tmp_path)["x"]] == [0, 1, 2]
    writer.path.write_bytes(data[:-5])  # the last record cut mid-data
    assert [s for s, _, _ in tbevents.read_scalars(tmp_path)["x"]] == [0, 1]
    for at in (len(data) - 10, 3):  # a data byte of the last record, a length byte of the first
        broken = bytearray(data)
        broken[at] ^= 0x01
        writer.path.write_bytes(bytes(broken))
        with pytest.raises(tbevents.CorruptRecordError):
            tbevents.read_scalars(tmp_path)


def test_crc32c_known_answer():
    assert tbevents.crc32c(b"123456789") == 0xE3069283  # the Castagnoli check value
    assert tbevents.crc32c(b"") == 0


def test_spectrogram_figure_without_matplotlib_writes_nothing(tmp_path, monkeypatch):
    """The card's machine has no matplotlib: the figure is skipped, no error;
    with matplotlib it is a PNG image summary TensorBoard reads."""
    mel = np.random.default_rng(1).standard_normal((80, 40))
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)  # import fails
        writer = MetricsWriter(tmp_path / "none")
        writer.spectrogram_figure("generated/y_hat_spec_0", mel, 3)
        writer.close()
    assert [ev for ev in tbevents.read_events(tmp_path / "none") if "values" in ev] == []
    pytest.importorskip("matplotlib")
    writer = MetricsWriter(tmp_path / "fig")
    writer.spectrogram_figure("generated/y_hat_spec_0", mel, 3)
    writer.close()
    acc = event_accumulator()(str(tmp_path / "fig"), size_guidance={"images": 0})
    acc.Reload()
    (image,) = acc.Images("generated/y_hat_spec_0")
    assert image.step == 3 and image.encoded_image_string[:8] == b"\x89PNG\r\n\x1a\n" and (image.width, image.height) == (1000, 200)
