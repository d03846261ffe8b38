"""The port's training loops and datasets against the JAX package:
byte-equal batches, CFM training with resume, HiFi-GAN training killed after
a mid-epoch checkpoint and resumed bit for bit, and the exports.

Corpora are tiny and made with numpy from a seed: 6 utterances of 24 units
for CFM (``tests/test_train_loops.py``'s), 4 wavs of 30 frames with random
80-bin mels for HiFi-GAN. The HiFi-GAN generator is
``tests/test_trainers.py``'s (8 channels, rates (5, 4), mel n_fft 24, hop
20); its discriminators are cut to 8 and 16 channels
(``narrow_discriminators``): these tests hold the loops' bookkeeping
(checkpoints, resume, exports), which no width changes, and at their full
widths every checkpoint would hold ~70 M parameters with their AdamW moments
(~850 MB). tests/test_torch_train_hifigan.py holds the discriminators at
their widths against the JAX package.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from speech_resynth_tpu.core.config import config_from_dict
from speech_resynth_tpu.models import export as jax_export
from speech_resynth_tpu.models.cfm import CFMConfig as JaxCFMConfig
from speech_resynth_tpu.pipeline import data as jax_data
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.dsp import audio_io
from speech_resynth_torch.models import speech_encoder as SE
from speech_resynth_torch.models.cfm import CFMConfig, ConditionalFlowMatchingModel
from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan
from speech_resynth_torch.models.convert import cfm_state_dict, load_checkpoint
from speech_resynth_torch.models import hifigan as TH
from speech_resynth_torch.models.hubert import HubertConfig
from speech_resynth_torch.pipeline import data as torch_data
from speech_resynth_torch.pipeline import train_loops

FM = dict(
    batch_size=2,
    frames_per_seg=16,
    warmup_steps=2,
    lr=1e-3,
    lr_min=1e-4,
    max_norm=0.1,
    summary_interval=1,
    save_interval_epoch=1,
    dt=0.5,
    truncation_value=1.0,
    dense_model_name="_loops_tiny",
    quantizer_model_name="kmeans",
    vocab_size=9,
    dim_in=80,
    dim_cond_emb=16,
    hidden_size=16,
    depth=2,
    heads=2,
    intermediate_size=24,
    ff_dropout=0.0,
    use_unet_skip_connection=False,
    conv_pos_embed_kernel_size=7,
    conv_pos_embed_groups=16,
    attn_dropout=0.0,
    mean=-5.8843,
    std=2.2615,
    predict_duration=False,
)
GAN = dict(
    batch_size=2,
    segment_size=324,  # 16 frames
    learning_rate=2e-4,
    adam_b1=0.8,
    adam_b2=0.99,
    lr_decay=0.999,
    seed=1234,
    upsample_rates=[5, 4],
    upsample_kernel_sizes=[10, 8],
    upsample_initial_channel=8,
    resblock_kernel_sizes=[3],
    resblock_dilation_sizes=[[1, 3]],
    n_fft=24,
    hop_size=20,
    stdout_interval=1,
    summary_interval=1,
)


def _cfm_corpus(root: Path):
    rng = np.random.default_rng(0)
    spec_dir = root / "spec"
    units = {}
    for i in range(6):
        name = f"train/u{i}"
        units[name] = {"units": rng.integers(0, 9, 24).tolist(), "durations": [1] * 24, "transcript": f"utt {i}"}
        out = spec_dir / f"{name}.npy"
        out.parent.mkdir(parents=True, exist_ok=True)
        np.save(out, rng.standard_normal((24, 80)).astype(np.float32))
    train_file = root / "train.json"
    train_file.write_text(json.dumps(units))
    return train_file, spec_dir


def _gan_corpus(root: Path, n: int = 4, frames: int = 30):
    rng = np.random.default_rng(1)
    wav_dir, mel_dir = root / "wav", root / "mel"
    wav_dir.mkdir(parents=True)
    mel_dir.mkdir()
    names = []
    for i in range(n):
        samples = (frames - 1) * 20 + 24
        t = np.arange(samples) / 16000
        wav = (0.3 * np.sin(2 * np.pi * (200 + 40 * i) * t) + 0.02 * rng.standard_normal(samples)).astype(np.float32)
        audio_io.write(wav_dir / f"g{i}.wav", wav, 16000)
        np.save(mel_dir / f"g{i}.npy", (rng.standard_normal((frames + i, 80)) - 5).astype(np.float32))
        names.append(f"g{i}")
    file_list = root / "files.txt"
    file_list.write_text("\n".join(names) + "\n")
    return wav_dir, mel_dir, file_list


def _cfm_config(root: Path, train_file: Path, spec_dir: Path, epoch: int):
    return config_from_dict({
        "common": {"seed": 0},
        "dataset": {"wav_dir": str(root / "none"), "spectrogram_dir": str(spec_dir), "ext_audio": ".wav",
                    "train_file": str(train_file), "dev_file": str(root / "missing_dev.json")},
        "flow_matching": {"path": str(root / "model"), "epoch": epoch, **FM},
    })


def _gan_config(root: Path, wav_dir, mel_dir, file_list, path: Path, **overrides):
    return config_from_dict({
        "dataset": {"wav_dir": str(wav_dir), "spectrogram_dir": str(mel_dir), "ext_audio": ".wav",
                    "train_file": str(file_list), "dev_file": str(file_list)},
        "hifigan": {"path": str(path), **GAN, **overrides},
    })


@pytest.fixture(scope="module")
def narrow_discriminators():
    """MPD's convs at 8 channels and MSD's at 16 (their groups of 4 and 16 still divide them)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TH, "PERIOD_CHANNELS", (8, 8, 8, 8))
        mp.setattr(TH, "SCALE_SPECS", tuple((16, k, s, p, g) for _, k, s, p, g in TH.SCALE_SPECS))
        yield


@pytest.fixture(scope="module")
def tiny_encoder():
    SE.DENSE_MODELS["_loops_tiny"] = {
        "config": HubertConfig(hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=24,
                               conv_dim=(8, 8), conv_kernel=(10, 4), conv_stride=(5, 4), num_conv_pos_embeddings=8,
                               num_conv_pos_embedding_groups=2),
        "output_layer": 1,
    }
    yield
    del SE.DENSE_MODELS["_loops_tiny"]


@pytest.fixture(scope="module")
def trained_cfm(tmp_path_factory, tiny_encoder):
    """``train_flow_matching`` for 2 epochs of 3 steps, then resumed with the
    epochs raised to 3 (``tests/test_train_loops.py``'s run)."""
    root = tmp_path_factory.mktemp("cfm")
    train_file, spec_dir = _cfm_corpus(root)
    cfg = _cfm_config(root, train_file, spec_dir, epoch=2)
    first = train_loops.train_flow_matching(cfg, device="cpu")
    ckpt = Path(cfg.flow_matching.path) / "ckpt"
    steps = sorted(int(p.name) for p in ckpt.iterdir() if p.name.isdigit())
    second = train_loops.train_flow_matching(_cfm_config(root, train_file, spec_dir, epoch=3), device="cpu")
    steps2 = sorted(int(p.name) for p in ckpt.iterdir() if p.name.isdigit())
    return cfg, first, steps, second, steps2


def test_train_flow_matching_checkpoints_and_resumes(trained_cfm):
    cfg, first, steps, second, steps2 = trained_cfm
    assert steps == [3, 6] and first["step"] == 6
    assert steps2 == [3, 6, 9] and second["step"] == 9, "the resumed run did not continue from step 6"
    assert all(np.isfinite(v) for v in second["metrics"].values()) and set(second["metrics"]) == {
        "loss", "mse", "duration_loss", "grad_norm"}
    hf = Path(cfg.flow_matching.path) / "hf"
    assert (hf / "pytorch_model.bin").is_file() and not (hf / "model.safetensors").exists()
    config = json.loads((hf / "config.json").read_text())
    assert list(config) == [f.name for f in dataclasses.fields(JaxCFMConfig)]
    model = ConditionalFlowMatchingModel(CFMConfig(**{k: config[k] for k in config}), FLOAT32)
    model.load_state_dict(load_checkpoint(hf))
    table = SE.embedding("_loops_tiny", "kmeans", 9, device="cpu")
    assert torch.equal(model.to_cond_emb.weight, torch.from_numpy(table)), "the frozen table moved"


def test_cfm_export_equals_the_jax_export_of_the_same_weights(tmp_path):
    """The same weights exported by the port and by the JAX package: the
    same keys, equal tensors, the same config."""
    import jax

    from speech_resynth_tpu.core.flaxinit import jitted_init
    from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
    from speech_resynth_tpu.models.cfm import ConditionalFlowMatchingModel as JaxModel

    kw = {k: FM[k] for k in ("vocab_size", "dim_in", "dim_cond_emb", "hidden_size", "depth", "heads", "intermediate_size",
                             "conv_pos_embed_kernel_size", "conv_pos_embed_groups")}
    jcfg = JaxCFMConfig(**kw)
    jmodel = JaxModel(jcfg, policy=JAX_FLOAT32)
    ids = np.ones((1, 8), np.int32)
    variables = jitted_init(jmodel, {"params": jax.random.key(0)}, ids, np.zeros((1, 8, 80), np.float32), ids,
                            rng=jax.random.key(1))
    theirs = jax_export.cfm_state_dict(variables)
    port_cfg = CFMConfig(**kw)
    model = ConditionalFlowMatchingModel(port_cfg, FLOAT32)
    model.load_state_dict(cfm_state_dict(variables))
    cfg = config_from_dict({"flow_matching": {"path": str(tmp_path)}})
    train_loops._export_cfm(cfg, port_cfg, model)
    ours = load_checkpoint(tmp_path / "hf")
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == torch.float32 and np.array_equal(ours[k].numpy(), v), k
    assert json.loads((tmp_path / "hf" / "config.json").read_text()) == dataclasses.asdict(jcfg)


def _final_state(path: Path) -> dict:
    ckpt = path / "ckpt"
    last = max(int(p.name) for p in ckpt.iterdir() if p.name.isdigit())
    return torch.load(ckpt / str(last) / "state.pt", weights_only=True)


def _assert_equal_trees(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_trees(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


class Killed(Exception):
    pass


@pytest.fixture(scope="module")
def gan_runs(tmp_path_factory, narrow_discriminators):
    """``train_hifigan`` for 2 epochs of 2 steps with a checkpoint at step 3
    (mid-epoch): once straight through, once killed right after that
    checkpoint and resumed."""
    root = tmp_path_factory.mktemp("gan")
    wav_dir, mel_dir, file_list = _gan_corpus(root)
    kw = dict(training_epochs=2, checkpoint_interval=3, validation_interval=4)
    straight = _gan_config(root, wav_dir, mel_dir, file_list, root / "straight", **kw)
    resumed = _gan_config(root, wav_dir, mel_dir, file_list, root / "resumed", **kw)

    class KillAfterSave(train_loops.CheckpointManager):
        def save(self, step, state, force=False):
            saved = super().save(step, state, force)
            if step == 3 and not force:
                raise Killed(step)
            return saved

    out = {"straight": train_loops.train_hifigan(straight, device="cpu")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_loops, "CheckpointManager", KillAfterSave)
        with pytest.raises(Killed):
            train_loops.train_hifigan(resumed, device="cpu")
    killed_steps = sorted(int(p.name) for p in (root / "resumed" / "ckpt").iterdir() if p.name.isdigit())
    out["resumed"] = train_loops.train_hifigan(resumed, device="cpu")
    out["killed_steps"] = killed_steps
    out["states"] = {k: _final_state(root / k) for k in ("straight", "resumed")}
    out["exports"] = {k: load_checkpoint(root / k) for k in ("straight", "resumed")}
    return root, out


def test_train_hifigan_resumes_bit_for_bit(gan_runs):
    root, out = gan_runs
    assert out["killed_steps"] == [3]
    assert out["straight"]["step"] == out["resumed"]["step"] == 4
    _assert_equal_trees(out["states"]["straight"], out["states"]["resumed"], "state")
    _assert_equal_trees(out["exports"]["straight"], out["exports"]["resumed"], "generator")
    assert all(np.isfinite(v) for v in out["straight"]["metrics"].values())


def test_trained_pair_loads_and_synthesizes(trained_cfm, gan_runs):
    """The CFM export and the generator export serve through ``load_pretrained``."""
    cfg, *_ = trained_cfm
    root, _ = gan_runs
    decoder = ConditionalFlowMatchingWithHifiGan.load_pretrained(
        Path(cfg.flow_matching.path) / "hf", root / "straight", FLOAT32, device="cpu"
    )
    ids = torch.from_numpy(np.random.default_rng(5).integers(1, 10, (2, 12)))
    ids[1, 9:] = 0
    wavs = decoder(ids, dt=0.5, truncation_value=1.0, generator=torch.Generator().manual_seed(0))
    assert [w.shape for w in wavs] == [(1, int(decoder.vocoder.config.waveform_lengths(n))) for n in (12, 9)]
    assert all(np.isfinite(w).all() for w in wavs)


def test_validate_hifigan_scores_full_utterances(tmp_path, narrow_discriminators):
    """Full-length dev batches under inference mode, masked mel-L1 per frame,
    the first batch's audio trimmed to its true length."""
    wav_dir, mel_dir, file_list = _gan_corpus(tmp_path)
    cfg = _gan_config(tmp_path, wav_dir, mel_dir, file_list, tmp_path / "gan")
    from speech_resynth_torch.train.hifigan import HifiGanTrainerConfig, build_models

    gen, _, _ = build_models(train_loops._hifigan_config(cfg.hifigan), FLOAT32, device="cpu")

    class Writer:
        scalars, audio_logged = {}, {}

        def scalar(self, k, v, step):
            self.scalars[k] = v

        def audio(self, k, wav, step):
            self.audio_logged[k] = wav

        def spectrogram_figure(self, k, mel, step):
            pass

    writer = Writer()
    train_loops._validate_hifigan(cfg, gen, HifiGanTrainerConfig(segment_size=324, n_fft=24, hop_size=20), 1, writer)
    assert np.isfinite(writer.scalars["validation/mel_spec_error"]) and writer.scalars["validation/mel_spec_error"] > 0
    assert writer.audio_logged["generated/y_hat_0"].shape == ((30 - 1) * 20 + 24,)


def _batches_equal(ours, theirs):
    n = 0
    for a, b in zip(ours, theirs, strict=True):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
            else:
                assert a[k] == b[k], k
        n += 1
    return n


@pytest.mark.parametrize("epoch", [1, 2])
def test_unit_batches_are_byte_equal_to_jax(tmp_path, epoch):
    train_file, spec_dir = _cfm_corpus(tmp_path)
    for fps in (16, None):
        kw = dict(spectrogram_dir=str(spec_dir), frames_per_seg=fps)
        ours = torch_data.UnitDataset(str(train_file), **kw).batches(2, seed=3, epoch=epoch)
        theirs = jax_data.UnitDataset(str(train_file), **kw).batches(2, seed=3, epoch=epoch)
        assert _batches_equal(ours, theirs) == 3


@pytest.mark.parametrize("epoch", [0, 1])
def test_mel_batches_are_byte_equal_to_jax(tmp_path, epoch):
    wav_dir, mel_dir, file_list = _gan_corpus(tmp_path, n=5)
    args = (str(wav_dir), str(mel_dir), str(file_list), 324, 24, 20)
    ours = torch_data.MelDataset(*args, True).batches(2, seed=1234, epoch=epoch)
    theirs = jax_data.MelDataset(*args, True).batches(2, seed=1234, epoch=epoch)
    assert _batches_equal(ours, theirs) == 2
    ours = torch_data.MelDataset(*args, False).padded_batches(2, multiple=16)
    theirs = jax_data.MelDataset(*args, False).padded_batches(2, multiple=16)
    assert _batches_equal(ours, theirs) == 3
