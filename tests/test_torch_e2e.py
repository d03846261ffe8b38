"""The training steps' FLOP counts and MFU, the end-to-end quality run and
the entry points of the port (graft_entry).

* ``core.metrics``: the CFM and HiFi-GAN forward counts equal
  ``torch.utils.flop_counter.FlopCounterMode``'s count of a tiny forward
  exactly (the discriminators' convolutions: their spectral norm's
  u^T W v contraction, batch-independent, is left out); each whole tiny
  training step is within ``STEP_RTOL`` of ``FlopCounterMode``'s count, with
  its conv backward counted as two forward convs (``_conv_backward``:
  ``FlopCounterMode``'s own weight-gradient formula ignores a grouped
  conv's groups). Not exact because the first product of each network
  computes no input gradient, the GAN's mel loss runs its STFT as a product
  with a DFT basis (left out of the count as FFT work) and MSD's spectral
  norm contracts once a call. The full-width steps lie in the ranges
  reckoned by hand. One CPU epoch of each loop writes ``train/MFU`` /
  ``training/MFU``.
* ``pipeline.e2e_quality``: ``SCALES``, ``N_UNITS`` and both trainer
  configs equal the JAX package's; the whole run at a monkeypatched small
  scale writes every result key, finite, and ``E2E_QUALITY.json`` (no
  quality gate at that size); the ``ci`` run with the JAX test's gates is
  ``slow`` (``chip_smoke.py`` drives the run on the card).
* ``graft_entry.entry``: the decoder's output lengths at a tiny config.
  (``dryrun_steps`` runs in tests/test_torch_parallel.py's spawn of 4.)
"""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from speech_resynth_tpu.pipeline import e2e_quality as jax_e2e
from speech_resynth_torch import graft_entry
from speech_resynth_torch.core import metrics as MT
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.models import hifigan as TH
from speech_resynth_torch.models import speech_encoder as SE
from speech_resynth_torch.models.cfm import CFMConfig, ConditionalFlowMatchingModel
from speech_resynth_torch.models.composite import init_random_weights
from speech_resynth_torch.models.hubert import HubertConfig
from speech_resynth_torch.pipeline import e2e_quality as torch_e2e
from speech_resynth_torch.pipeline import train_loops
from speech_resynth_torch.train.hifigan import HifiGanTrainerConfig, make_gan_trainer

aten = torch.ops.aten
STEP_RTOL = {"cfm": 0.01, "hifigan": 0.05}  # measured: CFM 0.1% and HiFi-GAN 3.1% under FlopCounterMode's count


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for torch: the suite runs six workers on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def narrow_discriminators(monkeypatch):
    """MPD's convs at 8 channels and MSD's at 16 (their groups of 4 and 16 still divide them)."""
    monkeypatch.setattr(TH, "PERIOD_CHANNELS", (8, 8, 8, 8))
    monkeypatch.setattr(TH, "SCALE_SPECS", tuple((16, k, s, p, g) for _, k, s, p, g in TH.SCALE_SPECS))


def _conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed, _output_padding,
                   _groups, output_mask, out_shape=None, **kwargs) -> int:
    """A conv's input and weight gradients, each the products of one forward conv."""
    return sum(conv_flop_count(x_shape, w_shape, grad_out_shape, transposed) for needed in output_mask[:2] if needed)


def _flops(fn, by_op: bool = False):
    with FlopCounterMode(display=False, custom_mapping={aten.convolution_backward: _conv_backward}) as counter:
        fn()
    if by_op:
        return {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    return counter.get_total_flops()


def _cfm(skip: bool) -> ConditionalFlowMatchingModel:
    cfg = CFMConfig(vocab_size=9, dim_in=8, dim_cond_emb=12, hidden_size=16, depth=2, heads=2, intermediate_size=24,
                    conv_pos_embed_kernel_size=7, conv_pos_embed_groups=16, use_unet_skip_connection=skip)
    model = ConditionalFlowMatchingModel(cfg, FLOAT32)
    init_random_weights(model, torch.Generator().manual_seed(0))
    return model


def _cfm_batch(B=3, N=10):
    gen = torch.Generator().manual_seed(1)
    return torch.randint(1, 10, (B, N), generator=gen), torch.randn(B, N, 8, generator=gen)


@pytest.mark.parametrize("skip", [False, True], ids=["plain", "unet_skips"])
def test_cfm_forward_flops_equal_flop_counter(skip):
    model = _cfm(skip)
    ids, mel = _cfm_batch()
    with torch.no_grad():
        got = _flops(lambda: model.loss(ids, mel, generator=torch.Generator().manual_seed(0)))
    assert got == MT.cfm_forward_flops(model.config, *ids.shape)


@pytest.mark.parametrize("skip", [False, True], ids=["plain", "unet_skips"])
def test_cfm_step_flops_near_flop_counter(skip):
    """3 forwards against the counted forward + backward (the time MLP's
    Fourier features take no gradient: the count is 0.1% high)."""
    model = _cfm(skip)
    ids, mel = _cfm_batch()

    def step():
        loss, _ = model.loss(ids, mel, generator=torch.Generator().manual_seed(0))
        loss.backward()

    got, want = _flops(step), MT.cfm_step_flops(model.config, *ids.shape)
    assert want == 3 * MT.cfm_forward_flops(model.config, *ids.shape)
    assert got == pytest.approx(want, rel=STEP_RTOL["cfm"])
    assert MT.cfm_step_flops(model.config, *ids.shape, remat=True) == pytest.approx(want * 4 / 3)


GAN = TH.HifiGanConfig(model_in_dim=80, upsample_initial_channel=32, upsample_rates=(5, 4), upsample_kernel_sizes=(10, 8),
                       resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3)))


def test_hifigan_generator_flops_equal_flop_counter():
    gen = TH.HifiGanGenerator(GAN, FLOAT32)
    init_random_weights(gen, torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = _flops(lambda: gen(torch.randn(2, 16, 80)))
    assert got == MT.hifigan_generator_flops(GAN, 2, 16)


def test_discriminator_flops_equal_flop_counter(narrow_discriminators):
    """MPD and MSD on a pair of waves: their convolutions exactly (the
    spectral norm's u^T W v, once a call whatever the batch, is not conv work)."""
    samples = int(GAN.waveform_lengths(16))
    mpd, msd = TH.MultiPeriodDiscriminator(policy=FLOAT32), TH.MultiScaleDiscriminator(policy=FLOAT32)
    init_random_weights(mpd, torch.Generator().manual_seed(1))
    init_random_weights(msd, torch.Generator().manual_seed(2))
    y, y_hat = torch.randn(2, samples), torch.randn(2, samples)
    with torch.no_grad():
        got = _flops(lambda: (mpd(y, y_hat), msd(y, y_hat)), by_op=True)
    assert got["aten.convolution"] == 2 * MT.discriminator_flops(2, samples)
    assert set(got) == {"aten.convolution", "aten.bmm"} and got["aten.bmm"] < 0.01 * got["aten.convolution"]


def test_hifigan_step_flops_near_flop_counter(narrow_discriminators):
    """3 G + 9 D against the counted step: the first conv of G and of each
    discriminator computes no input gradient (the count is high), the mel
    loss's STFT product and the spectral norm are not counted (low)."""
    frames = 16
    samples = int(GAN.waveform_lengths(frames))
    (gen, _, _), state, step = make_gan_trainer(GAN, HifiGanTrainerConfig(n_fft=24, hop_size=20), FLOAT32, "cpu")
    gen_ = torch.Generator().manual_seed(3)
    batch = {"mel": torch.randn(2, frames, 80, generator=gen_) - 5, "wav": torch.randn(2, samples, generator=gen_) * 0.1,
             "mel_mask": torch.ones(2, frames, dtype=torch.bool)}
    got, want = _flops(lambda: step(state, batch)), MT.hifigan_step_flops(GAN, 2, frames)
    assert want == 3 * MT.hifigan_generator_flops(GAN, 2, frames) + 9 * MT.discriminator_flops(2, samples)
    assert got == pytest.approx(want, rel=STEP_RTOL["hifigan"])


def test_full_width_step_counts_in_the_reckoned_ranges():
    """configs/resynth/mhubert-expresso-2000.yaml's steps, reckoned by hand:

    CFM, a frame's forward: the input projection 2 * 848 * 256 = 0.43 M;
    a layer's qkv and out 8 * 256^2 = 0.52 M, its feed-forward's two k=3
    convs 18 * 256 * 896 = 4.13 M, attention 4 * 100 * 256 = 0.10 M, four
    layers 19.0 M; 19.5 M in all; x 2 700 x 100 frames x 3 = 15.8 TFLOP.
    HiFi-GAN: the generator ~322 MFLOP a mel frame (each of 5 stages ~12 *
    C^2 * 21 * T) over 64 x 50 frames = 1.03 TFLOP; MPD and MSD ~33.7 GFLOP
    a 16 080-sample wave = 2.15 TFLOP a batch; 3 G + 9 D = 22.5 TFLOP."""
    assert 14e12 < MT.cfm_step_flops(CFMConfig(vocab_size=2000), 2700, 100) < 18e12
    assert 18e6 < MT.cfm_forward_flops(CFMConfig(vocab_size=2000), 1, 100) / 100 < 21e6
    full = TH.HifiGanConfig()
    assert int(full.waveform_lengths(50)) == 16080
    assert 0.9e12 < MT.hifigan_generator_flops(full, 64, 50) < 1.2e12
    assert 1.9e12 < MT.discriminator_flops(64, 16080) < 2.4e12
    assert 20e12 < MT.hifigan_step_flops(full, 64, 50) < 25e12


def test_mfu_is_zero_off_the_card():
    assert MT.mfu(1e12, 0.1, "cpu") == 0.0


@pytest.fixture
def recording_writer(monkeypatch):
    from test_torch_cuda import RecordingWriter

    writers = []

    def make(*args, **kwargs):
        writers.append(RecordingWriter())
        return writers[-1]

    monkeypatch.setattr(train_loops, "MetricsWriter", make)
    return writers


def test_both_resynthesis_loops_write_mfu(tmp_path, recording_writer, narrow_discriminators):
    """One CPU epoch of each loop at a summary every step writes the MFU
    beside the steps per second (0.0 on the CPU)."""
    from test_torch_train_loops import _cfm_config, _cfm_corpus, _gan_config, _gan_corpus

    SE.DENSE_MODELS["_loops_tiny"] = {
        "config": HubertConfig(hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=24,
                               conv_dim=(8, 8), conv_kernel=(10, 4), conv_stride=(5, 4), num_conv_pos_embeddings=8,
                               num_conv_pos_embedding_groups=2),
        "output_layer": 1,
    }
    try:
        train_file, spec_dir = _cfm_corpus(tmp_path / "cfm")
        train_loops.train_flow_matching(_cfm_config(tmp_path / "cfm", train_file, spec_dir, epoch=1), device="cpu")
    finally:
        del SE.DENSE_MODELS["_loops_tiny"]
    wav_dir, mel_dir, file_list = _gan_corpus(tmp_path / "gan")
    train_loops.train_hifigan(_gan_config(tmp_path / "gan", wav_dir, mel_dir, file_list, tmp_path / "gan" / "out",
                                          training_epochs=1, checkpoint_interval=100, validation_interval=100), device="cpu")
    cfm_scalars, gan_scalars = recording_writer[0].scalars_, recording_writer[1].scalars_
    assert {"train/steps_per_sec", "train/MFU"} <= set(cfm_scalars), sorted(cfm_scalars)
    assert {"training/steps_per_sec", "training/MFU"} <= set(gan_scalars), sorted(gan_scalars)
    assert cfm_scalars["train/MFU"] == 0.0 and gan_scalars["training/MFU"] == 0.0


# ---------------------------------------------------------------------------
# the end-to-end quality run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", ["ci", "chip"])
def test_e2e_configs_equal_jax(scale, tmp_path):
    assert torch_e2e.SCALES == jax_e2e.SCALES and torch_e2e.N_UNITS == jax_e2e.N_UNITS
    assert torch_e2e.EVAL_PAD_FRAMES == jax_e2e.EVAL_PAD_FRAMES
    corpus = {"wav_dir": tmp_path / "w", "spec_dir": tmp_path / "s", "train_file": tmp_path / "t.json"}
    p = torch_e2e.SCALES[scale]
    for name in ("_gan_config", "_cfm_config"):
        assert getattr(torch_e2e, name)(tmp_path, corpus, p).to_dict() == getattr(jax_e2e, name)(tmp_path, corpus, p).to_dict()


RESULT_KEYS = ("gan_mel_l1_untrained", "gan_mel_l1_trained", "gan_peak_untrained", "gan_peak_trained", "gan_weight_change",
               "cfm_mel_l1_untrained", "cfm_mel_l1_trained",
               "cfm_mel_l1_trained_midpoint_eqnfe", "cfm_mel_l1_trained_midpoint_halfnfe", "resynth_mel_l1",
               "lm_pair_accuracy", "lm_pairs")


def test_e2e_quality_plumbing_at_a_small_scale(tmp_path, monkeypatch, narrow_discriminators):
    """The whole run, every loop and every measure, at a scale too small to
    learn: every key, finite, and the JSON written. No quality gate here."""
    small = dict(n_train=4, n_eval=2, gan_channels=32, gan_epochs=1, gan_batch=2, frames_per_seg=8, cfm_hidden=16,
                 cfm_epochs=1, cfm_batch=2, lm_hidden=16, lm_layers=1, lm_epochs=1, lm_batch=8, lm_sentences=16)
    monkeypatch.setitem(torch_e2e.SCALES, "small", small)
    monkeypatch.delitem(SE.DENSE_MODELS, "_e2e_formant", raising=False)
    results = torch_e2e.run_e2e_quality(tmp_path, scale="small", device="cpu")
    SE.DENSE_MODELS.pop("_e2e_formant", None)
    assert results["scale"] == "small" and set(RESULT_KEYS) <= set(results)
    assert all(np.isfinite(results[k]) for k in RESULT_KEYS)
    assert results["lm_pairs"] == 200 and 0.0 <= results["lm_pair_accuracy"] <= 1.0
    # the GAN trainer moved the generator off its draw, and its output off the draw's near silence
    assert results["gan_weight_change"] > 1e-5 and results["gan_peak_trained"] >= 10 * results["gan_peak_untrained"]
    assert json.loads((tmp_path / "E2E_QUALITY.json").read_text()) == results
    for export in (tmp_path / "hifigan", tmp_path / "cfm" / "hf"):
        assert (export / "model.safetensors").is_file()


@pytest.mark.slow
def test_e2e_quality_ci(tmp_path):
    """The JAX test's gates (tests/test_e2e_quality.py) on the port's ci run on the CPU."""
    r = torch_e2e.run_e2e_quality(tmp_path, scale="ci", device="cpu")
    assert np.isfinite(r["gan_mel_l1_trained"]) and r["gan_mel_l1_trained"] <= 1.05 * r["gan_mel_l1_untrained"], r
    assert r["cfm_mel_l1_trained"] < 0.7 * r["cfm_mel_l1_untrained"], r
    assert np.isfinite(r["resynth_mel_l1"]) and r["resynth_mel_l1"] < 1.5 * r["gan_mel_l1_untrained"], r
    assert r["lm_pair_accuracy"] > 0.9, r
    # the generator left its draw and its near silence: at this scale the GAN gate passes at the mel-L1 of silence
    assert r["gan_weight_change"] > 1e-5 and r["gan_peak_trained"] >= 10 * r["gan_peak_untrained"], r


# ---------------------------------------------------------------------------
# the entry points (graft_entry)
# ---------------------------------------------------------------------------


def test_entry_synthesizes_the_waveform_lengths(monkeypatch):
    """``entry(device="cpu")`` at a tiny decoder: ``fn(*args)`` gives the
    lengths ``waveform_lengths`` gives the unit counts (no pad ids)."""
    monkeypatch.setattr(graft_entry, "MODEL_CONFIG", CFMConfig(vocab_size=2000, dim_cond_emb=16, hidden_size=16, depth=2,
                                                               heads=2, intermediate_size=24, conv_pos_embed_kernel_size=7,
                                                               conv_pos_embed_groups=16))
    monkeypatch.setattr(graft_entry, "VOCODER_CONFIG", TH.HifiGanConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                                                                        resblock_dilation_sizes=((1, 3),)))
    fn, (ids, generator) = graft_entry.entry(device="cpu")
    assert ids.shape == graft_entry.ENTRY_IDS and ids.device.type == "cpu" and int(ids.min()) >= 1
    assert int(ids.max()) <= graft_entry.MODEL_CONFIG.vocab_size
    wave, lengths = fn(ids, generator)
    want = graft_entry.VOCODER_CONFIG.waveform_lengths(torch.full((2,), ids.shape[1]))
    assert torch.equal(lengths, want) and wave.shape == (2, int(want.max())) and torch.isfinite(wave).all()
    assert graft_entry.MODEL_CONFIG.vocab_size == 2000 and (graft_entry.ENTRY_DT, graft_entry.ENTRY_TRUNCATION) == (0.0625, 1.0)


def test_entry_refuses_to_fall_back_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.entry()


# The port's GAN learning check at a scale of its own: scale ci's corpora, batch
# and crops with scale chip's 128-channel generator (at 32 or 64 channels the
# JAX draw's generator stays at the mel-L1 of silence for 1 200 steps on the
# card), the discriminators narrowed; 5 epochs of 16 steps.
GAN_LEARNING = dict(torch_e2e.SCALES["ci"], gan_channels=128, gan_epochs=5)


def test_gan_leaves_silence_at_the_ports_learning_scale(tmp_path, narrow_discriminators):
    """The quality run's GAN (seed-0 train and seed-99 held-out corpora, GAN
    seed 1234) at ``GAN_LEARNING``: the trained generator's held-out mel-L1
    is at most 0.7 x the draw's, the form of the CFM gate."""
    r = torch_e2e.run_gan_quality(tmp_path, GAN_LEARNING, device="cpu")
    assert r["gan_steps"] == 80 and np.isfinite(r["gan_mel_l1_trained"]), r
    assert r["gan_mel_l1_trained"] <= 0.7 * r["gan_mel_l1_untrained"], r


def test_gan_steps_bookkeeping_on_two_cpu_runs(narrow_discriminators, monkeypatch):
    """``tests/test_torch_cuda.py:gan_steps_card_vs_cpu`` with the CPU on
    both sides: every gradient and update difference 0 at every step, per
    tensor and per module (the synced trainer loaded from the reference's
    state, the free one on its own), the first-divergence report empty, the
    weight changes equal and above 0."""
    import test_torch_cuda as TCU

    monkeypatch.setattr(TCU, "GAN_REFERENCE_THREADS", 1)
    r = TCU.gan_steps_card_vs_cpu(2, devices=("cpu", "cpu"))
    assert r["first_divergence"] is None and len(r["records"]) == 2
    for record in r["records"]:
        for prefix, kinds in (("", ("grad", "update", "update_replayed")), ("free_", ("grad", "update"))):
            for kind in kinds:
                assert record[f"{prefix}{kind}_rel_worst"][0] == 0.0
                assert set(record[f"{prefix}{kind}_rel_module"].values()) == {0.0}
        assert record["losses"][0] == record["losses"][1] and set(record["loss_rel"].values()) == {0.0}
        cpu, other = record["gan_weight_change"]
        assert cpu == other > 0


@pytest.mark.parametrize("fault", ["mel_loss_weight_x3", "no_feature_loss", "adversarial_sign", "no_disc_real_term",
                                   "adam_update_x3"])
def test_gan_steps_check_sees_a_fault_planted_at_step_2(narrow_discriminators, monkeypatch, fault):
    """``gan_steps_card_vs_cpu`` on the CPU against the CPU with ``fault``
    (``tests/test_torch_cuda.py:planted_gan_fault``) in the second side's
    losses or its optimizers' updates from step 2: step 1 agrees exactly,
    and step 2 parts past a limit (the loss that holds the fault past
    GAN_LOSS_TOL; each module's update against the CPU optimizer's replay of
    its gradients past GAN_MODULE_TOL)."""
    import test_torch_cuda as TCU

    monkeypatch.setattr(TCU, "GAN_REFERENCE_THREADS", 1)
    with TCU.planted_gan_fault(fault):
        r = TCU.gan_steps_card_vs_cpu(2, devices=("cpu", "cpu"))
    step1, step2 = r["records"]
    assert set(step1["grad_rel_module"].values()) == set(step1["update_rel_module"].values()) == {0.0}, step1
    assert r["first_divergence"] is not None and r["first_divergence"]["step"] == 2, r["first_divergence"]
    if fault == "adam_update_x3":
        assert all(r > TCU.GAN_MODULE_TOL["update_replayed"] for r in step2["update_replayed_rel_module"].values()), step2
    else:
        assert step2["loss_rel"]["loss_disc" if fault == "no_disc_real_term" else "loss_gen"] > TCU.GAN_LOSS_TOL, step2


@pytest.mark.parametrize("fault", ["mel_loss_weight_x3", "no_disc_real_term", "adam_update_x3"])
def test_gan_steps_check_sees_a_fault_planted_under_bf16(narrow_discriminators, monkeypatch, fault):
    """One fault a kind of limit (the generator's loss, the discriminators'
    loss, the updates against the replay) under the loop's DEFAULT policy
    (bf16 convs), CPU against CPU: step 2 parts past that policy's limits
    (GAN_TOL["default"], set above what the card's bf16 steps part from the
    CPU's)."""
    import test_torch_cuda as TCU

    monkeypatch.setattr(TCU, "GAN_REFERENCE_THREADS", 1)
    with TCU.planted_gan_fault(fault):
        r = TCU.gan_steps_card_vs_cpu(2, devices=("cpu", "cpu"), policy="default")
    assert r["policy"] == "default" and r["records"][0]["loss_rel"] == dict.fromkeys(r["records"][0]["loss_rel"], 0.0)
    assert r["first_divergence"] is not None and r["first_divergence"]["step"] == 2, r["first_divergence"]


def test_gan_weight_change_bound_sees_a_free_trajectory_that_moves_too_little(narrow_discriminators, monkeypatch):
    """The free trainer's updates x0.2 from step 1 under DEFAULT, CPU against
    CPU (the synced trainer untouched): every measure taken from the
    reference's state stays exact, and the free trajectory's final weight
    change, about 0.2 of the reference's, falls outside the bound
    (``gan_weight_change_within``), as one that never left its draw does."""
    import test_torch_cuda as TCU

    monkeypatch.setattr(TCU, "GAN_REFERENCE_THREADS", 1)
    with TCU.planted_gan_fault("free_update_x0.2", from_step=1):
        r = TCU.gan_steps_card_vs_cpu(2, devices=("cpu", "cpu"), policy="default")
    assert r["first_divergence"] is None, r["first_divergence"]
    cpu, free = r["gan_weight_change"]
    assert 0 < free < 0.3 * cpu, r["gan_weight_change"]
    assert TCU.gan_weight_change_within("default", cpu, cpu)
    assert not TCU.gan_weight_change_within("default", cpu, free) and not TCU.gan_weight_change_within("default", cpu, 0.0)
