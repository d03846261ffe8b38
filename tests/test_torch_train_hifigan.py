"""The port's HiFi-GAN training path against the JAX package: the
discriminators with their weight and spectral norms, the GAN losses, and one
trainer step.

The generator is ``tests/test_trainers.py``'s (8 mels, 8 channels, rates
(5, 4), mel n_fft 24 and hop 20, so its output's mel has exactly its input's
frames); the discriminators have fixed widths, so the waves stay short (16
frames, 324 samples). Weights come from the JAX package's init (FLOAT32
policy) through ``models/convert.py``; inputs are made with numpy from a seed.

Tolerances (f32): discriminator outputs and feature maps atol 1e-5 (O(1)
values through up to seven convs); the power iteration's u atol 1e-6 (unit
vectors); losses and step metrics rtol 1e-5. After one step parameters are
compared to 1e-6 where |g| > 1e-5 * max|g| of their tensor: Adam's first
update is about lr * sign(g) (see tests/test_torch_train_cfm.py), and the
1024-channel discriminators' f32 gradients carry absolute differences of a
few 1e-6 * max|g| between the frameworks, so elements below that may take
either sign (the ones seen to differ were all under 4.1e-6 * max|g|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_resynth_tpu.core.mesh import make_mesh
from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.models import hifigan as JH
from speech_resynth_tpu.train import hifigan as jax_train_hifigan
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.models import hifigan as TH
from speech_resynth_torch.models.convert import hifigan_generator_state_dict, mpd_state_dict, msd_state_dict
from speech_resynth_torch.ops import fused_mrf as TM
from speech_resynth_torch.train import hifigan as torch_train_hifigan

GEN_KW = dict(
    model_in_dim=8,
    upsample_initial_channel=8,
    upsample_rates=(5, 4),
    upsample_kernel_sizes=(10, 8),
    resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),),
)
EXTRA = 24  # waveform_lengths(1): the mel n_fft that gives the generator's input frames back
B, T = 2, 16
S = (T - 1) * 20 + EXTRA
OUT_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def discriminators(gan_step):
    """The JAX trainer's initial discriminators and the port's, loaded from them."""
    _, _, _, _, _, _, (_, disc_params, disc_state) = gan_step
    mpd, msd = JH.MultiPeriodDiscriminator(policy=JAX_FLOAT32), JH.MultiScaleDiscriminator(policy=JAX_FLOAT32)
    mv = {"params": disc_params["mpd"]}
    sv = {"params": disc_params["msd"], "spectral": disc_state["msd"]}
    tm, ts = TH.MultiPeriodDiscriminator(policy=FLOAT32), TH.MultiScaleDiscriminator(policy=FLOAT32)
    tm.load_state_dict(mpd_state_dict(mv["params"]))
    ts.load_state_dict(msd_state_dict(sv["params"], sv["spectral"]))
    return mpd, mv, msd, sv, tm, ts


def _waves(seed=0, n=S):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((B, n)) * 0.3).astype(np.float32) for _ in range(2))


def _check_outputs(theirs, ours, layout):
    outs_r, outs_g, fmaps_r, fmaps_g = ours
    for a, b in zip(theirs[0] + theirs[1], outs_r + outs_g):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), **OUT_TOL)
    for fa, fb in zip(theirs[2] + theirs[3], fmaps_r + fmaps_g):
        assert len(fa) == len(fb)
        for a, b in zip(fa, fb):
            np.testing.assert_allclose(b.detach().permute(*layout).numpy(), np.asarray(a), **OUT_TOL)


@pytest.mark.parametrize("n", [S, S - 5])  # S - 5: every period pads its reflection differently
def test_multi_period_discriminator_matches_jax(discriminators, n):
    mpd, mv, _, _, tm, _ = discriminators
    y, y_hat = _waves(1, n)
    _check_outputs(mpd.apply(mv, y, y_hat), tm(torch.from_numpy(y), torch.from_numpy(y_hat)), (0, 2, 3, 1))


def test_multi_scale_discriminator_and_its_power_iteration_match_jax(discriminators):
    """Outputs and feature maps, and the first scale's u after one and after
    two ``update_stats`` calls (each advances it on y, then on y_hat); a call
    without ``update_stats`` leaves u as it was."""
    _, _, msd, sv, _, ts_template = discriminators
    ts = TH.MultiScaleDiscriminator(policy=FLOAT32)
    ts.load_state_dict(ts_template.state_dict())
    y, y_hat = _waves(2)
    spectral = sv["spectral"]
    u_before = {k: v.clone() for k, v in ts.state_dict().items() if k.endswith(".u")}
    _check_outputs(msd.apply(sv, y, y_hat), ts(torch.from_numpy(y), torch.from_numpy(y_hat)), (0, 2, 1))
    assert all(torch.equal(v, ts.state_dict()[k]) for k, v in u_before.items())
    for _ in range(2):
        theirs, new = msd.apply({"params": sv["params"], "spectral": spectral}, y, y_hat, update_stats=True, mutable=["spectral"])
        spectral = new["spectral"]
        _check_outputs(theirs, ts(torch.from_numpy(y), torch.from_numpy(y_hat), update_stats=True), (0, 2, 1))
        want = msd_state_dict(sv["params"], spectral)
        us = [k for k in want if k.endswith(".u")]
        assert len(us) == 8 and all(k.startswith("discriminators.0.") for k in us)
        for k in us:
            np.testing.assert_allclose(ts.state_dict()[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
            assert not torch.equal(ts.state_dict()[k], u_before[k])


def test_gan_losses_match_jax():
    rng = np.random.default_rng(3)
    outs = [[rng.standard_normal((B, n)).astype(np.float32) for n in (5, 9)] for _ in range(2)]
    fmaps = [[[rng.standard_normal((B, 3, n)).astype(np.float32) for n in (4, 6)] for _ in range(2)] for _ in range(2)]
    t = lambda tree: jax.tree_util.tree_map(torch.from_numpy, tree)  # noqa: E731
    pairs = (
        (TH.discriminator_loss(*t(outs)), JH.discriminator_loss(*outs)),
        (TH.generator_loss(t(outs[1])), JH.generator_loss(outs[1])),
        (TH.feature_loss(*t(fmaps)), JH.feature_loss(*fmaps)),
    )
    for ours, theirs in pairs:
        assert ours.dtype == torch.float32 and float(ours) == pytest.approx(float(theirs), rel=1e-5)


@pytest.fixture(scope="module")
def gan_step():
    """One step of each trainer from the same weights and batch; the port's
    gradients recorded as its optimizers take them."""
    jcfg = JH.HifiGanConfig(**GEN_KW)
    jtcfg = jax_train_hifigan.HifiGanTrainerConfig(n_fft=EXTRA, hop_size=20, num_mels=8, steps_per_epoch=10)
    _, jstate, jstep = jax_train_hifigan.make_gan_trainer(jcfg, jtcfg, make_mesh(data=1), policy=JAX_FLOAT32)
    before = jax.tree_util.tree_map(np.array, (jstate.gen_params, jstate.disc_params, jstate.disc_state))

    tcfg = torch_train_hifigan.HifiGanTrainerConfig(n_fft=EXTRA, hop_size=20, num_mels=8, steps_per_epoch=10)
    (gen, mpd, msd), state, step = torch_train_hifigan.make_gan_trainer(TH.HifiGanConfig(**GEN_KW), tcfg, FLOAT32, "cpu")
    gen.load_state_dict(hifigan_generator_state_dict(before[0]))
    mpd.load_state_dict(mpd_state_dict(before[1]["mpd"]))
    msd.load_state_dict(msd_state_dict(before[1]["msd"], before[2]["msd"]))
    grads = {}
    for name, opt in state.optimizers.items():
        def recording(g, opt=opt, real=opt.step, name=name):
            grads[name] = [x.clone() for x in g]
            return real(g)

        opt.step = recording

    rng = np.random.default_rng(0)
    batch = {
        "mel": rng.standard_normal((B, T, 8)).astype(np.float32),
        "wav": (rng.standard_normal((B, S)) * 0.1).astype(np.float32),
        "mel_mask": np.arange(T)[None, :] < np.array([[T], [T - 5]]),
    }
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    launches = TM.mrf_branch_kernel.launches, TM.mrf_stage_kernel.launches
    state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert (TM.mrf_branch_kernel.launches, TM.mrf_stage_kernel.launches) == launches
    after = {
        "gen": hifigan_generator_state_dict(jstate.gen_params),
        "mpd": mpd_state_dict(jstate.disc_params["mpd"]),
        "msd": msd_state_dict(jstate.disc_params["msd"], jstate.disc_state["msd"]),
    }
    return state, metrics, jmetrics, grads, after, int(jstate.step), before


def test_gan_step_metrics_match_jax(gan_step):
    state, metrics, jmetrics, _, _, jsteps, _ = gan_step
    assert state.step == jsteps == 1
    for key in ("loss_disc", "loss_gen", "mel_error"):
        assert float(metrics[key]) == pytest.approx(float(jmetrics[key]), rel=1e-5), key


@pytest.mark.parametrize("module", ["gen", "mpd", "msd"])
def test_gan_step_parameters_match_jax(gan_step, module):
    """The generator and both discriminators after one step, where their
    gradient is not ~0; MSD's u after the two advances of the D update."""
    state, _, _, grads, after, _, _ = gan_step
    opt = state.optimizers["gen" if module == "gen" else "disc"]
    grad_of = {id(p): g for p, g in zip(opt.params, grads["gen" if module == "gen" else "disc"])}
    compared = 0
    for name, p in state.modules[module].named_parameters():
        g = grad_of[id(p)].abs()
        live = g > 1e-5 * g.max()
        np.testing.assert_allclose(p.detach()[live].numpy(), after[module][name][live].numpy(), rtol=0, atol=1e-6,
                                   err_msg=f"{module}.{name}")
        compared += int(live.sum())
    assert compared > 0.9 * sum(p.numel() for p in state.modules[module].parameters())
    if module == "msd":
        for name, buf in state.modules["msd"].named_buffers():
            np.testing.assert_allclose(buf.numpy(), after["msd"][name].numpy(), rtol=0, atol=1e-6, err_msg=name)
