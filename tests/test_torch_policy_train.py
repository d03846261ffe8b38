"""The port's three trainers against the JAX package's under DEFAULT, the
policy they train in (f32 parameters, bf16 compute): one step each of the
CFM, the HiFi-GAN and the speech LM trainer from the same weights, batch and
draws.

Measures, each the port's distance from the JAX DEFAULT step as a multiple
of that step's distance from the FLOAT32 step (see tests/test_torch_policy.py):
the worst loss, the worst module's gradient (its tensors as one vector, as
the optimizer is given them) and the update (after - before) of all modules
as one vector (``_measures``). The FLOAT32 step is the
port's, which tests/test_torch_train_cfm.py, test_torch_train_hifigan.py and
test_torch_train_speechlm.py hold to the JAX package's: one JAX compile a
trainer. Each limit (LIMITS) sits between the sound port and faults planted
in it (a weight that skips its cast, a norm taken in bf16, a dropped bias),
over several seeds; PERF.md §6 has the numbers. The GAN's case compiles
the JAX step with the full-width discriminators (~50 s on one CPU) and is
marked ``slow``. To print them, seed by seed:

    JAX_PLATFORMS=cpu python tests/test_torch_policy_train.py [case ...] [--seeds 0 1 2]
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_resynth_tpu.core.mesh import make_mesh
from speech_resynth_tpu.core.precision import DEFAULT as JAX_DEFAULT
from speech_resynth_tpu.models import cfm as jax_cfm
from speech_resynth_tpu.models import hifigan as JH
from speech_resynth_tpu.models import llama as JL
from speech_resynth_tpu.train import cfm as jax_train_cfm
from speech_resynth_tpu.train import hifigan as jax_train_hifigan
from speech_resynth_tpu.train import speechlm as jax_train_lm
from speech_resynth_torch.core.precision import DEFAULT, FLOAT32
from speech_resynth_torch.models import cfm as torch_cfm
from speech_resynth_torch.models import hifigan as TH
from speech_resynth_torch.models import llama as TL
from speech_resynth_torch.models.convert import (
    cfm_state_dict,
    hifigan_generator_state_dict,
    llama_state_dict,
    mpd_state_dict,
    msd_state_dict,
)
from speech_resynth_torch.train import cfm as torch_train_cfm
from speech_resynth_torch.train import hifigan as torch_train_hifigan
from speech_resynth_torch.train import speechlm as torch_train_lm
from test_torch_policy import draw, drop_bias, norm_in_bf16, patched, skip_cast

# Each limit sits between the sound steps and the planted faults that cross it
# (PERF.md §6: each measure's largest sound reading and each fault's
# smallest, over seeds 0-7, the GAN's 0-4). The loss limits bound the sound
# steps; the faults cross the gradient or the update limits. A weight that
# skips its cast is one rounding among the step's thousands: it reads within
# the sound steps in all three (NOT_SEEN), and tests/test_torch_policy.py
# holds it at one block. The CFM's norm in bf16 reads within the sound
# gradients; its update limit holds it.
LIMITS = {
    "cfm": {"loss": 0.5, "grad": 2.0, "update": 1.067},
    "gan": {"loss": 0.5, "grad": 1.3, "update": 1.3},
    "lm": {"loss": 0.5, "grad": 1.12, "update": 1.05},
}
NOT_SEEN = {("cfm", "skip_cast"), ("gan", "skip_cast"), ("lm", "skip_cast")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _vectors(sd: dict, modules, skip=()) -> dict:
    """A state dict's tensors as one f64 vector per module (its keys' first
    part), the keys in ``skip`` left out."""
    return {m: np.concatenate([np.asarray(sd[k], np.float64).ravel() for k in sorted(sd)
                               if k.split(".")[0] == m and k not in skip]) for m in modules}


@contextlib.contextmanager
def jax_gradients(module, record: list):
    """The gradients each optimizer of a JAX trainer built while open is
    given, appended to ``record`` as (optimizer index, numpy tree)."""
    real = module.make_optimizer
    built = []

    def make(*args, **kwargs):
        tx, index = real(*args, **kwargs), len(built)
        built.append(tx)

        def update(grads, state, params=None):
            jax.debug.callback(lambda g: record.append((index, jax.tree_util.tree_map(np.array, g))), grads)
            return tx.update(grads, state, params)

        return optax.GradientTransformation(tx.init, update)

    with patched(module, "make_optimizer", make):
        yield


def _recording(opt, grads: list):
    real = opt.step
    opt.step = lambda g: grads.extend(x.detach().clone() for x in g) or real(g)


def _measures(port: dict, runs: dict, modules) -> dict:
    """Each quantity's port-vs-JAX-DEFAULT distance over the JAX DEFAULT
    step's distance from the FLOAT32 step. Losses: the worst loss, its
    DEFAULT-vs-FLOAT32 difference taken as at least one bf16 ulp of the loss
    (2^-8 |loss|), which a chance agreement of the two steps would otherwise
    shrink to nothing. Gradients: the worst module. Updates: every module's
    as one vector, since Adam's first update is lr * sign(g) and its distance
    counts the signs that flip, too few in one module to measure by."""
    d, f = runs["default"], runs["float32"]
    out = {"loss": max(abs(port["loss"][k] - d["loss"][k]) / max(abs(d["loss"][k] - f["loss"][k]), 2.0**-8 * abs(d["loss"][k]), 1e-30)
                       for k in d["loss"])}
    out["grad"] = max(_rel(port["grad"][m], d["grad"][m]) / _rel(d["grad"][m], f["grad"][m]) for m in modules)
    update = {k: np.concatenate([r["update"][m] for m in modules]) for k, r in (("port", port), ("default", d), ("float32", f))}
    out["update"] = _rel(update["port"], update["default"]) / _rel(update["default"], update["float32"])
    return out


# ---------------------------------------------------------------------------
# the CFM trainer
# ---------------------------------------------------------------------------

CFM_KW = dict(vocab_size=11, dim_in=8, dim_cond_emb=12, hidden_size=64, depth=2, heads=2, intermediate_size=96,
              conv_pos_embed_kernel_size=7, conv_pos_embed_groups=16)
CFM_MODULES = ("to_embed", "conv_embed", "time_cond_mlp", "transformer", "to_pred")  # the frozen unit table left out
CFM_BUFFERS = ("time_cond_mlp.0.weights",)


def _cfm_batch(seed=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, CFM_KW["vocab_size"] + 1, (3, 20)).astype(np.int32)
    ids[1, 14:] = 0
    mels = rng.standard_normal((3, 20, CFM_KW["dim_in"])).astype(np.float32) * 2 - 5
    mels[ids == 0] = -100.0
    return {"input_ids": ids, "spectrogram_labels": mels}


def _fill_zeros(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.1) if not np.asarray(a).any() else a, tree)


def _table():
    table = np.random.default_rng(3).standard_normal((CFM_KW["vocab_size"] + 1, CFM_KW["dim_cond_emb"])).astype(np.float32)
    table[0] = 0
    return table


def build_cfm(seed=0):
    """The JAX CFM step under DEFAULT (the trainer's own init with its seed,
    the zero leaves filled): its losses, gradients and updates keyed as the
    port's parameters; the weights; the step's draws; the port's FLOAT32
    step from the same weights and draws."""
    batch, rng, grads = _cfm_batch(seed + 4), jax.random.key(seed + 11), []
    tcfg = jax_train_cfm.CFMTrainerConfig(warmup_steps=2, lr=1e-3, lr_min=1e-4, seed=seed)
    with jax_gradients(jax_train_cfm, grads):
        _, jstate, jstep, _ = jax_train_cfm.make_trainer(jax_cfm.CFMConfig(**CFM_KW), tcfg, make_mesh(data=1), 10, _table(),
                                                         policy=JAX_DEFAULT)
    jstate = jstate.replace(params=_fill_zeros(jstate.params, seed + 9))
    before = jax.tree_util.tree_map(np.array, {"params": jstate.params, "buffers": jstate.extra})
    jstate, metrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    after = cfm_state_dict({"params": jax.tree_util.tree_map(np.asarray, jstate.params), "buffers": before["buffers"]})
    sd0 = cfm_state_dict(before)
    g = cfm_state_dict({"params": grads[-1][1], "buffers": before["buffers"]})
    runs = {"default": {"loss": {k: float(metrics[k]) for k in ("loss", "mse")}, "grad": _vectors(g, CFM_MODULES, CFM_BUFFERS),
                        "update": _vectors({k: after[k] - sd0[k] for k in sd0}, CFM_MODULES, CFM_BUFFERS)}}
    k_x0, k_t = jax.random.split(jax.random.split(rng)[0])
    draws = (torch.from_numpy(np.array(jax.random.normal(k_x0, batch["spectrogram_labels"].shape))),
             torch.from_numpy(np.array(jax.random.uniform(k_t, (3,)))))
    built = (runs, sd0, draws, seed)
    runs["float32"] = cfm_port_step(built, FLOAT32)[1]
    return built


def cfm_port_step(cfm, policy=DEFAULT) -> dict:
    _, sd0, (x0, times), seed = cfm
    batch = {k: torch.from_numpy(v) for k, v in _cfm_batch(seed + 4).items()}
    model, state, step = torch_train_cfm.make_trainer(torch_cfm.CFMConfig(**CFM_KW),
                                                      torch_train_cfm.CFMTrainerConfig(warmup_steps=2, lr=1e-3, lr_min=1e-4), 10,
                                                      _table(), policy=policy, device="cpu")
    model.load_state_dict(sd0)
    grads = []
    _recording(state.optimizers["model"], grads)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    state, metrics = step(state, batch, seed=0, x0=x0, times=times)
    after = model.state_dict()
    return model, {"loss": {k: float(metrics[k]) for k in ("loss", "mse")},
                   "grad": _vectors(dict(zip(names, grads)), CFM_MODULES, CFM_BUFFERS),
                   "update": _vectors({k: after[k] - sd0[k] for k in sd0}, CFM_MODULES, CFM_BUFFERS)}


# ---------------------------------------------------------------------------
# the HiFi-GAN trainer
# ---------------------------------------------------------------------------

GEN_KW = dict(model_in_dim=8, upsample_initial_channel=16, upsample_rates=(5, 4), upsample_kernel_sizes=(10, 8),
              resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3)))
GAN_B, GAN_T, GAN_EXTRA = 2, 16, 24
GAN_MODULES = ("gen", "mpd", "msd")
GAN_BUFFERS = ("gen.mean", "gen.scale")


def _gan_batch(seed):
    rng = np.random.default_rng(seed)
    return {"mel": rng.standard_normal((GAN_B, GAN_T, 8)).astype(np.float32),
            "wav": (rng.standard_normal((GAN_B, (GAN_T - 1) * 20 + GAN_EXTRA)) * 0.1).astype(np.float32),
            "mel_mask": np.arange(GAN_T)[None, :] < np.array([[GAN_T], [GAN_T - 5]])}


def _gan_sd(gen, disc, disc_state):
    return {**{f"gen.{k}": v for k, v in hifigan_generator_state_dict(gen).items()},
            **{f"mpd.{k}": v for k, v in mpd_state_dict(disc["mpd"]).items()},
            **{f"msd.{k}": v for k, v in msd_state_dict(disc["msd"], disc_state["msd"]).items() if not k.endswith(".u")}}


def build_gan(seed=0):
    """The JAX GAN step under DEFAULT (the trainer's own init with its seed;
    the generator drawn, so that its output is O(1): the draw's is ~1e-5,
    below the mel's floor; the discriminators' zero leaves filled); the port's
    FLOAT32 step from the same weights."""
    batch = _gan_batch(seed)
    tcfg = jax_train_hifigan.HifiGanTrainerConfig(n_fft=GAN_EXTRA, hop_size=20, num_mels=8, steps_per_epoch=10, seed=seed)
    grads = []
    with jax_gradients(jax_train_hifigan, grads):
        _, jstate, jstep = jax_train_hifigan.make_gan_trainer(JH.HifiGanConfig(**GEN_KW), tcfg, make_mesh(data=1),
                                                              policy=JAX_DEFAULT)
    jstate = jstate.replace(gen_params=jax.tree_util.tree_map(jnp.asarray, draw(jstate.gen_params, seed + 5)),
                            disc_params=_fill_zeros(jstate.disc_params, seed + 6))
    before = jax.tree_util.tree_map(np.array, (jstate.gen_params, jstate.disc_params, jstate.disc_state))
    jstate, metrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    by_opt = dict(grads)  # optimizer 0 the generator's, 1 the discriminators'
    sd0 = _gan_sd(*before)
    after = _gan_sd(*jax.tree_util.tree_map(np.asarray, (jstate.gen_params, jstate.disc_params, jstate.disc_state)))
    g = _gan_sd(by_opt[0], by_opt[1], before[2])
    runs = {"default": {"loss": {k: float(metrics[k]) for k in ("loss_disc", "loss_gen", "mel_error")},
                        "grad": _vectors(g, GAN_MODULES, GAN_BUFFERS),
                        "update": _vectors({k: after[k] - sd0[k] for k in sd0}, GAN_MODULES, GAN_BUFFERS)}}
    built = (runs, before, seed)
    runs["float32"] = gan_port_step(built, FLOAT32)[1]
    return built


def gan_port_step(gan, policy=DEFAULT) -> dict:
    _, (gen0, disc0, disc_state0), seed = gan
    tcfg = torch_train_hifigan.HifiGanTrainerConfig(n_fft=GAN_EXTRA, hop_size=20, num_mels=8, steps_per_epoch=10, seed=seed)
    (gen, mpd, msd), state, step = torch_train_hifigan.make_gan_trainer(TH.HifiGanConfig(**GEN_KW), tcfg, policy, "cpu")
    gen.load_state_dict(hifigan_generator_state_dict(gen0))
    mpd.load_state_dict(mpd_state_dict(disc0["mpd"]))
    msd.load_state_dict(msd_state_dict(disc0["msd"], disc_state0["msd"]))
    modules = {"gen": gen, "mpd": mpd, "msd": msd}
    sd0 = {f"{m}.{k}": v.detach().clone() for m, mod in modules.items() for k, v in mod.named_parameters()}
    grads = {k: [] for k in state.optimizers}
    for k, opt in state.optimizers.items():
        _recording(opt, grads[k])
    state, metrics = step(state, {k: torch.from_numpy(v) for k, v in _gan_batch(seed).items()})
    names = [f"gen.{n}" for n, _ in gen.named_parameters()]
    names += [f"{m}.{n}" for m in ("mpd", "msd") for n, _ in modules[m].named_parameters()]
    after = {f"{m}.{k}": v.detach() for m, mod in modules.items() for k, v in mod.named_parameters()}
    return gen, {"loss": {k: float(metrics[k]) for k in ("loss_disc", "loss_gen", "mel_error")},
                 "grad": _vectors(dict(zip(names, grads["gen"] + grads["disc"])), GAN_MODULES),
                 "update": _vectors({k: after[k] - sd0[k] for k in sd0}, GAN_MODULES)}


# ---------------------------------------------------------------------------
# the speech-LM trainer
# ---------------------------------------------------------------------------

LM_KW = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2)
LM_TRAIN_KW = dict(warmup_steps=2, lr=1e-3, lr_min=1e-4)
LM_MODULES = ("model", "lm_head")


def _lm_batch(seed=10):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, LM_KW["vocab_size"], (4, 16)).astype(np.int32)
    for row, n in enumerate((16, 9, 5, 11)):
        ids[row, n:] = 0
    return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32), "labels": np.where(ids == 0, -100, ids).astype(np.int32)}


def build_lm(seed=0):
    """The JAX LM step under DEFAULT (the trainer's own init with its seed,
    the RMSNorm gains drawn off 1); the port's FLOAT32 step from the same
    weights."""
    batch, grads, rng = _lm_batch(seed + 10), [], np.random.default_rng(seed + 1)
    tcfg = jax_train_lm.SpeechLMTrainerConfig(**LM_TRAIN_KW, seed=seed)
    with jax_gradients(jax_train_lm, grads):
        _, jstate, jstep, _ = jax_train_lm.make_speechlm_trainer(JL.LlamaConfig(**LM_KW), tcfg, make_mesh(data=1), 10,
                                                                  policy=JAX_DEFAULT)
    jstate = jstate.replace(params=jax.tree_util.tree_map(
        lambda a: jnp.asarray(1.0 + 0.1 * rng.standard_normal(a.shape).astype(np.float32)) if a.ndim == 1 else a, jstate.params))
    sd0 = llama_state_dict(jax.tree_util.tree_map(np.array, jstate.params))  # host copies: the step donates
    jstate, metrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    after = llama_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))
    g = llama_state_dict(grads[-1][1])
    runs = {"default": {"loss": {"loss": float(metrics["loss"])}, "grad": _vectors(g, LM_MODULES),
                        "update": _vectors({k: after[k] - sd0[k] for k in sd0}, LM_MODULES)}}
    built = (runs, sd0, seed)
    runs["float32"] = lm_port_step(built, FLOAT32)[1]
    return built


def lm_port_step(lm, policy=DEFAULT) -> dict:
    _, sd0, seed = lm
    model, state, step = torch_train_lm.make_speechlm_trainer(TL.LlamaConfig(**LM_KW),
                                                              torch_train_lm.SpeechLMTrainerConfig(**LM_TRAIN_KW, seed=seed), None,
                                                              10, policy, device="cpu")
    model.load_state_dict(sd0)
    grads = []
    _recording(state.optimizers["model"], grads)
    names = [n for n, _ in model.named_parameters()]
    state, metrics = step(state, {k: torch.from_numpy(v).long() for k, v in _lm_batch(seed + 10).items()})
    after = model.state_dict()
    return model, {"loss": {"loss": float(metrics["loss"])}, "grad": _vectors(dict(zip(names, grads)), LM_MODULES),
                   "update": _vectors({k: after[k] - sd0[k] for k in sd0}, LM_MODULES)}


# ---------------------------------------------------------------------------
# the cases and their planted faults
# ---------------------------------------------------------------------------


CASES = {
    "cfm": (cfm_port_step, CFM_MODULES, {
        "skip_cast": ("skip_cast", "transformer.layers.0.2.to_qkv.weight"),
        "norm_in_bf16": ("norm", "cfm"),
        "drop_bias": ("drop_bias", "transformer.layers.0.4.conv1.bias"),
    }),
    "gan": (gan_port_step, GAN_MODULES, {
        "skip_cast": ("skip_cast", "conv_pre.weight"),
        "drop_bias": ("drop_bias", "conv_pre.bias"),
    }),
    "lm": (lm_port_step, LM_MODULES, {
        "skip_cast": ("skip_cast", "model.layers.0.self_attn.q_proj.weight"),
        "norm_in_bf16": ("norm", "llama"),
    }),
}


def run_case(case: str, seed: int = 0, fault=None) -> dict:
    """The case's measures, with ``fault`` (a name of its faults) planted in
    the port's model from the moment the trainer builds it."""
    port_step, modules, faults = CASES[case]
    built = build(case, seed)
    if fault is None:
        return _measures(port_step(built)[1], built[0], modules)
    kind, target = faults[fault]
    with contextlib.ExitStack() as stack:
        if kind == "norm":
            stack.enter_context(norm_in_bf16(target))
        else:
            real = torch.nn.Module.load_state_dict

            def load(module, sd, *args, **kwargs):  # the trainer's model gets the fault once loaded
                out = real(module, sd, *args, **kwargs)
                if target in dict(module.named_parameters()):
                    p = module.get_parameter(target)
                    stack.enter_context(skip_cast(module, target, p) if kind == "skip_cast" else drop_bias(module, target))
                return out

            stack.enter_context(patched(torch.nn.Module, "load_state_dict", load))
        return _measures(port_step(built)[1], built[0], modules)


BUILDERS = {"cfm": build_cfm, "gan": build_gan, "lm": build_lm}


@functools.lru_cache(maxsize=None)
def build(case: str, seed: int = 0):
    """A case's JAX step and the port's FLOAT32 step for ``seed``, built once."""
    return BUILDERS[case](seed)


def crossed(case: str, m: dict) -> list:
    return [k for k, limit in LIMITS[case].items() if m[k] > limit]


@pytest.mark.parametrize("case", [pytest.param("gan", marks=pytest.mark.slow) if c == "gan" else c for c in CASES])
def test_sound_trainer_step_within_the_limits_and_each_planted_fault_crosses_one(case):
    m = run_case(case)
    assert not crossed(case, m), m
    for fault in CASES[case][2]:
        if (case, fault) not in NOT_SEEN:
            f = run_case(case, fault=fault)
            assert crossed(case, f), (fault, f)


if __name__ == "__main__":
    import argparse
    import json

    parser = argparse.ArgumentParser()
    parser.add_argument("cases", nargs="*", default=list(CASES))
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = parser.parse_args()
    torch.set_num_threads(1)
    for case in args.cases:
        sound, faulty = {}, {}
        for seed in args.seeds:
            m = run_case(case, seed)
            print(json.dumps({"case": case, "seed": seed, "limits": LIMITS[case], "sound": m}), flush=True)
            sound = {k: max(sound.get(k, -np.inf), v) for k, v in m.items()}
            for fault in CASES[case][2]:
                f = run_case(case, seed, fault)
                print(json.dumps({"case": case, "seed": seed, "fault": fault, **f}), flush=True)
                faulty[fault] = {k: min(faulty.get(fault, {}).get(k, np.inf), v) for k, v in f.items()}
        print(json.dumps({"case": case, "seeds": args.seeds, "sound_max": sound, "fault_min": faulty}), flush=True)
