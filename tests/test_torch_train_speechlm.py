"""The port's speech-LM trainer against the JAX package: the loss, the token
dataset, one trainer step (with and without accumulation), remat, the
attention routes, the FLOP count, and the loop with its checkpoint readers
(``train_speechlm``, ``eval_speechlm``, ``generate_speechlm``).

Weights come from the JAX package's init (FLOAT32 policy; the norm gains
moved off 1) through ``models/convert.py``. Tolerances (f32, JAX at
"highest" matmul precision, another summation order): losses and gradient
norms rtol 1e-5; after an AdamW update the parameters are compared where
|g| > 1e-6 max|g| of their tensor, atol 1e-6 (Adam's first update is about
lr * sign(g), so where g is ~0 the two frameworks may move an element by
2 lr in opposite directions); logits atol 1e-4. The token batches compare
bit for bit; the resumed loop's parameters equal the straight run's exactly.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_resynth_tpu.core.mesh import make_mesh as jax_make_mesh
from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.models import llama as JL
from speech_resynth_tpu.pipeline import data as jax_data
from speech_resynth_tpu.pipeline import speechlm as jax_speechlm
from speech_resynth_tpu.train import speechlm as jax_train
from speech_resynth_torch.core.checkpoint import CheckpointManager
from speech_resynth_torch.core.config import config_from_dict
from speech_resynth_torch.core.metrics import llama_matmul_params, step_flops
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.models import llama as TL
from speech_resynth_torch.models.convert import llama_state_dict
from speech_resynth_torch.ops import attention as TA
from speech_resynth_torch.pipeline import data as torch_data
from speech_resynth_torch.pipeline import train_loops
from speech_resynth_torch.pipeline.speechlm import load_lm_from_hf
from speech_resynth_torch.train import speechlm as torch_train

LM_KW = dict(vocab_size=40, hidden_size=32, intermediate_size=48, num_hidden_layers=2, num_attention_heads=2)
TRAIN_KW = dict(warmup_steps=2, lr=1e-3, lr_min=1e-4)
B, L = 4, 12


def _batch(seed):
    """Ids past the specials, rows right-padded with 0 from different points;
    the mask and labels as UnitTextDataset makes them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, LM_KW["vocab_size"], (B, L)).astype(np.int32)
    for row, n in enumerate((L, 9, 5, 11)):
        ids[row, n:] = 0
    return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32), "labels": np.where(ids == 0, -100, ids).astype(np.int32)}


def _tensors(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _fill_gains(params, seed=1):
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a, np.float32)
        return jnp.asarray(1.0 + 0.1 * rng.standard_normal(a.shape).astype(np.float32) if a.ndim == 1 else a)

    return jax.tree_util.tree_map(fill, params)


# ---------------------------------------------------------------------------
# the loss and the token dataset
# ---------------------------------------------------------------------------


def test_causal_lm_loss_equals_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[1, 4:] = -100
    labels[2, :] = -100
    theirs = float(JL.causal_lm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    ours = TL.causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(labels).long())
    assert ours.dtype == torch.float32
    assert float(ours) == pytest.approx(theirs, rel=1e-6)
    none_valid = torch.full((2, 5), -100)
    assert float(TL.causal_lm_loss(torch.zeros(2, 5, 4), none_valid)) == 0.0


@pytest.fixture(scope="module")
def unit_lines(tmp_path_factory):
    path = tmp_path_factory.mktemp("units") / "train.txt"
    rng = np.random.default_rng(3)
    path.write_text("\n".join(" ".join(map(str, rng.integers(0, 30, int(rng.integers(3, 20))))) for _ in range(26)) + "\n\n")
    return str(path)


@pytest.mark.parametrize("process_count", [1, 2])
@pytest.mark.parametrize("seed", [0, 7])
def test_unit_text_dataset_equals_jax(unit_lines, seed, process_count):
    """Every batch of every process, for two epochs, bit for bit."""
    kw = dict(units_per_sample=10, num_special_tokens=2, eos_token_id=1)
    ours, theirs = torch_data.UnitTextDataset(unit_lines, **kw), jax_data.UnitTextDataset(unit_lines, **kw)
    assert len(ours) == len(theirs) == 26
    for epoch in (1, 2):
        for index in range(process_count):
            args = dict(seed=seed, epoch=epoch, process_index=index, process_count=process_count)
            got, want = list(ours.batches(8, **args)), list(theirs.batches(8, **args))
            assert len(got) == len(want) == 3
            for a, b in zip(got, want):
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# one trainer step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_matches_jax(accum_steps):
    """``accum_steps`` micro-steps of ``make_speechlm_trainer`` against the
    JAX trainer's from the same weights and batches: each micro-step's loss
    and gradient norm, then the updated parameters where |g| is not ~0."""
    tcfg = jax_train.SpeechLMTrainerConfig(accum_steps=accum_steps, **TRAIN_KW)
    _, jstate, jstep, _ = jax_train.make_speechlm_trainer(JL.LlamaConfig(**LM_KW), tcfg, jax_make_mesh(data=1), 10, policy=JAX_FLOAT32)
    jstate = jstate.replace(params=_fill_gains(jstate.params))
    before = llama_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))  # the step donates its state

    ptcfg = torch_train.SpeechLMTrainerConfig(accum_steps=accum_steps, **TRAIN_KW)
    model, state, step = torch_train.make_speechlm_trainer(TL.LlamaConfig(**LM_KW), ptcfg, None, 10, FLOAT32, device="cpu")
    model.load_state_dict(before)
    assert ptcfg.attn_implementation == "xla" and all(l.attn_implementation == "xla" for l in model.model.layers)

    batches = [_batch(10 + i) for i in range(accum_steps)]
    # the gradient the update applies: the mean over the micro-batches
    probe = copy.deepcopy(model)
    grads = {n: torch.zeros_like(p) for n, p in probe.named_parameters()}
    for b in batches:
        t = _tensors(b)
        loss = TL.causal_lm_loss(probe(t["input_ids"], t["attention_mask"])[0], t["labels"])
        for (n, _), g in zip(probe.named_parameters(), torch.autograd.grad(loss, list(probe.parameters()))):
            grads[n] += g / accum_steps
    for b in batches:
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, metrics = step(state, _tensors(b))
        for key in ("loss", "grad_norm"):
            assert float(metrics[key]) == pytest.approx(float(jmetrics[key]), rel=1e-5), key
    assert state.step == accum_steps and state.optimizers["model"].count == 1
    after = llama_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))
    for name, p in model.named_parameters():
        g = grads[name].abs()
        live = g > 1e-6 * g.max()
        assert live.float().mean() > 0.5, name
        assert (p.detach() - before[name])[live].abs().max() > 0, name
        np.testing.assert_allclose(p.detach()[live].numpy(), after[name][live].numpy(), rtol=0, atol=1e-6, err_msg=name)


def test_remat_gives_the_same_loss_and_gradients():
    cfg = TL.LlamaConfig(**LM_KW)
    plain = TL.LlamaLM(cfg, FLOAT32)
    remat = TL.LlamaLM(cfg, FLOAT32, remat=True)
    remat.load_state_dict(plain.state_dict())
    t = _tensors(_batch(4))
    results = []
    for model in (plain, remat):
        loss = TL.causal_lm_loss(model(t["input_ids"], t["attention_mask"])[0], t["labels"])
        results.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    torch.testing.assert_close(results[0][0], results[1][0], rtol=0, atol=0)
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# attention routes
# ---------------------------------------------------------------------------


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """Tensors that report is_cuda, and K1's wrapper swapped for a counting
    plain version, so the dispatcher's routing shows on the CPU."""
    launches = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(
        TA, "flash_attention", lambda q, k, v, mask, causal: launches.append(q.shape) or TA.attention_reference(q, k, v, mask, causal)
    )
    return launches


ROUTE_KW = dict(vocab_size=24, hidden_size=128, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2)  # d = 64


@pytest.mark.parametrize("implementation,launches", [("xla", 0), ("auto", 2), ("pallas", 2)])
def test_training_attention_routes(as_if_on_the_card, implementation, launches):
    """"xla" never reaches K1; "auto" and "pallas" take it in every layer's
    forward (the backward is the plain version's), with the same loss and
    gradients, since the swapped kernel is the plain version."""
    cfg = TL.LlamaConfig(**ROUTE_KW)
    ref = TL.LlamaLM(cfg, FLOAT32, "xla")
    model = TL.LlamaLM(cfg, FLOAT32, implementation)
    model.load_state_dict(ref.state_dict())
    ids = torch.from_numpy(np.random.default_rng(5).integers(2, 24, (2, 8)))
    ids[1, 6:] = 0
    out = []
    for m in (model, ref):
        loss = TL.causal_lm_loss(m(ids, ids != 0)[0], torch.where(ids == 0, -100, ids))
        out.append((loss, torch.autograd.grad(loss, list(m.parameters()))))
    assert len(as_if_on_the_card) == launches
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_pallas_raises_where_the_kernel_does_not_take_the_shape(as_if_on_the_card):
    """Head dim 16: "auto" takes the plain version, "pallas" raises."""
    cfg = TL.LlamaConfig(**LM_KW)
    ids = torch.ones(1, 6, dtype=torch.long)
    TL.LlamaLM(cfg, FLOAT32, "auto")(ids)
    assert as_if_on_the_card == []
    with pytest.raises(ValueError, match="pallas"):
        TL.LlamaLM(cfg, FLOAT32, "pallas")(ids)
    with pytest.raises(ValueError, match="not one of"):
        TL.LlamaLM(cfg, FLOAT32, "flash")(ids)


# ---------------------------------------------------------------------------
# the FLOP count
# ---------------------------------------------------------------------------


def test_step_flops_counts_the_linear_layers_and_causal_attention():
    """The forward's products counted with hooks on every linear layer (2 x
    in x out per token) plus the causal attention's QK^T and PV at their
    causal half; the step is three forwards, four with remat."""
    cfg = TL.LlamaConfig(**LM_KW)
    model = TL.LlamaLM(cfg, FLOAT32)
    counted = []
    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            m.register_forward_hook(lambda mod, inp, out: counted.append(2 * inp[0].shape[:-1].numel() * mod.in_features * mod.out_features))
    t = _tensors(_batch(1))
    with torch.no_grad():
        model(t["input_ids"], t["attention_mask"])
    linear = sum(counted)
    assert linear == 2 * llama_matmul_params(cfg) * B * L
    d, h = cfg.head_dim, cfg.num_attention_heads
    causal_pairs = L * (L + 1) // 2
    attention = cfg.num_hidden_layers * B * h * causal_pairs * 2 * d * 2  # QK^T and PV
    assert step_flops(cfg, B, L) == 3 * (linear + attention)
    assert step_flops(cfg, B, L, remat=True) == pytest.approx(4 * (linear + attention))
    full = TL.LlamaConfig(vocab_size=16386)
    assert 9e12 < step_flops(full, 96, 128) < 1.1e13  # the shipped shape: ~1e13 FLOP a step


# ---------------------------------------------------------------------------
# the loop and the stages that read its checkpoint
# ---------------------------------------------------------------------------


def _loop_config(root: Path, epoch: int) -> dict:
    """The JAX loop test's config (tests/test_speechlm_loop.py): 32 lines, 4
    steps an epoch at batch 8, a tiny LM, dev and test sLM21 JSONs."""
    rng = np.random.default_rng(0)
    train_file = root / "train.txt"
    if not train_file.exists():
        train_file.write_text("\n".join(" ".join(map(str, rng.integers(0, 20, rng.integers(6, 20)))) for _ in range(32)) + "\n")
        for name in ("swuggy_dev", "sblimp_dev", "swuggy_test", "sblimp_test"):
            (root / f"{name}.json").write_text(json.dumps({f"{name}_a": [1, 2, 3], f"{name}_b": [2, 3], f"{name}_c": [4, 5, 6, 7]}))
    return {
        "dataset": {
            "train_file": str(train_file), "units_per_sample": 8,
            **{f"{k}_file": str(root / f"{k}.json") for k in ("swuggy_dev", "sblimp_dev", "swuggy_test", "sblimp_test")},
            "swuggy_dir": str(root / "no_lex"), "sblimp_dir": str(root / "no_syn"), "result_dir": str(root / "results"),
        },
        "dataloader": {"batch_size_per_device": 8, "num_workers": 0},
        "model": {"path": str(root / "model"), "vocab_size": 22, "hidden_size": 16, "intermediate_size": 32,
                  "num_hidden_layers": 1, "num_attention_heads": 2, "pad_token_id": 0, "bos_token_id": None, "eos_token_id": 1},
        "optim": {"epoch": epoch, "warmup_steps": 2, "lr": 1e-3, "lr_min": 1e-4, "beta1": 0.9, "beta2": 0.98, "max_norm": 1.0,
                  "summary_interval": 1},
    }


class Killed(Exception):
    pass


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One run of 2 epochs straight through, and one killed right after epoch
    1's checkpoint (step 4) and resumed."""
    roots = {k: tmp_path_factory.mktemp(k) for k in ("straight", "resumed")}
    results = {"straight": train_loops.train_speechlm(config_from_dict(_loop_config(roots["straight"], 2)), device="cpu")}

    class KillAfterSave(CheckpointManager):
        def save(self, step, state, force=False):
            saved = super().save(step, state, force)
            if saved and step == 4:
                raise Killed(step)
            return saved

    cfg = config_from_dict(_loop_config(roots["resumed"], 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_loops, "CheckpointManager", KillAfterSave)
        with pytest.raises(Killed):
            train_loops.train_speechlm(cfg, device="cpu")
    killed_at = _checkpoint(roots["resumed"])[0]
    results["resumed"] = train_loops.train_speechlm(cfg, device="cpu")
    return roots, results, killed_at


def _checkpoint(root: Path):
    with CheckpointManager(root / "model" / "ckpt") as ckpt:
        return ckpt.all_steps(), ckpt.read()


def test_train_speechlm_resumes_equal_to_a_straight_run(trained):
    roots, results, killed_at = trained
    assert killed_at == [4] and results["straight"]["step"] == results["resumed"]["step"] == 8
    steps, straight = _checkpoint(roots["straight"])
    assert steps == [4, 8]
    steps, resumed = _checkpoint(roots["resumed"])
    assert steps == [4, 8]
    assert straight["step"] == resumed["step"] == 8
    for k, v in straight["modules"]["model"].items():
        assert torch.equal(v, resumed["modules"]["model"][k]), k
    for a, b in zip(straight["optimizers"]["model"]["adamw"]["state"].values(), resumed["optimizers"]["model"]["adamw"]["state"].values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert np.isfinite(results["straight"]["metrics"]["loss"])
    # the dev sLM21 score files of the last validation
    lines = (roots["straight"] / "results" / "lexical" / "dev.txt").read_text().splitlines()
    assert [l.split()[0] for l in lines] == ["swuggy_dev_a", "swuggy_dev_b", "swuggy_dev_c"]


def test_the_export_loads_in_both_packages(trained):
    """<model.path>/hf, as the JAX loop writes it (model.safetensors),
    loads through the port's and the JAX package's ``load_lm_from_hf`` and
    gives the checkpoint's logits."""
    roots, _, _ = trained
    hf = roots["straight"] / "model" / "hf"
    config = json.loads((hf / "config.json").read_text())
    assert config["architectures"] == ["LlamaForCausalLM"] and config["vocab_size"] == 24 and config["torch_dtype"] == "float32"
    assert (hf / "model.safetensors").is_file() and not (hf / "pytorch_model.bin").exists()
    _, state = _checkpoint(roots["straight"])
    ref = TL.LlamaLM(TL.LlamaConfig(**{k: config[k] for k in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                                                                 "num_attention_heads")}), FLOAT32)
    ref.load_state_dict(state["modules"]["model"])
    ids = np.random.default_rng(2).integers(2, 24, (2, 9))
    with torch.no_grad():
        want = ref(torch.from_numpy(ids))[0].numpy()
        ours = load_lm_from_hf(hf, policy=FLOAT32, device="cpu")(torch.from_numpy(ids))[0].numpy()
    np.testing.assert_array_equal(ours, want)
    jmodel, variables = jax_speechlm.load_lm_from_hf(str(hf), policy=JAX_FLOAT32)
    theirs = np.asarray(jmodel.apply(variables, jnp.asarray(ids))[0])
    np.testing.assert_allclose(theirs, want, rtol=1e-5, atol=1e-4)


def test_eval_speechlm_scores_the_checkpoint(trained):
    """The test score files of the checkpoint's LM (no gold tables and no
    zrc here: no aggregate numbers), equal to scoring that LM directly."""
    roots, _, _ = trained
    cfg = config_from_dict(_loop_config(roots["straight"], 2))
    assert train_loops.eval_speechlm(cfg, device="cpu") is None
    lines = (roots["straight"] / "results" / "lexical" / "test.txt").read_text().splitlines()
    assert [l.split()[0] for l in lines] == ["swuggy_test_a", "swuggy_test_b", "swuggy_test_c"]
    lm, num_special = train_loops._restore_lm(cfg, torch.device("cpu"))
    assert num_special == 2 and lm.model.layers[0].attn_implementation == "auto"
    batch = next(torch_data.load_named_units_from_json(cfg.dataset.swuggy_test_file, 8, num_special))
    ids = torch.from_numpy(batch["input_ids"]).long()
    with torch.no_grad():
        want = TL.sequence_pseudo_log_prob(lm(ids)[0], ids)
    assert [float(l.split()[1]) for l in lines] == pytest.approx(want.tolist(), rel=1e-6)


def test_entry_points_default_to_the_card(trained, monkeypatch):
    roots, _, _ = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config_from_dict(_loop_config(roots["straight"], 2))
    for entry in (train_loops.train_speechlm, train_loops.eval_speechlm):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_train.make_speechlm_trainer(TL.LlamaConfig(**LM_KW), torch_train.SpeechLMTrainerConfig())
