"""The port's parallel layer (core/mesh.py, parallel/sharding.py,
parallel/pipeline.py) and the trainers' data parallelism on the CPU: gloo
process groups of 2 and 4 processes.

Each layout's speech-LM step is held against the single-process step of
``make_speechlm_trainer`` on the same seeded weights and the same global
batch, whose rows hold different numbers of valid tokens (so the data axis's
loss must be the global batch's mean, not a mean of means). The trainer's
own layouts: DP (data 2), TP (model 2), TP with sequence parallelism and at
4 processes DP x TP (2 x 2). The library's, driven here as the JAX package's
tests drive them: ``fsdp_rules`` (data 2, and FSDP x TP at 2 x 2) and
``pipelined_llama_loss_fn`` (PP, 2 stages x 2 microbatches, and PP x DP),
each stepped by ``train.common.make_optimizer`` as the trainer steps. The
CFM trainer's step, with dropout and the duration loss on rows of different
frame and token counts, and the HiFi-GAN trainer's, on 2 processes against
one; ``train_speechlm`` and ``train_flow_matching`` as torchrun would start
them on 2 processes against one process. The spawn of 4 also takes the
entry module's dry run (``graft_entry.dryrun_steps``: the CFM and HiFi-GAN
data-parallel steps, the LM's DP x TP, FSDP x TP, SP and PP steps).

Two steps each; f32. Tolerances: each step's loss rtol 1e-5; the parameters
after the two AdamW updates atol 2e-6 (summation orders differ between the
layouts; an element whose gradient is ~0 could still move by 2 lr where its
sign flips, which these seeds do not hit). One spawn per process count runs
every case; the mesh's policies are tested as pure functions.
"""

import contextlib
import dataclasses
import functools
import json
import socket
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from speech_resynth_torch import graft_entry
from speech_resynth_torch.core import mesh as M
from speech_resynth_torch.core.checkpoint import CheckpointManager
from speech_resynth_torch.core.config import config_from_dict
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.models.cfm import CFMConfig
from speech_resynth_torch.models.composite import init_random_weights
from speech_resynth_torch.models.llama import LlamaConfig, LlamaLM, causal_lm_loss_terms
from speech_resynth_torch.parallel import pipeline as PP
from speech_resynth_torch.parallel.sharding import fsdp_rules
from speech_resynth_torch.pipeline import train_loops
from speech_resynth_torch.train import cfm as torch_train_cfm
from speech_resynth_torch.train import speechlm as torch_train
from speech_resynth_torch.train.common import global_norm, make_optimizer, warmup_linear_decay
from speech_resynth_torch.train.speechlm import SpeechLMTrainerConfig, make_speechlm_trainer

LM = LlamaConfig(vocab_size=40, hidden_size=32, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4)
STEPS, ROWS, TOKENS = 2, 8, 12
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-6
SPAWN_TIMEOUT_S = 600
TRAINER = SpeechLMTrainerConfig(warmup_steps=1, lr=1e-3, lr_min=1e-4)
TOTAL_STEPS = 10

# name: (process count, data, model, layout, options); the layout is the
# trainer's own, or "fsdp" / "pp" through the library functions
CASES = {
    "dp": (2, 2, 1, "trainer", {}),
    "tp": (2, 1, 2, "trainer", {}),
    "tp_sequence_parallel": (2, 1, 2, "trainer", {"sequence_parallel": True}),
    "fsdp": (2, 2, 1, "fsdp", {}),
    "pp": (2, 1, 2, "pp", {"microbatches": 2}),
    "dp_tp": (4, 2, 2, "trainer", {}),
    "fsdp_tp": (4, 2, 2, "fsdp", {}),
    "pp_dp": (4, 2, 2, "pp", {"microbatches": 2}),
}


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(2, LM.vocab_size, (ROWS, TOKENS))
        for row in range(ROWS):
            ids[row, int(rng.integers(3, TOKENS + 1)) :] = 0
        out.append({"input_ids": ids, "attention_mask": (ids != 0).astype(np.int64), "labels": np.where(ids == 0, -100, ids)})
    return out


def _trainer_step(mesh, options):
    """(model, step) of ``make_speechlm_trainer`` over ``mesh``."""
    tcfg = dataclasses.replace(TRAINER, **options)
    model, state, step = make_speechlm_trainer(LM, tcfg, mesh, TOTAL_STEPS, FLOAT32, device="cpu")

    def run(batch):
        nonlocal state
        state, metrics = step(state, batch)
        return metrics["loss"]

    return model, run


def _library_step(mesh, layout, options):
    """(model, step) of the trainer's model and optimizer (the same seeded
    weights, schedule, AdamW and clip) laid out by ``fsdp_rules`` or as a
    pipeline stage stepped by ``pipelined_llama_loss_fn``."""
    model = LlamaLM(LM, FLOAT32, TRAINER.attn_implementation)
    with torch.no_grad():
        init_random_weights(model, torch.Generator().manual_seed(TRAINER.seed))
    n_data = mesh.shape[M.DATA_AXIS]
    norm = global_norm
    if layout == "pp":
        PP.pipeline_stage(model, mesh)
        loss_and_backward = PP.pipelined_llama_loss_fn(LM, mesh, options["microbatches"], FLOAT32)
        norm = PP.pipeline_grad_norm(mesh, [n for n, _ in model.named_parameters()])
    else:
        fsdp_rules(mesh, model, tp=mesh.shape[M.MODEL_AXIS] > 1)

        def loss_and_backward(model, batch):
            logits, _ = model(batch["input_ids"], batch["attention_mask"])
            nll, count = causal_lm_loss_terms(logits, batch["labels"])
            dist.all_reduce(count, group=mesh.group(M.DATA_AXIS))
            count = torch.clamp(count, min=1)
            (nll / count * n_data).backward()  # FSDP2 averages the gradients over the data axis
            nll = nll.detach()
            dist.all_reduce(nll, group=mesh.group(M.DATA_AXIS))
            return nll / count

    schedule = warmup_linear_decay(TOTAL_STEPS, TRAINER.warmup_steps, TRAINER.lr, TRAINER.lr_min)
    opt = make_optimizer(model.parameters(), schedule, b1=TRAINER.beta1, b2=TRAINER.beta2, eps=1e-8,
                         max_norm=TRAINER.max_norm, norm=norm)

    def run(batch):
        loss = loss_and_backward(model, batch)
        grads = [p.grad for p in opt.params]
        for p in opt.params:
            p.grad = None
        opt.step(grads)
        return loss

    return model, run


def _run(mesh, layout="trainer", options=None):
    """(losses, host copy of the state dict, rows this process stepped on) of
    STEPS steps over ``mesh``."""
    options = options or {}
    model, run = _trainer_step(mesh, options) if layout == "trainer" else _library_step(mesh, layout, options)
    losses, rows = [], 0
    for batch in _batches():
        local = M.shard_batch(batch, mesh, torch.device("cpu"))
        rows += len(local["input_ids"])
        losses.append(float(run(local)))
    return losses, M.host_local_copy(model.state_dict()), rows


def _loop_config(root: Path, batch_size_per_device: int) -> dict:
    """A tiny LM's loop over 32 lines of at most 20 units, 2 epochs of 4
    steps at a global batch of 8: every line fits ``units_per_sample``, so no
    crop draws from a process's own stream and the batches are the same
    rows at any process count."""
    rng = np.random.default_rng(1)
    lines = "\n".join(" ".join(map(str, rng.integers(0, 20, rng.integers(6, 20)))) for _ in range(32))
    (root / "train.txt").write_text(lines + "\n")
    return {
        "dataset": {"train_file": str(root / "train.txt"), "units_per_sample": 24, "result_dir": str(root / "results"),
                    "swuggy_dev_file": str(root / "absent.json"), "sblimp_dev_file": str(root / "absent.json")},
        "dataloader": {"batch_size_per_device": batch_size_per_device},
        "model": {"path": str(root / "model"), "vocab_size": 22, "hidden_size": 16, "intermediate_size": 32,
                  "num_hidden_layers": 1, "num_attention_heads": 2, "pad_token_id": 0, "bos_token_id": None, "eos_token_id": 1},
        "optim": {"epoch": 2, "warmup_steps": 2, "lr": 1e-3, "lr_min": 1e-4, "beta1": 0.9, "beta2": 0.98, "max_norm": 1.0,
                  "summary_interval": 1},
    }


@contextlib.contextmanager
def _f32_trainer(module, name):
    """The loop's trainer ``module.name`` in f32 (the loops build their
    models in bf16 compute), so a 2-process run compares with a 1-process
    run at f32 tolerances."""
    make = getattr(module, name)
    setattr(module, name, functools.partial(make, policy=FLOAT32))
    try:
        yield
    finally:
        setattr(module, name, make)


CFM = CFMConfig(vocab_size=11, dim_in=8, dim_cond_emb=12, hidden_size=16, depth=2, heads=2, intermediate_size=24,
                conv_pos_embed_kernel_size=7, conv_pos_embed_groups=16, ff_dropout=0.2, attn_dropout=0.2,
                predict_duration=True)


def _cfm_batches():
    """4 rows of different token and frame counts (pads at 0 and -100), with
    durations covering each row's frames."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(1, CFM.vocab_size + 1, (4, 10))
        for row in range(4):
            ids[row, int(rng.integers(4, 11)) :] = 0
        durs = np.where(ids != 0, rng.integers(1, 3, ids.shape), 0)
        frames = np.minimum(durs.sum(1), 14)
        mels = rng.standard_normal((4, 14, CFM.dim_in)).astype(np.float32) * 2 - 5
        mels[np.arange(14)[None, :] >= frames[:, None]] = -100.0
        out.append({"input_ids": ids, "spectrogram_labels": mels, "duration_labels": durs})
    return out


def _cfm_run(mesh):
    """(metrics of each step, state dict) of the CFM trainer (dropout on,
    the duration loss) over STEPS steps: every row on one process (``mesh``
    None), or each data replica its rows (``data_group``)."""
    group = None if mesh is None else mesh.group(M.DATA_AXIS)
    tcfg = torch_train_cfm.CFMTrainerConfig(warmup_steps=1, lr=1e-3, lr_min=1e-4, max_norm=1.0)
    model, state, step = torch_train_cfm.make_trainer(CFM, tcfg, TOTAL_STEPS, None, FLOAT32, "cpu", data_group=group)
    metrics = []
    for seed, batch in enumerate(_cfm_batches()):
        local = M.shard_batch(batch, mesh or M.Mesh(1, 1), torch.device("cpu"))
        state, m = step(state, local, seed + 3)
        metrics.append([float(m[k]) for k in sorted(m)])
    return metrics, {k: v.detach().clone() for k, v in model.state_dict().items()}


def _cfm_corpus(root: Path):
    """8 utterances of 8-16 units (a frame each): none reaches the crop's 16
    frames, so no crop draws from a process's own stream and the batches are
    the same rows at any process count."""
    rng = np.random.default_rng(2)
    units = {}
    for i in range(8):
        n = int(rng.integers(8, 17))
        name = f"train/u{i}"
        units[name] = {"units": rng.integers(0, 9, n).tolist(), "durations": [1] * n, "transcript": ""}
        out = root / "spec" / f"{name}.npy"
        out.parent.mkdir(parents=True, exist_ok=True)
        np.save(out, (rng.standard_normal((n, 80)) - 5).astype(np.float32))
    (root / "train.json").write_text(json.dumps(units))


def _cfm_loop_config(root: Path) -> dict:
    """``tests/test_torch_train_loops.py``'s CFM (its tiny k-means encoder)
    with dropout on: 2 epochs of 2 steps at a global batch of 4."""
    fm = dict(batch_size=4, frames_per_seg=16, warmup_steps=2, lr=1e-3, lr_min=1e-4, max_norm=0.1, summary_interval=1,
              save_interval_epoch=1, dt=0.5, truncation_value=1.0, dense_model_name="_parallel_tiny",
              quantizer_model_name="kmeans", vocab_size=9, dim_in=80, dim_cond_emb=16, hidden_size=16, depth=2, heads=2,
              intermediate_size=24, ff_dropout=0.1, use_unet_skip_connection=False, conv_pos_embed_kernel_size=7,
              conv_pos_embed_groups=16, attn_dropout=0.1, mean=-5.8843, std=2.2615, predict_duration=False)
    return {
        "common": {"seed": 0},
        "dataset": {"wav_dir": str(root / "none"), "spectrogram_dir": str(root / "spec"), "ext_audio": ".wav",
                    "train_file": str(root / "train.json"), "dev_file": str(root / "missing_dev.json")},
        "flow_matching": {"path": str(root / "model"), "epoch": 2, **fm},
    }


@contextlib.contextmanager
def _tiny_encoder():
    """A 1-layer HuBERT registered for the CFM loop's k-means table."""
    from speech_resynth_torch.models import speech_encoder as SE
    from speech_resynth_torch.models.hubert import HubertConfig

    SE.DENSE_MODELS["_parallel_tiny"] = {
        "config": HubertConfig(hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=24,
                               conv_dim=(8, 8), conv_kernel=(10, 4), conv_stride=(5, 4), num_conv_pos_embeddings=8,
                               num_conv_pos_embedding_groups=2),
        "output_layer": 1,
    }
    try:
        yield
    finally:
        del SE.DENSE_MODELS["_parallel_tiny"]


def _train_flow_matching(root: Path) -> dict:
    with _tiny_encoder(), _f32_trainer(torch_train_cfm, "make_trainer"):
        return train_loops.train_flow_matching(config_from_dict(_cfm_loop_config(root)), device="cpu")


def _gan_run(mesh):
    """(metrics, state dict) after one f32 step of a small HiFi-GAN (its
    discriminators cut to 8 and 16 channels, as tests/test_torch_train_loops.py
    cuts them) on 4 full-length rows: all of them on one process (``mesh``
    None), or each data replica its rows with the gradients averaged over
    the data axis."""
    from speech_resynth_torch.models import hifigan as TH
    from speech_resynth_torch.models.hifigan import HifiGanConfig
    from speech_resynth_torch.train.hifigan import HifiGanTrainerConfig, make_gan_trainer

    TH.PERIOD_CHANNELS = (8, 8, 8, 8)  # a spawned process of its own: nothing else reads these
    TH.SCALE_SPECS = tuple((16, k, s, p, g) for _, k, s, p, g in TH.SCALE_SPECS)

    cfg = HifiGanConfig(model_in_dim=80, upsample_initial_channel=32, upsample_rates=(5, 4), upsample_kernel_sizes=(10, 8),
                        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
    rng = np.random.default_rng(4)
    T = 16
    batch = {"mel": rng.standard_normal((4, T, 80)).astype(np.float32) - 5,
             "wav": (rng.standard_normal((4, (T - 1) * 20 + 24)) * 0.1).astype(np.float32),
             "mel_mask": np.ones((4, T), bool)}
    group = None if mesh is None else mesh.group("data")
    (gen, mpd, msd), state, step = make_gan_trainer(cfg, HifiGanTrainerConfig(n_fft=24, hop_size=20), FLOAT32, "cpu", data_group=group)
    local = M.shard_batch(batch, mesh or M.Mesh(1, 1), torch.device("cpu"))
    state, metrics = step(state, local)
    params = {f"{n}.{k}": v.detach().clone() for n, m in (("gen", gen), ("mpd", mpd), ("msd", msd)) for k, v in m.state_dict().items()}
    return [float(metrics[k]) for k in sorted(metrics)], params


def _max_err(params, ref) -> float:
    """The largest difference over every process of what it holds."""
    err = torch.tensor(max(float((v - ref[k]).abs().max()) for k, v in params.items()))
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    return float(err)


def _worker(rank, world, port, queue, loop_roots):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    try:
        ref_losses, ref, _ = _run(M.Mesh(1, 1))
        for name, (n, data, model, layout, options) in CASES.items():
            if n != world:
                continue
            mesh = M.make_mesh(data, model)
            losses, params, rows = _run(mesh, layout, options)
            # each process compares what it holds (a pipeline stage: its layers and the replicated rest)
            err = _max_err(params, ref)
            held = torch.tensor([len(params), rows], dtype=torch.float64)
            dist.all_reduce(held)
            if rank == 0:
                queue.put((name, {"losses": losses, "ref_losses": ref_losses, "param_err": err, "held": float(held[0]),
                                  "rows": float(held[1]), "ref_params": len(ref)}))
        if world == 2:
            mesh = M.make_mesh(2, 1)
            ref_gan, gan = _gan_run(None), _gan_run(mesh)
            err = _max_err(gan[1], ref_gan[1])
            metrics = torch.tensor(gan[0])
            dist.all_reduce(metrics)
            if rank == 0:
                queue.put(("gan_dp", {"metrics": (metrics / world).tolist(), "ref_metrics": ref_gan[0], "param_err": err}))
            ref_cfm, cfm = _cfm_run(None), _cfm_run(mesh)
            err = _max_err(cfm[1], ref_cfm[1])
            if rank == 0:
                queue.put(("cfm_dp", {"metrics": cfm[0], "ref_metrics": ref_cfm[0], "param_err": err}))
            # the loops as torchrun would start them on two processes
            with _f32_trainer(torch_train, "make_speechlm_trainer"):
                lm_loop = train_loops.train_speechlm(config_from_dict(_loop_config(loop_roots["lm_two"], 4)), device="cpu")
            cfm_loop = _train_flow_matching(loop_roots["cfm_two"])
            if rank == 0:
                queue.put(("loop", lm_loop))
                queue.put(("cfm_loop", cfm_loop))
        if world == 4:  # graft_entry's dry run: every step of graft_entry.dryrun_multichip(4)
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            t0 = time.perf_counter()
            steps = graft_entry.dryrun_steps("cpu")
            torch.set_num_threads(threads)
            if rank == 0:
                queue.put(("dryrun", {"steps": steps, "seconds": time.perf_counter() - t0}))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def loop_roots(tmp_path_factory):
    roots = {k: tmp_path_factory.mktemp(k) for k in ("lm_one", "lm_two", "cfm_one", "cfm_two")}
    for k in ("cfm_one", "cfm_two"):
        _cfm_corpus(roots[k])
    return roots


@pytest.fixture(scope="module")
def results(loop_roots):
    """Every case, from one spawn of 2 processes and one of 4."""
    ctx = mp.get_context("spawn")
    out = {}
    for world in (2, 4):
        queue = ctx.SimpleQueue()
        procs = mp.start_processes(_worker, args=(world, _free_port(), queue, loop_roots), nprocs=world,
                                   start_method="spawn", join=False)
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        done = False
        while not done:  # drain the queue while the workers run: a full pipe would block their puts
            done = procs.join(timeout=1)  # raises if a worker failed
            while not queue.empty():
                name, record = queue.get()
                out[name] = record
            if not done and time.monotonic() > deadline:
                for proc in procs.processes:
                    proc.terminate()
                pytest.fail(f"the {world} gloo processes did not finish in {SPAWN_TIMEOUT_S} s")
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_layout_step_equals_the_single_process_step(results, case):
    r = results[case]
    np.testing.assert_allclose(r["losses"], r["ref_losses"], rtol=LOSS_RTOL, atol=0)
    assert r["param_err"] <= PARAM_ATOL, r["param_err"]
    n, data, model, layout, options = CASES[case]
    assert r["rows"] == STEPS * ROWS * model  # each data replica steps on its rows; the model axis shares them
    if layout == "pp":  # every stage holds its layer's 9 tensors and the 3 replicated ones
        assert r["held"] == n * (9 + 3) and r["ref_params"] == 2 * 9 + 3
    else:
        assert r["held"] == n * r["ref_params"]


def test_dryrun_multichip_steps_on_four_processes(results):
    """``graft_entry.dryrun_multichip(4)``'s steps, each loss finite."""
    r = results["dryrun"]
    assert [name for name, _ in r["steps"]] == [
        "CFM DP", "HiFi-GAN DP D->G", "speech-LM dp x tp", "speech-LM fsdp x tp", "speech-LM sp x dp", "speech-LM pp x dp"
    ]
    assert all(np.isfinite(loss) for _, loss in r["steps"]), r


def test_losses_fall_over_the_steps(results):
    """The one-process trainer's steps (the reference of every case) lower
    the loss: its first STEPS losses are the spawned reference's, and a
    second pass over the same batches gives each a lower loss than the
    first (the batches differ, so one step's loss is no bound on the next's)."""
    r = results["dp"]
    assert all(np.isfinite(r["ref_losses"]))
    _, run = _trainer_step(M.Mesh(1, 1), {})
    batches = [M.shard_batch(b, M.Mesh(1, 1), torch.device("cpu")) for b in _batches()]
    losses = [float(run(b)) for b in batches + batches]
    np.testing.assert_allclose(losses[:STEPS], r["ref_losses"], rtol=LOSS_RTOL, atol=0)
    assert all(again < first for first, again in zip(losses[:STEPS], losses[STEPS:])), losses


def test_gan_step_on_two_processes_equals_one(results):
    """The HiFi-GAN trainer's data-parallel step (``data_group``: each
    process's rows, gradients averaged, as the loops run it under torchrun):
    its losses are means over equal rows, so it equals the one-process step."""
    r = results["gan_dp"]
    np.testing.assert_allclose(r["metrics"], r["ref_metrics"], rtol=LOSS_RTOL)
    assert r["param_err"] <= PARAM_ATOL, r["param_err"]


def test_cfm_step_on_two_processes_equals_one(results):
    """The CFM trainer's data-parallel step (``data_group``) on rows of
    different frame and token counts, with dropout and the duration loss:
    its noise, flow times and dropout masks are its rows of the global
    batch's draws and its loss is over the global counts, so its metrics
    (the global batch's) and its updates equal the one-process step's."""
    r = results["cfm_dp"]
    np.testing.assert_allclose(r["metrics"], r["ref_metrics"], rtol=LOSS_RTOL)
    assert r["param_err"] <= PARAM_ATOL, r["param_err"]


def _checkpoints(roots, path: str, steps):
    """Each root's latest checkpoint's model state, after checking the saved steps."""
    states = []
    for root in roots:
        with CheckpointManager(root / path / "ckpt") as ckpt:
            assert ckpt.all_steps() == steps
            states.append(ckpt.read()["modules"]["model"])
    return states


def test_train_speechlm_on_two_processes_equals_one(results, loop_roots):
    """``train_speechlm`` under a process group of 2 (batch 4 a process)
    against one process at batch 8: the same steps, checkpoints (written by
    rank 0) and exported weights."""
    with _f32_trainer(torch_train, "make_speechlm_trainer"):
        one = train_loops.train_speechlm(config_from_dict(_loop_config(loop_roots["lm_one"], 8)), device="cpu")
    two = results["loop"]
    assert one["step"] == two["step"] == 8
    assert two["metrics"]["loss"] == pytest.approx(one["metrics"]["loss"], rel=LOSS_RTOL)
    states = _checkpoints((loop_roots["lm_one"], loop_roots["lm_two"]), "model", [4, 8])
    for root in (loop_roots["lm_one"], loop_roots["lm_two"]):
        assert (root / "model" / "hf" / "model.safetensors").is_file()
    for k, v in states[0].items():
        np.testing.assert_allclose(states[1][k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL, err_msg=k)


def test_train_flow_matching_on_two_processes_equals_one(results, loop_roots):
    """``train_flow_matching`` under a process group of 2 (2 rows a process,
    dropout on) against one process: the same steps, metrics, checkpoints
    (written by rank 0) and export."""
    one = _train_flow_matching(loop_roots["cfm_one"])
    two = results["cfm_loop"]
    assert one["step"] == two["step"] == 4
    for k, v in one["metrics"].items():
        assert two["metrics"][k] == pytest.approx(v, rel=LOSS_RTOL), k
    states = _checkpoints((loop_roots["cfm_one"], loop_roots["cfm_two"]), "model", [2, 4])
    assert (loop_roots["cfm_two"] / "model" / "hf" / "model.safetensors").is_file()
    for k, v in states[0].items():
        np.testing.assert_allclose(states[1][k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# pure policies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,data,model,want",
    [(8, None, 1, (8, 1)), (8, None, 2, (4, 2)), (8, 2, 4, (2, 4)), (8, 2, 2, (2, 2)), (1, None, 1, (1, 1))],
)
def test_mesh_shape(n, data, model, want):
    assert M.mesh_shape(n, data, model) == want


@pytest.mark.parametrize("n,data,model,match", [(8, None, 3, "not divisible"), (4, 4, 2, "needs 8 devices")])
def test_mesh_shape_errors(n, data, model, match):
    with pytest.raises(ValueError, match=match):
        M.mesh_shape(n, data, model)


def test_single_process_mesh_has_no_device_mesh():
    mesh = M.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device_mesh is None and mesh.group("data") is None
    assert M.data_coordinates(mesh) == (0, 1)
    with pytest.raises(ValueError, match="covers 2 of 1|needs 2 devices"):
        M.make_mesh(data=2)
    assert M.distributed_init(torch.device("cpu")) is False  # no torchrun variables: a no-op


@pytest.mark.parametrize("batch,n,want", [(2700, 8, (8, 2696)), (64, 4, (4, 64)), (6, 8, (2, 6)), (3, 8, (1, 3)), (44, 1, (1, 44))])
def test_dp_batch_policy(batch, n, want):
    """Rounded down to a multiple of n at or above n, else the gcd data axis
    (the JAX ``dp_mesh_for_batch``)."""
    assert M.dp_batch_policy(batch, n) == want


def test_local_batch_slice_and_shard_batch():
    assert [M.local_batch_slice(12, i, 3) for i in range(3)] == [slice(0, 4), slice(4, 8), slice(8, 12)]
    assert M.local_batch_slice(12) == slice(0, 12)
    batch = {"input_ids": np.arange(12).reshape(6, 2), "names": ["a"] * 6}
    out = M.shard_batch(batch, M.Mesh(1, 1), torch.device("cpu"))
    assert list(out) == ["input_ids"] and torch.equal(out["input_ids"], torch.arange(12).reshape(6, 2))


def test_pipeline_stages_and_errors():
    assert [list(PP.pp_stage_layers(4, 2, s)) for s in (0, 1)] == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="not divisible into 4 stages"):
        PP.pp_stage_layers(6, 4, 0)
    cfg6 = LlamaConfig(vocab_size=8, hidden_size=8, intermediate_size=16, num_hidden_layers=6, num_attention_heads=2)
    with pytest.raises(ValueError, match="not divisible into 4 stages"):
        PP.pipelined_llama_loss_fn(cfg6, M.Mesh(2, 4), num_microbatches=2)
    loss_fn = PP.pipelined_llama_loss_fn(LM, M.Mesh(1, 1), num_microbatches=3)
    with pytest.raises(ValueError, match="not divisible by num_microbatches=3"):
        loss_fn(None, {"input_ids": torch.ones(4, 5, dtype=torch.long)})
    from speech_resynth_torch.models.llama import LlamaLM

    owners = PP.pp_param_shardings(M.Mesh(1, 2), LlamaLM(LM))
    assert owners["model.layers.0.mlp.up_proj.weight"] == 0 and owners["model.layers.1.input_layernorm.weight"] == 1
    assert owners["model.embed_tokens.weight"] is owners["lm_head.weight"] is owners["model.norm.weight"] is None
