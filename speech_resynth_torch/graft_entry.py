"""Entry points: the flagship decoder's forward, and a multi-process dry run.

Counterpart of the JAX package's root ``__graft_entry__.py``:

* ``entry(device=None)`` returns ``(fn, example_args)``: ``fn`` is the
  composite decoder's ``synthesize`` (the CFM's 16-step Euler ODE and the
  HiFi-GAN vocoder, K1 and K2 on the card) at reference sizes (CFM h=256 /
  d=4, vocab 2000, vocoder x320, ``BF16_INFERENCE``, seeded random weights),
  dt 0.0625, truncation 1.0; the arguments are seeded (2, 128) unit ids and
  a generator for the noise, on ``device`` (the card unless ``"cpu"``).
* ``dryrun_multichip(n)`` runs full training steps on ``n`` processes of
  ``torch.distributed`` (NCCL, one card each; gloo with ``device="cpu"``):
  the CFM trainer data-parallel over all of them, the HiFi-GAN trainer's
  D->G step data-parallel, and for even ``n`` the speech LM over a (n/2, 2)
  mesh: DP x TP, FSDP x TP, sequence parallelism and the GPipe pipeline.
  Each step's loss must be finite; rank 0 prints one line a step.
  ``dryrun_steps`` takes the same steps inside a process group that is
  already up.

    python -m speech_resynth_torch.graft_entry [n] [--device cpu]
"""

from __future__ import annotations

import socket
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .core.device import DeviceLike, resolve_device
from .models.cfm import CFMConfig
from .models.hifigan import HifiGanConfig

# the flagship decoder at reference sizes
MODEL_CONFIG = CFMConfig(vocab_size=2000)
VOCODER_CONFIG = HifiGanConfig()
ENTRY_IDS = (2, 128)
ENTRY_DT, ENTRY_TRUNCATION = 0.0625, 1.0


def entry(device: DeviceLike = None):
    """(fn, example_args): ``fn(input_ids, generator) -> (waveforms, lengths)``."""
    from .core.precision import BF16_INFERENCE
    from .models.composite import ConditionalFlowMatchingWithHifiGan

    device = resolve_device(device)
    decoder = ConditionalFlowMatchingWithHifiGan.from_config(MODEL_CONFIG, VOCODER_CONFIG, BF16_INFERENCE, device=device)

    def fn(input_ids, generator):
        return decoder.synthesize(input_ids, dt=ENTRY_DT, truncation_value=ENTRY_TRUNCATION, generator=generator)

    ids = np.random.default_rng(0).integers(1, MODEL_CONFIG.vocab_size + 1, ENTRY_IDS)
    return fn, (torch.from_numpy(ids).to(device), torch.Generator(device=device).manual_seed(0))


def _finite(name: str, loss) -> float:
    value = float(loss)
    if not np.isfinite(value):
        raise AssertionError(f"{name} produced a non-finite loss: {value}")
    return value


def dryrun_steps(device: DeviceLike = None) -> List[Tuple[str, float]]:
    """The dry run's steps over the process group that is up (every process
    calls it): [(step name, loss)], each loss finite; rank 0 prints them."""
    from .core.mesh import DATA_AXIS, make_mesh, process_count, process_index, shard_batch
    from .core.precision import DEFAULT
    from .models.composite import init_random_weights
    from .models.llama import LlamaConfig, LlamaLM, causal_lm_loss_terms
    from .parallel import fsdp_rules, pipelined_llama_loss_fn
    from .parallel.pipeline import pipeline_grad_norm, pipeline_stage
    from .train.cfm import CFMTrainerConfig, make_trainer
    from .train.common import make_optimizer, warmup_linear_decay
    from .train.hifigan import HifiGanTrainerConfig, make_gan_trainer
    from .train.speechlm import SpeechLMTrainerConfig, make_speechlm_trainer

    device = resolve_device(device)
    n = process_count()
    out: List[Tuple[str, float]] = []

    def report(name: str, loss, key: str = "loss") -> None:
        value = _finite(name, loss)
        out.append((name, value))
        if process_index() == 0:
            print(f"dryrun_multichip({n}): {name} step ok, {key}={value:.4f}", flush=True)

    mesh = make_mesh(data=n, model=1)
    data_group = mesh.group(DATA_AXIS)
    rng = np.random.default_rng(0)

    # CFM, data-parallel over every process, duration prediction and remat on
    cfg = CFMConfig(vocab_size=32, dim_in=8, dim_cond_emb=16, hidden_size=16, depth=2, heads=2, intermediate_size=24,
                    conv_pos_embed_kernel_size=7, conv_pos_embed_groups=16, predict_duration=True, remat=True)
    tcfg = CFMTrainerConfig(batch_size=2 * n, frames_per_seg=16, max_norm=0.1)
    _, state, step = make_trainer(cfg, tcfg, 10, None, DEFAULT, device, data_group=data_group)
    B, L, N = 2 * n, 8, 16
    batch = {
        "input_ids": rng.integers(1, 33, (B, L)),
        "duration_labels": np.full((B, L), 2),
        "spectrogram_labels": rng.standard_normal((B, N, 8)).astype(np.float32),
    }
    _, metrics = step(state, shard_batch(batch, mesh, device), 0)
    report("CFM DP", metrics["loss"])

    # the HiFi-GAN trainer's D->G step, data-parallel over every process
    gan_cfg = HifiGanConfig(model_in_dim=8, upsample_initial_channel=8, upsample_rates=(5, 4), upsample_kernel_sizes=(10, 8),
                            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
    # the generator's length invariant: mel(n_fft=extra, hop=x20) of its output has the input's frames
    extra = int(gan_cfg.waveform_lengths(1))
    gan_tcfg = HifiGanTrainerConfig(n_fft=extra, hop_size=gan_cfg.total_upsample, num_mels=8, steps_per_epoch=10)
    _, gan_state, gan_step = make_gan_trainer(gan_cfg, gan_tcfg, DEFAULT, device, data_group=data_group)
    B, T = n, 16
    S = (T - 1) * gan_cfg.total_upsample + extra
    gan_batch = {
        "mel": rng.standard_normal((B, T, 8)).astype(np.float32),
        "wav": (rng.standard_normal((B, S)) * 0.1).astype(np.float32),
        "mel_mask": np.ones((B, T), bool),
    }
    _, gan_metrics = gan_step(gan_state, shard_batch(gan_batch, mesh, device))
    for k, v in gan_metrics.items():
        _finite(f"HiFi-GAN DP D->G ({k})", v)
    report("HiFi-GAN DP D->G", gan_metrics["loss_gen"], "loss_gen")

    if n % 2:
        return out
    tp_mesh = make_mesh(data=n // 2, model=2)
    lm_cfg = LlamaConfig(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2)
    ids = rng.integers(2, 64, (n, 16))
    lm_batch = shard_batch({"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids}, tp_mesh, device)

    _, lm_state, lm_step = make_speechlm_trainer(lm_cfg, SpeechLMTrainerConfig(remat=True), tp_mesh, 10, DEFAULT, device)
    _, lm_metrics = lm_step(lm_state, lm_batch)
    report("speech-LM dp x tp", lm_metrics["loss"])

    def library_step(layout: str) -> float:
        """One AdamW step of the LM laid out by ``fsdp_rules`` (with TP) or
        as a pipeline stage (2 microbatches), as tests/test_torch_parallel.py
        steps the library's layouts."""
        model = LlamaLM(lm_cfg, DEFAULT, "xla")
        with torch.no_grad():
            init_random_weights(model, torch.Generator().manual_seed(0))
        model.to(device)
        norm = None
        if layout == "pp":
            pipeline_stage(model, tp_mesh)
            loss_and_backward = pipelined_llama_loss_fn(lm_cfg, tp_mesh, 2, DEFAULT)
            norm = pipeline_grad_norm(tp_mesh, [name for name, _ in model.named_parameters()])
        else:
            fsdp_rules(tp_mesh, model, min_size=64, tp=True)
            n_data = tp_mesh.shape[DATA_AXIS]

            def loss_and_backward(model, batch):
                logits, _ = model(batch["input_ids"], batch["attention_mask"])
                nll, count = causal_lm_loss_terms(logits, batch["labels"])
                dist.all_reduce(count, group=tp_mesh.group(DATA_AXIS))
                count = torch.clamp(count, min=1)
                (nll / count * n_data).backward()  # FSDP2 averages the gradients over the data axis
                nll = nll.detach()
                dist.all_reduce(nll, group=tp_mesh.group(DATA_AXIS))
                return nll / count

        kw = {} if norm is None else {"norm": norm}
        opt = make_optimizer(model.parameters(), warmup_linear_decay(10, 1, 1e-3, 1e-4), b1=0.9, b2=0.98, eps=1e-8,
                             max_norm=1.0, **kw)
        loss = loss_and_backward(model, lm_batch)
        grads = [p.grad for p in opt.params]
        opt.step(grads)
        return loss

    report("speech-LM fsdp x tp", library_step("fsdp"))
    _, sp_state, sp_step = make_speechlm_trainer(lm_cfg, SpeechLMTrainerConfig(sequence_parallel=True), tp_mesh, 10,
                                                 DEFAULT, device)
    _, sp_metrics = sp_step(sp_state, lm_batch)
    report("speech-LM sp x dp", sp_metrics["loss"])
    report("speech-LM pp x dp", library_step("pp"))
    return out


def _worker(rank: int, n: int, port: int, device_type: str) -> None:
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)  # n processes share the host's cores
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank, world_size=n)
    try:
        dryrun_steps(torch.device("cuda", rank) if device_type == "cuda" else "cpu")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device: DeviceLike = None) -> None:
    """``dryrun_steps`` on ``n`` new processes: one card each (NCCL), or the
    CPU (gloo) with ``device="cpu"``. Raises if a process fails."""
    import torch.multiprocessing as mp

    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multichip({n}) needs {n} cards, this machine has {torch.cuda.device_count()}")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_worker, args=(n, port, device.type), nprocs=n, start_method="spawn")


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description="the multi-process dry run of the trainers and the parallel layouts")
    parser.add_argument("n", nargs="?", type=int, default=torch.cuda.device_count() or 1)
    parser.add_argument("--device", default="cuda", help="cuda (one card a process, default) or cpu (gloo)")
    args = parser.parse_args()
    dryrun_multichip(args.n, args.device)
