"""Epoch-level training loops and the speech-LM stages that read their checkpoint.

Counterparts of the functions of the same names in
speech_resynth_tpu/pipeline/train_loops.py. Each loop calls
``core.mesh.distributed_init`` (torchrun's variables start the process group,
one process per device; without them it runs on one process), takes its
batch iterator's process index and count from the process group (its data
coordinate) and has rank 0 alone write checkpoints, exports, logs and
validation, after a symmetric ``host_local_copy``:

* ``train_flow_matching``: the CFM trainer over ``UnitDataset`` batches,
  checkpoints every ``save_interval_epoch`` epochs with the HF-format
  export to ``<flow_matching.path>/hf``; a run resumes from its latest
  checkpoint at the epoch after it (``step // steps_per_epoch + 1``); at
  each save, rank 0 first runs ``validate_flow_matching`` on the dev set
  (WER, CER and MOS of the resynthesized dev utterances through the scorers
  of ``pipeline.scorers``, five ``hyp/`` clips), unless there is no dev set
  or no vocoder export yet.
* ``train_hifigan``: the GAN trainer over ``MelDataset`` crops, checkpoints
  and the generator's export (to ``hifigan.path``) every
  ``checkpoint_interval`` steps, full-length validation every
  ``validation_interval`` steps, a final forced save; a run resumes exactly
  mid-epoch by skipping the batches it already took (batches are a function
  of (seed, epoch)).
* ``train_speechlm``: the speech-LM trainer over ``UnitTextDataset``
  batches of ``batch_size_per_device`` x the process count, data-parallel
  over the processes; a checkpoint, the HF export to ``<model.path>/hf``
  and the dev sLM21 scoring at each epoch's end; a run resumes at the epoch after its
  checkpoint (``step // steps_per_epoch + 1``), as the JAX loop does.
* ``eval_speechlm``: the sLM21 test evaluation of the checkpoint.
* ``generate_speechlm``: textless continuation of a prompt wav with the
  checkpoint's LM.

With several processes each trainer steps on its process's rows of the
global batch and reduces the gradients over the processes, so a step equals
the one-process step on the global batch, as the JAX step on its global
array: the CFM and the LM take their losses over the global counts of valid
frames or tokens (the CFM's noise, flow times and dropout masks drawn for
the global batch), the GAN averages, its losses being means over crops of
one length.

Exports are ``config.json`` + ``model.safetensors`` (f32) with the HF keys,
the files the JAX package exports, so
``ConditionalFlowMatchingWithHifiGan.load_pretrained`` serves a trained pair. Batches reach the device through ``prefetch``;
metrics are read back (a host sync) only every ``summary_interval`` steps,
with the steps per second and the MFU of the analytic FLOP counts of
``core.metrics`` (``train/MFU``, ``training/MFU``; 0.0 on the CPU).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.checkpoint import CheckpointManager
from ..core.device import DeviceLike, resolve_device
from ..core.mesh import DATA_AXIS, data_coordinates, distributed_init, dp_mesh_for_batch, host_local_copy, make_mesh, process_index
from ..core.metrics import MetricsWriter, StepTimer, cfm_step_flops, hifigan_step_flops, mfu, step_flops, trace_span
from ..core.precision import DEFAULT
from ..core.rng import RngStream
from ..dsp import audio_io
from ..dsp.mel import log_mel_spectrogram
from ..models.cfm import CFMConfig
from ..models.composite import ConditionalFlowMatchingWithHifiGan, load_vocoder
from ..models.convert import save_pretrained
from ..models.hifigan import HifiGanConfig, HifiGanGenerator
from ..models.llama import LlamaConfig, LlamaLM
from ..tokenizers.bpe import BpeTokenizer
from .data import MelDataset, UnitDataset, UnitTextDataset
from .generate import continue_speech, generate_unit_continuation
from .prefetch import prefetch, to_device
from .speechlm import _make_encoder, aggregate_slm21_scores, evaluate, run_zrc, write_scores

CFM_KEYS = ("input_ids", "spectrogram_labels", "duration_labels")
GAN_KEYS = ("mel", "wav", "mel_mask")
LM_KEYS = ("input_ids", "attention_mask", "labels")


def _mel_file_list(training_files: str) -> str:
    """The reference's MelDataset list (a tab-separated file list), or a unit
    JSON whose keys are the utterance names, written out as ``.filelist``."""
    path = Path(training_files)
    if path.suffix != ".json":
        return training_files
    with open(path) as f:
        names = list(json.load(f).keys())
    list_path = path.with_suffix(".filelist")
    # every process derives the list: a reader never sees another's partial write
    tmp = list_path.with_suffix(f".filelist.tmp{process_index()}")
    tmp.write_text("\n".join(names) + "\n")
    os.replace(tmp, list_path)
    return str(list_path)


def _read_metrics(metrics: dict) -> dict:
    """The step's metrics on the host: this waits for the card."""
    return {k: float(v) for k, v in metrics.items()}


def _save(ckpt: CheckpointManager, step: int, state, force: bool = False) -> dict:
    """A host copy of ``state`` gathered on every process (a collective),
    saved by rank 0; returns the copy."""
    payload = host_local_copy(state.state_dict())
    if process_index() == 0:
        ckpt.save(step, payload, force=force)
    return payload


def _barrier() -> None:
    """Every process waits here for rank 0's files."""
    if dist.is_initialized():
        dist.barrier()


@torch.inference_mode()
def validate_flow_matching(config, model, step: int, writer: MetricsWriter, max_utts: int = 16,
                           device: DeviceLike = None, noise=None) -> None:
    """Dev-set synthesis with the training CFM ``model`` and the exported
    vocoder (``hifigan.path``), scored by ``default_asr`` / ``default_mos``
    (``NullASR`` / ``EnergyMOS`` without checkpoints): ``dev/WER``,
    ``dev/CER``, ``dev/MOS``, ``dev/MOS (REF)`` and the first five
    ``hyp/<name>`` clips, over at most ``max_utts`` utterances in batches of
    up to 8. Nothing is written when there is no dev utterance or no vocoder
    export. The ODE noise of batch ``i`` is ``noise(i, shape)`` when given,
    else drawn from a generator seeded 0, as the JAX loop draws every
    batch's from ``key(0)``."""
    from ..text.normalize import cer, wer
    from .scorers import default_asr, default_mos

    device = resolve_device(device)
    dev_set = UnitDataset(config.dataset.dev_file, wav_dir=config.dataset.wav_dir, ext_audio=config.dataset.ext_audio)
    if len(dev_set) == 0:
        return
    voc_path = Path(config.hifigan.path) if "hifigan" in config else None
    if not (voc_path and (voc_path / "config.json").is_file()):
        return  # no vocoder yet: nothing to score
    vocoder = load_vocoder(voc_path, DEFAULT).to(device).eval().requires_grad_(False)  # the JAX sweep's default policy
    asr, mos = default_asr(config, device=device), default_mos(config, device=device)
    fm = config.flow_matching
    hyps, refs_text, hyp_scores, ref_scores = [], [], [], []
    clips = 0
    for i, batch in enumerate(dev_set.batches(min(8, max_utts), shuffle=False, drop_last=False)):
        ids = torch.from_numpy(batch["input_ids"]).to(device, torch.long)
        x0 = None if noise is None else noise(i, (ids.shape[0], ids.shape[1], model.config.dim_in))
        generator = torch.Generator(device=device).manual_seed(0)
        mels, mask = model.sample(ids, float(fm.dt), fm.get("truncation_value"), generator=generator, x0=x0)
        wavs = vocoder(mels).float().cpu().numpy()
        lengths = vocoder.config.waveform_lengths(mask.sum(dim=1)).cpu().numpy()
        ref_wavs, ref_lengths = dev_set.wav_batch(batch["names"])
        hyp_list = [w[: int(n)] for w, n in zip(wavs, lengths)]
        hyp_scores += [mos.score(w) for w in hyp_list]
        ref_scores += [mos.score(w[: int(max(n, 0))]) for w, n in zip(ref_wavs, ref_lengths)]
        hyps += asr.transcribe(hyp_list)
        refs_text += batch["transcripts"]
        if clips < 5:
            for j in range(min(len(hyp_list), 5 - clips)):
                writer.audio(f"hyp/{batch['names'][j]}", hyp_list[j], step)
            clips += len(hyp_list)
        if len(hyps) >= max_utts:
            break
    if hyps:
        writer.scalar("dev/WER", wer(refs_text, hyps), step)
        writer.scalar("dev/CER", cer(refs_text, hyps), step)
    if hyp_scores:
        writer.scalar("dev/MOS", float(np.mean(hyp_scores)), step)
        writer.scalar("dev/MOS (REF)", float(np.mean(ref_scores)), step)


def train_flow_matching(config, device: DeviceLike = None) -> dict:
    """Train the CFM decoder from ``config.flow_matching`` / ``config.dataset``
    on ``device`` (the card unless ``"cpu"``); returns the final step and its
    metrics."""
    from ..models.speech_encoder import embedding as kmeans_embedding
    from ..train.cfm import CFMTrainerConfig, make_trainer

    device = resolve_device(device)
    distributed_init(device)
    fm = config.flow_matching
    model_config = CFMConfig(
        vocab_size=fm.vocab_size,
        dim_in=fm.dim_in,
        dim_cond_emb=fm.dim_cond_emb,
        hidden_size=fm.hidden_size,
        depth=fm.depth,
        heads=fm.heads,
        intermediate_size=fm.intermediate_size,
        ff_dropout=fm.ff_dropout,
        use_unet_skip_connection=fm.use_unet_skip_connection,
        conv_pos_embed_kernel_size=fm.conv_pos_embed_kernel_size,
        conv_pos_embed_groups=fm.conv_pos_embed_groups,
        attn_dropout=fm.attn_dropout,
        mean=fm.mean,
        std=fm.std,
        predict_duration=fm.predict_duration,
        remat=bool(fm.get("remat") or False),  # optional memory knob, not a reference key
    )
    trainer_config = CFMTrainerConfig(
        batch_size=int(fm.batch_size),
        frames_per_seg=fm.frames_per_seg,
        epoch=fm.epoch,
        warmup_steps=fm.warmup_steps,
        lr=fm.lr,
        lr_min=fm.lr_min,
        max_norm=fm.max_norm,
        summary_interval=fm.summary_interval,
        save_interval_epoch=fm.save_interval_epoch,
        seed=int(config.common.seed),
        accum_steps=int(fm.get("accum_steps") or 1),
    )
    train_set = UnitDataset(
        config.dataset.train_file,
        spectrogram_dir=config.dataset.spectrogram_dir,
        frames_per_seg=fm.frames_per_seg,
        ext_audio=config.dataset.ext_audio,
    )
    mesh, batch_size = dp_mesh_for_batch(trainer_config.batch_size)
    index, count = data_coordinates(mesh)
    steps_per_epoch = max(len(train_set) // batch_size, 1)
    total_steps = trainer_config.epoch * steps_per_epoch

    table = kmeans_embedding(fm.dense_model_name, fm.quantizer_model_name, fm.vocab_size, device=device)
    model, state, step_fn = make_trainer(model_config, trainer_config, total_steps, table, device=device,
                                         data_group=mesh.group(DATA_AXIS) if count > 1 else None)

    path = Path(fm.path)
    writer = MetricsWriter(path / "logs", enabled=process_index() == 0)
    timer = StepTimer()
    rngs = RngStream(trainer_config.seed)
    values: dict = {}
    with CheckpointManager(path / "ckpt") as ckpt:
        start_epoch = 1
        if ckpt.has_checkpoint():
            ckpt.restore(state)
            start_epoch = state.step // steps_per_epoch + 1
        step = state.step
        for epoch in range(start_epoch, trainer_config.epoch + 1):
            batches = train_set.batches(batch_size, seed=trainer_config.seed, epoch=epoch, process_index=index, process_count=count)
            for batch in prefetch(batches, transform=lambda b: to_device(b, CFM_KEYS, device)):
                with trace_span("cfm_train_step"):
                    state, metrics = step_fn(state, batch, rngs.seed_for(step))
                step += 1
                timer.tick()
                if step % trainer_config.summary_interval == 0:
                    values = _read_metrics(metrics)
                    writer.scalars(values, step, prefix="train/")
                    step_time = timer.synced_step_time(step)
                    if step_time:
                        writer.scalar("train/steps_per_sec", 1.0 / step_time, step)
                        flops = cfm_step_flops(model_config, *batch["spectrogram_labels"].shape[:2], model_config.remat)
                        writer.scalar("train/MFU", mfu(flops, step_time, device), step)
            if epoch % trainer_config.save_interval_epoch == 0:
                if process_index() == 0:
                    try:
                        validate_flow_matching(config, model, step, writer, device=device)
                    except FileNotFoundError:
                        pass
                _save(ckpt, step, state)
                if process_index() == 0:
                    _export_cfm(config, model_config, model)
                _barrier()
    writer.close()
    return {"step": step, "metrics": values}


def _export_cfm(config, model_config: CFMConfig, model) -> None:
    """HF-format export to ``<flow_matching.path>/hf``: the JAX export's keys
    and its ``config.json`` (the CFM config's fields)."""
    save_pretrained(Path(config.flow_matching.path) / "hf", model.state_dict(), dataclasses.asdict(model_config))


def _hifigan_config(hg) -> HifiGanConfig:
    d = HifiGanConfig()
    return HifiGanConfig(
        upsample_rates=tuple(hg.upsample_rates),
        upsample_kernel_sizes=tuple(hg.upsample_kernel_sizes),
        upsample_initial_channel=hg.get("upsample_initial_channel", d.upsample_initial_channel),
        resblock_kernel_sizes=tuple(hg.get("resblock_kernel_sizes", d.resblock_kernel_sizes)),
        resblock_dilation_sizes=tuple(tuple(x) for x in hg.get("resblock_dilation_sizes", d.resblock_dilation_sizes)),
        normalize_before=False,
    )


def hifigan_training_setup(config, batch_size: int):
    """(generator config, ``MelDataset`` of the training crops, trainer
    config) of ``config.hifigan`` / ``config.dataset`` at ``batch_size`` rows
    a process: what ``train_hifigan`` steps on."""
    from ..train.hifigan import HifiGanTrainerConfig

    hg = config.hifigan
    train_set = MelDataset(
        config.dataset.wav_dir,
        config.dataset.spectrogram_dir,
        _mel_file_list(config.dataset.train_file),
        hg.segment_size,
        hg.n_fft,
        hg.hop_size,
        True,
        config.dataset.ext_audio,
    )
    trainer_config = HifiGanTrainerConfig(
        batch_size=batch_size,
        segment_size=hg.segment_size,
        training_epochs=hg.training_epochs,
        learning_rate=hg.learning_rate,
        adam_b1=hg.adam_b1,
        adam_b2=hg.adam_b2,
        lr_decay=hg.lr_decay,
        seed=hg.seed,
        n_fft=hg.n_fft,
        hop_size=hg.hop_size,
        steps_per_epoch=max(len(train_set) // batch_size, 1),
        stdout_interval=hg.stdout_interval,
        summary_interval=hg.summary_interval,
        checkpoint_interval=hg.checkpoint_interval,
        validation_interval=hg.validation_interval,
    )
    return _hifigan_config(hg), train_set, trainer_config


def train_hifigan(config, device: DeviceLike = None) -> dict:
    """Train the HiFi-GAN generator and discriminators from ``config.hifigan``
    / ``config.dataset`` on ``device`` (the card unless ``"cpu"``); returns
    the final step and its metrics."""
    from ..train.hifigan import make_gan_trainer

    device = resolve_device(device)
    distributed_init(device)
    mesh, batch_size = dp_mesh_for_batch(int(config.hifigan.batch_size))
    index, count = data_coordinates(mesh)
    model_config, train_set, trainer_config = hifigan_training_setup(config, batch_size)
    steps_per_epoch = trainer_config.steps_per_epoch
    (gen, _, _), state, step_fn = make_gan_trainer(model_config, trainer_config, device=device,
                                                   data_group=mesh.group(DATA_AXIS) if count > 1 else None)

    path = Path(config.hifigan.path)
    rank0 = process_index() == 0
    writer = MetricsWriter(path / "logs", enabled=rank0)
    timer = StepTimer()
    values: dict = {}
    with CheckpointManager(path / "ckpt") as ckpt:
        if ckpt.has_checkpoint():
            ckpt.restore(state)
        step = state.step
        start_epoch = step // steps_per_epoch
        # batches are a function of (seed, epoch): skip the ones the checkpoint already took
        resume_skip = step - start_epoch * steps_per_epoch
        for epoch in range(start_epoch, trainer_config.training_epochs):
            batches = train_set.batches(batch_size, seed=trainer_config.seed, epoch=epoch, process_index=index, process_count=count)
            if epoch == start_epoch and resume_skip:
                batches = itertools.islice(batches, resume_skip, None)
            for batch in prefetch(batches, transform=lambda b: to_device(b, GAN_KEYS, device)):
                with trace_span("hifigan_train_step"):
                    state, metrics = step_fn(state, batch)
                step += 1
                timer.tick()
                if step % trainer_config.summary_interval == 0:
                    values = _read_metrics(metrics)
                    writer.scalars(values, step, prefix="training/")
                    # the update that produced this summary had schedule count step - 1
                    lr = trainer_config.learning_rate * trainer_config.lr_decay ** ((step - 1) // steps_per_epoch)
                    writer.scalar("training/lr", lr, step)
                    step_time = timer.synced_step_time(step)
                    if step_time:
                        writer.scalar("training/steps_per_sec", 1.0 / step_time, step)
                        flops = hifigan_step_flops(model_config, *batch["mel"].shape[:2])
                        writer.scalar("training/MFU", mfu(flops, step_time, device), step)
                if step % trainer_config.checkpoint_interval == 0:
                    _save(ckpt, step, state)
                    if rank0:
                        _export_hifigan(config, model_config, gen)
                    _barrier()
                if step % trainer_config.validation_interval == 0 and rank0:
                    _validate_hifigan(config, gen, trainer_config, step, writer)
        _save(ckpt, step, state, force=True)
        if rank0:
            _export_hifigan(config, model_config, gen)
        _barrier()
    writer.close()
    return {"step": step, "metrics": values}


def _export_hifigan(config, model_config: HifiGanConfig, gen: HifiGanGenerator) -> None:
    """The generator in HF format to ``hifigan.path``, as the JAX loop exports it."""
    save_pretrained(
        Path(config.hifigan.path),
        gen.state_dict(),
        {
            "model_type": "hifigan",
            "model_in_dim": model_config.model_in_dim,
            "upsample_initial_channel": model_config.upsample_initial_channel,
            "upsample_rates": list(model_config.upsample_rates),
            "upsample_kernel_sizes": list(model_config.upsample_kernel_sizes),
            "resblock_kernel_sizes": list(model_config.resblock_kernel_sizes),
            "resblock_dilation_sizes": [list(d) for d in model_config.resblock_dilation_sizes],
            "leaky_relu_slope": model_config.leaky_relu_slope,
            "normalize_before": model_config.normalize_before,
        },
    )


@torch.inference_mode()
def _validate_hifigan(config, gen: HifiGanGenerator, trainer_config, step: int, writer, max_utts: int = 32) -> None:
    """Dev mel-L1 over full-length utterances, bucketed by padded length
    (``MelDataset.padded_batches``), masked to real frames and averaged per
    frame over the sweep; audio and spectrograms of the first batch logged.
    Runs under ``inference_mode`` on the generator's device, so K2 serves the
    narrow stages on the card."""
    dev_set = MelDataset(
        config.dataset.wav_dir,
        config.dataset.spectrogram_dir,
        _mel_file_list(config.dataset.dev_file),
        trainer_config.segment_size,
        trainer_config.n_fft,
        trainer_config.hop_size,
        False,  # full-length utterances
        config.dataset.ext_audio,
    )
    if len(dev_set) == 0:
        return
    device = gen.conv_pre.weight.device
    abs_tot, frame_tot, logged = 0.0, 0, False
    for batch in dev_set.padded_batches(8, max_utts=max_utts, with_wav=False):
        mel = torch.from_numpy(batch["mel"]).to(device)
        mask = torch.from_numpy(batch["mel_mask"]).to(device)
        y_hat = gen(mel)
        y_hat_mel = log_mel_spectrogram(
            y_hat, n_fft=trainer_config.n_fft, num_mels=trainer_config.num_mels, hop_size=trainer_config.hop_size
        )
        diff = torch.abs(y_hat_mel - mel)
        abs_tot += float((diff * mask[..., None]).sum())
        frame_tot += int(mask.sum()) * diff.shape[-1]
        if not logged:
            for j in range(min(3, y_hat.shape[0])):
                true_frames = int(batch["mel_mask"][j].sum())
                true_len = (true_frames - 1) * trainer_config.hop_size + trainer_config.n_fft
                writer.audio(f"generated/y_hat_{j}", y_hat[j, :true_len].float().cpu().numpy(), step)
                writer.spectrogram_figure(f"generated/y_hat_spec_{j}", y_hat_mel[j, :true_frames].float().cpu().numpy().T, step)
            logged = True
    if frame_tot:  # a sweep of no batch logs nothing rather than a perfect 0.0
        writer.scalar("validation/mel_spec_error", abs_tot / frame_tot, step)


SAMPLE_RATE = 16000


def _lm_config(config):
    """(LlamaConfig, special-token count) from ``config.model``: the vocab
    grown by the distinct pad, bos and eos ids, as the JAX loops build it."""
    m = config.model
    special = {m.get(k) for k in ("pad_token_id", "bos_token_id", "eos_token_id")}
    num_special = len(special - {None})
    model_config = LlamaConfig(
        vocab_size=m.vocab_size + num_special,
        hidden_size=m.hidden_size,
        intermediate_size=m.intermediate_size,
        num_hidden_layers=m.num_hidden_layers,
        num_attention_heads=m.num_attention_heads,
        pad_token_id=m.get("pad_token_id") or 0,
        bos_token_id=m.get("bos_token_id"),
        eos_token_id=m.get("eos_token_id"),
    )
    return model_config, num_special


def train_speechlm(config, device: DeviceLike = None) -> dict:
    """Train the speech LM from ``config.model`` / ``config.optim`` /
    ``config.dataset`` on ``device`` (the card unless ``"cpu"``), one process
    per device under torchrun; returns the final step and its metrics."""
    from ..train.speechlm import SpeechLMTrainerConfig, make_speechlm_trainer

    device = resolve_device(device)
    distributed_init(device)
    mesh = make_mesh()
    model_config, num_special = _lm_config(config)
    optim = config.optim
    trainer_config = SpeechLMTrainerConfig(
        batch_size_per_device=config.dataloader.batch_size_per_device,
        units_per_sample=config.dataset.units_per_sample,
        epoch=optim.epoch,
        warmup_steps=optim.warmup_steps,
        lr=optim.lr,
        lr_min=optim.lr_min,
        beta1=optim.beta1,
        beta2=optim.beta2,
        max_norm=optim.max_norm,
        summary_interval=optim.summary_interval,
        remat=bool(optim.get("remat") or False),  # optional memory knob, not a reference key
        accum_steps=int(optim.get("accum_steps") or 1),
    )
    train_set = UnitTextDataset(
        config.dataset.train_file,
        units_per_sample=trainer_config.units_per_sample,
        num_special_tokens=num_special,
        eos_token_id=config.model.eos_token_id,
    )
    index, count = data_coordinates(mesh)
    global_batch = trainer_config.batch_size_per_device * mesh.size
    steps_per_epoch = max(len(train_set) // global_batch, 1)
    total_steps = trainer_config.epoch * steps_per_epoch
    model, state, step_fn = make_speechlm_trainer(model_config, trainer_config, mesh, total_steps, device=device)
    flops = step_flops(model_config, trainer_config.batch_size_per_device, trainer_config.units_per_sample, trainer_config.remat)

    path = Path(config.model.path)
    rank0 = process_index() == 0
    writer = MetricsWriter(path / "logs", enabled=rank0)
    timer = StepTimer()
    values: dict = {}
    with CheckpointManager(path / "ckpt") as ckpt:
        start_epoch = 1
        if ckpt.has_checkpoint():
            ckpt.restore(state)
            start_epoch = state.step // steps_per_epoch + 1
        step = state.step
        for epoch in range(start_epoch, trainer_config.epoch + 1):
            batches = train_set.batches(
                global_batch, seed=trainer_config.seed, epoch=epoch, process_index=index, process_count=count
            )
            for batch in prefetch(batches, transform=lambda b: to_device(b, LM_KEYS, device)):
                with trace_span("speechlm_train_step"):
                    state, metrics = step_fn(state, batch)
                step += 1
                timer.tick()
                if step % trainer_config.summary_interval == 0:
                    values = _read_metrics(metrics)
                    writer.scalars(values, step, prefix="train/")
                    writer.memory(step, device)
                    step_time = timer.synced_step_time(step)
                    if step_time:
                        writer.scalar("train/tokens_per_sec", global_batch * trainer_config.units_per_sample / step_time, step)
                        writer.scalar("train/MFU", mfu(flops, step_time, device), step)
            payload = _save(ckpt, step, state)
            if rank0:
                params = payload["modules"]["model"]
                _export_speechlm(config, model_config, params)
                _validate_speechlm(config, model_config, params, step, writer, num_special, device)
            _barrier()
    writer.close()
    return {"step": step, "metrics": values}


def _export_speechlm(config, model_config: LlamaConfig, params: dict) -> None:
    """An HF ``LlamaForCausalLM`` directory at ``<model.path>/hf``: the JAX
    export's ``config.json`` keys, the weights as ``model.safetensors``.
    ``params`` is the host copy of the LM's state dict (its keys are HF's)."""
    save_pretrained(
        Path(config.model.path) / "hf",
        params,
        {
            "model_type": "llama",
            "architectures": ["LlamaForCausalLM"],
            "vocab_size": model_config.vocab_size,
            "hidden_size": model_config.hidden_size,
            "intermediate_size": model_config.intermediate_size,
            "num_hidden_layers": model_config.num_hidden_layers,
            "num_attention_heads": model_config.num_attention_heads,
            "num_key_value_heads": model_config.num_attention_heads,
            "rms_norm_eps": model_config.rms_norm_eps,
            "rope_theta": model_config.rope_theta,
            "tie_word_embeddings": False,
            "pad_token_id": model_config.pad_token_id,
            "bos_token_id": model_config.bos_token_id,
            "eos_token_id": model_config.eos_token_id,
            "torch_dtype": "float32",
        },
    )


def _scoring_lm(model_config: LlamaConfig, params: dict, device: torch.device) -> LlamaLM:
    """The LM for scoring and generation: the trainer's precision (f32
    parameters, bf16 compute) with ``"auto"`` attention, so the forward
    takes K1 on the card (inference, where the kernel keeps its win). Built
    on the meta device: the checkpoint's tensors are its parameters."""
    with torch.device("meta"):
        model = LlamaLM(model_config, attn_implementation="auto")
    model.load_state_dict(params, assign=True)
    return model.to(device).eval().requires_grad_(False)


def _validate_speechlm(config, model_config, params, step, writer, num_special, device) -> None:
    """The dev sLM21 score files (lexical and syntactic ``dev.txt``) and,
    when ``zrc`` runs, its four numbers as ``dev/*`` scalars."""
    result_dir = Path(config.dataset.result_dir)
    batch_size = config.dataloader.batch_size_per_device
    lm = _scoring_lm(model_config, params, device)
    try:
        write_scores(lm, config.dataset.swuggy_dev_file, result_dir / "lexical/dev.txt", batch_size, num_special)
        write_scores(lm, config.dataset.sblimp_dev_file, result_dir / "syntactic/dev.txt", batch_size, num_special)
    except FileNotFoundError:
        return
    if run_zrc(result_dir, "dev"):
        for name, value in aggregate_slm21_scores(result_dir, "dev").items():
            writer.scalar(f"dev/{name}", value, step)


def _restore_lm(config, device: torch.device):
    """(LM, special-token count) from the trainer's checkpoint under
    ``<model.path>/ckpt`` (the latest step), for scoring and generation."""
    model_config, num_special = _lm_config(config)
    with CheckpointManager(Path(config.model.path) / "ckpt") as ckpt:
        state = ckpt.read()
    return _scoring_lm(model_config, state["modules"]["model"], device), num_special


def eval_speechlm(config, device: DeviceLike = None):
    """The sLM21 test evaluation (``pipeline.speechlm.evaluate``) of the
    checkpoint's LM, with ``"auto"`` attention: K1 on the card."""
    lm, _ = _restore_lm(config, resolve_device(device))
    return evaluate(config, lm)


def generate_speechlm(
    config,
    prompt_wav: str,
    out_wav: Optional[str] = None,
    decoder_dir: Optional[str] = None,
    max_new_tokens: int = 128,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int = 0,
    device: DeviceLike = None,
) -> dict:
    """Textless continuation: prompt wav -> units -> LM sampling -> units,
    and -> waveform when a resynthesis decoder directory is given.

    The LM is the trainer's checkpoint under ``<model.path>/ckpt``, restored
    as ``eval_speechlm`` restores it (``pipeline.speechlm.load_lm_from_hf``
    reads an HF directory instead); the tokenizer comes from
    ``config.s2u.tokenizer_path``, the encoder from ``config.s2u``
    (deduplicating), and the special-token count from the pad, bos and eos
    ids of ``config.model``. Returns the ``continue_speech`` result and
    writes ``out_wav`` (16 kHz) when asked. Everything runs on ``device``,
    the card unless ``"cpu"``; the sampling generator is seeded with
    ``seed`` there.
    """
    device = resolve_device(device)
    tokenizer = BpeTokenizer.from_file(config.s2u.tokenizer_path)
    model, num_special = _restore_lm(config, device)
    eos = config.model.get("eos_token_id")

    encoder = _make_encoder(config, device=device)
    wav, _ = audio_io.read(prompt_wav)
    units = encoder(wav.astype(np.float32))["units"].cpu().numpy()  # a 1-D input gives 1-D units

    kwargs = dict(
        max_new_tokens=max_new_tokens,
        eos_token_id=eos if eos is not None else 1,
        num_special_tokens=num_special,
        temperature=temperature,
        top_k=top_k,
        top_p=top_p,
        generator=torch.Generator(device=device).manual_seed(seed),
    )
    if decoder_dir is None:
        generated = generate_unit_continuation(units, tokenizer, model, **kwargs)
        return {"units": np.concatenate([units, generated]), "generated_units": generated, "waveform": None}

    decoder = ConditionalFlowMatchingWithHifiGan.from_pretrained(decoder_dir, device=device)
    result = continue_speech(units, tokenizer, model, decoder, **kwargs)
    if out_wav:
        audio_io.write(out_wav, result["waveform"], SAMPLE_RATE)
    return result
