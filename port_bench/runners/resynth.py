"""The wav -> units -> wav cell: ``pipeline.synthesize.synthesize(config,
encoder, decoder)`` over a seeded tree of WAV files, in whole passes, until
the window's time is up.

Set-up writes the tree (speech-like waves at the mix's lengths, PCM16, under
the run's temporary directory), draws the encoder's (mHuBERT and its k-means
centres) and the decoder's weights on the card from the seed, builds the
program's ``SpeechEncoder`` and ``ConditionalFlowMatchingWithHifiGan`` from
them (BF16_INFERENCE) and runs one whole pass, which warms every shape. The
window's rate is the audio the passes wrote over their wall time.

Wrappers record from outside: the encoder's input shape and valid samples,
``decoder.synthesize``'s batches as the serving cells do, the host time of
``audio_io.read_batch`` and ``audio_io.write``, and, in the window's first
pass, the features, units, unit ids, noise-generator state and mel of the
batches the check keeps. The check runs the plain reference in f32 on the kept batches: the
encoder from the files' samples (the features compared row by row; the
quantizer's units against the exact assignment of the features it was
given), then the decoder on the units the program produced, from the same
noise (the program's units are its input: the decoder stage is checked step
by step from them), against that pass's mel and the files the window's last
pass wrote.
"""

from __future__ import annotations

import os
import tempfile
import time
import wave
from pathlib import Path

import numpy as np
import torch

from port_bench.runners.serve import compare_batch, reference_weights, samples_to_frames, summarize
from port_bench.harness import Check, sub_seed, tf32_off
from port_bench.program import cfm_config, decoder_weights, vocoder_config
from port_bench.reference import hubert as ref_hubert
from port_bench.reference import resynth as ref
from port_bench.yardstick import traffic as T
from port_bench.yardstick import weights as W

SAMPLE_RATE = 16000


class State:
    pass


def encoder_weights(torch, config: dict, seed: int, device: str, dtype) -> tuple:
    """mHuBERT's weights and the k-means centres (N(0, 1), f32) from the seed, drawn on the card."""
    enc = config["encoder"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 8))
    w = W.draw(torch, ref_hubert.hubert_spec(enc["hubert"]), gen, dtype)
    centers = torch.randn((enc["vocab_size"], enc["hubert"]["hidden_size"]), generator=gen, device=device)
    return w, centers


def speechlike(rng: np.random.Generator, samples: int) -> np.ndarray:
    """A gliding voiced tone with harmonics under a syllable-rate envelope,
    plus noise (a frozen copy of ``chip_smoke.py:speechlike_waves``)."""
    t = np.arange(samples) / SAMPLE_RATE
    f0 = rng.uniform(90, 220) * (1 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
    voiced = np.sin(phase) + 0.4 * np.sin(2 * phase) + 0.2 * np.sin(3 * phase)
    return (0.3 * env * voiced + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


def file_lengths(traffic: dict, seed: int) -> np.ndarray:
    """Samples of each file, in the tree's sorted order: the mix's block of
    lengths permuted by the seed."""
    seconds = T.block_lengths_s(traffic["length_s"], traffic["files"])
    return np.rint(seconds[np.random.default_rng(sub_seed(seed, 9)).permutation(len(seconds))] * SAMPLE_RATE).astype(np.int64)


def write_tree(root: Path, traffic: dict, seed: int) -> list:
    """The input tree ``<root>/<split>/s<k>/u<i>.wav``: (relative name, samples) a file."""
    from speech_resynth_torch.dsp import audio_io

    rng = np.random.default_rng(sub_seed(seed, 10))
    files = []
    for i, n in enumerate(file_lengths(traffic, seed)):
        name = f"{traffic['split_dir']}/s{i // 16:02d}/u{i:04d}"
        audio_io.write(root / (name + ".wav"), speechlike(rng, int(n)), SAMPLE_RATE)
        files.append((name, int(n)))
    return files


def kept_batches(files: list, batch: int, traffic: dict, seed: int) -> list:
    """The batches the check recomputes: the one holding the longest file and
    ``checked_batches`` - 1 others drawn from the seed."""
    longest = int(np.argmax([n for _, n in files])) // batch
    others = [int(b) for b in np.random.default_rng(sub_seed(seed, 7)).permutation(-(-len(files) // batch)) if b != longest]
    return sorted([longest] + others[: traffic["checked_batches"] - 1])


def read_pcm16(path: Path) -> np.ndarray:
    """A PCM16 mono WAV as its integer codes (the reference's own reader)."""
    with wave.open(str(path), "rb") as f:
        return np.frombuffer(f.readframes(f.getnframes()), dtype="<i2")


class EncoderProbe:
    """The program's encoder, called as ``synthesize`` calls it, recording
    each call's shape and valid samples, and the kept batches' units."""

    def __init__(self, encoder, run, st):
        self.encoder, self.run, self.st = encoder, run, st

    def __call__(self, wav, lengths=None):
        st = self.st
        k = st.encoder_calls
        st.encoder_calls += 1
        with self.run.span("encode"):
            out = self.encoder(wav, lengths=lengths)
        frames = sum(max(int(ref_hubert.num_frames(self.run.config["encoder"]["hubert"], int(n))), 0) for n in lengths)
        st.encoder_shapes.append((wav.shape[0], wav.shape[1], int(np.sum(lengths)), frames))
        if st.recording and k in st.keep:
            st.kept[k] = {"units": out["units"], "counts": out["num_units"], "lengths": np.array(lengths)}
        return out


class QuantizerProbe:
    """The program's k-means quantizer, as ``SpeechEncoder`` calls it,
    keeping the features of the batches the check keeps."""

    def __init__(self, quantizer, st):
        self.quantizer, self.st = quantizer, st
        self.centers, self.vocab_size = quantizer.centers, quantizer.vocab_size

    def __call__(self, features):
        st = self.st
        if st.recording and st.encoder_calls - 1 in st.keep:
            st.features[st.encoder_calls - 1] = features
        return self.quantizer(features)


def synthesis_config(run, st):
    from speech_resynth_torch.core.config import config_from_dict

    fm = run.config["flow_matching"]
    return config_from_dict({
        "common": {"seed": st.noise_seed},
        "synthesis": {"src_dir": str(st.src), "tgt_dir": str(st.tgt), "split": run.traffic["split"], "ext_audio": ".wav"},
        "flow_matching": {"dt": fm["dt"], "truncation_value": fm["truncation_value"], "predict_duration": fm["predict_duration"]},
        "flow_matching_with_hifigan": {"batch_size": run.config["flow_matching_with_hifigan"]["batch_size"]},
    })


def setup(run):
    from speech_resynth_torch.core.precision import BF16_INFERENCE
    from speech_resynth_torch.models.cfm import ConditionalFlowMatchingModel
    from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan
    from speech_resynth_torch.models.hifigan import HifiGanGenerator
    from speech_resynth_torch.models.hubert import HubertConfig, HubertEncoder
    from speech_resynth_torch.models.kmeans import KMeansQuantizer
    from speech_resynth_torch.models.speech_encoder import SpeechEncoder

    cfg, tr, dev = run.config, run.traffic, run.device
    fm, hg, enc = cfg["flow_matching"], cfg["hifigan"], cfg["encoder"]
    st = State()
    st.tmp = tempfile.TemporaryDirectory(prefix="port_bench_", dir=os.environ.get("TMPDIR"))
    st.src, st.tgt = Path(st.tmp.name) / "src", Path(st.tmp.name) / "tgt"
    st.files = write_tree(st.src, tr, run.seed)
    run.lap(f"the input tree of {len(st.files)} files written")
    st.batch = cfg["flow_matching_with_hifigan"]["batch_size"]
    st.noise_seed = sub_seed(run.seed, 2)
    st.dt, st.trunc = fm["dt"], fm["truncation_value"]
    st.keep = kept_batches(st.files, st.batch, tr, run.seed)

    cfm_w, voc_w = decoder_weights(torch, cfg, run.seed, dev, torch.bfloat16)
    hub_w, centers = encoder_weights(torch, cfg, run.seed, dev, torch.bfloat16)
    h = enc["hubert"]
    hcfg = HubertConfig(hidden_size=h["hidden_size"], num_hidden_layers=h["num_hidden_layers"],
                        num_attention_heads=h["num_attention_heads"], intermediate_size=h["intermediate_size"],
                        conv_dim=tuple(h["conv_dim"]), conv_kernel=tuple(h["conv_kernel"]), conv_stride=tuple(h["conv_stride"]),
                        num_conv_pos_embeddings=h["num_conv_pos_embeddings"],
                        num_conv_pos_embedding_groups=h["num_conv_pos_embedding_groups"], layer_norm_eps=h["layer_norm_eps"])
    with torch.device(dev):
        model = ConditionalFlowMatchingModel(cfm_config(fm), BF16_INFERENCE)
        vocoder = HifiGanGenerator(vocoder_config(hg), BF16_INFERENCE)
        hubert = HubertEncoder(hcfg, BF16_INFERENCE)
    model.load_state_dict(cfm_w)
    vocoder.load_state_dict(voc_w)
    hubert.load_state_dict(hub_w)
    del cfm_w, voc_w, hub_w
    st.decoder = ConditionalFlowMatchingWithHifiGan(model, vocoder, device=dev)
    st.features = {}
    encoder = SpeechEncoder(encoder=hubert.eval().requires_grad_(False), quantizer=QuantizerProbe(KMeansQuantizer(centers), st),
                            output_layer=enc["output_layer"], deduplicate=fm["predict_duration"],
                            dense_model_name=enc["dense_model_name"], quantizer_model_name=enc["quantizer_model_name"])
    st.encoder = EncoderProbe(encoder, run, st)
    run.synchronize()
    run.lap("weights, encoder and decoder built")
    st.encoder_calls, st.encoder_shapes, st.recording, st.warming, st.kept = 0, [], False, True, {}
    st.decoder_calls, st.batches, st.rows = 0, [], []
    probes(run, st)
    one_pass(run, st)  # the warm-up pass: every shape
    st.warming = False
    run.synchronize()
    run.lap("the warm-up pass")
    st.encoder_calls, st.encoder_shapes, st.batches, st.rows = 0, [], [], []
    st.io_ms, st.written = [], 0
    return st


def probes(run, st) -> None:
    """Wrap the decoder's entry points on the instance, as the serving cells do."""
    decoder = st.decoder
    synthesize, sample = decoder.synthesize, decoder.model.sample

    def synthesize_probe(ids, **kw):
        k = st.decoder_calls
        st.decoder_calls += 1
        if st.recording and k in st.keep:
            st.kept[k].update(ids=ids.detach().clone(), noise=kw["generator"].get_state())
        st.batches.append([int(ids.shape[1]), None, None])
        with run.span("dispatch"):
            t0 = time.perf_counter()
            out = synthesize(ids, **kw)
            st.batches[-1][2] = (time.perf_counter() - t0) * 1e3
        return out

    def sample_probe(*args, **kw):
        out = sample(*args, **kw)
        st.batches[-1][1] = out[0].shape[1]
        if st.recording and st.decoder_calls - 1 in st.keep:
            st.kept[st.decoder_calls - 1]["mel"] = out[0]
        st.rows.append(out[1].sum(dim=1))
        return out

    decoder.synthesize, decoder.model.sample = synthesize_probe, sample_probe


def one_pass(run, st) -> None:
    from speech_resynth_torch.dsp import audio_io
    from speech_resynth_torch.pipeline.synthesize import synthesize

    read_batch, write = audio_io.read_batch, audio_io.write

    def read_probe(paths, max_frames, n_threads=0):
        with run.span("read"):
            t0 = time.perf_counter()
            out = read_batch(paths, max_frames, n_threads)
            if not st.warming:
                st.io_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def write_probe(path, samples, sample_rate):
        with run.span("write"):
            t0 = time.perf_counter()
            write(path, samples, sample_rate)
            if not st.warming:
                st.io_ms.append((time.perf_counter() - t0) * 1e3)
                st.written += len(samples)
        return None

    st.encoder_calls = st.decoder_calls = 0
    audio_io.read_batch, audio_io.write = read_probe, write_probe
    try:
        synthesize(synthesis_config(run, st), st.encoder, st.decoder)
    finally:
        audio_io.read_batch, audio_io.write = read_batch, write


def window(run, st) -> dict:
    passes = 0
    t0 = time.perf_counter()
    while True:
        st.recording = passes == 0
        one_pass(run, st)
        st.recording = False
        passes += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    wall = time.perf_counter() - t0
    rows = [[int(n) for n in r.tolist()] for r in st.rows]
    run.records.update(batches=st.batches, batch_rows=rows, encoder_shapes=st.encoder_shapes, passes=passes, wall_s=wall,
                       file_samples=[n for _, n in st.files],
                       io_ms=sum(st.io_ms) / max(len(st.batches), 1))
    disk = st.written * 2 * 1 + sum(n for _, n in st.files) * 2
    run.note(f"passes {passes} of {len(st.files)} files in {wall!r} s; audio written {st.written / SAMPLE_RATE!r} s; "
             f"bytes written by the run about {disk} (input tree and outputs); batches {sorted(st.kept)} of the first pass "
             "kept for the check")
    return {"metrics": {"audio_s_per_s.resynth": st.written / SAMPLE_RATE / wall}, "attempted": passes * len(st.files), "failed": 0}


def release(run, st) -> None:
    encoder = st.encoder.encoder
    del st.decoder, st.encoder, encoder
    if run.device != "cpu":
        torch.cuda.empty_cache()


def reference_tree_batch(hub_w, centers, enc, src: Path, chunk: list, max_seconds: int, device, p=ref.F32):
    """The reference encoder on one batch of the tree as the dataset pads it:
    (features (B, frames, D), units (B, frames), valid frame mask)."""
    wav = np.zeros((len(chunk), max_seconds * SAMPLE_RATE), np.float32)
    lengths = []
    for j, name in enumerate(chunk):
        codes = read_pcm16(src / (name + ".wav"))
        wav[j, : len(codes)] = codes / 32768.0
        lengths.append(len(codes))
    lengths = torch.as_tensor(lengths, device=device)
    feats = torch.cat([ref_hubert.features(hub_w, enc["hubert"], torch.as_tensor(wav[i : i + 4], device=device), lengths[i : i + 4],
                                           enc["output_layer"], p)[0] for i in range(0, len(chunk), 4)])
    valid = torch.arange(feats.shape[1], device=device)[None, :] < ref_hubert.num_frames(enc["hubert"], lengths)[:, None]
    return feats, ref_hubert.assign(feats, centers, p), valid


def encoder_rows(feats_got, units_got, feats_want, units_want, valid, centers) -> tuple:
    """Per row the features' relative L2 error over its valid frames; the
    frames whose units equal the exact f32 assignment of the features they
    came from (the quantizer's own job), and those equal to the reference's
    units; and the valid frames."""
    errs = [float((feats_got[j][valid[j]].float() - feats_want[j][valid[j]]).norm() / feats_want[j][valid[j]].norm())
            for j in range(valid.shape[0]) if valid[j].any()]
    exact = ref_hubert.assign(feats_got.float(), centers)
    return errs, int(((exact == units_got.long()) & valid).sum()), int(((units_want == units_got.long()) & valid).sum()), int(valid.sum())


def encoder_checks(errs, assigned, agree, total, limits) -> list:
    return [Check("feature_rel_err", max(errs, default=float("inf")), limits["feature_rel_err"]),
            Check("assign_agreement", assigned / max(total, 1), limits["assign_agreement"], "min")]


def decoder_input(units, valid):
    """The decoder's unit ids as synthesize makes them: units + 1 on valid frames, 0 (pad) past them."""
    return torch.where(valid, units + 1, torch.zeros_like(units))


def reference_decode(w, fm, hg, ids, noise_state, dt, trunc, device, p=ref.F32):
    """The reference decoder on unit ids, from the generator state the
    program's stood at: (normalized mel, frame mask, frames, the written
    PCM16 codes)."""
    gen = torch.Generator(device=device)
    gen.set_state(noise_state)
    cond, mask, frames = ref.conditions(w, fm, ids.long(), p)
    x0 = torch.randn((cond.shape[0], cond.shape[1], fm["dim_in"]), generator=gen, device=device)
    x1 = ref.ode(w, fm, cond, mask, x0, dt, trunc, p)
    return x1, mask, frames, wav_codes(w, hg, fm, x1, mask, p)


def reference_weights_all(run):
    cfm_w, voc_w = reference_weights(torch, run.config, run.seed, run.device)
    hub_w, centers = encoder_weights(torch, run.config, run.seed, run.device, torch.bfloat16)
    return {**cfm_w, **voc_w}, {k: v.float() for k, v in hub_w.items()}, centers


def check(run, st) -> list:
    fm, hg, enc, tr = run.config["flow_matching"], run.config["hifigan"], run.config["encoder"], run.traffic
    dev = run.device
    w, hub_w, centers = reference_weights_all(run)
    names = [name for name, _ in st.files]
    errs, assigned, agree, total = [], 0, 0, 0
    rows = []
    with tf32_off(torch), torch.no_grad():
        for k in sorted(st.kept):
            kept = st.kept[k]
            chunk = names[k * st.batch : (k + 1) * st.batch]
            feats, units, valid = reference_tree_batch(hub_w, centers, enc, st.src, chunk, tr["max_seconds"], dev)
            e, a, g, n = encoder_rows(st.features[k], kept["units"], feats, units, valid, centers)
            errs, assigned, agree, total = errs + e, assigned + a, agree + g, total + n
            x1, mask, frames, want = reference_decode(w, fm, hg, kept["ids"], kept["noise"], st.dt, st.trunc, dev)
            waves = {j: read_pcm16(st.tgt / (name + ".wav")) for j, name in enumerate(chunk)}
            frames_prog = {j: samples_to_frames(hg, len(v)) for j, v in waves.items()}
            rows += list(compare_batch(fm, hg, x1, frames.cpu(), want, kept["mel"], frames_prog, waves).values())
    st.tmp.cleanup()
    run.note(f"checked {len(rows)} files of batches {sorted(st.kept)}; units equal the reference's on {agree} of {total} frames, "
             f"the exact assignment of their own features on {assigned}")
    return encoder_checks(errs, assigned, agree, total, tr["limits"]) + summarize(rows, tr["limits"], tr["min_checked_rows"])


def control(run, fmt: str = "fp8") -> list:
    """The control: the reference encoder and decoder computed in ``fmt`` put
    in the program's place on the batches a run keeps (the same tree, weights
    and noise), held by the run's own comparison: its units against the f32
    reference's, and its mel and codes against the f32 reference decoding
    its units."""
    fm, hg, enc, tr = run.config["flow_matching"], run.config["hifigan"], run.config["encoder"], run.traffic
    dev, batch = run.device, run.config["flow_matching_with_hifigan"]["batch_size"]
    w, hub_w, centers = reference_weights_all(run)
    low = ref.Precision(fmt)
    errs, assigned, agree, total = [], 0, 0, 0
    rows = []
    with tempfile.TemporaryDirectory(prefix="port_bench_", dir=os.environ.get("TMPDIR")) as tmp, tf32_off(torch), torch.no_grad():
        files = write_tree(Path(tmp), tr, run.seed)
        names = [name for name, _ in files]
        keep = kept_batches(files, batch, tr, run.seed)
        gen = torch.Generator(device=dev).manual_seed(sub_seed(run.seed, 2))
        for k in range(max(keep) + 1):
            chunk = names[k * batch : (k + 1) * batch]
            state = gen.get_state()
            frames_total = ref_hubert.num_frames(enc["hubert"], tr["max_seconds"] * SAMPLE_RATE)
            torch.randn((len(chunk), frames_total, fm["dim_in"]), generator=gen, device=dev)  # this batch's draw
            if k not in keep:
                continue
            want_feats, want_units, valid = reference_tree_batch(hub_w, centers, enc, Path(tmp), chunk, tr["max_seconds"], dev)
            got_feats, got_units, _ = reference_tree_batch(hub_w, centers, enc, Path(tmp), chunk, tr["max_seconds"], dev, low)
            e, a, g, n = encoder_rows(got_feats, got_units, want_feats, want_units, valid, centers)
            errs, assigned, agree, total = errs + e, assigned + a, agree + g, total + n
            ids = decoder_input(got_units, valid)
            x1, mask, frames, want = reference_decode(w, fm, hg, ids, state, fm["dt"], fm["truncation_value"], dev)
            x1_low, mask_low, frames_low, codes_low = reference_decode(w, fm, hg, ids, state, fm["dt"], fm["truncation_value"], dev, low)
            waves = {j: codes_low[j, : int(ref.waveform_lengths(hg, int(frames_low[j])))].cpu().numpy() for j in range(len(chunk))}
            frames_prog = {j: int(frames_low[j]) for j in range(len(chunk))}
            rows += list(compare_batch(fm, hg, x1, frames.cpu(), want, ref.log_mel(fm, x1_low, mask_low), frames_prog, waves).values())
    run.note(f"control: units equal the reference's on {agree} of {total} frames")
    return encoder_checks(errs, assigned, agree, total, tr["limits"]) + summarize(rows, tr["limits"], tr["min_checked_rows"])


def wav_codes(w, hg, fm, x1, mask, p=ref.F32, rows: int = 8):
    """The reference's waveform as the WAV writer stores it: clamped, times
    32767, truncated toward zero."""
    mel = ref.log_mel(fm, x1, mask)
    out = []
    for i in range(0, mel.shape[0], rows):
        wave_ = ref.vocoder(w, hg, mel[i : i + rows], p).clamp(-1.0, 1.0)
        out.append(torch.trunc(wave_ * 32767.0))
    return torch.cat(out)
