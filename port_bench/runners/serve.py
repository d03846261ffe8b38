"""Serving cells: ``SynthesisServer.synthesize_stream`` over a backlog.

The request stream (``yardstick.traffic.request_stream``) yields requests as
fast as the server pulls them (a backlog) until the window's time is up and
its block of fixed batches is whole; then it stops and the server drains
what it holds. A request's latency runs from the moment the server pulled
it to the moment its waveform was yielded, so it does not grow with the
backlog: it is bounded by the server's own batch and in-flight depth.

The program is ``ConditionalFlowMatchingWithHifiGan`` at the configuration's
widths under BF16_INFERENCE, its weights drawn on the card from the seed
(conv_post scaled by the configuration's ``wire_gain``, so PCM16 codes are
not all zero at random weights). Wrappers record each batch from outside:
its unit ids and noise-generator state (for the batches the check keeps),
its frame count, the host time of ``decoder.synthesize`` (the enqueue; in a
duration-predicting model it includes the host sync of its frame bound) and
the log-mel the ODE produced (kept batches only).

The check recomputes the kept batches (the one holding the stream's first
longest request and others drawn from the seed) with the plain reference in
f32, from the same weights, unit ids and noise, and compares every real
request of them: the normalized mel over its frames, the delivered PCM16
codes, its frame count.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from port_bench.harness import Check, sub_seed, tf32_off
from port_bench.reference import resynth as ref
from port_bench.program import cfm_config, decoder_weights, vocoder_config
from port_bench.yardstick import flops, traffic as T

SAMPLE_RATE = 16000


def bucket(n: int, multiple: int) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def collate(batch, size: int, multiple: int) -> np.ndarray:
    """A batch of unit arrays as the server pads it: rows past the requests are
    one-unit fillers, the length is the longest rounded up to ``multiple``."""
    rows = list(batch) + [np.ones(1, np.int64)] * (size - len(batch))
    ids = np.zeros((size, bucket(max(len(r) for r in rows), multiple)), np.int64)
    for j, r in enumerate(rows):
        ids[j, : len(r)] = r
    return ids


def kept_batches(traffic: dict, vocab: int, seed: int, batch: int) -> list:
    """The batches the check recomputes: the one holding the stream's first
    longest request, and ``checked_batches`` - 1 others drawn from the seed
    among the first ``checked_from`` batches."""
    longest = T.first_longest(traffic, vocab, seed) // batch
    rng = np.random.default_rng(sub_seed(seed, 7))
    others = [int(b) for b in rng.permutation(traffic["checked_from"]) if b != longest]
    return sorted([longest] + others[: traffic["checked_batches"] - 1])


class State:
    pass


def setup(run):
    import torch

    from speech_resynth_torch.core.precision import BF16_INFERENCE
    from speech_resynth_torch.models.cfm import ConditionalFlowMatchingModel
    from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan
    from speech_resynth_torch.models.hifigan import HifiGanGenerator
    from speech_resynth_torch.pipeline.serving import SynthesisServer

    cfg, tr, dev = run.config, run.traffic, run.device
    fm, hg = cfg["flow_matching"], cfg["hifigan"]
    st = State()
    st.batch = cfg["flow_matching_with_hifigan"]["batch_size"]
    st.dt, st.trunc = fm["dt"], fm["truncation_value"]
    cfm_w, voc_w = decoder_weights(torch, cfg, run.seed, dev, torch.bfloat16)
    with torch.device(dev):
        model = ConditionalFlowMatchingModel(cfm_config(fm), BF16_INFERENCE)
        vocoder = HifiGanGenerator(vocoder_config(hg), BF16_INFERENCE)
    model.load_state_dict(cfm_w)
    vocoder.load_state_dict(voc_w)
    del cfm_w, voc_w
    st.decoder = ConditionalFlowMatchingWithHifiGan(model, vocoder, device=dev)
    st.server = SynthesisServer(st.decoder, batch_size=st.batch, dt=st.dt, truncation_value=st.trunc,
                                length_multiple=tr["length_multiple"], pcm16=True, seed=sub_seed(run.seed, 2),
                                max_inflight=tr["max_inflight"])
    st.keep = kept_batches(tr, fm["vocab_size"], run.seed, st.batch)
    run.synchronize()
    run.lap("weights and the decoder built")
    warm_up(run, st, torch)
    run.lap(f"{run.records['warm_shapes']} warm-up batches")
    return st


def frame_bounds(run, st, torch, batches: int) -> set:
    """The frame bounds a duration-predicting model reaches on the stream's
    first ``batches`` batches, from the reference's duration predictor on the
    same weights (the shapes set-up warms)."""
    fm = run.config["flow_matching"]
    cfm_w, _ = decoder_weights(torch, run.config, run.seed, run.device, torch.bfloat16)
    w = {k: v.float() for k, v in cfm_w.items() if k.startswith(("to_cond_emb", "duration_predictor"))}
    stream = T.request_stream(run.traffic, fm["vocab_size"], run.seed)
    found = set()
    with torch.no_grad():
        for _ in range(batches):
            ids = torch.from_numpy(collate([next(stream)[1] for _ in range(st.batch)], st.batch, run.traffic["length_multiple"]))
            ids = ids.to(run.device)
            d = ref.durations(w, ref.embed_units(w, ids), ids != 0)
            found.add(ref.frame_bound(d.sum(dim=1)))
    return found


def warm_up(run, st, torch) -> None:
    """One batch at every unit bucket the traffic reaches (its fixed batches'
    longest) and, with duration prediction, at every frame bound between the
    least and the largest the stream's first batches reach (and one more
    step of 64)."""
    fm, tr = run.config["flow_matching"], run.traffic
    buckets = sorted({bucket(int(g.max()), tr["length_multiple"]) for g in T.block_groups(tr)})
    gen = torch.Generator(device=run.device).manual_seed(sub_seed(run.seed, 3))
    rng = np.random.default_rng(sub_seed(run.seed, 4))
    calls = []
    for L in buckets:
        calls.append((rng.integers(1, fm["vocab_size"] + 1, (st.batch, L)), None))
    if fm["predict_duration"]:
        bounds = frame_bounds(run, st, torch, tr["warm_batches"])
        longest = rng.integers(1, fm["vocab_size"] + 1, (st.batch, buckets[-1]))
        calls += [(longest, f) for f in range(min(bounds), max(bounds) + 65, 64)]
    for ids, frames in calls:
        st.decoder.synthesize(ids, dt=st.dt, truncation_value=st.trunc, generator=gen, pcm16=True, max_frames=frames)
    run.synchronize()
    run.records["warm_shapes"] = len(calls)


def window(run, st) -> dict:
    tr, hg = run.traffic, run.config["hifigan"]
    decoder, model, server = st.decoder, st.decoder.model, st.server
    keep = set(st.keep)
    st.kept: Dict[int, dict] = {}
    batches = []  # per dispatched batch: [unit length, frames, host ms]
    pulled, done, units, lengths = {}, {}, {}, {}
    st.waves: Dict[int, np.ndarray] = {}
    samples = 0
    synthesize, sample, collate_ = decoder.synthesize, model.sample, server._collate

    def synthesize_probe(ids, **kw):
        k = len(batches)
        if k in keep:
            st.kept[k] = {"ids": np.array(ids), "noise": kw["generator"].get_state()}
        batches.append([ids.shape[1], None, None])
        with run.span("dispatch"):
            t0 = time.perf_counter()
            out = synthesize(ids, **kw)
            batches[k][2] = (time.perf_counter() - t0) * 1e3
        return out

    def sample_probe(*args, **kw):
        out = sample(*args, **kw)
        k = len(batches) - 1
        batches[k][1] = out[0].shape[1]
        if k in keep:
            st.kept[k]["mel"] = out[0]
        return out

    def collate_probe(batch):
        with run.span("collate"):
            return collate_(batch)

    decoder.synthesize, model.sample, server._collate = synthesize_probe, sample_probe, collate_probe

    from speech_resynth_torch.pipeline.serving import SynthesisRequest

    start = []

    def requests():
        for i, u in T.request_stream(tr, run.config["flow_matching"]["vocab_size"], run.seed):
            now = time.perf_counter()
            if not start:
                start.append(now)
            elif now - start[0] >= run.seconds and i % tr["block"] == 0:
                return  # the window ends with a whole block: every seed sends the same batches
            pulled[i], units[i] = now, len(u)
            yield SynthesisRequest(u, i)

    try:
        stream = server.synthesize_stream(requests())
        while True:
            with run.span("drain"):
                item = next(stream, None)
            if item is None:
                break
            rid, wav = item
            done[rid] = time.perf_counter()
            lengths[rid] = len(wav)
            samples += len(wav)
            if rid // st.batch in keep:
                st.waves[rid] = wav
        end = time.perf_counter()
    finally:
        decoder.synthesize, model.sample, server._collate = synthesize, sample, collate_

    latency_ms = np.array([(done[i] - pulled[i]) * 1e3 for i in done])
    wall = end - start[0]
    frames = {i: samples_to_frames(hg, n) for i, n in lengths.items()}
    rows = [[frames.get(k * st.batch + j, 1) for j in range(st.batch)] for k in range(len(batches))]  # a filler row: 1 unit
    run.records.update(batches=batches, batch_rows=rows, wall_s=wall, units={i: units[i] for i in done}, frames=frames)
    run.note(f"requests {len(done)} of {len(pulled)} pulled; latency median {float(np.median(latency_ms))!r} ms, "
             f"p95 {tail_ms(latency_ms)!r} ms over {len(latency_ms)}; batches {len(batches)}; "
             f"audio {samples / SAMPLE_RATE!r} s in {wall!r} s")
    return {
        "metrics": {"audio_s_per_s": samples / SAMPLE_RATE / wall, "request_p95_ms": tail_ms(latency_ms)},
        "attempted": len(pulled),
        "failed": len(pulled) - len(done),
    }


def tail_ms(latencies_ms, q: float = 95) -> float:
    """The q-th percentile of every completed request's latency (linear
    interpolation between order statistics), not of chunk medians."""
    return float(np.percentile(np.asarray(latencies_ms, np.float64), q))


def samples_to_frames(hg: dict, samples: int) -> int:
    """Mel frames of a waveform of ``samples`` samples (the inverse of
    ``flops.waveform_length``, which is affine in the frames)."""
    base = flops.waveform_length(hg, 0)
    return (samples - base) // (flops.waveform_length(hg, 1) - base)


def release(run, st) -> None:
    import torch

    del st.decoder, st.server
    if run.device != "cpu":
        torch.cuda.empty_cache()


def compare_batch(fm, hg, x1_ref, frames_ref, codes_ref, mel_prog, frames_prog, waves_prog) -> dict:
    """Per real row j (``waves_prog`` maps a row to its delivered PCM16
    codes): whether its frame count matches, and where it does its mel's and
    codes' relative L2 errors against the reference."""
    rows = {}
    same_bound = mel_prog.shape[1] == x1_ref.shape[1]
    for j, wave in waves_prog.items():
        n = int(frames_ref[j])
        if not same_bound or frames_prog[j] != n or len(wave) != ref.waveform_lengths(hg, n):
            rows[j] = {"frames_match": False}
            continue
        x_prog = (mel_prog[j, :n].float() - fm["mean"]) / fm["std"]
        x_ref = x1_ref[j, :n]
        c_prog = wave_tensor(wave, codes_ref.device)
        c_ref = codes_ref[j, : len(wave)]
        rows[j] = {
            "frames_match": True,
            "mel": float((x_prog - x_ref).norm() / x_ref.norm()),
            "wav": float((c_prog - c_ref).norm() / c_ref.norm().clamp(min=1.0)),
            "zero_codes": int((c_prog == 0).sum()),
            "codes": len(wave),
        }
    return rows


def wave_tensor(wave, device):
    import torch

    return torch.as_tensor(np.asarray(wave, np.float32), device=device)


def summarize(rows: list, limits: dict, min_rows: int) -> list:
    """The numbers compared over every checked row."""
    matched = [r for r in rows if r["frames_match"]]
    codes = sum(r["codes"] for r in matched)
    checks = [
        Check("rows_checked", float(len(rows)), float(min_rows), "min"),
        Check("frames_mismatch_share", (len(rows) - len(matched)) / max(len(rows), 1), limits["frames_mismatch_share"]),
        Check("mel_rel_err", max((r["mel"] for r in matched), default=float("inf")), limits["mel_rel_err"]),
        Check("wav_rel_err", max((r["wav"] for r in matched), default=float("inf")), limits["wav_rel_err"]),
        Check("zero_code_share", sum(r["zero_codes"] for r in matched) / max(codes, 1), limits["zero_code_share"]),
    ]
    return checks


def reference_batch(torch, w, fm, hg, ids, noise_state, dt, trunc, device, p=ref.F32):
    """The reference on one collated batch with the ODE noise drawn from the
    generator state the server's stood at before it."""
    gen = torch.Generator(device=device)
    gen.set_state(noise_state)
    ids_t = torch.as_tensor(ids, device=device)
    return ref.synthesize(w, fm, hg, ids_t, lambda shape: torch.randn(shape, generator=gen, device=device), dt, trunc, p)


def reference_weights(torch, config, seed, device) -> tuple:
    """The same weights the program got, drawn again from the seed, in f32."""
    cfm_w, voc_w = decoder_weights(torch, config, seed, device, torch.bfloat16)
    return {k: v.float() for k, v in cfm_w.items()}, {k: v.float() for k, v in voc_w.items()}


def check(run, st) -> list:
    import torch

    fm, hg, tr = run.config["flow_matching"], run.config["hifigan"], run.traffic
    cfm_w, voc_w = reference_weights(torch, run.config, run.seed, run.device)
    w = {**cfm_w, **voc_w}
    rows = []
    with tf32_off(torch):
        for k in sorted(st.kept):
            kept = st.kept[k]
            reals = {i - k * st.batch: st.waves[i] for i in st.waves if i // st.batch == k}
            if "mel" not in kept or not reals:
                continue
            x1, mask, frames, codes = reference_batch(torch, w, fm, hg, kept["ids"], kept["noise"], st.dt, st.trunc, run.device)
            frames_prog = {j: samples_to_frames(hg, len(v)) for j, v in reals.items()}
            rows += list(compare_batch(fm, hg, x1, frames.cpu(), codes, kept["mel"], frames_prog, reals).values())
            del x1, mask, codes
    zero = sum(r.get("zero_codes", 0) for r in rows)
    total = sum(r.get("codes", 0) for r in rows)
    run.note(f"checked {len(rows)} requests of batches {sorted(st.kept)}; nonzero PCM16 codes {1 - zero / max(total, 1)!r} "
             f"(wire gain {run.config['assumed']['weights']['wire_gain']})")
    return summarize(rows, tr["limits"], tr["min_checked_rows"])


def control(run, fmt: str = "fp8") -> list:
    """The control: the reference computed in ``fmt`` put in the program's
    place on the batches a run keeps (the same weights, unit ids and noise,
    the server's batching replayed), held by the run's own comparison
    against the reference in f32."""
    import torch

    fm, hg, tr = run.config["flow_matching"], run.config["hifigan"], run.traffic
    batch, dev = run.config["flow_matching_with_hifigan"]["batch_size"], run.device
    cfm_w, voc_w = reference_weights(torch, run.config, run.seed, dev)
    w = {**cfm_w, **voc_w}
    keep = kept_batches(tr, fm["vocab_size"], run.seed, batch)
    stream = T.request_stream(tr, fm["vocab_size"], run.seed)
    gen = torch.Generator(device=dev).manual_seed(sub_seed(run.seed, 2))
    low = ref.Precision(fmt)
    rows = []
    with tf32_off(torch), torch.no_grad():
        for k in range(max(keep) + 1):
            ids = collate([next(stream)[1] for _ in range(batch)], batch, tr["length_multiple"])
            state = gen.get_state()
            want = reference_batch(torch, w, fm, hg, ids, state, fm["dt"], fm["truncation_value"], dev)
            gen.set_state(state)
            torch.randn((batch, want[0].shape[1], fm["dim_in"]), generator=gen, device=dev)  # the server's draw for this batch
            if k not in keep:
                continue
            x1, mask, frames, codes = reference_batch(torch, w, fm, hg, ids, state, fm["dt"], fm["truncation_value"], dev, low)
            mel = ref.log_mel(fm, x1, mask)
            waves = {j: codes[j, : int(ref.waveform_lengths(hg, int(frames[j])))].cpu().numpy() for j in range(batch)}
            frames_prog = {j: int(frames[j]) for j in range(batch)}
            rows += list(compare_batch(fm, hg, want[0], want[2].cpu(), want[3], mel, frames_prog, waves).values())
    return summarize(rows, tr["limits"], tr["min_checked_rows"])
