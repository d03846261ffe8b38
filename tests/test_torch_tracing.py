"""The port's own spans and counters (``core.tracing``): recorded only under a
``torch.profiler`` session, nested where the work nests, on the clock of the
profiler's own events, and capped."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from speech_resynth_torch.core.config import config_from_dict
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.core.tracing import Recorder, recorded
from speech_resynth_torch.dsp import audio_io
from speech_resynth_torch.models.cfm import CFMConfig
from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan, init_random_weights
from speech_resynth_torch.models.hifigan import HifiGanConfig
from speech_resynth_torch.models.hubert import HubertConfig, HubertEncoder
from speech_resynth_torch.models.kmeans import KMeansQuantizer
from speech_resynth_torch.models.speech_encoder import SpeechEncoder
from speech_resynth_torch.pipeline import synthesize as resynthesis
from speech_resynth_torch.pipeline.serving import SynthesisRequest, SynthesisServer

CFM_KW = dict(vocab_size=50, dim_in=8, dim_cond_emb=12, hidden_size=16, depth=2, heads=2, intermediate_size=24,
              conv_pos_embed_kernel_size=7, conv_pos_embed_groups=16)
VOC = HifiGanConfig(model_in_dim=8, upsample_initial_channel=16, upsample_rates=(5, 4), upsample_kernel_sizes=(10, 8),
                    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
# a tiny HuBERT with the real x320 frame rate (the dataset pads each batch to 30 s)
HUBERT = HubertConfig(hidden_size=24, num_hidden_layers=2, num_attention_heads=4, intermediate_size=48, conv_dim=(12, 12, 12),
                      conv_kernel=(10, 8, 4), conv_stride=(5, 8, 8), num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
UNITS = [np.arange(1, n + 1) % 49 + 1 for n in (5, 12, 7, 20, 9)]  # 3 batches of 2: the last is partial
FILES = (4800, 7000, 5555)  # 2 batches of 2: the last is partial
MS = 1_000_000  # ns


def decoder(predict_duration: bool) -> ConditionalFlowMatchingWithHifiGan:
    cfm = CFMConfig(**CFM_KW, predict_duration=predict_duration)
    return ConditionalFlowMatchingWithHifiGan.from_config(cfm, VOC, FLOAT32, torch.Generator().manual_seed(1), device="cpu")


@pytest.fixture(scope="module")
def plain():
    return decoder(False)


@pytest.fixture(scope="module")
def with_durations():
    return decoder(True)


@pytest.fixture(scope="module")
def encoder():
    hubert = HubertEncoder(HUBERT, FLOAT32)
    init_random_weights(hubert, torch.Generator().manual_seed(2))
    centers = torch.randn(49, HUBERT.hidden_size, generator=torch.Generator().manual_seed(3))
    return SpeechEncoder(hubert.eval().requires_grad_(False), KMeansQuantizer(centers), 2, deduplicate=True)


@pytest.fixture(scope="module")
def wav_tree(tmp_path_factory):
    src = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(5)
    for i, n in enumerate(FILES):
        audio_io.write(src / "test" / f"u{i}.wav", (0.3 * rng.standard_normal(n)).astype(np.float32), 16000)
    return src


def serve(dec):
    server = SynthesisServer(dec, batch_size=2, dt=0.5, length_multiple=8, pcm16=True, max_inflight=1)
    return list(server.synthesize_stream(SynthesisRequest(u, i) for i, u in enumerate(UNITS)))


def resynthesize(enc, dec, src, tgt):
    cfg = config_from_dict({
        "common": {"seed": 0},
        "synthesis": {"src_dir": str(src), "tgt_dir": str(tgt), "split": "test", "ext_audio": ".wav"},
        "flow_matching": {"dt": 0.5, "truncation_value": 1.0, "predict_duration": True},
        "flow_matching_with_hifigan": {"batch_size": 2},
    })
    resynthesis.synthesize(cfg, encoder=enc, decoder=dec)


def profiled(fn, *args):
    """``fn(*args)`` under a CPU profiler session: its result, what the port
    recorded, and the profiler's own events as {name: [(start_ns, end_ns)]}."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out, recorded(), events


def by_name(rec, name):
    return sorted((s for s in rec.spans if s.name == name), key=lambda s: s.start_ns)


def ancestry(rec, span):
    ids = {s.id: s for s in rec.spans}
    names = []
    while span.parent is not None:
        span = ids[span.parent]
        names.append(span.name)
    return names


def assert_on_the_profilers_clock(rec, events):
    """Each span that is also a ``record_function`` range starts and ends
    within 1 ms of the profiler's event of the same name."""
    checked = 0
    for name in {s.name for s in rec.spans} - {"serve.inflight"}:
        theirs = sorted(events[name])
        ours = by_name(rec, name)
        assert len(ours) == len(theirs), name
        for s, (start, end) in zip(ours, theirs):
            assert abs(s.start_ns - start) < MS and abs(s.end_ns - end) < MS, (name, s.start_ns - start, s.end_ns - end)
            checked += 1
    assert checked


def test_nothing_is_recorded_without_a_profiler(plain, encoder, with_durations, wav_tree, tmp_path):
    before = recorded()
    assert not torch._C._autograd._profiler_enabled()
    assert len(serve(plain)) == len(UNITS)
    resynthesize(encoder, with_durations, wav_tree, tmp_path)
    assert len(list(tmp_path.rglob("*.wav"))) == len(FILES)
    assert recorded() == before


def test_server_spans_nest_carry_request_ids_and_share_the_profilers_clock(plain):
    served, rec, events = profiled(serve, plain)
    assert [i for i, _ in served] == list(range(len(UNITS)))
    assert rec.dropped == 0
    enqueues = by_name(rec, "serve.enqueue")
    assert [s.attrs["batch"] for s in enqueues] == [0, 1, 2]
    assert [s.attrs["requests"] for s in enqueues] == [[0, 1], [2, 3], [4]]
    for name in ("decoder.synthesize", "decoder.input", "decoder.ode", "decoder.vocoder"):
        spans = by_name(rec, name)
        assert len(spans) == 3 and all(ancestry(rec, s)[-1] == "serve.enqueue" for s in spans), name
    assert all(ancestry(rec, s) == ["decoder.synthesize", "serve.enqueue"] for s in by_name(rec, "decoder.ode"))
    assert not by_name(rec, "decoder.duration_bound")  # this model predicts no durations

    inflight = by_name(rec, "serve.inflight")
    main = threading.get_ident()
    assert [s.attrs["batch"] for s in inflight] == [0, 1, 2]
    for s, enq in zip(inflight, enqueues):
        assert s.thread == main and s.end_thread != main  # opened by the enqueue, closed by the copy thread
        assert enq.end_ns <= s.start_ns <= s.end_ns
    assert_on_the_profilers_clock(rec, events)


def test_server_counters_give_the_pad_share_of_its_batches(plain):
    served, rec, _ = profiled(serve, plain)
    needed = sum(len(w) for _, w in served)
    assert needed == sum(int(VOC.waveform_lengths(len(u))) for u in UNITS)
    # serve.pad_share's formula in samples: each batch computes every row (fillers too) at its padded length
    computed = sum(2 * int(VOC.waveform_lengths(-(-max(len(u) for u in UNITS[k:k + 2]) // 8) * 8)) for k in range(0, 5, 2))
    assert rec.total("serve.samples_needed") == needed
    assert rec.total("serve.samples_computed") == computed
    assert len([c for c in rec.counts if c.name == "serve.samples_computed"]) == 3
    share = 1 - rec.total("serve.samples_needed") / rec.total("serve.samples_computed")
    assert share == pytest.approx(1 - needed / computed) and 0 < share < 1


def test_resynthesis_spans_run_read_encode_decode_fetch_write_and_count_the_encoders_padding(encoder, with_durations, wav_tree,
                                                                                              tmp_path):
    _, rec, events = profiled(resynthesize, encoder, with_durations, wav_tree, tmp_path)
    assert len(list(tmp_path.rglob("*.wav"))) == len(FILES)
    steps = ("resynth.read", "resynth.encode", "resynth.decode", "resynth.fetch", "resynth.write")
    spans = sorted((s for s in rec.spans if s.name.startswith("resynth.")), key=lambda s: s.start_ns)
    batches = [(s.attrs["batch"], s.name) for s in spans]
    assert batches == [(k, name) for k in (0, 1) for name in steps] + [(2, "resynth.read")]  # the last read finds none
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))
    for name in ("decoder.synthesize", "decoder.input", "decoder.duration_bound", "decoder.ode", "decoder.vocoder"):
        found = by_name(rec, name)
        assert len(found) == 2 and all(ancestry(rec, s)[-1] == "resynth.decode" for s in found), name
    assert all(ancestry(rec, s) == ["decoder.synthesize", "resynth.decode"] for s in by_name(rec, "decoder.duration_bound"))

    padded = 30 * 16000  # the dataset pads every batch to 30 s
    assert rec.total("encoder.samples_given") == len(FILES) * padded
    assert rec.total("encoder.samples_valid") == sum(FILES)
    assert_on_the_profilers_clock(rec, events)


def test_the_cap_counts_dropped_spans_and_a_new_session_starts_afresh():
    rec = Recorder(cap=3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(4):
            with rec.span("step", index=i):
                pass
        rec.count("items", 2)
        late = rec.begin("late")
    rec.end(late)  # begun in the session: recorded, though it closes after it
    got = rec.recorded()
    assert [s.attrs["index"] for s in got.spans] == [0, 1, 2] and got.counts == [] and got.dropped == 3

    assert not rec.recording()
    with rec.span("unrecorded"):
        pass
    assert rec.recorded() == got
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time.time_ns()
        rec.count("items", 5)
    again = rec.recorded()
    assert again.spans == [] and again.dropped == 0 and again.total("items") == 5 and again.counts[0].time_ns >= t0
