"""The readers of the program's own spans and counters: each reads a number
from a traced rehearsal of its cell (the idle splits excepted: the CPU runs
no device operation), agrees with its outside twin, and finds the known
answer on a made-up timeline; a program without the recording gives
nothing. On the card, the program's spans share the trace's clock."""

from __future__ import annotations

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

from port_bench import harness
from port_bench.metrics import _recorded
from port_bench.tests import small

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# the per-layer metrics that read the program's own recording, and the cells that report them
READERS = ("decoder.synthesize_ms", "decoder.input_ms", "decoder.ode_ms", "decoder.vocoder_ms", "decoder.duration_sync_ms", "serve.inflight_ms",
           "serve.idle_in_ode", "serve.idle_in_vocoder", "serve.pad_share.counted", "resynth.io_ms", "resynth.fetch_ms",
           "resynth.idle_in_io", "encoder.pad_share.counted")
PROGRAM = {m["name"]: m["workloads"] for m in BENCH["per_layer"] if m["name"] in READERS}
IDLE = ("serve.idle_in_ode", "serve.idle_in_vocoder", "resynth.idle_in_io")

TRACED = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from port_bench import harness
from port_bench.metrics import _recorded
from port_bench.tests import small
from port_bench.yardstick import flops
runs = {{}}
read_trace = harness._read_trace
def keep(run, prof):
    read_trace(run, prof)
    runs["run"] = run
harness._read_trace = keep
out = {{}}
for cell, cfg, tr, seconds in {cells!r}:
    config, traffic = (small.config(cfg), small.traffic(tr)) if {device!r} == "cpu" else (None, None)
    res = harness.execute(cell, {seed}, seconds, True, {device!r}, config=config, traffic=traffic)
    run = runs.pop("run")
    hg = run.config["hifigan"]
    ours = sorted(_recorded.spans(run, "decoder.synthesize"))
    theirs = sorted((a, b) for name, a, b in run.spans if name == "dispatch")
    rec = run.records
    needed = sum(flops.waveform_length(hg, f) for f in rec.get("frames", {{}}).values())
    computed = sum(len(rows) * flops.waveform_length(hg, n) for (_, n, _), rows in zip(rec["batches"], rec["batch_rows"]))
    out[cell] = {{
        "correct": res["correct"], "metrics": {{k: v["value"] for k, v in res["metrics"].items()}},
        "spans": [len(ours), len(theirs)],
        "clock_ms": max((1e3 * max(abs(a - c), abs(b - d)) for (a, b), (c, d) in zip(ours, theirs)), default=None),
        "samples": [needed, computed],
    }}
print(json.dumps(out))
"""


def traced(device: str, cells, seed: int, timeout: int) -> dict:
    code = TRACED.format(root=str(ROOT), cells=cells, device=device, seed=seed)
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def cells_of(names=None):
    return [(w["name"], w["config"], w["traffic"]) for w in BENCH["workloads"] if any(w["name"] in c for c in PROGRAM.values())
            and (names is None or w["name"] in names)]


def test_every_program_reader_is_declared_and_reads_the_recording():
    assert set(PROGRAM) == set(READERS)
    assert all(m["source"] in ("program_span", "program_counter") for m in BENCH["per_layer"] if m["name"] in READERS)
    assert {c for c, _, _ in cells_of()} == {"expresso.serve", "expresso-duration.serve", "expresso.resynth_wav"}


@pytest.fixture(scope="module")
def rehearsal():
    return traced("cpu", [(c, cfg, tr, 0.5) for c, cfg, tr in cells_of()], 2**31 + 17, 900)


@pytest.mark.parametrize("cell", ["expresso.serve", "expresso-duration.serve", "expresso.resynth_wav"])
def test_a_traced_cpu_rehearsal_reads_every_program_metric_of_its_cell(rehearsal, cell):
    got = rehearsal[cell]
    assert got["correct"] is True
    for name, cells in PROGRAM.items():
        if cell not in cells:
            assert name not in got["metrics"]
        elif name in IDLE:
            assert name not in got["metrics"], name  # no device operation on the CPU: nothing to split
        else:
            assert isinstance(got["metrics"][name], float) and got["metrics"][name] >= 0, name


@pytest.mark.parametrize("cell", ["expresso.serve", "expresso-duration.serve"])
def test_the_serving_readings_agree_with_their_outside_twins(rehearsal, cell):
    got, m = rehearsal[cell], rehearsal[cell]["metrics"]
    ours, theirs = got["spans"]
    assert ours == theirs > 0 and got["clock_ms"] < 1.0  # one decoder.synthesize inside each bench.dispatch, on one clock
    assert 0.95 * m["serve.dispatch_ms"] <= m["decoder.synthesize_ms"] <= m["serve.dispatch_ms"]
    children = m["decoder.input_ms"] + m["decoder.ode_ms"] + m["decoder.vocoder_ms"] + m.get("decoder.duration_sync_ms", 0.0)
    assert 0.9 * m["decoder.synthesize_ms"] <= children <= m["decoder.synthesize_ms"]
    assert ("decoder.duration_sync_ms" in m) == (cell == "expresso-duration.serve")
    needed, computed = got["samples"]  # the runner's records, in samples: the counters' own terms
    assert m["serve.pad_share.counted"] == pytest.approx(100.0 * (1 - needed / computed), rel=1e-9)
    assert abs(m["serve.pad_share.counted"] - m["serve.pad_share"]) < 2.0  # samples are affine in frames


def test_the_resynthesis_readings_agree_with_their_outside_twins(rehearsal):
    m = rehearsal["expresso.resynth_wav"]["metrics"]
    assert m["encoder.pad_share.counted"] == pytest.approx(m["encoder.pad_share"], rel=1e-9)
    # the spans hold the wrapped calls and the loop's own work around them (each file's name, transcript and
    # path, the empty read that ends a pass), which costs well under 1 ms a file
    batch = small.config("expresso")["flow_matching_with_hifigan"]["batch_size"]
    assert m["io.host_ms"] <= m["resynth.io_ms"] <= m["io.host_ms"] + 1.0 * batch
    assert m["resynth.fetch_ms"] > 0


def fake_run(window, ops, spans):
    """A run whose trace holds ``ops`` in ``window`` (seconds) and whose
    program recorded ``spans`` ((name, start s, end s))."""
    run = harness.Run(cell={}, config={}, traffic={}, seed=0, seconds=1.0, trace=True, device="cuda")
    run.window, run.ops = window, [("op", a, b) for a, b in ops]
    recording = types.SimpleNamespace(
        spans=[types.SimpleNamespace(name=n, start_ns=int(a * 1e9), end_ns=int(b * 1e9)) for n, a, b in spans], counts=[])
    return run, recording


T0 = 1_800_000_000.0  # a wall-clock epoch like the trace's


@pytest.mark.parametrize("metric, spans, want", [
    # idle gaps [2, 3] and [4, 6]; an ODE span half inside the first, another over half of the second
    ("serve.idle_in_ode", [("decoder.ode", 1.5, 2.5), ("decoder.ode", 5.0, 7.0)], 15.0),
    ("serve.idle_in_vocoder", [("decoder.vocoder", 2.5, 3.5), ("decoder.ode", 4.0, 6.0)], 5.0),
    # overlapping spans count once; a span outside the window not at all
    ("resynth.idle_in_io", [("resynth.read", 2.0, 4.5), ("resynth.write", 4.2, 5.0), ("resynth.read", 11.0, 12.0)], 20.0),
    ("serve.idle_in_ode", [("decoder.ode", 0.0, 2.0)], 0.0),
])
def test_the_idle_splits_find_the_known_answer(monkeypatch, metric, spans, want):
    run, recording = fake_run((T0, T0 + 10), [(T0, T0 + 2), (T0 + 3, T0 + 4), (T0 + 6, T0 + 10)],
                              [(n, T0 + a, T0 + b) for n, a, b in spans])
    monkeypatch.setattr(_recorded, "recording", lambda: recording)
    assert harness.load_by_path("metrics", metric).read(run) == pytest.approx(want, abs=1e-4)
    assert harness.load_by_path("metrics", "device.idle.serve").read(run) == pytest.approx(30.0, abs=1e-4)


def test_a_program_without_the_recording_gives_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "speech_resynth_torch.core.tracing", None)  # the import fails, as on a program without it
    run, _ = fake_run((T0, T0 + 10), [(T0, T0 + 2)], [])
    run.records.update(batches=[], batch_rows=[], encoder_shapes=[], frames={})
    for name in PROGRAM:
        assert harness.load_by_path("metrics", name).read(run) is None, name


@pytest.mark.cuda
def test_on_the_card_the_program_spans_share_the_traces_clock():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the device trace and its clock exist only there")
    got = traced("cuda", [(c, cfg, tr, 3.0) for c, cfg, tr in cells_of(("expresso.serve", "expresso-duration.serve"))],
                 2**31 + 19, 900)
    for cell, g in got.items():
        ours, theirs = g["spans"]
        assert g["correct"] is True and ours == theirs > 0 and g["clock_ms"] < 1.0, (cell, g)
        assert {n for n, cells in PROGRAM.items() if cell in cells} <= set(g["metrics"]), (cell, g["metrics"])
