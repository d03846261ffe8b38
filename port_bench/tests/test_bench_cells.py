"""Every cell of BENCHMARK.json finds its configuration, traffic mix, runner
and metric readers by name, and the file keeps the format its readers rely on."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from port_bench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_its_config_traffic_and_runner_by_name(cell):
    bench, spec, config, traffic = harness.load_cell(cell)
    assert spec["name"] == cell and config["flow_matching"]["vocab_size"] == 2000
    runner = harness.load_by_path("runners", traffic["runner"])
    for fn in ("setup", "window", "release", "check", "control"):
        assert callable(getattr(runner, fn))
    reported = harness.metrics_of(bench, cell, "end_to_end")
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert harness.metrics_of(bench, cell, "per_layer")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader_and_moves_a_metric_its_cells_report(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert callable(harness.load_by_path("metrics", metric).read)
    moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    assert set(m["workloads"]) <= set(moves.get("workloads", m["workloads"]))


def test_benchmark_file_keeps_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[key]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and (ROOT / c["file"]).is_file()
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024
