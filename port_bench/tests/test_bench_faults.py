"""A run with the timed path broken underneath reads ``correct`` false: each
fault a cell can have (``port_bench/faults.py``), planted in the program on
the CPU at a small size (the harness's look for a card skipped), while the
sound run of the same size reads true."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from port_bench import faults, harness
from port_bench.tests import small

SEED = 2**31 + 17
ROOT = Path(__file__).resolve().parents[2]
CELLS = {w["name"]: (w["config"], w["traffic"]) for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}
SERVING = [c for c in CELLS if not c.endswith("train_cfm")]


def run(cell):
    torch.set_num_threads(2)
    cfg, tr = CELLS[cell]
    return harness.execute(cell, SEED, 0.5, False, "cpu", config=small.config(cfg), traffic=small.traffic(tr))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", faults.SERVING, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", SERVING)
def test_serving_fault_reads_incorrect(monkeypatch, fault, cell):
    fault(monkeypatch)
    result = run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", faults.ENCODING, ids=lambda f: f.__name__)
def test_encoding_fault_reads_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    result = run("expresso.resynth_wav")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", faults.TRAINING, ids=lambda f: f.__name__)
def test_training_fault_reads_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    result = run("expresso.train_cfm")
    assert not result["correct"], result["checks"]
