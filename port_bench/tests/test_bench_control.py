"""The control (the reference one precision step lower, in the program's
place) reads ``correct`` false under each cell's limits, here at a small
size on the CPU; on the card ``port_bench/control.py`` reads it at the
cell's own size. The same reference in f32 in the program's place passes."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from port_bench import control
from port_bench.tests import small

ROOT = Path(__file__).resolve().parents[2]
CELLS = [(w["name"], w["config"], w["traffic"]) for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell,cfg,tr", CELLS)
def test_control_fails_a_limit_and_f32_passes(cell, cfg, tr):
    torch.set_num_threads(2)
    for seed in (2**31 + 19, 5):
        low = control.readings(cell, seed, "fp8", "cpu", small.config(cfg), small.traffic(tr))
        assert not all(c.ok for c in low), [(c.name, c.value, c.limit) for c in low]
    same = control.readings(cell, 2**31 + 19, "f32", "cpu", small.config(cfg), small.traffic(tr))
    assert all(c.ok for c in same), [(c.name, c.value, c.limit) for c in same]
