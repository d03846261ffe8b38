"""The runner refuses to measure without a card, and a run's process loads
nothing of JAX or the JAX package."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    done = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "expresso.serve", "--seed", str(2**31 + 9),
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout.strip() == ""
    assert "CUDA" in done.stderr


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules({"jax.numpy": 1, "speech_resynth_torch.ops": 1, "jaxtyping": 1}) == ["jax.numpy"]
    assert harness.forbidden_modules({"speech_resynth_tpu": 1, "flax.linen": 1}) == ["flax.linen", "speech_resynth_tpu"]


REHEARSAL = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from port_bench import harness
from port_bench.tests import small
out = {{}}
for cell, cfg, tr in {cells!r}:
    res = harness.execute(cell, 2**31 + 11, 0.5, False, "cpu", config=small.config(cfg), traffic=small.traffic(tr))
    out[cell] = res["correct"]
print(json.dumps({{"ran": out, "forbidden": harness.forbidden_modules()}}))
"""


def test_a_cpu_rehearsal_of_every_runner_loads_no_jax():
    cells = [(w["name"], w["config"], w["traffic"]) for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
    code = REHEARSAL.format(root=str(ROOT), cells=cells)
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert set(result["ran"]) == {c for c, _, _ in cells}
    assert result["forbidden"] == []


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark measures nothing without one")
    done = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "expresso.serve", "--seed", str(2**31 + 13),
                           "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    assert json.loads(done.stdout.strip().splitlines()[-1])["correct"] is True
