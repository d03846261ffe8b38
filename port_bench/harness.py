"""The benchmark's harness: one cell, one seed, one window.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration (``port_bench/configs/<config>.json``) and traffic mix
(``port_bench/traffic/<traffic>.json``), the runner the mix names
(``port_bench/runners/<runner>.py``) and each per-layer metric's reader
(``port_bench/metrics/<metric>.py``). A runner provides ``setup(run)``,
``window(run, state)``, ``release(run, state)`` and ``check(run, state)``;
a reader provides ``read(run)``, which returns a number or None.

A run: set-up (imports, the kernel library, weights, warm-up of the cell's
shapes) up to the first timed request or step is ``setup_s``, counted from
the process's start; then the window, under ``torch.profiler`` with
``--trace 1``; then the peak memory; then the program's state is freed and
the plain reference checks what the window produced. The last line of
standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "port_bench"
# modules that may not be loaded in a run's process: JAX and the JAX package,
# compared by whole top-level name (the program's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "speech_resynth_tpu")
# the kernel caches a CUDA toolchain may use, fixed inside the checkout (build/ is not committed)
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions", "TRITON_CACHE_DIR": "build/triton_cache"}


def process_start() -> float:
    """The wall-clock time this process started (from /proc), or now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        btime = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines() if line.startswith("btime"))
        return btime + start_ticks / ticks
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def sub_seed(seed: int, k: int) -> int:
    """A seed for the k-th stream of a run, a pure function of ``--seed``."""
    return (int(seed) * 1_000_003 + k) % 2**63


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


@contextlib.contextmanager
def tf32_off(torch):
    """TF32 off for f32 products (cuBLAS and cuDNN) inside, restored after:
    the reference's f32 is f32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@dataclasses.dataclass
class Check:
    """One number compared: ``value`` must be at most ``limit`` (``sense``
    "max") or at least it ("min")."""

    name: str
    value: float
    limit: float
    sense: str = "max"

    @property
    def ok(self) -> bool:
        if not math.isfinite(self.value):
            return False
        return self.value <= self.limit if self.sense == "max" else self.value >= self.limit


@dataclasses.dataclass
class Run:
    """What a runner and the metric readers see of one run."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    records: Dict[str, Any] = dataclasses.field(default_factory=dict)
    spans: List[tuple] = dataclasses.field(default_factory=list)  # (name, start_s, end_s), host, traced runs
    ops: List[tuple] = dataclasses.field(default_factory=list)  # (name, start_s, end_s), device, traced runs
    window: Optional[tuple] = None  # (start_s, end_s) of the traced window on the trace's clock
    started: float = dataclasses.field(default_factory=time.time)  # the process's start, for set-up laps

    def span(self, name: str):
        """A host span on the profiler's timeline (traced runs only)."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(f"bench.{name}")

    def note(self, text: str) -> None:
        """An informational line on standard error, before the checks."""
        print(text, file=sys.stderr, flush=True)

    def lap(self, what: str) -> None:
        """A set-up stage's end, in seconds since the process started."""
        self.note(f"set-up: {what} at {time.time() - self.started:.3f} s")

    def synchronize(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    @property
    def window_s(self) -> Optional[float]:
        return None if self.window is None else self.window[1] - self.window[0]

    @property
    def busy_s(self) -> Optional[float]:
        if self.window is None:
            return None
        from .yardstick import timeline

        return timeline.busy([(a, b) for _, a, b in self.ops], *self.window)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: Optional[dict] = None):
    """(benchmark, cell, configuration, traffic mix) by the cell's name."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return bench, cell, load_json(ROOT / conf["file"]), load_json(HERE / "traffic" / f"{cell['traffic']}.json")


def load_by_path(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_of(bench: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` this cell reports: those listing it, and those with no list."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def _read_trace(run: Run, prof) -> None:
    """Device operations and the benchmark's host spans from the profiler,
    in seconds on the trace's clock, and the window's bounds."""
    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    ops, spans = [], []
    events = [(e.name(), e.device_type(), e.start_ns() / 1e9, e.end_ns() / 1e9, e.is_user_annotation())
              for e in prof.profiler.kineto_results.events()]
    for name, dev, start, end, annotation in events:
        if name.startswith("bench."):
            if dev == cpu:
                spans.append((name[len("bench."):], start, end))
        elif dev == cuda and not annotation:
            ops.append((name, start, end))
    window = [s for s in spans if s[0] == "window"]
    run.window = (window[0][1], window[0][2]) if window else None
    run.spans = [s for s in spans if s[0] != "window"]
    run.ops = ops


def card_settings(torch) -> str:
    """The card's name and power limit (nvidia-smi) and the TF32 settings the window runs under."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "nvidia-smi unavailable"
    return (f"card {smi}; torch {torch.__version__} cuda {torch.version.cuda}; window under "
            f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")


def breakdown(run: Run) -> dict:
    """The device operations that took most time and the longest idle gaps, named by host span."""
    from .yardstick import timeline

    by_name = timeline.time_by_name(run.ops, *run.window)
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    gaps = timeline.idle_gaps([(a, b) for _, a, b in run.ops], run.spans, *run.window)
    return {"device_ops": [[name[:160], s] for name, s in top], "idle_gaps": gaps}


def execute(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda", started: Optional[float] = None,
            bench: Optional[dict] = None, config: Optional[dict] = None, traffic: Optional[dict] = None) -> dict:
    """One run of a cell; returns the result (``checks`` last). ``config`` and
    ``traffic`` replace the cell's files (the CPU tests run small ones)."""
    started = process_start() if started is None else started
    bench, cell, cell_config, cell_traffic = load_cell(cell_name, bench)
    import torch

    run = Run(cell, config or cell_config, traffic or cell_traffic, int(seed), float(seconds), bool(trace), device, started=started)
    runner = load_by_path("runners", run.traffic["runner"])
    run.lap("imports")
    if device != "cpu":
        run.note(card_settings(torch))
    state = runner.setup(run)
    run.synchronize()
    setup_s = time.time() - started

    prof = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device != "cpu":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    with run.span("window"):
        measured = runner.window(run, state)
        run.synchronize()
    if prof is not None:
        prof.stop()
        _read_trace(run, prof)
        del prof
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    loaded = forbidden_modules()
    if loaded:
        raise RuntimeError(f"the run's process loaded {loaded}: nothing of JAX or the JAX package may run")

    runner.release(run, state)
    checks = runner.check(run, state)
    correct = all(c.ok for c in checks)

    metrics = {}
    if not trace:
        values = {**measured["metrics"], "setup_s": setup_s}
        for m in metrics_of(bench, cell_name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in metrics_of(bench, cell_name, "per_layer"):
            value = load_by_path("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": measured["attempted"],
        "failed": measured["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device != "cpu" else "cpu",
            "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(peak),
        },
    }
    if trace and run.window is not None:
        result["device"]["busy_s"] = run.busy_s
        result["device"]["window_s"] = run.window_s
        result["breakdown"] = breakdown(run)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit, "must_be": "<=" if c.sense == "max" else ">="} for c in checks}
    return result


def main(argv=None) -> int:
    started = process_start()
    parser = argparse.ArgumentParser(description="Run one benchmark cell of the PyTorch port once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(ROOT / rel)

    _, cell, _, _ = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA device(s), this machine has {have}; "
              "nothing is measured without the card", file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", started)
    loaded = forbidden_modules()
    if loaded:
        print(f"port_bench: the run's process loaded {loaded}; no result", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} {c['must_be']} {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
