#!/usr/bin/env python3
"""Read a cell's control on the card: the plain reference computed one
precision step below the configuration's, put in the program's place, held
by the cell's own comparison. Its readings are the upper ends the limits of
``correct`` are set below; the benchmark's runs never run it.

    python3 port_bench/control.py --workload <cell> --seeds <n> [<n> ...] [--format fp8]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench import harness  # noqa: E402


def readings(cell: str, seed: int, fmt: str, device: str = "cuda", config=None, traffic=None) -> list:
    _, spec, cell_config, cell_traffic = harness.load_cell(cell)
    run = harness.Run(spec, config or cell_config, traffic or cell_traffic, seed, 0.0, False, device)
    return harness.load_by_path("runners", run.traffic["runner"]).control(run, fmt)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--format", default="fp8")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = readings(args.workload, seed, args.format)
        print(json.dumps({"workload": args.workload, "control": args.format, "seed": seed, "seconds": time.perf_counter() - t0,
                          "readings": {c.name: c.value for c in checks}, "fails": [c.name for c in checks if not c.ok]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
