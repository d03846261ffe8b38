#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch port on this machine's card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Exits non-zero, printing no result, without a
CUDA card (or with fewer than the cell asks for). See ``port_bench/harness.py``.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
