"""Run one cell of the benchmark once and print its result line.

    python3 cics_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program (``src/repro_torch``).
The cells, configurations and metrics are those of ``BENCHMARK.json``.
Without a CUDA card, or with fewer than the cell asks for, it exits with a
non-zero code and prints no result.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for cache, sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[cache] = str(ROOT / "build" / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from cics_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
