#!/usr/bin/env python3
"""Run one cell of the benchmark on this machine's CUDA card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result as one JSON object; the numbers the check compared, each beside its
limit, are the last lines of standard error.  Without a CUDA card, or
without the program in ``src/repro_torch``, it prints no result and exits
with 2.
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout (the
# program's own nvcc builds go to build/repro_torch)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
