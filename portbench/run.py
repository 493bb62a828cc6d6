"""Run one cell of the benchmark of pioran_tpu_torch once and print its
result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. Needs the
CUDA device(s) the cell asks for; without them it exits with code 2 and
prints no result.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel and extension caches at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from portbench.harness import main

    sys.exit(main())
