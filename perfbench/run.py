#!/usr/bin/env python3
"""Run one cell of the benchmark of ``dynaboa_tpu_torch`` once.

  python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
      --trace <0|1>

from the root of a checkout.  Prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; the numbers the check compared, each beside its limit, come
last in it and last on standard error.  Exits 2 without a result when the
cell's CUDA cards are not there, 3 when anything imported JAX or the JAX
package.
"""

import time

T_IMPORT = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_IMPORT))
