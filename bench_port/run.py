"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``bench_port/``
and the port ``epnet_tpu_torch/``. It needs as many CUDA devices as the
cell asks for and exits with code 2 without them; the last line of
standard output is the result (see ``harness.py``), the last lines of
standard error each compared number beside its limit.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])

from bench_port import harness  # noqa: E402

if __name__ == '__main__':
    sys.exit(harness.main(t0=T0))
