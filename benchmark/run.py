"""Run one cell of the benchmark of ``versalignlib_tpu_torch`` once, on the
CUDA device of this machine, and print its result as the last line of
standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations, traffic mixes and metrics are those of
``BENCHMARK.json`` at the checkout's root. Exits with a code other than 0,
printing no result, where no card is present.
"""

import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from vbench.cell import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
