"""The benchmark's own tests: the harness, the generator, the arithmetic
and the reference, on the CPU at small sizes; tests marked ``card`` run a
cell on a CUDA device and skip without one.

    python3 -m pytest benchmark/tests -q
"""

import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

#: Each cell cut to a size the CPU runs in a second or two.
SMALL = {
    "ref512.score": {"traffic": {"pairs_per_call": 24, "pool": 2},
                     "pairs": {"pad_to": 48, "length_min": 16, "length_max": 48}},
    "illumina150.genome": {"traffic": {"reads_per_call": 3, "pool": 2, "check_reads": 4},
                           "reads": {"length": 40},
                           "references": {"genome": {"length": 3000, "window": 256,
                                                     "stride": 128}}},
}

#: The same cells at sizes where correct scores pass what 8-bit cells hold.
WIDE = {
    "ref512.score": {"traffic": {"pairs_per_call": 16, "pool": 2},
                     "pairs": {"pad_to": 160, "length_min": 128, "length_max": 160}},
    "illumina150.genome": {"traffic": {"reads_per_call": 3, "pool": 1, "check_reads": 3},
                           "references": {"genome": {"length": 2000, "window": 640,
                                                     "stride": 320}}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: runs a cell on a CUDA device")


@pytest.fixture
def card():
    """A CUDA device, or a skip."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
