"""Time chip_smoke.py's banded models' phase at several DNA check counts.

    python3 scripts/torch_banded_check_cost.py [--seed N] [--checks 16 4 16 4]

Builds the banded kernels, draws chip_smoke's 1024 DNA pairs of 16 kbp,
then runs ``phase_banded_models`` once for each count of ``--checks``, in
the order given, with ``BANDED_CHECK`` (the DNA models' pairs held to the
plain reference) set to it. Each run logs every model's line, whose last
figure is the time of its plain reference, and one ``[check-cost]`` line
with the phase's wall. It says whether fewer checked pairs shorten the
phase (the plain references launch row by row). Needs one CUDA card; about
two minutes a count.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from versalignlib_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checks", type=int, nargs="+", default=[16, 4, 16, 4])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_banded_check_cost: no CUDA device", file=sys.stderr)
        return 2
    cs.log(f"[card] {cs.nvidia_smi_line()}")
    cs.log(f"[build] {_build.build(['banded_score.cu', 'banded_align.cu', 'banded_walk.cu'])}")
    rng = np.random.default_rng(args.seed)
    pairs = cs.make_banded_pairs(rng, cs.make_genome(rng)[1])
    dev = torch.device("cuda", 0)
    for check in args.checks:
        cs.BANDED_CHECK = check
        t0 = time.perf_counter()
        cs.phase_banded_models(np.random.default_rng(args.seed + 1), dev, pairs)
        cs.log(f"[check-cost] BANDED_CHECK {check}: phase {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
