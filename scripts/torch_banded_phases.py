"""Run only the long-pair phases of chip_smoke.py on one CUDA card.

    python3 scripts/torch_banded_phases.py [--seed N]

Builds the banded kernels (csrc/banded_score.cu, csrc/banded_align.cu and
the walk csrc/banded_walk.cu), then runs chip_smoke's phases 9-12 on the
data they are given there: every B5 / B6 branch against its plain version
(the row layout's edges first), the banded models on 1024 pairs of 16 kbp
(walk on the card == walk on the host), ``map_long_reads`` against the
4.64 Mbp genome, and the B5 / B6 times; it prints the same log lines and a
``{"kernels": [...]}`` line with the B5 and B6 entries. A few minutes: the
quick check after an edit of a banded source.
"""

from __future__ import annotations

import argparse
import json
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_banded_phases: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cs.log(f"[card] {cs.nvidia_smi_line()}")
    cs.log(f"[build] {_build.build(['banded_score.cu', 'banded_align.cu', 'banded_walk.cu'])}")
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda", 0)
    genome = cs.make_genome(rng)[1]
    pairs = cs.make_banded_pairs(rng, genome)
    edge_errs = cs.phase_banded_edges(cs.edge_rng(args.seed), dev)
    errs, plain_ms = cs.phase_banded_kernels_vs_plain(rng, dev, pairs)
    errs = cs.merge_errs(edge_errs, errs)
    runs = cs.phase_banded_models(rng, dev, pairs)
    longreads = cs.phase_long_reads(rng, genome)
    entries = cs.phase_banded_times(rng, dev, pairs, errs, plain_ms, runs, longreads)
    cs.log(f"[phase] total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
