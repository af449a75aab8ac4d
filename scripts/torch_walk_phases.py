"""Run only the traceback walks' phases of chip_smoke.py on one CUDA card.

    python3 scripts/torch_walk_phases.py [--seed N]

Builds the walks (csrc/walk.cu, csrc/banded_walk.cu) and the fills whose
words they walk (csrc/align.cu, csrc/align_affine.cu, csrc/banded_align.cu),
prints each walk instantiation's registers and launch geometry, then runs
chip_smoke's walk phases on the data they are given there: every B7-B10
branch against its plain version (``phase_walk_vs_plain``: the main
shapes, the edges, the window and miss cases of both walks, 32 of the
16 kbp pairs) and their times (``phase_walk_times``: the main shapes and
``map_reads``' align shape, with misses and rows a round; launch counts 0:
no entry point runs here). Prints the same log lines and a
``{"kernels": [...]}`` line with the four walk entries. About two minutes
with the builds: the quick check after an edit of a walk.
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

WALKS = ("walk.cu", "banded_walk.cu")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_walk_phases: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cs.log(f"[card] {cs.nvidia_smi_line()}")
    cs.log(f"[build] {_build.build([*WALKS, 'align.cu', 'align_affine.cu', 'banded_align.cu'])}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for src, pairs in zip(WALKS, (cs.ALIGN_PAIRS, cs.BANDED_PAIRS)):
        lines = cs.register_report(_build.library_path(src).with_suffix(".log").read_text())
        cs.check_no_spills(src, lines)
        for line in cs.walk_geometry(src, lines, pairs, sms):
            cs.log(f"[build] {src} launch: {line}")
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda", 0)
    data = cs.make_search_data(rng)
    pairs = cs.make_banded_pairs(rng, data["map_to_reference"][1])
    errs, plain_ms = cs.phase_walk_vs_plain(cs.edge_rng(args.seed, 10), dev, pairs)
    launches = {k: 0 for k in ("dna_default", "dna_affine_bwamem", "banded:dna_default",
                               "banded:dna_affine_bwamem")}
    entries = cs.phase_walk_times(dev, pairs, data, errs, plain_ms, launches, {})
    cs.log(f"[phase] total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
