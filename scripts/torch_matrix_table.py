"""Where the kernels keep an S x S matrix: shared memory or the read-only cache.

    python3 scripts/torch_matrix_table.py [--seed N]

The kernels of ``csrc/`` read a matrix of at most 48 KB from shared memory
and a larger one from device memory through the read-only cache. This
script times both on the same protein data: BLOSUM62 itself (25 x 25,
2.5 KB) and BLOSUM62 padded with zero rows and columns to 111 x 111
(49 KB), which scores every code below 25 as BLOSUM62 does. The two
outputs must be equal. It runs the score kernel at 16384 pairs and both
fills at 4096 pairs of 512 x 512, SW and NW, canonical flavor, linear
(gap -11) and affine (open -11, extend -1) gaps. Each point is the median
of 7 CUDA-event runs (chip_smoke.time_cuda), taken in the order small,
padded, padded, small; one JSON line per point.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from versalignlib_tpu_torch.alphabet import blosum62  # noqa: E402
from versalignlib_tpu_torch.ops import cuda_align  # noqa: E402
from versalignlib_tpu_torch.ops.cuda_score import score_batch_device  # noqa: E402
from versalignlib_tpu_torch.params import AlignmentParameters  # noqa: E402
from versalignlib_tpu_torch.types import Algorithm, TieBreak  # noqa: E402

#: 111 x 111 x 4 bytes is over the kernels' 48 KB shared-memory limit.
PADDED_S = 111


def padded(matrix: tuple, s: int) -> tuple:
    out = np.zeros((s, s), dtype=np.int64)
    k = len(matrix)
    out[:k, :k] = np.array(matrix)
    return tuple(tuple(int(v) for v in row) for row in out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.nvidia_smi_line(), flush=True)
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda", 0)
    m = n = 512
    tie = TieBreak.DIAG_UP_LEFT
    small, big = blosum62(), padded(blosum62(), PADDED_S)
    gaps = {"linear": dict(score_gap_read=-11, score_gap_ref=-11),
            "affine": dict(score_gap_read=-1, score_gap_ref=-1,
                           gap_open_read=-11, gap_open_ref=-11)}
    for kind, b in (("score", 16384), ("align", 4096)):
        r_np = chip_smoke.random_protein(rng, b, m)
        r = torch.from_numpy(r_np).to(dev)
        f = torch.from_numpy(chip_smoke.random_protein(rng, b, n)).to(dev)
        mrp = torch.from_numpy(cuda_align.last_valid_pos(r_np, tie, small)).to(dev)
        for gap, kw in gaps.items():
            params = {"smem": AlignmentParameters(matrix=small, **kw),
                      "ldg": AlignmentParameters(matrix=big, **kw)}
            for alg in Algorithm:
                def run(p):
                    if kind == "score":
                        return score_batch_device(r, f, p, alg)
                    return cuda_align.fill(r, f, mrp, p, alg, tie)

                got = {k: run(p) for k, p in params.items()}
                for x, y in zip(*(v if isinstance(v, tuple) else (v,)
                                  for v in got.values())):
                    if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
                        raise AssertionError(f"{kind} {gap} {alg.name}: outputs differ")
                times = {"smem": [], "ldg": []}
                for k in ("smem", "ldg", "ldg", "smem"):
                    times[k].append(chip_smoke.time_cuda(lambda: run(params[k]))["median"])
                print(json.dumps({
                    "kernel": kind, "gaps": gap, "algorithm": alg.name, "b": b,
                    "m": m, "n": n, "smem_ms": times["smem"], "ldg_ms": times["ldg"],
                    "ldg_over_smem": sum(times["ldg"]) / sum(times["smem"])}), flush=True)
        del r, f
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
