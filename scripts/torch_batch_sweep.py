"""Batch-size sweep of the port's two CUDA kernels at 512 x 512.

    python3 scripts/torch_batch_sweep.py [--seed N]

One thread runs one pair, so the batch sets how many warps each SM holds.
The sweep times ``score.cu`` and ``align.cu`` (SW, canonical flavor) over a
range of batch sizes with CUDA events (median of 7 after a warm-up, as
chip_smoke.py does) and prints one JSON line per point: where GCUPS grows
with the batch, the kernels are short of warps at that batch.
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
from versalignlib_tpu_torch.ops import cuda_align  # noqa: E402
from versalignlib_tpu_torch.ops.cuda_score import score_batch_device  # noqa: E402
from versalignlib_tpu_torch.params import DEFAULT_PARAMETERS as P  # noqa: E402
from versalignlib_tpu_torch.types import Algorithm, TieBreak  # noqa: E402


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
    sw = Algorithm.SMITH_WATERMAN
    tie = TieBreak.DIAG_UP_LEFT
    for kernel, batches in (("score", (2048, 4096, 8192, 16384, 32768, 65536)),
                            ("align", (1024, 2048, 4096, 8192, 16384, 32768))):
        for b in batches:
            r_np = chip_smoke.random_codes(rng, b, m)
            r = torch.from_numpy(r_np).to(dev)
            f = torch.from_numpy(chip_smoke.random_codes(rng, b, n)).to(dev)
            if kernel == "score":
                t = chip_smoke.time_cuda(lambda: score_batch_device(r, f, P, sw))
            else:
                mrp = torch.from_numpy(cuda_align.last_valid_pos(r_np, tie)).to(dev)
                t = chip_smoke.time_cuda(lambda: cuda_align.fill(r, f, mrp, P, sw, tie))
            print(json.dumps({"kernel": kernel, "algorithm": "SW", "b": b,
                              "warps_per_sm": b / 32 / 132, **t,
                              "gcups": b * m * n / t["median"] / 1e6}), flush=True)
            del r, f
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
