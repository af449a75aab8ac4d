"""Batch-size sweep of the port's CUDA kernels.

    python3 scripts/torch_batch_sweep.py [--seed N] [--banded]

The batch sets how many warps each SM holds. The sweep times ``score.cu``
and ``align.cu`` at 512 x 512 (SW, canonical flavor) over a range of batch
sizes with CUDA events (median of 7 after a warm-up, as chip_smoke.py does)
and prints one JSON line per point: where GCUPS grows with the batch, the
kernels are short of warps at that batch. ``--banded`` sweeps the banded
kernels instead (``banded_score.cu``, ``banded_align.cu``, linear DNA SW)
on chip_smoke's HiFi-like pairs of 16 kbp at band 512, over the round
sizes of ``cuda_banded.chunk_pairs_for`` (whole waves of 4 pairs an SM:
528 on an H100) and of its cap (588), with the rest of 1024 pairs each
leaves, and 1024.
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


def banded_sweep(rng, dev) -> None:
    """B5 and B6 on the first b of 1024 HiFi-like pairs of 16 kbp."""
    from versalignlib_tpu_torch.ops import cuda_banded

    genome = chip_smoke.make_genome(rng)[1]
    reads, refs = chip_smoke.make_banded_pairs(rng, genome)
    band, sw, tie = chip_smoke.BAND, Algorithm.SMITH_WATERMAN, TieBreak.DIAG_UP_LEFT
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kernel in ("banded_align", "banded_score"):
        r, f, offs = chip_smoke._banded_inputs(
            reads, refs, band, chip_smoke.BAND_TILE if kernel == "banded_score" else None, dev)
        mrp = torch.from_numpy(cuda_align.last_valid_pos(reads, tie)).to(dev)
        for b in (132, 264, 396, 436, 496, 528, 588, 660, 792, 1024):
            if kernel == "banded_score":
                t = chip_smoke.time_cuda(lambda: cuda_banded.score(r[:b], f[:b], offs, P, sw, band))
            else:
                t = chip_smoke.time_cuda(lambda: cuda_banded.fill(r[:b], f[:b], offs, mrp[:b], P,
                                                                  sw, tie, band))
            print(json.dumps({"kernel": kernel, "algorithm": "SW", "b": b,
                              "warps_per_sm": b / sms, **t,
                              "ms_per_pair": t["median"] / b}), flush=True)
        del r, f
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--banded", action="store_true", help="sweep the banded kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.nvidia_smi_line(), flush=True)
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda", 0)
    if args.banded:
        banded_sweep(rng, dev)
        return 0
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
