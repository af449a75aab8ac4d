"""The control of a cell on the card: its whole run with the plain
reference, computed in the configuration's ``control_cell_bits`` (8-bit
saturating cells), in the program's place, on each seed given. The
comparison has to find it wrong; each line printed is one seed's numbers
compared, beside their limits.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--pool 1]

The window makes one call of each pool batch (``--pool`` overrides the
traffic's pool, so that a slow control answers fewer distinct calls; the
comparison reads the same number of sampled reads either way).
"""

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from vbench.cell import forbidden_modules, run_cell  # noqa: E402
from vbench.spec import Spec  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--pool", type=int)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    spec = Spec()
    traffic = spec.traffic(spec.cell(args.workload)["traffic"])
    pool = args.pool or traffic["pool"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = run_cell(spec, args.workload, seed, 0.0, False, torch.device("cuda", 0), t0,
                       overrides={"traffic": {"pool": pool}},
                       program=lambda entry: entry.control, min_calls=pool)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "correct": out["correct"], "checks": out["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"the process holds forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
