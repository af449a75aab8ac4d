"""Time the score and one-vs-many kernels of several checkouts of the port in
one process, interleaved.

    python3 scripts/torch_kernel_ab.py DIR_A DIR_B [--pairs 10] [--out FILE]

Each DIR is the root of a checkout holding ``versalignlib_tpu_torch/csrc``,
whose ``score.cu`` and ``search.cu`` must keep this checkout's C interface.
They are built with the package's nvcc flags into ``build/ab/<i>/`` of this
checkout and bound in place of the package's own build, so every side runs
through the same wrappers on the same inputs: scores on 16384 pairs of 512
x 512 under ``chip_smoke``'s four parameter sets, SW and NW, and the
one-vs-many kernel at each search path's launch shape
(``chip_smoke.search_launches``). Each round times every side once
(CUDA-event median of 7 after a warm-up), the order reversed every other
round, and every side's outputs must equal the first side's. Prints one
line per case: each side's median over the rounds and its quartiles, and in
how many rounds the last side beat the first. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from versalignlib_tpu_torch.ops import _build, cuda_score, cuda_search  # noqa: E402
from versalignlib_tpu_torch.types import Algorithm  # noqa: E402

KERNELS = {"score.cu": cuda_score.SCORE_KERNEL, "search.cu": cuda_search.SEARCH_KERNEL}


def build(side: int, checkout: pathlib.Path, source: str):
    """nvcc of one checkout's source; returns its bound C entry."""
    out_dir = _build.BUILD_DIR / "ab" / str(side)
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / source.replace(".cu", ".so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
           str(checkout / "versalignlib_tpu_torch" / "csrc" / source)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    kernel = KERNELS[source]
    fn = getattr(ctypes.CDLL(str(lib)), kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    return fn


def cases(dev) -> list[tuple[str, str, object]]:
    """(name, source, call) for every timed case."""
    rng = np.random.default_rng(0)
    out = []
    for pname, params in cs._param_sets().items():
        r = torch.from_numpy(cs.codes_for(params, rng, cs.SCORE_PAIRS, cs.LENGTH)).to(dev)
        f = torch.from_numpy(cs.codes_for(params, rng, cs.SCORE_PAIRS, cs.LENGTH)).to(dev)
        for alg in Algorithm:
            out.append((f"score {pname} {alg.name}", "score.cu",
                        lambda r=r, f=f, p=params, a=alg:
                        cuda_score.score_batch_device(r, f, p, a)))
    for name, (params, queries, pool, kind) in cs.search_launches(cs.make_search_data(rng)).items():
        q = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
        p = torch.from_numpy(np.ascontiguousarray(pool)).to(dev)
        for alg in Algorithm:
            if kind == "profile" and alg == Algorithm.NEEDLEMAN_WUNSCH:
                continue
            out.append((f"search {name} {alg.name}", "search.cu",
                        cs._search_call(kind, q, p, params, alg)[0]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+", type=pathlib.Path)
    ap.add_argument("--pairs", type=int, default=10, help="rounds of every side")
    ap.add_argument("--out", type=pathlib.Path, help="write every round's times here (JSON)")
    args = ap.parse_args()
    if args.pairs < 2:
        ap.error("--pairs must be at least 2 (quartiles)")
    jobs = [(i, c.resolve(), s) for i, c in enumerate(args.checkouts) for s in KERNELS]
    with ThreadPoolExecutor(len(jobs)) as ex:
        fns = dict(zip([(i, s) for i, _, s in jobs], ex.map(lambda j: build(*j), jobs)))
    sides = range(len(args.checkouts))
    results = {}
    for name, source, call in cases(torch.device("cuda", 0)):
        kernel = KERNELS[source]
        times = {i: [] for i in sides}
        want = None
        for rnd in range(args.pairs):
            for i in (sides if rnd % 2 == 0 else reversed(sides)):
                kernel._fn = fns[i, source]
                got = call()
                got = got if isinstance(got, tuple) else (got,)
                if want is None:
                    want = got
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"{name}: side {i} differs from side 0")
                times[i].append(cs.time_cuda(call)["median"])
        kernel._fn = None
        wins = sum(b < a for a, b in zip(times[0], times[len(sides) - 1]))
        summary = []
        for i in sides:
            q1, _, q3 = statistics.quantiles(times[i], n=4)
            summary.append(f"{i}: {statistics.median(times[i]):.3f} ms "
                           f"[{q1:.3f}, {q3:.3f}]")
        print(f"{name}: " + "; ".join(summary)
              + f"; last beat first in {wins} of {args.pairs}", flush=True)
        results[name] = times
    if args.out:
        args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
