"""Time the kernels of several checkouts of the port in one process,
interleaved.

    python3 scripts/torch_kernel_ab.py DIR_A DIR_B [--pairs 10] [--out FILE]
        [--kernels score.cu search.cu align.cu align_affine.cu banded_score.cu
                   banded_align.cu]

Each DIR is the root of a checkout holding ``versalignlib_tpu_torch/csrc``.
Its sources are built with the package's nvcc flags into ``build/ab/<i>/``
of this checkout and bound in place of the package's own build. Every
source runs through each checkout's own wrapper (``ops/cuda_score.py``,
``ops/cuda_search.py``, ``ops/cuda_align.py`` or ``ops/cuda_banded.py`` of
that checkout, loaded under a name of its own), so the sides may differ in
their C interface and in the layout they launch on: the score kernel
(``score.cu``) on 16384 pairs of 512 x 512 under ``chip_smoke``'s four
parameter sets, SW and NW; the one-vs-many kernel at each search path's launch shape
(``chip_smoke.search_launches``), SW and NW (the profile launch's SW with
coordinates); ``cuda_align.fill`` on 4096 pairs of 512 x 512 under the
four parameter sets, SW and NW in both flavors, and at each aligning search
path's align shape (``chip_smoke.search_align_pairs``), SW and NW,
canonical flavor. The banded kernels (``banded_score.cu``,
``banded_align.cu``) run through each side's own ``ops/cuda_banded.py`` at
the banded models' launch (1024 pairs of 16 kbp, band 512) under the four
parameter sets, SW and NW (the fill in the canonical flavor). Each round times every side once (CUDA-event median of 7
after a warm-up, wrapper included), the order reversed every other round,
and every side's outputs must equal the first side's. Prints one line per
case: each side's median over the rounds and its quartiles, and in how
many rounds the last side beat the first. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
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
from versalignlib_tpu_torch.ops import _build  # noqa: E402
from versalignlib_tpu_torch.types import Algorithm, TieBreak  # noqa: E402

#: The sources, each with its wrapper module and the name of its kernel in
#: it.
SOURCES = {"score.cu": ("cuda_score", "SCORE_KERNEL"),
       "search.cu": ("cuda_search", "SEARCH_KERNEL"),
       "align.cu": ("cuda_align", "ALIGN_KERNEL"),
       "align_affine.cu": ("cuda_align", "AFFINE_KERNEL"),
       "banded_score.cu": ("cuda_banded", "BANDED_SCORE_KERNEL"),
       "banded_align.cu": ("cuda_banded", "BANDED_ALIGN_KERNEL")}
FILLS = ("align.cu", "align_affine.cu")
BANDED = ("banded_score.cu", "banded_align.cu")


def own_wrapper(side: int, checkout: pathlib.Path, module: str):
    """The checkout's own ``ops/<module>.py``, loaded as a module of its
    own (it imports the rest of the package from this checkout)."""
    path = checkout / "versalignlib_tpu_torch" / "ops" / f"{module}.py"
    spec = importlib.util.spec_from_file_location(f"_ab_{module}_{side}", path)
    loaded = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loaded)
    return loaded


def build(side: int, checkout: pathlib.Path, source: str, kernel):
    """nvcc of one checkout's source; returns its C entry, bound with the
    argument types of ``kernel`` (the ``CudaKernel`` that will launch it)."""
    out_dir = _build.BUILD_DIR / "ab" / str(side)
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / source.replace(".cu", ".so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
           str(checkout / "versalignlib_tpu_torch" / "csrc" / source)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(str(lib)), kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    return fn


def cases(dev, sources, wrappers) -> list[tuple[str, str, object]]:
    """(name, source, call) for every timed case of ``sources``; call(i)
    runs side i; ``wrappers[i]`` maps a wrapper module's name to side i's."""
    rng = np.random.default_rng(0)
    out = []
    sets = cs._param_sets()
    if "score.cu" in sources:
        for pname, params in sets.items():
            r = torch.from_numpy(cs.codes_for(params, rng, cs.SCORE_PAIRS, cs.LENGTH)).to(dev)
            f = torch.from_numpy(cs.codes_for(params, rng, cs.SCORE_PAIRS, cs.LENGTH)).to(dev)
            for alg in Algorithm:
                out.append((f"score {pname} {alg.name}", "score.cu",
                            lambda i, r=r, f=f, p=params, a=alg:
                            wrappers[i]["cuda_score"].score_batch_device(r, f, p, a)))
    fills = [(f"{pname} {cs.ALIGN_PAIRS}x{cs.LENGTH}x{cs.LENGTH}", params,
              cs.codes_for(params, rng, cs.ALIGN_PAIRS, cs.LENGTH),
              cs.codes_for(params, rng, cs.ALIGN_PAIRS, cs.LENGTH), tuple(TieBreak))
             for pname, params in sets.items() if cs._fill_source(params) in sources]
    if "search.cu" in sources or set(FILLS) & set(sources):
        data = cs.make_search_data(rng)
    if "search.cu" in sources:
        for name, (params, queries, pool, kind) in cs.search_launches(data).items():
            q = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
            p = torch.from_numpy(np.ascontiguousarray(pool)).to(dev)
            for alg in Algorithm:
                if kind == "profile":
                    coords = alg == Algorithm.SMITH_WATERMAN
                    call = (lambda i, q=q, p=p, pr=params, a=alg, c=coords:
                            wrappers[i]["cuda_search"].pssm_scores_device(q, p, pr, a, c))
                else:
                    call = (lambda i, q=q, p=p, pr=params, a=alg:
                            wrappers[i]["cuda_search"].cross_scores_device(q, p, pr, a))
                out.append((f"search {name} {alg.name}", "search.cu", call))
    if set(FILLS) & set(sources):
        for name, (params, r_np, f_np) in cs.search_align_pairs(data).items():
            (b, m), n = r_np.shape, f_np.shape[1]
            fills.append((f"{name} {b}x{m}x{n}", params, r_np, f_np, (TieBreak.DIAG_UP_LEFT,)))
    if set(BANDED) & set(sources):
        out += banded_cases(dev, sources, wrappers, rng)
    for label, params, r_np, f_np, ties in fills:
        source = cs._fill_source(params)
        if source not in sources:
            continue
        r = torch.from_numpy(np.ascontiguousarray(r_np)).to(dev)
        f = torch.from_numpy(np.ascontiguousarray(f_np)).to(dev)
        for tie in ties:
            mrp = torch.from_numpy(
                wrappers[0]["cuda_align"].last_valid_pos(r_np, tie, params.matrix)).to(dev)
            for alg in Algorithm:
                out.append((f"fill {label} {alg.name} {tie.name}", source,
                            lambda i, r=r, f=f, mrp=mrp, p=params, a=alg, t=tie:
                            tuple(x for x in wrappers[i]["cuda_align"].fill(r, f, mrp, p, a, t)
                                  if x is not None)))
    return out


def banded_cases(dev, sources, wrappers, rng) -> list[tuple[str, str, object]]:
    """The banded kernels at the models' launch (``chip_smoke``: 1024 HiFi-like
    pairs of 16 kbp, band 512) under the four parameter sets, SW and NW:
    ``cuda_banded.score`` on the reads padded to the score tile, and
    ``cuda_banded.fill`` in the canonical flavor."""
    genome = cs.make_genome(rng)[1]
    reads, refs = cs.make_banded_pairs(rng, genome)
    out = []
    for pname, params in cs._param_sets().items():
        for source in BANDED:
            if source not in sources:
                continue
            score = source == "banded_score.cu"
            r, f, offs = cs._banded_inputs(reads, refs, cs.BAND, cs.BAND_TILE if score else None,
                                           dev)
            tie = TieBreak.DIAG_UP_LEFT
            mrp = torch.from_numpy(
                wrappers[0]["cuda_align"].last_valid_pos(reads, tie, params.matrix)).to(dev)
            for alg in Algorithm:
                name = f"{source} {pname} {r.shape[0]}x{r.shape[1]}x{f.shape[1]} band {cs.BAND}"
                if score:
                    call = (lambda i, r=r, f=f, o=offs, p=params, a=alg:
                            wrappers[i]["cuda_banded"].score(r, f, o, p, a, cs.BAND))
                else:
                    call = (lambda i, r=r, f=f, o=offs, m=mrp, p=params, a=alg:
                            tuple(x for x in wrappers[i]["cuda_banded"].fill(
                                r, f, o, m, p, a, tie, cs.BAND) if x is not None))
                out.append((f"{name} {alg.name}", source, call))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+", type=pathlib.Path)
    ap.add_argument("--pairs", type=int, default=10, help="rounds of every side")
    ap.add_argument("--out", type=pathlib.Path, help="write every round's times here (JSON)")
    ap.add_argument("--kernels", nargs="+", default=[*SOURCES], choices=[*SOURCES],
                    help="the sources to time")
    args = ap.parse_args()
    if args.pairs < 2:
        ap.error("--pairs must be at least 2 (quartiles)")
    checkouts = [c.resolve() for c in args.checkouts]
    modules = {SOURCES[s][0] for s in args.kernels}
    if set(BANDED) & set(args.kernels):
        modules.add("cuda_align")   # last_valid_pos
    wrappers = [{mod: own_wrapper(i, c, mod) for mod in modules}
                for i, c in enumerate(checkouts)]

    def kernel_of(i, source):
        mod, kernel = SOURCES[source]
        return getattr(wrappers[i][mod], kernel)

    jobs = [(i, c, s, kernel_of(i, s)) for i, c in enumerate(checkouts) for s in args.kernels]
    with ThreadPoolExecutor(len(jobs)) as ex:
        fns = dict(zip([(i, s) for i, _, s, _ in jobs], ex.map(lambda j: build(*j), jobs)))
    for (i, source), fn in fns.items():
        kernel_of(i, source)._fn = fn
    sides = range(len(checkouts))
    results = {}
    for name, source, call in cases(torch.device("cuda", 0), args.kernels, wrappers):
        times = {i: [] for i in sides}
        want = None
        for rnd in range(args.pairs):
            for i in (sides if rnd % 2 == 0 else reversed(sides)):
                got = call(i)
                got = got if isinstance(got, tuple) else (got,)
                if want is None:
                    want = got
                if len(got) != len(want) or \
                        not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"{name}: side {i} differs from side 0")
                times[i].append(cs.time_cuda(lambda: call(i))["median"])
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
