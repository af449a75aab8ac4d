#!/usr/bin/env python
"""Time the single-device search entry points and the bulk score loop of
several checkouts of the port on one CUDA card, interleaved.

    python3 scripts/torch_entry_ab.py DIR_A DIR_B [--rounds 1] [--reps 5]
        [--seed 0] [--out FILE]

Each DIR is the root of a checkout of the repo. Every run is a process of
its own that imports that checkout's package (the package name is the same
on every side), builds its kernels (a library already built by another
side under the same digest is copied, not rebuilt), makes chip_smoke's
search data from ``--seed`` with this checkout's ``chip_smoke.py``, and
times, after one call off the clock: ``map_reads`` (2048 reads of 150 bp
vs 512 x 1536 bp, DNA default and BWA-MEM affine), ``score_matrix`` on the
same reads and panel, ``map_to_reference`` (256 reads vs the 4.6 Mbp
genome), ``translated_search`` with alignments (1024 reads vs 2048
proteins), and the staged score loop of that checkout's
``scripts/torch_bulk_align.py`` (131072 pairs of 512 x 512 in chunks of
16384, the synthetic chunks drawn before the clock starts). Each wall is
the host's clock around one call, the card synchronised before and after;
``--reps`` walls a call. A round runs the sides in order and then in
reverse (A B B A); the results of every side must equal the first side's.
Prints one line per entry point with each side's median over all its walls
and their range, the card's name and power limit, and one JSON object as
the last line (``--out`` also writes it).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
BULK_PAIRS, BULK_CHUNK = 131072, 16384


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _digest(x) -> str:
    """A digest of a result: its arrays' bytes and its alignments."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for value in (vars(x).values() if hasattr(x, "__dict__") else [x]):
        if isinstance(value, np.ndarray):
            h.update(value.tobytes())
        elif isinstance(value, list):
            h.update(repr(value).encode())
    return h.hexdigest()[:16]


def worker(tree: pathlib.Path, seed: int, reps: int) -> dict:
    """One side's walls, in its own process."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import versalignlib_tpu_torch as pkg
    from versalignlib_tpu_torch import (map_reads, map_to_reference, score_matrix,
                                        translated_search)
    from versalignlib_tpu_torch.ops import _build

    if not pathlib.Path(pkg.__file__).resolve().is_relative_to(tree):
        raise AssertionError(f"imported {pkg.__file__}, not the package of {tree}")
    built = _build.build_all()
    cs = _load("chip_smoke", ROOT / "chip_smoke.py")
    data = cs.make_search_data(np.random.default_rng(seed))
    sets = cs._param_sets()
    bulk = _load("torch_bulk_align", tree / "scripts" / "torch_bulk_align.py")
    chunks = [bulk.synthetic_chunk(seed, c, BULK_CHUNK, cs.LENGTH)
              for c in range(BULK_PAIRS // BULK_CHUNK)]
    bulk.synthetic_chunk = lambda s, c, n, length: chunks[c]
    scratch = pathlib.Path(tempfile.mkdtemp(prefix="entry_ab_"))
    runs = iter(range(1 << 30))

    def bulk_scores():
        d = scratch / f"ck{next(runs)}"
        with contextlib.redirect_stdout(io.StringIO()):
            bulk.main(["--pairs", str(BULK_PAIRS), "--len", str(cs.LENGTH), "--chunk",
                       str(BULK_CHUNK), "--ckpt", str(d), "--seed", str(seed)])
        return np.load(d / "scores.npy")

    reads, panel = data["map_reads"][:2]
    rm_reads, genome = data["map_to_reference"][:2]
    tr_reads, proteins = data["translated_search"][:2]
    calls = {
        "map_reads dna_default": lambda: map_reads(reads, panel, sets["dna_default"]),
        "map_reads dna_affine_bwamem": lambda: map_reads(reads, panel,
                                                         sets["dna_affine_bwamem"]),
        "score_matrix": lambda: score_matrix(reads, panel),
        "map_to_reference": lambda: map_to_reference(rm_reads, genome),
        "translated_search": lambda: translated_search(tr_reads, proteins, alignments=True),
        "torch_bulk_align staged score": bulk_scores,
    }
    walls, digests = {}, {}
    try:
        for name, fn in calls.items():
            digests[name] = _digest(fn())
            walls[name] = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[name].append(1e3 * (time.perf_counter() - t0))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return {"tree": str(tree), "walls_ms": walls, "digests": digests, "build_s": built}


def _share_builds(src: pathlib.Path, trees: list[pathlib.Path]) -> None:
    """Copy src's built kernels into the other trees' build directories; a
    library's name carries the digest of its sources and flags, so a side
    loads only what it would have built itself."""
    built = src / "versalignlib_tpu_torch" / "build"
    for tree in trees:
        dst = tree / "versalignlib_tpu_torch" / "build"
        if dst == built:
            continue
        dst.mkdir(parents=True, exist_ok=True)
        for lib in built.glob("*.so"):
            if not (dst / lib.name).exists():
                shutil.copy2(lib, dst / lib.name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dirs", nargs="*", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=pathlib.Path)
    ap.add_argument("--worker", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve(), args.seed, args.reps)))
        return 0
    if len(args.dirs) < 2:
        ap.error("give at least two checkouts")
    import torch

    if not torch.cuda.is_available():
        print("torch_entry_ab: no CUDA card", file=sys.stderr)
        return 1
    trees = [d.resolve() for d in args.dirs]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    for tree in trees:
        _share_builds(tree, trees)
    results: dict[str, list[dict]] = {str(t): [] for t in trees}
    for _ in range(args.rounds):
        for tree in trees + trees[::-1]:
            t0 = time.perf_counter()
            done = subprocess.run([sys.executable, __file__, "--worker", str(tree), "--seed",
                                   str(args.seed), "--reps", str(args.reps)],
                                  capture_output=True, text=True, timeout=900)
            if done.returncode != 0:
                print(done.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"the run of {tree} exited {done.returncode}")
            run = json.loads(done.stdout.strip().splitlines()[-1])
            results[str(tree)].append(run)
            print(f"{tree}: {time.perf_counter() - t0:.1f} s with the process's start; "
                  f"builds {json.dumps(run['build_s'])}", flush=True)
            _share_builds(tree, trees)
    first = results[str(trees[0])][0]["digests"]
    for tree, runs in results.items():
        for run in runs:
            if run["digests"] != first:
                raise SystemExit(f"{tree}'s results differ from {trees[0]}'s: "
                                 f"{run['digests']} vs {first}")
    summary = {"card": smi, "reps": args.reps, "rounds": args.rounds, "entries": {}}
    for name in first:
        row = {}
        for tree, runs in results.items():
            walls = [w for run in runs for w in run["walls_ms"][name]]
            row[tree] = {"median_ms": statistics.median(walls), "min_ms": min(walls),
                         "max_ms": max(walls), "walls_ms": walls}
        summary["entries"][name] = row
        print(f"{name}: " + "; ".join(
            f"{pathlib.Path(t).name or t} {r['median_ms']:.3f} ms "
            f"[{r['min_ms']:.3f}, {r['max_ms']:.3f}]" for t, r in row.items()), flush=True)
    print(smi)
    if args.out:
        args.out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
