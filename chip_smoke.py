"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero before a result is printed):

1. card: name and power limit, torch and CUDA versions; build every kernel
   of ``versalignlib_tpu_torch/csrc`` (one nvcc per source, in parallel);
2. each kernel against its plain PyTorch version on the card, at the main
   path's launch shapes and an odd ref length, with ``==`` (tolerance 0:
   every output is an integer);
3. the main path through the entry points a user calls:
   ``AlignmentEngine().score_alignments`` on 16384 pairs of 512 x 512 and
   ``compute_alignments`` on 4096 pairs of 512 x 512 (``raw=True``) and on
   256 of them (``raw=False``), SW and NW, checked field by field on 64
   random pairs against the port's CPU path; each kernel's launch counter is
   read around this phase alone;
4. times with CUDA events after a warm-up, the median of 7 runs with min and
   max: each kernel, its plain version, and the split of
   ``compute_alignments`` into device fill, device-to-host copy and host
   decode;
5. one ``{"kernels": [...]}`` line, the nvidia-smi line, and the last line
   ``{"ok": true, "device": {...}}``.

Inputs are random A/C/G/T with about 2% N and random trailing padding, made
with numpy from ``--seed``. Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

#: H100 SXM peaks used for the bounds: HBM3 at 3.35 TB/s (NVIDIA data
#: sheet), and int32 on the CUDA cores: 64 INT32 lanes per SM (Hopper
#: architecture white paper) x 132 SMs x 1.98 GHz boost = 16.7 Tops/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

#: int32 operations per DP cell, counted from the recurrence each kernel
#: computes. Score: substitution (compare, select), three adds, two maxes,
#: the SW clamp and the running best (SW 8; NW 7: no clamp, best once a
#: row). Align adds the move priority (two ors), its extraction and packing
#: (and, shift, or), the cleared value (and) and the strict argmax (compare,
#: two selects): SW 16, NW 15.
OPS_PER_CELL = {("score", "sw"): 8, ("score", "nw"): 7,
                ("align", "sw"): 16, ("align", "nw"): 15}

REPS = 7


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_codes(rng, n: int, length: int) -> np.ndarray:
    """A/C/G/T codes with ~2% N (5) and random trailing padding (0), as
    tests/conftest.py:random_codes makes them."""
    codes = rng.integers(1, 5, size=(n, length)).astype(np.uint8)
    codes = np.where(rng.random((n, length)) < 0.02, np.uint8(5), codes)
    lens = rng.integers(1, length + 1, size=n)
    return np.where(np.arange(length)[None, :] < lens[:, None], codes,
                    np.uint8(0)).astype(np.uint8)


def time_cuda(fn, reps: int = REPS) -> dict:
    """Median, min and max ms of ``fn`` by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times), "k": reps}


def time_host(fn, reps: int = REPS) -> dict:
    """Median, min and max ms of ``fn`` by the host clock, synchronised."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times), "k": reps}


def bound(kind: str, alg: str, b: int, m: int, n: int, nbytes: int) -> tuple[float, str]:
    """Least time in ms for the work, and which of bytes or operations sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = OPS_PER_CELL[(kind, alg)] * b * m * n / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """Raise unless equal; returns the max absolute difference (0)."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max().item()) if got.numel() else 0
    if err:
        bad = int((got != want).sum().item())
        raise AssertionError(f"{name}: {bad} of {got.numel()} values differ "
                             f"(max abs diff {err})")
    return err


def phase_kernels_vs_plain(rng, dev) -> dict:
    from versalignlib_tpu_torch.ops import cuda_align, plain
    from versalignlib_tpu_torch.ops.cuda_score import score_batch_device
    from versalignlib_tpu_torch.params import DEFAULT_PARAMETERS as P
    from versalignlib_tpu_torch.types import Algorithm, TieBreak

    err = {"score": 0, "align": 0}
    # The main path's launch shapes (16384 scores; alignments in one chunk of
    # 4096 and one of 256, all 512 x 512), and an odd ref length.
    for b, m, n in ((16384, 512, 512), (4096, 150, 509)):
        r = torch.from_numpy(random_codes(rng, b, m)).to(dev)
        f = torch.from_numpy(random_codes(rng, b, n)).to(dev)
        for alg in Algorithm:
            got = score_batch_device(r, f, P, alg)
            want = plain.score_batch(r, f, P, alg)
            err["score"] = max(err["score"], check_equal(
                f"score {alg.name} {b}x{m}x{n}", got, want))
            log(f"[kernels] score.cu == plain  {alg.name:17s} B={b} {m}x{n}")
    for b, m, n in ((4096, 512, 512), (256, 512, 512), (1024, 150, 509)):
        r_np = random_codes(rng, b, m)
        r = torch.from_numpy(r_np).to(dev)
        f = torch.from_numpy(random_codes(rng, b, n)).to(dev)
        for tie in TieBreak:
            mrp = torch.from_numpy(cuda_align.last_valid_pos(r_np, tie)).to(dev)
            for alg in Algorithm:
                got = cuda_align.fill(r, f, mrp, P, alg, tie)
                want = plain.align_batch(r, f, mrp, P, alg, tie)
                for part, g, w in zip(("ptr", "aux", "hsel"), got, want):
                    if (g is None) != (w is None):
                        raise AssertionError(f"align {part}: one side is None")
                    if g is not None:
                        err["align"] = max(err["align"], check_equal(
                            f"align {part} {alg.name} {tie.name} {b}x{m}x{n}", g, w))
                log(f"[kernels] align.cu == plain  {alg.name:17s} {tie.name} "
                    f"B={b} {m}x{n} (ptr, aux, hsel)")
    torch.cuda.synchronize()
    return err


def _same_alignment(x, y) -> bool:
    return (x.read, x.ref, x.score, x.cigar, x.read_start, x.read_end,
            x.ref_start, x.ref_end, x.buffer_start, x.buffer_end) == \
           (y.read, y.ref, y.score, y.cigar, y.read_start, y.read_end,
            y.ref_start, y.ref_end, y.buffer_start, y.buffer_end)


def phase_main_path(rng) -> dict:
    from versalignlib_tpu_torch import Algorithm, AlignmentEngine
    from versalignlib_tpu_torch.ops.cuda_align import ALIGN_KERNEL
    from versalignlib_tpu_torch.ops.cuda_score import SCORE_KERNEL

    engine = AlignmentEngine(backend="auto")
    cpu = AlignmentEngine(device="cpu")
    if engine.device.type != "cuda":
        raise AssertionError(f"default engine resolved to {engine.device}")
    m = n = 512
    score_r = random_codes(rng, 16384, m)
    score_f = random_codes(rng, 16384, n)
    align_r = random_codes(rng, 4096, m)
    align_f = random_codes(rng, 4096, n)
    pick = np.sort(rng.choice(4096, size=64, replace=False))
    pick_obj = np.sort(rng.choice(256, size=64, replace=False))

    SCORE_KERNEL.launches = 0
    ALIGN_KERNEL.launches = 0
    t0 = time.perf_counter()
    scores, raws, objs = {}, {}, {}
    for alg in Algorithm:
        scores[alg] = engine.score_alignments(alg, score_r, score_f)
        raws[alg] = engine.compute_alignments(alg, align_r, align_f, raw=True)
        objs[alg] = engine.compute_alignments(alg, align_r[:256], align_f[:256])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"score": SCORE_KERNEL.launches, "align": ALIGN_KERNEL.launches}
    log(f"[main] launches during the main path: {launches} ({wall:.2f} s)")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the main path never launched the {name} kernel")

    for alg in Algorithm:
        s = scores[alg]
        if s.shape != (16384,) or s.dtype != np.int32 or (s < 0).any():
            raise AssertionError(f"scores {alg.name}: bad shape, type or sign")
        want = cpu.score_alignments(alg, score_r[pick], score_f[pick])
        if not (s[pick] == want).all():
            raise AssertionError(f"scores {alg.name} differ from the CPU path")
        batch = raws[alg]
        want_raw = cpu.compute_alignments(alg, align_r[pick], align_f[pick], raw=True)
        for col in ("meta", "cigar", "read_gapped", "ref_gapped"):
            if not np.array_equal(getattr(batch, col)[pick], getattr(want_raw, col)):
                raise AssertionError(f"raw {col} {alg.name} differs from the CPU path")
        want_obj = cpu.compute_alignments(alg, align_r[:256][pick_obj], align_f[:256][pick_obj])
        got_obj = [objs[alg][k] for k in pick_obj]
        if len(objs[alg]) != 256 or not all(map(_same_alignment, got_obj, want_obj)):
            raise AssertionError(f"alignments {alg.name} differ from the CPU path")
        if not (batch.scores[:256] == np.array([a.score for a in objs[alg]])).all():
            raise AssertionError(f"raw and object scores {alg.name} disagree")
        log(f"[main] {alg.name}: scores B=16384, raw B=4096, objects B=256 "
            f"== CPU path on 64 pairs each")
    return {"launches": launches, "wall_s": wall}


def phase_times(rng, dev, launches: dict, errs: dict) -> list[dict]:
    from versalignlib_tpu_torch import AlignmentEngine
    from versalignlib_tpu_torch.native import decode_batch_native
    from versalignlib_tpu_torch.ops import cuda_align, plain
    from versalignlib_tpu_torch.ops.cuda_score import score_batch_device
    from versalignlib_tpu_torch.params import DEFAULT_PARAMETERS as P
    from versalignlib_tpu_torch.types import Algorithm, TieBreak

    m = n = 512
    entries = []

    b = 16384
    r = torch.from_numpy(random_codes(rng, b, m)).to(dev)
    f = torch.from_numpy(random_codes(rng, b, n)).to(dev)
    t = {}
    for alg, key in ((Algorithm.SMITH_WATERMAN, "sw"), (Algorithm.NEEDLEMAN_WUNSCH, "nw")):
        k = time_cuda(lambda: score_batch_device(r, f, P, alg))
        pl = time_cuda(lambda: plain.score_batch(r, f, P, alg), reps=5)
        bd, by = bound("score", key, b, m, n, b * (m + n) + 4 * b)
        t[key] = (k, pl, bd, by)
        log(f"[times] score.cu {key} B={b} {m}x{n}: {k['median']:.3f} ms "
            f"(min {k['min']:.3f}, max {k['max']:.3f}), "
            f"{b * m * n / k['median'] / 1e6:.1f} GCUPS; plain {pl['median']:.1f} ms; "
            f"bound {bd:.3f} ms ({by})")
    entries.append(_entry("score", "versalignlib_tpu_torch/csrc/score.cu",
                          "versalignlib_tpu/ops/pallas_score.py:219",
                          launches["score"], errs["score"], (b, m, n), t))

    b = 4096
    r_np = random_codes(rng, b, m)
    f_np = random_codes(rng, b, n)
    r = torch.from_numpy(r_np).to(dev)
    f = torch.from_numpy(f_np).to(dev)
    tie = TieBreak.DIAG_UP_LEFT
    mrp_np = cuda_align.last_valid_pos(r_np, tie)
    mrp = torch.from_numpy(mrp_np).to(dev)
    nc = -(-n // cuda_align.PACK)
    engine = AlignmentEngine()
    t = {}
    split = {}
    for alg, key in ((Algorithm.SMITH_WATERMAN, "sw"), (Algorithm.NEEDLEMAN_WUNSCH, "nw")):
        k = time_cuda(lambda: cuda_align.fill(r, f, mrp, P, alg, tie))
        pl = time_cuda(lambda: plain.align_batch(r, f, mrp, P, alg, tie), reps=5)
        nbytes = b * (m + n) + 4 * b + 4 * b * m * nc + 16 * b + (0 if key == "sw" else 4 * b * (n + 1))
        bd, by = bound("align", key, b, m, n, nbytes)
        t[key] = (k, pl, bd, by)
        log(f"[times] align.cu {key} B={b} {m}x{n}: {k['median']:.3f} ms "
            f"(min {k['min']:.3f}, max {k['max']:.3f}), "
            f"{b * m * n / k['median'] / 1e6:.1f} GCUPS; plain {pl['median']:.1f} ms; "
            f"bound {bd:.3f} ms ({by})")

        out = cuda_align.fill(r, f, mrp, P, alg, tie)
        host = [None if x is None else torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                for x in out]

        def copy():
            for h, x in zip(host, out):
                if x is not None:
                    h.copy_(x, non_blocking=True)

        d2h = time_cuda(copy)
        start_r, start_f, sc = cuda_align.start_cells(
            host[1].numpy(), None if host[2] is None else host[2].numpy(),
            mrp_np, f_np, tie, key == "sw")
        decode = time_host(lambda: decode_batch_native(
            (host[0].numpy(), cuda_align.PACK), r_np, f_np, start_r, start_f,
            P, alg, sc, raw=True))
        e2e = time_host(lambda: engine.compute_alignments(alg, r_np, f_np, raw=True))
        split[key] = {"fill_ms": k["median"], "d2h_ms": d2h["median"],
                      "d2h_GBps": 4 * b * m * nc / d2h["median"] / 1e6,
                      "decode_ms": decode["median"], "e2e_ms": e2e["median"],
                      "e2e_min_ms": e2e["min"], "e2e_max_ms": e2e["max"]}
        log(f"[times] compute_alignments(raw=True) {key} B={b} {m}x{n}: "
            + json.dumps({kk: round(v, 3) for kk, v in split[key].items()}))
    entries.append(_entry("align", "versalignlib_tpu_torch/csrc/align.cu",
                          "versalignlib_tpu/ops/pallas_align.py:90",
                          launches["align"], errs["align"], (b, m, n), t))
    entries[-1]["compute_alignments_split"] = split
    return entries


def _entry(name, source, replaces, launches, err, shape, t) -> dict:
    b, m, n = shape
    (k, pl, bd, by), (k_nw, pl_nw, bd_nw, _) = t["sw"], t["nw"]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "tolerance": 0,
        "ms": k["median"], "plain_ms": pl["median"], "bound_ms": bd,
        "bound_by": by, "library_ms": None,
        "shape": [b, m, n], "algorithm": "SW", "ms_min": k["min"],
        "ms_max": k["max"], "gcups": b * m * n / k["median"] / 1e6,
        "nw": {"ms": k_nw["median"], "ms_min": k_nw["min"], "ms_max": k_nw["max"],
               "plain_ms": pl_nw["median"], "bound_ms": bd_nw,
               "gcups": b * m * n / k_nw["median"] / 1e6},
        "matches_plain": True,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from versalignlib_tpu_torch.ops import _build

    smi = nvidia_smi_line()
    log(f"[card] {smi}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    seconds = _build.build_all()
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in seconds.items()})}; "
        f"total {time.perf_counter() - t0:.2f} s")
    for src in seconds:
        report = _build.library_path(src).with_suffix(".log").read_text()
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")

    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda", 0)
    errs = phase_kernels_vs_plain(rng, dev)
    main_path = phase_main_path(rng)
    kernels = phase_times(rng, dev, main_path["launches"], errs)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
