"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

The path is ``AlignmentEngine.score_alignments`` and ``compute_alignments``
under four parameter sets (``_param_sets``): the reference's default DNA
scoring, BWA-MEM's affine DNA gaps, and BLOSUM62 protein scoring with
BLASTP's affine gaps or with linear gaps.

Phases (any failure exits non-zero before a result is printed):

1. card: name and power limit, torch and CUDA versions; build every kernel
   of ``versalignlib_tpu_torch/csrc`` (one nvcc per source, in parallel) and
   print each instantiation's registers and spills;
2. every branch of every kernel against its plain PyTorch version on the
   card, with ``==`` (tolerance 0: every output is an integer): at the main
   path's launch shapes (scores 16384 x 512 x 512; fills 4096 and 256 x 512
   x 512), at an odd shape whose ref length leaves a partial pointer word
   (150 x 509), and under a random 200 x 200 matrix, too large for shared
   memory, at a small shape;
3. the main path through the entry points a user calls, once per parameter
   set: ``AlignmentEngine(params, tie=...)`` scores 16384 pairs of 512 x 512
   and aligns 4096 of them (``raw=True``) and 256 (``raw=False``), SW and NW,
   both tie-break flavors, checked field by field on 64 random pairs against
   the port's CPU path. The launch counts are set to 0 just before each
   set's run and read just after: the kernels of its path must have
   launched, and the other fill kernel must not;
4. times with CUDA events after a warm-up, the median of 7 runs with min and
   max, for each branch: the kernel, its plain version, the bound, and the
   split of ``compute_alignments(raw=True)`` into device fill,
   device-to-host copy and host decode;
5. one ``{"kernels": [...]}`` line, the nvidia-smi line, and the last line
   ``{"ok": true, "device": {...}}``.

DNA inputs are random A/C/G/T with about 2% N, protein inputs the 20
standard residues with about 1% X, both with random trailing padding, made
with numpy from ``--seed``. Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import json
import re
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

#: int32 operations per DP cell, (SW, NW), counted from the recurrence each
#: branch computes, not from the instructions a kernel happens to issue.
#: Linear gaps, DNA: score 8 / 7 and fill 16 / 15 (the move priority, its
#: packing and the cleared value on top of the score's cell), the counts
#: the first bounds used. Each other branch adds only what its recurrence
#: adds:
#: - matrix: substitution is an add and a lookup, as the DNA compare and
#:   select are two, so a matrix branch counts as its DNA branch;
#: - affine: F = max(up + open, F_up) + gap and E alike are three
#:   operations each where a linear gap arm is one add (+4), and in the
#:   fills each extend bit is a compare, a select and an or (+6).
OPS_PER_CELL = {
    ("score", "linear"): (8, 7), ("score", "affine"): (12, 11),
    ("align", "linear"): (16, 15), ("align", "affine"): (26, 25),
}

REPS = 7
PLAIN_REPS = 3

#: The main path's shapes: scores on SCORE_PAIRS pairs of LENGTH x LENGTH,
#: raw alignments on ALIGN_PAIRS pairs and ``Alignment`` objects on
#: OBJECT_PAIRS of them, CHECK_PAIRS of each checked against the CPU path;
#: ODD_SHAPE leaves a partial pointer word; BIG_MATRIX_SHAPE is where the
#: 200 x 200 matrix runs.
LENGTH = 512
SCORE_PAIRS, ALIGN_PAIRS, OBJECT_PAIRS, CHECK_PAIRS = 16384, 4096, 256, 64
ODD_SHAPE = (1024, 150, 509)
BIG_MATRIX_SHAPE = (512, 64, 77)


def _param_sets() -> dict:
    from versalignlib_tpu_torch.alphabet import blosum62
    from versalignlib_tpu_torch.params import DEFAULT_PARAMETERS, AlignmentParameters

    return {
        # The reference program's default scoring (CustomParameters.h:55-58).
        "dna_default": DEFAULT_PARAMETERS,
        # BWA-MEM's defaults -A1 -B4 -O6 -E1 (bwa.1 man page); a gap of
        # length L costs gap_open + L * score_gap.
        "dna_affine_bwamem": AlignmentParameters(
            score_match=1, score_mismatch=-4, score_gap_read=-1, score_gap_ref=-1,
            gap_open_read=-6, gap_open_ref=-6),
        # BLASTP's defaults: BLOSUM62, gap existence 11, extension 1.
        "protein_blosum62_affine": AlignmentParameters(
            score_gap_read=-1, score_gap_ref=-1, gap_open_read=-11,
            gap_open_ref=-11, matrix=blosum62()),
        # The JAX package's own protein setting (tests/test_matrix.py:166).
        "protein_blosum62_linear": AlignmentParameters(
            score_gap_read=-11, score_gap_ref=-11, matrix=blosum62()),
    }


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _pad_tail(rng, codes: np.ndarray) -> np.ndarray:
    n, length = codes.shape
    lens = rng.integers(1, length + 1, size=n)
    return np.where(np.arange(length)[None, :] < lens[:, None], codes,
                    np.uint8(0)).astype(np.uint8)


def random_codes(rng, n: int, length: int) -> np.ndarray:
    """A/C/G/T codes with ~2% N (5) and random trailing padding (0), as
    tests/conftest.py:random_codes makes them."""
    codes = rng.integers(1, 5, size=(n, length)).astype(np.uint8)
    codes = np.where(rng.random((n, length)) < 0.02, np.uint8(5), codes)
    return _pad_tail(rng, codes)


def random_protein(rng, n: int, length: int) -> np.ndarray:
    """The 20 standard residues of ``PROTEIN_ALPHABET`` (codes 1..20) with
    ~1% X (23) and random trailing padding (0)."""
    codes = rng.integers(1, 21, size=(n, length)).astype(np.uint8)
    codes = np.where(rng.random((n, length)) < 0.01, np.uint8(23), codes)
    return _pad_tail(rng, codes)


def codes_for(params, rng, n: int, length: int) -> np.ndarray:
    return (random_codes if params.matrix is None else random_protein)(rng, n, length)


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


def register_report(log_text: str) -> list[str]:
    """One line per kernel instantiation from ``nvcc -Xptxas -v``: its
    template arguments (kLocal, kCanon or kAffine, kMat), registers and
    spill bytes."""
    out, kernel, spill = [], "?", ""
    for line in log_text.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[-1].strip()
            found = re.search(r"([a-z]+_kernel)I(.*)EEvNS", name)
            kernel = (f"{found.group(1)}<{','.join(re.findall(r'L[bi](\d+)E', found.group(2) + 'E'))}>"
                      if found else name)
        elif "spill stores" in line:
            spill = line.split(",", 1)[-1].strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{kernel}: {regs.group(1) if regs else '?'} registers, {spill}")
    return out


def branch_of(params) -> tuple[str, str]:
    return ("affine" if params.affine else "linear",
            "dna" if params.matrix is None else "matrix")


def bound(kind: str, params, alg: str, b: int, m: int, n: int,
          nbytes: int) -> tuple[float, str]:
    """Least time in ms for the work, and which of bytes or operations sets it."""
    sw, nw = OPS_PER_CELL[kind, branch_of(params)[0]]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (sw if alg == "sw" else nw) * b * m * n / INT32_OPS_PER_S
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


def _plain_fill(params):
    """The plain version of the parameters' fill kernel."""
    from versalignlib_tpu_torch.ops import plain

    return plain.align_affine_batch if params.affine else plain.align_batch


def _kernel_name(kind: str, params) -> str:
    return f"{kind}[{','.join(branch_of(params))}]"


def _random_matrix(rng, s: int) -> tuple:
    """An asymmetric S x S matrix with zero padding row and column and one
    interior all-zero code (score-invalid, as N is for DNA)."""
    m = rng.integers(-4, 5, size=(s, s))
    np.fill_diagonal(m, rng.integers(3, 7, size=s))
    m[0, :] = m[:, 0] = 0
    m[4, :] = m[:, 4] = 0
    return tuple(tuple(int(v) for v in row) for row in m)


def phase_kernels_vs_plain(rng, dev) -> dict:
    """Each branch against its plain version; returns the max abs error per
    kernel name (0)."""
    from versalignlib_tpu_torch.ops import cuda_align, plain
    from versalignlib_tpu_torch.ops.cuda_score import score_batch_device
    from versalignlib_tpu_torch.params import AlignmentParameters
    from versalignlib_tpu_torch.types import Algorithm, TieBreak

    err: dict[str, int] = {}

    def run(name, params, score_shapes, fill_shapes, make):
        for b, m, n in score_shapes:
            r = torch.from_numpy(make(rng, b, m)).to(dev)
            f = torch.from_numpy(make(rng, b, n)).to(dev)
            key = _kernel_name("score", params)
            for alg in Algorithm:
                got = score_batch_device(r, f, params, alg)
                want = plain.score_batch(r, f, params, alg)
                err[key] = max(err.get(key, 0), check_equal(
                    f"{key} {name} {alg.name} {b}x{m}x{n}", got, want))
            log(f"[kernels] score.cu == plain  {name:24s} SW, NW  B={b} {m}x{n}")
        plain_fill = _plain_fill(params)
        key = _kernel_name("align", params)
        for b, m, n in fill_shapes:
            r_np = make(rng, b, m)
            r = torch.from_numpy(r_np).to(dev)
            f = torch.from_numpy(make(rng, b, n)).to(dev)
            for tie in TieBreak:
                mrp = torch.from_numpy(
                    cuda_align.last_valid_pos(r_np, tie, params.matrix)).to(dev)
                for alg in Algorithm:
                    got = cuda_align.fill(r, f, mrp, params, alg, tie)
                    want = plain_fill(r, f, mrp, params, alg, tie)
                    for part, g, w in zip(("ptr", "aux", "hsel"), got, want):
                        if (g is None) != (w is None):
                            raise AssertionError(f"{key} {part}: one side is None")
                        if g is not None:
                            err[key] = max(err.get(key, 0), check_equal(
                                f"{key} {part} {name} {alg.name} {tie.name} "
                                f"{b}x{m}x{n}", g, w))
            src = "align_affine.cu" if params.affine else "align.cu"
            log(f"[kernels] {src} == plain  {name:24s} SW, NW x both flavors "
                f"B={b} {m}x{n} (ptr, aux, hsel)")

    L = LENGTH
    for name, params in _param_sets().items():
        # The main path's launch shapes (scores; alignments in one chunk of
        # ALIGN_PAIRS and one of OBJECT_PAIRS), and an odd ref length.
        run(name, params, ((SCORE_PAIRS, L, L), ODD_SHAPE),
            ((ALIGN_PAIRS, L, L), (OBJECT_PAIRS, L, L), ODD_SHAPE),
            lambda g, b, length, p=params: codes_for(p, g, b, length))
    # A 200 x 200 matrix is 160 KB: the kernels read it from device memory.
    # Codes run past S, which must score 0 and count as invalid.
    big = _random_matrix(rng, 200)
    for name, params in (
            ("random_s200_linear", AlignmentParameters(
                score_gap_read=-3, score_gap_ref=-2, matrix=big)),
            ("random_s200_affine", AlignmentParameters(
                score_gap_read=-1, score_gap_ref=-2, gap_open_read=-3,
                gap_open_ref=-4, matrix=big))):
        run(name, params, (BIG_MATRIX_SHAPE,), (BIG_MATRIX_SHAPE,),
            lambda g, b, length: _pad_tail(g, g.integers(1, 210, size=(b, length)).astype(np.uint8)))
    torch.cuda.synchronize()
    return err


def _same_alignment(x, y) -> bool:
    return (x.read, x.ref, x.score, x.cigar, x.read_start, x.read_end,
            x.ref_start, x.ref_end, x.buffer_start, x.buffer_end) == \
           (y.read, y.ref, y.score, y.cigar, y.read_start, y.read_end,
            y.ref_start, y.ref_end, y.buffer_start, y.buffer_end)


def _main_path(name, params, rng) -> dict:
    """One parameter set through the engine, launch counts read around it
    alone, checked on 64 pairs against the CPU path."""
    from versalignlib_tpu_torch import Algorithm, AlignmentEngine, TieBreak
    from versalignlib_tpu_torch.ops.cuda_align import AFFINE_KERNEL, ALIGN_KERNEL
    from versalignlib_tpu_torch.ops.cuda_score import SCORE_KERNEL

    engines = {tie: AlignmentEngine(params, backend="auto", tie=tie) for tie in TieBreak}
    for engine in engines.values():
        if engine.device.type != "cuda":
            raise AssertionError(f"default engine resolved to {engine.device}")
    m = n = LENGTH
    nobj = OBJECT_PAIRS
    score_r = codes_for(params, rng, SCORE_PAIRS, m)
    score_f = codes_for(params, rng, SCORE_PAIRS, n)
    align_r = codes_for(params, rng, ALIGN_PAIRS, m)
    align_f = codes_for(params, rng, ALIGN_PAIRS, n)
    pick = np.sort(rng.choice(ALIGN_PAIRS, size=CHECK_PAIRS, replace=False))
    pick_obj = np.sort(rng.choice(nobj, size=CHECK_PAIRS, replace=False))

    kernels = {"score": SCORE_KERNEL, "align": ALIGN_KERNEL, "align_affine": AFFINE_KERNEL}
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    scores, raws, objs = {}, {}, {}
    for alg in Algorithm:
        scores[alg] = engines[TieBreak.DIAG_UP_LEFT].score_alignments(alg, score_r, score_f)
        for tie, engine in engines.items():
            raws[alg, tie] = engine.compute_alignments(alg, align_r, align_f, raw=True)
            objs[alg, tie] = engine.compute_alignments(alg, align_r[:nobj], align_f[:nobj])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels.items()}
    log(f"[main] {name}: launches during its path: {launches} ({wall:.2f} s)")
    fill, other = ("align_affine", "align") if params.affine else ("align", "align_affine")
    for kernel in ("score", fill):
        if launches[kernel] < 1:
            raise AssertionError(f"{name}: the path never launched the {kernel} kernel")
    if launches[other]:
        raise AssertionError(f"{name}: the path launched the {other} kernel")

    for alg in Algorithm:
        cpus = {tie: AlignmentEngine(params, tie=tie, device="cpu") for tie in TieBreak}
        s = scores[alg]
        if s.shape != (SCORE_PAIRS,) or s.dtype != np.int32 or (s < 0).any():
            raise AssertionError(f"{name} scores {alg.name}: bad shape, type or sign")
        want = cpus[TieBreak.DIAG_UP_LEFT].score_alignments(alg, score_r[pick], score_f[pick])
        if not (s[pick] == want).all():
            raise AssertionError(f"{name} scores {alg.name} differ from the CPU path")
        for tie, cpu in cpus.items():
            batch = raws[alg, tie]
            want_raw = cpu.compute_alignments(alg, align_r[pick], align_f[pick], raw=True)
            for col in ("meta", "cigar", "read_gapped", "ref_gapped"):
                if not np.array_equal(getattr(batch, col)[pick], getattr(want_raw, col)):
                    raise AssertionError(
                        f"{name} raw {col} {alg.name} {tie.name} differs from the CPU path")
            want_obj = cpu.compute_alignments(
                alg, align_r[:nobj][pick_obj], align_f[:nobj][pick_obj])
            got_obj = [objs[alg, tie][k] for k in pick_obj]
            if len(objs[alg, tie]) != nobj or not all(map(_same_alignment, got_obj, want_obj)):
                raise AssertionError(
                    f"{name} alignments {alg.name} {tie.name} differ from the CPU path")
            if not (batch.scores[:nobj] == np.array([a.score for a in objs[alg, tie]])).all():
                raise AssertionError(f"{name} raw and object scores {alg.name} disagree")
        log(f"[main] {name} {alg.name}: scores B={SCORE_PAIRS}, raw B={ALIGN_PAIRS}, "
            f"objects B={nobj}, both flavors == CPU path on {CHECK_PAIRS} pairs each")
    return {"launches": launches, "wall_s": wall}


def phase_main_path(rng) -> dict:
    return {name: _main_path(name, params, rng) for name, params in _param_sets().items()}


def phase_times(rng, dev, main: dict, errs: dict) -> list[dict]:
    from versalignlib_tpu_torch import AlignmentEngine
    from versalignlib_tpu_torch.native import decode_batch_native
    from versalignlib_tpu_torch.ops import cuda_align, plain
    from versalignlib_tpu_torch.ops.cuda_score import score_batch_device
    from versalignlib_tpu_torch.types import Algorithm, TieBreak

    m = n = LENGTH
    algs = ((Algorithm.SMITH_WATERMAN, "sw"), (Algorithm.NEEDLEMAN_WUNSCH, "nw"))
    entries = []
    for name, params in _param_sets().items():
        b = SCORE_PAIRS
        r = torch.from_numpy(codes_for(params, rng, b, m)).to(dev)
        f = torch.from_numpy(codes_for(params, rng, b, n)).to(dev)
        table_bytes = 0 if params.matrix is None else 4 * params.sub_size ** 2
        t = {}
        for alg, key in algs:
            k = time_cuda(lambda: score_batch_device(r, f, params, alg))
            pl = time_cuda(lambda: plain.score_batch(r, f, params, alg), reps=PLAIN_REPS)
            bd, by = bound("score", params, key, b, m, n, b * (m + n) + 4 * b + table_bytes)
            t[key] = (k, pl, bd, by)
            log(f"[times] score.cu {name} {key} B={b} {m}x{n}: {k['median']:.3f} ms "
                f"(min {k['min']:.3f}, max {k['max']:.3f}), "
                f"{b * m * n / k['median'] / 1e6:.1f} GCUPS; plain {pl['median']:.1f} ms; "
                f"bound {bd:.3f} ms ({by})")
        key = _kernel_name("score", params)
        entries.append(_entry(key, name, "versalignlib_tpu_torch/csrc/score.cu",
                              "versalignlib_tpu/ops/pallas_score.py:219",
                              main[name]["launches"]["score"], errs[key], (b, m, n), t))

        b = ALIGN_PAIRS
        r_np = codes_for(params, rng, b, m)
        f_np = codes_for(params, rng, b, n)
        r = torch.from_numpy(r_np).to(dev)
        f = torch.from_numpy(f_np).to(dev)
        tie = TieBreak.DIAG_UP_LEFT
        mrp_np = cuda_align.last_valid_pos(r_np, tie, params.matrix)
        mrp = torch.from_numpy(mrp_np).to(dev)
        kernel, plain_fill = cuda_align.fill, _plain_fill(params)
        pack = cuda_align.AFFINE_PACK if params.affine else cuda_align.PACK
        nc = -(-n // pack)
        engine = AlignmentEngine(params)
        mrp_sse = torch.from_numpy(cuda_align.last_valid_pos(
            r_np, TieBreak.DIAG_LEFT_UP, params.matrix)).to(dev)
        t = {}
        split = {}
        sse = {}
        for alg, key in algs:
            sse[key] = time_cuda(
                lambda: kernel(r, f, mrp_sse, params, alg, TieBreak.DIAG_LEFT_UP))["median"]
            k = time_cuda(lambda: kernel(r, f, mrp, params, alg, tie))
            pl = time_cuda(lambda: plain_fill(r, f, mrp, params, alg, tie), reps=PLAIN_REPS)
            nbytes = (b * (m + n) + 4 * b + table_bytes + 4 * b * m * nc + 16 * b
                      + (0 if key == "sw" else 4 * b * (n + 1)))
            bd, by = bound("align", params, key, b, m, n, nbytes)
            t[key] = (k, pl, bd, by)
            src = "align_affine.cu" if params.affine else "align.cu"
            log(f"[times] {src} {name} {key} B={b} {m}x{n}: {k['median']:.3f} ms "
                f"(min {k['min']:.3f}, max {k['max']:.3f}), "
                f"{b * m * n / k['median'] / 1e6:.1f} GCUPS; plain {pl['median']:.1f} ms; "
                f"bound {bd:.3f} ms ({by}); SSE flavor {sse[key]:.3f} ms")

            out = kernel(r, f, mrp, params, alg, tie)
            host = [None if x is None else torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    for x in out]

            def copy():
                for h, x in zip(host, out):
                    if x is not None:
                        h.copy_(x, non_blocking=True)

            d2h = time_cuda(copy)
            start_r, start_f, sc = cuda_align.start_cells(
                host[1].numpy(), None if host[2] is None else host[2].numpy(),
                mrp_np, f_np, tie, key == "sw", params.matrix)
            decode = time_host(lambda: decode_batch_native(
                (host[0].numpy(), pack), r_np, f_np, start_r, start_f,
                params, alg, sc, affine=params.affine, raw=True))
            e2e = time_host(lambda: engine.compute_alignments(alg, r_np, f_np, raw=True))
            split[key] = {"fill_ms": k["median"], "d2h_ms": d2h["median"],
                          "d2h_GBps": 4 * b * m * nc / d2h["median"] / 1e6,
                          "decode_ms": decode["median"], "e2e_ms": e2e["median"],
                          "e2e_min_ms": e2e["min"], "e2e_max_ms": e2e["max"]}
            log(f"[times] compute_alignments(raw=True) {name} {key} B={b} {m}x{n}: "
                + json.dumps({kk: round(v, 3) for kk, v in split[key].items()}))
        key = _kernel_name("align", params)
        fill_kernel = "align_affine" if params.affine else "align"
        source, replaces = (
            ("versalignlib_tpu_torch/csrc/align_affine.cu",
             "versalignlib_tpu/ops/pallas_align.py:724") if params.affine else
            ("versalignlib_tpu_torch/csrc/align.cu", "versalignlib_tpu/ops/pallas_align.py:90"))
        entries.append(_entry(key, name, source, replaces,
                              main[name]["launches"][fill_kernel], errs[key], (b, m, n), t))
        entries[-1]["compute_alignments_split"] = split
        entries[-1]["sse_flavor_ms"] = sse
    return entries


def _entry(name, params_name, source, replaces, launches, err, shape, t) -> dict:
    b, m, n = shape
    (k, pl, bd, by), (k_nw, pl_nw, bd_nw, _) = t["sw"], t["nw"]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "tolerance": 0,
        "ms": k["median"], "plain_ms": pl["median"], "bound_ms": bd,
        "bound_by": by, "library_ms": None,
        "params": params_name, "shape": [b, m, n], "algorithm": "SW",
        "ms_min": k["min"], "ms_max": k["max"],
        "gcups": b * m * n / k["median"] / 1e6,
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

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"[card] {smi}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    seconds = _build.build_all()
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in seconds.items()})}; "
        f"total {time.perf_counter() - t_start:.2f} s")
    for src in seconds:
        for line in register_report(_build.library_path(src).with_suffix(".log").read_text()):
            log(f"[build] {src} {line}")

    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    errs = phase_kernels_vs_plain(rng, dev)
    log(f"[phase] kernels vs plain: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    main_path = phase_main_path(rng)
    log(f"[phase] main path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels = phase_times(rng, dev, main_path, errs)
    log(f"[phase] times: {time.perf_counter() - t0:.1f} s; whole script "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
