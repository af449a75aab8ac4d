"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py [--seed N]

The pairwise path is ``AlignmentEngine.score_alignments`` and
``compute_alignments`` under four parameter sets (``_param_sets``): the
reference's default DNA scoring, BWA-MEM's affine DNA gaps, and BLOSUM62
protein scoring with BLASTP's affine gaps or with linear gaps. The search
paths run the one-vs-many kernel (``csrc/search.cu``) through
``map_reads`` (under the first two sets), ``map_to_reference``,
``profile_search`` and ``translated_search`` at real sizes (``SEARCH_*``
below), each checked on a subset against the same entry point with every
kernel's launch swapped for its plain version on the card.

Phases (any failure exits non-zero before a result is printed):

1. card: name and power limit, torch and CUDA versions; build every kernel
   of ``versalignlib_tpu_torch/csrc`` (one nvcc per source, in parallel) and
   print each instantiation's registers and spills (a spill in any kernel
   fails the run), the fills' launch geometry at 4096 pairs, the score
   kernel's at each main-path launch and at the deep edge
   (``score_geometry``: instantiation, registers, warps launched and
   resident per SM, shared memory, memory plan), and the one-vs-many
   kernel's at each search launch, with its memory plan, once the search
   data is made (``search_geometry``), and the walks' launches
   (``walk_geometry``: a thread per pair, a warp a block);
2. every branch of every kernel against its plain PyTorch version on the
   card, with ``==`` (tolerance 0: every output is an integer): at the main
   path's launch shapes (scores 16384 x 512 x 512; fills 4096 and 256 x 512
   x 512), at an odd shape whose ref length leaves a partial pointer word
   (150 x 509), and under a random 200 x 200 matrix at a small shape (the
   fills read it through the read-only cache, the score kernel from shared
   memory past the 48 KB default); then the score kernel at the edges of
   its lane groups (``phase_score_edges``: ``SCORE_EDGE_M`` x
   ``SCORE_EDGE_N`` at both column widths, DNA at and past the byte
   tables' limits, a 30 x 30 matrix, 200 x 200 and 250 x 250 matrices,
   linear and affine, SW and NW, tie-heavy periodic and all-padding pairs,
   an NW batch clamped at 0, 4000-row reads whose affine boundary columns
   live in device memory, one pair, B not a multiple of 8; its own
   generator, so the other phases' data do not depend on it); both fills at the edges of their
   wavefront (``FILL_EDGE_SHAPES``: refs of three stripes and of two and a
   partial one, 20 read rows, a ref of 9 columns; ``TIE_SHAPE``: periodic
   reads and refs whose SW maximum recurs across lanes and stripes, reads of
   all N or of padding), and the BLOSUM62 sets and DNA scores too large
   for the kernels' byte tables across stripes;
3. the main path through the entry points a user calls, once per parameter
   set: ``AlignmentEngine(params, tie=...)`` scores 16384 pairs of 512 x 512
   and aligns 4096 of them (``raw=True``) and 256 (``raw=False``), SW and NW,
   both tie-break flavors, checked field by field on 64 random pairs against
   the port's CPU path. The default engines walk on the card
   (``csrc/walk.cu``); their raw output on the whole 4096-pair batch, every
   column, == that of engines that walk on the host. The launch counts are
   set to 0 just before each set's run and read just after: the score
   kernel, the set's fill kernel and the walk must have launched, and the
   other fill kernel and the banded and search kernels must not;
4. times with CUDA events after a warm-up, the median of 7 runs with min and
   max, for each branch: the kernel, its plain version, the bound, the
   split of ``score_alignments`` into host-to-device copy, kernel,
   device-to-host copy and the rest, each timed inside the same calls
   (``score_wall_split``; logged, not in the ``kernels`` line), and the
   split of ``compute_alignments(raw=True)``, every part timed inside the
   same calls (``align_wall_split``): fill + walk + records copy + replay +
   rest with the walk on the card, fill + pointer copy + host decode + rest
   with it on the host;
5. every branch of the one-vs-many kernel against its plain version with
   ``==``: at each search path's launch shape, on a slice of its queries at
   the full pool size; at odd shapes (m, n not multiples of 16) in both
   orientations with codes past S; and with profiles of 100 KB (shared
   memory past the 48 KB default) and 250 KB (read-only cache); at the
   edges of its lane groups at both column widths (``SEARCH_EDGE_M`` x
   ``SEARCH_EDGE_N``: default DNA, at and past the byte tables' limits, a
   30 x 30 matrix, linear and affine, both orientations; tie-heavy periodic
   PSSMs and pools with coordinates; all-padding entries; an NW batch
   clamped at 0: ``phase_search_edges``). Then the fill kernel of each aligning search path against its plain version at
   that path's own align shape (2048 x 150 x 1536, 256 x 150 x 640, 1024 x
   50 x 512), on the pairs its planted reads win;
6. the search paths, each with the launch counts set to 0 just before its
   run and read just after (the one-vs-many kernel must have launched, and
   the fill kernel of its parameters where the path aligns on the card),
   its wall time split into the one-vs-many kernel (CUDA events), the align
   path (host clock) and the rest, 64 reads (profiles: all 8 on a 4096-entry
   slice) checked field by field against the plain reference (the same
   entry point with the one-vs-many wrappers and the fill launch swapped
   for their plain versions, on the card), and the planted reads, entries
   and instances found where they were planted;
7. times of the one-vs-many kernel at each path's launch shape (median of
   7, min, max, GCUPS), its plain version's at the slice shape, the bound;
8. every branch of the traceback walks (``csrc/walk.cu``, B7 linear, B8
   Gotoh; ``csrc/banded_walk.cu``, B9, B10) against its plain version
   (``ops/walk.py``) with ``==`` on the words the fill kernels write:
   records, start cells and scores, at 4096 x 512 x 512 under every
   parameter set, SW and NW, both flavors; at the edges (``WALK_EDGES``:
   refs of 9, 17 and 509, reads of one row, refs far longer than their
   reads, ties, all-padding reads, SW score 0, insertions for Gotoh F
   chains; ``BANDED_WALK_EDGES``: bands 8 and 20, steps of 3-4;
   ``WALK_RANDOM_WORDS``: random words whose walks leave the band on both
   edges); on 32 of the 16 kbp pairs at band 512 (``phase_walk_vs_plain``);
9. every branch of the banded kernels (``csrc/banded_score.cu``, B5;
   ``csrc/banded_align.cu``, B6) against its plain version with ``==``:
   first at the edges of their row layout (``BANDED_EDGES``: bands of 8 and
   20 where most lanes are empty, a band equal to n, steps of 3-4, 24, 32
   and 40 columns a lane, all-padding reads with NW's mrp < 0, a tie-heavy
   periodic batch, rows in device memory; ``phase_banded_edges``, each
   launch's instantiation, registers, shared bytes, warps resident and
   whether T stays in registers printed by ``banded_geometry``), then
   SW, NW x linear, affine x DNA, BLOSUM62 (fill: x both flavors) at 256
   pairs of 1500 x 1800, band 333 (steps of 2, a partial pointer word, rows
   padded to the score tile); bands too wide for shared memory (8 pairs of
   16 kbp at band 16000 linear, SW, and at band 4000 affine, NW), whose
   rows live in device memory; a random 200 x 200 matrix, read through the
   read-only cache, at 64 pairs of 300 x 360, band 203; and the
   models' defaults (DNA linear SW and NW, BWA-MEM affine SW) on 32 of the
   long pairs at full length;
10. the banded models at full width: ``banded_smith_waterman(band=512)``,
   ``banded_needleman_wunsch(band=512)`` and a banded BWA-MEM affine model,
   ``score`` and ``align`` on 1024 pairs of 16 kbp (each ref a window of the
   genome, each read a HiFi-like copy), launch counts read around each call
   (B5 for ``score``; B6 and the walk for ``align``; no other kernel), 16
   pairs checked against the plain reference on the card, ``align`` again
   with the walk on the host (== on every pair), each split into fill,
   walk, copy back (CUDA events), replay or host decode and the rest;
11. ``map_long_reads`` of 256 HiFi-like reads of 12-15 kbp on both strands
    and 16 junk reads against the 4.64 Mbp genome: the index timed alone, B6
    and B9 the only kernels, every planted read within 50 bp of its origin on its
    strand, junk unmapped, 16 reads checked against the plain reference and
    all against the walk on the host, the wall split into seeding and
    chaining, fill, walk, copy, replay and the rest; then one round of 528
    pairs of 100 kbp at band 512 with the walk on the card, split alike
    (``phase_long_round``);
12. times of B5 and B6 at 1024 pairs of 16 kbp, band 512 (median of 7, min,
    max, GCUPS in band cells), each launch's geometry, the plain versions'
    on the 32-pair slice, the bounds; times of B7-B10 (4096 x 512 x 512;
    1024 x 16 kbp, band 512), their plain versions, their bounds from the
    rows this run's walks visited (``walk_bound``);
13. one ``{"kernels": [...]}`` line, the nvidia-smi line, and the last line
    ``{"ok": true, "device": {...}}``.

DNA inputs are random A/C/G/T with about 2% N, protein inputs the 20
standard residues with about 1% X, both with random trailing padding, made
with numpy from ``--seed``; the search and long-pair paths' inputs are
described at ``make_*``. Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

#: H100 SXM peaks used for the bounds: HBM3 at 3.35 TB/s (NVIDIA data
#: sheet), and int32 operations at 2 x 128 lanes per SM per clock x 132 SMs x
#: 1.98 GHz boost = 66.9 Tops/s. An SM issues at most four warp instructions
#: (128 lanes) per clock, shared by its integer pipe and the FMA pipe that
#: runs IMAD, and the integer instructions the kernels compile to do at most
#: two of the counted operations each (VIADDMNMX an add and a max, VIMNMX3
#: two maxes, IADD3 two adds; scripts/torch_sass_mix.py). The 64 INT32 lanes
#: per SM of the white paper, one operation each, are no ceiling: the
#: profile search launch ran faster than that bound.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 2 * 128 * 132 * 1.98e9

#: int32 operations per DP cell, (SW, NW), of the score recurrence as
#: score.cu's cell loop computes it (csrc/common.cuh, score_sweep): the
#: substitution, then the recurrence.
#: - recurrence, linear gaps: diag + s, two gap adds and two maxes (5); SW
#:   adds its zero clamp and its running best (7 / 5). Affine gaps make each
#:   gap arm an add, a max and an add where a linear arm is one add (+4:
#:   11 / 9);
#: - substitution: an index add for an S x S matrix or a query profile (the
#:   lookup is a load, not an operation), so 1; a compare, a select and a
#:   mask for the default DNA table, so 3. The one-vs-many kernel's bound
#:   counts every scoring as one lookup, as its first design read each
#:   through a query profile, so its bounds compare across its designs;
#: - coordinates (search.cu, SW): the running best becomes a compare, a max
#:   and a column select (+SEARCH_COORDS_OPS).
#: The fills count from their recurrence (not yet from their cell
#: loops): linear 16 / 15 (the move priority, its packing and the cleared
#: value on top of the score's cell), affine 26 / 25 (each extend bit a
#: compare, a select and an or). The banded kernels compute the same cell
#: function over the band's cells and are counted alike: B5 as a score, B6
#: as a fill; what their scan design does on top (the fold pass, the second
#: pass's repeated adds) is not work the function needs.
RECURRENCE_OPS = {"linear": (7, 5), "affine": (11, 9)}
SUBSTITUTION_OPS = {"dna": 3, "matrix": 1, "profile": 1}
FILL_OPS = {"linear": (16, 15), "affine": (26, 25)}
SEARCH_COORDS_OPS = 2


def ops_per_cell(kind: str, gap: str, scoring: str) -> tuple[int, int]:
    """(SW, NW) int32 operations per cell of ``kind`` ("score", "search" or
    "align") under ``gap`` ("linear", "affine") and ``scoring`` ("dna",
    "matrix", "profile")."""
    if kind == "align":
        return FILL_OPS[gap]
    sub = SUBSTITUTION_OPS["profile" if kind == "search" else scoring]
    sw, nw = RECURRENCE_OPS[gap]
    return sub + sw, sub + nw

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
#: The edges of the fills' wavefront (csrc/fill.cuh: a warp per pair, 16
#: columns a lane, stripes of 512 columns), (pairs, m, n): three whole
#: stripes, two and a partial one, fewer read rows than lanes, a ref
#: narrower than one lane's columns. TIE_SHAPE holds the periodic batch
#: whose SW maximum recurs across lanes and stripes, and the reads of all N
#: or of padding (mrp < 0 in one flavor or both).
FILL_EDGE_SHAPES = ((128, 150, 1536), (128, 200, 1100), (256, 20, 512), (256, 64, 9))
TIE_SHAPE = (256, 96, 1100)
#: The edges of the score kernel (csrc/score.cu: 16 lanes a pair, 32 or 40
#: columns a lane, 8 pairs a block): read rows of one, fewer than the lanes,
#: just more and two lanes' worth plus one; refs narrower than a lane, one
#: column short of, at and past a 32-column stripe, a 40-column stripe and
#: a partial third stripe. Each is run at both widths on SCORE_EDGE_PAIRS
#: pairs (not a multiple of 8), and the tie-heavy batch at SCORE_TIE_SHAPE.
#: SCORE_EDGE_DEEP reads are too deep for a block's affine boundary columns
#: in shared memory.
SCORE_EDGE_M, SCORE_EDGE_N = (1, 15, 17, 33), (9, 511, 512, 513, 640, 1100)
SCORE_EDGE_PAIRS = 13
SCORE_TIE_SHAPE = (64, 33, 1100)
SCORE_EDGE_DEEP = (4000, 1100)

#: The search paths' sizes. map_reads: SEARCH_READS Illumina reads of
#: READ_LEN bp against SEARCH_PANEL entries of PANEL_LEN bp (16S-gene
#: length). map_to_reference: REFMAP_READS reads against one reference of
#: GENOME_LEN bp (E. coli K-12 MG1655's length). profile_search: PROFILES
#: protein profiles of PROFILE_LEN positions against POOL proteins of
#: POOL_LEN residues (one default chunk), checked on the first POOL_SLICE.
#: translated_search: TRANSLATED_READS reads against PROTEINS proteins of
#: POOL_LEN residues. SEARCH_CHECK reads of each are checked field by field.
READ_LEN = 150
SEARCH_READS, SEARCH_PANEL, PANEL_LEN = 2048, 512, 1536
REFMAP_READS, GENOME_LEN = 256, 4_641_652
PROFILES, PROFILE_LEN, POOL, POOL_LEN, POOL_SLICE = 8, 256, 131072, 512, 4096
PLANTED_PER_PROFILE = 5
TRANSLATED_READS, PROTEINS = 1024, 2048
SEARCH_CHECK = 64
#: Queries of each search launch shape that the plain version scores
#: against the full pool (the plain version of a whole launch would take
#: minutes), and the odd shapes of the branch sweep: (queries, m) against
#: (pool, n), both orientations.
PLAIN_QUERIES = {"map_reads": 16, "map_to_reference": 16, "profile_search": 1,
                 "translated_search": 16}
SEARCH_ODD = ((37, 45), (300, 77))
#: The edges of the one-vs-many kernel (csrc/search.cu: 16 lanes a pair, 32
#: or 40 columns a lane): read rows fewer than, and just more than, the lanes
#: and the lanes plus one; refs narrower than a lane, one column into a
#: second stripe, the reference-mapping width and a partial last stripe.
#: Each is run at both widths, SEARCH_EDGE_QUERIES queries against
#: SEARCH_EDGE_POOL pool sequences in both orientations.
SEARCH_EDGE_M, SEARCH_EDGE_N = (1, 20, 33), (9, 513, 640, 1100)
SEARCH_EDGE_QUERIES, SEARCH_EDGE_POOL = 3, 24
#: Affine reads too deep for a block's boundary columns in shared memory,
#: against refs of more than one stripe.
SEARCH_EDGE_DEEP = (4000, 1100)


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
    template arguments (kLocal, kCanon or kAffine, kMat), registers, stack
    frame and spill bytes."""
    out, kernel, spill = [], "?", ""
    for line in log_text.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[-1].strip()
            found = re.search(r"([a-z_]+_kernel)I(.*)EEvN", name)
            kernel = (f"{found.group(1)}<{','.join(re.findall(r'L[bi](\d+)E', found.group(2) + 'E'))}>"
                      if found else name)
        elif "spill stores" in line:
            spill = line.split(":", 1)[-1].strip() if ":" in line else line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{kernel}: {regs.group(1) if regs else '?'} registers, {spill}")
    return out


def registers(lines: list[str]) -> dict[str, int]:
    """Registers by instantiation, from ``register_report`` lines."""
    out = {}
    for line in lines:
        found = re.search(r"^(\S+): (\d+) registers", line)
        if found:
            out[found.group(1)] = int(found.group(2))
    return out


def resident_blocks(regs: int, smem: int) -> int:
    """Blocks of 128 threads an SM holds at once: by registers (65536 an SM,
    allocated 256 a warp) and by shared memory (233472 bytes, 1 KB reserved
    a block); at most 16 blocks."""
    per_warp = -(-regs * 32 // 256) * 256
    return min(16, (65536 // per_warp) // 4, 233472 // (smem + 1024))


def check_no_spills(source: str, lines: list[str]) -> None:
    """Raise if any instantiation in ``register_report`` lines spills."""
    for line in lines:
        if "0 bytes spill stores, 0 bytes spill loads" not in line:
            raise AssertionError(f"{source} spills: {line}")


def fill_geometry(lines: list[str], pairs: int, sms: int) -> list[str]:
    """The fills' launch of ``pairs`` pairs (a warp each, in blocks of
    ``cuda_align.FILL_WARPS``): blocks, warps launched per SM, and for each
    instantiation the blocks an SM holds at once by its registers (65536 a
    SM, allocated 256 a warp; at most 64 warps)."""
    from versalignlib_tpu_torch.ops.cuda_align import FILL_WARPS

    blocks = -(-pairs // FILL_WARPS)
    out = [f"{pairs} pairs: {blocks} blocks of {FILL_WARPS * 32} threads, "
           f"{pairs / sms:.1f} warps launched per SM on {sms} SMs"]
    for line in lines:
        regs = re.search(r": (\d+) registers", line)
        if regs:
            per_warp = -(-int(regs.group(1)) * 32 // 256) * 256
            resident = min(64, 65536 // per_warp) // FILL_WARPS
            out.append(f"{line.split(':')[0]}: {resident} blocks ({resident * FILL_WARPS} "
                       f"warps) resident per SM by registers")
    return out


def branch_of(params) -> tuple[str, str]:
    return ("affine" if params.affine else "linear",
            "dna" if params.matrix is None else "matrix")


def bound(kind: str, params, alg: str, b: int, m: int, n: int,
          nbytes: int) -> tuple[float, str]:
    """Least time in ms for the work, and which of bytes or operations sets it."""
    sw, nw = ops_per_cell(kind, *branch_of(params))
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


def _fill_source(params) -> str:
    return "align_affine.cu" if params.affine else "align.cu"


def check_fill(label: str, r_np: np.ndarray, f_np: np.ndarray, params, dev) -> int:
    """``cuda_align.fill`` against its plain version on the card, on (B, m)
    and (B, n) codes, SW and NW under both tie-break flavors, every output
    (ptr, aux, hsel) with ``==``; returns the max abs error (0)."""
    from versalignlib_tpu_torch.ops import cuda_align
    from versalignlib_tpu_torch.types import Algorithm, TieBreak

    r = torch.from_numpy(np.ascontiguousarray(r_np)).to(dev)
    f = torch.from_numpy(np.ascontiguousarray(f_np)).to(dev)
    plain_fill = _plain_fill(params)
    err = 0
    for tie in TieBreak:
        mrp = torch.from_numpy(cuda_align.last_valid_pos(r_np, tie, params.matrix)).to(dev)
        for alg in Algorithm:
            got = cuda_align.fill(r, f, mrp, params, alg, tie)
            want = plain_fill(r, f, mrp, params, alg, tie)
            for part, g, w in zip(("ptr", "aux", "hsel"), got, want):
                if (g is None) != (w is None):
                    raise AssertionError(f"{label} {part}: one side is None")
                if g is not None:
                    err = max(err, check_equal(f"{label} {part} {alg.name} {tie.name}", g, w))
    return err


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
    from versalignlib_tpu_torch.ops import plain
    from versalignlib_tpu_torch.ops.cuda_score import score_batch_device
    from versalignlib_tpu_torch.params import AlignmentParameters
    from versalignlib_tpu_torch.types import Algorithm

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
        key = _kernel_name("align", params)
        for b, m, n in fill_shapes:
            r_np = make(rng, b, m)
            f_np = make(rng, b, n)
            err[key] = max(err.get(key, 0), check_fill(f"{key} {name} {b}x{m}x{n}",
                                                       r_np, f_np, params, dev))
            log(f"[kernels] {_fill_source(params)} == plain  {name:24s} SW, NW x both "
                f"flavors B={b} {m}x{n} (ptr, aux, hsel)")

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
    for key, e in phase_fill_edges(rng, dev).items():
        err[key] = max(err.get(key, 0), e)
    torch.cuda.synchronize()
    return err


def tie_batch(rng, b: int, m: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Periodic reads and refs whose SW maximum recurs across lanes and
    stripes: ACGT repeats at random phases against ACGT repeats, poly-A
    against poly-A and against ACGT repeats; then reads of all N and of
    padding alone (mrp < 0 in the SSE flavor, in both)."""
    acgt = np.array([1, 2, 3, 4], np.uint8)

    def period(count, length):
        phase = rng.integers(0, 4, size=(count, 1))
        return acgt[(np.arange(length)[None, :] + phase) % 4]

    q = b // 4
    reads = np.concatenate([period(q, m), np.ones((q, m), np.uint8),
                            np.ones((q, m), np.uint8), period(b - 3 * q, m)])
    refs = np.concatenate([period(q, n), np.ones((q, n), np.uint8),
                           period(q, n), period(b - 3 * q, n)])
    reads[-8:-4] = 5   # all N
    reads[-4:] = 0     # padding alone
    return reads, refs


def phase_fill_edges(rng, dev) -> dict:
    """Both fills against their plain versions at the wavefront's edges
    (``FILL_EDGE_SHAPES``, ``TIE_SHAPE``), SW and NW in both flavors, and
    at the stripes under the two BLOSUM62 sets and DNA scores too large
    for a byte; returns the max abs error per kernel name (0)."""
    err: dict[str, int] = {}
    sets = _param_sets()
    for name in ("dna_default", "dna_affine_bwamem"):
        params = sets[name]
        key = _kernel_name("align", params)
        cases = [(f"{b}x{m}x{n}", codes_for(params, rng, b, m), codes_for(params, rng, b, n))
                 for b, m, n in FILL_EDGE_SHAPES]
        cases.append((f"ties {'x'.join(map(str, TIE_SHAPE))}", *tie_batch(rng, *TIE_SHAPE)))
        for label, r_np, f_np in cases:
            err[key] = max(err.get(key, 0), check_fill(f"{key} {name} {label}", r_np, f_np,
                                                       params, dev))
            log(f"[kernels] {_fill_source(params)} == plain  {name:24s} SW, NW x both "
                f"flavors {label} (ptr, aux, hsel): edge")
    # DNA scores too large for the kernels' byte tables reach them as the
    # 6 x 6 matrix (cuda_align.dna_fits_bytes).
    from versalignlib_tpu_torch.params import AlignmentParameters

    sets = dict(sets, dna_large_linear=AlignmentParameters(
        score_match=40, score_mismatch=-35, score_gap_read=-50, score_gap_ref=-45),
        dna_large_affine=AlignmentParameters(
            score_match=40, score_mismatch=-35, score_gap_read=-10, score_gap_ref=-15,
            gap_open_read=-60, gap_open_ref=-50))
    for name in ("protein_blosum62_affine", "protein_blosum62_linear", "dna_large_linear",
                 "dna_large_affine"):
        params = sets[name]
        key = _kernel_name("align", params)
        b, m, n = FILL_EDGE_SHAPES[1]
        err[key] = max(err.get(key, 0), check_fill(
            f"{key} {name} {b}x{m}x{n}", codes_for(params, rng, b, m),
            codes_for(params, rng, b, n), params, dev))
        log(f"[kernels] {_fill_source(params)} == plain  {name:24s} SW, NW x both "
            f"flavors B={b} {m}x{n} (ptr, aux, hsel): edge")
    return err


def phase_score_edges(rng, dev) -> dict:
    """The score kernel against its plain version with ``==`` at the edges
    of its lane groups (SCORE_EDGE_M x SCORE_EDGE_N at both column widths,
    SCORE_EDGE_PAIRS pairs): default DNA (byte tables; scores at the byte's
    limits; scores past a byte, through the 6 x 6 matrix) and a 30 x 30
    matrix, linear and affine, SW and NW; then a 200 x 200 matrix (160 KB,
    in shared memory past the 48 KB default) and a 250 x 250 one (through
    the read-only cache), the tie-heavy periodic batch with all-N and
    all-padding reads, an NW batch that clamps at 0, SCORE_EDGE_DEEP reads
    whose affine boundary columns live in device memory (linear: in shared
    memory past 48 KB), one pair, and blocks past B. Returns the max abs
    error per kernel name (0)."""
    from versalignlib_tpu_torch.ops import cuda_score, plain
    from versalignlib_tpu_torch.ops.cuda_score import score_batch_device
    from versalignlib_tpu_torch.params import AlignmentParameters
    from versalignlib_tpu_torch.types import Algorithm

    err: dict[str, int] = {}

    def hold(label, params, r_np, f_np, algs=tuple(Algorithm)):
        r = torch.from_numpy(np.ascontiguousarray(r_np)).to(dev)
        f = torch.from_numpy(np.ascontiguousarray(f_np)).to(dev)
        key = _kernel_name("score", params)
        for alg in algs:
            err[key] = max(err.get(key, 0), check_equal(
                f"score.cu {key} {label} {alg.name}", score_batch_device(r, f, params, alg),
                plain.score_batch(r, f, params, alg)))

    mat = _random_matrix(rng, 30)
    sets = (("dna linear", AlignmentParameters(score_gap_read=-2, score_gap_ref=-3), 4),
            ("dna affine", AlignmentParameters(gap_open_read=-5, gap_open_ref=-4), 4),
            ("dna byte limits", AlignmentParameters(score_match=127, score_mismatch=-128,
                                                    score_gap_read=-60, score_gap_ref=-70), 4),
            ("dna past a byte", AlignmentParameters(score_match=300, score_mismatch=-200,
                                                    score_gap_read=-7, score_gap_ref=-5,
                                                    gap_open_read=-40, gap_open_ref=-30), 4),
            ("matrix linear", AlignmentParameters(score_gap_read=-3, score_gap_ref=-2,
                                                  matrix=mat), 30),
            ("matrix affine", AlignmentParameters(score_gap_read=-1, score_gap_ref=-2,
                                                  gap_open_read=-3, gap_open_ref=-4,
                                                  matrix=mat), 30))
    t0 = time.perf_counter()
    b = SCORE_EDGE_PAIRS
    for m in SCORE_EDGE_M:
        for n in SCORE_EDGE_N:
            for label, params, size in sets:
                # Periodic reads and refs (maxima that recur across lanes and
                # stripes), random codes past S, and padding alone.
                r_np = _periodic_pool(rng, b, m, size)
                f_np = _periodic_pool(rng, b, n, size)
                for cols in (32, 40):
                    with _search_width(cols):
                        hold(f"{label} B={b} {m}x{n} {cols} cols", params, r_np, f_np)
    for s in (200, 250):
        big = _random_matrix(rng, s)
        for label, params in (
                ("linear", AlignmentParameters(score_gap_read=-3, score_gap_ref=-2,
                                               matrix=big)),
                ("affine", AlignmentParameters(score_gap_read=-1, score_gap_ref=-2,
                                               gap_open_read=-3, gap_open_ref=-4,
                                               matrix=big))):
            hold(f"{s} x {s} matrix {label} B={b} 33x1100", params,
                 _pad_tail(rng, rng.integers(1, s + 10, size=(b, 33)).astype(np.uint8)),
                 _pad_tail(rng, rng.integers(1, s + 10, size=(b, 1100)).astype(np.uint8)))
    lin, aff = sets[0][1], sets[1][1]
    for params in (lin, aff):
        gap = "affine" if params.affine else "linear"
        hold(f"ties {gap} {'x'.join(map(str, SCORE_TIE_SHAPE))}", params,
             *tie_batch(rng, *SCORE_TIE_SHAPE))
        hold(f"one pair {gap} 1x17x640", params, random_codes(rng, 1, 17),
             random_codes(rng, 1, 640))
        m, n = SCORE_EDGE_DEEP
        where = "device" if cuda_score.launch_plan(m, n, params.affine).edge_in_device else "shared"
        if where != ("device" if params.affine else "shared"):
            raise AssertionError(f"the deep {gap} shape keeps its boundary in {where} memory")
        hold(f"deep {gap} B=3 {m}x{n}, boundary in {where} memory", params,
             random_codes(rng, 3, m), random_codes(rng, 3, n))
    # NW overlap scores that clamp at 0: every cell a mismatch or a gap.
    reads = np.full((b, 33), 1, np.uint8)
    refs = np.full((b, 1100), 2, np.uint8)
    if bool((plain.score_batch(torch.from_numpy(reads), torch.from_numpy(refs), lin,
                               Algorithm.NEEDLEMAN_WUNSCH) != 0).any()):
        raise AssertionError("the NW clamp batch does not clamp")
    for cols in (32, 40):
        with _search_width(cols):
            hold(f"NW clamp {cols} cols", lin, reads, refs, (Algorithm.NEEDLEMAN_WUNSCH,))
    torch.cuda.synchronize()
    log(f"[kernels] score.cu == plain  edges: m {SCORE_EDGE_M} x n {SCORE_EDGE_N} x 32, 40 "
        f"cols, {len(sets)} scorings, 200 and 250 matrices, ties, one pair, deep reads, NW "
        f"clamp: {time.perf_counter() - t0:.1f} s")
    return err


def score_geometry(lines: list[str], sms: int) -> list[str]:
    """Each launch of the score kernel at the main path's shape (SCORE_PAIRS
    pairs of LENGTH x LENGTH) under the four parameter sets, and at the deep
    edge: the instantiation it runs (kLocal, kAffine, kSub, kCols),
    its registers, the ref columns a lane owns and the stripes, the blocks
    (128 threads, 8 pairs) and warps launched per SM, the blocks and warps
    an SM holds at once (by registers, allocated 256 a warp of 65536, and by
    shared memory, 233472 bytes with 1 KB reserved a block; at most 16
    blocks, 64 warps), and the dynamic shared memory of a block, all as
    the wrapper's ``cuda_score.launch_plan`` chooses them."""
    from versalignlib_tpu_torch.ops import cuda_score as cs_
    from versalignlib_tpu_torch.ops import cuda_search as cu
    from versalignlib_tpu_torch.params import AlignmentParameters

    regs = registers(lines)
    launches = [(name, params, SCORE_PAIRS, LENGTH, LENGTH)
                for name, params in _param_sets().items()]
    launches.append(("deep affine edge", AlignmentParameters(gap_open_read=-5, gap_open_ref=-4),
                     3, *SCORE_EDGE_DEEP))
    out = []
    for name, params, b, m, n in launches:
        cols, stripes, sub, smem, _ = cs_.launch_plan(
            m, n, params.affine, None if cu.dna_fits_bytes(params) else params.sub_size)
        blocks = -(-b // cu.PAIRS_PER_BLOCK)
        for local in (1, 0):
            inst = f"score_kernel<{local},{int(params.affine)},{sub},{cols}>"
            resident = resident_blocks(regs.get(inst, 255), smem)
            out.append(f"{name} {'SW' if local else 'NW'}: {inst} {regs.get(inst, '?')} "
                       f"registers; {b} pairs of {m}x{n}, {cols} cols a lane, {stripes} "
                       f"stripe(s); {blocks} blocks, {4 * blocks / sms:.1f} warps launched per "
                       f"SM, {resident} blocks ({4 * resident} warps) resident per SM; {smem} B "
                       f"shared a block; mem plan "
                       f"{cs_.score_mem_plan(m, n, b, params.affine) / 2**20:.1f} MiB")
    return out


def _same_alignment(x, y) -> bool:
    return (x.read, x.ref, x.score, x.cigar, x.read_start, x.read_end,
            x.ref_start, x.ref_end, x.buffer_start, x.buffer_end) == \
           (y.read, y.ref, y.score, y.cigar, y.read_start, y.read_end,
            y.ref_start, y.ref_end, y.buffer_start, y.buffer_end)


def _main_path(name, params, rng) -> dict:
    """One parameter set through the engine, launch counts read around it
    alone, checked on 64 pairs against the CPU path; the raw alignments of
    the default engines, which walk on the card, == those of engines that
    walk on the host, on the whole batch."""
    from versalignlib_tpu_torch import Algorithm, AlignmentEngine, TieBreak

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

    kernels = _all_kernels()
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
    for kernel in ("score", fill, "walk"):
        if launches[kernel] < 1:
            raise AssertionError(f"{name}: the path never launched the {kernel} kernel")
    for kernel in (other, "search", "banded_score", "banded_align", "banded_walk"):
        if launches[kernel]:
            raise AssertionError(f"{name}: the path launched the {kernel} kernel")
    for (alg, tie), batch in raws.items():
        host = AlignmentEngine(params, tie=tie, device_walk=False).compute_alignments(
            alg, align_r, align_f, raw=True)
        for col in ("meta", "cigar", "read_gapped", "ref_gapped"):
            if not np.array_equal(getattr(batch, col), getattr(host, col)):
                raise AssertionError(f"{name} raw {col} {alg.name} {tie.name}: the walk on "
                                     "the card differs from the walk on the host")
    log(f"[main] {name}: raw B={ALIGN_PAIRS}, SW, NW x both flavors, walk on the card == "
        "walk on the host, every column")

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


def phase_times(rng, dev, main: dict, errs: dict, splits: dict) -> list[dict]:
    """Times of B1, B2 and B3 at the main path's shapes, and the split of
    ``compute_alignments(raw=True)`` per parameter set (kept in
    ``splits``)."""
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
        score_wall_split(name, params, r.cpu().numpy(), f.cpu().numpy())

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
        mrp_sse = torch.from_numpy(cuda_align.last_valid_pos(
            r_np, TieBreak.DIAG_LEFT_UP, params.matrix)).to(dev)
        t = {}
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

        key = _kernel_name("align", params)
        fill_kernel = "align_affine" if params.affine else "align"
        source, replaces = (
            ("versalignlib_tpu_torch/csrc/align_affine.cu",
             "versalignlib_tpu/ops/pallas_align.py:724") if params.affine else
            ("versalignlib_tpu_torch/csrc/align.cu", "versalignlib_tpu/ops/pallas_align.py:90"))
        entries.append(_entry(key, name, source, replaces,
                              main[name]["launches"][fill_kernel], errs[key], (b, m, n), t))
        split = splits[name] = align_wall_split(name, params, r_np, f_np)
        entries[-1]["compute_alignments_split"] = split
        entries[-1]["sse_flavor_ms"] = sse
    return entries


def score_wall_split(name: str, params, r_np: np.ndarray, f_np: np.ndarray) -> dict:
    """``AlignmentEngine.score_alignments`` on the (B, m), (B, n) codes
    ``r_np``, ``f_np``, SW and NW, each of REPS calls split as it
    runs. CUDA events on the stream, recorded when the backend's scorer
    starts, when ``cuda_score.score_batch_device`` starts and returns and
    when the scorer returns, time its host-to-device copy of both code
    arrays (copies from pageable memory, which the host waits for), the
    kernel (the wrapper's host work and the launch included) and the
    device-to-host copy of the scores; the host clock times the wall and
    the rest (encoding checks and the memory-plan gate before the scorer,
    the numpy view after it). Every part is a time measured in the call;
    ``parts_ms``, their sum, misses the call's wall only by the host's
    microseconds between a clock read and an event record. Logs and
    returns the medians of each over the calls."""
    from versalignlib_tpu_torch import AlignmentEngine
    from versalignlib_tpu_torch.ops import cuda_score
    from versalignlib_tpu_torch.types import Algorithm

    engine = AlignmentEngine(params)
    backend, kernel = engine.backend, cuda_score.score_batch_device
    scorer = backend._scorer
    marks: dict[str, tuple] = {}

    def mark(key):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks[key] = (event, time.perf_counter())

    def timed_kernel(*args):
        mark("kernel")
        out = kernel(*args)
        mark("kernel_end")
        return out

    def timed_scorer(*args):
        mark("scorer")
        out = scorer(*args)
        mark("scorer_end")
        return out

    def ms(a, b):
        return marks[a][0].elapsed_time(marks[b][0])

    cuda_score.score_batch_device, backend._scorer = timed_kernel, timed_scorer
    out = {}
    try:
        for alg, key in ((Algorithm.SMITH_WATERMAN, "sw"), (Algorithm.NEEDLEMAN_WUNSCH, "nw")):
            engine.score_alignments(alg, r_np, f_np)
            calls = []
            for _ in range(REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.score_alignments(alg, r_np, f_np)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                call = {"wall_ms": 1e3 * (t1 - t0), "h2d_ms": ms("scorer", "kernel"),
                        "kernel_ms": ms("kernel", "kernel_end"),
                        "d2h_ms": ms("kernel_end", "scorer_end"),
                        "rest_ms": 1e3 * (marks["scorer"][1] - t0 + t1 - marks["scorer_end"][1])}
                call["parts_ms"] = sum(
                    call[k] for k in ("h2d_ms", "kernel_ms", "d2h_ms", "rest_ms"))
                calls.append(call)
            out[key] = {k: float(np.median([c[k] for c in calls])) for k in calls[0]}
            out[key]["wall_min_ms"] = min(c["wall_ms"] for c in calls)
            out[key]["wall_max_ms"] = max(c["wall_ms"] for c in calls)
            log(f"[times] score_alignments {name} {key} B={r_np.shape[0]} "
                f"{r_np.shape[1]}x{f_np.shape[1]}, medians of {REPS} calls: "
                + json.dumps({k: round(v, 3) for k, v in out[key].items()}))
    finally:
        cuda_score.score_batch_device, backend._scorer = kernel, scorer
    return out


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


# ---------------------------------------------------------------------------
# The search paths: the one-vs-many kernel (csrc/search.cu)
# ---------------------------------------------------------------------------

def _profile_params():
    """Protein profile search: gaps open -22, extend -2, on the scale of
    BLOSUM62 x 2 (BLASTP's -11 / -1 doubled with the scores)."""
    from versalignlib_tpu_torch.params import AlignmentParameters

    return AlignmentParameters(score_gap_read=-2, score_gap_ref=-2,
                               gap_open_read=-22, gap_open_ref=-22)


def _substitute(rng, codes: np.ndarray, rate: float, size: int) -> np.ndarray:
    """Replace about ``rate`` of the codes (1..size) with another code."""
    other = (codes.astype(np.int64) - 1 + rng.integers(1, size, size=codes.shape)) % size + 1
    return np.where(rng.random(codes.shape) < rate, other, codes).astype(np.uint8)


def make_map_reads(rng):
    """SEARCH_PANEL random A/C/G/T entries of PANEL_LEN bp, and SEARCH_READS
    reads of READ_LEN bp drawn from them with 1% substitutions and 2% N,
    half reverse-complemented: (reads, panel, source entry, reverse)."""
    from versalignlib_tpu_torch.alphabet import reverse_complement_codes

    panel = rng.integers(1, 5, size=(SEARCH_PANEL, PANEL_LEN)).astype(np.uint8)
    src = rng.integers(0, SEARCH_PANEL, size=SEARCH_READS)
    off = rng.integers(0, PANEL_LEN - READ_LEN + 1, size=SEARCH_READS)
    reads = _substitute(rng, panel[src[:, None], off[:, None] + np.arange(READ_LEN)], 0.01, 4)
    reads = np.where(rng.random(reads.shape) < 0.02, np.uint8(5), reads)
    rev = rng.random(SEARCH_READS) < 0.5
    reads[rev] = reverse_complement_codes(reads[rev])
    return reads, panel, src, rev


def make_genome(rng):
    """One random A/C/G/T reference of GENOME_LEN bp and REFMAP_READS exact
    reads of READ_LEN bp planted at random positions, half
    reverse-complemented: (reads, genome, position, reverse)."""
    from versalignlib_tpu_torch.alphabet import reverse_complement_codes

    genome = rng.integers(1, 5, size=GENOME_LEN).astype(np.uint8)
    pos = rng.integers(0, GENOME_LEN - READ_LEN + 1, size=REFMAP_READS)
    reads = genome[pos[:, None] + np.arange(READ_LEN)]
    rev = rng.random(REFMAP_READS) < 0.5
    reads[rev] = reverse_complement_codes(reads[rev])
    return reads, genome, pos, rev


def make_profiles(rng):
    """PROFILES protein profiles, each the BLOSUM62 rows of a random
    consensus of PROFILE_LEN residues times 2 (entries -8..22, so 8-bit
    fields), and a pool of POOL random proteins of POOL_LEN residues with
    PLANTED_PER_PROFILE instances of each consensus (10% substitutions)
    planted in its first POOL_SLICE entries: (profiles, pool, planted)."""
    from versalignlib_tpu_torch.alphabet import blosum62

    blosum = np.array(blosum62(), dtype=np.int32)
    cons = rng.integers(1, 21, size=(PROFILES, PROFILE_LEN))
    profiles = [2 * blosum[c] for c in cons]
    pool = rng.integers(1, 21, size=(POOL, POOL_LEN)).astype(np.uint8)
    planted = rng.choice(POOL_SLICE, size=PROFILES * PLANTED_PER_PROFILE,
                         replace=False).reshape(PROFILES, PLANTED_PER_PROFILE)
    for k in range(PROFILES):
        for e in planted[k]:
            off = rng.integers(0, POOL_LEN - PROFILE_LEN + 1)
            pool[e, off:off + PROFILE_LEN] = _substitute(rng, cons[k], 0.1, 20)
    return profiles, pool, planted


def make_translated(rng):
    """PROTEINS random proteins of POOL_LEN residues, and TRANSLATED_READS
    DNA reads of READ_LEN bp, each the back-translation of READ_LEN / 3
    residues of one protein, half reverse-complemented: (reads, proteins,
    source protein, reverse)."""
    from versalignlib_tpu_torch.alphabet import (PROTEIN_ALPHABET, pad_and_encode,
                                                 reverse_complement_codes)
    from versalignlib_tpu_torch.translate import GENETIC_CODE

    codon = {aa: c for c, aa in GENETIC_CODE.items()}
    proteins = rng.integers(1, 21, size=(PROTEINS, POOL_LEN)).astype(np.uint8)
    n_aa = READ_LEN // 3
    src = rng.integers(0, PROTEINS, size=TRANSLATED_READS)
    off = rng.integers(0, POOL_LEN - n_aa + 1, size=TRANSLATED_READS)
    reads = pad_and_encode(["".join(codon[PROTEIN_ALPHABET[c - 1]] for c in proteins[s, o:o + n_aa])
                            for s, o in zip(src, off)])
    rev = rng.random(TRANSLATED_READS) < 0.5
    reads[rev] = reverse_complement_codes(reads[rev])
    return reads, proteins, src, rev


def frame_queries(reads: np.ndarray) -> np.ndarray:
    """The six frame translations of each read, encoded, as
    ``translated_search`` scores them."""
    from versalignlib_tpu_torch.alphabet import PROTEIN_ALPHABET, encode_custom
    from versalignlib_tpu_torch.translate import FRAMES, translate_codes

    return encode_custom([translate_codes(r[:np.count_nonzero(r)], f)
                          for r in reads for f in FRAMES], PROTEIN_ALPHABET)


def make_search_data(rng) -> dict:
    from versalignlib_tpu_torch.refmap import tile_references

    data = {"map_reads": make_map_reads(rng), "map_to_reference": make_genome(rng),
            "profile_search": make_profiles(rng), "translated_search": make_translated(rng)}
    genome = data["map_to_reference"][1]
    window = -(-4 * READ_LEN // 128) * 128   # map_to_reference's default
    data["windows"] = tile_references(genome, window, window // 2).windows
    data["frames"] = frame_queries(data["translated_search"][0])
    return data


def search_launches(data) -> dict:
    """Each search path's one-vs-many launch as its entry point makes it:
    name -> (params, queries, pool, kind), kind "cross" (reads, refs) or
    "profile" (table, pool). ``map_reads`` scores all reads against the
    whole panel (the reads are the pool), ``map_to_reference`` all reads
    against one chunk of 2^20 / 256 windows (the windows are the pool),
    ``profile_search`` all profiles against the pool, and
    ``translated_search`` all frame queries against one chunk of
    2^20 // 6144 proteins (the frame queries are the pool)."""
    sets = _param_sets()
    reads, panel = data["map_reads"][:2]
    rm_reads = data["map_to_reference"][0]
    profiles, pool = data["profile_search"][:2]
    proteins = data["translated_search"][1]
    frames = data["frames"]
    from versalignlib_tpu_torch.translate import TRANSLATED_PARAMETERS

    return {
        "map_reads,dna_default": (sets["dna_default"], reads, panel, "cross"),
        "map_reads,dna_affine_bwamem": (sets["dna_affine_bwamem"], reads, panel, "cross"),
        "map_to_reference": (sets["dna_default"], rm_reads,
                             data["windows"][:(1 << 20) // REFMAP_READS], "cross"),
        "profile_search": (_profile_params(), np.stack(profiles), pool, "profile"),
        "translated_search": (TRANSLATED_PARAMETERS, frames,
                              proteins[:(1 << 20) // frames.shape[0]], "cross"),
    }


def search_align_pairs(data) -> dict:
    """Each aligning search path's fill launch, at the shape its entry point
    makes it, on the pairs its planted truth wins: name -> (params, reads,
    refs). ``map_reads`` aligns each read, turned to its strand, against its
    panel entry; ``map_to_reference`` each read against the window that
    holds its start; ``translated_search`` one frame query per read against
    its protein. (``profile_search`` walks its alignments on the host.)"""
    from versalignlib_tpu_torch.alphabet import reverse_complement_codes
    from versalignlib_tpu_torch.translate import TRANSLATED_PARAMETERS

    sets = _param_sets()
    reads, panel, src, rev = data["map_reads"]
    oriented = np.where(rev[:, None], reverse_complement_codes(reads), reads)
    rm_reads, _, pos, rm_rev = data["map_to_reference"]
    rm_oriented = np.where(rm_rev[:, None], reverse_complement_codes(rm_reads), rm_reads)
    windows = data["windows"]
    stride = windows.shape[1] // 2
    held = windows[np.minimum(pos // stride, len(windows) - 1)]
    t_src = data["translated_search"][2]
    frames = data["frames"][:TRANSLATED_READS]
    proteins = data["translated_search"][1][np.repeat(t_src, 6)[:TRANSLATED_READS]]
    return {
        "map_reads,dna_default": (sets["dna_default"], oriented, panel[src]),
        "map_reads,dna_affine_bwamem": (sets["dna_affine_bwamem"], oriented, panel[src]),
        "map_to_reference": (sets["dna_default"], rm_oriented, held),
        "translated_search": (TRANSLATED_PARAMETERS, frames, proteins),
    }


def search_geometry(data, lines: list[str], sms: int) -> list[str]:
    """Each search launch (``search_launches``): the instantiation it runs,
    the ref columns a lane owns and the stripes, the blocks (of 128 threads,
    8 pairs) and warps launched per SM, the blocks and warps an SM holds at
    once (by the instantiation's registers, allocated 256 a warp of 65536,
    and by shared memory, 233472 bytes with 1 KB reserved a block; at most
    16 blocks, 64 warps), the shared memory of a block, and
    ``search_mem_plan`` against the (n, pairs) H (and F) row scratch that
    a thread per pair kept in device memory before."""
    from versalignlib_tpu_torch.ops import cuda_search as cu

    regs = registers(lines)
    out = []
    for name, (params, queries, pool, kind) in search_launches(data).items():
        affine = params.affine
        if kind == "profile":
            (k, m, s), (r, n) = queries.shape, pool.shape
            table_bytes, code_bytes = 4 * m * s, 0
        else:
            (b, m), (rp, n) = queries.shape, pool.shape
            k, r = (b, rp) if rp >= b else (rp, b)
            code_bytes = m if rp >= b else n
            table_bytes = 0 if cu.dna_fits_bytes(params) else 4 * params.sub_size ** 2
        cols = cu.search_cols(m, n)
        stripes = -(-n // (cu.LANES * cols))
        edge = (4 * cu.PAIRS_PER_BLOCK * m * (2 if affine else 1)
                if stripes > 1 and cu.edge_in_shared(m, n, affine) else 0)
        rest = edge + code_bytes
        if not table_bytes:
            sub, smem = 0, rest
        elif table_bytes + rest <= cu.SMEM_BYTES:
            sub, smem = 1, table_bytes + rest
        else:
            sub, smem = 2, rest
        blocks = -(-r // cu.PAIRS_PER_BLOCK) * k
        pairs = k * r
        plan = cu.search_mem_plan(n, pairs, affine, m)
        row_scratch = pairs * (4 * n * (2 if affine else 1) + 12)
        algs = [(1, int(kind == "profile"))] + [(0, 0)]
        for local, coords in algs:
            inst = f"search_kernel<{local},{int(affine)},{coords},{sub},{cols}>"
            resident = resident_blocks(regs.get(inst, 255), smem)
            out.append(f"{name} {'SW' if local else 'NW'}: {inst} {regs.get(inst, '?')} "
                       f"registers; {k} queries x {r} pool, {m}x{n}, {cols} cols a lane, {stripes} "
                       f"stripe(s); {blocks} blocks, {4 * blocks / sms:.1f} warps launched "
                       f"per SM, {resident} blocks ({4 * resident} warps) resident per SM; "
                       f"{smem} B shared a block; mem plan {plan / 2**20:.1f} MiB "
                       f"(row scratch before: {row_scratch / 2**20:.1f} MiB)")
    return out


def _plain_slice(kind: str, name: str, queries, pool):
    """The slice of a launch that the plain version scores: PLAIN_QUERIES
    of its queries (the smaller side) against the whole pool."""
    q = PLAIN_QUERIES[name.split(",")[0]]
    if kind == "profile":
        return queries[:q], pool
    if queries.shape[0] >= pool.shape[0]:        # the reads are the pool
        return queries, pool[:q]
    return queries[:q], pool


def phase_search_kernels_vs_plain(rng, dev, data) -> tuple[dict, dict]:
    """Every branch of the one-vs-many kernel against its plain version, and
    each search path's fill launch against the fill's plain version; returns
    the max abs error per search path (0) of each: (search, fill)."""
    from versalignlib_tpu_torch.ops import cuda_search, plain
    from versalignlib_tpu_torch.params import AlignmentParameters
    from versalignlib_tpu_torch.types import Algorithm

    err: dict[str, int] = {}
    sw, nw = Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH

    def hold(key, label, got, want):
        err[key] = max(err.get(key, 0), check_equal(f"search.cu {key} {label}", got, want))

    def cross(key, label, reads, refs, params, say=True):
        r = torch.from_numpy(np.ascontiguousarray(reads)).to(dev)
        f = torch.from_numpy(np.ascontiguousarray(refs)).to(dev)
        for alg in Algorithm:
            hold(key, f"{label} {alg.name}", cuda_search.cross_scores_device(r, f, params, alg),
                 plain.cross_scores(r, f, params, alg))
        side = "reads" if r.shape[0] > f.shape[0] else "refs"
        if say:
            log(f"[search] search.cu == plain  {key:30s} {label}: SW, NW; "
                f"{r.shape[0]}x{r.shape[1]} reads vs {f.shape[0]}x{f.shape[1]} refs, "
                f"pool = {side}")

    def profile(key, label, table, pool, params, say=True):
        t = torch.from_numpy(np.ascontiguousarray(table)).to(dev)
        p = torch.from_numpy(np.ascontiguousarray(pool)).to(dev)
        got = cuda_search.pssm_scores_device(t, p, params, sw, with_coords=True)
        want = plain.profile_scores(t, p, params, sw, with_coords=True)
        for part, g, w in zip(("score", "end_row", "end_col"), got, want):
            hold(key, f"{label} SW {part}", g, w)
        hold(key, f"{label} NW", cuda_search.pssm_scores_device(t, p, params, nw),
             plain.profile_scores(t, p, params, nw))
        if say:
            log(f"[search] search.cu == plain  {key:30s} {label}: SW with coords, NW; "
                f"{tuple(t.shape)} profiles vs {p.shape[0]}x{p.shape[1]} pool")

    # Each path's launch, on a slice of its queries against the full pool.
    for name, (params, queries, pool, kind) in search_launches(data).items():
        q, p = _plain_slice(kind, name, queries, pool)
        (profile if kind == "profile" else cross)(name, "launch slice", q, p, params)
    # Odd shapes in both orientations, codes past S, every gap model and
    # scoring; the errors count towards every path's entry.
    odd = "odd shapes"
    mat = _random_matrix(rng, 30)
    for label, params, hi in (
            ("dna linear", AlignmentParameters(score_gap_read=-2, score_gap_ref=-3), 8),
            ("dna affine", AlignmentParameters(gap_open_read=-5, gap_open_ref=-4), 8),
            ("matrix linear", AlignmentParameters(score_gap_read=-3, score_gap_ref=-2,
                                                  matrix=mat), 36),
            ("matrix affine", AlignmentParameters(score_gap_read=-1, score_gap_ref=-2,
                                                  gap_open_read=-3, gap_open_ref=-4,
                                                  matrix=mat), 36)):
        for (qb, qm), (pb, pn) in (SEARCH_ODD, SEARCH_ODD[::-1]):
            cross(odd, label, rng.integers(0, hi, size=(qb, qm)).astype(np.uint8),
                  rng.integers(0, hi, size=(pb, pn)).astype(np.uint8), params)
    lin = AlignmentParameters(score_gap_read=-3, score_gap_ref=-2)
    aff = AlignmentParameters(score_gap_read=-1, score_gap_ref=-2, gap_open_read=-6,
                              gap_open_ref=-5)
    (k, m), (r, n) = (3, SEARCH_ODD[0][1]), SEARCH_ODD[1]
    for lo, hi in ((-4, 11), (-60, 100)):           # 4-bit and 8-bit fields
        table = rng.integers(lo, hi + 1, size=(k, m, 25)).astype(np.int32)
        table[:, :, 0] = 0
        pool = rng.integers(0, 31, size=(r, n)).astype(np.uint8)
        for params in (lin, aff):
            profile(odd, f"pssm {lo}..{hi} {'affine' if params.affine else 'linear'}",
                    table, pool, params)
    # Profiles past the 48 KB default: 100 KB in shared memory (opt-in) and
    # 250 KB through the read-only cache.
    for m_big in (1000, 2500):
        table = rng.integers(-4, 12, size=(2, m_big, 25)).astype(np.int32)
        table[:, :, 0] = 0
        pool = rng.integers(0, 31, size=(256, 77)).astype(np.uint8)
        for params in (lin, aff):
            profile(odd, f"pssm {m_big * 25 * 4 // 1000} KB "
                    f"{'affine' if params.affine else 'linear'}", table, pool, params)
    phase_search_edges(rng, dev, cross, profile, odd)
    # Each aligning path's fill kernel at its own align shape.
    fills = {}
    for name, (params, r_np, f_np) in search_align_pairs(data).items():
        (b, m), n = r_np.shape, f_np.shape[1]
        fills[name] = {"source": f"versalignlib_tpu_torch/csrc/{_fill_source(params)}",
                       "shape": [b, m, n],
                       "max_abs_err": check_fill(f"{_fill_source(params)} {name}", r_np,
                                                 f_np, params, dev)}
        log(f"[search] {_fill_source(params)} == plain  {name:30s} SW, NW x both flavors "
            f"B={b} {m}x{n} (ptr, aux, hsel): the path's align shape")
    torch.cuda.synchronize()
    big = err.pop(odd)
    return {key: max(e, big) for key, e in err.items()}, fills


@contextlib.contextmanager
def _search_width(cols: int):
    """While active, every launch of the one-vs-many kernel and of the score
    kernel gives each lane ``cols`` ref columns, whatever
    ``cuda_search.search_cols`` would choose (the output does not depend on
    it)."""
    from versalignlib_tpu_torch.ops import cuda_search

    chosen = cuda_search.search_cols
    cuda_search.search_cols = lambda m, n: cols
    try:
        yield
    finally:
        cuda_search.search_cols = chosen


def _periodic_pool(rng, rows: int, n: int, size: int) -> np.ndarray:
    """Pool codes: a third periodic (period 4, so a maximum recurs across
    lanes and stripes), a third random with codes past ``size``, and a
    third of padding (best 0, cell (0, 0))."""
    pool = rng.integers(0, size + 6, size=(rows, n)).astype(np.uint8)
    pool[: rows // 3] = np.tile(np.array([1, 2, 3, 1], np.uint8), -(-n // 4))[:n]
    pool[rows - rows // 3:] = 0
    return pool


def phase_search_edges(rng, dev, cross, profile, key: str) -> None:
    """The one-vs-many kernel against its plain version at the edges of its
    lane groups (SEARCH_EDGE_M x SEARCH_EDGE_N), at both column widths:
    default DNA (byte tables; scores at the byte's limits; scores past a
    byte, through the 6 x 6 matrix), a 30 x 30 matrix, linear and affine,
    both orientations, SW and NW; PSSMs with a periodic tie-heavy profile
    and pool (SW with coordinates, NW) and all-padding entries; and an NW
    batch whose overlap score clamps at 0; and affine reads of
    SEARCH_EDGE_DEEP rows, whose boundary columns live in device memory."""
    from versalignlib_tpu_torch.ops import cuda_search, plain
    from versalignlib_tpu_torch.params import AlignmentParameters
    from versalignlib_tpu_torch.types import Algorithm

    mat = _random_matrix(rng, 30)
    sets = (("dna linear", AlignmentParameters(score_gap_read=-2, score_gap_ref=-3), 4),
            ("dna affine", AlignmentParameters(gap_open_read=-5, gap_open_ref=-4), 4),
            ("dna byte limits", AlignmentParameters(score_match=127, score_mismatch=-128,
                                                    score_gap_read=-60, score_gap_ref=-70), 4),
            ("dna past a byte", AlignmentParameters(score_match=300, score_mismatch=-200,
                                                    score_gap_read=-7, score_gap_ref=-5,
                                                    gap_open_read=-40, gap_open_ref=-30), 4),
            ("matrix linear", AlignmentParameters(score_gap_read=-3, score_gap_ref=-2,
                                                  matrix=mat), 30),
            ("matrix affine", AlignmentParameters(score_gap_read=-1, score_gap_ref=-2,
                                                  gap_open_read=-3, gap_open_ref=-4,
                                                  matrix=mat), 30))
    lin = AlignmentParameters(score_gap_read=-3, score_gap_ref=-2)
    aff = AlignmentParameters(score_gap_read=-1, score_gap_ref=-2, gap_open_read=-6,
                              gap_open_ref=-5)
    q, pool_rows = SEARCH_EDGE_QUERIES, SEARCH_EDGE_POOL
    t0 = time.perf_counter()
    for m in SEARCH_EDGE_M:
        for n in SEARCH_EDGE_N:
            for label, params, size in sets:
                reads = _periodic_pool(rng, pool_rows, m, size)
                refs = _periodic_pool(rng, pool_rows, n, size)
                for cols in (32, 40):
                    with _search_width(cols):
                        # Pool = refs (query_is_read), then pool = reads.
                        cross(key, f"{label} {m}x{n} {cols} cols", reads[:q], refs, params,
                              say=False)
                        cross(key, f"{label} {m}x{n} {cols} cols", reads, refs[:q], params,
                              say=False)
            # A PSSM whose best recurs along the periodic pool's diagonals.
            table = rng.integers(-3, 3, size=(q, m, 25)).astype(np.int32)
            pattern = np.array([1, 2, 3, 1])[np.arange(m) % 4]
            table[:, np.arange(m), pattern] = 4
            table[:, :, 0] = 0
            pool = _periodic_pool(rng, pool_rows, n, 25)
            for params in (lin, aff):
                for cols in (32, 40):
                    with _search_width(cols):
                        profile(key, f"pssm {'affine' if params.affine else 'linear'} "
                                f"{m}x{n} {cols} cols", table, pool, params, say=False)
    # Read rows whose boundary columns do not fit shared memory: they go to
    # device memory (cuda_search.edge_in_shared).
    m, n = SEARCH_EDGE_DEEP
    if cuda_search.edge_in_shared(m, n, True):
        raise AssertionError("the deep edge shape keeps its boundary in shared memory")
    cross(key, f"dna affine {m}x{n} boundary in device memory",
          _periodic_pool(rng, SEARCH_EDGE_QUERIES, m, 4),
          _periodic_pool(rng, SEARCH_EDGE_POOL // 3, n, 4), sets[1][1], say=False)
    # NW overlap scores that clamp at 0: every cell a mismatch or a gap.
    reads = np.full((SEARCH_EDGE_QUERIES, 33), 1, np.uint8)
    refs = np.full((SEARCH_EDGE_POOL, 1100), 2, np.uint8)
    r, f = (torch.from_numpy(x).to(dev) for x in (reads, refs))
    nw = Algorithm.NEEDLEMAN_WUNSCH
    want = plain.cross_scores(r, f, lin, nw)
    if bool((want != 0).any()):
        raise AssertionError("the NW clamp batch does not clamp")
    for cols in (32, 40):
        with _search_width(cols):
            check_equal(f"search.cu {key} NW clamp {cols} cols",
                        cuda_search.cross_scores_device(r, f, lin, nw), want)
    torch.cuda.synchronize()
    log(f"[search] search.cu edges: m {SEARCH_EDGE_M} x n {SEARCH_EDGE_N} x 32, 40 cols, "
        f"{len(sets)} scorings + PSSMs, NW clamp: {time.perf_counter() - t0:.1f} s")


class _LaunchTimer:
    """While active, records CUDA events around each launch of ``kernel``;
    ``ms()`` sums their device time."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.events = []

    def __enter__(self):
        launch = self.kernel.launch

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(*args)
            end.record()
            self.events.append((start, end))

        self.kernel.launch = timed
        return self

    def __exit__(self, *exc):
        del self.kernel.launch

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


@contextlib.contextmanager
def _host_timed(module, name: str, acc: list):
    """While active, ``module.name`` appends its synchronised host time in
    ms to ``acc`` on each call."""
    fn = getattr(module, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.synchronize()
            acc.append(1e3 * (time.perf_counter() - t0))

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def _plain_search():
    """The reference runs, plain throughout on the card: the one-vs-many
    kernel's wrappers, the fill launch and the walk swapped for their plain
    versions. Raises if a kernel launched all the same."""
    from versalignlib_tpu_torch.ops import cuda_align, cuda_search, plain
    from versalignlib_tpu_torch.ops.cuda_align import AFFINE_KERNEL, ALIGN_KERNEL
    from versalignlib_tpu_torch.ops.cuda_search import SEARCH_KERNEL

    from versalignlib_tpu_torch.ops import cuda_walk

    def plain_fill(reads, refs, mrp, params, algorithm, tie):
        return _plain_fill(params)(reads, refs, mrp, params, algorithm, tie)

    kernels = (SEARCH_KERNEL, ALIGN_KERNEL, AFFINE_KERNEL, cuda_walk.WALK_KERNEL)
    before = [k.launches for k in kernels]
    saved = (cuda_search.cross_scores_device, cuda_search.pssm_scores_device,
             cuda_align._launch_fill, cuda_walk.walk)
    cuda_search.cross_scores_device = plain.cross_scores
    cuda_search.pssm_scores_device = plain.profile_scores
    cuda_align._launch_fill = plain_fill
    cuda_walk.walk = _plain_walks()[0]
    try:
        yield
    finally:
        (cuda_search.cross_scores_device, cuda_search.pssm_scores_device,
         cuda_align._launch_fill, cuda_walk.walk) = saved
    if [k.launches for k in kernels] != before:
        raise AssertionError("a kernel launched during a plain reference run")


def _run_path(name: str, fn, fill: str | None):
    """Run ``fn`` once with every launch count set to 0 just before and read
    just after; the one-vs-many kernel must have launched, and ``fill`` (the
    fill kernel of the path's parameters) too, the other fill kernel not
    (the walk kernel's launches are logged: paths that align through the
    backend walk on the card, ``translated_search`` on the host).
    Returns (result, {"launches", "split"}), the split in ms: wall, the
    one-vs-many kernel (CUDA events), the align path (host clock; its fill
    kernels by CUDA events) and the rest."""
    from versalignlib_tpu_torch.ops import cuda_align, pssm
    from versalignlib_tpu_torch.ops.cuda_align import AFFINE_KERNEL, ALIGN_KERNEL
    from versalignlib_tpu_torch.ops.cuda_score import SCORE_KERNEL
    from versalignlib_tpu_torch.ops.cuda_search import SEARCH_KERNEL

    from versalignlib_tpu_torch.ops.cuda_walk import WALK_KERNEL

    kernels = {"search": SEARCH_KERNEL, "score": SCORE_KERNEL, "align": ALIGN_KERNEL,
               "align_affine": AFFINE_KERNEL, "walk": WALK_KERNEL}
    align_ms: list[float] = []
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    with _LaunchTimer(SEARCH_KERNEL) as b4, _LaunchTimer(ALIGN_KERNEL) as f1, \
            _LaunchTimer(AFFINE_KERNEL) as f2, \
            _host_timed(cuda_align, "align_batch", align_ms), \
            _host_timed(pssm, "profile_align_oracle", align_ms):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    launches = {k: v.launches for k, v in kernels.items()}
    if launches["search"] < 1:
        raise AssertionError(f"{name}: the path never launched the one-vs-many kernel")
    for fill_kernel in ("align", "align_affine"):
        if (fill_kernel == fill) != (launches[fill_kernel] >= 1):
            raise AssertionError(f"{name}: {fill_kernel} launched {launches[fill_kernel]} "
                                 f"times; the path's fill kernel is {fill}")
    split = {"wall_ms": wall, "search_ms": b4.ms(), "align_ms": sum(align_ms),
             "align_fill_ms": f1.ms() + f2.ms()}
    split["rest_ms"] = wall - split["search_ms"] - split["align_ms"]
    log(f"[path] {name}: launches {launches}; "
        + json.dumps({k: round(v, 3) for k, v in split.items()}))
    return result, {"launches": launches, "split": split}


def _check_fields(name: str, got, want, rows, fields) -> None:
    for field in fields:
        g = np.asarray(getattr(got, field))
        if rows is not None:
            g = g[rows]
        if not np.array_equal(g, np.asarray(getattr(want, field))):
            raise AssertionError(f"{name}: {field} differs from the plain reference")


def _check_alignments(name: str, got: list, want: list) -> None:
    if len(got) != len(want) or not all(map(_same_alignment, got, want)):
        raise AssertionError(f"{name}: alignments differ from the plain reference")


def phase_search_paths(rng, data) -> dict:
    """The four search entry points at full size, each checked on a subset
    against its plain reference run, and the planted truth."""
    from versalignlib_tpu_torch import (map_reads, map_to_reference, profile_search,
                                        translated_search)

    out = {}
    reads, panel, src, rev = data["map_reads"]
    pick = np.sort(rng.choice(reads.shape[0], SEARCH_CHECK, replace=False))
    for pname in ("dna_default", "dna_affine_bwamem"):
        params = _param_sets()[pname]
        name = f"map_reads,{pname}"
        hits, out[name] = _run_path(name, lambda: map_reads(reads, panel, params),
                                    "align_affine" if params.affine else "align")
        if not ((hits.index == src).all() and (hits.strand == rev).all()):
            raise AssertionError(f"{name}: {(hits.index != src).sum()} reads off their "
                                 f"entry, {(hits.strand != rev).sum()} off their strand")
        with _plain_search():
            want = map_reads(reads[pick], panel, params)
        _check_fields(name, hits, want, pick, ("index", "score", "strand", "mapq"))
        _check_alignments(name, [hits.alignments[i] for i in pick], want.alignments)
        log(f"[path] {name}: {SEARCH_READS} reads vs {SEARCH_PANEL} x {PANEL_LEN} bp, both "
            f"strands: every read on its entry and strand; {SEARCH_CHECK} == plain reference")

    reads, genome, pos, rev = data["map_to_reference"]
    name = "map_to_reference"
    hits, out[name] = _run_path(name, lambda: map_to_reference(reads, genome), "align")
    starts = np.array([a.ref_start for a in hits.alignments])
    if not ((hits.ref_id == 0).all() and (hits.strand == rev).all() and (starts == pos).all()):
        raise AssertionError(f"{name}: {(starts != pos).sum()} reads off their start, "
                             f"{(hits.strand != rev).sum()} off their strand")
    pick = np.sort(rng.choice(reads.shape[0], SEARCH_CHECK, replace=False))
    with _plain_search():
        want = map_to_reference(reads[pick], genome)
    _check_fields(name, hits, want, pick, ("ref_id", "pos", "score", "strand", "mapq"))
    _check_alignments(name, [hits.alignments[i] for i in pick], want.alignments)
    log(f"[path] {name}: {REFMAP_READS} reads vs {GENOME_LEN} bp ({len(data['windows'])} "
        f"windows): every read at its planted start and strand; {SEARCH_CHECK} == plain reference")

    profiles, pool, planted = data["profile_search"]
    name = "profile_search"
    params = _profile_params()

    def search(p):
        return profile_search(profiles, p, params, k=10, hits=True, alignments=True)

    hits, out[name] = _run_path(name, lambda: search(pool), None)
    for k, found in enumerate(hits):
        if not set(planted[k]) <= {h.index for h in found}:
            raise AssertionError(f"{name}: profile {k} misses a planted instance")
    got = search(pool[:POOL_SLICE])
    with _plain_search():
        want = search(pool[:POOL_SLICE])
    if got != want:
        raise AssertionError(f"{name}: hits on the {POOL_SLICE}-entry slice differ "
                             "from the plain reference")
    log(f"[path] {name}: {PROFILES} profiles x {PROFILE_LEN} vs {POOL} x {POOL_LEN}: every "
        f"planted instance in its top 10; all hits on {POOL_SLICE} entries == plain reference")

    reads, proteins, src, rev = data["translated_search"]
    name = "translated_search"
    hits, out[name] = _run_path(name, lambda: translated_search(reads, proteins, alignments=True),
                                "align_affine")
    if not ((hits.index == src).all() and ((hits.frame < 0) == rev).all()):
        raise AssertionError(f"{name}: {(hits.index != src).sum()} reads off their protein, "
                             f"{((hits.frame < 0) != rev).sum()} off their strand")
    rows = np.arange(SEARCH_CHECK)
    with _plain_search():
        want = translated_search(reads[rows], proteins, alignments=True)
    _check_fields(name, hits, want, rows, ("index", "frame", "score", "scores", "dna_start",
                                           "dna_end", "strand"))
    if hits.dna_cigar[:SEARCH_CHECK] != want.dna_cigar \
            or hits.proteins[:SEARCH_CHECK] != want.proteins:
        raise AssertionError(f"{name}: CIGARs or translations differ from the plain reference")
    _check_alignments(name, hits.alignments[:SEARCH_CHECK], want.alignments)
    log(f"[path] {name}: {TRANSLATED_READS} reads vs {PROTEINS} x {POOL_LEN}: every read on "
        f"its protein and strand; {SEARCH_CHECK} == plain reference")
    return out


def _search_call(kind, q, p, params, alg):
    from versalignlib_tpu_torch.ops import cuda_search, plain

    if kind == "profile":
        return (lambda: cuda_search.pssm_scores_device(q, p, params, alg, with_coords=True),
                lambda: plain.profile_scores(q, p, params, alg, with_coords=True))
    return (lambda: cuda_search.cross_scores_device(q, p, params, alg),
            lambda: plain.cross_scores(q, p, params, alg))


def phase_search_times(dev, data, paths: dict, errs: dict, fills: dict) -> list[dict]:
    """The one-vs-many kernel at each path's launch shape (SW; NW too where
    the launch is a cross product), its plain version at the slice shape,
    and the bound."""
    from versalignlib_tpu_torch.types import Algorithm

    entries = []
    for name, (params, queries, pool, kind) in search_launches(data).items():
        q = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
        p = torch.from_numpy(np.ascontiguousarray(pool)).to(dev)
        q_pl, p_pl = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                      for x in _plain_slice(kind, name, queries, pool))
        if kind == "profile":
            k, m, s = q.shape
            r, n = p.shape
            nbytes = 4 * k * m * s + r * n + 12 * k * r
            plain_cells = q_pl.shape[0] * q_pl.shape[1] * p_pl.shape[0] * n
        else:
            (k, m), (r, n) = q.shape, p.shape
            s = params.sub_size
            nbytes = k * m + r * n + 4 * s * s + 4 * k * r
            plain_cells = q_pl.shape[0] * m * p_pl.shape[0] * n
        cells = k * r * m * n
        gap = "affine" if params.affine else "linear"
        t = {}
        for alg, key in ((Algorithm.SMITH_WATERMAN, "sw"), (Algorithm.NEEDLEMAN_WUNSCH, "nw")):
            if kind == "profile" and key == "nw":
                continue
            kernel = _search_call(kind, q, p, params, alg)[0]
            plain_fn = _search_call(kind, q_pl, p_pl, params, alg)[1]
            km = time_cuda(kernel)
            pm = time_cuda(plain_fn, reps=PLAIN_REPS)
            sw_ops, nw_ops = ops_per_cell("search", gap, "profile")
            ops = (sw_ops + (SEARCH_COORDS_OPS if kind == "profile" else 0)
                   if key == "sw" else nw_ops)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops * cells / INT32_OPS_PER_S
            bd = 1e3 * max(t_bytes, t_ops)
            t[key] = {"ms": km["median"], "ms_min": km["min"], "ms_max": km["max"],
                      "gcups": cells / km["median"] / 1e6, "plain_ms": pm["median"],
                      "bound_ms": bd, "bound_by": "bytes" if t_bytes > t_ops else "operations"}
            log(f"[times] search.cu {name} {key} {k}x{m} vs {r}x{n}: {km['median']:.3f} ms "
                f"(min {km['min']:.3f}, max {km['max']:.3f}), {t[key]['gcups']:.1f} GCUPS; "
                f"plain {pm['median']:.1f} ms on {plain_cells:.3g} cells; bound {bd:.3f} ms "
                f"({t[key]['bound_by']})")
        sw = t["sw"]
        entry = {
            "name": f"search[{name}]", "route": "cuda",
            "source": "versalignlib_tpu_torch/csrc/search.cu",
            "replaces": "versalignlib_tpu/ops/pallas_search.py:45",
            "launches": paths[name]["launches"]["search"], "max_abs_err": errs[name],
            "tolerance": 0, "ms": sw["ms"], "plain_ms": sw["plain_ms"],
            "bound_ms": sw["bound_ms"], "bound_by": sw["bound_by"], "library_ms": None,
            "params": name, "launch_shape": [k, r, m, n], "algorithm": "SW",
            "coords": kind == "profile", "ms_min": sw["ms_min"], "ms_max": sw["ms_max"],
            "gcups": sw["gcups"], "plain_cells": plain_cells,
            "path_split_ms": paths[name]["split"], "matches_plain": True,
        }
        if "nw" in t:
            entry["nw"] = t["nw"]
        if name in fills:
            entry["align_fill_vs_plain"] = fills[name]
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# The long-pair paths: the banded kernels (csrc/banded_score.cu, B5, and
# csrc/banded_align.cu, B6)
# ---------------------------------------------------------------------------

#: The banded shapes. BANDED_ODD (pairs, m, n, band) is the branch sweep's
#: shape: steps of 2 columns a row, a partial last pointer word (333 % 8),
#: and rows padded to the score tile (1500 % 256). BANDED_PAIRS pairs of
#: BANDED_LEN bp at band BAND are the banded models' run (BENCHMARKS.md:140's
#: shape: 1024 pairs of 16 kbp, band 512), BANDED_SLICE of them are held to
#: the plain versions at full length, BANDED_CHECK checked field by field.
BANDED_ODD = (256, 1500, 1800, 333)
BANDED_PAIRS, BANDED_LEN, BAND, BAND_TILE = 1024, 16000, 512, 256
BANDED_SLICE, BANDED_CHECK = 32, 16
#: map_long_reads: LONG_READS HiFi-like reads of LONG_MIN..LONG_MAX bp
#: planted on both strands of the GENOME_LEN reference, and LONG_JUNK random
#: reads of JUNK_LEN bp; a read maps within LONG_SLACK bp of its origin.
LONG_READS, LONG_MIN, LONG_MAX, LONG_JUNK, JUNK_LEN, LONG_SLACK = 256, 12000, 15000, 16, 12000, 50
#: HiFi-like errors: substitutions and indels (of 1-3 bp) per base.
HIFI_SUB, HIFI_INDEL = 0.005, 0.003
#: One round of the banded path with the walk on the card: a wave of
#: LONG_ROUND_PAIRS pairs of LONG_ROUND_LEN bp at band BAND (13.5 GB of
#: pointer words that never leave the card), LONG_ROUND_CHECK of them
#: checked against the host walk.
LONG_ROUND_PAIRS, LONG_ROUND_LEN, LONG_ROUND_CHECK = 528, 100_000, 4

#: Wide bands and a large matrix, held to the plain versions: (label,
#: pairs, m, n, band, gap, algorithms). Bands this wide keep their rows in
#: device memory (ops/cuda_banded.rows_in_shared is false), and a matrix of
#: BANDED_BIG_MATRIX residues (160 KB) is read through the read-only cache.
BANDED_WIDE = (("dna_default", 8, 16000, 16000, 16000, ("sw",)),
               ("dna_affine_bwamem", 8, 16000, 16000, 4000, ("nw",)))
BANDED_BIG_MATRIX, BANDED_BIG_MATRIX_SHAPE = 200, (64, 300, 360, 203)
#: The edges of the banded kernels' row layout (csrc/banded.cuh), each
#: held to the plain versions under every parameter set, SW and NW, both
#: flavors: (label, pairs, m, n, band, reads). "random" reads are random
#: codes, "edge" half of them copies of their ref shifted by half the band
#: (the SW maximum runs along the band's right edge while the band is still
#: pinned at column 0, where a lane's last pointer word is partial), "ties"
#: the periodic batch of ``tie_batch`` (its last reads all N or padding),
#: "padding" reads of padding alone (NW's mrp < 0).
BANDED_EDGES = (
    ("band 8, 31 lanes empty", 16, 96, 96, 8, "edge"),
    ("band 20, a partial word, 29 lanes empty", 16, 96, 96, 20, "edge"),
    ("band == n, every offset 0", 8, 80, 72, 72, "random"),
    ("steps of 3-4 (n ~ 3.8 m)", 8, 48, 184, 16, "random"),
    ("cols 24 (band 700)", 4, 40, 760, 700, "edge"),
    ("cols 32 (band 1024, the register limit)", 4, 40, 1080, 1024, "random"),
    ("cols 40 (band 1030, two chunks)", 4, 40, 1080, 1030, "edge"),
    ("all padding, NW mrp < 0", 8, 48, 64, 24, "padding"),
    ("tie-heavy periodic, band 45", 16, 64, 80, 45, "ties"),
    ("rows in device memory (band 6700, cols 216)", 2, 24, 6760, 6700, "random"),
)


def _all_kernels():
    """Every kernel of the package, by name."""
    from versalignlib_tpu_torch.ops.cuda_align import AFFINE_KERNEL, ALIGN_KERNEL
    from versalignlib_tpu_torch.ops.cuda_banded import BANDED_ALIGN_KERNEL, BANDED_SCORE_KERNEL
    from versalignlib_tpu_torch.ops.cuda_score import SCORE_KERNEL
    from versalignlib_tpu_torch.ops.cuda_search import SEARCH_KERNEL
    from versalignlib_tpu_torch.ops.cuda_walk import BANDED_WALK_KERNEL, WALK_KERNEL

    return {"score": SCORE_KERNEL, "align": ALIGN_KERNEL, "align_affine": AFFINE_KERNEL,
            "search": SEARCH_KERNEL, "banded_score": BANDED_SCORE_KERNEL,
            "banded_align": BANDED_ALIGN_KERNEL, "walk": WALK_KERNEL,
            "banded_walk": BANDED_WALK_KERNEL}


def hifi_copy(rng, seq: np.ndarray, length: int | None = None) -> np.ndarray:
    """A HiFi-like copy of ``seq``: HIFI_SUB substitutions and HIFI_INDEL
    insertions or deletions of 1-3 bp per base; cut or padded with 0 to
    ``length`` when given."""
    seq = _substitute(rng, seq, HIFI_SUB, 4)
    n = seq.shape[0]
    where = np.sort(rng.choice(n, size=rng.binomial(n, HIFI_INDEL), replace=False))
    parts, lo = [], 0
    for pos in where:
        if pos < lo:
            continue
        size = int(rng.integers(1, 4))
        parts.append(seq[lo:pos])
        if rng.random() < 0.5:      # insertion before pos
            parts.append(rng.integers(1, 5, size=size).astype(np.uint8))
            lo = pos
        else:                       # deletion of seq[pos:pos + size]
            lo = pos + size
    parts.append(seq[lo:])
    out = np.concatenate(parts).astype(np.uint8)
    if length is None:
        return out
    padded = np.zeros(length, dtype=np.uint8)
    padded[:min(length, out.shape[0])] = out[:length]
    return padded


def make_banded_pairs(rng, genome: np.ndarray):
    """BANDED_PAIRS refs, each a BANDED_LEN window of the genome, and reads,
    each a HiFi-like copy of its ref padded to BANDED_LEN."""
    starts = rng.integers(0, genome.shape[0] - BANDED_LEN + 1, size=BANDED_PAIRS)
    refs = genome[starts[:, None] + np.arange(BANDED_LEN)]
    reads = np.stack([hifi_copy(rng, f, BANDED_LEN) for f in refs])
    return reads, refs


def make_long_reads(rng, genome: np.ndarray):
    """LONG_READS HiFi-like reads of LONG_MIN..LONG_MAX bp from random
    origins of the genome, half reverse-complemented, then LONG_JUNK random
    reads of JUNK_LEN: (reads, origin, reverse), origin -1 for junk."""
    from versalignlib_tpu_torch.alphabet import reverse_complement_codes

    lens = rng.integers(LONG_MIN, LONG_MAX + 1, size=LONG_READS)
    origin = rng.integers(0, genome.shape[0] - LONG_MAX, size=LONG_READS)
    rev = rng.random(LONG_READS) < 0.5
    reads = []
    for p, n, r in zip(origin, lens, rev):
        read = hifi_copy(rng, genome[p:p + n])
        reads.append(reverse_complement_codes(read) if r else read)
    reads += [rng.integers(1, 5, size=JUNK_LEN).astype(np.uint8) for _ in range(LONG_JUNK)]
    return (reads, np.concatenate([origin, np.full(LONG_JUNK, -1)]),
            np.concatenate([rev, np.zeros(LONG_JUNK, bool)]))


def _banded_inputs(r_np, f_np, band: int, tile: int | None, dev):
    """Codes on the card, rows padded to ``tile`` (None: not padded), and
    the band starts, as banded_score_batch / banded_align_batch make them."""
    from versalignlib_tpu_torch.ops.banded import band_offsets

    m, n = r_np.shape[1], f_np.shape[1]
    m_pad = m if tile is None else -(-m // tile) * tile
    padded = np.zeros((r_np.shape[0], m_pad), np.uint8)
    padded[:, :m] = r_np
    return (torch.from_numpy(padded).to(dev), torch.from_numpy(np.ascontiguousarray(f_np)).to(dev),
            band_offsets(m_pad, m, n, band))


def check_banded(label, r_np, f_np, params, band, dev, algs=None, ties=None, timed=None,
                 tile=BAND_TILE) -> int:
    """B5 and B6 against their plain versions on the card, every output
    with ``==``: scores at the score tile's padded rows, and (ptr, best,
    keep) under each tie flavor. ``timed`` collects one CUDA-event time of
    each plain call. Returns the max abs error (0)."""
    from versalignlib_tpu_torch.ops import cuda_banded, plain_banded
    from versalignlib_tpu_torch.ops.cuda_align import last_valid_pos
    from versalignlib_tpu_torch.types import Algorithm, TieBreak

    def plain_call(key, fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        if timed is not None:
            timed[key] = start.elapsed_time(end)
        return out

    err = 0
    for alg in algs or Algorithm:
        key = "sw" if alg == Algorithm.SMITH_WATERMAN else "nw"
        r, f, offs = _banded_inputs(r_np, f_np, band, tile, dev)
        got = cuda_banded.score(r, f, offs, params, alg, band)
        want = plain_call(("score", key), lambda: plain_banded.banded_score(
            r, f, offs, params, alg, band))
        err = max(err, check_equal(f"banded_score {label} {alg.name}", got, want))
        r, f, offs = _banded_inputs(r_np, f_np, band, None, dev)
        for tie in ties or TieBreak:
            mrp = torch.from_numpy(last_valid_pos(r_np, tie, params.matrix)).to(dev)
            got = cuda_banded.fill(r, f, offs, mrp, params, alg, tie, band)
            want = plain_call(("align", key), lambda: plain_banded.banded_fill(
                r, f, offs, mrp, params, alg, tie, band))
            for part, g, w in zip(("ptr", "best", "keep"), got, want):
                if (g is None) != (w is None):
                    raise AssertionError(f"banded_align {label} {part}: one side is None")
                if g is not None:
                    err = max(err, check_equal(
                        f"banded_align {label} {part} {alg.name} {tie.name}", g, w))
    return err


def _banded_regs() -> dict:
    """Registers of each banded instantiation, from the builds' reports."""
    from versalignlib_tpu_torch.ops import _build

    regs = {}
    for src in ("banded_score.cu", "banded_align.cu"):
        regs.update(registers(register_report(
            _build.library_path(src).with_suffix(".log").read_text())))
    return regs


def banded_geometry(label: str, params, band: int, pairs: int, kinds=("score", "align"),
                    canon_only: bool = False) -> list[str]:
    """Each banded launch of ``pairs`` pairs at ``band`` under ``params``:
    the instantiation, its registers, the dynamic shared memory of a block,
    the blocks (4 pairs, a warp each) an SM holds at once (by registers,
    allocated 256 a warp of 65536, and by shared memory, 233472 bytes with
    1 KB reserved a block; at most 32 blocks, 64 warps) against the warps
    launched per SM, where the rows live and whether T stays in registers
    (cols <= 32) or each chunk's first pass is computed again."""
    from versalignlib_tpu_torch.ops import cuda_banded as cb

    regs = _banded_regs()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cols = cb.lane_cols(band)
    smem = cb.shared_bytes(band, params)
    mat = 0 if params.matrix is None else (
        1 if 4 * params.sub_size ** 2 + params.sub_size <= cb.SMEM_TABLE_BYTES else 2)
    where = "shared memory" if cb.rows_in_shared(band, params) else "device memory"
    regs_mode = "T in registers" if cb.t_in_registers(band) else \
        f"T recomputed, {-(-cols // cb.CHUNK_COLS)} chunks of {cb.CHUNK_COLS}"
    out = []
    for kind in kinds:
        for local in (1, 0):
            for canon in ((None,) if kind == "score" else ((1,) if canon_only else (1, 0))):
                args = [local, int(params.affine)] + ([] if canon is None else [canon]) + \
                    [mat, int(not cb.t_in_registers(band))]
                inst = f"banded_{kind}_kernel<{','.join(map(str, args))}>"
                per_warp = -(-regs.get(inst, 255) * 32 // 256) * 256
                blocks = min(32, 65536 // (per_warp * cb.WARPS_PER_BLOCK),
                             233472 // (smem + 1024))
                out.append(f"{label}: {inst} {regs.get(inst, '?')} registers, {smem} B shared "
                           f"a block, {blocks} blocks ({blocks * cb.WARPS_PER_BLOCK} warps) "
                           f"resident per SM, {pairs / sms:.1f} warps launched per SM; band "
                           f"{band}, cols {cols}, rows in {where}, {regs_mode}")
    return out


def _edge_reads(rng, params, b: int, m: int, n: int, band: int, kind: str):
    """(reads, refs) of one ``BANDED_EDGES`` case."""
    if kind == "ties":
        return tie_batch(rng, b, m, n)
    refs = codes_for(params, rng, b, n)
    reads = codes_for(params, rng, b, m)
    if kind == "padding":
        reads[:] = 0
    elif kind == "edge":
        shift = band // 2
        full = codes_for(params, rng, b // 2, n + m)
        full = np.where(full == 0, np.uint8(1), full)
        refs[:b // 2] = full[:, :n]
        reads[:b // 2] = full[:, shift:shift + m]
    return reads, refs


def phase_banded_edges(rng, dev) -> dict:
    """Every branch of B5 and B6 against its plain version at the edges of
    the row layout (``BANDED_EDGES``), each launch's geometry printed;
    returns the max abs error per kernel name (0). ``rng`` is a generator
    of its own (``edge_rng``), so that the other phases' data does not
    depend on this one."""
    err: dict[str, int] = {}
    for label, b, m, n, band, kind in BANDED_EDGES:
        t0 = time.perf_counter()
        for name, params in _param_sets().items():
            r_np, f_np = _edge_reads(rng, params, b, m, n, band, kind)
            e = check_banded(f"{name} {label}", r_np, f_np, params, band, dev, tile=16)
            for k in ("banded_score", "banded_align"):
                key = _kernel_name(k, params)
                err[key] = max(err.get(key, 0), e)
        for line in banded_geometry(label, _param_sets()["dna_affine_bwamem"], band, b):
            log(f"[banded] launch: {line}")
        log(f"[banded] banded_score.cu, banded_align.cu == plain  every set, SW, NW (fill: both "
            f"flavors) B={b} {m}x{n} band {band}: {label} ({time.perf_counter() - t0:.1f} s)")
    return err


def edge_rng(seed: int, stream: int = 8):
    """The generator of an edge phase, apart from the script's: stream 8
    for ``phase_banded_edges``, 9 for ``phase_score_edges``."""
    return np.random.default_rng([seed, stream])


def merge_errs(*errs: dict) -> dict:
    """The max abs error per kernel name over several phases."""
    out: dict[str, int] = {}
    for e in errs:
        for k, v in e.items():
            out[k] = max(out.get(k, 0), v)
    return out


def phase_banded_kernels_vs_plain(rng, dev, pairs) -> tuple[dict, dict]:
    """Every branch of B5 and B6 against its plain version at BANDED_ODD,
    the wide bands of BANDED_WIDE, a BANDED_BIG_MATRIX matrix at
    BANDED_BIG_MATRIX_SHAPE, and the models' defaults at full length on
    BANDED_SLICE of the models' pairs. Returns the max abs error per kernel
    name (0), and the plain versions' times on the slice."""
    from versalignlib_tpu_torch.ops.cuda_banded import rows_in_shared
    from versalignlib_tpu_torch.params import AlignmentParameters
    from versalignlib_tpu_torch.types import Algorithm, TieBreak

    err: dict[str, int] = {}

    def checked(params, e):
        for kind in ("banded_score", "banded_align"):
            key = _kernel_name(kind, params)
            err[key] = max(err.get(key, 0), e)

    sets = _param_sets()
    canon = (TieBreak.DIAG_UP_LEFT,)
    b, m, n, band = BANDED_ODD
    for name, params in sets.items():  # every (gap, scoring) branch
        r_np = codes_for(params, rng, b, m)
        f_np = codes_for(params, rng, b, n)
        checked(params, check_banded(f"{name} {b}x{m}x{n} band {band}", r_np, f_np, params,
                                     band, dev))
        log(f"[banded] banded_score.cu, banded_align.cu == plain  {name:24s} SW, NW (fill: "
            f"both flavors) B={b} {m}x{n} band {band}")
    # Rows in device memory: bands too wide for a block's shared memory.
    for name, b, m, n, band, algs in BANDED_WIDE:
        params = sets[name]
        if rows_in_shared(band, params):
            raise AssertionError(f"band {band} ({name}) keeps its rows in shared memory")
        t0 = time.perf_counter()
        checked(params, check_banded(
            f"{name} {b}x{m}x{n} band {band}", random_codes(rng, b, m), random_codes(rng, b, n),
            params, band, dev, [Algorithm.SMITH_WATERMAN if a == "sw" else
                                Algorithm.NEEDLEMAN_WUNSCH for a in algs], canon))
        log(f"[banded] banded_score.cu, banded_align.cu == plain  {name:24s} "
            f"{', '.join(a.upper() for a in algs)} B={b} {m}x{n} band {band}, rows in device "
            f"memory ({time.perf_counter() - t0:.1f} s)")
    # A 200 x 200 matrix is 160 KB: the kernels read it through the
    # read-only cache. Codes run past S, which must score 0 and count as
    # invalid.
    big = _random_matrix(rng, BANDED_BIG_MATRIX)
    b, m, n, band = BANDED_BIG_MATRIX_SHAPE

    def big_codes(k, length):
        return _pad_tail(rng, rng.integers(1, BANDED_BIG_MATRIX + 10,
                                           size=(k, length)).astype(np.uint8))

    for name, params in (
            ("random_s200_linear", AlignmentParameters(
                score_gap_read=-3, score_gap_ref=-2, matrix=big)),
            ("random_s200_affine", AlignmentParameters(
                score_gap_read=-1, score_gap_ref=-2, gap_open_read=-3,
                gap_open_ref=-4, matrix=big))):
        t0 = time.perf_counter()
        checked(params, check_banded(f"{name} {b}x{m}x{n} band {band}", big_codes(b, m),
                                     big_codes(b, n), params, band, dev))
        log(f"[banded] banded_score.cu, banded_align.cu == plain  {name:24s} SW, NW (fill: "
            f"both flavors) B={b} {m}x{n} band {band}, matrix through the read-only cache "
            f"({time.perf_counter() - t0:.1f} s)")
    reads, refs = pairs[0][:BANDED_SLICE], pairs[1][:BANDED_SLICE]
    plain_ms = {}
    # The models' defaults in both algorithms; every other branch SW, on the
    # same pairs (codes 1-5 are residues A, R, N, D, C under BLOSUM62).
    for name, algs in (("dna_default", list(Algorithm)),
                       ("dna_affine_bwamem", [Algorithm.SMITH_WATERMAN]),
                       ("protein_blosum62_affine", [Algorithm.SMITH_WATERMAN]),
                       ("protein_blosum62_linear", [Algorithm.SMITH_WATERMAN])):
        params = sets[name]
        timed = {}
        checked(params, check_banded(f"{name} slice", reads, refs, params, BAND, dev, algs,
                                     canon, timed))
        plain_ms[name] = timed
        log(f"[banded] banded_score.cu, banded_align.cu == plain  {name:24s} "
            f"{'SW, NW' if len(algs) == 2 else 'SW'} B={BANDED_SLICE} {BANDED_LEN}x{BANDED_LEN} "
            f"band {BAND}; plain ms {json.dumps({f'{k}_{a}': round(v, 1) for (k, a), v in timed.items()})}")
    torch.cuda.synchronize()
    return err, plain_ms


@contextlib.contextmanager
def _plain_banded():
    """The reference runs, plain throughout on the card: the banded
    wrappers and the banded walk swapped for their plain versions and every
    kernel's launch made to raise."""
    from versalignlib_tpu_torch.ops import cuda_banded, cuda_walk, plain_banded

    def refuse(*args):
        raise AssertionError("a kernel launched during a plain reference run")

    kernels = list(_all_kernels().values())
    saved = (cuda_banded.score, cuda_banded.fill, cuda_walk.banded_walk)
    cuda_banded.score = plain_banded.banded_score
    cuda_banded.fill = plain_banded.banded_fill
    cuda_walk.banded_walk = _plain_walks()[1]
    for k in kernels:
        k.launch = refuse
    try:
        yield
    finally:
        cuda_banded.score, cuda_banded.fill, cuda_walk.banded_walk = saved
        for k in kernels:
            del k.launch


def _run_banded(name: str, fn, want: tuple):
    """Run ``fn`` once with every launch count set to 0 just before and read
    just after; every kernel of ``want`` must have launched and no other.
    Returns (result, {"launches": {kernel: count}, "split"}), the split in
    ms of an align call as ``_split_timers`` takes it (fill, walk, copy
    back, replay or host decode) with its wall and the rest; of a score
    call, its wall."""
    kernels = _all_kernels()
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    with (_split_timers(kernels["banded_align"]) if "banded_align" in want
          else contextlib.nullcontext({})) as parts:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    launches = {k: v.launches for k, v in kernels.items()}
    if any(launches[k] < 1 for k in want) or any(v for k, v in launches.items()
                                                 if k not in want):
        raise AssertionError(f"{name}: launches {launches}; only {want} may launch")
    split = dict(parts, wall_ms=wall)
    split["rest_ms"] = wall - sum(v for k, v in parts.items())
    return result, {"launches": {k: launches[k] for k in want}, "split": split}


def phase_banded_models(rng, dev, pairs) -> dict:
    """The banded models at full width on BANDED_PAIRS pairs: score (B5) and
    align (B6 and the walk, B9 or B10) each run once with the launch counts
    read around it, align again with the walk on the host (== on every
    pair), checked on BANDED_CHECK pairs against the plain reference on the
    card."""
    import dataclasses

    from versalignlib_tpu_torch import models
    from versalignlib_tpu_torch.ops import cuda_banded
    from versalignlib_tpu_torch.types import Algorithm

    reads, refs = pairs
    pick = np.sort(rng.choice(BANDED_PAIRS, size=BANDED_CHECK, replace=False))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rounds = cuda_banded.chunk_pairs_for(BANDED_LEN, BAND, sms)
    t0 = time.perf_counter()
    for slot in (0, 1):
        cuda_banded.PINNED.take(slot, (rounds, BANDED_LEN, BAND // 8))
    pin_ms = 1e3 * (time.perf_counter() - t0)
    log(f"[banded] rounds of {rounds} pairs; two page-locked buffers of "
        f"{4 * rounds * BANDED_LEN * BAND // 8 / 2**30:.2f} GiB pinned in {pin_ms:.1f} ms")
    runs = {
        "banded_smith_waterman": ("dna_default", models.banded_smith_waterman(band=BAND)),
        "banded_needleman_wunsch": ("dna_default", models.banded_needleman_wunsch(band=BAND)),
        "banded_affine_bwamem": ("dna_affine_bwamem", models.AlignmentModel(
            "banded_affine_bwamem", Algorithm.SMITH_WATERMAN, _param_sets()["dna_affine_bwamem"],
            banded=True, band=BAND, band_tile=BAND_TILE)),
    }
    out = {"rounds": rounds, "pin_ms": pin_ms}
    for name, (pname, model) in runs.items():
        scores, s_run = _run_banded(f"{name}.score", lambda: model.score(reads, refs),
                                    ("banded_score",))
        alns, a_run = _run_banded(f"{name}.align", lambda: model.align(reads, refs),
                                  ("banded_align", "banded_walk"))
        host_model = dataclasses.replace(model, device_walk=False)
        host_alns, h_run = _run_banded(f"{name}.align, walk on the host",
                                       lambda: host_model.align(reads, refs), ("banded_align",))
        if not all(map(_same_alignment, alns, host_alns)):
            raise AssertionError(f"{name}: the walk on the card differs from the walk on the "
                                 "host")
        if scores.shape != (BANDED_PAIRS,) or (scores <= 0).any() or len(alns) != BANDED_PAIRS:
            raise AssertionError(f"{name}: bad scores or alignment count")
        # SW: the best score is the alignment's. NW need not agree: its
        # overlap score takes the last column of every row, padding rows
        # included, while its alignment ends on row mrp; the JAX package's
        # banded oracles give 31374 against 31371 on one read of 15989 bp
        # padded to 16 kbp. NW is held to the plain reference below.
        if model.algorithm == Algorithm.SMITH_WATERMAN and \
                not (scores == np.array([a.score for a in alns])).all():
            raise AssertionError(f"{name}: scores and alignment scores disagree")
        with _plain_banded():
            want_s = model.score(reads[pick], refs[pick])
            want_a = model.align(reads[pick], refs[pick])
        if not (scores[pick] == want_s).all():
            raise AssertionError(f"{name}: scores differ from the plain reference")
        _check_alignments(name, [alns[i] for i in pick], want_a)
        # The host walk's rounds overlap (round 2 fills and copies while
        # round 1 decodes), so its rest is negative where they do.
        split = a_run["split"]
        out[name] = {"params": pname, "score_launches": s_run["launches"]["banded_score"],
                     "align_launches": a_run["launches"]["banded_align"],
                     "walk_launches": a_run["launches"]["banded_walk"],
                     "score_wall_ms": s_run["split"]["wall_ms"], "align_split": split,
                     "align_split_walk_off": h_run["split"]}
        log(f"[banded] {name}: score B5 x{s_run['launches']['banded_score']} "
            f"({s_run['split']['wall_ms']:.1f} ms), align B6 x{a_run['launches']['banded_align']}"
            f" B9/B10 x{a_run['launches']['banded_walk']} "
            + json.dumps({k: round(v, 3) for k, v in split.items()})
            + "; walk on the host: " + json.dumps({k: round(v, 3) for k, v in
                                                 h_run["split"].items() if v})
            + f"; all {BANDED_PAIRS} == walk on the host; {BANDED_CHECK} pairs == plain "
            "reference")
    return out


def phase_long_reads(rng, genome: np.ndarray) -> dict:
    """map_long_reads at real size: the index timed on its own, the mapping
    run once with the launch counts read around it (B6 only), every planted
    read within LONG_SLACK of its origin on its strand, every junk read
    unmapped, 16 reads checked field by field against the plain reference."""
    import dataclasses
    import functools

    from versalignlib_tpu_torch import build_index, longread, map_long_reads
    from versalignlib_tpu_torch.ops import banded

    reads, origin, rev = make_long_reads(rng, genome)
    t0 = time.perf_counter()
    index = build_index(genome, k=15, w=10)
    index_ms = 1e3 * (time.perf_counter() - t0)
    chain_ms: list[float] = []
    chains: list = []
    find_chains = longread.find_chains

    def recorded(*args, **kw):
        chains.append(find_chains(*args, **kw))
        return chains[-1]

    longread.find_chains = recorded
    try:
        with _host_timed(longread, "find_chains", chain_ms):
            hits, run = _run_banded("map_long_reads",
                                    lambda: map_long_reads(reads, (index, [genome])),
                                    ("banded_align", "banded_walk"))
    finally:
        longread.find_chains = find_chains
    split = dict(run["split"], index_ms=index_ms, seed_chain_ms=sum(chain_ms))
    split["rest_ms"] -= split["seed_chain_ms"]
    # The same mapping with the walk on the host; the host chains, which
    # the walk does not change, are replayed as the first run found them.
    replay = iter(chains)
    align_batch = banded.banded_align_batch
    longread.find_chains = lambda *args, **kw: next(replay)
    banded.banded_align_batch = functools.partial(align_batch, device_walk=False)
    try:
        host = map_long_reads(reads, (index, [genome]))
    finally:
        longread.find_chains, banded.banded_align_batch = find_chains, align_batch
    for field in ("ref_id", "pos", "strand", "score", "mapq", "chain_score"):
        if not np.array_equal(getattr(hits, field), getattr(host, field)):
            raise AssertionError(f"map_long_reads: {field} differs between the walk on the "
                                 "card and on the host")
    if not all((g is None and w is None) or (g is not None and w is not None
                                             and _same_alignment(g, w))
               for g, w in zip(hits.alignments, host.alignments)):
        raise AssertionError("map_long_reads: alignments differ between the walk on the card "
                             "and on the host")
    planted = origin >= 0
    off = np.abs(hits.pos - origin)
    bad = planted & ((hits.ref_id != 0) | (off > LONG_SLACK) | (hits.strand != rev))
    if bad.any() or (hits.ref_id[~planted] != -1).any():
        raise AssertionError(f"map_long_reads: {bad.sum()} planted reads off their origin or "
                             f"strand, {(hits.ref_id[~planted] != -1).sum()} junk reads mapped")
    pick = np.concatenate([np.arange(min(12, LONG_READS)),
                           np.arange(len(reads) - min(4, LONG_JUNK), len(reads))])
    with _plain_banded():
        want = map_long_reads([reads[i] for i in pick], (index, [genome]))
    for field in ("ref_id", "pos", "strand", "score", "mapq", "chain_score"):
        if not np.array_equal(getattr(hits, field)[pick], getattr(want, field)):
            raise AssertionError(f"map_long_reads: {field} differs from the plain reference")
    for i, w in zip(pick, want.alignments):
        g = hits.alignments[i]
        if (g is None) != (w is None) or (g is not None and dataclasses.asdict(g)
                                          != dataclasses.asdict(w)):
            raise AssertionError("map_long_reads: alignments differ from the plain reference")
    log(f"[longread] {LONG_READS} reads of {LONG_MIN}-{LONG_MAX} bp + {LONG_JUNK} junk vs "
        f"{genome.shape[0]} bp: B6 x{run['launches']['banded_align']}, B9 "
        f"x{run['launches']['banded_walk']}; every planted read within "
        f"{LONG_SLACK} bp (max {int(off[planted].max())}) on its strand, junk unmapped; "
        f"{len(pick)} == plain reference; all == the walk on the host; "
        + json.dumps({k: round(v, 3) for k, v in split.items()}))
    return {"launches": run["launches"]["banded_align"],
            "walk_launches": run["launches"]["banded_walk"], "split": split,
            "index_entries": len(index), "max_offset_bp": int(off[planted].max())}


def phase_banded_times(rng, dev, pairs, errs: dict, plain_ms: dict, runs: dict,
                       longreads: dict) -> list[dict]:
    """B5 and B6 at the full shape (BANDED_PAIRS pairs of BANDED_LEN, band
    BAND), SW and NW, in every (gap model, scoring) branch (the BLOSUM62
    branches on the same pairs, whose codes are residues there): the median
    of 7 with min and max, GCUPS in band cells, the bound; the plain
    versions' times are the slice's (BANDED_SLICE pairs). Launches are the
    banded models' runs, which take the DNA branches (0 for the others)."""
    from versalignlib_tpu_torch.ops import cuda_banded
    from versalignlib_tpu_torch.ops.cuda_align import last_valid_pos
    from versalignlib_tpu_torch.types import Algorithm, TieBreak

    reads, refs = pairs
    sets = _param_sets()
    tie = TieBreak.DIAG_UP_LEFT
    entries = []
    for pname, params in sets.items():
        gap, scoring = branch_of(params)
        for line in banded_geometry(pname, params, BAND, BANDED_PAIRS, canon_only=True):
            log(f"[banded] launch: {line}")
        for kind, source, replaces in (
                ("banded_score", "banded_score.cu", "versalignlib_tpu/ops/banded.py:354"),
                ("banded_align", "banded_align.cu", "versalignlib_tpu/ops/banded.py:710")):
            score = kind == "banded_score"
            r, f, offs = _banded_inputs(reads, refs, BAND, BAND_TILE if score else None, dev)
            b, m = r.shape
            n = f.shape[1]
            cells = b * m * BAND
            nw_words = -(-BAND // 8)
            t = {}
            for alg, key in ((Algorithm.SMITH_WATERMAN, "sw"), (Algorithm.NEEDLEMAN_WUNSCH, "nw")):
                if score:
                    km = time_cuda(lambda: cuda_banded.score(r, f, offs, params, alg, BAND))
                    nbytes = b * (m + n) + 4 * m + 4 * b
                else:
                    mrp = torch.from_numpy(last_valid_pos(reads, tie, params.matrix)).to(dev)
                    km = time_cuda(lambda: cuda_banded.fill(r, f, offs, mrp, params, alg, tie,
                                                            BAND))
                    nbytes = (b * (m + n) + 4 * m + 4 * b + 4 * b * m * nw_words
                              + (16 * b if key == "sw" else 4 * b * BAND))
                ops = ops_per_cell("score" if score else "align", gap, scoring)[
                    0 if key == "sw" else 1]
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops * cells / INT32_OPS_PER_S
                pl = plain_ms[pname].get(("score" if score else "align", key))
                t[key] = {"ms": km["median"], "ms_min": km["min"], "ms_max": km["max"],
                          "gcups": cells / km["median"] / 1e6, "plain_ms": pl,
                          "bound_ms": 1e3 * max(t_bytes, t_ops),
                          "bound_by": "bytes" if t_bytes > t_ops else "operations",
                          "ops_per_cell": ops}
                log(f"[times] {source} {pname} {key} B={b} {m}x{n} band {BAND}: "
                    f"{km['median']:.3f} ms (min {km['min']:.3f}, max {km['max']:.3f}), "
                    f"{t[key]['gcups']:.1f} GCUPS (band cells); plain "
                    f"{'not run' if pl is None else f'{pl:.1f} ms'} on {BANDED_SLICE} pairs; "
                    f"bound {t[key]['bound_ms']:.3f} ms ({t[key]['bound_by']})")
            sw = t["sw"]
            model_runs = {k: v for k, v in runs.items()
                          if isinstance(v, dict) and v["params"] == pname}
            launches = sum(v["score_launches" if score else "align_launches"]
                           for v in model_runs.values())
            entry = {
                "name": _kernel_name(kind, params), "route": "cuda",
                "source": f"versalignlib_tpu_torch/csrc/{source}", "replaces": replaces,
                "launches": launches, "max_abs_err": errs[_kernel_name(kind, params)],
                "tolerance": 0, "ms": sw["ms"], "plain_ms": sw["plain_ms"],
                "bound_ms": sw["bound_ms"], "bound_by": sw["bound_by"], "library_ms": None,
                "params": pname, "shape": [b, m, n], "band": BAND, "algorithm": "SW",
                "ms_min": sw["ms_min"], "ms_max": sw["ms_max"], "gcups": sw["gcups"],
                "plain_pairs": BANDED_SLICE, "nw": t["nw"], "matches_plain": True,
                "models": {k: (v["align_split"] if not score else v["score_wall_ms"])
                           for k, v in model_runs.items()},
            }
            if not score and pname == "dna_default":
                entry["map_long_reads"] = longreads
            entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# The traceback walks: csrc/walk.cu (B7, B8) and csrc/banded_walk.cu (B9, B10)
# ---------------------------------------------------------------------------

#: The walks' edges, (label, pairs, m, n, reads): refs of 9, 17 and 509
#: columns (partial pointer words), reads of one row, refs much longer than
#: their reads (NW LEFT runs across many words), the periodic batch of
#: ``tie_batch`` (its last reads all N or padding), reads that score 0 under
#: SW (start (0, 0)), and reads with insertions of 4-24 bases (UP runs: the
#: Gotoh walk's F chains).
WALK_EDGES = (
    ("n 9", 256, 64, 9, "random"), ("n 17", 256, 40, 17, "random"),
    ("n 509", 128, 150, 509, "random"), ("m 1", 256, 1, 100, "random"),
    ("n >> m, long LEFT runs", 64, 20, 1500, "random"), ("ties", 256, 96, 1100, "ties"),
    ("SW score 0", 64, 30, 40, "zero"), ("insertions, F chains", 128, 200, 240, "insert"),
)
#: Banded walk edges, (label, pairs, m, n, band): bands of 8 and 20 on a
#: fill's words; random words (LEFT 60% of the time, random Gotoh extend
#: bits) whose walks leave the band on both edges.
BANDED_WALK_EDGES = (("band 8", 32, 96, 120, 8), ("band 20", 32, 96, 120, 20),
                     ("band 8, steps of 3-4", 16, 48, 184, 8))
WALK_RANDOM_WORDS = ((256, 200, 260, 8), (256, 200, 260, 20))


def _walk_reads(rng, params, b, m, n, kind):
    """(reads, refs) of one ``WALK_EDGES`` case; every kind holds reads of
    padding alone (mrp < 0) in its last four rows."""
    if kind == "ties":
        return tie_batch(rng, b, m, n)
    reads, refs = codes_for(params, rng, b, m), codes_for(params, rng, b, n)
    if kind == "zero":
        reads[:] = 1
        refs[:] = 2 if params.matrix is None else 3
    elif kind == "insert":
        for k in range(b - 4):
            cut, size = int(rng.integers(20, m - 40)), int(rng.integers(4, 25))
            src = np.concatenate([refs[k, :cut], codes_for(params, rng, 1, size)[0],
                                  refs[k, cut:]])
            reads[k] = np.where(src[:m] == 0, np.uint8(1), src[:m])
    reads[-4:] = 0
    return reads, refs


def _plain_walks():
    from versalignlib_tpu_torch.ops import walk as walks

    def dense(ptr, aux, hsel, mrp, mxp, n, local, affine):
        return (walks.walk_dense_affine if affine else walks.walk_dense)(
            ptr, aux, hsel, mrp, mxp, n, local)

    def banded(ptr, best, keep, mrp, mxp, offsets, n, band, local, affine):
        offs = torch.as_tensor(np.asarray(offsets, np.int32)).to(ptr.device)
        return (walks.walk_banded_affine if affine else walks.walk_banded)(
            ptr, best, keep, mrp, mxp, offs, n, band, local)

    return dense, banded


def _visited_rows(records: torch.Tensor, start_r: torch.Tensor) -> tuple[int, int]:
    """Rows the walks visited (every nonzero record, and the row where a
    walk stopped with a START record of no LEFT), in all and at most in one
    pair: the bytes of the bound and the chain of dependent loads."""
    rows = (records != 0).sum(dim=1) + (start_r >= 0).to(torch.int64)
    return int(rows.sum().item()), int(rows.max().item()) if rows.numel() else 0


def _compare_walk(label, got, want) -> int:
    err = 0
    for part, g, w in zip(("records", "start_r", "start_f", "scores"), got, want):
        err = max(err, check_equal(f"{label} {part}", g, w))
    return err


def check_dense_walk(label, r_np, f_np, params, dev, algs=None, ties=None) -> int:
    """B7 or B8 (by the parameters' gap model) against its plain version on
    the card, on the words the fill kernel writes for (B, m), (B, n) codes,
    SW and NW under both tie flavors: records, start cells and scores with
    ``==``. Returns the max abs error (0)."""
    from versalignlib_tpu_torch.ops import cuda_align, cuda_walk
    from versalignlib_tpu_torch.types import Algorithm, TieBreak

    plain_dense, _ = _plain_walks()
    r = torch.from_numpy(np.ascontiguousarray(r_np)).to(dev)
    f = torch.from_numpy(np.ascontiguousarray(f_np)).to(dev)
    n = f_np.shape[1]
    err = 0
    for tie in ties or TieBreak:
        mrp = torch.from_numpy(cuda_align.last_valid_pos(r_np, tie, params.matrix)).to(dev)
        mxp = torch.from_numpy(cuda_align.last_valid_pos(f_np, tie, params.matrix)).to(dev)
        for alg in algs or Algorithm:
            local = alg == Algorithm.SMITH_WATERMAN
            out = cuda_align.fill(r, f, mrp, params, alg, tie)
            args = (*out, mrp, mxp, n, local, params.affine)
            err = max(err, _compare_walk(f"{label} {alg.name} {tie.name}",
                                         cuda_walk.walk(*args), plain_dense(*args)))
    return err


def check_banded_walk(label, r_np, f_np, params, band, dev, algs=None, ties=None,
                      timed=None) -> int:
    """B9 or B10 against its plain version on the card, on the words the
    banded fill kernel writes; ``timed`` collects one CUDA-event time of
    each plain call, by algorithm. Returns the max abs error (0)."""
    from versalignlib_tpu_torch.ops import cuda_banded, cuda_walk
    from versalignlib_tpu_torch.ops.cuda_align import last_valid_pos
    from versalignlib_tpu_torch.types import Algorithm, TieBreak

    _, plain_banded_walk = _plain_walks()
    r, f, offs = _banded_inputs(r_np, f_np, band, None, dev)
    n = f_np.shape[1]
    err = 0
    for tie in ties or TieBreak:
        mrp = torch.from_numpy(last_valid_pos(r_np, tie, params.matrix)).to(dev)
        mxp = torch.from_numpy(last_valid_pos(f_np, tie, params.matrix)).to(dev)
        for alg in algs or Algorithm:
            local = alg == Algorithm.SMITH_WATERMAN
            out = cuda_banded.fill(r, f, offs, mrp, params, alg, tie, band)
            args = (*out, mrp, mxp, offs, n, band, local, params.affine)
            got = cuda_walk.banded_walk(*args)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            want = plain_banded_walk(*args)
            end.record()
            end.synchronize()
            if timed is not None:
                timed["sw" if local else "nw"] = start.elapsed_time(end)
            err = max(err, _compare_walk(f"{label} {alg.name} {tie.name}", got, want))
    return err


def _random_band_words(rng, b, m, nw, band, affine) -> np.ndarray:
    """Band-relative words of random codes, LEFT 60% of the time, fields
    past the band 0 (tests/test_torch_walk.py makes them alike)."""
    codes = np.where(rng.random((b, m, nw * 8)) < 0.6, 2, rng.integers(0, 4, (b, m, nw * 8)))
    if affine:
        codes = codes | (rng.integers(0, 4, codes.shape) << 2)
    codes[:, :, band:] = 0
    words = (codes.reshape(b, m, nw, 8) << ((4 if affine else 2) * np.arange(8))).sum(axis=3)
    return words.astype(np.int64).astype(np.uint32).view(np.int32)


def check_random_band_words(rng, dev, b, m, n, band) -> dict:
    """B9 and B10 against their plain versions on random words and random
    start cells; raises unless walks leave the band on both edges."""
    from versalignlib_tpu_torch.ops import cuda_walk
    from versalignlib_tpu_torch.ops.banded import band_offsets

    _, plain_banded_walk = _plain_walks()
    offsets = band_offsets(m, m, n, band)
    nw = -(-band // 8)
    err = {}
    for affine in (False, True):
        ptr = torch.from_numpy(_random_band_words(rng, b, m, nw, band, affine)).to(dev)
        rows = rng.integers(0, m, b)
        best = torch.from_numpy(np.stack(
            [rng.integers(0, 50, b), rows, offsets[rows] + rng.integers(0, band, b),
             np.zeros(b, np.int64)], axis=1).astype(np.int32)).to(dev)
        keep = torch.from_numpy(rng.integers(-20, 20, (b, band)).astype(np.int32)).to(dev)
        mrp = torch.from_numpy(np.where(rng.random(b) < 0.1, -1, rows).astype(np.int32)).to(dev)
        mxp = torch.from_numpy(rng.integers(-1, n, b).astype(np.int32)).to(dev)
        key = f"banded_walk[{'affine' if affine else 'linear'}]"
        right = left = 0
        for local in (True, False):
            args = (ptr, best, keep, mrp, mxp, offsets, n, band, local, affine)
            got = cuda_walk.banded_walk(*args)
            err[key] = max(err.get(key, 0), _compare_walk(
                f"{key} random words band {band} local {local}", got, plain_banded_walk(*args)))
            rec, sr, sf = (x.cpu().numpy() for x in got[:3])
            for k in range(b):
                r, fp = int(sr[k]), int(sf[k])
                while r >= 0:
                    run, code = int(rec[k, r]) >> 2, int(rec[k, r]) & 3
                    off = int(offsets[r])
                    if code == 0:
                        right += fp - off >= band
                        left += off > 0 and (fp < off or fp - run == off - 1)
                        break
                    fp -= run + (code == 3)
                    r -= 1
        if not (right and left):
            raise AssertionError(f"{key} band {band}: walks off the right edge {right}, "
                                 f"off the left edge {left}; both must occur")
        log(f"[walk] banded_walk.cu == plain  {key} random words B={b} {m}x{n} band {band}, "
            f"SW, NW: {right} walks off the band's right edge, {left} off its left edge")
    return err


def phase_walk_vs_plain(rng, dev, pairs) -> tuple[dict, dict]:
    """Every branch of B7-B10 against its plain version on the card: at the
    main path's shape (ALIGN_PAIRS x LENGTH x LENGTH, every parameter set,
    SW and NW, both flavors), at the edges (``WALK_EDGES``,
    ``BANDED_WALK_EDGES``, ``WALK_RANDOM_WORDS``) and on BANDED_SLICE of
    the long pairs at band BAND (the banded models' branches: DNA linear SW
    and NW, BWA-MEM affine SW).
    Returns the max abs error per kernel name (0) and the plain banded
    walks' times on the slice."""
    from versalignlib_tpu_torch.types import Algorithm, TieBreak

    sets = _param_sets()
    err: dict[str, int] = {}

    def merge(key, e):
        err[key] = max(err.get(key, 0), e)

    def key_of(kind, params):
        return f"{kind}[{'affine' if params.affine else 'linear'}]"

    t0 = time.perf_counter()
    for name, params in sets.items():
        r_np = codes_for(params, rng, ALIGN_PAIRS, LENGTH)
        f_np = codes_for(params, rng, ALIGN_PAIRS, LENGTH)
        merge(key_of("walk", params), check_dense_walk(
            f"{name} {ALIGN_PAIRS}x{LENGTH}x{LENGTH}", r_np, f_np, params, dev))
        log(f"[walk] walk.cu == plain  {name:24s} SW, NW x both flavors B={ALIGN_PAIRS} "
            f"{LENGTH}x{LENGTH} (records, start cells, scores)")
    for label, b, m, n, kind in WALK_EDGES:
        for name in ("dna_default", "dna_affine_bwamem"):
            params = sets[name]
            r_np, f_np = _walk_reads(rng, params, b, m, n, kind)
            merge(key_of("walk", params), check_dense_walk(f"{name} {label}", r_np, f_np,
                                                           params, dev))
        log(f"[walk] walk.cu == plain  linear, affine SW, NW x both flavors B={b} {m}x{n}: "
            f"{label}")
    for label, b, m, n, band in BANDED_WALK_EDGES:
        for name in ("dna_default", "dna_affine_bwamem"):
            params = sets[name]
            r_np, f_np = _edge_reads(rng, params, b, m, n, band, "edge")
            r_np[-2:] = 0
            merge(key_of("banded_walk", params), check_banded_walk(
                f"{name} {label}", r_np, f_np, params, band, dev))
        log(f"[walk] banded_walk.cu == plain  linear, affine SW, NW x both flavors B={b} "
            f"{m}x{n}: {label}")
    for b, m, n, band in WALK_RANDOM_WORDS:
        for key, e in check_random_band_words(rng, dev, b, m, n, band).items():
            merge(key, e)
    log(f"[walk] main shapes and edges: {time.perf_counter() - t0:.1f} s")
    reads, refs = pairs[0][:BANDED_SLICE], pairs[1][:BANDED_SLICE]
    plain_ms = {}
    # The models' defaults: DNA linear SW and NW, BWA-MEM affine SW.
    for name, algs in (("dna_default", list(Algorithm)),
                       ("dna_affine_bwamem", [Algorithm.SMITH_WATERMAN])):
        params = sets[name]
        timed = {}
        t0 = time.perf_counter()
        merge(key_of("banded_walk", params), check_banded_walk(
            f"{name} slice", reads, refs, params, BAND, dev, algs, (TieBreak.DIAG_UP_LEFT,),
            timed))
        plain_ms[name] = timed
        log(f"[walk] banded_walk.cu == plain  {name:24s} {'SW, NW' if len(algs) == 2 else 'SW'} "
            f"B={BANDED_SLICE} "
            f"{BANDED_LEN}x{BANDED_LEN} band {BAND}; plain ms "
            f"{json.dumps({k: round(v, 1) for k, v in timed.items()})} "
            f"({time.perf_counter() - t0:.1f} s)")
    torch.cuda.synchronize()
    return err, plain_ms


def walk_geometry(lines: list[str], pairs: int, sms: int) -> list[str]:
    """A walk launch of ``pairs`` pairs (a thread each, a warp a block):
    blocks, warps per SM, and each instantiation's registers."""
    warps = -(-pairs // 32)
    return [f"{pairs} pairs: {warps} blocks of 32 threads, {warps / sms:.2f} warps per SM "
            f"on {sms} SMs"] + [line for line in lines if "registers" in line]


def walk_bound(b: int, m: int, visited: int, start_bytes: int) -> float:
    """Least time in ms of a walk: the records written (4 bytes a row of
    every pair, 12 a pair of start outputs), one 32-byte sector of pointer
    words a visited row, and the start inputs, over the card's memory
    rate; its operations, a few a row, are far below their bound."""
    return 1e3 * (4 * b * m + 12 * b + 32 * visited + start_bytes) / HBM_BYTES_PER_S


def phase_walk_times(dev, pairs, errs: dict, plain_ms: dict, launches: dict,
                     splits: dict) -> list[dict]:
    """B7, B8 at ALIGN_PAIRS x LENGTH x LENGTH (DNA default, BWA-MEM
    affine) and B9, B10 at BANDED_PAIRS x BANDED_LEN, band BAND, SW and
    NW: the median of 7 with min and max, the plain version (dense: the
    full shape, PLAIN_REPS; banded: the BANDED_SLICE slice), the bound from
    this run's visited rows, and ms a row of the longest chain."""
    from versalignlib_tpu_torch.ops import cuda_align, cuda_banded, cuda_walk
    from versalignlib_tpu_torch.types import Algorithm, TieBreak

    plain_dense, _ = _plain_walks()
    sets = _param_sets()
    tie = TieBreak.DIAG_UP_LEFT
    rng = np.random.default_rng(11)
    entries = []
    for name, replaces in (("dna_default", "versalignlib_tpu/ops/walk.py:78"),
                           ("dna_affine_bwamem", "versalignlib_tpu/ops/walk.py:162")):
        params = sets[name]
        b, m, n = ALIGN_PAIRS, LENGTH, LENGTH
        r_np, f_np = codes_for(params, rng, b, m), codes_for(params, rng, b, n)
        r, f = torch.from_numpy(r_np).to(dev), torch.from_numpy(f_np).to(dev)
        mrp = torch.from_numpy(cuda_align.last_valid_pos(r_np, tie, params.matrix)).to(dev)
        mxp = torch.from_numpy(cuda_align.last_valid_pos(f_np, tie, params.matrix)).to(dev)
        t = {}
        for alg, key in ((Algorithm.SMITH_WATERMAN, "sw"), (Algorithm.NEEDLEMAN_WUNSCH, "nw")):
            out = cuda_align.fill(r, f, mrp, params, alg, tie)
            args = (*out, mrp, mxp, n, key == "sw", params.affine)
            km = time_cuda(lambda: cuda_walk.walk(*args))
            pl = time_cuda(lambda: plain_dense(*args), reps=PLAIN_REPS)
            rec, sr = cuda_walk.walk(*args)[:2]
            visited, chain = _visited_rows(rec, sr)
            start_bytes = b * (16 if key == "sw" else 16 + 8 + 32)
            bd = walk_bound(b, m, visited, start_bytes)
            t[key] = {"ms": km["median"], "ms_min": km["min"], "ms_max": km["max"],
                      "plain_ms": pl["median"], "bound_ms": bd, "visited_rows": visited,
                      "longest_chain_rows": chain, "ns_per_chain_row": 1e6 * km["median"] / chain}
            log(f"[times] walk.cu {name} {key} B={b} {m}x{n}: {km['median']:.3f} ms (min "
                f"{km['min']:.3f}, max {km['max']:.3f}); plain {pl['median']:.1f} ms; bound "
                f"{bd:.4f} ms (bytes: {visited} rows visited); longest chain {chain} rows, "
                f"{t[key]['ns_per_chain_row']:.0f} ns a row")
        kind = "affine" if params.affine else "linear"
        entries.append(_walk_entry(f"walk[{kind}]", name, "versalignlib_tpu_torch/csrc/walk.cu",
                                   replaces, launches[name], errs[f"walk[{kind}]"], (b, m, n), t,
                                   splits.get(name)))
    reads, refs = pairs
    for name, replaces in (("dna_default", "versalignlib_tpu/ops/walk.py:324"),
                           ("dna_affine_bwamem", "versalignlib_tpu/ops/walk.py:413")):
        params = sets[name]
        r, f, offs = _banded_inputs(reads, refs, BAND, None, dev)
        b, m = r.shape
        n = f.shape[1]
        mrp = torch.from_numpy(cuda_align.last_valid_pos(reads, tie, params.matrix)).to(dev)
        mxp = torch.from_numpy(cuda_align.last_valid_pos(refs, tie, params.matrix)).to(dev)
        t = {}
        for alg, key in ((Algorithm.SMITH_WATERMAN, "sw"), (Algorithm.NEEDLEMAN_WUNSCH, "nw")):
            out = cuda_banded.fill(r, f, offs, mrp, params, alg, tie, BAND)
            args = (*out, mrp, mxp, offs, n, BAND, key == "sw", params.affine)
            km = time_cuda(lambda: cuda_walk.banded_walk(*args))
            rec, sr = cuda_walk.banded_walk(*args)[:2]
            visited, chain = _visited_rows(rec, sr)
            start_bytes = b * (16 if key == "sw" else 8 + 4 * BAND)
            bd = walk_bound(b, m, visited, start_bytes)
            pl = plain_ms[name].get(key)
            t[key] = {"ms": km["median"], "ms_min": km["min"], "ms_max": km["max"],
                      "plain_ms": pl, "bound_ms": bd, "visited_rows": visited,
                      "longest_chain_rows": chain, "ns_per_chain_row": 1e6 * km["median"] / chain}
            log(f"[times] banded_walk.cu {name} {key} B={b} {m}x{n} band {BAND}: "
                f"{km['median']:.3f} ms (min {km['min']:.3f}, max {km['max']:.3f}); plain "
                f"{'not run' if pl is None else f'{pl:.1f} ms'} on {BANDED_SLICE} pairs; "
                f"bound {bd:.4f} ms (bytes: {visited} rows "
                f"visited); longest chain {chain} rows, {t[key]['ns_per_chain_row']:.0f} ns a row")
            del out, args
        kind = "affine" if params.affine else "linear"
        entry = _walk_entry(f"banded_walk[{kind}]", name,
                            "versalignlib_tpu_torch/csrc/banded_walk.cu", replaces,
                            launches[f"banded:{name}"], errs[f"banded_walk[{kind}]"], (b, m, n),
                            t, splits.get(f"banded:{name}"))
        entry.update(band=BAND, plain_pairs=BANDED_SLICE)
        entries.append(entry)
    return entries


def _walk_entry(name, params_name, source, replaces, launches, err, shape, t, split) -> dict:
    sw, nw = t["sw"], t["nw"]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "tolerance": 0,
        "ms": sw["ms"], "plain_ms": sw["plain_ms"], "bound_ms": sw["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "params": params_name, "shape": list(shape), "algorithm": "SW",
        "ms_min": sw["ms_min"], "ms_max": sw["ms_max"], "visited_rows": sw["visited_rows"],
        "longest_chain_rows": sw["longest_chain_rows"], "nw": nw, "matches_plain": True,
        "split": split,
    }


class _DoneEvents:
    """While active, each ``torch.cuda.Event()`` made without arguments (the
    events the align paths record after a round's copies back) is a timing
    event kept in ``events``, so that a copy's time is read against the
    launch before it."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        real = self.real = torch.cuda.Event

        def make(*args, **kw):
            event = real(enable_timing=True)
            if not args and not kw:
                self.events.append(event)
            return event

        torch.cuda.Event = make
        return self

    def __exit__(self, *exc):
        torch.cuda.Event = self.real


@contextlib.contextmanager
def _split_timers(fill_kernel):
    """Times each part of one align call as it runs: the fill and walk
    launches (CUDA events), the copies back (from the last launch of a
    round to its done event), the host replay or decode (host clock)."""
    from versalignlib_tpu_torch.ops import banded, cuda_align, cuda_walk
    from versalignlib_tpu_torch.ops import walk as walks

    host = {"replay": [], "decode": []}
    walk_kernel = (cuda_walk.BANDED_WALK_KERNEL if fill_kernel.source == "banded_align.cu"
                   else cuda_walk.WALK_KERNEL)
    decode_mod, decode_name = ((banded, "decode_banded_native")
                               if fill_kernel.source == "banded_align.cu"
                               else (cuda_align, "decode_batch_native"))
    with _LaunchTimer(fill_kernel) as fill, _LaunchTimer(walk_kernel) as walk, \
            _DoneEvents() as done, _host_timed(walks, "replay_batch", host["replay"]), \
            _host_timed(decode_mod, decode_name, host["decode"]):
        parts = {}
        yield parts
        torch.cuda.synchronize()
        last = walk.events if walk.events else fill.events
        if len(last) != len(done.events):
            raise AssertionError(f"{len(last)} rounds launched, {len(done.events)} copied back")
        parts.update(fill_ms=fill.ms(), walk_ms=walk.ms(),
                     copy_ms=sum(e.elapsed_time(d) for (_, e), d in zip(last, done.events)),
                     replay_ms=sum(host["replay"]), decode_ms=sum(host["decode"]))


def align_wall_split(name: str, params, r_np: np.ndarray, f_np: np.ndarray) -> dict:
    """``AlignmentEngine.compute_alignments(raw=True)`` on the codes, SW and
    NW, with the walk on the card (the default) and off, each of REPS calls
    split as it runs (``_split_timers``): fill + walk + records copy +
    replay + rest, or fill + pointer copy + host decode + rest. The rest is
    the wall less the parts: the codes' copies to the card, the memory-plan
    gate, the host's own work; it is below zero where chunks overlap. Logs
    and returns the medians."""
    from versalignlib_tpu_torch import AlignmentEngine
    from versalignlib_tpu_torch.ops.cuda_align import AFFINE_KERNEL, ALIGN_KERNEL
    from versalignlib_tpu_torch.types import Algorithm

    fill_kernel = AFFINE_KERNEL if params.affine else ALIGN_KERNEL
    out = {}
    for walk in (True, False):
        engine = AlignmentEngine(params, device_walk=None if walk else False)
        for alg, key in ((Algorithm.SMITH_WATERMAN, "sw"), (Algorithm.NEEDLEMAN_WUNSCH, "nw")):
            engine.compute_alignments(alg, r_np, f_np, raw=True)
            calls = []
            for _ in range(REPS):
                torch.cuda.synchronize()
                with _split_timers(fill_kernel) as parts:
                    t0 = time.perf_counter()
                    engine.compute_alignments(alg, r_np, f_np, raw=True)
                    wall = 1e3 * (time.perf_counter() - t0)
                parts["wall_ms"] = wall
                calls.append(parts)
            keys = (("fill_ms", "walk_ms", "copy_ms", "replay_ms") if walk else
                    ("fill_ms", "copy_ms", "decode_ms"))
            med = {k: float(np.median([c[k] for c in calls])) for k in keys + ("wall_ms",)}
            med["rest_ms"] = med["wall_ms"] - sum(med[k] for k in keys)
            med["wall_min_ms"] = min(c["wall_ms"] for c in calls)
            med["wall_max_ms"] = max(c["wall_ms"] for c in calls)
            out[f"{key}_{'walk_on' if walk else 'walk_off'}"] = med
            log(f"[times] compute_alignments(raw=True) {name} {key} walk "
                f"{'on the card' if walk else 'on the host'} B={r_np.shape[0]} "
                f"{r_np.shape[1]}x{f_np.shape[1]}, medians of {REPS} calls: "
                + json.dumps({k: round(v, 3) for k, v in med.items()}))
    return out


def phase_long_round(rng, genome: np.ndarray) -> dict:
    """One round of ``banded_align_batch`` with the walk on the card:
    LONG_ROUND_PAIRS HiFi-like copies of genome windows of LONG_ROUND_LEN
    bp, DNA linear SW at band BAND (one wave, ``chunk_pairs_for`` under
    ``WALK_CHUNK_PTR_BYTES``), split into fill, walk, records copy, replay
    and rest; LONG_ROUND_CHECK pairs == the host walk's output."""
    from versalignlib_tpu_torch.ops import cuda_banded
    from versalignlib_tpu_torch.ops.banded import banded_align_batch
    from versalignlib_tpu_torch.types import Algorithm

    t0 = time.perf_counter()
    starts = rng.integers(0, genome.shape[0] - LONG_ROUND_LEN + 1, size=LONG_ROUND_PAIRS)
    refs = np.stack([genome[s:s + LONG_ROUND_LEN] for s in starts])
    reads = np.stack([hifi_copy(rng, f, LONG_ROUND_LEN) for f in refs])
    data_s = time.perf_counter() - t0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rounds = cuda_banded.chunk_pairs_for(LONG_ROUND_LEN, BAND, sms,
                                         cuda_banded.WALK_CHUNK_PTR_BYTES)
    if rounds < LONG_ROUND_PAIRS:
        raise AssertionError(f"{LONG_ROUND_PAIRS} pairs of {LONG_ROUND_LEN} take more than one "
                             f"round ({rounds} pairs a round)")
    params = _param_sets()["dna_default"]
    alg = Algorithm.SMITH_WATERMAN

    def run():
        return banded_align_batch(reads, refs, params, alg, band=BAND, raw=True)

    run_out, info = _run_banded(f"{LONG_ROUND_PAIRS} x {LONG_ROUND_LEN} round", run,
                                ("banded_align", "banded_walk"))
    if info["launches"] != {"banded_align": 1, "banded_walk": 1}:
        raise AssertionError(f"the round took launches {info['launches']}, not one each")
    pick = np.arange(LONG_ROUND_CHECK)
    want = banded_align_batch(reads[pick], refs[pick], params, alg, band=BAND, raw=True,
                              device_walk=False)
    for col in ("meta", "cigar", "read_gapped", "ref_gapped"):
        if not np.array_equal(getattr(run_out, col)[pick], getattr(want, col)):
            raise AssertionError(f"the {LONG_ROUND_LEN} bp round's {col} differs from the "
                                 "host walk")
    if (run_out.scores <= 0).any():
        raise AssertionError(f"the {LONG_ROUND_LEN} bp round has pairs that score 0")
    split = info["split"]
    log(f"[longround] {LONG_ROUND_PAIRS} pairs of {LONG_ROUND_LEN} bp, band {BAND}, walk on the "
        f"card (data {data_s:.1f} s): " + json.dumps({k: round(v, 3) for k, v in split.items()})
        + f"; {LONG_ROUND_CHECK} pairs == the host walk")
    return {"pairs": LONG_ROUND_PAIRS, "length": LONG_ROUND_LEN, "split": split}


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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    reg_lines = {}
    for src in seconds:
        lines = reg_lines[src] = register_report(
            _build.library_path(src).with_suffix(".log").read_text())
        for line in lines:
            log(f"[build] {src} {line}")
        check_no_spills(src, lines)
        if src in ("align.cu", "align_affine.cu"):
            for line in fill_geometry(lines, ALIGN_PAIRS, sms):
                log(f"[build] {src} launch: {line}")
    for line in score_geometry(reg_lines["score.cu"], sms):
        log(f"[build] score.cu launch: {line}")
    for src, pairs in (("walk.cu", ALIGN_PAIRS), ("banded_walk.cu", BANDED_PAIRS)):
        for line in walk_geometry(reg_lines[src], pairs, sms):
            log(f"[build] {src} launch: {line}")

    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    errs = phase_kernels_vs_plain(rng, dev)
    errs = merge_errs(errs, phase_score_edges(edge_rng(args.seed, 9), dev))
    log(f"[phase] kernels vs plain: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    main_path = phase_main_path(rng)
    log(f"[phase] main path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    splits: dict = {}
    kernels = phase_times(rng, dev, main_path, errs, splits)
    log(f"[phase] times: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    data = make_search_data(rng)
    log(f"[phase] search data: {time.perf_counter() - t0:.1f} s")
    for line in search_geometry(data, reg_lines["search.cu"], sms):
        log(f"[build] search.cu launch: {line}")
    t0 = time.perf_counter()
    search_errs, fill_errs = phase_search_kernels_vs_plain(rng, dev, data)
    log(f"[phase] search kernel vs plain: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths = phase_search_paths(rng, data)
    log(f"[phase] search paths: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += phase_search_times(dev, data, paths, search_errs, fill_errs)
    log(f"[phase] search times: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    genome = data["map_to_reference"][1]
    pairs = make_banded_pairs(rng, genome)
    log(f"[phase] banded data: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    walk_errs, walk_plain = phase_walk_vs_plain(edge_rng(args.seed, 10), dev, pairs)
    log(f"[phase] walks vs plain: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    edge_errs = phase_banded_edges(edge_rng(args.seed), dev)
    banded_errs, banded_plain = phase_banded_kernels_vs_plain(rng, dev, pairs)
    banded_errs = merge_errs(edge_errs, banded_errs)
    log(f"[phase] banded kernels vs plain: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    banded_runs = phase_banded_models(rng, dev, pairs)
    log(f"[phase] banded models: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    longreads = phase_long_reads(rng, genome)
    log(f"[phase] long reads: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    long_round = phase_long_round(edge_rng(args.seed, 11), genome)
    log(f"[phase] one round of {LONG_ROUND_PAIRS} x {LONG_ROUND_LEN} bp: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += phase_banded_times(rng, dev, pairs, banded_errs, banded_plain, banded_runs,
                                  longreads)
    log(f"[phase] banded times: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sets = _param_sets()
    launches = {name: sum(main_path[p]["launches"]["walk"] for p in sets
                          if sets[p].affine == sets[name].affine)
                for name in ("dna_default", "dna_affine_bwamem")}
    for name in ("dna_default", "dna_affine_bwamem"):
        launches[f"banded:{name}"] = sum(v["walk_launches"] for v in banded_runs.values()
                                         if isinstance(v, dict) and v["params"] == name)
        splits[f"banded:{name}"] = {k: v["align_split"] for k, v in banded_runs.items()
                                    if isinstance(v, dict) and v["params"] == name}
    launches["banded:dna_default"] += longreads["walk_launches"]
    splits["banded:dna_default"].update(map_long_reads=longreads["split"],
                                        long_round=long_round)
    kernels += phase_walk_times(dev, pairs, walk_errs, walk_plain, launches, splits)
    log(f"[phase] walk times: {time.perf_counter() - t0:.1f} s; whole script "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
