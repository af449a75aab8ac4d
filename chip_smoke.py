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
   (``walk_geometry``: ``walk.cu`` and ``banded_walk.cu`` a warp per pair,
   four a block, their shared memory and the blocks an SM holds);
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
   edges, and at bands 333 and 512, whose rows hold more words than the
   banded walk stages a row, random and drifting words on which it must
   miss: its miss counts must show both kinds; ``DENSE_WALK_WORDS``: the
   same for the dense walk, random and drifting words at rows of 57-188
   words, wider than the window it stages a row); on 32 of the 16 kbp
   pairs at band 512 (``phase_walk_vs_plain``);
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
    on the 32-pair slice, the bounds; times of B7-B10 (4096 x 512 x 512 and
    ``map_reads``' align shape, 2048 x 150 x 1536; 1024 x 16 kbp, band
    512), their plain versions, their bounds from the rows this run's walks
    visited (``walk_bound``), their misses and rows a round, and the banded
    walk's share of each banded wall (models, ``map_long_reads``, the 100
    kbp round);
13. the command line (``phase_cli``): every mode of ``CLI_MODES``
    (pairwise SW and NW with SAM and BAM, ``--reference-compat``, ``--tie
    sse``, ``--gap-open``, ``--matrix blosum62``; ``--panel`` with
    ``--both-strands``, ``--reads2`` and ``--stats``; ``--reference`` and
    ``--reference --long``; ``--band`` linear and affine; ``--pssm-from``;
    ``--translated``) and ``--selftest --bench`` on small seeded files
    (``write_cli_inputs``), in process on the card, the launch counts set to
    0 just before and read just after (every kernel must launch), each file
    == the same command with ``--device cpu``; then pairwise at 4096 x 512 x
    512 with ``--sam --bam``, its wall split into parse, encode, score,
    align, text, SAM and BAM, its score files == ``score_alignments``, the
    native FASTA parser and SAM formatter == their Python versions; and
    ``--panel`` at ``map_reads``' shape, its hits == ``map_reads``;
14. device staging (``phase_staging``): 8 chunks of 16384 x 512 x 512 code
    pairs through ``prefetch_to_device`` into the score kernel, == the
    unstaged scores; one chunk's pageable copy, its copy into page-locked
    memory and the page-locked copy, and the loop staged and unstaged, timed;
15. serving (``phase_serve``): ``AlignServer`` over ``BatchingAligner`` on
    the card in process; bursts of 16 concurrent /v1/score, /v1/align and
    CIGAR-only /v1/align requests of 256 pairs of 512 x 512 and one /v1/map
    at ``map_reads``' shape, every reply == the engine's direct call on the
    card, a sample == the ``oracle`` backend, the score, fill, walk and
    one-vs-many kernels launched; walls, pairs/s, the card's kernel time and
    /stats logged; then ``scripts/torch_serve_bench.py`` at its mix
    (latency percentiles, throughput, the dispatcher's time, the share
    ``_bucket`` pads);
16. the bulk pipelines (``phase_bulk``): ``scripts/torch_bulk_map.py
    --synthetic 65536 --sam`` against the ``map_reads`` panel and
    ``scripts/torch_bulk_align.py`` (131072 x 512 staged and pageable, in
    turns; 16384 with ``--mode align``), the launch counts read from each
    script's own run, ``torch_bulk_map`` and a staged ``torch_bulk_align``
    resumed after a dropped chunk with byte-identical files, and both
    checked against the entry points;
17. the examples (``phase_examples``): every ``examples/torch/*.py`` in a
    subprocess on the card and with ``--device cpu``, equal output, the
    kernels each example drives launched on the card and none on the CPU;
18. one ``{"kernels": [...]}`` line, the nvidia-smi line, and the last line
    ``{"ok": true, "device": {...}}``.

DNA inputs are random A/C/G/T with about 2% N, protein inputs the 20
standard residues with about 1% X, both with random trailing padding, made
with numpy from ``--seed``; the search and long-pair paths' inputs are
described at ``make_*``. Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
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


def time_device(fn, reps: int = REPS) -> float:
    """Median ms of ``fn``'s work on the card alone, after one warm-up: each
    call is queued behind a spin of the card (``torch.cuda._sleep``), so
    that the host's time to launch it, which ``time_cuda`` counts where the
    card is faster, falls outside the events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    template arguments (kLocal, kCanon or kAffine, kMat), registers, static
    shared memory where it has any, stack frame and spill bytes."""
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
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{kernel}: {regs.group(1) if regs else '?'} registers, "
                       + (f"{smem.group(1)} bytes smem, " if smem else "") + spill)
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
    starts, when ``cuda_score.score_batch_device`` first starts and last
    returns and when the scorer returns, time the copy of the first chunk's
    codes to the card (staged in page-locked memory, which the launch
    waits for), the kernels (the wrapper's host work, the launches and the
    later chunks' copies, which overlap them, included) and the
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

    def timed_kernel(*args, **kw):
        if "kernel" not in marks:
            mark("kernel")
        out = kernel(*args, **kw)
        mark("kernel_end")
        return out

    def timed_scorer(*args):
        marks.clear()
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
def _host_timed(module, name: str, acc: list, sync: bool = True):
    """While active, ``module.name`` appends its host time in ms to ``acc``
    on each call, from whichever thread: synchronised with the card, or with
    ``sync=False`` not (for functions that return host results, where a
    synchronisation would add the wait to take the interpreter back)."""
    fn = getattr(module, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            if sync:
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
BANDED_SLICE, BANDED_CHECK = 8, 16
#: map_long_reads: LONG_READS HiFi-like reads of LONG_MIN..LONG_MAX bp
#: planted on both strands of the GENOME_LEN reference, and LONG_JUNK random
#: reads of JUNK_LEN bp; a read maps within LONG_SLACK bp of its origin.
LONG_READS, LONG_MIN, LONG_MAX, LONG_JUNK, JUNK_LEN, LONG_SLACK = 256, 12000, 15000, 16, 12000, 50
#: HiFi-like errors: substitutions and indels (of 1-3 bp) per base.
HIFI_SUB, HIFI_INDEL = 0.005, 0.003
#: The protein banded models' pairs: PROTEIN_PAIRS whole chains of
#: PROTEIN_LEN residues (long multi-domain proteins) and refs, each a
#: homolog of its read with PROTEIN_SUB substitutions and PROTEIN_INDEL
#: indels of 1-3 residues per residue (a few a pair), which keep the path
#: inside a band of BAND.
PROTEIN_PAIRS, PROTEIN_LEN, PROTEIN_SUB, PROTEIN_INDEL = 1024, 4096, 0.15, 0.001
PROTEIN_CHECK = 16
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


def hifi_copy(rng, seq: np.ndarray, length: int | None = None, sub: float = HIFI_SUB,
              indel: float = HIFI_INDEL, letters: int = 4) -> np.ndarray:
    """A HiFi-like copy of ``seq``: ``sub`` substitutions and ``indel``
    insertions or deletions of 1-3 codes per code, the codes 1..``letters``;
    cut or padded with 0 to ``length`` when given."""
    seq = _substitute(rng, seq, sub, letters)
    n = seq.shape[0]
    where = np.sort(rng.choice(n, size=rng.binomial(n, indel), replace=False))
    parts, lo = [], 0
    for pos in where:
        if pos < lo:
            continue
        size = int(rng.integers(1, 4))
        parts.append(seq[lo:pos])
        if rng.random() < 0.5:      # insertion before pos
            parts.append(rng.integers(1, letters + 1, size=size).astype(np.uint8))
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


def make_protein_pairs(rng):
    """PROTEIN_PAIRS reads of PROTEIN_LEN residues from ``random_protein``,
    its trailing padding filled with residues (whole chains), and refs, each
    a copy of its read with PROTEIN_SUB substitutions and PROTEIN_INDEL
    indels of 1-3 residues, padded with 0 or cut to PROTEIN_LEN."""
    reads = random_protein(rng, PROTEIN_PAIRS, PROTEIN_LEN)
    reads = np.where(reads == 0, rng.integers(1, 21, size=reads.shape), reads).astype(np.uint8)
    refs = np.stack([hifi_copy(rng, r, PROTEIN_LEN, PROTEIN_SUB, PROTEIN_INDEL, 20)
                     for r in reads])
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
    """The generator of a phase apart from the script's: stream 8 for
    ``phase_banded_edges``, 9 ``phase_score_edges``, 10 ``phase_walk_vs_plain``,
    11 ``phase_long_round``, 12 ``phase_cli``, 13 ``phase_staging``, 14
    ``phase_serve``, 15 ``phase_bulk``."""
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
    """The banded models at full width, the DNA ones on BANDED_PAIRS pairs
    of BANDED_LEN, the BLOSUM62 ones (affine SW, linear NW) on PROTEIN_PAIRS
    protein pairs of PROTEIN_LEN (``make_protein_pairs``): score (B5) and
    align (B6 and the walk, B9 or B10) each run once with the launch counts
    read around it, align again with the walk on the host (== on every
    pair), checked on BANDED_CHECK (DNA) or PROTEIN_CHECK pairs against the
    plain reference on the card."""
    import dataclasses

    from versalignlib_tpu_torch import models
    from versalignlib_tpu_torch.ops import cuda_banded
    from versalignlib_tpu_torch.types import Algorithm

    inputs = {"dna": pairs}
    picks = {"dna": np.sort(rng.choice(BANDED_PAIRS, size=BANDED_CHECK, replace=False))}
    inputs["protein"] = make_protein_pairs(rng)
    picks["protein"] = np.sort(rng.choice(PROTEIN_PAIRS, size=PROTEIN_CHECK, replace=False))
    sets = _param_sets()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rounds = cuda_banded.chunk_pairs_for(BANDED_LEN, BAND, sms)
    t0 = time.perf_counter()
    for slot in (0, 1):
        cuda_banded.PINNED.take(slot, (rounds, BANDED_LEN, BAND // 8))
    pin_ms = 1e3 * (time.perf_counter() - t0)
    log(f"[banded] rounds of {rounds} pairs; two page-locked buffers of "
        f"{4 * rounds * BANDED_LEN * BAND // 8 / 2**30:.2f} GiB pinned in {pin_ms:.1f} ms")
    runs = {
        "banded_smith_waterman": ("dna_default", "dna", models.banded_smith_waterman(band=BAND)),
        "banded_needleman_wunsch": ("dna_default", "dna",
                                    models.banded_needleman_wunsch(band=BAND)),
        "banded_affine_bwamem": ("dna_affine_bwamem", "dna", models.AlignmentModel(
            "banded_affine_bwamem", Algorithm.SMITH_WATERMAN, sets["dna_affine_bwamem"],
            banded=True, band=BAND, band_tile=BAND_TILE)),
        "banded_protein_blosum62": ("protein_blosum62_affine", "protein", models.AlignmentModel(
            "banded_protein_blosum62", Algorithm.SMITH_WATERMAN,
            sets["protein_blosum62_affine"], banded=True, band=BAND, band_tile=BAND_TILE)),
        "banded_protein_blosum62_linear_nw": ("protein_blosum62_linear", "protein",
                                              models.AlignmentModel(
            "banded_protein_blosum62_linear_nw", Algorithm.NEEDLEMAN_WUNSCH,
            sets["protein_blosum62_linear"], banded=True, band=BAND, band_tile=BAND_TILE)),
    }
    out = {"rounds": rounds, "pin_ms": pin_ms}
    for name, (pname, data, model) in runs.items():
        (reads, refs), pick = inputs[data], picks[data]
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
        if scores.shape != (len(reads),) or (scores <= 0).any() or len(alns) != len(reads):
            raise AssertionError(f"{name}: bad scores or alignment count")
        # SW: the best score is the alignment's. NW need not agree: its
        # overlap score takes the last column of every row, padding rows
        # included, while its alignment ends on row mrp; the JAX package's
        # banded oracles give 31374 against 31371 on one read of 15989 bp
        # padded to 16 kbp. NW is held to the plain reference below.
        if model.algorithm == Algorithm.SMITH_WATERMAN and \
                not (scores == np.array([a.score for a in alns])).all():
            raise AssertionError(f"{name}: scores and alignment scores disagree")
        t0 = time.perf_counter()
        with _plain_banded():
            want_s = model.score(reads[pick], refs[pick])
            want_a = model.align(reads[pick], refs[pick])
        plain_s = time.perf_counter() - t0
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
            + f"; all {len(reads)} pairs of {reads.shape[1]} x {refs.shape[1]} ({pname}) == "
            f"walk on the host; {len(pick)} pairs == plain reference ({plain_s:.1f} s)")
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
    banded models' runs of the branch's parameter set (the BLOSUM62 ones on
    their protein pairs)."""
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
#: Words that no fill writes, (pairs, m, n, band, kind) (``check_band_words``):
#: random words at bands 8 and 20, whose walks leave the band on both edges;
#: then at bands of 42 and 64 words a row, more than the 16 the banded walk
#: stages a row (csrc/banded_walk.cu), random words and drifting words
#: (``drifting_band_words``: UP runs and F chains that carry the cursor
#: out of its window, LEFT runs and E chains below it, rows LEFT across
#: the whole band), where the kernel must miss.
WALK_RANDOM_WORDS = ((256, 200, 260, 8, "random"), (256, 200, 260, 20, "random"),
                     (64, 200, 700, 333, "window"), (64, 200, 900, 512, "window"),
                     (64, 600, 620, 333, "drift"), (64, 600, 640, 512, "drift"))
#: Dense words that no fill writes, (pairs, m, n, kind) (``check_dense_words``),
#: at rows wider than the window the dense walk stages a row (128 columns
#: linear, 64 Gotoh; csrc/walk.cuh): random words from random start cells
#: ("window") and drifting words (``drifting_dense_words``: UP runs and F
#: chains that carry the cursor off the diagonal and out of its window,
#: LEFT runs and E chains below it, rows LEFT across the whole row), where
#: the kernel must miss.
DENSE_WALK_WORDS = ((64, 200, 1500, "window"), (64, 200, 900, "window"),
                    (64, 600, 1500, "drift"), (64, 600, 900, "drift"))


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


def _pack_codes(codes: np.ndarray, affine: bool, per_word: int) -> np.ndarray:
    """(b, m, words * per_word) codes -> (b, m, words) int32 words of
    ``per_word`` fields, 4 bits a field under ``affine``, else 2."""
    b, m, fields = codes.shape
    shifts = ((4 if affine else 2) * np.arange(per_word)).astype(np.uint32)
    words = (codes.reshape(b, m, fields // per_word, per_word).astype(np.uint32)
             << shifts).sum(axis=3, dtype=np.uint32)
    return words.view(np.int32)


def random_band_words(rng, b, m, nw, band, affine) -> np.ndarray:
    """Band-relative words of random codes, LEFT 60% of the time (long runs
    across words), random Gotoh extend bits, fields past the band 0."""
    codes = np.where(rng.random((b, m, nw * 8)) < 0.6, 2, rng.integers(0, 4, (b, m, nw * 8)))
    if affine:
        codes = codes | (rng.integers(0, 4, codes.shape) << 2)
    codes[:, :, band:] = 0
    return _pack_codes(codes, affine, 8)


def drifting_band_words(rng, b, m, nw, band, affine) -> np.ndarray:
    """Band-relative words whose walks drift across the band: from the last
    row up, runs of 40-160 rows that are UP everywhere (the cursor's band
    field rises by the band's step a row; under Gotoh 80% of the fields
    carry f_ext, so the walk chains in state F) alternate with runs of
    20-100 DIAG rows, of which 15% are LEFT but for a stop every 100-400
    fields (half of those rows with their stops on a word's first field,
    and under Gotoh e_ext on 30% of the fields, so E chains continue across
    stops and across words); a quarter of the pairs have one row, 10-60
    rows above the last, that is LEFT across the whole band. Fields past
    the band are 0."""
    codes = np.full((b, m, nw * 8), 3, np.int64)
    ext = np.zeros_like(codes)
    for k in range(b):
        r = m - 1
        while r >= 0:
            up = rng.random() < 0.5
            rows = slice(max(r - int(rng.integers(40, 161) if up else rng.integers(20, 101)), -1)
                         + 1, r + 1)
            if up:
                codes[k, rows] = 1
                ext[k, rows] = np.where(rng.random(ext[k, rows].shape) < 0.8, 2, 0)
            else:
                for row in range(rows.start, rows.stop):
                    if rng.random() < 0.15:
                        stops = rng.choice(band, max(1, band // int(rng.integers(100, 401))),
                                           replace=False)
                        codes[k, row] = 2
                        codes[k, row, stops & ~7 if rng.random() < 0.5 else stops] = 3
                        ext[k, row] = rng.random(nw * 8) < 0.3
            r = rows.start - 1
        if k % 4 == 0:
            codes[k, m - 1 - int(rng.integers(10, 61))] = 2
    codes[:, :, band:] = 0
    return _pack_codes(codes | (ext << 2) if affine else codes, affine, 8)


def random_dense_words(rng, b, m, n, affine) -> np.ndarray:
    """Dense pointer words of random codes, (b, m, ceil(n/16)) of 2-bit
    codes or under ``affine`` (b, m, ceil(n/8)) of 4-bit Gotoh codes: LEFT
    60% of the time (long runs across words), random Gotoh extend bits,
    fields past column n - 1 zero."""
    per = 8 if affine else 16
    fields = -(-n // per) * per
    codes = np.where(rng.random((b, m, fields)) < 0.6, 2,
                     rng.integers(0, 4, (b, m, fields), np.uint8)).astype(np.uint8)
    if affine:
        codes |= rng.integers(0, 4, codes.shape, np.uint8) << 2
    codes[:, :, n:] = 0
    return _pack_codes(codes, affine, per)


def drifting_dense_words(rng, b, m, n, affine) -> np.ndarray:
    """Dense pointer words (as ``random_dense_words``) whose walks drift off
    the diagonal: from the last row up, runs of 40-200 rows that are UP
    everywhere (the cursor keeps its column, one column a row right of the
    diagonal; under Gotoh 80% of the fields carry f_ext, so the walk chains
    in state F) alternate with runs of 20-100 DIAG rows, of which 8% are
    LEFT but for a stop every 100-400 fields (half of those rows with their
    stops on a word's first field, and under Gotoh e_ext on 30% of the
    fields, so E chains continue across stops and across words); a quarter
    of the pairs have one row, 10-60 rows above the last, that is LEFT
    across the whole row. Fields past column n - 1 are 0."""
    per = 8 if affine else 16
    fields = -(-n // per) * per
    codes = np.full((b, m, fields), 3, np.uint8)
    ext = np.zeros_like(codes)
    for k in range(b):
        r = m - 1
        while r >= 0:
            up = rng.random() < 0.5
            rows = slice(max(r - int(rng.integers(40, 201) if up else rng.integers(20, 101)), -1)
                         + 1, r + 1)
            if up:
                codes[k, rows] = 1
                ext[k, rows] = np.where(rng.random(ext[k, rows].shape) < 0.8, 2, 0)
            else:
                for row in np.flatnonzero(rng.random(rows.stop - rows.start) < 0.08):
                    row += rows.start
                    stops = rng.integers(0, n, max(1, n // int(rng.integers(100, 401))))
                    codes[k, row] = 2
                    codes[k, row, stops & -per if rng.random() < 0.5 else stops] = 3
                    ext[k, row] = rng.random(fields) < 0.3
            r = rows.start - 1
        if k % 4 == 0:
            codes[k, m - 1 - int(rng.integers(10, 61))] = 2
    codes[:, :, n:] = 0
    return _pack_codes(codes | (ext << 2) if affine else codes, affine, per)


def dense_word_starts(rng, b, m, n, kind):
    """Start inputs for a dense walk on words that no fill writes: the SW
    aux (b, 4) [score, row, column, 0], the NW aux (b, 4) [column, 0, 0, 0]
    with hsel (b, n + 1), and mrp, mxp (b,), as int32 arrays. Kind "drift"
    starts in the last 40 rows, mid-row; else anywhere. A tenth of the NW
    walks never start (mrp -1), a fifth start at a random mxp below their
    column."""
    if kind == "drift":
        rows, cols = rng.integers(m - 40, m, b), rng.integers(n // 4, 3 * n // 4, b)
    else:
        rows, cols = rng.integers(0, m, b), rng.integers(0, n, b)
    zeros = np.zeros(b, np.int64)
    aux_sw = np.stack([rng.integers(0, 50, b), rows, cols, zeros], axis=1)
    aux_nw = np.stack([cols, zeros, zeros, zeros], axis=1)
    hsel = rng.integers(-50, 50, (b, n + 1))
    mrp = np.where(rng.random(b) < 0.1, -1, rows)
    mxp = np.where(rng.random(b) < 0.2, rng.integers(-1, n, b), n - 1)
    return tuple(x.astype(np.int32) for x in (aux_sw, aux_nw, hsel, mrp, mxp))


def dense_drift(records, start_r, start_f, rows: int = 96) -> tuple[int, int]:
    """The largest move of a dense walk's cursor off the diagonal over
    ``rows`` rows (the rows a stage is staged ahead of its walk), and the
    walks that reached column -1."""
    drift = reached = 0
    for rec, r, fp in zip(records, start_r, start_f):
        diag = {}
        r, fp = int(r), int(fp)
        while r >= 0 and fp >= 0 and rec[r] & 3:
            diag[r] = fp - r
            fp -= (int(rec[r]) >> 2) + (int(rec[r]) & 3 == 3)
            r -= 1
        reached += r >= 0 and fp < 0
        drift = max([drift] + [abs(d - diag[r + rows]) for r, d in diag.items()
                               if r + rows in diag])
    return drift, reached


def band_exits(records, start_r, start_f, offsets, band) -> tuple[int, int]:
    """The walks that stop on the band's right edge (a row entered past the
    band) and on its left edge above column 0 (a row entered left of the
    band, or a LEFT run down to the band's start)."""
    right = left = 0
    for rec, r, fp in zip(records, start_r, start_f):
        r, fp = int(r), int(fp)
        while r >= 0:
            run, code = int(rec[r]) >> 2, int(rec[r]) & 3
            off = int(offsets[r])
            if code == 0:
                right += fp - off >= band
                left += off > 0 and (fp < off or fp - run == off - 1)
                break
            fp -= run + (code == 3)
            r -= 1
    return right, left


def check_band_words(rng, dev, b, m, n, band, kind, stats) -> dict:
    """B9 and B10 against their plain versions, SW and NW, on words that no
    fill writes: ``kind`` "random" (``random_band_words``, random start
    cells; raises unless walks leave the band on both edges), "window"
    (the same at bands whose rows hold more words than the kernel stages a
    row) or "drift" (``drifting_band_words``, walks from the last 40 rows,
    mid-band; raises unless some LEFT run spans more than 128 fields, the
    fields a staged window holds). ``stats`` (the wrapper's int64 (3,)
    counts) gets the kernel's misses and rounds added."""
    from versalignlib_tpu_torch.ops import cuda_walk
    from versalignlib_tpu_torch.ops.banded import band_offsets

    _, plain_banded_walk = _plain_walks()
    offsets = band_offsets(m, m, n, band)
    nw = -(-band // 8)
    err = {}
    for affine in (False, True):
        make = drifting_band_words if kind == "drift" else random_band_words
        ptr = torch.from_numpy(make(rng, b, m, nw, band, affine)).to(dev)
        if kind == "drift":
            rows = rng.integers(m - 40, m, b)
            cols = offsets[rows] + rng.integers(band // 4, 3 * band // 4, b)
        else:
            rows = rng.integers(0, m, b)
            cols = offsets[rows] + rng.integers(0, band, b)
        best = torch.from_numpy(np.stack([rng.integers(0, 50, b), rows, cols,
                                          np.zeros(b, np.int64)], axis=1).astype(np.int32)).to(dev)
        keep = torch.from_numpy(rng.integers(-20, 20, (b, band)).astype(np.int32)).to(dev)
        mrp = torch.from_numpy(np.where(rng.random(b) < 0.1, -1, rows).astype(np.int32)).to(dev)
        mxp = torch.from_numpy(rng.integers(-1, n, b).astype(np.int32)).to(dev)
        key = f"banded_walk[{'affine' if affine else 'linear'}]"
        right = left = longest = 0
        before = stats.tolist()
        for local in (True, False):
            args = (ptr, best, keep, mrp, mxp, offsets, n, band, local, affine)
            got = cuda_walk.banded_walk(*args, stats=stats)
            err[key] = max(err.get(key, 0), _compare_walk(
                f"{key} {kind} words band {band} local {local}", got, plain_banded_walk(*args)))
            rec, sr, sf = (x.cpu().numpy() for x in got[:3])
            exits = band_exits(rec, sr, sf, offsets, band)
            right, left = right + exits[0], left + exits[1]
            longest = max(longest, int((rec >> 2).max()))
        if kind == "random" and not (right and left):
            raise AssertionError(f"{key} band {band}: walks off the right edge {right}, "
                                 f"off the left edge {left}; both must occur")
        if kind == "drift" and longest <= 128:
            raise AssertionError(f"{key} band {band}: the longest LEFT run spans {longest} "
                                 "fields, within one staged window")
        reissued, deep, _ = (x - y for x, y in zip(stats.tolist(), before))
        log(f"[walk] banded_walk.cu == plain  {key} {kind} words B={b} {m}x{n} band {band}, "
            f"SW, NW: {right} walks off the band's right edge, {left} off its left edge, "
            f"longest LEFT run {longest} fields; misses: {reissued} windows staged again, "
            f"{deep} runs below a window")
    return err


def check_dense_words(rng, dev, b, m, n, kind, stats) -> dict:
    """B7 and B8 against their plain versions, SW and NW, on words that no
    fill writes, at rows wider than a staged window: ``kind`` "window"
    (``random_dense_words`` from random start cells) or "drift"
    (``drifting_dense_words`` walked from the last 40 rows, mid-row; raises
    unless some LEFT run spans more than a window's columns, 128 linear and
    64 Gotoh). ``stats`` (the wrapper's int64 (3,) counts) gets the
    kernel's misses and rounds added."""
    from versalignlib_tpu_torch.ops import cuda_walk

    plain_dense, _ = _plain_walks()
    err = {}
    for affine in (False, True):
        make = drifting_dense_words if kind == "drift" else random_dense_words
        ptr = torch.from_numpy(make(rng, b, m, n, affine)).to(dev)
        aux_sw, aux_nw, hsel, mrp, mxp = (torch.from_numpy(x).to(dev) for x in
                                          dense_word_starts(rng, b, m, n, kind))
        key = f"walk[{'affine' if affine else 'linear'}]"
        longest = drift = reached = 0
        before = stats.tolist()
        for local, aux in ((True, aux_sw), (False, aux_nw)):
            args = (ptr, aux, None if local else hsel, mrp, mxp, n, local, affine)
            got = cuda_walk.walk(*args, stats=stats)
            err[key] = max(err.get(key, 0), _compare_walk(
                f"{key} {kind} words n {n} local {local}", got, plain_dense(*args)))
            rec, sr, sf = (x.cpu().numpy() for x in got[:3])
            longest = max(longest, int((rec >> 2).max()))
            d, c = dense_drift(rec, sr, sf)
            drift, reached = max(drift, d), reached + c
        window = 64 if affine else 128
        if kind == "drift" and longest <= window:
            raise AssertionError(f"{key} n {n}: the longest LEFT run spans {longest} columns, "
                                 f"within one staged window of {window}")
        reissued, deep, _ = (x - y for x, y in zip(stats.tolist(), before))
        log(f"[walk] walk.cu == plain  {key} {kind} words B={b} {m}x{n}, SW, NW: longest LEFT "
            f"run {longest} columns, cursor {drift} columns off the diagonal over 96 rows, "
            f"{reached} NW walks reached column -1; misses: {reissued} windows staged "
            f"again, {deep} runs below a window")
    return err


def phase_walk_vs_plain(rng, dev, pairs) -> tuple[dict, dict]:
    """Every branch of B7-B10 against its plain version on the card: at the
    main path's shape (ALIGN_PAIRS x LENGTH x LENGTH, every parameter set,
    SW and NW, both flavors), at the edges (``WALK_EDGES``,
    ``BANDED_WALK_EDGES``, ``WALK_RANDOM_WORDS``, ``DENSE_WALK_WORDS``;
    each walk kernel must miss on the last two) and on BANDED_SLICE of
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
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    for b, m, n, band, kind in WALK_RANDOM_WORDS:
        for key, e in check_band_words(rng, dev, b, m, n, band, kind, stats).items():
            merge(key, e)
    reissued, deep, _ = (int(x) for x in stats.tolist())
    if not (reissued and deep):
        raise AssertionError(f"banded_walk.cu staged {reissued} windows again and read {deep} "
                             "runs past a window on the window and drift words: both must occur")
    log(f"[walk] banded_walk.cu misses on the window and drift words: {reissued} cursors "
        f"left their window (the ring staged again), {deep} runs read words below it")
    stats.zero_()
    for b, m, n, kind in DENSE_WALK_WORDS:
        for key, e in check_dense_words(rng, dev, b, m, n, kind, stats).items():
            merge(key, e)
    reissued, deep, _ = (int(x) for x in stats.tolist())
    if not (reissued and deep):
        raise AssertionError(f"walk.cu staged {reissued} windows again and read {deep} runs "
                             "past a window on the dense window and drift words: both must "
                             "occur")
    log(f"[walk] walk.cu misses on the dense window and drift words: {reissued} cursors left "
        f"their window (the ring staged again), {deep} runs read words below it")
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


def walk_geometry(source: str, lines: list[str], pairs: int, sms: int) -> list[str]:
    """A walk launch of ``pairs`` pairs: a warp a pair, ``WALK_WARPS`` (or
    ``BANDED_WALK_WARPS``) a block, with its ring in shared memory. Blocks,
    warps per SM, and each instantiation's registers and the blocks an SM
    holds at once by its registers and shared memory; raises unless the
    shared memory a block is ``WALK_SMEM`` (``BANDED_WALK_SMEM``)."""
    from versalignlib_tpu_torch.ops import cuda_walk

    if source == "walk.cu":
        warps, smem_want = cuda_walk.WALK_WARPS, cuda_walk.WALK_SMEM
    else:
        warps, smem_want = cuda_walk.BANDED_WALK_WARPS, cuda_walk.BANDED_WALK_SMEM
    blocks = -(-pairs // warps)
    out = [f"{pairs} pairs: {blocks} blocks of {warps} warps ({warps * 32} threads, "
           f"{smem_want} bytes of shared memory), {pairs / sms:.2f} warps per SM on {sms} SMs, "
           f"{min(blocks, sms)} SMs busy"]
    for line in lines:
        regs = re.search(r": (\d+) registers", line)
        smem = re.search(r"(\d+) bytes smem", line)
        if regs:
            if smem and int(smem.group(1)) != smem_want:
                raise AssertionError(f"{source} holds {smem.group(1)} bytes of shared memory a "
                                     f"block, not {smem_want}: {line}")
            out.append(f"{line}; {resident_blocks(int(regs.group(1)), smem_want)} "
                       "blocks resident per SM")
    return out


def walk_bound(b: int, m: int, visited: int, start_bytes: int) -> float:
    """Least time in ms of a walk: the records written (4 bytes a row of
    every pair, 12 a pair of start outputs), one 32-byte sector of pointer
    words a visited row, and the start inputs, over the card's memory
    rate; its operations, a few a row, are far below their bound."""
    return 1e3 * (4 * b * m + 12 * b + 32 * visited + start_bytes) / HBM_BYTES_PER_S


def _dense_walk_times(dev, params, r_np, f_np, plain_reps) -> dict:
    """B7 or B8 (by the parameters' gap model) on the words the fill kernel
    writes for (B, m), (B, n) codes, SW and NW, canonical flavor: the
    median of 7 with min and max, the plain version's median of
    ``plain_reps``, the bound from this run's visited rows,
    ns a row of the longest chain, and the kernel's misses and rounds."""
    from versalignlib_tpu_torch.ops import cuda_align, cuda_walk
    from versalignlib_tpu_torch.types import Algorithm, TieBreak

    plain_dense, _ = _plain_walks()
    tie = TieBreak.DIAG_UP_LEFT
    (b, m), n = r_np.shape, f_np.shape[1]
    r = torch.from_numpy(np.ascontiguousarray(r_np)).to(dev)
    f = torch.from_numpy(np.ascontiguousarray(f_np)).to(dev)
    mrp = torch.from_numpy(cuda_align.last_valid_pos(r_np, tie, params.matrix)).to(dev)
    mxp = torch.from_numpy(cuda_align.last_valid_pos(f_np, tie, params.matrix)).to(dev)
    t = {}
    for alg, key in ((Algorithm.SMITH_WATERMAN, "sw"), (Algorithm.NEEDLEMAN_WUNSCH, "nw")):
        out = cuda_align.fill(r, f, mrp, params, alg, tie)
        args = (*out, mrp, mxp, n, key == "sw", params.affine)
        km = time_cuda(lambda: cuda_walk.walk(*args))
        device_ms = time_device(lambda: cuda_walk.walk(*args))
        pl = time_cuda(lambda: plain_dense(*args), reps=plain_reps)
        stats = torch.zeros(3, dtype=torch.int64, device=dev)
        rec, sr = cuda_walk.walk(*args, stats=stats)[:2]
        visited, chain = _visited_rows(rec, sr)
        reissued, deep, rounds = (int(x) for x in stats.tolist())
        start_bytes = b * (16 if key == "sw" else 16 + 8 + 32)
        bd = walk_bound(b, m, visited, start_bytes)
        t[key] = {"ms": km["median"], "ms_min": km["min"], "ms_max": km["max"],
                  "device_ms": device_ms, "plain_ms": pl["median"], "bound_ms": bd,
                  "visited_rows": visited, "longest_chain_rows": chain,
                  "ns_per_chain_row": 1e6 * km["median"] / max(chain, 1),
                  "windows_staged_again": reissued, "runs_below_window": deep,
                  "rows_a_round": visited / max(rounds, 1)}
        log(f"[times] walk.cu {'affine' if params.affine else 'linear'} {key} B={b} {m}x{n}: "
            f"{km['median']:.4f} ms (min {km['min']:.4f}, max {km['max']:.4f}; the card alone "
            f"{device_ms:.4f}); plain {pl['median']:.1f} ms; "
            f"bound {bd:.4f} ms ({100 * bd / km['median']:.1f}%; bytes: {visited} rows "
            f"visited); longest chain {chain} rows, {t[key]['ns_per_chain_row']:.1f} ns a row; "
            f"misses {reissued} windows staged again, {deep} runs below a window "
            f"({(reissued + deep) / max(visited, 1):.2e} a visited row); {rounds} rounds, "
            f"{t[key]['rows_a_round']:.2f} rows a round")
        del out, args
    return t


def phase_walk_times(dev, pairs, data, errs: dict, plain_ms: dict, launches: dict,
                     splits: dict) -> list[dict]:
    """B7, B8 at ALIGN_PAIRS x LENGTH x LENGTH (DNA default, BWA-MEM
    affine) and at ``map_reads``' align shape (``search_align_pairs``,
    rows wider than a staged window; under the ``map_reads`` key of each
    entry), and B9, B10 at BANDED_PAIRS x BANDED_LEN, band BAND, SW and NW:
    the median of 7 with min and max (wrapper included) and of the card's
    work alone (``time_device``), the plain version (dense: the full shape,
    PLAIN_REPS; banded: the BANDED_SLICE slice), the bound from this run's
    visited rows, ms a row of the longest chain, and each kernel's misses
    and rows a round."""
    from versalignlib_tpu_torch.ops import cuda_align, cuda_banded, cuda_walk
    from versalignlib_tpu_torch.types import Algorithm, TieBreak

    sets = _param_sets()
    tie = TieBreak.DIAG_UP_LEFT
    rng = np.random.default_rng(11)
    align_pairs = search_align_pairs(data)
    entries = []
    for name, replaces in (("dna_default", "versalignlib_tpu/ops/walk.py:78"),
                           ("dna_affine_bwamem", "versalignlib_tpu/ops/walk.py:162")):
        params = sets[name]
        b, m, n = ALIGN_PAIRS, LENGTH, LENGTH
        r_np, f_np = codes_for(params, rng, b, m), codes_for(params, rng, b, n)
        t = _dense_walk_times(dev, params, r_np, f_np, PLAIN_REPS)
        kind = "affine" if params.affine else "linear"
        entry = _walk_entry(f"walk[{kind}]", name, "versalignlib_tpu_torch/csrc/walk.cu",
                            replaces, launches[name], errs[f"walk[{kind}]"], (b, m, n), t,
                            splits.get(name))
        _, r_np, f_np = align_pairs[f"map_reads,{name}"]
        entry["map_reads"] = {"shape": [*r_np.shape, f_np.shape[1]],
                              **_dense_walk_times(dev, params, r_np, f_np, PLAIN_REPS)}
        entries.append(entry)
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
            device_ms = time_device(lambda: cuda_walk.banded_walk(*args))
            stats = torch.zeros(3, dtype=torch.int64, device=dev)
            rec, sr = cuda_walk.banded_walk(*args, stats=stats)[:2]
            visited, chain = _visited_rows(rec, sr)
            reissued, deep, rounds = (int(x) for x in stats.tolist())
            start_bytes = b * (16 if key == "sw" else 8 + 4 * BAND)
            bd = walk_bound(b, m, visited, start_bytes)
            pl = plain_ms[name].get(key)
            t[key] = {"ms": km["median"], "ms_min": km["min"], "ms_max": km["max"],
                      "device_ms": device_ms, "plain_ms": pl, "bound_ms": bd,
                      "visited_rows": visited,
                      "longest_chain_rows": chain, "ns_per_chain_row": 1e6 * km["median"] / chain,
                      "windows_staged_again": reissued, "runs_below_window": deep,
                      "rows_a_round": visited / rounds}
            log(f"[times] banded_walk.cu {name} {key} B={b} {m}x{n} band {BAND}: "
                f"{km['median']:.3f} ms (min {km['min']:.3f}, max {km['max']:.3f}; the card "
                f"alone {device_ms:.3f}); plain "
                f"{'not run' if pl is None else f'{pl:.1f} ms'} on {BANDED_SLICE} pairs; "
                f"bound {bd:.4f} ms ({100 * bd / km['median']:.1f}%; bytes: {visited} rows "
                f"visited); longest chain {chain} rows, {t[key]['ns_per_chain_row']:.1f} ns a "
                f"row; misses {reissued} windows staged again, {deep} runs below a window "
                f"({(reissued + deep) / visited:.2e} a visited row); {rounds} rounds, "
                f"{visited / rounds:.2f} rows a round")
            del out, args
        kind = "affine" if params.affine else "linear"
        entry = _walk_entry(f"banded_walk[{kind}]", name,
                            "versalignlib_tpu_torch/csrc/banded_walk.cu", replaces,
                            launches[f"banded:{name}"], errs[f"banded_walk[{kind}]"], (b, m, n),
                            t, splits.get(f"banded:{name}"))
        entry.update(band=BAND, plain_pairs=BANDED_SLICE)
        entries.append(entry)
        for label, split in (splits.get(f"banded:{name}") or {}).items():
            split = split.get("split", split)
            log(f"[times] banded_walk.cu {name} in {label}: walk {split['walk_ms']:.3f} of a "
                f"{split['wall_ms']:.3f} ms wall ({100 * split['walk_ms'] / split['wall_ms']:.1f}"
                "%): " + json.dumps({k: round(v, 3) for k, v in split.items()}))
    return entries


def _walk_entry(name, params_name, source, replaces, launches, err, shape, t, split) -> dict:
    sw, nw = t["sw"], t["nw"]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "tolerance": 0,
        "ms": sw["ms"], "plain_ms": sw["plain_ms"], "bound_ms": sw["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "params": params_name, "shape": list(shape), "algorithm": "SW",
        "ms_min": sw["ms_min"], "ms_max": sw["ms_max"], "device_ms": sw["device_ms"],
        "visited_rows": sw["visited_rows"],
        "longest_chain_rows": sw["longest_chain_rows"],
        **{k: sw[k] for k in ("windows_staged_again", "runs_below_window", "rows_a_round")
           if k in sw},
        "nw": nw, "matches_plain": True,
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


# ---------------------------------------------------------------------------
# The command line (cli.py) and device staging (io/staging.py)
# ---------------------------------------------------------------------------

#: Every mode of ``python -m versalignlib_tpu_torch`` on small inputs
#: (``write_cli_inputs``; arguments naming one of its files are joined to its
#: directory). ``phase_cli`` runs each on the card and with ``--device cpu``
#: and holds every file to the CPU run's bytes; ``tests/test_torch_cli.py``
#: holds the CPU run to the JAX package's CLI.
CLI_MODES = {
    "pairwise_fastq_sam_bam": ["--reads", "reads.fq", "--refs", "refs.fa", "--sam", "--bam"],
    "compat_sse": ["--reads", "reads.fa", "--refs", "refs.fa", "--reference-compat",
                   "--tie", "sse"],
    "affine_sam": ["--reads", "reads.fa", "--refs", "refs.fa", "--gap-open", "-4", "--sam"],
    "blosum62": ["--reads", "prot_reads.fa", "--refs", "prot_refs.fa", "--matrix", "blosum62",
                 "--gap-open", "-11", "--gap-read", "-1", "--gap-ref", "-1", "--sam"],
    "panel_both_strands": ["--reads", "panel_reads.fa", "--panel", "panel.fa",
                           "--both-strands", "--sam", "--bam"],
    "panel_paired": ["--reads", "panel_reads.fa", "--reads2", "mates.fq", "--panel",
                     "panel.fa", "--sam", "--bam"],
    "panel_stats": ["--reads", "panel_reads.fa", "--panel", "panel.fa", "--stats",
                    "--stats-samples", "32"],
    "reference": ["--reads", "genome_reads.fa", "--reference", "genome.fa", "--sam", "--bam"],
    "reference_long": ["--reads", "long_reads.fa", "--reference", "long_genome.fa", "--long",
                       "--sam", "--bam"],
    "band": ["--reads", "band_reads.fa", "--refs", "band_refs.fa", "--band", "32", "--sam"],
    "band_affine": ["--reads", "band_reads.fa", "--refs", "band_refs.fa", "--band", "32",
                    "--gap-open", "-4", "--gap-read", "-1", "--gap-ref", "-1"],
    "band_blosum62": ["--reads", "prot_reads.fa", "--refs", "prot_refs.fa", "--band", "32",
                      "--matrix", "blosum62", "--gap-open", "-11", "--gap-read", "-1",
                      "--gap-ref", "-1", "--sam"],
    "pssm": ["--pssm-from", "motifs.fa", "--panel", "pool.fa", "--top", "5", "--stats",
             "--stats-samples", "32"],
    "translated": ["--translated", "--reads", "tr_reads.fa", "--panel", "tr_panel.fa"],
    "selftest_oracle": ["--selftest", "--backend", "oracle", "--sam"],
}
#: The full-width CLI runs: pairwise at the main path's shape (CLI_PAIRS
#: reads of LENGTH against as many refs) and ``--panel`` at ``map_reads``'
#: (SEARCH_READS reads of READ_LEN against SEARCH_PANEL entries of
#: PANEL_LEN). STAGED_CHUNKS chunks of SCORE_PAIRS pairs of LENGTH go
#: through ``prefetch_to_device``.
CLI_PAIRS = 4096
STAGED_CHUNKS = 8
_CODON = {"M": "ATG", "K": "AAA", "V": "GTT", "L": "CTG", "A": "GCT", "G": "GGC",
          "S": "TCT", "E": "GAA", "R": "CGT", "W": "TGG", "F": "TTT", "Y": "TAT",
          "P": "CCG", "T": "ACC", "D": "GAT", "N": "AAC", "Q": "CAG", "H": "CAT",
          "I": "ATT", "C": "TGC"}


def write_cli_inputs(d, rng) -> None:
    """Seeded FASTA/FASTQ inputs for every mode of CLI_MODES in directory
    ``d``: pairs with indels, an N and an unrelated read (FASTA and FASTQ);
    protein pairs; a panel with reads on both strands and mates, one
    unrelated; two contigs with reads; a 3 kbp genome with three long reads
    and a junk read; long pairs; aligned motif instances and a pool that
    holds the motif; reverse-translated peptides."""
    from versalignlib_tpu_torch.alphabet import reverse_complement
    from versalignlib_tpu_torch.io.fasta import write_fasta
    from versalignlib_tpu_torch.io.fastq import write_fastq

    dna, protein = np.array(list("ACGT")), np.array(list("ARNDCQEGHILKMFPSTWYV"))

    def seq(n, alphabet=dna):
        return "".join(rng.choice(alphabet, size=int(n)))

    def mutate(s, rate=0.05):
        out = []
        for c in s:
            r = rng.random()
            if r < rate / 3:
                continue
            out.append(str(rng.choice(dna)) if r < rate else c)
            if r < 2 * rate / 3:
                out.append(c)
        return "".join(out)

    def quals(seqs):
        return ["".join(chr(33 + int(q)) for q in rng.integers(0, 41, size=len(s)))
                for s in seqs]

    refs = [seq(rng.integers(40, 90)) for _ in range(12)]
    reads = [mutate(r[int(rng.integers(0, 10)):][:int(rng.integers(20, 50))]) for r in refs]
    reads[3] = "N" + reads[3]
    reads[5] = seq(30)
    write_fasta(d / "reads.fa", reads)
    write_fasta(d / "refs.fa", refs, names=[f"ref{i} desc" for i in range(12)])
    write_fastq(d / "reads.fq", reads, names=[f"r{i}" for i in range(12)],
                qualities=quals(reads))
    prot = [seq(rng.integers(20, 40), protein) for _ in range(6)]
    write_fasta(d / "prot_reads.fa", ["".join(c if rng.random() > 0.15 else str(rng.choice(
        protein)) for c in p[2:30]) for p in prot])
    write_fasta(d / "prot_refs.fa", prot)
    panel = [seq(80) for _ in range(6)]
    preads, mates = [], []
    for i in range(10):
        j, lo = int(rng.integers(0, 6)), int(rng.integers(0, 30))
        r = mutate(panel[j][lo:lo + 30])
        preads.append(reverse_complement(r) if i % 2 else r)
        mates.append(reverse_complement(panel[j][lo + 40:lo + 70]) if i != 4 else seq(30))
    write_fasta(d / "panel.fa", panel, names=[f"p{i}" for i in range(6)])
    write_fasta(d / "panel_reads.fa", preads)
    write_fastq(d / "mates.fq", mates, qualities=quals(mates))
    contigs = [seq(700), seq(500)]
    greads = []
    for i in range(8):
        c = contigs[i % 2]
        lo = int(rng.integers(0, len(c) - 60))
        r = mutate(c[lo:lo + 50])
        greads.append(reverse_complement(r) if i % 3 == 0 else r)
    write_fasta(d / "genome.fa", contigs, names=["chrA", "chrB"])
    write_fasta(d / "genome_reads.fa", greads)
    genome = seq(3000)
    lreads = []
    for i in range(3):
        lo = int(rng.integers(0, 2000))
        r = mutate(genome[lo:lo + 600], 0.01)
        lreads.append(reverse_complement(r) if i == 1 else r)
    write_fasta(d / "long_genome.fa", [genome], names=["chrL"])
    write_fasta(d / "long_reads.fa", lreads + [seq(400)])
    brefs = [seq(rng.integers(150, 200)) for _ in range(4)]
    write_fasta(d / "band_reads.fa", [mutate(r, 0.03) for r in brefs])
    write_fasta(d / "band_refs.fa", brefs)
    motif = seq(12)
    write_fasta(d / "motifs.fa", ["".join(c if rng.random() > 0.1 else str(rng.choice(dna))
                                          for c in motif) for _ in range(6)])
    pool = [seq(60) for _ in range(8)]
    pool[2] = pool[2][:20] + motif + pool[2][32:]
    write_fasta(d / "pool.fa", pool)
    peptides = [seq(30, protein) for _ in range(4)]
    coding = ["".join(_CODON[a] for a in p[3:20]) for p in peptides]
    coding[1] = reverse_complement(coding[1])
    write_fasta(d / "tr_panel.fa", peptides)
    write_fasta(d / "tr_reads.fa", coding)


def cli_args(mode_args: list[str], d) -> list[str]:
    """A mode's arguments with its input files joined to directory ``d``."""
    return [str(d / a) if (d / a).is_file() else a for a in mode_args]


def run_cli(args: list[str]) -> str:
    """``cli.main(args)`` in this process; its standard output. A non-zero
    return raises."""
    from versalignlib_tpu_torch import cli

    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = cli.main(args)
    if rc != 0:
        raise AssertionError(f"cli {' '.join(args)} returned {rc}: {out.getvalue()}")
    return out.getvalue()


def same_files(label: str, got_dir, want_dir) -> list[str]:
    """Names of the files in ``want_dir``; raises unless ``got_dir`` holds
    the same names, each with the same bytes."""
    want = sorted(p.name for p in want_dir.iterdir())
    got = sorted(p.name for p in got_dir.iterdir())
    if got != want or not want:
        raise AssertionError(f"cli {label}: files {got} on the card, {want} on the CPU")
    for name in want:
        if (got_dir / name).read_bytes() != (want_dir / name).read_bytes():
            raise AssertionError(f"cli {label}: {name} differs from the CPU run's bytes")
    return want


def _codes_text(codes: np.ndarray) -> list[str]:
    from versalignlib_tpu_torch.alphabet import decode

    return [decode(c) for c in codes]


def make_cli_pairs(rng) -> tuple[np.ndarray, np.ndarray]:
    """CLI_PAIRS random A/C/G/T refs of LENGTH bp and reads copied from them
    with 3% substitutions, one deletion and one insertion, 1% N, all of
    LENGTH bp (so that every file holds real alignments)."""
    refs = rng.integers(1, 5, size=(CLI_PAIRS, LENGTH)).astype(np.uint8)
    reads = _substitute(rng, refs, 0.03, 4)
    cut = rng.integers(0, LENGTH, size=(CLI_PAIRS, 2))
    for i in range(CLI_PAIRS):
        row = np.delete(reads[i], cut[i, 0])
        reads[i] = np.insert(row, min(cut[i, 1], LENGTH - 1), rng.integers(1, 5))
    reads = np.where(rng.random(reads.shape) < 0.01, np.uint8(5), reads).astype(np.uint8)
    return reads, refs


def phase_cli(rng) -> dict:
    """``python -m versalignlib_tpu_torch`` in process: every mode of
    CLI_MODES and ``--selftest --bench`` on the card, launch counts set to 0
    just before and read just after (every kernel, B1-B10, must launch),
    each file == the same command with ``--device cpu``; then pairwise at
    full width (CLI_PAIRS x LENGTH x LENGTH, ``--sam --bam``), its wall
    split by the host clock into parse, encode, score, align, text, SAM and
    BAM, its score files == ``AlignmentEngine.score_alignments`` on the same
    codes, ``parse_fasta_codes`` == ``parse_fasta`` + ``pad_and_encode``,
    ``write_sam_batch`` (native) == ``write_sam`` (Python) on the card's raw
    batch; and ``--panel`` at ``map_reads``' shape, its hits == ``map_reads``
    on the same codes."""
    import tempfile

    from versalignlib_tpu_torch import AlignmentEngine, cli, dispatch, map_reads, native
    from versalignlib_tpu_torch.alphabet import pad_and_encode
    from versalignlib_tpu_torch.io import bam, fastq, sam
    from versalignlib_tpu_torch.io.fasta import parse_fasta, write_fasta
    from versalignlib_tpu_torch.ops.cuda_backend import CudaBackend
    from versalignlib_tpu_torch.types import Algorithm

    if not native.available():
        raise AssertionError("the native library does not build or load on this host")
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        d = root / "in"
        d.mkdir()
        write_cli_inputs(d, rng)
        kernels = _zero_launches()
        t0 = time.perf_counter()
        for mode, args in CLI_MODES.items():
            before = {k: v.launches for k, v in kernels.items()}
            t_mode = time.perf_counter()
            run_cli(cli_args(args, d) + ["--outdir", str(root / "card" / mode)])
            if mode == "band_blosum62":
                # The CLI's route to the BLOSUM62 branches of B5 and B6.
                torch.cuda.synchronize()
                t_mode = 1e3 * (time.perf_counter() - t_mode)
                banded = {k: kernels[k].launches - before[k]
                          for k in ("banded_score", "banded_align", "banded_walk")}
                if not (banded["banded_score"] or banded["banded_align"]):
                    raise AssertionError(f"cli band_blosum62 launched no banded kernel: {banded}")
                log(f"[cli] band_blosum62 on the card: wall {t_mode:.3f} ms, launches {banded}")
                out["band_blosum62"] = {"wall_ms": t_mode, "launches": banded}
        bench = run_cli(["--selftest", "--bench", "--outdir", str(root / "card" / "selftest")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _require_launches("the CLI's modes", kernels, kernels)
        log(f"[cli] {len(CLI_MODES) + 1} modes on the card: launches {launches} ({wall:.2f} s)")
        t0 = time.perf_counter()
        for mode, args in CLI_MODES.items():
            run_cli(cli_args(args, d) + ["--outdir", str(root / "cpu" / mode), "--device", "cpu"])
        run_cli(["--selftest", "--outdir", str(root / "cpu" / "selftest"), "--device", "cpu"])
        files = sum(len(same_files(mode, root / "card" / mode, root / "cpu" / mode))
                    for mode in [*CLI_MODES, "selftest"])
        log(f"[cli] every mode's {files} files == the --device cpu run's bytes "
            f"({time.perf_counter() - t0:.2f} s); bench table on the card:\n{bench.strip()}")
        out["modes"] = {"launches": launches, "wall_s": wall, "files": files}

        reads, refs = make_cli_pairs(rng)
        write_fasta(d / "big_reads.fa", _codes_text(reads))
        write_fasta(d / "big_refs.fa", _codes_text(refs))
        targets = {"parse": (fastq, "parse_records"), "encode": (dispatch, "pad_and_encode"),
                   "score": (CudaBackend, "score_alignments"),
                   "align": (CudaBackend, "compute_alignments"),
                   "text": (cli, "_write_scores"), "text_aln": (cli, "_write_alignments"),
                   "sam": (sam, "write_sam"), "bam": (cli, "_maybe_bam")}
        args = ["--reads", str(d / "big_reads.fa"), "--refs", str(d / "big_refs.fa"),
                "--sam", "--bam", "--outdir", str(root / "big")]
        acc = {key: [] for key in targets}
        with contextlib.ExitStack() as timers:
            for key, (owner, attr) in targets.items():
                timers.enter_context(_host_timed(owner, attr, acc[key]))
            t0 = time.perf_counter()
            run_cli(args)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        split = {k: sum(v) for k, v in acc.items()}
        split["text"] += split.pop("text_aln")
        split["rest"] = wall - sum(split.values())
        log(f"[cli] pairwise {CLI_PAIRS} x {LENGTH} x {LENGTH} --sam --bam on the card: wall "
            f"{wall:.3f} ms = " + " + ".join(f"{k} {v:.3f}" for k, v in split.items()))
        out["pairwise"] = {"wall_ms": wall, "split_ms": split,
                           "shape": [CLI_PAIRS, LENGTH, LENGTH]}
        codes, lengths = native.parse_fasta_codes(d / "big_reads.fa")
        if not (np.array_equal(codes, pad_and_encode(parse_fasta(d / "big_reads.fa")))
                and np.array_equal(codes, reads) and (lengths == LENGTH).all()):
            raise AssertionError("parse_fasta_codes differs from parse_fasta + pad_and_encode")
        engine = AlignmentEngine()
        for alg in Algorithm:
            algo = alg.name.lower()
            text = (root / "big" / f"scores_{algo}.txt").read_text().splitlines()
            if not np.array_equal(np.array(text[2::3], dtype=np.int32),
                                  engine.score_alignments(alg, reads, refs)):
                raise AssertionError(f"cli scores_{algo}.txt differs from score_alignments")
            sam_text = (root / "big" / f"alignments_{algo}.sam").read_text()
            if bam.read_bam(root / "big" / f"alignments_{algo}.bam") != sam_text:
                raise AssertionError(f"cli alignments_{algo}.bam does not read back as its SAM")
        seqs, ref_seqs = _codes_text(reads), _codes_text(refs)
        batch = engine.compute_alignments(Algorithm.SMITH_WATERMAN, reads, refs, raw=True)
        strands = (np.arange(CLI_PAIRS) % 2).tolist()
        t0 = time.perf_counter()
        native_buf = io.StringIO()
        sam.write_sam_batch(native_buf, batch, seqs, ref_seqs, strands=strands)
        t_native = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        python_buf = io.StringIO()
        sam.write_sam(python_buf, list(batch), seqs, ref_seqs, strands=strands)
        t_python = 1e3 * (time.perf_counter() - t0)
        if native_buf.getvalue() != python_buf.getvalue():
            raise AssertionError("write_sam_batch (native) differs from write_sam (Python)")
        log(f"[cli] parse_fasta_codes == parse_fasta + pad_and_encode on {CLI_PAIRS} reads; "
            f"score files == score_alignments; BAM reads back as SAM; write_sam_batch "
            f"(native, {t_native:.3f} ms) == write_sam (Python, {t_python:.3f} ms) on "
            f"{CLI_PAIRS} records")
        out["sam_ms"] = {"native": t_native, "python": t_python}

        panel_reads, panel, _, _ = make_map_reads(rng)
        write_fasta(d / "map_reads.fa", _codes_text(panel_reads))
        write_fasta(d / "map_panel.fa", _codes_text(panel))
        args = ["--reads", str(d / "map_reads.fa"), "--panel", str(d / "map_panel.fa"),
                "--sam", "--outdir", str(root / "panel")]
        t0 = time.perf_counter()
        run_cli(args)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        for alg in Algorithm:
            rows = (root / "panel" / f"hits_{alg.name.lower()}.tsv").read_text().splitlines()
            hits = map_reads(panel_reads, panel, algorithm=alg, align=False, both_strands=False)
            got = np.array([r.split("\t")[2:5:2] for r in rows[1:]], dtype=np.int64)
            if not (np.array_equal(got[:, 0], hits.index)
                    and np.array_equal(got[:, 1], hits.score)):
                raise AssertionError(f"cli --panel hits_{alg.name.lower()}.tsv differ from "
                                     "map_reads")
        log(f"[cli] --panel {SEARCH_READS} x {READ_LEN} vs {SEARCH_PANEL} x {PANEL_LEN} --sam "
            f"on the card: wall {wall:.3f} ms; hits == map_reads")
        out["panel"] = {"wall_ms": wall, "shape": [SEARCH_READS, READ_LEN, SEARCH_PANEL,
                                                   PANEL_LEN]}
    return out


def phase_staging(rng, dev) -> dict:
    """``prefetch_to_device`` feeding ``cuda_score.score_batch_device``:
    STAGED_CHUNKS chunks of SCORE_PAIRS x LENGTH x LENGTH code pairs, the
    staged scores == the unstaged ones in every chunk; times of one chunk's
    pageable ``.to()`` copy (CUDA events), of its staging (the copy into
    page-locked memory by the host clock, the page-locked copy by CUDA
    events), and of the whole loop staged and unstaged (host clock, in
    turns: unstaged, staged, staged, unstaged, REPS rounds)."""
    from versalignlib_tpu_torch.io.staging import prefetch_to_device
    from versalignlib_tpu_torch.ops.cuda_score import score_batch_device
    from versalignlib_tpu_torch.types import Algorithm

    params = _param_sets()["dna_default"]
    alg = Algorithm.SMITH_WATERMAN
    chunks = [(k, random_codes(rng, SCORE_PAIRS, LENGTH), random_codes(rng, SCORE_PAIRS, LENGTH))
              for k in range(STAGED_CHUNKS)]

    def unstaged():
        return [score_batch_device(torch.from_numpy(r).to(dev), torch.from_numpy(f).to(dev),
                                   params, alg) for _, r, f in chunks]

    def staged():
        out = []
        for k, r, f in prefetch_to_device(iter(chunks), depth=2, device=dev):
            if not (r.is_cuda and f.is_cuda) or k != len(out):
                raise AssertionError("prefetch_to_device broke the order or missed the card")
            out.append(score_batch_device(r, f, params, alg))
        return out

    want = [s.cpu() for s in unstaged()]
    got = [s.cpu() for s in staged()]
    for k, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            raise AssertionError(f"staged chunk {k}: scores differ from the unstaged ones")
    _, r, f = chunks[0]
    pageable = time_cuda(lambda: (torch.from_numpy(r).to(dev), torch.from_numpy(f).to(dev)))
    pin = time_host(lambda: (torch.from_numpy(r).pin_memory(), torch.from_numpy(f).pin_memory()))
    pr, pf = torch.from_numpy(r).pin_memory(), torch.from_numpy(f).pin_memory()
    pinned = time_cuda(lambda: (pr.to(dev, non_blocking=True), pf.to(dev, non_blocking=True)))
    loops = {"unstaged": [], "staged": []}
    for _ in range(REPS):
        for name in ("unstaged", "staged", "staged", "unstaged"):
            fn = unstaged if name == "unstaged" else staged
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            loops[name].append(1e3 * (time.perf_counter() - t0))
    loop = {k: {"median": statistics.median(v), "min": min(v), "max": max(v), "k": len(v)}
            for k, v in loops.items()}
    mb = 2 * r.nbytes / 1e6
    out = {"chunk_mb": mb, "pageable_ms": pageable, "pin_ms": pin, "pinned_ms": pinned,
           "loop_ms": loop}
    log(f"[staging] {STAGED_CHUNKS} chunks of {SCORE_PAIRS} x {LENGTH} x {LENGTH}: staged "
        f"scores == unstaged in every chunk; one chunk's {mb:.1f} MB of codes: pageable .to() "
        f"{pageable['median']:.3f} ms ({mb / pageable['median']:.1f} GB/s), into page-locked "
        f"memory {pin['median']:.3f} ms (host), page-locked .to() {pinned['median']:.3f} ms "
        f"({mb / pinned['median']:.1f} GB/s); the {STAGED_CHUNKS}-chunk score loop "
        f"unstaged {loop['unstaged']['median']:.3f} ms, staged {loop['staged']['median']:.3f} "
        "ms (medians): " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Serving (serve.py), the bulk pipelines (scripts/torch_bulk_*.py) and the
# examples (examples/torch/)
# ---------------------------------------------------------------------------

#: The serving phase's full-width bursts: SERVE_CLIENTS concurrent requests
#: of SERVE_REQUEST_PAIRS pairs each of the CLI_PAIRS pairs of LENGTH x
#: LENGTH (``make_cli_pairs``), then one /v1/map request at ``map_reads``'
#: shape; ORACLE_CHECK pairs (reads) of each kind also go to a server on the
#: ``oracle`` backend; SERVE_BENCH_S seconds of ``scripts/torch_serve_bench.py``.
SERVE_CLIENTS, SERVE_REQUEST_PAIRS, ORACLE_CHECK, SERVE_BENCH_S = 16, 256, 16, 10
#: The bulk phase: BULK_MAP_READS synthetic reads (``torch_bulk_map``) drawn
#: from the ``map_reads`` panel, BULK_ALIGN_PAIRS pairs of LENGTH scored
#: (``torch_bulk_align``) and BULK_ALIGN_TRACED of them aligned, in chunks of
#: BULK_CHUNK.
BULK_MAP_READS, BULK_ALIGN_PAIRS, BULK_ALIGN_TRACED, BULK_CHUNK = 65536, 131072, 16384, 16384
ROOT = pathlib.Path(__file__).resolve().parent
#: Runs one example with ``jax`` and the JAX package blocked: ``python -c
#: EXAMPLE_RUNNER script [args...]`` from the root of the repository. Its
#: last line on standard error is LAUNCHES and the launch counts of
#: ``_all_kernels`` as JSON.
LAUNCHES = "launches "
EXAMPLE_RUNNER = ("import json, runpy, sys\n"
                  "sys.modules['jax'] = None\n"
                  "sys.modules['versalignlib_tpu'] = None\n"
                  "sys.argv = sys.argv[1:]\n"
                  "try:\n"
                  "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
                  "finally:\n"
                  "    from chip_smoke import LAUNCHES, _all_kernels\n"
                  "    print(LAUNCHES + json.dumps({k: v.launches for k, v in "
                  "_all_kernels().items()}), file=sys.stderr)\n")
#: The kernels each example must launch on the card; with ``--device cpu``
#: it launches none.
EXAMPLE_KERNELS = {
    "01_pairwise.py": ("score", "align", "walk"),
    "02_panel_search.py": ("search", "align", "walk"),
    "03_reference_mapping.py": ("search", "align", "walk"),
    "04_banded_long_pairs.py": ("banded_align", "banded_walk"),
    "05_multichip.py": ("score", "align", "walk"),
    "06_serving.py": ("score", "align", "walk", "search"),
    "07_protein_and_stats.py": ("score", "align", "walk"),
    "08_pssm_motif_scan.py": ("search",),
    "09_translated_search.py": ("search", "align_affine"),
}


def example_scripts() -> list:
    """The port's examples, ``examples/torch/*.py``."""
    return sorted((ROOT / "examples" / "torch").glob("*.py"))


def run_example(script, device: str, timeout: float = 300) -> subprocess.CompletedProcess:
    """``script --device device`` in a subprocess with ``jax`` and the JAX
    package blocked; its completed process (stdout and stderr as text)."""
    return subprocess.run([sys.executable, "-c", EXAMPLE_RUNNER, str(script), "--device",
                           device], capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def example_launches(done: subprocess.CompletedProcess) -> dict:
    """The launch counts an example's run printed (``EXAMPLE_RUNNER``)."""
    lines = [ln for ln in done.stderr.splitlines() if ln.startswith(LAUNCHES)]
    if not lines:
        raise AssertionError(f"no launch counts on standard error: {done.stderr[-2000:]}")
    return json.loads(lines[-1][len(LAUNCHES):])


def load_script(name: str):
    """``scripts/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _zero_launches() -> dict:
    kernels = _all_kernels()
    for k in kernels.values():
        k.launches = 0
    return kernels


def _require_launches(label: str, kernels: dict, names) -> dict:
    launches = {k: v.launches for k, v in kernels.items()}
    missing = [k for k in names if launches[k] < 1]
    if missing:
        raise AssertionError(f"{label} never launched {missing}: {launches}")
    return launches


def _post(addr, path: str, body: dict):
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise AssertionError(f"{path} -> {resp.status}: {data[:300]!r}")
    return json.loads(data)


def _burst(addr, path: str, bodies: list) -> tuple[list, float]:
    """All ``bodies`` posted at once, one thread each; (replies, wall ms
    from the release of the threads to the last reply)."""
    import threading

    replies = [None] * len(bodies)
    errors = []
    go = threading.Barrier(len(bodies) + 1)

    def client(i):
        go.wait()
        try:
            replies[i] = _post(addr, path, bodies[i])
        except Exception as exc:  # noqa: BLE001 (re-raised below)
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    go.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = 1e3 * (time.perf_counter() - t0)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"{path} burst failed: {errors[:2]}")
    return replies, wall


@contextlib.contextmanager
def _kernel_ms(*names):
    """While active, every launch of the kernels ``names`` (of
    ``_all_kernels``) is timed with CUDA events, from whichever thread;
    yields a function that returns their sum in ms."""
    kernels = _all_kernels()
    with contextlib.ExitStack() as stack:
        timers = [stack.enter_context(_LaunchTimer(kernels[n])) for n in names]
        yield lambda: sum(t.ms() for t in timers)


def phase_serve(rng, dev) -> dict:
    """``AlignServer`` over a ``BatchingAligner`` (defaults: max_batch 4096,
    max_wait_ms 5) on the card's engine, in process. After one request of
    each kind off the clock, the launch counts are set to 0 and: bursts of
    SERVE_CLIENTS concurrent /v1/score, /v1/align and /v1/align
    ``fields: "cigar"`` requests of SERVE_REQUEST_PAIRS pairs of LENGTH x
    LENGTH, every reply == the engine's direct call on the card
    (``score_alignments``, ``compute_alignments(raw=True[, gapped=False])
    .to_json_rows()``); one /v1/map of SEARCH_READS reads against the
    ``map_reads`` panel with ``align``, == ``map_reads`` on the card; the
    score, fill, walk and one-vs-many kernels must have launched. ORACLE_CHECK
    pairs (reads) of each kind == a server on the ``oracle`` backend. Each
    burst's wall and pairs/s beside the card's kernel time in it (CUDA
    events) and the engine's direct call on the same pairs, the map
    request's wall beside ``map_reads``' own, and /stats are logged. Then
    ``scripts/torch_serve_bench.py --duration SERVE_BENCH_S`` in process at
    its mix, with the card's kernel time and the host time of ``map_reads``
    and ``pad_and_encode`` over the whole call."""
    import tempfile

    from versalignlib_tpu_torch import AlignmentEngine, alphabet, map_reads, search
    from versalignlib_tpu_torch.serve import AlignServer, BatchingAligner, _hits_json
    from versalignlib_tpu_torch.types import Algorithm

    sw = Algorithm.SMITH_WATERMAN
    reads, refs = make_cli_pairs(rng)
    seqs, ref_seqs = _codes_text(reads), _codes_text(refs)
    map_r, panel, _, _ = make_map_reads(rng)
    map_seqs, panel_seqs = _codes_text(map_r), _codes_text(panel)
    n = SERVE_CLIENTS * SERVE_REQUEST_PAIRS
    engine = AlignmentEngine()
    out: dict = {}

    def bodies(extra=None):
        return [{"reads": seqs[i * SERVE_REQUEST_PAIRS:(i + 1) * SERVE_REQUEST_PAIRS],
                 "refs": ref_seqs[i * SERVE_REQUEST_PAIRS:(i + 1) * SERVE_REQUEST_PAIRS],
                 "algorithm": "sw", **(extra or {})} for i in range(SERVE_CLIENTS)]

    kinds = {"score": ("/v1/score", bodies()), "align": ("/v1/align", bodies()),
             "align_cigar": ("/v1/align", bodies({"fields": "cigar"}))}
    map_body = {"reads": map_seqs, "panel": panel_seqs, "algorithm": "sw",
                "both_strands": True, "align": True}
    with AlignServer(BatchingAligner(engine)) as server:
        server.start()
        addr = server.address
        for path, b in kinds.values():
            _post(addr, path, b[0])
        _post(addr, "/v1/map", {**map_body, "reads": map_seqs[:8]})
        torch.cuda.synchronize()
        stats0 = server.aligner.stats()
        kernels = _zero_launches()
        replies, walls, card_ms = {}, {}, {}
        for kind, (path, b) in kinds.items():
            with _kernel_ms("score", "align", "walk") as ms:
                replies[kind], walls[kind] = _burst(addr, path, b)
                card_ms[kind] = ms()
        with _kernel_ms("search", "align", "walk") as ms:
            t0 = time.perf_counter()
            map_reply = _post(addr, "/v1/map", map_body)["hits"]
            walls["map"] = 1e3 * (time.perf_counter() - t0)
            card_ms["map"] = ms()
        torch.cuda.synchronize()
        stats1 = server.aligner.stats()
        launches = _require_launches("serving", kernels, ("score", "align", "walk", "search"))

    direct = {"score": lambda: engine.score_alignments(sw, reads[:n], refs[:n]),
              "align": lambda: engine.compute_alignments(sw, reads[:n], refs[:n], raw=True),
              "align_cigar": lambda: engine.compute_alignments(sw, reads[:n], refs[:n],
                                                               raw=True, gapped=False)}
    direct_ms, results = {}, {}
    for kind, fn in direct.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[kind] = fn()
        torch.cuda.synchronize()
        direct_ms[kind] = 1e3 * (time.perf_counter() - t0)
    want_scores = results["score"].tolist()
    want_rows = {k: results[k].to_json_rows() for k in ("align", "align_cigar")}
    for kind, got in replies.items():
        key = "scores" if kind == "score" else "alignments"
        flat = [x for r in got for x in r[key]]
        if flat != (want_scores if kind == "score" else want_rows[kind]):
            raise AssertionError(f"served {kind} replies differ from the engine's direct call")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hits = map_reads(map_r, panel, device=dev, align=True)
    torch.cuda.synchronize()
    direct_map_ms = 1e3 * (time.perf_counter() - t0)
    if map_reply != _hits_json(hits, True):
        raise AssertionError("the served /v1/map reply differs from map_reads on the card")

    # One request of each kind, ORACLE_CHECK pairs, on the oracle backend.
    small = {kind: (path, {**b[0], "reads": b[0]["reads"][:ORACLE_CHECK],
                           "refs": b[0]["refs"][:ORACLE_CHECK]})
             for kind, (path, b) in kinds.items()}
    small["map"] = ("/v1/map", {**map_body, "reads": map_seqs[:ORACLE_CHECK]})
    answers = {}
    for backend in ("cuda", "oracle"):
        with AlignServer(BatchingAligner(AlignmentEngine(backend=backend))) as server:
            server.start()
            answers[backend] = {k: _post(server.address, *v) for k, v in small.items()}
    if answers["cuda"] != answers["oracle"]:
        bad = [k for k in small if answers["cuda"][k] != answers["oracle"][k]]
        raise AssertionError(f"served {bad} on the card differ from the oracle backend")

    stats = {k: stats1[k] - stats0[k] for k in ("requests", "batches", "batched_pairs",
                                                "queue_wait_sum_s", "device_sum_s")}
    stats["max_batch_pairs"] = stats1["max_batch_pairs"]
    stats["mean_queue_wait_ms"] = 1e3 * stats["queue_wait_sum_s"] / stats["requests"]
    bursts = {k: {"wall_ms": walls[k], "pairs_per_s": 1e3 * n / walls[k],
                  "card_kernel_ms": card_ms[k], "direct_engine_ms": direct_ms[k]}
              for k in kinds}
    out.update(bursts=bursts, launches=launches, stats=stats,
               map={"wall_ms": walls["map"], "card_kernel_ms": card_ms["map"],
                    "direct_map_reads_ms": direct_map_ms,
                    "reads_per_s": 1e3 * SEARCH_READS / walls["map"]})
    log(f"[serve] bursts of {SERVE_CLIENTS} x {SERVE_REQUEST_PAIRS} pairs of {LENGTH} x "
        f"{LENGTH}: " + "; ".join(
            f"{k} {v['wall_ms']:.3f} ms, {v['pairs_per_s']:.1f} pairs/s (card kernels "
            f"{v['card_kernel_ms']:.3f} ms; the engine's direct call on the {n} pairs "
            f"{v['direct_engine_ms']:.3f} ms)" for k, v in bursts.items())
        + f"; /v1/map {SEARCH_READS} x {READ_LEN} vs {SEARCH_PANEL} x {PANEL_LEN} with align "
        f"{walls['map']:.3f} ms (card kernels {card_ms['map']:.3f} ms; map_reads direct "
        f"{direct_map_ms:.3f} ms); every reply == the engine's direct call on the card; "
        f"{ORACLE_CHECK} of each kind == the oracle backend; launches {launches}; /stats over "
        f"the bursts and the map request: {json.dumps(stats)}")

    bench = load_script("torch_serve_bench")
    host_ms = {"map_reads": [], "pad_and_encode": []}
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "serve_bench.json"
        with contextlib.redirect_stdout(io.StringIO()), \
                _kernel_ms("score", "align", "walk", "search") as ms, \
                _host_timed(search, "map_reads", host_ms["map_reads"], sync=False), \
                _host_timed(alphabet, "pad_and_encode", host_ms["pad_and_encode"], sync=False):
            t0 = time.perf_counter()
            bench.main(["--duration", str(SERVE_BENCH_S), "--out", str(path)])
            call_s = time.perf_counter() - t0
            kernel_s = ms() / 1e3
        result = json.loads(path.read_text())
    if result["errors"]:
        raise AssertionError(f"torch_serve_bench saw errors: {result.get('error_samples')}")
    result["card_kernel_s"] = {"whole_call": kernel_s, "call_s": call_s,
                               "share_of_the_window": kernel_s / result["duration_s"]}
    result["host_s_whole_call"] = {k: {"calls": len(v), "s": sum(v) / 1e3}
                                   for k, v in host_ms.items()}
    out["bench"] = result
    log(f"[serve] torch_serve_bench --duration {SERVE_BENCH_S}: " + json.dumps(
        {k: result[k] for k in ("requests_per_s", "pairs_per_s", "latency", "batching",
                                "dispatcher_s", "bucket_padding", "align_path_ab",
                                "card_kernel_s", "host_s_whole_call")}))
    return out


def _drop_chunk(ckpt: pathlib.Path, chunk: int) -> None:
    """Take ``chunk`` out of the journal ``ckpt/done.jsonl``, as a run killed
    before it committed that chunk would have left it."""
    journal = ckpt / "done.jsonl"
    journal.write_text("".join(line + "\n" for line in journal.read_text().splitlines()
                               if json.loads(line)["chunk"] != chunk))


def phase_bulk(rng, dev) -> dict:
    """The bulk pipelines in process on the card. The launch counts are set
    to 0 just before each script's run and read just after it, before any
    reference call. ``torch_bulk_map --synthetic BULK_MAP_READS --sam``
    against the ``map_reads`` panel in chunks of BULK_CHUNK (the one-vs-many,
    fill and walk kernels launched), then again after one chunk is dropped
    from the journal (its rows overwritten; the same kernels launched):
    ``hits.tsv``, ``table.npy`` and ``alignments.sam`` byte-identical, chunk
    0's rows == ``map_reads`` on the card. ``torch_bulk_align --pairs
    BULK_ALIGN_PAIRS --len LENGTH`` staged and with ``--no-prefetch`` (the
    score kernel launched at least once a chunk): the score tables
    identical, chunk 0 == ``score_alignments``; pairs/s and GCUPS both ways,
    the time spent drawing the synthetic chunks timed apart; the first
    staged run resumed after one chunk is dropped (its scores overwritten),
    ``scores.npy`` byte-identical. ``--mode align`` on BULK_ALIGN_TRACED
    pairs (the fill and walk kernels launched): the alignment file ==
    ``compute_alignments(raw=True).write_to`` on the same codes."""
    import tempfile

    from versalignlib_tpu_torch import AlignmentEngine, map_reads
    from versalignlib_tpu_torch.io.fasta import write_fasta
    from versalignlib_tpu_torch.types import Algorithm

    bulk_map, bulk_align = load_script("torch_bulk_map"), load_script("torch_bulk_align")
    _, panel, _, _ = make_map_reads(rng)
    chunks = -(-BULK_ALIGN_PAIRS // BULK_CHUNK)
    out: dict = {}
    launches: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        write_fasta(root / "panel.fa", _codes_text(panel))
        ck = root / "map"
        argv = ["--synthetic", str(BULK_MAP_READS), "--panel", str(root / "panel.fa"),
                "--ckpt", str(ck), "--chunk", str(BULK_CHUNK), "--sam"]
        with contextlib.redirect_stdout(io.StringIO()), \
                _kernel_ms("search") as b4, _kernel_ms("align", "walk") as fill_walk:
            kernels = _zero_launches()
            t0 = time.perf_counter()
            bulk_map.main(argv)
            torch.cuda.synchronize()
            map_wall = time.perf_counter() - t0
            launches["bulk_map"] = _require_launches("torch_bulk_map --sam", kernels,
                                                     ("search", "align", "walk"))
            map_kernels = {"search_s": b4() / 1e3, "align_walk_s": fill_walk() / 1e3}
        names = ("hits.tsv", "table.npy", "alignments.sam")
        before = {name: (ck / name).read_bytes() for name in names}
        np.load(ck / "table.npy", mmap_mode="r+")[BULK_CHUNK:2 * BULK_CHUNK] = -1
        (ck / "sam_000001.part").write_text("")
        _drop_chunk(ck, 1)
        kernels = _zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            bulk_map.main(argv)
        torch.cuda.synchronize()
        resume_wall = time.perf_counter() - t0
        launches["bulk_map resume"] = _require_launches(
            "torch_bulk_map's resume", kernels, ("search", "align", "walk"))
        if {name: (ck / name).read_bytes() for name in names} != before:
            raise AssertionError("torch_bulk_map: the resumed run's files differ")
        reads0 = bulk_map.synthetic_chunk(0, 0, BULK_CHUNK, panel)
        hits = map_reads(reads0, panel, device=dev, align=False)
        rows = np.stack([hits.index, hits.score, hits.strand, hits.mapq], axis=1)
        if not np.array_equal(np.load(ck / "table.npy")[:BULK_CHUNK], rows):
            raise AssertionError("torch_bulk_map chunk 0 differs from map_reads on the card")
        m = reads0.shape[1]
        out["map"] = {"reads": BULK_MAP_READS, "read_len": m, "wall_s": map_wall,
                      "reads_per_s": BULK_MAP_READS / map_wall,
                      "resume_one_chunk_s": resume_wall, "card_kernels": map_kernels,
                      "sam_bytes": len(before["alignments.sam"])}
        log(f"[bulk] torch_bulk_map --synthetic {BULK_MAP_READS} (reads of {m} bp) vs "
            f"{SEARCH_PANEL} x {PANEL_LEN}, both strands, --sam, chunk {BULK_CHUNK}: "
            f"{map_wall:.3f} s, {BULK_MAP_READS / map_wall:.1f} reads/s (card: one-vs-many "
            f"{map_kernels['search_s']:.3f} s, fill and walk {map_kernels['align_walk_s']:.3f} "
            "s); one chunk dropped "
            f"and resumed in {resume_wall:.3f} s: hits.tsv, table.npy, alignments.sam "
            "byte-identical; chunk 0 == map_reads on the card")

        def run_align(d, *extra, pairs=BULK_ALIGN_PAIRS, need=("score",), at_least=1):
            """``torch_bulk_align --pairs pairs`` into ``d``; its wall s, the
            synthetic draw's s, and its launch counts, each of ``need`` at
            least ``at_least``."""
            draw_ms: list[float] = []
            torch.cuda.synchronize()
            with contextlib.redirect_stdout(io.StringIO()), \
                    _host_timed(bulk_align, "synthetic_chunk", draw_ms, sync=False):
                kernels = _zero_launches()
                t0 = time.perf_counter()
                bulk_align.main(["--pairs", str(pairs), "--len", str(LENGTH), "--chunk",
                                 str(BULK_CHUNK), "--ckpt", str(d), *extra])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            counts = {k: v.launches for k, v in kernels.items()}
            short = [k for k in need if counts[k] < at_least]
            if short:
                raise AssertionError(f"torch_bulk_align {' '.join(extra)} launched {short} "
                                     f"fewer than {at_least} times: {counts}")
            return wall, sum(draw_ms) / 1e3, counts

        runs, tables = [], set()
        cells = BULK_ALIGN_PAIRS * LENGTH * LENGTH
        # In turns, so that the first (cold) run of each way shows.
        for i, name in enumerate(("staged", "pageable", "pageable", "staged")):
            d = root / f"{name}{i}"
            wall, draw, counts = run_align(
                d, *(["--no-prefetch"] if name == "pageable" else []), at_least=chunks)
            launches[f"bulk_align {name}{i}"] = counts
            runs.append({"run": name, "wall_s": wall, "pairs_per_s": BULK_ALIGN_PAIRS / wall,
                         "gcups": cells / wall / 1e9, "draw_s": draw,
                         "pairs_per_s_without_draw": BULK_ALIGN_PAIRS / (wall - draw)})
            tables.add((d / "scores.npy").read_bytes())
        if len(tables) != 1:
            raise AssertionError("torch_bulk_align: staged and pageable score tables differ")
        d = root / "staged0"
        before = (d / "scores.npy").read_bytes()
        np.load(d / "scores.npy", mmap_mode="r+")[BULK_CHUNK:2 * BULK_CHUNK] = -1
        _drop_chunk(d, 1)
        align_resume, _, launches["bulk_align resume"] = run_align(d)
        if (d / "scores.npy").read_bytes() != before:
            raise AssertionError("torch_bulk_align: the resumed run's scores.npy differs")
        r0, f0 = bulk_align.synthetic_chunk(0, 0, BULK_CHUNK, LENGTH)
        engine = AlignmentEngine()
        if not np.array_equal(np.load(d / "scores.npy")[:BULK_CHUNK],
                              engine.score_alignments(Algorithm.SMITH_WATERMAN, r0, f0)):
            raise AssertionError("torch_bulk_align chunk 0 differs from score_alignments")
        out["align_score"] = runs
        out["align_score_resume_one_chunk_s"] = align_resume
        log(f"[bulk] torch_bulk_align --pairs {BULK_ALIGN_PAIRS} --len {LENGTH} --chunk "
            f"{BULK_CHUNK}, in turns: " + "; ".join(
                f"{v['run']} {v['wall_s']:.3f} s, {v['pairs_per_s']:.1f} pairs/s, "
                f"{v['gcups']:.3f} GCUPS (drawing the chunks {v['draw_s']:.3f} s; without it "
                f"{v['pairs_per_s_without_draw']:.1f} pairs/s)" for v in runs)
            + f"; score tables identical; one chunk dropped and resumed in {align_resume:.3f} "
            "s, scores.npy byte-identical; chunk 0 == score_alignments")

        d = root / "traced"
        traced_wall, _, launches["bulk_align --mode align"] = run_align(
            d, "--mode", "align", pairs=BULK_ALIGN_TRACED, need=("align", "walk"))
        buf = io.StringIO()
        engine.compute_alignments(Algorithm.SMITH_WATERMAN, r0, f0, raw=True).write_to(buf)
        if (d / "alignments_000000.txt").read_text() != buf.getvalue():
            raise AssertionError("torch_bulk_align --mode align differs from compute_alignments")
        out["align_traced"] = {"pairs": BULK_ALIGN_TRACED, "wall_s": traced_wall,
                               "pairs_per_s": BULK_ALIGN_TRACED / traced_wall}
        log(f"[bulk] torch_bulk_align --mode align, {BULK_ALIGN_TRACED} pairs of {LENGTH}: "
            f"{traced_wall:.3f} s, {BULK_ALIGN_TRACED / traced_wall:.1f} pairs/s; the "
            "alignment file == compute_alignments(raw=True).write_to")
    out["launches"] = launches
    log(f"[bulk] launches in each script's own run: {json.dumps(launches)}")
    return out


#: The mesh phase: the multi-process script's pairs (of LENGTH x LENGTH),
#: and the chunks of its ``torch_bulk_align`` run (of BULK_CHUNK pairs).
MULTIHOST_PAIRS, MESH_BULK_CHUNKS = 4096, 2


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _in_turns(single, mesh) -> dict:
    """Walls (host clock, synchronised) of ``single`` and ``mesh`` in turns
    (single, mesh, mesh, single, twice), after one call of each off the
    clock: medians of 4."""
    walls = {"single": [], "mesh": []}
    for name in ("single", "mesh", "mesh", "single") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (single if name == "single" else mesh)()
        torch.cuda.synchronize()
        walls[name].append(1e3 * (time.perf_counter() - t0))
    out = {f"{k}_ms": statistics.median(v) for k, v in walls.items()}
    out["overhead_ms"] = out["mesh_ms"] - out["single_ms"]
    return out


def _by_entry(label: str, launches: dict, names: dict) -> dict:
    """Launch counts by the ``kernels`` line entry of the branch each kernel
    ran: ``names`` maps a kernel of ``_all_kernels`` to its entry's name;
    a kernel launched outside ``names`` fails."""
    stray = [k for k, v in launches.items() if v and k not in names]
    if stray:
        raise AssertionError(f"{label} launched {stray}, outside its path: {launches}")
    return {names[k]: v for k, v in launches.items() if v}


def _mesh_item(label: str, single, mesh, names: dict, same) -> tuple[dict, dict]:
    """One mesh entry point: ``single()`` (the call without a mesh) once,
    then ``mesh()`` once with every launch count set to 0 just before and
    read just after (each kernel of ``names`` launched, and no other),
    ``same(got, want)`` true, then both timed in turns. Returns (launches
    by kernels-line entry, ``_by_entry``, and walls)."""
    want = single()
    kernels = _zero_launches()
    got = mesh()
    torch.cuda.synchronize()
    launches = _by_entry(label, _require_launches(f"{label} on the mesh", kernels, names),
                         names)
    if not same(got, want):
        raise AssertionError(f"{label}: the mesh's result differs from the call without one")
    walls = _in_turns(single, mesh)
    log(f"[parallel] {label}: == without the mesh; launches {json.dumps(launches)}; wall "
        f"{walls['mesh_ms']:.3f} ms on the mesh, {walls['single_ms']:.3f} ms without "
        f"(sharding overhead {walls['overhead_ms']:.3f} ms)")
    return launches, walls


def _same_hits(fields):
    def same(got, want):
        return all(np.array_equal(getattr(got, f), getattr(want, f)) for f in fields) \
            and got.alignments == want.alignments
    return same


def _run_multihost(root: pathlib.Path, outdir: str, nproc: int, extra: list) -> tuple:
    """``scripts/torch_multihost_align.py`` as ``nproc`` processes on the
    card through EXAMPLE_RUNNER (``jax`` blocked, launch counts on standard
    error), meeting at a TCP store on localhost; (wall s, launch counts of
    each process, each of score, align and walk at least once)."""
    script = ROOT / "scripts" / "torch_multihost_align.py"
    port = _free_port()
    args = ["--reads", str(root / "reads.fa"), "--refs", str(root / "refs.fa"), "--outdir",
            str(root / outdir), "--coordinator", f"localhost:{port}", "--num-processes",
            str(nproc), *extra]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", EXAMPLE_RUNNER, str(script), *args,
                               "--process-id", str(i)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for i in range(nproc)]
    try:
        done = [subprocess.CompletedProcess(p.args, 0, *p.communicate(timeout=240))
                for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for p, d in zip(procs, done):
        if p.returncode != 0:
            raise AssertionError(f"torch_multihost_align.py ({nproc} processes, {extra}) "
                                 f"exited {p.returncode}: {d.stderr[-2000:]}")
    launches = [example_launches(d) for d in done]
    for i, counts in enumerate(launches):
        missing = [k for k in ("score", "align", "walk") if counts[k] < 1]
        if missing:
            raise AssertionError(f"torch_multihost_align.py process {i} of {nproc} never "
                                 f"launched {missing}: {counts}")
    return wall, launches


def phase_parallel(rng, dev, data) -> dict:
    """The multi-device layer on ``make_mesh()``, every card of the machine.
    Each item runs once without a mesh and once on it, the launch counts set
    to 0 just before the mesh call and read just after, the results ``==``;
    then both walls in turns (the sharding overhead, which is all one card
    can measure): ``AlignmentEngine(mesh=)`` scores (SCORE_PAIRS) and aligns
    (ALIGN_PAIRS) of LENGTH x LENGTH, DNA default and BWA-MEM affine, SW and
    NW; ``map_reads`` under both ``panel_axis`` values, ``map_to_reference``
    with ``panel_axis="panel"``, ``translated_search`` at their search
    shapes. Then an NCCL group at world size 1 in process:
    ``multihost_score_batch`` / ``multihost_align_batch`` on MULTIHOST_PAIRS
    pairs == the engine, the ``all_gather``'s time by the host clock
    (synchronised); ``scripts/torch_multihost_align.py`` as one NCCL process
    and as two processes sharing the card over gloo, its files == the
    engine's through the CLI writers; ``torch_bulk_align``'s staged score
    loop, which shards every chunk over ``make_mesh()``, == the engine
    without a mesh, one launch a shard a chunk; ``prefetch_to_device(mesh=)``'s
    shards on their cards. Returns each item's launch counts by the
    ``kernels`` line entry of the branch they ran (a script's summed over
    its processes)."""
    import tempfile

    import torch.distributed as dist

    from versalignlib_tpu_torch import (AlignmentEngine, map_reads, map_to_reference,
                                        translated_search)
    from versalignlib_tpu_torch.cli import _write_alignments, _write_scores
    from versalignlib_tpu_torch.io.fasta import write_fasta
    from versalignlib_tpu_torch.io.staging import prefetch_to_device
    from versalignlib_tpu_torch.parallel import make_mesh, multihost
    from versalignlib_tpu_torch.parallel.distributed import shard_rows
    from versalignlib_tpu_torch.translate import TRANSLATED_PARAMETERS
    from versalignlib_tpu_torch.types import Algorithm

    smi = nvidia_smi_line()
    mesh = make_mesh()
    if mesh.devices != tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count())):
        raise AssertionError(f"make_mesh() is not every card: {mesh.devices}")
    launches, walls = {}, {}

    def item(label, single, on_mesh, names, same):
        launches[label], walls[label] = _mesh_item(label, single, on_mesh, names, same)

    sets = _param_sets()
    dna = sets["dna_default"]
    #: The kernels-line entries of the DNA default path: the fill and the
    #: walk, and with them the scores.
    dna_fill = {"align": _kernel_name("align", dna), "walk": "walk[linear]"}
    dna_names = {"score": _kernel_name("score", dna), **dna_fill}
    for pname in ("dna_default", "dna_affine_bwamem"):
        params = sets[pname]
        fill = "align_affine" if params.affine else "align"
        walk = "walk[affine]" if params.affine else "walk[linear]"
        one, sharded = AlignmentEngine(params), AlignmentEngine(params, mesh=mesh)
        score_r, score_f = (codes_for(params, rng, SCORE_PAIRS, LENGTH) for _ in range(2))
        align_r, align_f = (codes_for(params, rng, ALIGN_PAIRS, LENGTH) for _ in range(2))
        for alg in Algorithm:
            item(f"score_alignments {pname} {alg.name}",
                 lambda: one.score_alignments(alg, score_r, score_f),
                 lambda: sharded.score_alignments(alg, score_r, score_f),
                 {"score": _kernel_name("score", params)}, np.array_equal)
            item(f"compute_alignments {pname} {alg.name}",
                 lambda: one.compute_alignments(alg, align_r, align_f),
                 lambda: sharded.compute_alignments(alg, align_r, align_f),
                 {fill: _kernel_name("align", params), "walk": walk}, lambda a, b: a == b)

    reads, panel, _, _ = data["map_reads"]
    for axis in ("reads", "panel"):
        item(f"map_reads panel_axis={axis}", lambda: map_reads(reads, panel),
             lambda: map_reads(reads, panel, mesh=mesh, panel_axis=axis),
             {**dna_fill, "search": "search[map_reads,dna_default]"},
             _same_hits(("index", "score", "strand", "mapq")))
    reads, genome, _, _ = data["map_to_reference"]
    item("map_to_reference panel_axis=panel", lambda: map_to_reference(reads, genome),
         lambda: map_to_reference(reads, genome, mesh=mesh, panel_axis="panel"),
         {**dna_fill, "search": "search[map_to_reference]"},
         _same_hits(("ref_id", "pos", "score", "strand", "mapq")))
    reads, proteins, _, _ = data["translated_search"]
    item("translated_search", lambda: translated_search(reads, proteins, alignments=True),
         lambda: translated_search(reads, proteins, alignments=True, mesh=mesh),
         {"search": "search[translated_search]",
          "align_affine": _kernel_name("align", TRANSLATED_PARAMETERS)},
         _same_hits(("index", "frame", "score", "scores", "dna_start", "dna_end", "strand")))

    params = dna
    r_np, f_np = (codes_for(params, rng, MULTIHOST_PAIRS, LENGTH) for _ in range(2))
    engine = AlignmentEngine(params)
    alg = Algorithm.SMITH_WATERMAN
    step = MULTIHOST_PAIRS // 4
    chunks = [(k, r_np[k * step:(k + 1) * step]) for k in range(4)]
    for k, shards in prefetch_to_device(iter(chunks), depth=2, mesh=mesh):
        want = shard_rows(chunks[k][1], mesh.size)
        if len(shards) != mesh.size or any(
                s.device != d or not np.array_equal(s.cpu().numpy(), w)
                for s, d, w in zip(shards, mesh.devices, want)):
            raise AssertionError(f"prefetch_to_device(mesh=): chunk {k}'s shards differ")
    log(f"[parallel] prefetch_to_device(mesh=): 4 chunks of {step} x {LENGTH}, every row "
        "shard on its card with the chunk's bytes, in order")
    want_scores = engine.score_alignments(alg, r_np, f_np)
    want_alns = engine.compute_alignments(alg, r_np, f_np)
    gather_ms: list[float] = []
    multihost.initialize(f"localhost:{_free_port()}", 1, 0, backend="nccl")
    try:
        with _host_timed(dist, "all_gather", gather_ms):
            multihost.multihost_score_batch(r_np, f_np, params, alg, mesh=mesh)
            gather_ms.clear()
            kernels = _zero_launches()
            t0 = time.perf_counter()
            scores = multihost.multihost_score_batch(r_np, f_np, params, alg, mesh=mesh)
            alns, lo, hi = multihost.multihost_align_batch(r_np, f_np, params, alg, mesh=mesh)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            label = "multihost NCCL world 1"
            launches[label] = _by_entry(label, _require_launches(
                "multihost_score_batch / multihost_align_batch", kernels, dna_names),
                dna_names)
            for _ in range(REPS - 1):
                multihost.multihost_score_batch(r_np, f_np, params, alg, mesh=mesh)
    finally:
        dist.destroy_process_group()
    if not (np.array_equal(scores, want_scores) and (lo, hi) == (0, MULTIHOST_PAIRS)
            and alns == want_alns):
        raise AssertionError("multihost_score_batch / multihost_align_batch differ from "
                             "the engine")
    gather = {"median_ms": statistics.median(gather_ms), "min_ms": min(gather_ms),
              "max_ms": max(gather_ms), "k": len(gather_ms)}
    walls["multihost NCCL world 1"] = {"score_and_align_ms": wall, "all_gather": gather}
    log(f"[parallel] multihost_score_batch + multihost_align_batch, NCCL at world size 1, "
        f"{MULTIHOST_PAIRS} pairs of {LENGTH} x {LENGTH} SW: == the engine; {wall:.3f} ms; "
        f"the scores' all_gather {gather['median_ms']:.3f} ms (min {gather['min_ms']:.3f}, "
        f"max {gather['max_ms']:.3f}, {gather['k']} calls, host clock synchronised); {smi}")

    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        write_fasta(root / "reads.fa", _codes_text(r_np))
        write_fasta(root / "refs.fa", _codes_text(f_np))
        want = {}
        reads_t, refs_t = _codes_text(r_np), _codes_text(f_np)
        for a in Algorithm:
            name = "smith_waterman" if a == Algorithm.SMITH_WATERMAN else "needleman_wunsch"
            _write_scores(root / "s.txt", reads_t, refs_t, engine.score_alignments(a, r_np, f_np))
            _write_alignments(root / "a.txt", engine.compute_alignments(a, r_np, f_np))
            want[name] = ((root / "s.txt").read_text(), (root / "a.txt").read_text())
        for label, outdir, nproc, extra in (("NCCL, 1 process", "nccl", 1, []),
                                            ("gloo, 2 processes on one card", "gloo", 2,
                                             ["--collective", "gloo"])):
            wall_s, counts = _run_multihost(root, outdir, nproc, extra)
            out = root / outdir
            for name, (scores_txt, alns_txt) in want.items():
                parts = sorted(out.glob(f"alignments_{name}.part*-of{nproc:03d}.txt"))
                if (out / f"scores_{name}.txt").read_text() != scores_txt or len(parts) != nproc \
                        or "".join(p.read_text() for p in parts) != alns_txt:
                    raise AssertionError(f"torch_multihost_align.py ({label}): {name} files "
                                         "differ from the engine's")
            man = json.loads((out / "manifest.json").read_text())
            rows = [o["rows"] for o in man["outputs"] if isinstance(o, dict)
                    and "smith_waterman" in o["file"]]
            if (man["processes"], man["devices"]) != (nproc, nproc * mesh.size) \
                    or rows[0][0] != 0 or rows[-1][1] != MULTIHOST_PAIRS \
                    or any(a[1] != b[0] for a, b in zip(rows, rows[1:])):
                raise AssertionError(f"torch_multihost_align.py ({label}): bad manifest {man}")
            launches[f"torch_multihost_align.py {label}"] = _by_entry(
                label, {k: sum(c[k] for c in counts) for k in counts[0]}, dna_names)
            walls[f"torch_multihost_align.py {label}"] = {"wall_s": wall_s}
            log(f"[parallel] torch_multihost_align.py, {label}, {MULTIHOST_PAIRS} pairs of "
                f"{LENGTH} x {LENGTH}, SW and NW: scores, merged alignment parts == the "
                f"engine's bytes, manifest tiles the batch; {wall_s:.3f} s with the processes' "
                f"start; launches {json.dumps(counts)}")

        bulk_align = load_script("torch_bulk_align")
        pairs = MESH_BULK_CHUNKS * BULK_CHUNK
        label = "torch_bulk_align (staged loop on make_mesh())"
        kernels = _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            bulk_align.main(["--pairs", str(pairs), "--len", str(LENGTH), "--chunk",
                             str(BULK_CHUNK), "--ckpt", str(root / "bulk")])
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        launches[label] = _by_entry(label, _require_launches(label, kernels, ("score",)),
                                    dna_names)
        if f"mesh={mesh.size}" not in text.getvalue() \
                or kernels["score"].launches != MESH_BULK_CHUNKS * mesh.size:
            raise AssertionError(f"{label}: not one launch a shard a chunk on the "
                                 f"{mesh.size}-card mesh ({kernels['score'].launches} launches)")
        got = np.load(root / "bulk" / "scores.npy")
        want = np.concatenate([engine.score_alignments(
            alg, *bulk_align.synthetic_chunk(0, c, BULK_CHUNK, LENGTH))
            for c in range(MESH_BULK_CHUNKS)])
        if not np.array_equal(got, want):
            raise AssertionError(f"{label}: scores.npy differs from the engine without a mesh")
        walls[label] = {"wall_ms": wall}
        log(f"[parallel] {label}, --pairs {pairs} --len {LENGTH} --chunk {BULK_CHUNK}: "
            f"scores.npy == the engine without a mesh, chunk by chunk; one launch a shard a "
            f"chunk; {wall:.3f} ms")
    log(f"[parallel] {mesh.size} card(s) in the mesh; walls: {json.dumps(walls)}; {smi}")
    return launches


def phase_examples() -> dict:
    """Each ``examples/torch/*.py`` in a subprocess on the card and with
    ``--device cpu``, all at once on 8 workers: every run exits 0, the two
    standard outputs are equal and hold no ``MISS``; on the card each
    example launched its EXAMPLE_KERNELS, with ``--device cpu`` no kernel."""
    from concurrent.futures import ThreadPoolExecutor

    scripts = example_scripts()
    if [s.name for s in scripts] != sorted(EXAMPLE_KERNELS):
        raise AssertionError(f"examples/torch holds {[s.name for s in scripts]}, not "
                             f"{sorted(EXAMPLE_KERNELS)}")

    def run(job):
        script, device = job
        t0 = time.perf_counter()
        done = run_example(script, device)
        return script.name, device, done, time.perf_counter() - t0

    jobs = [(s, d) for s in scripts for d in ("cuda", "cpu")]
    with ThreadPoolExecutor(max_workers=8) as pool:
        runs = list(pool.map(run, jobs))
    stdout, walls, launches = {}, {}, {}
    for name, device, done, wall in runs:
        if done.returncode != 0:
            raise AssertionError(f"{name} --device {device} exited {done.returncode}: "
                                 f"{done.stderr[-2000:]}")
        stdout[name, device] = done.stdout
        walls.setdefault(name, {})[device] = wall
        counts = example_launches(done)
        if device == "cpu" and any(counts.values()):
            raise AssertionError(f"{name} --device cpu launched kernels: {counts}")
        if device == "cuda":
            missing = [k for k in EXAMPLE_KERNELS[name] if counts[k] < 1]
            if missing:
                raise AssertionError(f"{name} on the card never launched {missing}: {counts}")
            launches[name] = {k: v for k, v in counts.items() if v}
    for s in scripts:
        card, cpu = stdout[s.name, "cuda"], stdout[s.name, "cpu"]
        if not card.strip() or card != cpu or "MISS" in card:
            raise AssertionError(f"{s.name}: the card's output differs from the CPU's or "
                                 f"holds MISS:\n{card}\n---\n{cpu}")
    log(f"[examples] {len(scripts)} examples on the card == --device cpu, no MISS; walls (s): "
        + json.dumps(walls) + "; launches on the card: " + json.dumps(launches))
    return {"walls": walls, "launches": launches}


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
        for line in walk_geometry(src, reg_lines[src], pairs, sms):
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
        # B9 walks every linear-gap model's pairs, B10 every affine one's.
        same_gaps = {k: v for k, v in banded_runs.items() if isinstance(v, dict)
                     and sets[v["params"]].affine == sets[name].affine}
        launches[f"banded:{name}"] = sum(v["walk_launches"] for v in same_gaps.values())
        splits[f"banded:{name}"] = {k: v["align_split"] for k, v in same_gaps.items()}
    launches["banded:dna_default"] += longreads["walk_launches"]
    splits["banded:dna_default"].update(map_long_reads=longreads["split"],
                                        long_round=long_round)
    kernels += phase_walk_times(dev, pairs, data, walk_errs, walk_plain, launches, splits)
    log(f"[phase] walk times: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_cli(edge_rng(args.seed, 12))
    log(f"[phase] cli: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_staging(edge_rng(args.seed, 13), dev)
    log(f"[phase] staging: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_serve(edge_rng(args.seed, 14), dev)
    log(f"[phase] serve: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_bulk(edge_rng(args.seed, 15), dev)
    log(f"[phase] bulk: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh_launches = phase_parallel(edge_rng(args.seed, 16), dev, data)
    for entry in kernels:
        entry["mesh_launches"] = {item: by_entry[entry["name"]]
                                  for item, by_entry in mesh_launches.items()
                                  if entry["name"] in by_entry}
    missing = {name for by_entry in mesh_launches.values() for name in by_entry} - {
        entry["name"] for entry in kernels}
    if missing:
        raise AssertionError(f"mesh launches of branches with no kernels entry: {missing}")
    log(f"[phase] parallel: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_examples()
    log(f"[phase] examples: {time.perf_counter() - t0:.1f} s; whole script "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
