"""Command line: the reference example app on the card (the port's
counterpart of ``versalignlib_tpu/cli.py``, writing the same bytes).

Reproduces the behavior of the reference's ``Versalign`` executable
(src/impl/main.cpp:74-215): load two FASTA files, run Smith-Waterman and
Needleman-Wunsch in score and alignment mode, write the four result files
(same filenames, main.cpp:133-155,169-189), then run the threads-vs-time
benchmark table (here: backends-vs-GCUPS, replacing ``time_kernel``'s
OpenMP thread sweep, main.cpp:240-295).

Every mode runs on ``--device`` (default ``cuda``, which raises without a
card); ``--device cpu`` takes the plain PyTorch path.

Usage:
    python -m versalignlib_tpu_torch --reads reads.fa --refs refs.fa [--outdir .]
    python -m versalignlib_tpu_torch --selftest --device cpu   # synthetic data
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

from versalignlib_tpu_torch import (
    Algorithm,
    AlignmentEngine,
    AlignmentParameters,
    available_backends,
)
from versalignlib_tpu_torch.alphabet import pad_and_encode
from versalignlib_tpu_torch.dispatch import _resolve_device
from versalignlib_tpu_torch.utils.logging import get_logger
from versalignlib_tpu_torch.utils.profiling import GcupsMeter

_log = get_logger("cli")

#: Output filenames, matching main.cpp:133-155,169-189.
OUT_FILES = {
    (Algorithm.SMITH_WATERMAN, "score"): "scores_smith_waterman.txt",
    (Algorithm.SMITH_WATERMAN, "align"): "alignments_smith_waterman.txt",
    (Algorithm.NEEDLEMAN_WUNSCH, "score"): "scores_needleman_wunsch.txt",
    (Algorithm.NEEDLEMAN_WUNSCH, "align"): "alignments_needleman_wunsch.txt",
}


def _maybe_bam(sam_path, want: bool) -> None:
    """Write the BAM twin of a just-written SAM file (CLI --bam)."""
    if want:
        from versalignlib_tpu_torch.io.bam import write_bam

        sam_path = pathlib.Path(sam_path)
        write_bam(sam_path.with_suffix(".bam"), sam_path.read_text())


def _oriented_quals(quals, strands):
    """FASTQ QUAL strings in alignment orientation: reversed on reverse-
    strand records; None when the input had no qualities at all."""
    if quals is None or all(q is None for q in quals):
        return None
    return [q[::-1] if (s and q) else q for q, s in zip(quals, strands)]


def _write_scores(path, reads, refs, scores, compat: bool = False):
    """Score files. ``compat=True`` is byte-compatible with the reference
    (one ``<read>\\t<score>`` line per pair, main.cpp:135-139); the default
    extended format adds the ref on its own line."""
    with open(path, "w") as f:
        if compat:
            for r, s in zip(reads, scores):
                f.write(f"{r}\t{int(s)}\n")
        else:
            for r, q, s in zip(reads, refs, scores):
                f.write(f"{r}\n{q}\n{int(s)}\n")


def _write_alignments(path, alignments, compat: bool = False):
    """Alignment files. ``compat=True`` is byte-compatible with the reference
    (the two gapped strings from buffer_start, then a blank line,
    main.cpp:146-153); the default extended format appends a
    ``<cigar>\\t<score>`` third line instead."""
    with open(path, "w") as f:
        if compat:
            for a in alignments:
                f.write(f"{a.read}\n{a.ref}\n\n")
        else:
            for a in alignments:
                f.write(f"{a.read}\n{a.ref}\n{a.cigar}\t{a.score}\n")


def _run_pssm_mode(ap, args, params) -> int:
    """--pssm-from: build a log-odds profile from aligned instances and
    scan the panel with the SMEM-profile search kernel (ops/pssm.py)."""
    from versalignlib_tpu_torch.types import Algorithm

    for bad, name in ((args.reads, "--reads"), (args.reads2, "--reads2"),
                      (args.reference, "--reference"), (args.band, "--band"),
                      (args.long, "--long"), (args.sam, "--sam"),
                      (args.matrix, "--matrix"),
                      (args.selftest, "--selftest")):
        if bad:
            ap.error(f"--pssm-from cannot be combined with {name}")
    if not args.panel:
        ap.error("--pssm-from requires --panel")
    from versalignlib_tpu_torch.io.fastq import parse_sequences_with_names
    from versalignlib_tpu_torch.ops.pssm import profile_search, pssm_from_sequences

    insts = [s for _, s in parse_sequences_with_names(args.pssm_from)]
    if not insts:
        print(f"{args.pssm_from!r} contains no sequences - exiting.",
              file=sys.stderr)
        return 1
    if len({len(s) for s in insts}) != 1:
        ap.error("--pssm-from sequences must be aligned (equal length)")
    if args.alphabet:
        from versalignlib_tpu_torch.alphabet import encode_custom

        codes = encode_custom(insts, args.alphabet)
        s_sym = len(args.alphabet) + 1
        background = np.zeros(s_sym)
        background[1:] = 1.0 / (s_sym - 1)
        pssm = pssm_from_sequences(codes, n_symbols=s_sym,
                                   background=background)
    else:
        pssm = pssm_from_sequences(pad_and_encode(insts))
    recs = parse_sequences_with_names(args.panel)
    panel_names = [n or f"panel{i}" for i, (n, _) in enumerate(recs)]
    pool = [s for _, s in recs]
    if not pool:
        print(f"Panel {args.panel!r} contains no sequences - exiting.",
              file=sys.stderr)
        return 1
    if args.alphabet:
        from versalignlib_tpu_torch.alphabet import encode_custom

        pool = encode_custom(pool, args.alphabet)
    cal = None
    pool_lens = ([len(s) for s in pool] if not isinstance(pool, np.ndarray)
                 else [pool.shape[1]] * len(pool))
    db_len = sum(pool_lens)
    if args.stats:
        from versalignlib_tpu_torch.ops.pssm import calibrate_profile

        cal = calibrate_profile(pssm, params,
                                n=max(64, max(pool_lens)),
                                samples=args.stats_samples, device=args.device)
    hits = profile_search(pssm, pool, params, Algorithm.SMITH_WATERMAN,
                          k=args.top, device=args.device, hits=True,
                          alignments=True, calibration=cal, db_len=db_len)
    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    out = outdir / "hits_pssm.tsv"
    with out.open("w") as fh:
        header = ("rank\tpanel_index\tpanel_name\tscore\tstart\tend"
                  "\tprofile_span\tcigar")
        fh.write(header + ("\tbitscore\tevalue\n" if cal else "\n"))
        for rank, h in enumerate(hits):
            a = h.alignment
            row = (f"{rank}\t{h.index}\t{panel_names[h.index]}\t{h.score}"
                   f"\t{a.ref_start}\t{h.end_col}"
                   f"\t{a.read_start}-{h.end_row}\t{a.cigar}")
            if cal:
                row += f"\t{h.bitscore:.1f}\t{h.evalue:.3g}"
            fh.write(row + "\n")
    print(f"pssm: {pssm.shape[0]}-position profile from {len(insts)} "
          f"instances; top {len(hits)}/{len(pool)} hits -> {out}")
    return 0


def _run_translated_mode(ap, args) -> int:
    """--translated: six-frame translate DNA reads, scan a protein panel
    (translate.py; BLOSUM62 + affine gaps unless overridden)."""
    for bad, name in ((args.reads2, "--reads2"),
                      (args.reference, "--reference"), (args.band, "--band"),
                      (args.long, "--long"), (args.sam, "--sam"),
                      (args.matrix, "--matrix"),
                      (args.alphabet, "--alphabet"),
                      (args.selftest, "--selftest")):
        if bad:
            ap.error(f"--translated cannot be combined with {name}")
    if not args.reads or not args.panel:
        ap.error("--translated requires --reads (DNA) and --panel (protein)")
    from versalignlib_tpu_torch.io.fastq import parse_records, parse_sequences_with_names
    from versalignlib_tpu_torch.translate import calibrate_translated, translated_search

    rrecs = parse_records(args.reads)
    read_names = [n or f"read{i}" for i, (n, _, _) in enumerate(rrecs)]
    reads = [s for _, s, _ in rrecs]
    precs = parse_sequences_with_names(args.panel)
    panel_names = [n or f"panel{i}" for i, (n, _) in enumerate(precs)]
    panel = [s for _, s in precs]
    if not reads or not panel:
        print("empty reads or panel - exiting.", file=sys.stderr)
        return 1
    cal = None
    if args.stats:
        cal = calibrate_translated(
            panel, read_len=max(60, max(len(r) for r in reads)),
            samples=args.stats_samples, device=args.device)
    hits = translated_search(reads, panel, alignments=True, calibration=cal,
                             device=args.device)
    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    out = outdir / "hits_translated.tsv"
    with out.open("w") as fh:
        header = ("read\tpanel_index\tpanel_name\tframe\tscore"
                  "\tdna_start\tdna_end\tstrand\tcigar_dna\tpanel_start")
        fh.write(header + ("\tbitscore\tevalue\n" if cal else "\n"))
        for i in range(len(hits)):
            row = (f"{read_names[i]}\t{int(hits.index[i])}"
                   f"\t{panel_names[int(hits.index[i])]}"
                   f"\t{int(hits.frame[i]):+d}\t{int(hits.score[i])}"
                   f"\t{int(hits.dna_start[i])}\t{int(hits.dna_end[i])}"
                   f"\t{hits.strand[i]}\t{hits.dna_cigar[i]}"
                   f"\t{hits.alignments[i].ref_start}")
            if cal:
                row += (f"\t{float(hits.bitscore[i]):.1f}"
                        f"\t{float(hits.evalue[i]):.3g}")
            fh.write(row + "\n")
    print(f"translated: {len(reads)} reads x 6 frames vs "
          f"{len(panel)}-entry protein panel -> {out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="versalignlib_tpu_torch", description=__doc__)
    ap.add_argument("--reads", help="FASTA or FASTQ file of reads "
                                    "(format sniffed from the first byte)")
    ap.add_argument("--refs", help="FASTA or FASTQ file of references")
    ap.add_argument("--panel", help="FASTA/FASTQ reference panel: map each "
                                    "read against EVERY panel entry and "
                                    "report the best hit (one-vs-many "
                                    "search; replaces --refs)")
    ap.add_argument("--reads2", help="with --panel: mate-2 FASTA/FASTQ — "
                                     "paired-end mapping (FR/RF layouts "
                                     "scored jointly, mate-linked SAM)")
    ap.add_argument("--reference", help="FASTA of LONG references (contigs/"
                                        "chromosomes): map each read by "
                                        "exhaustive window tiling, report "
                                        "global coordinates (replaces "
                                        "--refs/--panel)")
    ap.add_argument("--long", action="store_true",
                    help="with --reference: seed-chain-extend long-read "
                         "mapping (minimizer index + banded extension) "
                         "instead of exhaustive window tiling — use for "
                         "kbp+ reads and/or large genomes")
    ap.add_argument("--min-anchors", type=int, default=3,
                    help="with --long: minimum chained minimizer anchors "
                         "to call a read mapped")
    ap.add_argument("--window", type=int, default=None,
                    help="with --reference: tiling window (default 4x the "
                         "longest read, multiple of 128)")
    ap.add_argument("--stride", type=int, default=None,
                    help="with --reference: tiling stride (default "
                         "window/2; overlap must cover the longest "
                         "alignment span)")
    ap.add_argument("--both-strands", action="store_true",
                    help="with --panel: also score each read's reverse "
                         "complement and report the better orientation "
                         "(SAM FLAG 16, strand column in the hits TSV)")
    ap.add_argument("--outdir", default=".", help="output directory")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where every mode runs: cuda (the default; fails "
                         "without a card) or cpu (the plain PyTorch path)")
    ap.add_argument("--backend", default="auto",
                    help=f"kernel backend (auto|{'|'.join(sorted(available_backends('cpu')))})")
    ap.add_argument("--device-walk", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="cuda backend: walk tracebacks on the device and "
                         "ship compact per-row records instead of the "
                         "packed pointer words (same output, far fewer "
                         "device->host bytes). Default: on for the card, "
                         "off for the CPU; --no-device-walk decodes the "
                         "pointer words on the host")
    ap.add_argument("--match", type=int, default=2)
    ap.add_argument("--mismatch", type=int, default=-1)
    ap.add_argument("--gap-read", type=int, default=-3)
    ap.add_argument("--gap-ref", type=int, default=-3)
    ap.add_argument("--gap-open", type=int, default=0,
                    help="affine gap-open penalty (0 = linear, reference model)")
    ap.add_argument("--band", type=int, default=0,
                    help="banded alignment with this band width (0 = dense; "
                         "use for long pairs, e.g. --band 512 for 10-100kbp)")
    ap.add_argument("--band-tile", type=int, default=64,
                    help="row tile of the banded kernels (accepted and "
                         "passed on; the port's banded kernels choose their "
                         "own rows)")
    ap.add_argument("--matrix", default=None,
                    help="substitution matrix: 'blosum62' or a whitespace TSV "
                         "file of SxS ints (row/col 0 must be zero); implies "
                         "--alphabet for encoding")
    ap.add_argument("--alphabet", default=None,
                    help="custom alphabet string (char i -> code i+1); "
                         "defaults to the protein alphabet with "
                         "--matrix blosum62, else the reference DNA table")
    ap.add_argument("--tie", choices=["canonical", "sse"], default="canonical",
                    help="traceback tie-break flavor: canonical = Default/"
                         "OpenCL (DIAG>UP>LEFT), sse = SSE/AVX (DIAG>LEFT>UP)")
    ap.add_argument("--bench", action="store_true",
                    help="run the backend benchmark table afterwards")
    ap.add_argument("--reference-compat", action="store_true",
                    help="write output files byte-compatible with the "
                         "reference driver (read\\tscore lines; two gapped "
                         "strings + blank line) instead of the extended "
                         "format with CIGAR/score")
    ap.add_argument("--sam", action="store_true",
                    help="additionally write SAM files (soft-clipped flanks, "
                         "AS score tag) next to the text alignments")
    ap.add_argument("--bam", action="store_true",
                    help="with --sam: also write BGZF-compressed BAM "
                         "twins of every SAM file (io/bam.py)")
    ap.add_argument("--stats", action="store_true",
                    help="with --panel: append Karlin-Altschul bitscore and "
                         "E-value columns to the Smith-Waterman hits TSV "
                         "(Gumbel law calibrated on random pairs at "
                         "startup; NW is semi-global, no local-alignment "
                         "statistics apply)")
    ap.add_argument("--stats-samples", type=int, default=512,
                    help="random pairs for the Gumbel calibration")
    ap.add_argument("--stats-cache", default=None,
                    help="JSON file to load/save the Gumbel calibration "
                         "(skip recalibration across runs of the same "
                         "scoring model)")
    ap.add_argument("--pssm-from",
                    help="FASTA of ALIGNED equal-length motif instances: "
                         "build a log-odds PSSM and scan --panel with it "
                         "(profile-search mode; writes hits_pssm.tsv)")
    ap.add_argument("--translated", action="store_true",
                    help="blastx mode: translate DNA --reads in all six "
                         "frames and score them against a PROTEIN --panel "
                         "(BLOSUM62 + affine gaps; writes "
                         "hits_translated.tsv)")
    ap.add_argument("--top", type=int, default=10,
                    help="with --pssm-from: number of top panel hits")
    ap.add_argument("--selftest", action="store_true",
                    help="run on synthetic sequences instead of files")
    args = ap.parse_args(argv)
    _resolve_device(args.device)  # no card and no --device cpu: RuntimeError

    matrix = None
    alphabet = args.alphabet
    if args.matrix:
        from versalignlib_tpu_torch.alphabet import PROTEIN_ALPHABET, blosum62

        if args.matrix.lower() == "blosum62":
            matrix = blosum62()
            alphabet = alphabet or PROTEIN_ALPHABET
        elif not pathlib.Path(args.matrix).is_file():
            ap.error(f"--matrix {args.matrix!r} is neither a known matrix "
                     "name ('blosum62') nor an existing file")
        else:
            rows = [[int(v) for v in line.split()]
                    for line in pathlib.Path(args.matrix).read_text().splitlines()
                    if line.strip()]
            matrix = tuple(tuple(r) for r in rows)
            if alphabet is None:
                ap.error("--matrix FILE requires --alphabet")

    params = AlignmentParameters(
        score_match=args.match, score_mismatch=args.mismatch,
        score_gap_read=args.gap_read, score_gap_ref=args.gap_ref,
        gap_open_read=args.gap_open, gap_open_ref=args.gap_open,
        matrix=matrix,
    )
    from versalignlib_tpu_torch.types import TieBreak
    tie = TieBreak.DIAG_UP_LEFT if args.tie == "canonical" else TieBreak.DIAG_LEFT_UP

    if args.panel and args.band:
        ap.error("--panel and --band cannot be combined (the search path "
                 "uses the dense kernels)")
    if args.reads2 and not args.panel:
        ap.error("--reads2 requires --panel (paired-end mapping is a "
                 "search-mode feature)")
    if args.reads2 and (args.matrix or args.alphabet):
        ap.error("--reads2 is DNA-only (custom matrices/alphabets have "
                 "no complement)")
    if args.reads2 and args.selftest:
        ap.error("--reads2 reads mate files; combine it with --reads/"
                 "--panel, not --selftest")
    if args.reference and (args.panel or args.refs or args.reads2
                           or args.band or args.selftest):
        ap.error("--reference is its own mode: combine it with --reads "
                 "only (not --panel/--refs/--reads2/--band/--selftest)")
    if args.reference and (args.matrix or args.alphabet):
        ap.error("--reference mapping is DNA-only (custom matrices/"
                 "alphabets have no complement)")
    if (args.window or args.stride) and not args.reference:
        ap.error("--window/--stride only apply to --reference mode")
    if args.long and not args.reference:
        ap.error("--long applies to --reference mode")
    if args.long and (args.window or args.stride):
        ap.error("--long replaces window tiling; --window/--stride do "
                 "not apply")
    if args.bam and not args.sam:
        ap.error("--bam requires --sam (BAM files are twins of the SAM "
                 "output)")
    if args.stats and not args.panel:
        ap.error("--stats applies to --panel search (hit significance "
                 "needs a database)")
    if args.stats and args.reads2:
        ap.error("--stats is single-end only (no paired Gumbel law)")
    if args.pssm_from:
        return _run_pssm_mode(ap, args, params)
    if args.translated:
        return _run_translated_mode(ap, args)
    panel_names = None
    read_names: list[str] | None = None
    read_quals: list[str | None] | None = None
    ref_names: list[str] | None = None
    if args.selftest:
        rng = np.random.default_rng(0)
        bases = np.array(list("ACGT"))
        reads = ["".join(rng.choice(bases, size=64)) for _ in range(128)]
        if args.panel:
            refs = ["".join(rng.choice(bases, size=96)) for _ in range(16)]
            panel_names = [f"panel{i}" for i in range(len(refs))]
        else:
            refs = ["".join(rng.choice(bases, size=96)) for _ in range(128)]
    elif args.panel:
        from versalignlib_tpu_torch.io.fastq import (parse_records,
                                                     parse_sequences_with_names)

        if not args.reads:
            ap.error("--panel requires --reads")
        rrecs = parse_records(args.reads)
        read_names = [n or f"read{i}" for i, (n, _, _) in enumerate(rrecs)]
        read_quals = [q for _, _, q in rrecs]
        reads = [s for _, s, _ in rrecs]
        if args.reads2:
            rrecs2 = parse_records(args.reads2)
            reads2 = [s for _, s, _ in rrecs2]
            read_quals2 = [q for _, _, q in rrecs2]
            if len(reads2) != len(reads):
                print(f"Mate counts differ ({len(reads)} vs {len(reads2)}) "
                      "- exiting.", file=sys.stderr)
                return 1
        recs = parse_sequences_with_names(args.panel)
        panel_names = [n for n, _ in recs]
        refs = [s for _, s in recs]
        if not refs:
            print(f"Panel {args.panel!r} contains no sequences - exiting.",
                  file=sys.stderr)
            return 1
    elif args.reference:
        from versalignlib_tpu_torch.io.fastq import (parse_records,
                                                     parse_sequences_with_names)

        if not args.reads:
            ap.error("--reference requires --reads")
        rrecs = parse_records(args.reads)
        read_names = [n or f"read{i}" for i, (n, _, _) in enumerate(rrecs)]
        read_quals = [q for _, _, q in rrecs]
        reads = [s for _, s, _ in rrecs]
        recs = parse_sequences_with_names(args.reference)
        panel_names = [(n.split() or [""])[0] or f"ref{i}"
                       for i, (n, _) in enumerate(recs)]
        refs = [s for _, s in recs]
        if not refs:
            print(f"Reference {args.reference!r} contains no sequences - "
                  "exiting.", file=sys.stderr)
            return 1
    else:
        if not args.reads or not args.refs:
            ap.error("--reads and --refs are required (or use --selftest)")
        # Format-sniffed: FASTA ('>') or FASTQ ('@') both accepted.
        from versalignlib_tpu_torch.io.fastq import parse_records

        rrecs = parse_records(args.reads)
        read_names = [n or f"read{i}" for i, (n, _, _) in enumerate(rrecs)]
        read_quals = [q for _, _, q in rrecs]
        reads = [s for _, s, _ in rrecs]
        frecs = parse_records(args.refs)
        ref_names = [n or f"ref{i}" for i, (n, _, _) in enumerate(frecs)]
        refs = [s for _, s, _ in frecs]
        if len(reads) != len(refs):
            # main.cpp:93-102 semantics.
            print(
                f"Read number ({len(reads)}) differs from ref number "
                f"({len(refs)}) - exiting.", file=sys.stderr,
            )
            return 1

    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    if alphabet is not None:
        from versalignlib_tpu_torch.alphabet import encode_custom

        reads_in = encode_custom(reads, alphabet)
        refs_in = encode_custom(refs, alphabet)
    else:
        reads_in, refs_in = reads, refs

    if args.reference and args.long:
        from versalignlib_tpu_torch.alphabet import reverse_complement
        from versalignlib_tpu_torch.io.sam import write_sam
        from versalignlib_tpu_torch.longread import map_long_reads
        from versalignlib_tpu_torch.types import Alignment

        _log.info("long-read mapping: %d reads vs %d reference(s), "
                  "%d total bp", len(reads), len(refs),
                  sum(len(r) for r in refs))
        rnames = read_names or [f"read{i}" for i in range(len(reads))]
        hits = map_long_reads(reads, refs, params, tie=tie,
                              min_anchors=args.min_anchors, device=args.device)
        with open(outdir / "hits_long.tsv", "w") as f:
            f.write("read\tref\tref_id\tpos\tstrand\tscore\tmapq\t"
                    "chain_score\n")
            for i in range(len(hits)):
                rn = (panel_names[hits.ref_id[i]]
                      if hits.ref_id[i] >= 0 else "*")
                f.write(f"{rnames[i]}\t{rn}\t{int(hits.ref_id[i])}\t"
                        f"{int(hits.pos[i])}\t"
                        f"{'-' if hits.strand[i] else '+'}\t"
                        f"{int(hits.score[i])}\t{int(hits.mapq[i])}\t"
                        f"{float(hits.chain_score[i]):.0f}\n")
        if args.sam:
            unmapped = Alignment("", "", 0, "", -1, -1, -1, -1)
            alns = [a if a is not None else unmapped
                    for a in hits.alignments]
            oriented = [reverse_complement(r) if s else r
                        for r, s in zip(reads, hits.strand)]
            quals = _oriented_quals(read_quals, hits.strand)
            sam_path = outdir / "alignments_long.sam"
            write_sam(sam_path, alns, oriented,
                      [refs[j] if j >= 0 else "" for j in hits.ref_id],
                      read_names=rnames,
                      ref_names=[panel_names[j] if j >= 0 else "*"
                                 for j in hits.ref_id],
                      strands=hits.strand, mapqs=hits.mapq, quals=quals)
            _maybe_bam(sam_path, args.bam)
        mapped = int((hits.ref_id >= 0).sum())
        print(f"LONG: mapped {mapped}/{len(reads)} reads vs "
              f"{len(refs)} reference(s)")
        return 0

    if args.reference:
        from versalignlib_tpu_torch.alphabet import reverse_complement
        from versalignlib_tpu_torch.io.sam import write_sam
        from versalignlib_tpu_torch.refmap import map_to_reference, tile_references

        _log.info("reference mapping: %d reads vs %d reference(s), "
                  "%d total bp", len(reads), len(refs),
                  sum(len(r) for r in refs))
        rnames = read_names or [f"read{i}" for i in range(len(reads))]
        m = max((len(r) for r in reads), default=0)
        window = args.window or max(128, -(-4 * m // 128) * 128)
        stride = args.stride or window // 2
        index = tile_references(refs, window, stride)  # shared by both algos
        _log.info("tiling: window=%d stride=%d -> %d windows",
                  window, stride, len(index))
        for algorithm in (Algorithm.SMITH_WATERMAN,
                          Algorithm.NEEDLEMAN_WUNSCH):
            hits = map_to_reference(reads, index, params, algorithm,
                                    backend=args.backend, tie=tie,
                                    device=args.device)
            algo = algorithm.name.lower()
            with open(outdir / f"hits_{algo}.tsv", "w") as f:
                f.write("read\tref\tref_id\tpos\tstrand\tscore\tmapq\n")
                for i in range(len(hits)):
                    f.write(f"{rnames[i]}\t{panel_names[hits.ref_id[i]]}\t"
                            f"{int(hits.ref_id[i])}\t{int(hits.pos[i])}\t"
                            f"{'-' if hits.strand[i] else '+'}\t"
                            f"{int(hits.score[i])}\t{int(hits.mapq[i])}\n")
            _write_alignments(outdir / OUT_FILES[(algorithm, "align")],
                              hits.alignments, compat=args.reference_compat)
            if args.sam:
                oriented = [reverse_complement(r) if s else r
                            for r, s in zip(reads, hits.strand)]
                quals = _oriented_quals(read_quals, hits.strand)
                base = OUT_FILES[(algorithm, "align")].removesuffix(".txt")
                write_sam(outdir / f"{base}.sam", hits.alignments, oriented,
                          [refs[j] for j in hits.ref_id],
                          read_names=rnames,
                          ref_names=[panel_names[j] for j in hits.ref_id],
                          strands=hits.strand, mapqs=hits.mapq, quals=quals)
                _maybe_bam(outdir / f"{base}.sam", args.bam)
            print(f"{algorithm.name}: mapped {len(reads)} reads vs "
                  f"{len(refs)} reference(s) ({len(index)} windows)")
        return 0

    if args.panel and args.reads2:
        from versalignlib_tpu_torch.alphabet import reverse_complement
        from versalignlib_tpu_torch.io.sam import write_sam_paired
        from versalignlib_tpu_torch.search import map_read_pairs

        _log.info("paired panel search: %d fragments vs %d panel entries",
                  len(reads), len(refs))
        rnames = read_names or [f"pair{i}" for i in range(len(reads))]
        for algorithm in (Algorithm.SMITH_WATERMAN,
                          Algorithm.NEEDLEMAN_WUNSCH):
            hits = map_read_pairs(reads, reads2, refs_in, params, algorithm,
                                  backend=args.backend, tie=tie,
                                  align=args.sam, device=args.device)
            algo = algorithm.name.lower()
            with open(outdir / f"hits_{algo}.tsv", "w") as f:
                f.write("fragment\thit\thit_index\torient\tscore\tmapq\n")
                for i in range(len(hits)):
                    f.write(f"{rnames[i]}\t{panel_names[hits.index[i]]}\t"
                            f"{int(hits.index[i])}\t"
                            f"{'RF' if hits.orient[i] else 'FR'}\t"
                            f"{int(hits.score[i])}\t{int(hits.mapq[i])}\n")
            if args.sam:
                base = OUT_FILES[(algorithm, "align")].removesuffix(".txt")
                o1 = [reverse_complement(r) if s else r
                      for r, s in zip(reads, hits.strand1)]
                o2 = [reverse_complement(r) if s else r
                      for r, s in zip(reads2, hits.strand2)]
                write_sam_paired(
                    outdir / f"{base}.sam", hits.alignments1,
                    hits.alignments2, o1, o2,
                    [refs[j] for j in hits.index], read_names=rnames,
                    ref_names=[panel_names[j] for j in hits.index],
                    strands1=hits.strand1, strands2=hits.strand2,
                    mapqs=hits.mapq,
                    quals1=_oriented_quals(read_quals, hits.strand1),
                    quals2=_oriented_quals(read_quals2, hits.strand2))
                _maybe_bam(outdir / f"{base}.sam", args.bam)
            print(f"{algorithm.name}: mapped {len(reads)} read pairs vs a "
                  f"{len(refs)}-entry panel")
        return 0

    if args.panel:
        from versalignlib_tpu_torch.search import map_reads

        _log.info("panel search: %d reads vs %d panel entries%s",
                  len(reads), len(refs),
                  " (both strands)" if args.both_strands else "")
        calib = None
        if args.stats:
            from versalignlib_tpu_torch.stats import GumbelCalibration, calibrate

            cache = pathlib.Path(args.stats_cache) if args.stats_cache else None
            if cache is not None and cache.is_file():
                calib = GumbelCalibration.from_json(cache.read_text())
                _log.info("Gumbel calibration loaded from %s", cache)
            else:
                calib = calibrate(params,
                                  m=max(len(r) for r in reads),
                                  n=max(len(r) for r in refs),
                                  samples=args.stats_samples,
                                  device=args.device)
                if cache is not None:
                    cache.write_text(calib.to_json())
            _log.info("Gumbel calibration: lambda=%.4f K=%.4g "
                      "(%d samples)", calib.lam, calib.k, calib.samples)
        db_len = sum(len(r) for r in refs)
        for algorithm in (Algorithm.SMITH_WATERMAN,
                          Algorithm.NEEDLEMAN_WUNSCH):
            hits = map_reads(reads_in, refs_in, params, algorithm,
                             backend=args.backend, tie=tie,
                             both_strands=args.both_strands,
                             device=args.device)
            algo = algorithm.name.lower()
            rnames = read_names or [f"read{i}" for i in range(len(reads))]
            with_stats = calib is not None and (
                algorithm is Algorithm.SMITH_WATERMAN)
            with open(outdir / f"hits_{algo}.tsv", "w") as f:
                f.write("read\thit\thit_index\tstrand\tscore\tmapq"
                        + ("\tbitscore\tevalue" if with_stats else "")
                        + "\n")
                for i in range(len(hits)):
                    extra = ""
                    if with_stats:
                        extra = (
                            f"\t{float(calib.bit_score(hits.score[i])):.1f}"
                            f"\t{float(calib.evalue(hits.score[i], len(reads[i]), db_len)):.3g}")
                    f.write(f"{rnames[i]}\t{panel_names[hits.index[i]]}\t"
                            f"{int(hits.index[i])}\t"
                            f"{'-' if hits.strand[i] else '+'}\t"
                            f"{int(hits.score[i])}\t{int(hits.mapq[i])}"
                            f"{extra}\n")
            _write_alignments(outdir / OUT_FILES[(algorithm, "align")],
                              hits.alignments, compat=args.reference_compat)
            if args.sam:
                from versalignlib_tpu_torch.alphabet import reverse_complement
                from versalignlib_tpu_torch.io.sam import write_sam

                base = OUT_FILES[(algorithm, "align")].removesuffix(".txt")
                oriented = [reverse_complement(r) if s else r
                            for r, s in zip(reads, hits.strand)]
                quals = _oriented_quals(read_quals, hits.strand)
                write_sam(outdir / f"{base}.sam", hits.alignments, oriented,
                          [refs[j] for j in hits.index],
                          read_names=rnames,
                          ref_names=[panel_names[j] for j in hits.index],
                          strands=hits.strand, mapqs=hits.mapq, quals=quals)
                _maybe_bam(outdir / f"{base}.sam", args.bam)
            print(f"{algorithm.name}: wrote best hits for {len(reads)} "
                  f"reads vs a {len(refs)}-entry panel")
        if args.bench:
            _log.warning("--bench is skipped in --panel mode (the table "
                         "times the 1:1 pairwise virtuals)")
        return 0

    if args.band:
        from versalignlib_tpu_torch.models.base import AlignmentModel

        if args.backend != "auto":
            # The banded path has exactly one kernel pair (ops/banded.py);
            # there is no backend dispatch to honor — say so instead of
            # silently dropping the flag.
            _log.warning("--backend %s is ignored with --band: the banded "
                         "path runs its own kernels", args.backend)
        _log.info("banded path (band=%d) over %d pairs", args.band, len(reads))

        def run(algorithm):
            model = AlignmentModel("cli_banded", algorithm, params, tie,
                                   banded=True, band=args.band,
                                   band_tile=args.band_tile)
            return (model.score(reads_in, refs_in, device=args.device),
                    model.align(reads_in, refs_in, device=args.device))
    else:
        try:
            engine = AlignmentEngine(params=params, backend=args.backend,
                                     tie=tie, device=args.device,
                                     device_walk=args.device_walk)
        except KeyError as exc:
            ap.error(str(exc.args[0] if exc.args else exc))
        _log.info("using backend %s over %d pairs", engine.backend.name, len(reads))

        def run(algorithm):
            return (engine.score_alignments(algorithm, reads_in, refs_in),
                    engine.compute_alignments(algorithm, reads_in, refs_in))

    for algorithm in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        scores, alns = run(algorithm)
        _write_scores(outdir / OUT_FILES[(algorithm, "score")], reads, refs,
                      scores, compat=args.reference_compat)
        _write_alignments(outdir / OUT_FILES[(algorithm, "align")], alns,
                          compat=args.reference_compat)
        if args.sam:
            from versalignlib_tpu_torch.io.sam import write_sam

            base = OUT_FILES[(algorithm, "align")].removesuffix(".txt")
            write_sam(outdir / f"{base}.sam", alns, reads, refs,
                      read_names=read_names, ref_names=ref_names,
                      quals=read_quals)
            _maybe_bam(outdir / f"{base}.sam", args.bam)
        print(f"{algorithm.name}: wrote {len(reads)} scores + alignments")

    if args.bench:
        # Pass the ALREADY-ENCODED inputs: with --alphabet/--matrix the raw
        # strings must not be re-encoded through the DNA table (that would
        # benchmark an all-padding workload).
        run_benchmark_table(reads_in, refs_in, params, device=args.device)
    return 0


def run_benchmark_table(reads, refs, params, repeats: int = 3,
                        device: str = "cuda") -> None:
    """Backends-vs-throughput TSV in BOTH modes, the analogue of
    ``time_kernel``'s table: the reference times ``compute_alignments`` per
    kernel across a thread sweep (main.cpp:240-295); here the sweep axis is
    each backend available on ``device``, and both the score-only and the
    full-alignment virtuals are timed (host clock; the backends return host
    arrays, so every call has finished on the card)."""
    from versalignlib_tpu_torch.dispatch import get_backend
    from versalignlib_tpu_torch.types import TieBreak

    def _enc(x):
        if isinstance(x, np.ndarray) and x.dtype == np.uint8 and x.ndim == 2:
            return x  # already encoded (custom alphabets stay intact)
        return pad_and_encode(x)

    reads_enc = _enc(reads)
    refs_enc = _enc(refs)
    cells = reads_enc.shape[0] * reads_enc.shape[1] * refs_enc.shape[1]
    print("backend\tmode\tseconds/call\tGCUPS")
    for name in available_backends(device):
        backend = get_backend(name, device)

        def run_mode(mode: str, call):
            meter = GcupsMeter()
            with meter.measure(cells):  # warm/compile
                call()
            meter = GcupsMeter()
            for _ in range(repeats):
                with meter.measure(cells):
                    call()
            print(f"{name}\t{mode}\t{meter.seconds / meter.calls:.6f}"
                  f"\t{meter.gcups:.2f}")

        run_mode("score", lambda: backend.score_alignments(
            Algorithm.SMITH_WATERMAN, reads_enc, refs_enc, params))
        run_mode("align", lambda: backend.compute_alignments(
            Algorithm.SMITH_WATERMAN, reads_enc, refs_enc, params,
            TieBreak.DIAG_UP_LEFT))


if __name__ == "__main__":
    sys.exit(main())
