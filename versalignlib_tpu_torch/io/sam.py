"""SAM output for alignment results (production interop surface): the
port's copy of ``versalignlib_tpu/io/sam.py``, byte for byte the same
records and headers.

The reference emits only its own two-gapped-strings text format
(src/impl/main.cpp:146-155); downstream genomics tooling
expects SAM. This maps :class:`~versalignlib_tpu_torch.types.Alignment` results
(local or semi-global) onto single-end SAM records: the aligned window
becomes POS/CIGAR with the unaligned read flanks soft-clipped, the raw read
is SEQ, and the DP score rides the standard ``AS:i`` tag. CIGAR convention
matches SAM: M consumes read+ref, D consumes ref only (read deletion), I
consumes read only.
"""

from __future__ import annotations

import pathlib
import re
from typing import Iterable, Sequence

import numpy as np

from versalignlib_tpu_torch.types import Alignment

#: The @PG header line. It names the JAX package, whose records these are
#: byte for byte, so that files written by either package compare equal.
PG_LINE = "@PG\tID:versalignlib_tpu\tPN:versalignlib_tpu\n"

_CIG_RE = re.compile(r"(\d+)([MID])")


def _nm_md(read_g: str, ref_g: str) -> tuple[int, str]:
    """NM (edit distance) and MD string over an aligned gapped window.

    Inputs are the gapped read/ref strings of the EMITTED alignment window
    (edge non-M runs already trimmed). NM counts mismatched M columns plus
    every inserted read base and deleted ref base; MD follows the samtools
    convention — match-run lengths (0 allowed) separating mismatched ref
    bases and ``^``-prefixed deletion runs, insertions invisible.
    """
    nm = 0
    md: list[str] = []
    run = 0
    i = 0
    n_cols = len(read_g)
    while i < n_cols:
        r, f = read_g[i], ref_g[i]
        if r != "-" and f != "-":
            if r.upper() == f.upper():
                run += 1
            else:
                md.append(f"{run}{f.upper()}")
                run = 0
                nm += 1
            i += 1
        elif f == "-":           # insertion: consumes read only, MD-invisible
            nm += 1
            i += 1
        else:                    # deletion run: '-' in read, ref bases deleted
            dele = []
            while i < n_cols and read_g[i] == "-":
                dele.append(ref_g[i].upper())
                nm += 1
                i += 1
            md.append(f"{run}^{''.join(dele)}")
            run = 0
    md.append(str(run))
    return nm, "".join(md)


def _normalize(aln: Alignment, read_len: int):
    """Edge-op normalization shared by single and paired records.

    Returns ``None`` when nothing aligns (unmapped), else
    ``(lead, items, tail, pos, lead_cols, tail_cols)``: soft-clip lengths,
    surviving CIGAR items, 0-based POS, and how many gapped-string columns
    the edge trimming removed at each end (for NM/MD consistency).
    """
    if not aln.cigar or aln.read_start < 0 or aln.read_end <= aln.read_start:
        return None
    lead = aln.read_start
    tail = read_len - aln.read_end
    pos = aln.ref_start
    lead_cols = tail_cols = 0
    items = [(int(n), op) for n, op in _CIG_RE.findall(aln.cigar)]
    while items and items[0][1] != "M":
        n, op = items.pop(0)
        lead_cols += n
        if op == "D":
            pos += n            # leading deletion: alignment starts later
        else:
            lead += n           # leading insertion: more soft-clipped read
    while items and items[-1][1] != "M":
        n, op = items.pop()
        tail_cols += n
        if op == "I":
            tail += n
    if not items:               # no aligned (M) bases survive
        return None
    return lead, items, tail, pos, lead_cols, tail_cols


def ref_span(aln: Alignment, read_len: int) -> tuple[int, int] | None:
    """0-based half-open reference interval of the EMITTED record
    (post edge normalization), or ``None`` if unmapped. The paired writer
    uses this for PNEXT/TLEN so mate fields match the mate's record."""
    norm = _normalize(aln, read_len)
    if norm is None:
        return None
    _, items, _, pos, _, _ = norm
    return pos, pos + sum(n for n, op in items if op in "MD")


def sam_record(
    aln: Alignment,
    read_seq: str,
    read_name: str,
    ref_name: str,
    reverse: bool = False,
    mapq: int = 255,
    qual: str | None = None,
    flag_bits: int = 0,
    rnext: str = "*",
    pnext: int = -1,
    tlen: int = 0,
) -> str:
    """One SAM line (no trailing newline) for an alignment of ``read_seq``.

    ``reverse``: the alignment is of the reverse-complemented read — sets
    FLAG 16; pass ``read_seq`` (and ``qual``) already in alignment
    (reverse-complement / reversed) orientation, per the SAM convention.

    ``qual``: Phred+33 base-quality string for ``read_seq`` (FASTQ input);
    ``None`` emits ``*``.

    ``flag_bits``: extra FLAG bits OR'd in (paired-end bookkeeping: 0x1
    paired, 0x40/0x80 first/second, 0x20 mate-reverse, 0x8 mate-unmapped);
    ``rnext``/``pnext``/``tlen``: mate fields — ``pnext`` is the 0-based
    mate position (emitted 1-based) or -1 for none (emitted 0).

    Mapped records carry ``AS:i`` (DP score), ``NM:i`` (edit distance over
    the emitted window), and ``MD:Z`` (samtools-convention mismatch/deletion
    string), so downstream tools can reconstruct the reference bases without
    the FASTA.

    SAM validators reject CIGARs whose first/last non-clip op is a
    deletion (and frown on edge insertions), which semi-global tracebacks
    can legitimately produce (the walk may stop on a LEFT step). Edge ops
    are normalized: a leading D advances POS, a trailing D is dropped,
    and edge I runs fold into the soft clips — so the emitted CIGAR always
    starts and ends with M between its clips. NM/MD are computed over the
    same trimmed window, consistent with the emitted CIGAR/POS.
    """
    if qual is not None and len(qual) != len(read_seq):
        raise ValueError(
            f"quality length {len(qual)} != read length {len(read_seq)} "
            f"for {read_name!r}")
    pnext_s = str(pnext + 1) if pnext >= 0 else "0"
    norm = _normalize(aln, len(read_seq))
    if norm is None:
        # Unmapped: drop strand/proper bits, keep the pairing bookkeeping.
        flag = 0x4 | (flag_bits & ~0x2)
        return "\t".join([
            read_name, str(flag), "*", "0", "0", "*", rnext, pnext_s, "0",
            read_seq or "*", qual or "*", f"AS:i:{aln.score}",
        ])
    lead, items, tail, pos, lead_cols, tail_cols = norm
    cigar = (
        (f"{lead}S" if lead else "")
        + "".join(f"{n}{op}" for n, op in items)
        + (f"{tail}S" if tail else "")
    )
    nm, md = _nm_md(aln.read[lead_cols : len(aln.read) - tail_cols],
                    aln.ref[lead_cols : len(aln.ref) - tail_cols])
    return "\t".join([
        read_name,
        str((0x10 if reverse else 0) | flag_bits),
        ref_name,
        str(pos + 1),            # SAM POS is 1-based
        str(int(mapq)),          # 255 = unavailable (pairwise mode)
        cigar,
        rnext, pnext_s, str(int(tlen)),
        read_seq,
        qual or "*",
        f"AS:i:{aln.score}",
        f"NM:i:{nm}",
        f"MD:Z:{md}",
    ])


def write_sam(
    path,
    alignments: Sequence[Alignment],
    reads: Sequence[str],
    refs: Sequence[str],
    read_names: Iterable[str] | None = None,
    ref_names: Iterable[str] | None = None,
    strands=None,
    mapqs=None,
    quals: Sequence[str | None] | None = None,
) -> None:
    """Write single-end SAM: one record per (read, ref) pair.

    ``reads``/``refs`` are the ORIGINAL (ungapped) sequences the batch was
    aligned from — for reverse-strand records (``strands[i]`` truthy) pass
    the read already reverse-complemented (and its quality string already
    reversed), the orientation it was aligned in. Names default to
    ``read<i>`` / ``ref<i>``; ``quals`` entries may be ``None`` (``*``).
    Each pair's ref becomes its own @SQ entry (deduplicated by name).
    """
    read_names = list(read_names) if read_names is not None else [
        f"read{i}" for i in range(len(reads))]
    ref_names = list(ref_names) if ref_names is not None else [
        f"ref{i}" for i in range(len(refs))]
    strands = ([0] * len(reads) if strands is None else
               [int(s) for s in strands])
    mapqs = ([255] * len(reads) if mapqs is None else
             [int(q) for q in mapqs])
    quals = list(quals) if quals is not None else [None] * len(reads)
    if not (len(alignments) == len(reads) == len(refs)
            == len(read_names) == len(ref_names) == len(strands)
            == len(mapqs) == len(quals)):
        raise ValueError("alignments/reads/refs/names/strands/mapqs/quals "
                         "length mismatch")

    def emit(f):
        f.write("@HD\tVN:1.6\tSO:unknown\n")
        seen = set()
        for name, seq in zip(ref_names, refs):
            if name != "*" and name not in seen:  # '*' = unmapped rows
                seen.add(name)
                f.write(f"@SQ\tSN:{name}\tLN:{len(seq)}\n")
        f.write(PG_LINE)
        for aln, seq, rn, fn, st, mq, q in zip(alignments, reads, read_names,
                                               ref_names, strands, mapqs,
                                               quals):
            f.write(sam_record(aln, seq, rn, fn, reverse=bool(st), mapq=mq,
                               qual=q) + "\n")

    if isinstance(path, (str, pathlib.Path)):
        with open(path, "w") as f:
            emit(f)
    else:
        emit(path)


def write_sam_batch(
    path,
    batch,
    reads: Sequence[str],
    refs: Sequence[str],
    read_names: Iterable[str] | None = None,
    ref_names: Iterable[str] | None = None,
    strands=None,
    mapqs=None,
    quals: Sequence[str | None] | None = None,
) -> None:
    """Single-end SAM from a raw :class:`~versalignlib_tpu_torch.types.AlignmentBatch`.

    The bulk fast path: record formatting runs in the native C++ layer
    straight off the column store (~20x the Python writer; identical
    bytes, test-gated), falling back to per-record :func:`sam_record` when
    the native library is unavailable. Same argument conventions as
    :func:`write_sam` (sequences/qualities already in alignment
    orientation; strands flag the reverse-complemented ones).
    """
    n = len(batch)
    read_names = list(read_names) if read_names is not None else [
        f"read{i}" for i in range(n)]
    ref_names = list(ref_names) if ref_names is not None else [
        f"ref{i}" for i in range(n)]
    strands = ([0] * n if strands is None else [int(s) for s in strands])
    mapqs = [255] * n if mapqs is None else [int(q) for q in mapqs]
    quals = list(quals) if quals is not None else [None] * n
    if not (n == len(reads) == len(refs) == len(read_names)
            == len(ref_names) == len(strands) == len(mapqs) == len(quals)):
        raise ValueError("alignments/reads/refs/names/strands/mapqs/quals "
                         "length mismatch")
    for q, s in zip(quals, reads):
        if q is not None and len(q) != len(s):
            raise ValueError("quality length != read length")

    from versalignlib_tpu_torch import native

    body: bytes | None = None
    if native.available():
        flags_mapped = np.array([16 if s else 0 for s in strands],
                                dtype=np.int32)
        flags_unmapped = np.full(n, 4, dtype=np.int32)
        body = native.format_sam_native(
            batch, list(reads), read_names, ref_names, flags_mapped,
            flags_unmapped, np.asarray(mapqs), quals=quals)

    def emit(f):
        f.write("@HD\tVN:1.6\tSO:unknown\n")
        seen = set()
        for name, seq in zip(ref_names, refs):
            if name != "*" and name not in seen:  # '*' = unmapped rows
                seen.add(name)
                f.write(f"@SQ\tSN:{name}\tLN:{len(seq)}\n")
        f.write(PG_LINE)
        if body is not None:
            f.write(body.decode("latin-1"))
        else:  # pure-Python fallback: materialize one record at a time
            for i in range(n):
                f.write(sam_record(batch[i], reads[i], read_names[i],
                                   ref_names[i], reverse=bool(strands[i]),
                                   mapq=mapqs[i], qual=quals[i]) + "\n")

    if isinstance(path, (str, pathlib.Path)):
        with open(path, "w") as f:
            emit(f)
    else:
        emit(path)


def write_sam_paired(
    path,
    alns1: Sequence[Alignment],
    alns2: Sequence[Alignment],
    reads1: Sequence[str],
    reads2: Sequence[str],
    refs: Sequence[str],
    read_names: Iterable[str] | None = None,
    ref_names: Iterable[str] | None = None,
    strands1=None,
    strands2=None,
    mapqs=None,
    quals1: Sequence[str | None] | None = None,
    quals2: Sequence[str | None] | None = None,
) -> None:
    """Write paired-end SAM: two records per fragment, mate-linked.

    Both mates of fragment ``i`` aligned against the same ``refs[i]`` (the
    :func:`~versalignlib_tpu_torch.search.map_read_pairs` contract). As in
    :func:`write_sam`, pass mate sequences/qualities already in alignment
    orientation, with ``strands1``/``strands2`` flagging which are
    reverse-complemented.

    FLAG bookkeeping per the SAM spec: 0x1 paired + 0x40/0x80 first/second
    on every record; 0x2 proper-pair when both mates map; 0x10/0x20
    self/mate strand; 0x4/0x8 self/mate unmapped. RNEXT is ``=`` (mates
    share the reference by construction), PNEXT the mate's emitted POS, and
    TLEN the signed outer span (leftmost mate positive, mate 1 wins the
    tie), all computed from the edge-normalized records so mate fields
    agree with the mate's own line.
    """
    n = len(alns1)
    read_names = list(read_names) if read_names is not None else [
        f"pair{i}" for i in range(n)]
    ref_names = list(ref_names) if ref_names is not None else [
        f"ref{i}" for i in range(n)]
    strands1 = [0] * n if strands1 is None else [int(s) for s in strands1]
    strands2 = [0] * n if strands2 is None else [int(s) for s in strands2]
    mapqs = [255] * n if mapqs is None else [int(q) for q in mapqs]
    quals1 = list(quals1) if quals1 is not None else [None] * n
    quals2 = list(quals2) if quals2 is not None else [None] * n
    if not (n == len(alns2) == len(reads1) == len(reads2) == len(refs)
            == len(read_names) == len(ref_names) == len(strands1)
            == len(strands2) == len(mapqs) == len(quals1) == len(quals2)):
        raise ValueError("paired SAM column length mismatch")

    def emit(f):
        f.write("@HD\tVN:1.6\tSO:unknown\n")
        seen = set()
        for name, seq in zip(ref_names, refs):
            if name not in seen:
                seen.add(name)
                f.write(f"@SQ\tSN:{name}\tLN:{len(seq)}\n")
        f.write(PG_LINE)
        for i in range(n):
            span1 = ref_span(alns1[i], len(reads1[i]))
            span2 = ref_span(alns2[i], len(reads2[i]))
            proper = 0x2 if (span1 and span2) else 0
            flags1 = 0x1 | 0x40 | proper
            flags2 = 0x1 | 0x80 | proper
            if span2:
                if strands2[i]:
                    flags1 |= 0x20
            else:
                flags1 |= 0x8
            if span1:
                if strands1[i]:
                    flags2 |= 0x20
            else:
                flags2 |= 0x8
            tlen1 = tlen2 = 0
            if span1 and span2:
                left = min(span1[0], span2[0])
                right = max(span1[1], span2[1])
                mate1_left = (span1[0], span1[1]) <= (span2[0], span2[1])
                tlen1 = (right - left) if mate1_left else (left - right)
                tlen2 = -tlen1
            # "=" requires a usable RNAME on this line; an unmapped record
            # (RNAME "*") names the mate's reference explicitly instead.
            f.write(sam_record(
                alns1[i], reads1[i], read_names[i], ref_names[i],
                reverse=bool(strands1[i]), mapq=mapqs[i], qual=quals1[i],
                flag_bits=flags1,
                rnext=("=" if span1 else ref_names[i]) if span2 else "*",
                pnext=span2[0] if span2 else -1, tlen=tlen1) + "\n")
            f.write(sam_record(
                alns2[i], reads2[i], read_names[i], ref_names[i],
                reverse=bool(strands2[i]), mapq=mapqs[i], qual=quals2[i],
                flag_bits=flags2,
                rnext=("=" if span2 else ref_names[i]) if span1 else "*",
                pnext=span1[0] if span1 else -1, tlen=tlen2) + "\n")

    if isinstance(path, (str, pathlib.Path)):
        with open(path, "w") as f:
            emit(f)
    else:
        emit(path)
