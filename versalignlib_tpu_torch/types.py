"""Result types and algorithm enums (the port's copy of
``versalignlib_tpu/types.py``).

``Alignment`` is the analogue of the reference's ``Alignment`` struct
(AlignmentKernel.h:12-24): two gapped strings plus start/end indices, with
the score, a CIGAR string and true sequence coordinates added (the
reference's ``readEnd`` / ``refEnd`` are buffer indices, kept as the
``buffer_*`` compat fields).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class Algorithm(enum.IntEnum):
    """DP algorithm selector (the reference's ``opt & 0xF``,
    AlignmentKernel.h:26-32): 0 = Smith-Waterman (local), 1 =
    "Needleman-Wunsch" (semi-global / overlap, SURVEY.md §2.2)."""

    SMITH_WATERMAN = 0
    NEEDLEMAN_WUNSCH = 1


class TieBreak(enum.IntEnum):
    """Traceback pointer flavor: each value selects the complete pointer
    semantics of a reference backend family.

    - ``DIAG_UP_LEFT`` (canonical; Default + OpenCL backends): priority
      DIAG > UP > LEFT, SW cells equal to 0 get START, and N counts as
      *valid* for the NW end-cell tracking (DefaultKernel.cpp:240-248,308).
    - ``DIAG_LEFT_UP`` (SSE/AVX backends): priority DIAG > LEFT > UP, DIAG
      only when both bases are A/C/G/T, no START force at zero SW cells, and
      N counts as *invalid* for NW end-cell tracking
      (SSEKernel.cpp:364-379,515-527,597-611).
    """

    DIAG_UP_LEFT = 0  # canonical (Default + OpenCL backends)
    DIAG_LEFT_UP = 1  # SSE / AVX backends


class Trace(enum.IntEnum):
    """Pointer codes in traceback matrices (2 bits each when packed)."""

    START = 0
    UP = 1     # consume read base against a gap in ref (cost score_gap_ref)
    LEFT = 2   # consume ref base against a gap in read (cost score_gap_read)
    DIAG = 3   # consume both (cost match/mismatch)


class AlignMode(enum.Enum):
    """Score-only vs full traceback (the reference's two AlignmentKernel
    virtuals, AlignmentKernel.h:40-43)."""

    SCORE = "score"
    ALIGN = "align"


@dataclasses.dataclass
class Alignment:
    """One pairwise alignment result.

    ``read`` / ``ref`` are the gapped strings ('-' for gaps) of the aligned
    window. ``read_start:read_end`` and ``ref_start:ref_end`` are half-open
    0-based sequence coordinates; ``buffer_start`` / ``buffer_end`` are the
    reference's buffer indices (DefaultKernel.cpp:441-451).
    """

    read: str
    ref: str
    score: int
    cigar: str
    read_start: int
    read_end: int
    ref_start: int
    ref_end: int
    buffer_start: int = 0
    buffer_end: int = 0

    def __len__(self) -> int:
        return len(self.read)


class AlignmentBatch:
    """Column-store alignment results — no Python object per pair.

    Columns: ``read_gapped``/``ref_gapped`` (b, aln_cap) uint8 ('-' gaps,
    NUL-padded tails), ``cigar`` (b, cigar_cap) uint8, ``meta`` (b, 8) int32
    [score, read_start, read_end, ref_start, ref_end, aln_len, buffer_start,
    cigar_len]. CIGAR-only batches (``gapped=False`` decode) carry ``None``
    gapped columns.
    """

    def __init__(self, read_gapped, ref_gapped, cigar, meta):
        self.read_gapped = read_gapped
        self.ref_gapped = ref_gapped
        self.cigar = cigar
        self.meta = meta

    def __len__(self) -> int:
        return self.meta.shape[0]

    @property
    def scores(self):
        return self.meta[:, 0]

    def __getitem__(self, k: int) -> Alignment:
        if self.read_gapped is None:
            raise ValueError("CIGAR-only AlignmentBatch (decoded with "
                             "gapped=False) cannot materialize Alignment "
                             "objects; read meta/cigar columns directly")
        (score, rs, re_, fs, fe, aln_len, buf_start, clen) = (
            int(x) for x in self.meta[k])
        return Alignment(
            read=self.read_gapped[k, :aln_len].tobytes().decode("latin-1"),
            ref=self.ref_gapped[k, :aln_len].tobytes().decode("latin-1"),
            score=score,
            cigar=self.cigar[k, :clen].tobytes().decode("ascii"),
            read_start=rs, read_end=re_, ref_start=fs, ref_end=fe,
            buffer_start=buf_start,
            buffer_end=self.read_gapped.shape[1] - 1,
        )

    def __iter__(self):
        return (self[k] for k in range(len(self)))

    def slice(self, lo: int, hi: int) -> "AlignmentBatch":
        """Rows [lo, hi) as a view of the same columns (numpy slicing)."""
        gapped = self.read_gapped is not None
        return AlignmentBatch(
            self.read_gapped[lo:hi] if gapped else None,
            self.ref_gapped[lo:hi] if gapped else None,
            self.cigar[lo:hi], self.meta[lo:hi])

    def to_json_rows(self) -> list[dict]:
        """One dict per pair straight from the columns: score, CIGAR and
        coordinates, plus the gapped strings unless the batch is
        CIGAR-only. The meta block converts in one ``tolist()``; the byte
        columns decode row by row (their lengths vary)."""
        gapped = self.read_gapped is not None
        meta_l = self.meta.tolist()
        cig_b = self.cigar.tobytes()
        ccap = self.cigar.shape[1]
        if gapped:
            rg_b = self.read_gapped.tobytes()
            fg_b = self.ref_gapped.tobytes()
            acap = self.read_gapped.shape[1]
        rows = []
        for k, (score, rs, re_, fs, fe, aln_len, _bs, clen) in enumerate(meta_l):
            row = {"score": score,
                   "cigar": cig_b[k * ccap:k * ccap + clen].decode("ascii"),
                   "read_start": rs, "read_end": re_,
                   "ref_start": fs, "ref_end": fe}
            if gapped:
                o = k * acap
                row["read"] = rg_b[o:o + aln_len].decode("latin-1")
                row["ref"] = fg_b[o:o + aln_len].decode("latin-1")
            rows.append(row)
        return rows

    def write_to(self, fileobj, compat: bool = False) -> None:
        """Write the alignments as text: with ``compat`` the reference's
        read line, ref line and a blank line (main.cpp:146-153), else read,
        ref and ``cigar<TAB>score``. A CIGAR-only batch raises."""
        if self.read_gapped is None:
            raise ValueError("CIGAR-only AlignmentBatch cannot write gapped "
                             "text; decode with gapped=True for display output")
        rg, fg, cg, meta = self.read_gapped, self.ref_gapped, self.cigar, self.meta
        for k in range(len(self)):
            aln_len = int(meta[k, 5])
            r = rg[k, :aln_len].tobytes().decode("latin-1")
            f = fg[k, :aln_len].tobytes().decode("latin-1")
            if compat:
                fileobj.write(f"{r}\n{f}\n\n")
            else:
                c = cg[k, :int(meta[k, 7])].tobytes().decode("ascii")
                fileobj.write(f"{r}\n{f}\n{c}\t{int(meta[k, 0])}\n")

    @staticmethod
    def concat(batches: list["AlignmentBatch"]) -> "AlignmentBatch":
        gapped = batches[0].read_gapped is not None
        return AlignmentBatch(
            np.concatenate([b.read_gapped for b in batches]) if gapped else None,
            np.concatenate([b.ref_gapped for b in batches]) if gapped else None,
            np.concatenate([b.cigar for b in batches]),
            np.concatenate([b.meta for b in batches]),
        )


def cigar_from_gapped(read_gapped: str, ref_gapped: str) -> str:
    """CIGAR (M/I/D run-length) of two gapped strings: I = gap in ref (the
    UP pointer), D = gap in read (the LEFT pointer)."""
    if len(read_gapped) != len(ref_gapped):
        raise ValueError("gapped strings must have equal length")
    ops = []
    for rc, fc in zip(read_gapped, ref_gapped):
        op = "D" if rc == "-" else ("I" if fc == "-" else "M")
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])
    return "".join(f"{n}{op}" for op, n in ops)
