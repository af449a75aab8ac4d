"""FASTQ parsing/writing (production ingestion surface; the port's copy of
``versalignlib_tpu/io/fastq.py``).

ADDITIVE over the reference, whose only input format is FASTA
(src/util/versalignUtil.h:47-99); FASTQ is the dominant
wire format for sequencer reads, so a production pipeline needs it
natively. Strict 4-line records (``@name`` / seq / ``+`` / qual) — the
modern form emitted by basecallers; multi-line FASTQ is ancient and
ambiguous (a quality line may start with ``@``) and is rejected rather
than guessed at. Qualities ride along untouched (the DP scores codes, not
qualities); :func:`sniff_format` lets callers accept either format on the
same flag (cli.py does).
"""

from __future__ import annotations

import io
from typing import Iterable, Iterator


def _open(path):
    if isinstance(path, io.TextIOBase):
        return path, False
    return open(path, "r"), True


def iter_fastq_records(path) -> Iterator[tuple[str, str, str]]:
    """Stream (name, sequence, quality) records, O(record) memory.

    Raises ``ValueError`` on structural corruption: a record not starting
    with ``@``, a separator line not starting with ``+``, a quality string
    whose length differs from its sequence, or a truncated trailing record.
    """
    f, owned = _open(path)
    try:
        while True:
            header = f.readline()
            if not header:
                return
            header = header.rstrip("\r\n")
            if not header:
                continue  # tolerate stray blank lines between records
            if header[0] != "@":
                raise ValueError(f"FASTQ record must start with '@': {header[:40]!r}")
            seq = f.readline().rstrip("\r\n")
            plus = f.readline()
            qual = f.readline()
            if not plus or not qual:
                raise ValueError(f"truncated FASTQ record: {header[:40]!r}")
            if plus[0] != "+":
                raise ValueError(
                    f"FASTQ separator must start with '+' (multi-line FASTQ "
                    f"is not supported): {plus.rstrip()[:40]!r}")
            qual = qual.rstrip("\r\n")
            if len(qual) != len(seq):
                raise ValueError(
                    f"quality length {len(qual)} != sequence length "
                    f"{len(seq)} in {header[:40]!r}")
            yield (header[1:].split() or [""])[0], seq, qual
    finally:
        if owned:
            f.close()


def iter_fastq(path) -> Iterator[str]:
    """Stream sequences only (parse_fasta-shaped API)."""
    for _, seq, _ in iter_fastq_records(path):
        yield seq


def parse_fastq(path) -> list[str]:
    """Parse a FASTQ file -> list of sequences (names/quals discarded,
    mirroring ``parse_fasta``)."""
    return list(iter_fastq(path))


def parse_fastq_with_names(path) -> list[tuple[str, str, str]]:
    """Full records: list of (name, sequence, quality)."""
    return list(iter_fastq_records(path))


def iter_fastq_chunks(path, chunk_records: int = 100_000):
    """Yield lists of up to ``chunk_records`` sequences — the FASTQ twin of
    ``iter_fasta_chunks`` for checkpointed bulk pipelines."""
    batch: list[str] = []
    for seq in iter_fastq(path):
        batch.append(seq)
        if len(batch) >= chunk_records:
            yield batch
            batch = []
    if batch:
        yield batch


def write_fastq(path, sequences: Iterable[str],
                names: Iterable[str] | None = None,
                qualities: Iterable[str] | None = None) -> None:
    """Write 4-line FASTQ (default names seq0..; default quality 'I' = Q40)."""
    seqs = list(sequences)
    names = list(names) if names is not None else [
        f"seq{i}" for i in range(len(seqs))]
    quals = list(qualities) if qualities is not None else [
        "I" * len(s) for s in seqs]
    if not (len(seqs) == len(names) == len(quals)):
        raise ValueError("sequences/names/qualities length mismatch")
    for s, q in zip(seqs, quals):
        if len(s) != len(q):
            raise ValueError("quality length != sequence length")
    f, owned = (path, False) if isinstance(path, io.TextIOBase) else (
        open(path, "w"), True)
    try:
        for name, seq, qual in zip(names, seqs, quals):
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")
    finally:
        if owned:
            f.close()


def sniff_format(path) -> str:
    """'fasta' or 'fastq' from the first non-blank byte ('>' vs '@').

    An empty (or all-whitespace) file sniffs as FASTA with zero records —
    callers check for emptiness themselves; only unrecognized CONTENT is
    an error.
    """
    if isinstance(path, io.TextIOBase):
        pos = path.tell()
        head = path.read(4096)
        path.seek(pos)
    else:
        with open(path, "r") as f:
            head = f.read(4096)
    for ch in head:
        if ch.isspace():
            continue
        if ch == ">":
            return "fasta"
        if ch == "@":
            return "fastq"
        raise ValueError(
            f"cannot sniff sequence format (expected '>' or '@'): "
            f"{str(path)!r}")
    return "fasta"  # empty file: zero FASTA records


def parse_sequences(path) -> list[str]:
    """Format-agnostic front door: sniff FASTA vs FASTQ, return sequences."""
    from versalignlib_tpu_torch.io.fasta import parse_fasta

    if sniff_format(path) == "fastq":
        return parse_fastq(path)
    return parse_fasta(path)


def parse_sequences_with_names(path) -> list[tuple[str, str]]:
    """Format-sniffed (name, sequence) records (qualities dropped)."""
    from versalignlib_tpu_torch.io.fasta import parse_fasta_with_names

    if sniff_format(path) == "fastq":
        return [(n, s) for n, s, _ in iter_fastq_records(path)]
    return parse_fasta_with_names(path)


def iter_sequence_chunks(path, chunk_records: int = 100_000):
    """Format-sniffed streaming chunk iterator: yields lists of up to
    ``chunk_records`` sequences, O(chunk) memory — the front door for bulk
    pipelines over files too large to materialize (scripts/bulk_map.py)."""
    from versalignlib_tpu_torch.io.fasta import iter_fasta_chunks

    if sniff_format(path) == "fastq":
        yield from iter_fastq_chunks(path, chunk_records)
    else:
        yield from iter_fasta_chunks(path, chunk_records)


def count_sequences(path) -> int:
    """Number of records in a FASTA/FASTQ file, streamed (no storage)."""
    return sum(len(c) for c in iter_sequence_chunks(path))


def parse_records(path) -> list[tuple[str, str, str | None]]:
    """Format-sniffed FULL records: (name, sequence, quality-or-None).

    FASTA records carry ``None`` quality; FASTQ records carry their
    Phred+33 string. The one front door for pipelines that want to
    propagate names and base qualities (e.g. into SAM QUAL) without
    format-dispatching themselves. Names are normalized to the first
    whitespace-separated header token (SAM QNAME forbids whitespace);
    FASTA descriptions are dropped, matching the FASTQ parser.
    """
    from versalignlib_tpu_torch.io.fasta import parse_fasta_with_names

    if sniff_format(path) == "fastq":
        return list(iter_fastq_records(path))
    return [((n.split() or [""])[0], s, None)
            for n, s in parse_fasta_with_names(path)]
